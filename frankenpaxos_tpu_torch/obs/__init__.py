"""paxtrace in the port: end-to-end causal tracing, the crash flight
recorder and the telemetry plane's host side (the counterpart of
``frankenpaxos_tpu/obs/``). All of it is host code:

  * ``trace`` -- a trace context (trace_id, span_id, sampling bit)
    propagated at the transport FRAME layer (``host:port|<ctx>`` on TCP
    frames, a ``trace`` field on simulated messages) plus the Tracer
    that emits receive/timer/drain spans with drain-stage sub-spans
    (decode, handler, quorum-kernel, wal-fsync, send-release), and the
    ``RuntimeMetrics`` sink of the drain-granular runtime metrics.
  * ``flight`` -- a fixed-size per-role flight recorder ring over an
    mmap'd file: the OS keeps the dirty pages when the process is
    SIGKILL'd, so a crashed role still leaves a record of its last
    actions.
  * ``perfetto`` -- span records -> Chrome-trace-event JSON (loads in
    Perfetto / chrome://tracing), per-command critical paths, and the
    drain-stage latency-breakdown table.
  * ``telemetry`` -- one device-to-host copy per reporting interval of
    the drain kernel's counters, published as ``fpx_pipeline_*``
    RuntimeMetrics and Perfetto counter tracks.

``python -m frankenpaxos_tpu_torch.obs DIR --breakdown --out trace.json``
merges a run's role dumps.
"""

from frankenpaxos_tpu_torch.obs.flight import FlightRecorder
from frankenpaxos_tpu_torch.obs.perfetto import (
    latency_breakdown,
    load_jsonl,
    to_chrome_trace,
    trace_tree,
)
from frankenpaxos_tpu_torch.obs.telemetry import (
    collect,
    TelemetryReporter,
    TelemetrySnapshot,
)
from frankenpaxos_tpu_torch.obs.trace import (
    RuntimeMetrics,
    SpanRecord,
    TraceContext,
    Tracer,
    VirtualClock,
)

__all__ = [
    "FlightRecorder",
    "RuntimeMetrics",
    "SpanRecord",
    "TelemetryReporter",
    "TelemetrySnapshot",
    "TraceContext",
    "Tracer",
    "VirtualClock",
    "collect",
    "latency_breakdown",
    "load_jsonl",
    "to_chrome_trace",
    "trace_tree",
]
