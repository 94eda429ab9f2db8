"""Trace contexts, spans, and the per-role Tracer (the port's copy of
``frankenpaxos_tpu/obs/trace.py``).

THE PROPAGATION LAYER: a ``TraceContext`` (trace_id, parent span_id,
sampling bit) rides the transport FRAME header -- ``host:port|<ctx>``
on TCP frames, a ``trace`` field on ``SimMessage`` -- never the
message codecs: the wire tag space 1..127 is fully allocated, and the
frame layer reaches every protocol uniformly without touching a single
codec. Roles that never heard of tracing still propagate it, because
propagation lives in the two transports.

SPAN MODEL: the transports emit one span per
``receive`` (parented by the frame's context, or a fresh sampled root
when the frame carries none -- the client edge), one per timer fire,
and one per ``on_drain``. The drain span adopts the context of the
LAST sampled message delivered in its batch (group commit serves a
batch; the adopted command's critical path runs through its batch's
drain). Inside handlers and drains, ``Actor.trace_stage`` opens
drain-stage sub-spans -- decode, handler, quorum-kernel, wal-fsync,
send-release -- the stages the latency-breakdown table attributes
per-command time to. On a ``"cuda"`` ProxyLeader the quorum-kernel
stage wraps the tracker's drain: the staged call of K1 / K2 on the card.

DETERMINISM: ids come from a per-role counter (salted with a CRC of
the role name so roles never collide), and the clock is injectable --
``VirtualClock`` advances a fixed tick per reading, so a SimTransport
trace is a pure function of the command sequence and golden-testable.

OVERHEAD: with no tracer attached every hook is one attribute load +
``is None`` test.
Unsampled traces propagate their context (so the sampling decision is
made ONCE, at the root) but never read the clock or allocate records.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional
import zlib

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """What propagates: which trace, which parent span, sampled or not."""

    trace_id: int
    span_id: int
    sampled: bool

    def encode(self) -> str:
        """Frame-header form. No ``:`` or ``|`` (both are taken by the
        ``host:port|ctx`` header grammar)."""
        return (f"{self.trace_id:016x}.{self.span_id:016x}."
                f"{1 if self.sampled else 0}")

    @classmethod
    def decode(cls, text: str) -> "Optional[TraceContext]":
        parts = text.split(".")
        if len(parts) != 3:
            return None
        try:
            return cls(trace_id=int(parts[0], 16),
                       span_id=int(parts[1], 16),
                       sampled=parts[2] == "1")
        except ValueError:
            return None


@dataclasses.dataclass
class SpanRecord:
    """One finished span (the unit perfetto.py exports)."""

    name: str       # e.g. "receive:Phase2a", "drain", "stage:wal-fsync"
    cat: str        # receive | timer | drain | stage | event
    role: str       # the tracer's role label ("acceptor_1")
    t0: float       # seconds (shared wall clock; virtual in sim)
    dur: float      # seconds
    trace_id: int
    span_id: int
    parent_id: int  # 0 = root

    def to_json(self) -> dict:
        return {"name": self.name, "cat": self.cat, "role": self.role,
                "t0": round(self.t0, 9), "dur": round(self.dur, 9),
                "trace_id": f"{self.trace_id:016x}",
                "span_id": f"{self.span_id:016x}",
                "parent_id": f"{self.parent_id:016x}"}

    @classmethod
    def from_json(cls, row: dict) -> "SpanRecord":
        return cls(name=row["name"], cat=row["cat"], role=row["role"],
                   t0=row["t0"], dur=row["dur"],
                   trace_id=int(row["trace_id"], 16),
                   span_id=int(row["span_id"], 16),
                   parent_id=int(row["parent_id"], 16))


class VirtualClock:
    """A deterministic clock: every reading advances a fixed tick.
    SimTransport traces under it are pure functions of the command
    sequence (the golden-trace tests rely on this)."""

    def __init__(self, start: float = 0.0, tick_s: float = 1e-6):
        self.now = start
        self.tick_s = tick_s

    def __call__(self) -> float:
        self.now += self.tick_s
        return self.now


class RuntimeMetrics:
    """The drain-granular runtime metrics every role exports when the
    metrics endpoint is on (with or without tracing): drain-stage
    latency histograms, inbound queue depth (messages per drain
    batch), and WAL group-commit fsync latency. These feed the shared
    "runtime" Grafana row and the promdb scrapes."""

    def __init__(self, collectors, role: str):
        self.role = role
        self._stage_hist = collectors.histogram(
            "fpx_runtime_drain_stage_seconds",
            help="Per-drain-stage latency (decode/handler/quorum-kernel/"
                 "wal-fsync/send-release)",
            labels=("role", "stage"))
        self._depth_gauge = collectors.gauge(
            "fpx_runtime_inbound_queue_depth",
            help="Messages delivered in the current drain batch",
            labels=("role",)).labels(role)
        self._fsync_hist = collectors.histogram(
            "fpx_runtime_wal_fsync_seconds",
            help="WAL group-commit fsync latency (one per drain)",
            labels=("role",)).labels(role)
        self._stage_children: dict = {}
        # paxload (serve/): the admission/backpressure families every
        # /metrics role exports -- registered here (not lazily) so the
        # series exist at zero on every role, admission enabled or not
        # (the Grafana "Runtime" row charts them fleet-wide).
        self._adm_admitted = collectors.counter(
            "fpx_runtime_admission_admitted_total",
            help="Client commands admitted by this role's admission "
                 "controller",
            labels=("role",)).labels(role)
        self._adm_rejected = collectors.counter(
            "fpx_runtime_admission_rejected_total",
            help="Client commands rejected (tokens/inflight/queue/"
                 "codel)",
            labels=("role", "reason"))
        self._adm_shed = collectors.counter(
            "fpx_runtime_admission_shed_total",
            help="Client-lane frames shed by a bounded inbox "
                 "(drop-oldest/reject-newest)",
            labels=("role", "policy"))
        self._adm_inflight = collectors.gauge(
            "fpx_runtime_admission_inflight",
            help="Live proposed-minus-chosen in-flight span under the "
                 "slot budget",
            labels=("role",)).labels(role)
        self._adm_queue = collectors.gauge(
            "fpx_runtime_admission_queue_depth",
            help="Client-lane bounded-inbox depth",
            labels=("role",)).labels(role)
        self._retry_counter = collectors.counter(
            "fpx_runtime_client_retries_total",
            help="Client retry-discipline events "
                 "(backoff/failover/giveup)",
            labels=("role", "kind"))
        self._outbuf_hwm = collectors.gauge(
            "fpx_runtime_outbound_buffer_bytes",
            help="Per-role outbound-buffer high-water mark (bytes "
                 "pending to the slowest peer)",
            labels=("role",)).labels(role)
        self._outbuf_stalls = collectors.counter(
            "fpx_runtime_outbound_stalls_total",
            help="Outbound buffer overflows (oldest frames dropped, "
                 "client lane first; protocol resends cover)",
            labels=("role",)).labels(role)
        # paxwire (runtime/paxwire.py + docs/TRANSPORT.md): the batched
        # transport's health triple -- how many wire frames each writev
        # carried, how many Phase2b acks the flush-time coalescers
        # merged away, and how many bytes left through batched flushes.
        self._transport_fpw = collectors.gauge(
            "fpx_runtime_transport_frames_per_writev",
            help="Wire frames carried by the most recent batched "
                 "flush (writev)",
            labels=("role",)).labels(role)
        self._transport_coalesced = collectors.counter(
            "fpx_runtime_transport_coalesced_acks_total",
            help="Phase2b/ack messages merged into run-granular ack "
                 "ranges by the flush-time coalescers",
            labels=("role",)).labels(role)
        # (Named without the counter-conventional _total suffix: the
        # metric name is part of the paxwire metrics contract
        # (docs/TRANSPORT.md) and the generated dashboards chart it
        # verbatim.)
        self._transport_batch_bytes = collectors.counter(
            "fpx_runtime_transport_batch_bytes",
            help="Bytes sent through the batched (paxwire) flush path",
            labels=("role",)).labels(role)
        # paxingest (ingest/, docs/TRANSPORT.md): the ingestion-plane
        # health triple for batchers and leaders -- commands moved as
        # pre-batched run descriptors, descriptor bytes (run metadata
        # + raw value segments forwarded without decode), and the
        # per-run fill (commands per descriptor).
        self._ingest_cmds = collectors.counter(
            "fpx_runtime_ingest_batched_cmds_total",
            help="Client commands shipped/consumed as pre-batched "
                 "ingest run descriptors",
            labels=("role",)).labels(role)
        self._ingest_bytes = collectors.counter(
            "fpx_runtime_ingest_descriptor_bytes",
            help="Run-descriptor bytes handled by the ingest plane "
                 "(value segments forwarded as raw copies)",
            labels=("role",)).labels(role)
        self._ingest_fill = collectors.summary(
            "fpx_runtime_ingest_batch_fill",
            help="Commands per ingest run descriptor (batch fill)",
            labels=("role",)).labels(role)
        # paxfan (ingest/fan.py): per-shard fan-in health for the
        # N-batcher ring -- distinct sessions pinned to this shard
        # (capped gauge), commands routed through it, the descriptor-
        # pipelining window depth, failovers absorbed, and the shard's
        # structural ring skew (arc share x N; 1.0 = perfectly even).
        self._shard_owned = collectors.gauge(
            "fpx_runtime_ingest_shard_owned_keys",
            help="Distinct client sessions (pseudonyms) observed by "
                 "this ingest shard (capped tracking set)",
            labels=("role", "shard"))
        self._shard_routed = collectors.counter(
            "fpx_runtime_ingest_shard_routed_cmds_total",
            help="Client commands shipped onward by this ingest shard",
            labels=("role", "shard"))
        self._shard_depth = collectors.gauge(
            "fpx_runtime_ingest_shard_pipeline_depth",
            help="Un-credited IngestRuns in flight from this shard "
                 "(descriptor-pipelining window occupancy)",
            labels=("role", "shard"))
        self._shard_failovers = collectors.counter(
            "fpx_runtime_ingest_shard_failovers_total",
            help="Leader changes and wedged-window resets absorbed by "
                 "this ingest shard",
            labels=("role", "shard"))
        self._shard_skew = collectors.gauge(
            "fpx_runtime_ingest_shard_ring_skew",
            help="Structural routing skew of this shard's ring arcs "
                 "(hash-space share x num_batchers; 1.0 = even)",
            labels=("role", "shard"))
        self._shard_children: dict = {}
        # paxworld (scenarios/, docs/GLOBAL.md): per-region serving
        # health for the Grafana "Global serving" band -- commands
        # committed and client commands rejected/shed, labeled by the
        # zone/region the exporting role serves.
        self._region_goodput = collectors.counter(
            "fpx_runtime_region_goodput_cmds_total",
            help="Commands committed (chosen) by this role, by "
                 "region/zone",
            labels=("role", "region"))
        self._region_shed = collectors.counter(
            "fpx_runtime_region_shed_total",
            help="Client commands rejected or shed by this role, by "
                 "region/zone",
            labels=("role", "region"))
        # paxpulse (ops/telemetry.py + obs/telemetry.py): the device
        # pipeline counters that ride INSIDE the drain kernel's state
        # buffer and reach here through one collect() per reporting
        # interval. fpx_pipeline_* (not fpx_runtime_*)
        # because the exporter is the pipeline harness, not a role's
        # event loop.
        self._pipe_drains = collectors.counter(
            "fpx_pipeline_drains_total",
            help="Device pipeline drains accumulated (fori_loop "
                 "iterations collected)",
            labels=("role",)).labels(role)
        self._pipe_committed = collectors.counter(
            "fpx_pipeline_committed_total",
            help="Commands newly chosen by the device pipeline "
                 "(mesh-global)",
            labels=("role",)).labels(role)
        self._pipe_proposed = collectors.counter(
            "fpx_pipeline_proposed_total",
            help="Valid (non-pad) commands proposed by the device "
                 "pipeline",
            labels=("role",)).labels(role)
        self._pipe_pads = collectors.counter(
            "fpx_pipeline_pad_lanes_total",
            help="Pad-lane slots masked per drain under a "
                 "non-divisible paxmesh slot split (padding waste)",
            labels=("role",)).labels(role)
        self._pipe_shard = collectors.gauge(
            "fpx_pipeline_shard_committed",
            help="Cumulative committed commands per slot shard (the "
                 "skew source)",
            labels=("role", "shard"))
        self._pipe_skew = collectors.gauge(
            "fpx_pipeline_shard_skew_ratio",
            help="max/mean of per-shard committed (1.0 = perfectly "
                 "even mesh)",
            labels=("role",)).labels(role)
        self._pipe_fill = collectors.gauge(
            "fpx_pipeline_batch_fill",
            help="Valid proposals per drain over the global block "
                 "(1.0 = every lane carried a command)",
            labels=("role",)).labels(role)
        self._pipe_occ = collectors.counter(
            "fpx_pipeline_quorum_occupancy_total",
            help="Slots first chosen with exactly `votes` acceptor "
                 "votes landed (quorum-progress occupancy)",
            labels=("role", "votes"))
        self._pipe_lag = collectors.counter(
            "fpx_pipeline_watermark_lag_total",
            help="End-of-drain watermark lag (proposed-but-unchosen "
                 "slots), log2-bucketed by lower bound",
            labels=("role", "bucket"))
        # paxruns (runs/ + protocols/{epaxos,simplebpaxos,fastpaxos}):
        # the batched dependency-set engine and the fast-quorum layer.
        self._depset_deps = collectors.counter(
            "fpx_runtime_depset_batched_deps_total",
            help="Dependency columns computed through the batched "
                 "depset engine (runs/depruns.py)",
            labels=("role",)).labels(role)
        self._depset_fallbacks = collectors.counter(
            "fpx_runtime_depset_span_fallbacks_total",
            help="Depset unions that fell back to the sparse-span "
                 "path (tail window exceeded / host backend)",
            labels=("role",)).labels(role)
        self._fastquorum_checks = collectors.counter(
            "fpx_runtime_fastquorum_checks_total",
            help="Fast-quorum / spec-checker evaluations (fastpaxos, "
                 "fastmultipaxos, runs/quorums.py)",
            labels=("role",)).labels(role)
        self._adm_rejected_children: dict = {}
        self._adm_shed_children: dict = {}
        self._retry_children: dict = {}
        self._region_children: dict = {}
        self._pipe_children: dict = {}

    def observe_stage(self, stage: str, dur_s: float) -> None:
        child = self._stage_children.get(stage)
        if child is None:
            child = self._stage_hist.labels(self.role, stage)
            self._stage_children[stage] = child
        child.observe(dur_s)
        if stage == "wal-fsync":
            self._fsync_hist.observe(dur_s)

    def observe_batch(self, depth: int) -> None:
        self._depth_gauge.set(depth)

    # --- paxload admission/backpressure (serve/) ------------------------
    def admission_admitted(self, n: int = 1) -> None:
        self._adm_admitted.inc(n)

    def admission_rejected(self, reason: str, n: int = 1) -> None:
        child = self._adm_rejected_children.get(reason)
        if child is None:
            child = self._adm_rejected.labels(self.role, reason)
            self._adm_rejected_children[reason] = child
        child.inc(n)

    def admission_shed(self, policy: str, n: int = 1) -> None:
        child = self._adm_shed_children.get(policy)
        if child is None:
            child = self._adm_shed.labels(self.role, policy)
            self._adm_shed_children[policy] = child
        child.inc(n)

    def admission_inflight(self, value: int) -> None:
        self._adm_inflight.set(value)

    def admission_queue_depth(self, value: int) -> None:
        self._adm_queue.set(value)

    def client_retry(self, kind: str, n: int = 1) -> None:
        child = self._retry_children.get(kind)
        if child is None:
            child = self._retry_counter.labels(self.role, kind)
            self._retry_children[kind] = child
        child.inc(n)

    # --- paxingest ingestion plane (ingest/) ----------------------------
    def ingest_batch(self, cmds: int, nbytes: int) -> None:
        self._ingest_cmds.inc(cmds)
        if nbytes:
            self._ingest_bytes.inc(nbytes)
        self._ingest_fill.observe(cmds)

    # --- paxfan sharded fan-in (ingest/fan.py) --------------------------
    def _shard_family(self, shard: int):
        children = self._shard_children.get(shard)
        if children is None:
            label = str(shard)
            children = (
                self._shard_owned.labels(self.role, label),
                self._shard_routed.labels(self.role, label),
                self._shard_depth.labels(self.role, label),
                self._shard_failovers.labels(self.role, label),
                self._shard_skew.labels(self.role, label),
            )
            self._shard_children[shard] = children
        return children

    def ingest_shard_routed(self, shard: int, cmds: int) -> None:
        self._shard_family(shard)[1].inc(cmds)

    def ingest_shard_state(self, shard: int, *, owned_keys: int,
                           pipeline_depth: int, skew: float) -> None:
        owned, _, depth, _, skew_g = self._shard_family(shard)
        owned.set(owned_keys)
        depth.set(pipeline_depth)
        skew_g.set(skew)

    def ingest_shard_failover(self, shard: int) -> None:
        self._shard_family(shard)[3].inc()

    # --- paxworld global serving (scenarios/) ---------------------------
    def region_goodput(self, region: str, n: int = 1) -> None:
        child = self._region_children.get(("goodput", region))
        if child is None:
            child = self._region_goodput.labels(self.role, region)
            self._region_children[("goodput", region)] = child
        child.inc(n)

    def region_shed(self, region: str, n: int = 1) -> None:
        child = self._region_children.get(("shed", region))
        if child is None:
            child = self._region_shed.labels(self.role, region)
            self._region_children[("shed", region)] = child
        child.inc(n)

    def outbound_buffer_hwm(self, size_bytes: int) -> None:
        if size_bytes > self._outbuf_hwm.get():
            self._outbuf_hwm.set(size_bytes)

    def outbound_stall(self, n: int = 1) -> None:
        self._outbuf_stalls.inc(n)

    # --- paxpulse device pipeline (obs/telemetry.py publishes) ----------
    def pipeline_interval(self, *, drains: int, committed: int,
                          proposed: int, pad_lanes: int,
                          occupancy, lag_hist, shard_committed,
                          skew: float, fill=None) -> None:
        """One reporting interval: deltas for the counters, the
        cumulative per-shard/skew/fill state for the gauges."""
        self._pipe_drains.inc(drains)
        self._pipe_committed.inc(committed)
        self._pipe_proposed.inc(proposed)
        self._pipe_pads.inc(pad_lanes)
        for votes, n in enumerate(occupancy):
            if not n:
                continue
            key = ("occ", votes)
            child = self._pipe_children.get(key)
            if child is None:
                child = self._pipe_occ.labels(self.role, str(votes))
                self._pipe_children[key] = child
            child.inc(n)
        for bucket, n in enumerate(lag_hist):
            if not n:
                continue
            key = ("lag", bucket)
            child = self._pipe_children.get(key)
            if child is None:
                child = self._pipe_lag.labels(self.role, str(bucket))
                self._pipe_children[key] = child
            child.inc(n)
        for shard, total in enumerate(shard_committed):
            key = ("shard", shard)
            child = self._pipe_children.get(key)
            if child is None:
                child = self._pipe_shard.labels(self.role, str(shard))
                self._pipe_children[key] = child
            child.set(total)
        self._pipe_skew.set(skew)
        if fill is not None:
            self._pipe_fill.set(fill)

    # --- paxruns depset / fast-quorum layer (runs/, protocols/) ---------
    def depset_batch(self, ndeps: int) -> None:
        self._depset_deps.inc(ndeps)

    def depset_span_fallback(self, n: int = 1) -> None:
        self._depset_fallbacks.inc(n)

    def fastquorum_check(self, n: int = 1) -> None:
        self._fastquorum_checks.inc(n)

    # --- paxwire batched transport (runtime/paxwire.py) -----------------
    def transport_flush(self, frames: int, nbytes: int) -> None:
        self._transport_fpw.set(frames)
        self._transport_batch_bytes.inc(nbytes)

    def transport_coalesced_acks(self, n: int) -> None:
        self._transport_coalesced.inc(n)


class _Scope:
    """An active span: sets ``tracer.current`` for its dynamic extent
    so sends made inside it propagate its context."""

    __slots__ = ("tracer", "name", "cat", "ctx", "parent_id", "prev",
                 "t0", "m0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 ctx: TraceContext, parent_id: int):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.ctx = ctx
        self.parent_id = parent_id

    def __enter__(self) -> "_Scope":
        tracer = self.tracer
        self.prev = tracer.current
        tracer.current = self.ctx
        if self.ctx.sampled:
            self.t0 = tracer.clock()
            # Durations come from the MONOTONIC clock (an NTP step
            # between enter and exit would otherwise record a
            # negative duration and corrupt the latency histograms);
            # t0 stays on the shared wall clock so role tracks align.
            self.m0 = (self.t0 if tracer.mono is tracer.clock
                       else tracer.mono())
        return self

    def __exit__(self, *exc) -> bool:
        tracer = self.tracer
        tracer.current = self.prev
        if self.ctx.sampled:
            m1 = (tracer.clock() if tracer.mono is tracer.clock
                  else tracer.mono())
            tracer._record(SpanRecord(
                name=self.name, cat=self.cat, role=tracer.role,
                t0=self.t0, dur=m1 - self.m0,
                trace_id=self.ctx.trace_id, span_id=self.ctx.span_id,
                parent_id=self.parent_id))
            if self.cat == "stage" and tracer.runtime_metrics is not None:
                tracer.runtime_metrics.observe_stage(
                    self.name[len("stage:"):], m1 - self.m0)
        return False


class _MetricStage:
    """Stage timing with metrics only (tracing off but /metrics on):
    feeds the drain-stage histogram without emitting spans."""

    __slots__ = ("metrics", "stage", "t0")

    def __init__(self, metrics: RuntimeMetrics, stage: str):
        self.metrics = metrics
        self.stage = stage

    def __enter__(self) -> "_MetricStage":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.metrics.observe_stage(self.stage,
                                   time.perf_counter() - self.t0)
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SCOPE = _Noop()


def stage_scope(tracer: "Optional[Tracer]",
                metrics: Optional[RuntimeMetrics], name: str):
    """The one stage-timing entry point (Actor.trace_stage): a traced
    sub-span, a metrics-only timer, or a shared no-op."""
    if tracer is not None:
        return tracer.stage(name)
    if metrics is not None:
        return _MetricStage(metrics, name)
    return NOOP_SCOPE


class Tracer:
    """Per-role span emitter. One per process (deployed) or one per
    harness (sim, shared across roles via per-call role labels is NOT
    done -- each simulated role can share one tracer because the role
    label rides each span via the transport's actor address)."""

    def __init__(self, role: str = "",
                 clock: Optional[Callable[[], float]] = None,
                 sample_rate: float = 1.0,
                 flight=None,
                 runtime_metrics: Optional[RuntimeMetrics] = None,
                 sink_path: Optional[str] = None,
                 max_spans: int = 1 << 20,
                 instance: int = 0):
        self.role = role
        self.clock = clock if clock is not None else time.time
        # Durations are measured on a monotonic clock; a CUSTOM clock
        # (VirtualClock) serves both roles so sim traces stay pure
        # functions of the command sequence.
        self.mono: Callable[[], float] = (
            clock if clock is not None else time.perf_counter)
        # Sampling is 1-in-N at trace ROOTS (deterministic, counter
        # based); propagated contexts keep their bit unchanged.
        self.sample_every = (1 if sample_rate >= 1.0
                             else 0 if sample_rate <= 0.0
                             else max(1, round(1.0 / sample_rate)))
        self.flight = flight
        self.runtime_metrics = runtime_metrics
        self.current: Optional[TraceContext] = None
        self.spans: list[SpanRecord] = []
        self.max_spans = max_spans
        # ``instance`` distinguishes INCARNATIONS of one role: a
        # crash-relaunched role restarts its counter at 0, and with
        # the same role salt its ids would collide with the killed
        # life's in the appended trace.jsonl (the CLI passes the pid;
        # sims keep the default 0 so traces stay deterministic).
        self._salt = ((zlib.crc32(role.encode())
                       ^ ((instance * 0x9E3779B1) & 0xFFFFFFFF))
                      & 0xFFFFFFFF) << 32
        self._next = 0
        self._roots = 0
        # Per-actor: colocated actors (supernode, every sim harness)
        # share one tracer, and actor A's drain must never adopt the
        # context of a receive that went to actor B.
        self._drain_parent: dict[str, TraceContext] = {}
        self._sink = open(sink_path, "a") if sink_path else None
        self._sink_pending = 0

    # --- ids / sampling ---------------------------------------------------
    def _new_id(self) -> int:
        self._next += 1
        return (self._salt | (self._next & 0xFFFFFFFF)) & _MASK64

    def _sample_root(self) -> bool:
        if self.sample_every == 0:
            return False
        self._roots += 1
        return (self._roots - 1) % self.sample_every == 0

    # --- span factories (called by the transports) ------------------------
    def receive_span(self, actor: str, msg_type: str,
                     ctx: Optional[TraceContext]) -> _Scope:
        """The per-message receive span. ``ctx`` is the frame's
        context; a missing context makes this receive a trace ROOT
        (the client-facing edge) under the sampling policy."""
        if ctx is None:
            ctx = TraceContext(trace_id=self._new_id(), span_id=0,
                               sampled=self._sample_root())
        child = TraceContext(trace_id=ctx.trace_id,
                             span_id=self._new_id(),
                             sampled=ctx.sampled)
        if ctx.sampled:
            self._drain_parent[actor] = child
        return _Scope(self, f"receive:{msg_type}@{actor}", "receive",
                      child, ctx.span_id)

    def timer_span(self, actor: str, timer_name: str) -> _Scope:
        ctx = TraceContext(trace_id=self._new_id(),
                           span_id=self._new_id(),
                           sampled=self._sample_root())
        if ctx.sampled:
            self._drain_parent[actor] = ctx
        return _Scope(self, f"timer:{timer_name}@{actor}", "timer",
                      ctx, 0)

    def drain_span(self, actor: str) -> _Scope:
        """The on_drain span: adopts THIS actor's last sampled receive
        of the batch (group commit serves the batch; the adopted
        command's critical path runs through its batch's drain)."""
        parent = self._drain_parent.pop(actor, None)
        if parent is None:
            ctx = TraceContext(trace_id=self._new_id(), span_id=0,
                               sampled=False)
            parent_id = 0
        else:
            ctx = TraceContext(trace_id=parent.trace_id,
                               span_id=self._new_id(),
                               sampled=parent.sampled)
            parent_id = parent.span_id
        return _Scope(self, f"drain@{actor}", "drain", ctx, parent_id)

    def stage(self, name: str):
        """A drain-stage sub-span under the current context (decode,
        handler, quorum-kernel, wal-fsync, send-release)."""
        parent = self.current
        if parent is None or not parent.sampled:
            # No span for unsampled work -- but the RUNTIME METRICS
            # must not be starved by the sampling rate (the Grafana
            # row charts every fsync, not 1-in-N), so fall back to the
            # metrics-only timer when one is attached. It leaves
            # ``current`` untouched, which matches the unsampled span
            # behavior exactly: an unsampled stage reuses the parent
            # context anyway.
            if self.runtime_metrics is not None:
                return _MetricStage(self.runtime_metrics, name)
            ctx = parent if parent is not None else TraceContext(
                trace_id=0, span_id=0, sampled=False)
            return _Scope(self, f"stage:{name}", "stage", ctx, 0)
        ctx = TraceContext(trace_id=parent.trace_id,
                           span_id=self._new_id(), sampled=True)
        return _Scope(self, f"stage:{name}", "stage", ctx,
                      parent.span_id)

    def record_stage(self, name: str, m0: float,
                     ctx: Optional[TraceContext]) -> None:
        """A stage span recorded after the fact (ends now; ``m0`` is a
        ``tracer.mono()`` reading from its start): the TCP receive
        path times message decode before any span scope can be open,
        because decode errors must stay inside the transport's
        corrupt-frame guard."""
        if ctx is None or not ctx.sampled:
            return
        if self.mono is self.clock:
            dur = self.clock() - m0
            t0 = m0
        else:
            dur = self.mono() - m0
            t0 = self.clock() - dur
        self._record(SpanRecord(
            name=f"stage:{name}", cat="stage", role=self.role,
            t0=t0, dur=dur, trace_id=ctx.trace_id,
            span_id=self._new_id(), parent_id=ctx.span_id))
        if self.runtime_metrics is not None:
            self.runtime_metrics.observe_stage(name, dur)

    def event(self, text: str) -> None:
        """An instantaneous flight-recorder note (crash post-mortems:
        'recovering 8124 records', 'phase1 restarted @ round 3')."""
        t = self.clock()
        if self.flight is not None:
            self.flight.record(t, f"event {text}")
        self._record(SpanRecord(
            name=f"event:{text}", cat="event", role=self.role,
            t0=t, dur=0.0, trace_id=0, span_id=self._new_id(),
            parent_id=0))

    # --- record sinks -----------------------------------------------------
    def _record(self, record: SpanRecord) -> None:
        # With a jsonl sink the file IS the record of truth; keeping a
        # second in-memory copy would grow a long-running role by
        # hundreds of MB at full sampling for data nothing reads.
        if self._sink is None and len(self.spans) < self.max_spans:
            self.spans.append(record)
        if self.flight is not None and record.cat != "event":
            self.flight.record(
                record.t0 + record.dur,
                f"{record.name} trace={record.trace_id:016x} "
                f"dur_us={record.dur * 1e6:.1f}")
        if self._sink is not None:
            self._sink.write(json.dumps(record.to_json(),
                                        separators=(",", ":")) + "\n")
            self._sink_pending += 1
            if self._sink_pending >= 64:
                self._sink.flush()
                self._sink_pending = 0

    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()
            self._sink_pending = 0

    def close(self) -> None:
        if self._sink is not None:
            self._sink.flush()
            self._sink.close()
            self._sink = None
        if self.flight is not None:
            self.flight.close()

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for record in self.spans:
                f.write(json.dumps(record.to_json(),
                                   separators=(",", ":")) + "\n")
