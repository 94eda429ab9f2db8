"""The port's tracer and its companions (``frankenpaxos_tpu_torch/obs/``)
against the JAX package.

(a) The cases of ``tests/test_obs.py`` on the port: the context codec,
the Tracer's sampling and parenting, the deterministic echo trace
against the same committed ``tests/golden/sim_echo_trace.json``, the
flight recorder, the Perfetto export, frame-layer propagation over
real TCP, and the metrics-only stages.
(b) ``tests/test_paxwire.py::test_trace_context_rides_batch_header`` and
a SIGKILL post-mortem in the spirit of
``tests/test_telemetry.py::test_sigkill_postmortem_snapshots_telemetry``
(the flight ring read back cold after ``kill -9``, the telemetry
reporter's summary beside it).
(c) Parity: a ``VirtualClock``-traced coalesced MultiPaxos run's span
dump is equal, field for field, in both packages on the ``dict``
tracker and on the device trackers (the JAX ``tpu`` tracker and the
port's ``cuda`` one on ``device="cpu"``, synchronous and pipelined); the
Perfetto export, trace trees and breakdowns of equal spans are equal;
``RuntimeMetrics`` exposes the same series for the same events; the
telemetry reporter publishes onto it.
(d) ``bench/traced_tcp.py`` and ``python -m frankenpaxos_tpu_torch.obs``
end to end on the CPU, and the WPaxos leaders' per-region goodput.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

from frankenpaxos_tpu_torch.obs import (
    __main__ as obs_main,
    FlightRecorder,
    latency_breakdown,
    load_jsonl,
    perfetto,
    RuntimeMetrics,
    to_chrome_trace,
    trace_tree,
    TraceContext,
    Tracer,
    VirtualClock,
)
from frankenpaxos_tpu_torch.obs.trace import NOOP_SCOPE, stage_scope
from frankenpaxos_tpu_torch.protocols.echo import EchoClient, EchoServer
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
from frankenpaxos_tpu_torch.runtime import (
    FakeCollectors,
    FakeLogger,
    LogLevel,
    SimTransport,
)
import pytest

from frankenpaxos_tpu import obs as jobs
from frankenpaxos_tpu.obs import perfetto as jperfetto
from frankenpaxos_tpu.runtime import FakeCollectors as JFakeCollectors
from tests.protocols import multipaxos_harness as jh
from tests.test_obs import traced_echo_spans as jax_echo_spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "sim_echo_trace.json")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(predicate, timeout=10.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


# --- (a) tests/test_obs.py on the port ----------------------------------------


class TestTraceContext:
    def test_encode_decode_round_trip(self):
        ctx = TraceContext(trace_id=0x2ECAC21000000001,
                           span_id=0xDEADBEEF00000007, sampled=True)
        assert TraceContext.decode(ctx.encode()) == ctx
        off = TraceContext(trace_id=1, span_id=2, sampled=False)
        assert TraceContext.decode(off.encode()) == off

    def test_encode_avoids_header_separators(self):
        ctx = TraceContext(trace_id=2**64 - 1, span_id=0, sampled=True)
        assert ":" not in ctx.encode()
        assert "|" not in ctx.encode()

    def test_decode_garbage_is_none(self):
        assert TraceContext.decode("") is None
        assert TraceContext.decode("nope") is None
        assert TraceContext.decode("xx.yy.1") is None
        assert TraceContext.decode("1.2") is None

    @pytest.mark.parametrize("trace_id,span_id,sampled", [
        (0, 0, False), (1, 2, True), (2**64 - 1, 2**63, True),
        (0x2ECAC21000000001, 0xDEADBEEF00000007, False)])
    def test_encoding_matches_the_reference(self, trace_id, span_id,
                                            sampled):
        ctx = TraceContext(trace_id, span_id, sampled)
        ref = jobs.TraceContext(trace_id, span_id, sampled)
        assert ctx.encode() == ref.encode()
        assert TraceContext.decode(ref.encode()) == ctx


class TestTracer:
    def test_sampling_one_in_n_at_roots(self):
        tracer = Tracer(role="r", clock=VirtualClock(), sample_rate=0.25)
        sampled = []
        for _ in range(8):
            with tracer.receive_span("a", "M", None) as span:
                sampled.append(span.ctx.sampled)
        assert sampled == [True, False, False, False] * 2

    def test_propagated_context_keeps_root_decision(self):
        tracer = Tracer(role="r", clock=VirtualClock(), sample_rate=0.0)
        ctx = TraceContext(trace_id=9, span_id=1, sampled=True)
        with tracer.receive_span("a", "M", ctx) as span:
            assert span.ctx.sampled
            assert span.ctx.trace_id == 9
        assert tracer.spans  # recorded despite local rate 0

    def test_unsampled_spans_record_nothing(self):
        tracer = Tracer(role="r", clock=VirtualClock(), sample_rate=0.0)
        with tracer.receive_span("a", "M", None):
            pass
        with tracer.drain_span("a"):
            pass
        assert tracer.spans == []

    def test_drain_parent_is_per_actor(self):
        """Colocated actors share one tracer: actor A's drain adopts A's
        last sampled receive, never B's."""
        tracer = Tracer(role="r", clock=VirtualClock())
        with tracer.receive_span("A", "M", None) as ra:
            pass
        with tracer.receive_span("B", "M", None) as rb:
            pass
        with tracer.drain_span("A") as da:
            assert da.parent_id == ra.ctx.span_id
            assert da.ctx.trace_id == ra.ctx.trace_id
        with tracer.drain_span("B") as db:
            assert db.parent_id == rb.ctx.span_id
            assert db.ctx.trace_id == rb.ctx.trace_id

    def test_instance_salt_separates_incarnations(self):
        life1 = Tracer(role="acceptor_1", clock=VirtualClock(),
                       instance=1234)
        life2 = Tracer(role="acceptor_1", clock=VirtualClock(),
                       instance=5678)
        ids1 = {life1._new_id() for _ in range(50)}
        ids2 = {life2._new_id() for _ in range(50)}
        assert not ids1 & ids2
        assert Tracer(role="sim")._salt == Tracer(role="sim", instance=0)._salt

    @pytest.mark.parametrize("role,instance", [
        ("sim", 0), ("acceptor_1", 1234), ("supernode_0", 99)])
    def test_ids_match_the_reference(self, role, instance):
        port = Tracer(role=role, clock=VirtualClock(), instance=instance)
        ref = jobs.Tracer(role=role, clock=jobs.VirtualClock(),
                          instance=instance)
        assert [port._new_id() for _ in range(5)] == \
            [ref._new_id() for _ in range(5)]

    def test_sampling_does_not_starve_runtime_metrics(self):
        collectors = FakeCollectors()
        metrics = RuntimeMetrics(collectors, "r0")
        tracer = Tracer(role="r0", clock=VirtualClock(), sample_rate=0.0,
                        runtime_metrics=metrics)
        for _ in range(5):
            with tracer.receive_span("a", "M", None):
                with tracer.stage("wal-fsync"):
                    pass
        assert tracer.spans == []
        fsync = collectors.metrics["fpx_runtime_wal_fsync_seconds"]
        assert fsync.labels("r0").get_count() == 5

    def test_current_context_restored_on_exit(self):
        tracer = Tracer(role="r", clock=VirtualClock())
        assert tracer.current is None
        with tracer.receive_span("a", "M", None) as outer:
            assert tracer.current is outer.ctx
            with tracer.stage("handler") as inner:
                assert tracer.current is inner.ctx
            assert tracer.current is outer.ctx
        assert tracer.current is None

    def test_sink_file_is_the_record(self, tmp_path):
        """With a jsonl sink the spans go to the file (flushed on close),
        not to memory."""
        path = str(tmp_path / "r.trace.jsonl")
        tracer = Tracer(role="r", clock=VirtualClock(), sink_path=path)
        for _ in range(3):
            with tracer.receive_span("a", "M", None):
                pass
        tracer.close()
        assert tracer.spans == []
        assert [r.name for r in load_jsonl(path)] == ["receive:M@a"] * 3


def traced_echo_spans(payloads):
    logger = FakeLogger()
    transport = SimTransport(logger)
    EchoServer("server", transport, logger)
    client = EchoClient("client", transport, logger, "server")
    transport.tracer = Tracer(role="sim", clock=VirtualClock())
    for payload in payloads:
        client.echo(payload)
    transport.deliver_all()
    return transport.tracer.spans


def traced_multipaxos(pkg_make, tracer, writes=4, waves=3, **kwargs):
    """Coalesced writes in waves through a traced harness cluster,
    delivered until quiet (the pipelined tracker's flush timer fired
    when delivery goes quiet); returns the span dump."""
    sim = pkg_make(f=1, coalesced=True, **kwargs)
    sim.transport.tracer = tracer
    results: list = []
    for wave in range(waves):
        for p in range(writes):
            sim.clients[0].write(p, b"v%d.%d" % (wave, p), results.append)
        sim.clients[0].flush_writes()
        while True:
            while sim.transport.messages:
                sim.transport.deliver_all_coalesced()
            flush = [t for t in sim.transport.running_timers()
                     if t.name == "tpuDrainFlush"]
            if not flush:
                break
            for timer in flush:
                sim.transport.trigger_timer(timer.id)
    assert len(results) == writes * waves
    return [s.to_json() for s in tracer.spans]


class TestDeterministicSimTrace:
    def test_echo_trace_matches_golden(self):
        """The golden test: the port's echo trace equals the committed
        golden file the reference is held to."""
        spans = [s.to_json() for s in traced_echo_spans(["one", "two"])]
        with open(GOLDEN) as f:
            golden = json.load(f)
        assert spans == golden

    def test_trace_is_reproducible_across_fresh_harnesses(self):
        a = [s.to_json() for s in traced_echo_spans(["x", "y", "z"])]
        b = [s.to_json() for s in traced_echo_spans(["x", "y", "z"])]
        assert a == b

    def test_multipaxos_coalesced_trace_deterministic(self):
        def run():
            return traced_multipaxos(
                make_multipaxos, Tracer(role="sim", clock=VirtualClock()))

        first, second = run(), run()
        assert first == second
        names = {row["name"] for row in first}
        assert any(n.startswith("stage:handler") for n in names)
        assert any(n.startswith("drain@") for n in names)

    def test_end_to_end_trace_crosses_roles(self):
        sim = make_multipaxos(f=1, coalesced=True)
        tracer = Tracer(role="sim", clock=VirtualClock())
        sim.transport.tracer = tracer
        results: list = []
        sim.clients[0].write(0, b"cmd", results.append)
        sim.clients[0].flush_writes()
        sim.transport.deliver_all_coalesced()
        assert results
        receives = [s for s in tracer.spans if s.cat == "receive"]
        root_traces = {s.trace_id for s in receives if s.parent_id == 0}
        assert root_traces
        main = max(root_traces,
                   key=lambda t: sum(1 for s in tracer.spans
                                     if s.trace_id == t))
        actors = {s.name.rpartition("@")[2] for s in tracer.spans
                  if s.trace_id == main and s.cat == "receive"}
        assert len(actors) >= 3, actors

    def test_crash_is_a_flight_event(self):
        logger = FakeLogger()
        transport = SimTransport(logger)
        EchoServer("server", transport, logger)
        ring = FlightRecorder(slots=8, slot_size=64)
        transport.tracer = Tracer(role="sim", clock=VirtualClock(),
                                  flight=ring)
        transport.crash("server")
        assert [t for _, _, t in ring.records()] == ["event crash server"]
        assert transport.tracer.spans[-1].name == "event:crash server"


class TestFlightRecorder:
    def test_ring_wraps_and_orders(self):
        ring = FlightRecorder(slots=4, slot_size=64)
        for i in range(10):
            ring.record(float(i), f"event {i}")
        got = ring.records()
        assert [seq for seq, _, _ in got] == [7, 8, 9, 10]
        assert [text for _, _, text in got] == [
            "event 6", "event 7", "event 8", "event 9"]

    def test_mmap_ring_survives_abandonment(self, tmp_path):
        path = str(tmp_path / "role.flight")
        ring = FlightRecorder(path, slots=8, slot_size=64)
        for i in range(5):
            ring.record(i * 0.5, f"act {i}")
        del ring  # no close(): the crash
        got = FlightRecorder.read(path)
        assert [text for _, _, text in got] == [f"act {i}" for i in range(5)]
        assert got[2][1] == pytest.approx(1.0)

    def test_restart_reuses_ring_and_keeps_crash_records(self, tmp_path):
        path = str(tmp_path / "role.flight")
        ring = FlightRecorder(path, slots=8, slot_size=64)
        ring.record(1.0, "before crash")
        del ring
        again = FlightRecorder(path, slots=8, slot_size=64)
        again.record(2.0, "after restart")
        got = FlightRecorder.read(path)
        assert [text for _, _, text in got] == [
            "before crash", "after restart"]
        assert [seq for seq, _, _ in got] == [1, 2]

    def test_long_text_truncates_not_corrupts(self, tmp_path):
        path = str(tmp_path / "role.flight")
        ring = FlightRecorder(path, slots=2, slot_size=48)
        ring.record(0.0, "x" * 500)
        ring.record(1.0, "short")
        got = FlightRecorder.read(path)
        assert len(got) == 2
        assert len(got[0][2]) == 48 - 18
        assert got[1][2] == "short"

    def test_dump_file_writes_post_mortem_json(self, tmp_path):
        path = str(tmp_path / "role.flight")
        ring = FlightRecorder(path, slots=4, slot_size=64)
        ring.record(0.25, "hello")
        ring.close()
        out = str(tmp_path / "post.json")
        dump = FlightRecorder.dump_file(path, out)
        assert dump["records"][0]["text"] == "hello"
        with open(out) as f:
            assert json.load(f) == dump

    def test_read_rejects_garbage(self, tmp_path):
        path = str(tmp_path / "bad.flight")
        with open(path, "wb") as f:
            f.write(b"not a flight ring")
        with pytest.raises(ValueError):
            FlightRecorder.read(path)

    def test_tracer_feeds_flight(self):
        ring = FlightRecorder(slots=16, slot_size=128)
        tracer = Tracer(role="r", clock=VirtualClock(), flight=ring)
        with tracer.receive_span("a", "M", None):
            pass
        tracer.event("recovered 12 records")
        texts = [text for _, _, text in ring.records()]
        assert any("receive:M@a" in t for t in texts)
        assert any("event recovered 12 records" in t for t in texts)

    def test_ring_bytes_match_the_reference(self, tmp_path):
        """Both packages write the same ring file for the same records,
        and each reads the other's."""
        paths = [str(tmp_path / f"{name}.flight") for name in ("p", "j")]
        for cls, path in zip((FlightRecorder, jobs.FlightRecorder), paths):
            ring = cls(path, slots=4, slot_size=64)
            for i in range(6):
                ring.record(i * 0.25, f"record {i}")
            ring.close()
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
        assert FlightRecorder.read(paths[1]) == \
            jobs.FlightRecorder.read(paths[0])


class TestPerfettoExport:
    def test_chrome_trace_shape(self):
        spans = traced_echo_spans(["one"])
        trace = to_chrome_trace(spans)
        events = trace["traceEvents"]
        complete = [e for e in events if e["ph"] == "X"]
        meta = [e for e in events if e["ph"] == "M"]
        assert len(complete) == len(spans)
        assert meta and meta[0]["args"]["name"] == "sim"
        for event in complete:
            assert event["ts"] >= 0 and event["dur"] > 0
            assert len(event["args"]["trace_id"]) == 16
        json.loads(json.dumps(trace))

    def test_latency_breakdown_buckets_by_stage(self):
        spans = traced_echo_spans(["one", "two"])
        table = latency_breakdown(spans)
        assert set(table) == {"decode", "handler", "receive", "drain"}
        assert table["decode"]["count"] == 4
        assert table["receive"]["mean_us"] == pytest.approx(5.0)

    def test_trace_tree_critical_path(self):
        spans = traced_echo_spans(["one", "two"])
        tree = trace_tree(spans, spans[0].trace_id)
        path = tree["critical_path"]
        assert path[0].cat == "receive"
        assert path[-1].name == "drain@client"

    def test_jsonl_round_trip(self, tmp_path):
        spans = traced_echo_spans(["one"])
        path = str(tmp_path / "t.trace.jsonl")
        tracer = Tracer(role="sim", clock=VirtualClock())
        tracer.spans = spans
        tracer.dump_jsonl(path)
        with open(path, "a") as f:
            f.write('{"name": "torn')
        back = load_jsonl(path)
        assert [s.to_json() for s in back] == [s.to_json() for s in spans]


class TestTcpPropagation:
    def test_trace_context_crosses_real_tcp(self):
        from frankenpaxos_tpu_torch.runtime.tcp_transport import TcpTransport

        logger = FakeLogger(LogLevel.FATAL)
        saddr = ("127.0.0.1", free_port())
        caddr = ("127.0.0.1", free_port())
        ts = TcpTransport(saddr, logger)
        tc = TcpTransport(caddr, logger)
        ts.tracer = Tracer(role="server")
        tc.tracer = Tracer(role="client")
        ts.start()
        tc.start()
        try:
            EchoServer(saddr, ts, logger)
            client = EchoClient(caddr, tc, logger, saddr)
            done = threading.Event()
            tc.loop.call_soon_threadsafe(
                client.echo, "hello", lambda _: done.set())
            assert done.wait(15), "echo never completed"
            assert wait_for(lambda: any(s.cat == "receive"
                                        for s in tc.tracer.spans))
            server_recv = [s for s in ts.tracer.spans if s.cat == "receive"]
            client_recv = [s for s in tc.tracer.spans if s.cat == "receive"]
            assert server_recv and client_recv
            assert server_recv[0].parent_id == 0
            assert client_recv[0].trace_id == server_recv[0].trace_id
            assert client_recv[0].parent_id != 0
        finally:
            ts.stop()
            tc.stop()


class TestMetricsOnlyStages:
    def test_stage_scope_feeds_histogram_without_tracer(self):
        collectors = FakeCollectors()
        metrics = RuntimeMetrics(collectors, "acceptor_0")
        with stage_scope(None, metrics, "wal-fsync"):
            pass
        hist = collectors.metrics["fpx_runtime_drain_stage_seconds"]
        assert hist.labels("acceptor_0", "wal-fsync").get_count() == 1
        fsync = collectors.metrics["fpx_runtime_wal_fsync_seconds"]
        assert fsync.labels("acceptor_0").get_count() == 1

    def test_stage_scope_noop_without_sinks(self):
        scope = stage_scope(None, None, "decode")
        with scope:
            pass
        assert scope is NOOP_SCOPE

    def test_tracer_stages_feed_runtime_metrics(self):
        collectors = FakeCollectors()
        metrics = RuntimeMetrics(collectors, "r0")
        tracer = Tracer(role="r0", clock=VirtualClock(),
                        runtime_metrics=metrics)
        with tracer.receive_span("a", "M", None):
            with tracer.stage("handler"):
                pass
        hist = collectors.metrics["fpx_runtime_drain_stage_seconds"]
        assert hist.labels("r0", "handler").get_count() == 1

    def test_wal_drain_stages_via_actor(self):
        sim = make_multipaxos(f=1, coalesced=True, wal=True)
        collectors = FakeCollectors()
        sim.transport.runtime_metrics = RuntimeMetrics(collectors, "sim")
        results: list = []
        sim.clients[0].write(0, b"cmd", results.append)
        sim.clients[0].flush_writes()
        sim.transport.deliver_all_coalesced()
        assert results
        fsync = collectors.metrics["fpx_runtime_wal_fsync_seconds"]
        assert fsync.labels("sim").get_count() > 0


# --- (b) batch frames and the SIGKILL post-mortem ------------------------------


def test_trace_context_rides_batch_header():
    """The frame-header TraceContext covers every message expanded from
    a batch frame: receive spans on the peer parent to the SENDER's
    context."""
    import frankenpaxos_tpu_torch.protocols.multipaxos  # noqa: F401
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        ClientRequest,
        Command,
        CommandId,
    )
    from frankenpaxos_tpu_torch.runtime.actor import Actor
    from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
    from frankenpaxos_tpu_torch.runtime.tcp_transport import TcpTransport

    class Sink(Actor):
        def __init__(self, *args):
            super().__init__(*args)
            self.got: list = []
            self.done = threading.Event()

        def receive(self, src, message):
            self.got.append(message)
            if len(self.got) == 30:
                self.done.set()

    logger = FakeLogger()
    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    ta = TcpTransport(a_addr, logger)
    tb = TcpTransport(b_addr, logger)
    tracer = Tracer("sink", sample_rate=1.0)
    tb.tracer = tracer
    ta.start()
    tb.start()
    try:
        sink = Sink(b_addr, tb, logger)
        ctx = TraceContext(trace_id=0xABC, span_id=0x123, sampled=True)

        def send_all():
            for i in range(30):
                ta._write(a_addr, b_addr, DEFAULT_SERIALIZER.to_bytes(
                    ClientRequest(Command(CommandId(("c", 1), 0, i), b"x"))),
                    flush=True, ctx=ctx)

        ta.loop.call_soon_threadsafe(send_all)
        assert sink.done.wait(10)
        assert wait_for(lambda: len(
            [s for s in tracer.spans if s.cat == "receive"]) >= 30)
        receive_spans = [s for s in tracer.spans if s.cat == "receive"]
        assert len(receive_spans) == 30
        assert all(s.trace_id == 0xABC and s.parent_id == 0x123
                   for s in receive_spans)
        assert ta.stat_frames < len(receive_spans)
    finally:
        ta.stop()
        tb.stop()


_ROLE = r"""
import sys, time
from frankenpaxos_tpu_torch.obs import FlightRecorder, Tracer, VirtualClock
tracer = Tracer(role="pipeline_0", clock=VirtualClock(),
                flight=FlightRecorder(sys.argv[1]))
for i in range(5):
    with tracer.receive_span("pipeline_0", "Drain", None):
        pass
tracer.event("ready")
print("ready", flush=True)
time.sleep(60)
"""


def _postmortem(directory: str, label: str, reporter) -> str:
    """The killed role's ring and its reporter's last summary dumped
    beside each other, numbered on repeated kills."""
    out = os.path.join(directory, f"{label}.telemetry.json")
    n = 1
    while os.path.exists(out):
        out = os.path.join(directory, f"{label}.telemetry.json.killed{n}")
        n += 1
    with open(out, "w") as f:
        json.dump(reporter.summary(), f)
    FlightRecorder.dump_file(os.path.join(directory, f"{label}.flight"),
                             out.replace(".telemetry.json", ".flight.json"))
    return out


def test_sigkill_postmortem_snapshots_telemetry(tmp_path):
    """A role killed with SIGKILL leaves its mmap'd flight ring (read
    back cold) and, beside it, the last device-counter summary of its
    telemetry reporter; a second kill numbers its dumps."""
    from frankenpaxos_tpu_torch.obs.telemetry import TelemetryReporter
    from tests.test_torch_telemetry import _run_1x1

    block = 1 << 6
    state = _run_1x1(window=1 << 9, block=block, iters=4)
    reporter = TelemetryReporter("pipeline_0", block_size=block)
    reporter.collect(state, t=1.0)
    ring = str(tmp_path / "pipeline_0.flight")
    env = dict(os.environ, PYTHONPATH=ROOT)
    for kill in range(2):
        proc = subprocess.Popen([sys.executable, "-c", _ROLE, ring],
                                stdout=subprocess.PIPE, env=env, cwd=ROOT)
        try:
            assert proc.stdout.readline().strip() == b"ready"
            os.kill(proc.pid, signal.SIGKILL)
            assert proc.wait(timeout=10) == -signal.SIGKILL
        finally:
            proc.stdout.close()
            if proc.poll() is None:
                proc.kill()
        out = _postmortem(str(tmp_path), "pipeline_0", reporter)
        records = FlightRecorder.read(ring)
        assert records[-1][2] == "event ready"
        assert sum(1 for _, _, t in records
                   if t.startswith("receive:Drain")) == 5 * (kill + 1)
    with open(tmp_path / "pipeline_0.telemetry.json") as f:
        summary = json.load(f)
    assert summary["collected"] is True
    assert summary["committed"] == 4 * block
    assert out.endswith(".killed1") and os.path.exists(out)
    assert os.path.exists(tmp_path / "pipeline_0.flight.json")


# --- (c) parity with the JAX package ------------------------------------------


#: (JAX harness options, port harness options) per tracker.
BACKENDS = {
    "dict": ({}, {}),
    "sync": (dict(quorum_backend="tpu"),
             dict(quorum_backend="cuda", device="cpu")),
    "pipelined": (dict(quorum_backend="tpu", tpu_pipelined=True),
                  dict(quorum_backend="cuda", tpu_pipelined=True,
                       device="cpu")),
}


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("writes,waves", [(4, 3), (16, 2)])
def test_multipaxos_span_dump_matches_the_reference(backend, writes,
                                                    waves):
    """Every span field (names, roles, virtual times and durations, trace
    / span / parent ids) is equal in both packages."""
    jax_options, port_options = BACKENDS[backend]
    ref = traced_multipaxos(jh.make_multipaxos,
                            jobs.Tracer(role="sim", clock=jobs.VirtualClock()),
                            writes, waves, **jax_options)
    port = traced_multipaxos(make_multipaxos,
                             Tracer(role="sim", clock=VirtualClock()),
                             writes, waves, **port_options)
    assert port == ref
    assert any(row["name"] == "stage:quorum-kernel" for row in port)


@pytest.mark.parametrize("payloads", [["one"], ["one", "two"], list("abcd")])
def test_echo_spans_and_exports_match_the_reference(payloads):
    port = traced_echo_spans(payloads)
    ref = jax_echo_spans(payloads)
    assert [s.to_json() for s in port] == [s.to_json() for s in ref]
    assert to_chrome_trace(port) == jperfetto.to_chrome_trace(ref)
    assert latency_breakdown(port) == jperfetto.latency_breakdown(ref)
    assert perfetto.format_breakdown(latency_breakdown(port)) == \
        jperfetto.format_breakdown(jperfetto.latency_breakdown(ref))
    for trace_id in {s.trace_id for s in port}:
        a = trace_tree(port, trace_id)
        b = jperfetto.trace_tree(ref, trace_id)
        assert a["roots"] == b["roots"] and a["children"] == b["children"]
        assert [s.to_json() for s in a["critical_path"]] == \
            [s.to_json() for s in b["critical_path"]]


def _feed(metrics) -> None:
    """The same events through every RuntimeMetrics entry point."""
    metrics.observe_stage("handler", 0.001)
    metrics.observe_stage("wal-fsync", 0.002)
    metrics.observe_batch(7)
    metrics.admission_admitted(3)
    metrics.admission_rejected("inflight", 2)
    metrics.admission_shed("drop-oldest")
    metrics.admission_inflight(5)
    metrics.admission_queue_depth(4)
    metrics.client_retry("backoff")
    metrics.ingest_batch(12, 480)
    metrics.ingest_shard_routed(1, 12)
    metrics.ingest_shard_state(1, owned_keys=3, pipeline_depth=2, skew=1.5)
    metrics.ingest_shard_failover(1)
    metrics.region_goodput("us", 9)
    metrics.region_shed("eu", 2)
    metrics.outbound_buffer_hwm(1024)
    metrics.outbound_buffer_hwm(512)
    metrics.outbound_stall(2)
    metrics.pipeline_interval(drains=4, committed=100, proposed=110,
                              pad_lanes=2, occupancy=(0, 0, 60, 40),
                              lag_hist=(5, 0, 1), shard_committed=(60, 40),
                              skew=1.2, fill=0.9)
    metrics.depset_batch(6)
    metrics.depset_span_fallback()
    metrics.fastquorum_check(3)
    metrics.transport_flush(8, 4096)
    metrics.transport_coalesced_acks(5)


def _exposition(collectors) -> dict:
    """Every labelled series of a FakeCollectors as plain values."""
    out = {}
    for name, metric in collectors.metrics.items():
        for labels, child in metric._children.items():
            if hasattr(child, "bucket_counts"):
                out[(name, labels)] = (child._root.count, child._root.value,
                                       tuple(child.bucket_counts))
            else:
                out[(name, labels)] = (child.value, child.count)
    return out


def test_runtime_metrics_series_match_the_reference():
    port, ref = FakeCollectors(), JFakeCollectors()
    _feed(RuntimeMetrics(port, "r0"))
    _feed(jobs.RuntimeMetrics(ref, "r0"))
    assert set(port.metrics) == set(ref.metrics)
    got = _exposition(port)
    assert got == _exposition(ref)
    assert got[("fpx_runtime_outbound_buffer_bytes", ("r0",))][0] == 1024


def test_telemetry_publishes_onto_runtime_metrics():
    """A reporter with a RuntimeMetrics publishes each interval's deltas
    into the fpx_pipeline_* series, and its counter tracks merge into
    the span export."""
    from frankenpaxos_tpu_torch.obs.telemetry import TelemetryReporter
    from tests.test_torch_telemetry import _run_1x1

    block = 1 << 6
    collectors = FakeCollectors()
    reporter = TelemetryReporter("pipeline_0",
                                 RuntimeMetrics(collectors, "pipeline_0"),
                                 block_size=block)
    reporter.collect(_run_1x1(window=1 << 9, block=block, iters=2), t=1.0)
    reporter.collect(_run_1x1(window=1 << 9, block=block, iters=5), t=2.0)
    committed = collectors.metrics["fpx_pipeline_committed_total"]
    assert committed.labels("pipeline_0").get() == 5 * block
    drains = collectors.metrics["fpx_pipeline_drains_total"]
    assert drains.labels("pipeline_0").get() == 5
    spans = traced_echo_spans(["one"])
    trace = to_chrome_trace(spans, reporter.counter_events())
    counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert len(counters) == 4
    assert counters[2]["args"]["committed"] == 3 * block


# --- (d) the traced TCP bench, the CLI and WPaxos's region export -------------


def test_traced_tcp_bench_on_cpu():
    from frankenpaxos_tpu_torch.bench import traced_tcp

    result = traced_tcp.run("cpu", writes=1024)
    assert result["nvidia_smi"] is None
    for arm, fig in result["arms"].items():
        assert fig["writes"] == 1024 and fig["spans"] > 0
        assert fig["path"][0].startswith(("timer:closedLoopStart@",
                                          "receive:ClientRequest"))
        assert fig["path"][-1].startswith("receive:ClientReply")
        assert any(n == "stage:quorum-kernel" for n in fig["path"])
        assert set(fig["flight_records"]) == {"supernode_0.flight",
                                              "client_0.flight"}
        assert "quorum-kernel" in fig["breakdown"]


def test_a_trace_without_the_reply_fails_the_gate(tmp_path):
    from frankenpaxos_tpu_torch.bench import traced_tcp

    spans = traced_echo_spans(["one"])
    assert traced_tcp.find_path(spans, {"server"}, True) is None


def test_obs_cli_merges_dumps(tmp_path, capsys):
    for role, payloads in (("a", ["one"]), ("b", ["two", "three"])):
        tracer = Tracer(role=role, clock=VirtualClock())
        tracer.spans = traced_echo_spans(payloads)
        tracer.dump_jsonl(str(tmp_path / f"{role}.trace.jsonl"))
    ring = FlightRecorder(str(tmp_path / "a.flight"), slots=4, slot_size=64)
    ring.record(0.5, "hello")
    ring.close()
    out = str(tmp_path / "trace.json")
    assert obs_main.main([str(tmp_path), "--out", out, "--breakdown",
                          "--flight", str(tmp_path / "a.flight")]) == 0
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    assert sum(1 for e in events if e["ph"] == "X") == \
        len(traced_echo_spans(["one"])) + len(traced_echo_spans(["a", "b"]))
    printed = capsys.readouterr().out
    assert "decode" in printed and "handler" in printed
    with open(str(tmp_path / "a.flight") + ".json") as f:
        assert json.load(f)["records"][0]["text"] == "hello"
    assert obs_main.main([]) == 2


def test_wpaxos_leaders_export_region_goodput():
    """With a RuntimeMetrics on the geo transport, every leader drain
    exports its commits under its zone's region."""
    from frankenpaxos_tpu_torch.protocols.wpaxos.harness import (
        drive,
        make_wpaxos,
    )

    sim = make_wpaxos()
    collectors = FakeCollectors()
    sim.transport.runtime_metrics = RuntimeMetrics(collectors, "geo")
    got = drive(sim, 4, key_prefix=b"obj1")
    assert len(got) == 4
    goodput = collectors.metrics["fpx_runtime_region_goodput_cmds_total"]
    group = sim.config.group_of_key(b"obj1")
    region = sim.config.zones[sim.config.initial_home[group]]
    assert {labels: child.value
            for labels, child in goodput._children.items()} == {
        ("geo", region): 4}
