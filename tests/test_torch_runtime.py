"""The port's host runtime: SimTransport semantics, timers, loggers and
metrics (the SimTransport / actor / timer cases of
``tests/test_runtime.py`` repeated against the port), the wave engine's
partition mask and batched delivery, and delivery order equal to the
JAX package's SimTransport on the same traffic -- with bounded
client-lane inboxes armed too (the two admission cases of
``tests/test_sim_core.py``, the port against the JAX package's
transport where the reference held its wave engine against the legacy
core)."""

import dataclasses
import random
from typing import Callable, Optional

from frankenpaxos_tpu_torch import runtime as truntime
from frankenpaxos_tpu_torch.obs.trace import NOOP_SCOPE
from frankenpaxos_tpu_torch.ops import simwave
from frankenpaxos_tpu_torch.runtime import (
    Actor,
    FakeCollectors,
    FakeLogger,
    LogLevel,
    PickleSerializer,
    SimTransport,
)
from frankenpaxos_tpu_torch.runtime.logger import FatalError
import numpy as np
import pytest

from frankenpaxos_tpu import runtime as jruntime
from frankenpaxos_tpu.ops import simwave as jsimwave


@dataclasses.dataclass(frozen=True)
class EchoRequest:
    msg: str


@dataclasses.dataclass(frozen=True)
class EchoReply:
    msg: str


def _echo_classes(actor_base):
    """The reference's echo protocol (protocols/echo.py) over either
    package's Actor."""

    class EchoServer(actor_base):
        def __init__(self, address, transport, logger):
            super().__init__(address, transport, logger)
            self.num_messages_received = 0

        def receive(self, src, message):
            self.num_messages_received += 1
            self.send(src, EchoReply(msg=message.msg))

    class EchoClient(actor_base):
        def __init__(self, address, transport, logger, server_address,
                     ping_period_s: float = 1.0):
            super().__init__(address, transport, logger)
            self.server_address = server_address
            self.num_messages_received = 0
            self.replies: list = []
            self._callbacks: list[Callable[[str], None]] = []
            self.ping_timer = self.timer("ping", ping_period_s, self._ping)

        def _ping(self):
            self.send(self.server_address, EchoRequest(msg="ping"))
            self.ping_timer.start()

        def echo(self, msg: str,
                 callback: Optional[Callable[[str], None]] = None):
            if callback is not None:
                self._callbacks.append(callback)
            self.send(self.server_address, EchoRequest(msg=msg))

        def receive(self, src, message):
            self.num_messages_received += 1
            self.replies.append(message.msg)
            if self._callbacks:
                self._callbacks.pop(0)(message.msg)

    return EchoServer, EchoClient


EchoServer, EchoClient = _echo_classes(Actor)


def make_echo():
    logger = FakeLogger()
    transport = SimTransport(logger)
    server = EchoServer("server", transport, logger)
    client = EchoClient("client", transport, logger, "server")
    return transport, server, client


class TestSimTransport:
    def test_messages_buffer_until_delivered(self):
        transport, server, client = make_echo()
        client.echo("hi")
        assert server.num_messages_received == 0
        assert len(transport.messages) == 1
        transport.deliver_message(transport.messages[0])
        assert server.num_messages_received == 1
        assert len(transport.messages) == 1
        transport.deliver_message(transport.messages[0])
        assert client.num_messages_received == 1

    def test_echo_round_trip_with_callback(self):
        transport, _, client = make_echo()
        got = []
        client.echo("hello", got.append)
        transport.deliver_all()
        assert got == ["hello"]

    def test_messages_can_be_reordered(self):
        transport, server, client = make_echo()
        client.echo("a")
        client.echo("b")
        m_a, m_b = transport.messages
        transport.deliver_message(m_b)
        transport.deliver_message(m_a)
        assert server.num_messages_received == 2
        transport.deliver_all()
        assert client.replies == ["b", "a"]

    def test_messages_can_be_dropped(self):
        transport, server, client = make_echo()
        client.echo("lost")
        transport.messages.clear()
        transport.deliver_all()
        assert server.num_messages_received == 0

    def test_delivering_removed_message_is_noop(self):
        transport, server, client = make_echo()
        client.echo("x")
        msg = transport.messages[0]
        transport.deliver_message(msg)
        transport.deliver_message(msg)  # already delivered: warn + drop
        assert server.num_messages_received == 1
        assert any(level == LogLevel.WARN
                   for level, _ in transport.logger.records)

    def test_timers_fire_only_when_triggered(self):
        transport, server, client = make_echo()
        client.ping_timer.start()
        assert transport.running_timers() == [client.ping_timer]
        transport.trigger_timer(client.ping_timer.id)
        assert len(transport.messages) == 1
        assert client.ping_timer.running

    def test_stopped_timer_does_not_fire(self):
        transport, server, client = make_echo()
        client.ping_timer.start()
        client.ping_timer.stop()
        transport.trigger_timer(client.ping_timer.id)
        assert transport.messages == []
        assert transport.running_timers() == []

    def test_partition_drops_messages(self):
        transport, server, client = make_echo()
        transport.partition("server")
        client.echo("into the void")
        transport.deliver_all()
        assert server.num_messages_received == 0
        transport.heal("server")
        client.echo("hello again")
        transport.deliver_all()
        assert server.num_messages_received == 1

    def test_partitioned_timer_is_stopped_not_fired(self):
        transport, server, client = make_echo()
        client.ping_timer.start()
        transport.partition("client")
        transport.trigger_timer(client.ping_timer.id)
        assert transport.messages == [] and not client.ping_timer.running

    def test_generate_command_exhaustive(self):
        transport, server, client = make_echo()
        rng = random.Random(0)
        assert transport.generate_command(rng) is None
        client.echo("a")
        client.ping_timer.start()
        kinds = set()
        for _ in range(50):
            cmd = transport.generate_command(rng)
            kinds.add(type(cmd).__name__)
        assert kinds == {"DeliverMessage", "TriggerTimer"}
        assert {type(c).__name__ for c in transport.possible_commands()} \
            == {"DeliverMessage", "TriggerTimer"}

    def test_duplicate_registration_rejected(self):
        transport, server, client = make_echo()
        with pytest.raises(ValueError):
            EchoServer("server", transport, FakeLogger())

    def test_crash_deregisters_and_kills_timers(self):
        transport, server, client = make_echo()
        client.ping_timer.start()
        client.echo("late")
        transport.crash("server")
        transport.crash("client")
        assert transport.running_timers() == []
        transport.deliver_all()  # to a dead address: dropped
        assert server.num_messages_received == 0

    def test_max_steps_bounds_one_call(self):
        transport, server, client = make_echo()
        for i in range(10):
            client.echo(str(i))
        assert transport.deliver_all_coalesced(max_steps=4) == 4
        assert server.num_messages_received == 4


class _BatchServer(EchoServer):
    """Overrides receive_batch, so coalesced waves hand it runs."""

    def __init__(self, *args):
        super().__init__(*args)
        self.runs: list[int] = []
        self.drains = 0

    def receive_batch(self, batch):
        self.runs.append(len(batch))
        super().receive_batch(batch)

    def on_drain(self):
        self.drains += 1


class TestWaveEngine:
    def test_coalesced_wave_batches_runs_and_drains_once(self):
        logger = FakeLogger()
        transport = SimTransport(logger)
        server = _BatchServer("server", transport, logger)
        client = EchoClient("client", transport, logger, "server")
        for i in range(40):
            client.echo(str(i))
        transport.deliver_all_coalesced()
        assert server.runs == [40] and server.drains == 1
        assert client.replies == [str(i) for i in range(40)]

    def test_per_message_delivery_drains_every_message(self):
        logger = FakeLogger()
        transport = SimTransport(logger)
        server = _BatchServer("server", transport, logger)
        client = EchoClient("client", transport, logger, "server")
        for i in range(5):
            client.echo(str(i))
        transport.deliver_all()
        assert server.runs == [] and server.drains == 5

    def test_vectorized_partition_mask_drops_like_the_scalar_check(self):
        """Waves at or above WAVE_VECTOR_MIN take the numpy mask; the
        result equals the per-message rule."""
        logger = FakeLogger()
        transport = SimTransport(logger)
        servers = [EchoServer(f"s{i}", transport, logger) for i in range(4)]
        clients = [EchoClient(f"c{i}", transport, logger, f"s{i % 4}")
                   for i in range(8)]
        for k in range(simwave.WAVE_VECTOR_MIN * 2):
            clients[k % 8].echo(str(k))
        transport.partition("s1")
        transport.partition("c2")
        transport.deliver_all_coalesced()
        assert servers[1].num_messages_received == 0
        assert clients[2].num_messages_received == 0
        assert servers[0].num_messages_received == 16  # c0 and c4
        assert servers[2].num_messages_received == 8   # c6 (c2 is cut)
        assert clients[6].num_messages_received == 8

    def test_keep_mask_matches_the_reference(self):
        rng = np.random.default_rng(3)
        src = rng.integers(0, 20, 500)
        dst = rng.integers(0, 20, 500)
        for blocked in (np.array([], np.int64), np.array([3, 7, 19])):
            np.testing.assert_array_equal(
                simwave.keep_mask(src, dst, blocked),
                jsimwave.keep_mask(src, dst, blocked))
        up = rng.random((6, 6)) < 0.7
        up[-1, :] = up[:, -1] = True
        zs, zd = rng.integers(-1, 5, 300), rng.integers(-1, 5, 300)
        np.testing.assert_array_equal(simwave.link_keep_mask(zs, zd, up),
                                      jsimwave.link_keep_mask(zs, zd, up))


def _traffic(runtime, echo_classes, seed: int, coalesce: bool) -> list:
    """A random echo workload on either package's SimTransport: the
    delivered history as (src, dst, msg) plus every client's replies."""
    server_cls, client_cls = echo_classes
    logger = runtime.FakeLogger()
    transport = runtime.SimTransport(logger)
    servers = [server_cls(f"s{i}", transport, logger) for i in range(3)]
    clients = [client_cls(f"c{i}", transport, logger, f"s{i % 3}")
               for i in range(5)]
    rng = random.Random(seed)
    for step in range(30):
        for _ in range(rng.randrange(1, 12)):
            rng.choice(clients).echo(f"{step}.{rng.randrange(100)}")
        if rng.random() < 0.2:
            transport.partition(rng.choice(["s0", "s1", "s2", "c0", "c1"]))
        if rng.random() < 0.3 and transport.partitioned:
            transport.heal(sorted(transport.partitioned)[0])
        if coalesce:
            transport.deliver_all_coalesced(max_steps=rng.randrange(5, 80))
        else:
            transport.deliver_all(max_steps=rng.randrange(5, 80))
    history = [(c.message.src, c.message.dst,
                transport.actors[c.message.dst].serializer.from_bytes(
                    c.message.data).msg)
               for c in transport.history]
    return history, [c.replies for c in clients], \
        [s.num_messages_received for s in servers]


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delivery_order_matches_the_reference(seed, coalesce):
    port = _traffic(truntime, (EchoServer, EchoClient), seed, coalesce)
    ref = _traffic(jruntime, _echo_classes(jruntime.Actor), seed, coalesce)
    assert port == ref
    assert len(port[0]) > 50


class TestLogger:
    def test_levels_filter(self):
        logger = FakeLogger(LogLevel.WARN)
        logger.debug("nope")
        logger.warn("yes")
        assert logger.records == [(LogLevel.WARN, "yes")]

    def test_lazy_messages_not_forced_when_filtered(self):
        logger = FakeLogger(LogLevel.ERROR)
        logger.debug(lambda: 1 / 0)  # must not evaluate

    def test_fatal_raises(self):
        logger = FakeLogger()
        with pytest.raises(FatalError):
            logger.fatal("boom")

    def test_checks(self):
        logger = FakeLogger()
        logger.check_eq(1, 1)
        logger.check_lt(1, 2)
        with pytest.raises(FatalError):
            logger.check_eq(1, 2)
        with pytest.raises(FatalError):
            logger.check(False)


class TestMetrics:
    def test_fake_counter_and_summary(self):
        collectors = FakeCollectors()
        c = collectors.counter("requests_total")
        c.inc()
        c.inc(2)
        assert c.get() == 3
        s = collectors.summary("latency")
        s.observe(0.5)
        s.observe(1.5)
        assert s.get_count() == 2
        assert s.get_sum() == 2.0
        g = collectors.gauge("depth")
        g.set(7)
        g.dec()
        assert g.get() == 6

    def test_same_name_same_metric(self):
        collectors = FakeCollectors()
        assert collectors.counter("x") is collectors.counter("x")


class TestUnported:
    def test_stage_scope_is_a_noop_or_a_metrics_timer(self):
        transport, server, client = make_echo()
        assert server.trace_stage("handler") is NOOP_SCOPE
        seen = []

        class Metrics:
            def observe_stage(self, name, seconds):
                seen.append(name)

        transport.runtime_metrics = Metrics()
        with server.trace_stage("quorum-kernel"):
            pass
        assert seen == ["quorum-kernel"]

    def test_traced_echo_records_spans(self):
        """A tracer on the SimTransport: each delivery is a receive span
        with decode and handler stages, the reply's frame carries the
        server handler's context, and ``trace_stage`` opens a sub-span
        of the current span."""
        from frankenpaxos_tpu_torch.obs import Tracer, VirtualClock

        transport, server, client = make_echo()
        tracer = Tracer(role="sim", clock=VirtualClock())
        transport.tracer = tracer
        client.echo("x")
        transport.deliver_all()
        receives = [s for s in tracer.spans if s.cat == "receive"]
        assert [s.name for s in receives] == [
            "receive:EchoRequest@server", "receive:EchoReply@client"]
        assert receives[0].parent_id == 0
        handler = next(s for s in tracer.spans if s.name == "stage:handler"
                       and s.parent_id == receives[0].span_id)
        assert receives[1].parent_id == handler.span_id
        assert receives[1].trace_id == receives[0].trace_id
        with tracer.receive_span("server", "M", None) as span:
            with server.trace_stage("quorum-kernel"):
                pass
        stage = tracer.spans[-2]
        assert stage.name == "stage:quorum-kernel"
        assert stage.parent_id == span.ctx.span_id

    def test_pickle_serializer_round_trips(self):
        ser = PickleSerializer()
        assert ser.from_bytes(ser.to_bytes(EchoReply("x"))) == EchoReply("x")


# --- bounded client-lane inboxes (tests/test_sim_core.py's two cases) ------


def _projection(transport) -> list:
    """The delivered history as comparable rows (ids are allocated in
    construction order, so equal rows mean equal schedules)."""
    rows = []
    for command in transport.history:
        m = command.message
        rows.append(("deliver", m.id, str(m.src), str(m.dst),
                     bytes(m.data)))
    return rows


def _armed_harnesses():
    from frankenpaxos_tpu_torch.protocols.multipaxos import harness as th
    from tests.protocols import multipaxos_harness as jh

    return th, jh


def test_partition_drops_still_decrement_armed_inbox():
    """_deliver decrements the bounded-inbox depth BEFORE the partition
    check (the frame left the buffer either way); the wave engine keeps
    that order, or a partitioned leader's inbox depth ratchets up and
    sheds spuriously after heal. The port's transport against the JAX
    package's on the same traffic."""
    results = []
    for harness in _armed_harnesses():
        sim = harness.make_multipaxos(
            f=1, coalesced=False,
            leader_admission=dict(admission_inbox_capacity=40,
                                  admission_inbox_policy="drop"))
        leader = sim.leaders[0]
        t = sim.transport
        for i in range(36):  # > WAVE_VECTOR_MIN so the mask path runs
            sim.clients[0].write(i, b"w%d" % i, lambda r: None)
        t.partition(leader.address)
        t.deliver_all_coalesced()
        t.heal(leader.address)
        for i in range(36, 44):
            sim.clients[0].write(i, b"w%d" % i, lambda r: None)
        t.deliver_all_coalesced()
        results.append((t._inbox_depth.get(leader.address, 0),
                        dict(leader.admission.rejected),
                        _projection(t)))
    assert results[0] == results[1]
    assert results[0][2]


def test_drop_oldest_mid_wave_shed_is_not_delivered():
    """A frame shed by drop-oldest while it sat in an in-flight wave
    must not reach its handler: flood an armed leader from inside a
    wave handler and compare with the JAX package's transport."""
    results = []
    for harness in _armed_harnesses():
        sim = harness.make_multipaxos(
            f=1, coalesced=False,
            leader_admission=dict(admission_inbox_capacity=2,
                                  admission_inbox_policy="drop"))
        leader = sim.leaders[0]
        for i in range(8):
            sim.clients[0].write(i, b"w%d" % i, lambda r: None)
        sim.transport.deliver_all_coalesced()
        results.append((leader.admission.rejected.get(
            "shed_drop-oldest", 0), _projection(sim.transport)))
    assert results[0] == results[1]
    assert results[0][0] > 0
