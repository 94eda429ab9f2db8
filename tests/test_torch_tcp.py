"""The port's TcpTransport and paxwire over real loopback sockets: the
cases of ``tests/test_tcp_transport.py`` and ``tests/test_paxwire.py``
repeated against the port (with test-local echo and append-log actors,
as ``tests/test_torch_runtime.py`` has them), the tracer as a refusal,
an actor's wire sinks and its bounded client-lane inbox, and interop with the JAX package's TcpTransport in
both directions: MultiPaxos messages and batch frames arrive equal, and
Phase2b ack streams coalesce into the same ranges.

Every wait is bounded and every transport is stopped in ``finally``."""

import asyncio
import socket
import struct
import threading
import time

from frankenpaxos_tpu_torch import native
import frankenpaxos_tpu_torch.protocols.multipaxos  # noqa: F401 - codecs
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    Chosen,
    ClientRequest,
    Command,
    CommandId,
    NOOP,
    Phase2b,
    Phase2bRange,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _coalesce_phase2b,
    Phase2bAckBatch,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, paxwire
from frankenpaxos_tpu_torch.runtime.actor import Actor
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
from frankenpaxos_tpu_torch.runtime.tcp_transport import (
    _encode_frame,
    TcpTransport,
)
from frankenpaxos_tpu_torch.serve.lanes import (
    frame_lane,
    LANE_CLIENT,
    LANE_CONTROL,
)
from frankenpaxos_tpu_torch.statemachine import AppendLog
import pytest

import frankenpaxos_tpu.protocols.multipaxos  # noqa: F401 - JAX codecs
from frankenpaxos_tpu.runtime import (
    FakeLogger as JFakeLogger,
    LogLevel as JLogLevel,
)
from frankenpaxos_tpu.runtime.actor import Actor as JActor
from frankenpaxos_tpu.runtime.tcp_transport import (
    TcpTransport as JTcpTransport,
)
from tests.test_torch_wire import _same, PORT, REF, seeded_samples

_LEN = struct.Struct(">I")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(predicate, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


@pytest.fixture
def transports():
    created = []

    def make(address=None, cls=TcpTransport, logger=None, **kwargs):
        t = cls(address, logger or FakeLogger(), **kwargs)
        created.append(t)
        t.start()
        return t

    try:
        yield make
    finally:
        for t in created:
            t.stop()


# --- test-local actors (the reference's echo and unreplicated roles) --------


class EchoServer(Actor):
    def __init__(self, address, transport, logger):
        super().__init__(address, transport, logger)
        self.num_messages_received = 0

    def receive(self, src, message):
        self.num_messages_received += 1
        self.send(src, ("echo", message[1]))


class EchoClient(Actor):
    def __init__(self, address, transport, logger, server_address):
        super().__init__(address, transport, logger)
        self.server_address = server_address
        self._callbacks: list = []

    def echo(self, msg: str, callback) -> None:
        def go():
            self._callbacks.append(callback)
            self.send(self.server_address, ("echo", msg))

        self.transport.loop.call_soon_threadsafe(go)

    def receive(self, src, message):
        if self._callbacks:
            self._callbacks.pop(0)(message[1])


class LogServer(Actor):
    """Runs each command on an AppendLog and replies with send_no_flush,
    flushing every ``flush_every_n`` replies (the unreplicated server's
    write batching)."""

    def __init__(self, address, transport, logger, flush_every_n):
        super().__init__(address, transport, logger)
        self.state_machine = AppendLog()
        self.flush_every_n = flush_every_n
        self.unflushed: dict = {}

    def receive(self, src, message):
        pseudonym, command = message
        result = self.state_machine.run(command)
        self.send_no_flush(src, (pseudonym, result))
        self.unflushed[src] = self.unflushed.get(src, 0) + 1
        if self.unflushed[src] >= self.flush_every_n:
            self.flush(src)
            self.unflushed[src] = 0


class LogClient(Actor):
    def __init__(self, address, transport, logger, server_address):
        super().__init__(address, transport, logger)
        self.server_address = server_address
        self.pending: dict = {}

    def propose(self, pseudonym, command, callback) -> None:
        def go():
            if pseudonym in self.pending:
                raise RuntimeError(f"pseudonym {pseudonym} is busy")
            self.pending[pseudonym] = callback
            self.send(self.server_address, (pseudonym, command))

        self.transport.loop.call_soon_threadsafe(go)

    def receive(self, src, message):
        pseudonym, result = message
        self.pending.pop(pseudonym)(result)


class Sink(Actor):
    def __init__(self, address, transport, logger, want=0):
        super().__init__(address, transport, logger)
        self.got: list = []
        self.done = threading.Event()
        self.want = want

    def receive(self, src, message):
        self.got.append(message)
        if self.want and len(self.got) >= self.want:
            self.done.set()


class Src(Actor):
    def receive(self, src, message):
        pass


# --- tests/test_tcp_transport.py, repeated -----------------------------------


def test_frame_encoding_roundtrip():
    frame = _encode_frame(("127.0.0.1", 9000), b"payload")
    (length,) = struct.unpack(">I", frame[:4])
    assert length == len(frame) - 4
    (hlen,) = struct.unpack(">I", frame[4:8])
    assert frame[8:8 + hlen] == b"127.0.0.1:9000"
    assert frame[8 + hlen:] == b"payload"


def test_oversized_frame_rejected():
    with pytest.raises(ValueError):
        _encode_frame(("h", 1), b"x" * (10 * 1024 * 1024 + 1))


def test_echo_over_tcp(transports):
    server_addr = ("127.0.0.1", free_port())
    client_addr = ("127.0.0.1", free_port())
    server_t = transports(server_addr)
    client_t = transports(client_addr)
    logger = FakeLogger()
    server = EchoServer(server_addr, server_t, logger)
    client = EchoClient(client_addr, client_t, logger, server_addr)
    got = []
    client.echo("over tcp", got.append)
    assert wait_for(lambda: got == ["over tcp"])
    assert server.num_messages_received == 1


def test_append_log_over_tcp_with_batching(transports):
    server_addr = ("127.0.0.1", free_port())
    client_addr = ("127.0.0.1", free_port())
    server_t = transports(server_addr)
    client_t = transports(client_addr)
    logger = FakeLogger()
    server = LogServer(server_addr, server_t, logger, flush_every_n=4)
    client = LogClient(client_addr, client_t, logger, server_addr)
    results = []
    done = threading.Event()

    def on_reply(pseudonym, round, result):
        results.append((pseudonym, round, result))
        if len(results) == 8:
            done.set()
        elif round == 0:
            client.propose(pseudonym, b"cmd-%d-1" % pseudonym,
                           lambda r, p=pseudonym: on_reply(p, 1, r))

    for p in range(4):
        client.propose(p, b"cmd-%d-0" % p, lambda r, p=p: on_reply(p, 0, r))
    assert done.wait(timeout=10)
    assert len(server.state_machine.get()) == 8
    assert {(p, r) for p, r, _ in results} == {(p, r) for p in range(4)
                                              for r in range(2)}


def test_timer_fires_and_resets(transports):
    t = transports(("127.0.0.1", free_port()))
    fired = []
    timer = t.timer(("x", 0), "t", 0.05, lambda: fired.append(1))
    timer.start()
    assert wait_for(lambda: fired == [1])
    time.sleep(0.1)
    assert fired == [1]
    timer.start()
    assert wait_for(lambda: fired == [1, 1])


def test_timer_stop_prevents_fire(transports):
    t = transports(("127.0.0.1", free_port()))
    fired = []
    timer = t.timer(("x", 0), "t", 0.2, lambda: fired.append(1))
    timer.start()
    timer.stop()
    time.sleep(0.35)
    assert fired == []


def test_connect_failure_drops_and_logs(transports):
    logger = FakeLogger()
    t = transports(("127.0.0.1", free_port()), logger=logger)
    dead = ("127.0.0.1", free_port())
    t.send(t.listen_address, dead, b"hello?")
    assert wait_for(lambda: any("connect" in m for _, m in logger.records))


def test_burst_beyond_scanner_frame_cap(transports):
    """More frames in one flush than one native scan pass returns (4096)
    must all dispatch: the receive loop re-scans the backlog."""
    logger = FakeLogger(LogLevel.FATAL)
    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    ta = transports(a_addr, logger=logger)
    tb = transports(b_addr, logger=logger)
    n = 6000
    sink = Sink(b_addr, tb, logger, want=n)
    src = Src(a_addr, ta, logger)

    def send():
        for i in range(n):
            src.send_no_flush(b_addr, b"m%d" % i)
        src.flush(b_addr)

    ta.loop.call_soon_threadsafe(send)
    assert sink.done.wait(30), f"only {len(sink.got)}/{n} delivered"


def test_corrupt_frame_drops_connection_not_server(transports):
    server_addr = ("127.0.0.1", free_port())
    client_addr = ("127.0.0.1", free_port())
    server_logger = FakeLogger()
    server_t = transports(server_addr, logger=server_logger)
    logger = FakeLogger()
    server = EchoServer(server_addr, server_t, logger)
    bad_inner = struct.pack(">I", 9999) + b"xx"
    bad = struct.pack(">I", len(bad_inner)) + bad_inner
    with socket.create_connection(server_addr, timeout=5) as s:
        s.sendall(bad)
        s.settimeout(5)
        assert s.recv(1) == b""
    assert wait_for(lambda: any("corrupt frame" in m
                                for _, m in server_logger.records))
    client_t = transports(client_addr)
    client = EchoClient(client_addr, client_t, logger, server_addr)
    got = []
    client.echo("still alive", got.append)
    assert wait_for(lambda: got == ["still alive"])
    assert server.num_messages_received == 1


# --- the refusals ------------------------------------------------------------


def test_a_tracer_is_refused():
    """The port has no tracer (ROADMAP.md queue 1 item 8.5): a transport
    with one attached refuses to start, and refuses every drain and
    timer it would run."""
    t = TcpTransport(("127.0.0.1", free_port()), FakeLogger())
    t.tracer = object()
    with pytest.raises(NotImplementedError, match="item 8.5"):
        t.start()
    t.stop()
    t = TcpTransport(("127.0.0.1", free_port()), FakeLogger())
    t.start()
    try:
        t.tracer = object()
        with pytest.raises(NotImplementedError, match="item 8.5"):
            t._check_untraced()
    finally:
        t.stop()


def test_wire_sink_takes_a_batch_frame_whole(transports):
    """An actor's wire sink gets a whole client batch frame as columns
    (one handler call a frame, no per-message decode); a frame whose
    parser declines it (None) falls back to per-message delivery."""
    from frankenpaxos_tpu_torch.ingest.columns import parse_client_batch

    class Columns(Sink):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.frames: list = []
            self.wire_sinks = {
                paxwire.CLIENT_BATCH_TAG: (parse_client_batch,
                                           self.take),
                paxwire.CONTROL_BATCH_TAG: (lambda data: None,
                                            self.take),
            }

        def take(self, src, colrun):
            self.frames.append(colrun)
            self.got.extend([None] * len(colrun))
            if len(self.got) >= self.want:
                self.done.set()

    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    ta, tb = transports(a_addr), transports(b_addr)
    logger = FakeLogger()
    n = 12
    sink = Columns(b_addr, tb, logger, want=n + 3)
    src = Src(a_addr, ta, logger)
    requests = [ClientRequest(Command(CommandId(a_addr, i, i), b"c%d" % i))
                for i in range(n)]
    acks = [Phase2b(group_index=0, acceptor_index=1, slot=5, round=0),
            Chosen(slot=1, value=NOOP), Chosen(slot=2, value=NOOP)]

    def send():
        for m in requests + acks:
            src.send_no_flush(b_addr, m)
        src.flush(b_addr)

    ta.loop.call_soon_threadsafe(send)
    assert sink.done.wait(10), f"only {len(sink.got)} delivered"
    assert sum(len(f) for f in sink.frames) == n
    assert tb.stat_sink_messages == n
    assert tb.stat_sink_frames == len(sink.frames) >= 1
    rows = [int(c) for f in sink.frames for c in f.cols[:, 2]]
    assert rows == list(range(n))
    # The declined control frame arrived message by message.
    assert [type(m).__name__ for m in sink.got if m is not None] == \
        ["Phase2b", "Chosen", "Chosen"]
    assert not logger.records


def test_inbound_inbox_sheds_client_lane_only(transports):
    """An actor's bounded client-lane inbox over TCP: past the capacity
    within one drain, a client request is answered with an explicit
    Rejected (reason queue) and never reaches the handler; control
    frames of the same drain are never shed."""
    from frankenpaxos_tpu_torch.serve.admission import (
        AdmissionController,
        AdmissionOptions,
    )
    from frankenpaxos_tpu_torch.serve.messages import REASON_QUEUE, Rejected

    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    ta, tb = transports(a_addr), transports(b_addr)
    logger = FakeLogger()
    server = Sink(b_addr, tb, logger)
    server.admission = AdmissionController(
        AdmissionOptions(inbox_capacity=2, retry_after_ms=30))
    client = Sink(a_addr, ta, logger, want=4)
    n = 6

    def send():
        for i in range(n):
            client.send_no_flush(b_addr, ClientRequest(Command(
                CommandId(a_addr, i, i), b"c%d" % i)))
            client.send_no_flush(b_addr, Chosen(slot=i, value=NOOP))
        client.flush(b_addr)

    ta.loop.call_soon_threadsafe(send)
    assert client.done.wait(10), f"{len(client.got)} replies"
    assert wait_for(lambda: len(server.got) == n + 2)
    names = [type(m).__name__ for m in server.got]
    assert names.count("Chosen") == n and names.count("ClientRequest") == 2
    assert all(isinstance(m, Rejected) and m.reason == REASON_QUEUE
               and m.retry_after_ms == 30 for m in client.got)
    assert sorted(e for m in client.got for e in m.entries) == \
        [(i, i) for i in range(2, n)]
    assert server.admission.rejected == {"shed_reject-newest": 4}


# --- tests/test_paxwire.py, repeated -----------------------------------------


def _client_request(i: int) -> bytes:
    return DEFAULT_SERIALIZER.to_bytes(
        ClientRequest(Command(CommandId(("10.0.0.1", 7), 0, i), b"x")))


def _phase2b(slot: int, round: int = 0) -> bytes:
    return DEFAULT_SERIALIZER.to_bytes(
        Phase2b(group_index=0, acceptor_index=1, slot=slot, round=round))


def _scan_messages(wire: bytes) -> list:
    out = []
    frames, consumed = native.scan_frames(wire)
    assert consumed == len(wire)
    for start, end in frames:
        (hlen,) = _LEN.unpack_from(wire, start)
        data = wire[start + 4 + hlen:end]
        if paxwire.is_batch_payload(data):
            out.extend(DEFAULT_SERIALIZER.from_bytes(seg)
                       for seg in paxwire.split_batch(data))
        else:
            out.append(DEFAULT_SERIALIZER.from_bytes(data))
    return out


def test_plan_flush_batches_adjacent_same_type_runs():
    entries = [(b"10.0.0.1:9", _client_request(i), LANE_CLIENT, 0)
               for i in range(5)]
    plan = paxwire.plan_flush(entries)
    assert plan.frames == 1 and plan.messages == 5
    wire = b"".join(bytes(s) for s in plan.segments)
    assert len(wire) == plan.nbytes
    (inner,) = _LEN.unpack_from(wire, 0)
    (hlen,) = _LEN.unpack_from(wire, 4)
    payload = wire[8 + hlen:4 + inner + 4]
    assert payload[0] == 0
    assert payload[1] + 128 == paxwire.CLIENT_BATCH_TAG


def test_plan_flush_preserves_order_across_type_boundaries():
    chosen = DEFAULT_SERIALIZER.to_bytes(Chosen(slot=4, value=NOOP))
    entries = [(b"h:1", _client_request(0), LANE_CLIENT, 0),
               (b"h:1", chosen, LANE_CONTROL, 0),
               (b"h:1", _client_request(1), LANE_CLIENT, 0),
               (b"h:1", _client_request(2), LANE_CLIENT, 0)]
    plan = paxwire.plan_flush(entries)
    assert plan.frames == 3
    messages = _scan_messages(b"".join(bytes(s) for s in plan.segments))
    assert [type(m).__name__ for m in messages] == [
        "ClientRequest", "Chosen", "ClientRequest", "ClientRequest"]


def test_plan_flush_singletons_stay_plain_frames():
    plan = paxwire.plan_flush([(b"h:1", _client_request(0), LANE_CLIENT, 0)])
    assert plan.frames == 1
    wire = b"".join(bytes(s) for s in plan.segments)
    (hlen,) = _LEN.unpack_from(wire, 4)
    assert not paxwire.is_batch_payload(wire[8 + hlen:])


def test_batch_frame_round_trip_and_torn_tail_containment():
    segs = [_client_request(i) for i in range(4)]
    batch = paxwire.ClientFrameBatch(tuple(segs))
    data = DEFAULT_SERIALIZER.to_bytes(batch)
    decoded = DEFAULT_SERIALIZER.from_bytes(data)
    assert decoded == batch
    assert [type(m).__name__
            for m in decoded.__wire_expand__(DEFAULT_SERIALIZER)] == \
        ["ClientRequest"] * 4
    for cut in range(3, len(data) - 1, 7):
        with pytest.raises(ValueError):
            paxwire.split_batch(data[:cut])


def test_batch_frames_classify_by_lane_without_decode():
    client = paxwire.ClientFrameBatch((_client_request(0),))
    control = paxwire.FrameBatch((_phase2b(1),))
    assert frame_lane(DEFAULT_SERIALIZER.to_bytes(client)) == LANE_CLIENT
    assert frame_lane(DEFAULT_SERIALIZER.to_bytes(control)) == LANE_CONTROL
    plan = paxwire.plan_flush([(b"h:1", _client_request(i), LANE_CLIENT, 0)
                               for i in range(3)])
    wire = b"".join(bytes(s) for s in plan.segments)
    (hlen,) = _LEN.unpack_from(wire, 4)
    assert frame_lane(bytes(wire[8 + hlen:])) == LANE_CLIENT


def test_phase2b_coalescer_builds_run_granular_ranges():
    payloads = [_phase2b(s) for s in (5, 6, 7, 9, 12, 13)]
    merged = _coalesce_phase2b(payloads)
    assert merged is not None
    assert len(merged) < sum(len(p) for p in payloads)
    batch = DEFAULT_SERIALIZER.from_bytes(merged)
    assert isinstance(batch, Phase2bAckBatch)
    kinds = [(type(m).__name__, getattr(m, "slot", None),
              getattr(m, "slot_start_inclusive", None),
              getattr(m, "slot_end_exclusive", None))
             for m in batch.__wire_expand__(DEFAULT_SERIALIZER)]
    assert kinds == [("Phase2bRange", None, 5, 8),
                     ("Phase2b", 9, None, None),
                     ("Phase2bRange", None, 12, 14)]


def test_phase2b_coalescer_declines_mixed_or_foreign_payloads():
    assert _coalesce_phase2b([_phase2b(1), _client_request(0)]) is None
    assert _coalesce_phase2b([b"", b""]) is None


def test_plan_flush_invokes_registered_coalescer():
    entries = [(b"h:1", _phase2b(s), LANE_CONTROL, 0)
               for s in range(100, 164)]
    plan = paxwire.plan_flush(entries)
    assert plan.frames == 1 and plan.coalesced_acks == 64
    messages = _scan_messages(b"".join(bytes(s) for s in plan.segments))
    assert len(messages) == 1 and isinstance(messages[0], Phase2bAckBatch)
    (entry,) = messages[0].ranges
    assert entry[:2] == (100, 164)


async def _async_value(f):
    return f()


def test_outbound_shed_drops_client_lane_before_control():
    transport = TcpTransport(None, FakeLogger())
    transport.outbound_buffer_cap = 8 * 1024
    transport.start()
    try:
        dst = ("127.0.0.1", 1)

        def fill():
            conn = transport._conn_for(("x", 0), dst)
            conn.connecting = True  # pin: pending only grows
            control = _phase2b(1)
            client = DEFAULT_SERIALIZER.to_bytes(ClientRequest(
                Command(CommandId(("c", 1), 0, 0), b"p" * 400)))
            for _ in range(8):
                transport._write(("x", 0), dst, control, flush=False)
            for _ in range(64):
                transport._write(("x", 0), dst, client, flush=False)
            return conn

        conn = asyncio.run_coroutine_threadsafe(
            _async_value(fill), transport.loop).result(timeout=5)
        assert conn.pending_bytes <= transport.outbound_buffer_cap
        lanes = [entry[2] for entry in conn.pending]
        assert lanes.count(LANE_CONTROL) == 8
        assert 0 < lanes.count(LANE_CLIENT) < 64
        assert transport.stat_outbound_dropped == 64 - lanes.count(
            LANE_CLIENT)
    finally:
        transport.stop()


@pytest.mark.parametrize("sendmsg", [True, False],
                         ids=["writev", "joined-write"])
def test_batched_sends_arrive_and_coalesce(transports, sendmsg):
    logger = FakeLogger()
    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    ta = transports(a_addr)
    ta.use_sendmsg = sendmsg
    tb = transports(b_addr)
    sink = Sink(b_addr, tb, logger, want=200)
    src = Src(a_addr, ta, logger)

    def send_all():
        for i in range(200):
            src.send(b_addr, ClientRequest(
                Command(CommandId(("c", 1), 0, i), b"w%d" % i)))

    ta.loop.call_soon_threadsafe(send_all)
    assert sink.done.wait(10), f"only {len(sink.got)}/200 delivered"
    assert [m.command.command_id.client_id for m in sink.got] == \
        list(range(200))
    assert ta.stat_messages == 200
    assert ta.stat_frames < 20 and ta.stat_syscalls < 20


def test_ack_coalescing_end_to_end(transports):
    logger = FakeLogger()
    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    ta = transports(a_addr)
    tb = transports(b_addr)
    sink = Sink(b_addr, tb, logger)
    src = Src(a_addr, ta, logger)

    def send_acks():
        for slot in range(50, 114):
            src.send(b_addr, Phase2b(group_index=0, acceptor_index=1,
                                     slot=slot, round=3))

    ta.loop.call_soon_threadsafe(send_acks)
    assert wait_for(lambda: sum(
        (m.slot_end_exclusive - m.slot_start_inclusive)
        if isinstance(m, Phase2bRange) else 1 for m in sink.got) == 64)
    assert ta.stat_coalesced_acks == 64
    ranges = [m for m in sink.got if isinstance(m, Phase2bRange)]
    assert ranges and all(m.round == 3 for m in ranges)


def test_legacy_sender_interoperates_with_batched_receiver(transports):
    logger = FakeLogger()
    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    legacy = transports(a_addr, batching=False)
    batched = transports(b_addr)
    sink = Sink(b_addr, batched, logger, want=40)
    src = Src(a_addr, legacy, logger)

    def send_all():
        for i in range(40):
            src.send(b_addr, ClientRequest(
                Command(CommandId(("c", 1), 0, i), b"x")))

    legacy.loop.call_soon_threadsafe(send_all)
    assert sink.done.wait(10)
    assert legacy.stat_frames == 40


def test_scan_frames_over_offset_cursor_does_not_copy_buffer():
    import tracemalloc

    frame = native.encode_frame(b"10.0.0.1:9000", b"p" * 400)
    n = 20000
    buf = bytearray(frame * n)
    tracemalloc.start()
    pos = passes = count = 0
    while pos < len(buf):
        frames, pos = native.scan_frames(buf, offset=pos)
        count += len(frames)
        passes += 1
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert count == n and passes >= 5
    assert peak < len(buf) / 2, (peak, len(buf))


def test_scan_frames_offset_handles_torn_tail():
    frame = native.encode_frame(b"h:1", b"abc")
    buf = bytearray(b"\x00" * 7 + frame + frame[: len(frame) - 2])
    frames, consumed = native.scan_frames(buf, offset=7)
    assert len(frames) == 1 and consumed == 7 + len(frame)
    assert bytes(buf[frames[0][1] - 3:frames[0][1]]) == b"abc"


# --- interop with the JAX package's TcpTransport ----------------------------


class JSink(JActor):
    def __init__(self, address, transport, logger, want=0):
        super().__init__(address, transport, logger)
        self.got: list = []
        self.done = threading.Event()
        self.want = want

    def receive(self, src, message):
        self.got.append(message)
        if self.want and len(self.got) >= self.want:
            self.done.set()


class JSrc(JActor):
    def receive(self, src, message):
        pass


def _pair(transports, reference_sends: bool, **kwargs):
    """A JAX transport and a port transport on loopback; the sender's
    source actor and the receiver's sink."""
    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    if reference_sends:
        ta = transports(a_addr, cls=JTcpTransport,
                        logger=JFakeLogger(JLogLevel.WARN), **kwargs)
        tb = transports(b_addr, logger=FakeLogger(LogLevel.WARN), **kwargs)
        src = JSrc(a_addr, ta, JFakeLogger())
        sink = Sink(b_addr, tb, FakeLogger())
    else:
        ta = transports(a_addr, logger=FakeLogger(LogLevel.WARN), **kwargs)
        tb = transports(b_addr, cls=JTcpTransport,
                        logger=JFakeLogger(JLogLevel.WARN), **kwargs)
        src = Src(a_addr, ta, FakeLogger())
        sink = JSink(b_addr, tb, JFakeLogger())
    return ta, tb, src, sink, b_addr


@pytest.mark.parametrize("reference_sends", [True, False],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("batching", [True, False],
                         ids=["batched", "per-frame"])
def test_multipaxos_traffic_crosses_packages(transports, reference_sends,
                                             batching):
    """Seeded MultiPaxos messages sent by one package's TcpTransport
    arrive, in order and equal, at the other's: batched runs ride batch
    frames (and Phase2b runs coalesced acks), per-frame the old path."""
    sender_ns, receiver_ns = (REF, PORT) if reference_sends else (PORT, REF)
    ta, tb, src, sink, b_addr = _pair(transports, reference_sends,
                                      batching=batching)
    sent = [m for m in seeded_samples(sender_ns, 5, 300)
            if type(m).__name__ != "Phase2b"]
    expected = [m for m in seeded_samples(receiver_ns, 5, 300)
                if type(m).__name__ != "Phase2b"]
    if batching:
        # The flush folds a run of adjacent ClientReplyArrays into one
        # array of all their entries (paxwire's reply coalescer).
        merged: list = []
        for m in expected:
            if merged and type(m).__name__ == "ClientReplyArray" \
                    and type(merged[-1]).__name__ == "ClientReplyArray":
                merged[-1] = type(m)(entries=merged[-1].entries
                                     + m.entries)
            else:
                merged.append(m)
        expected = merged
    sink.want = len(expected)

    def send_all():
        for message in sent:
            src.send_no_flush(b_addr, message)
        src.flush(b_addr)

    ta.loop.call_soon_threadsafe(send_all)
    assert sink.done.wait(20), f"{len(sink.got)} of {len(expected)} arrived"
    assert len(sink.got) == len(expected)
    for got, want in zip(sink.got, expected):
        assert _same(got, want), (got, want)
    if batching:
        assert ta.stat_frames < len(sent)
    else:
        assert ta.stat_frames == len(sent)
    assert not [m for level, m in tb.logger.records if level >= 3]


@pytest.mark.parametrize("reference_sends", [True, False],
                         ids=["jax-to-port", "port-to-jax"])
def test_ack_streams_coalesce_into_the_same_ranges(transports,
                                                   reference_sends):
    """A Phase2b stream from one package coalesces at the sender's flush
    into the ranges the other package's coalescer would make, and
    expands at the receiver into the same Phase2b / Phase2bRange
    messages."""
    sender_ns, receiver_ns = (REF, PORT) if reference_sends else (PORT, REF)
    ta, tb, src, sink, b_addr = _pair(transports, reference_sends)
    slots = [s for s in range(40, 140) if s % 17]
    acks = [(s, 2, 0, 1) for s in slots] + [(7, 1, 0, 1), (9, 1, 0, 1)]

    def send_acks():
        for slot, rnd, group, acceptor in acks:
            src.send(b_addr, sender_ns.mp.Phase2b(
                group_index=group, acceptor_index=acceptor, slot=slot,
                round=rnd))

    ta.loop.call_soon_threadsafe(send_acks)

    def votes():
        return sum((m.slot_end_exclusive - m.slot_start_inclusive)
                   if type(m).__name__ == "Phase2bRange" else 1
                   for m in sink.got)

    assert wait_for(lambda: votes() == len(acks), timeout=10)
    assert ta.stat_coalesced_acks == len(acks)
    payloads = [receiver_ns.ser.DEFAULT_SERIALIZER.to_bytes(
        receiver_ns.mp.Phase2b(group_index=g, acceptor_index=a, slot=s,
                               round=r)) for s, r, g, a in acks]
    merged = receiver_ns.ser.DEFAULT_SERIALIZER.from_bytes(
        receiver_ns.paxwire._COALESCERS[1](payloads))
    want = list(merged.__wire_expand__(receiver_ns.ser.DEFAULT_SERIALIZER))
    assert len(sink.got) == len(want)
    for got, expect in zip(sink.got, want):
        assert _same(got, expect)


def test_a_traced_reference_senders_context_is_ignored(transports):
    """A JAX sender's frame header may carry ``host:port|<ctx>``; the
    port parses the address and ignores the context."""
    from frankenpaxos_tpu.obs import TraceContext

    a_addr = ("127.0.0.1", free_port())
    b_addr = ("127.0.0.1", free_port())
    ta = transports(a_addr, cls=JTcpTransport, logger=JFakeLogger())
    tb = transports(b_addr)
    sink = Sink(b_addr, tb, FakeLogger(), want=30)
    ctx = TraceContext(trace_id=0xABC, span_id=0x123, sampled=True)

    def send_all():
        for i in range(30):
            ta._write(a_addr, b_addr, REF.ser.DEFAULT_SERIALIZER.to_bytes(
                REF.mp.ClientRequest(REF.mp.Command(
                    REF.mp.CommandId(("c", 1), 0, i), b"x"))),
                flush=True, ctx=ctx)

    ta.loop.call_soon_threadsafe(send_all)
    assert sink.done.wait(10)
    assert [m.command.command_id.client_id for m in sink.got] == \
        list(range(30))
    assert ta.stat_frames < 30
