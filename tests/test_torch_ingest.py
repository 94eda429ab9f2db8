"""The port's twin of ``tests/test_ingest.py`` (paxingest): columns,
the batcher, the wire sinks, lanes -- and their parity with the JAX
package.

Left out, each with its item: the Mencius router and the Mencius ingest
cases (ROADMAP.md queue 1 item 9), the deploy registry (item 11) and the
fault-link specs (item 11); the refusal of the Mencius router stands in
for the first. Added: parity with the JAX package on seeded inputs --
the codec bytes of IngestRun, NotLeaderIngest and IngestCredit; the
ColumnRun / AckColumns / ReplyColumns parses of the same frames, torn
and corrupt ones included; and one cluster scenario through both
harnesses (f = 1, two ingest batchers, a leader in-flight limit below
the load, a batcher crash-restart) whose replica logs, replies and
sequence of Rejected replies must be equal -- and the ProxyLeader's
ack-columns sink against the per-message path.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch import native
from frankenpaxos_tpu_torch.ingest import (
    IngestBatcher,
    IngestBatcherOptions,
    IngestRun,
    MenciusIngestRouter,
    MultiPaxosIngestRouter,
    NotLeaderIngest,
    parse_ack_batch,
    parse_client_batch,
    value_view,
)
import frankenpaxos_tpu_torch.protocols.multipaxos  # noqa: F401 (codecs)
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    ClientRequest,
    Command,
    CommandBatch,
    CommandId,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
from frankenpaxos_tpu_torch.serve.lanes import (
    frame_lane,
    LANE_CLIENT,
    message_lane,
)
import numpy as np
import pytest


def _request(i: int, client=("10.0.0.1", 9000), pseudonym=0,
             payload=None) -> ClientRequest:
    return ClientRequest(Command(
        CommandId(client, pseudonym, i), payload or b"w%04d" % i))


def _client_batch(requests) -> bytes:
    segs = [DEFAULT_SERIALIZER.to_bytes(r) for r in requests]
    return bytes(native.batch_header(151, [len(s) for s in segs])
                 + b"".join(segs))


# --- ColumnRun --------------------------------------------------------------


def test_column_run_prefix_and_rejects():
    reqs = [_request(i, client=("10.0.0.%d" % (i % 2), 9000))
            for i in range(8)]
    colrun = parse_client_batch(_client_batch(reqs))
    assert colrun is not None and len(colrun) == 8
    # Full and prefix lazy arrays decode to the expected values.
    assert tuple(colrun.lazy_values()) == tuple(
        CommandBatch((r.command,)) for r in reqs)
    assert tuple(colrun.lazy_values(3)) == tuple(
        CommandBatch((r.command,)) for r in reqs[:3])
    # Suffix rejects group by client with the right (pseudonym, id)s.
    rejects = colrun.reject_entries(6, retry_after_ms=7, reason=1)
    entries = {address: reply.entries for address, reply in rejects}
    assert set(entries) == {("10.0.0.0", 9000), ("10.0.0.1", 9000)}
    assert entries[("10.0.0.0", 9000)] == ((0, 6),)
    assert entries[("10.0.0.1", 9000)] == ((0, 7),)
    # value_view over the run's lazy array reproduces the columns.
    view = value_view(colrun.lazy_values())
    assert view is not None
    assert np.array_equal(view.cols[:, :3], colrun.cols[:, :3])


def test_parse_client_batch_falls_back_on_mixed_tags():
    req = _request(0)
    other = DEFAULT_SERIALIZER.to_bytes(CommandBatch((req.command,)))
    seg = DEFAULT_SERIALIZER.to_bytes(req)
    payload = bytes(native.batch_header(151, [len(seg), len(other)])
                    + seg + other)
    assert parse_client_batch(payload) is None  # unsupported, not corrupt


def test_parse_client_batch_raises_on_torn_table():
    payload = _client_batch([_request(i) for i in range(4)])
    with pytest.raises(ValueError):
        parse_client_batch(payload[:-3])


def test_value_view_declines_tuples_and_noops():
    assert value_view((CommandBatch((_request(0).command,)),)) is None
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import NOOP
    from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
        encode_value_array,
        LazyValueArray,
    )

    raw = encode_value_array((NOOP,))[8:]
    assert value_view(LazyValueArray(raw, 1)) is None


# --- ack columns ------------------------------------------------------------


def test_parse_ack_batch_merges_singles_ranges_and_coalesced():
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        Phase2b,
        Phase2bRange,
    )
    from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
        Phase2bAckBatch,
    )

    segs = [
        DEFAULT_SERIALIZER.to_bytes(
            Phase2b(group_index=0, acceptor_index=1, slot=5, round=2)),
        DEFAULT_SERIALIZER.to_bytes(Phase2bRange(
            group_index=0, acceptor_index=2, slot_start_inclusive=6,
            slot_end_exclusive=9, round=2)),
        DEFAULT_SERIALIZER.to_bytes(Phase2bAckBatch(
            ranges=((9, 12, 2, 0, 1), (20, 21, 3, 1, 0)))),
    ]
    payload = bytes(native.batch_header(150, [len(s) for s in segs])
                    + b"".join(segs))
    acks = parse_ack_batch(payload)
    assert acks is not None and acks.count == 3
    assert acks.rows.tolist() == [
        [5, 6, 2, 0, 1], [6, 9, 2, 0, 2], [9, 12, 2, 0, 1],
        [20, 21, 3, 1, 0]]


def test_parse_ack_batch_declines_non_ack_segments():
    seg = DEFAULT_SERIALIZER.to_bytes(_request(0))
    payload = bytes(native.batch_header(150, [len(seg)]) + seg)
    assert parse_ack_batch(payload) is None


# --- lanes + reject routing -------------------------------------------------


def test_ingest_run_is_client_lane_and_not_leader_is_control():
    run = IngestRun(batcher_index=0,
                    values=(CommandBatch((_request(3).command,)),))
    assert message_lane(run) == LANE_CLIENT
    assert frame_lane(DEFAULT_SERIALIZER.to_bytes(run)) == LANE_CLIENT
    bounce = NotLeaderIngest(group_index=0, run=run)
    assert message_lane(bounce) != LANE_CLIENT
    assert frame_lane(DEFAULT_SERIALIZER.to_bytes(bounce)) \
        != LANE_CLIENT


def test_reject_replies_for_ingest_run_groups_per_client():
    from frankenpaxos_tpu_torch.serve.admission import reject_replies_for

    run = IngestRun(batcher_index=0, values=tuple(
        CommandBatch((_request(i, client=("c%d" % (i % 2), 1)).command,))
        for i in range(4)))
    # Tuple path (sim) and lazy path (wire) must agree.
    decoded = dict(reject_replies_for(run, 5, 2))
    encoded = DEFAULT_SERIALIZER.from_bytes(
        DEFAULT_SERIALIZER.to_bytes(run))
    lazy = dict(reject_replies_for(encoded, 5, 2))
    assert set(decoded) == set(lazy) == {("c0", 1), ("c1", 1)}
    assert decoded[("c0", 1)].entries == lazy[("c0", 1)].entries


# --- batcher ----------------------------------------------------------------


def test_batcher_ships_one_run_per_drain_and_bounces_route():
    sim = make_multipaxos(f=1, num_ingest_batchers=2, num_clients=2,
                          seed=7)
    acked = []
    for i in range(6):
        sim.clients[i % 2].write(i % 4 if i < 4 else i, b"p%d" % i,
                                 lambda r, i=i: acked.append(i))
    sim.transport.deliver_all_coalesced(max_steps=4000)
    assert sorted(acked) == list(range(6))


def test_batcher_not_leader_bounce_rediscovers_and_resends():
    sim = make_multipaxos(f=1, num_ingest_batchers=1, num_clients=1,
                          seed=9)
    # Force a leader change so leader-0 goes inactive; the batcher
    # still targets round 0's leader and must recover via the bounce.
    sim.leaders[1].leader_change(is_new_leader=True)
    sim.leaders[0].leader_change(is_new_leader=False)
    acked = []
    sim.clients[0].write(0, b"x", lambda r: acked.append(r))
    sim.transport.deliver_all_coalesced(max_steps=4000)
    assert acked == [b"0"]
    assert sim.ingest_batchers[0].router.round > 0


def test_batcher_admission_rejects_suffix_with_explicit_replies():
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)

    class Cfg:
        num_leaders = 1
        leader_addresses = ["leader-0"]

    batcher = IngestBatcher(
        "batcher-0", transport, logger, MultiPaxosIngestRouter(Cfg),
        options=IngestBatcherOptions(admission_inflight_limit=2,
                                     admission_retry_after_ms=9))
    colrun = parse_client_batch(_client_batch(
        [_request(i) for i in range(5)]))
    batcher._handle_client_columns("client", colrun)
    assert batcher._staged_columns[0][1] == 2  # admitted prefix
    batcher.flush_ingest()
    sent = transport.messages
    runs = [m for m in sent if b"leader-0" in repr(m.dst).encode()
            or m.dst == "leader-0"]
    assert any(m.dst == "leader-0" for m in sent)
    rejected = [m for m in sent if m.dst == ("10.0.0.1", 9000)]
    assert rejected, "suffix must draw explicit Rejected replies"
    assert runs


# --- leader wire sink -------------------------------------------------------


def test_leader_consumes_client_columns_as_one_run():
    sim = make_multipaxos(f=1, num_clients=1, seed=3)
    leader = sim.leaders[0]
    sim.transport.deliver_all_coalesced()  # finish Phase1
    colrun = parse_client_batch(_client_batch(
        [_request(i, client="client-0", pseudonym=i) for i in range(5)]))
    before = leader.next_slot
    leader._handle_client_columns("client-0", colrun)
    assert leader.next_slot == before + 5
    # The proposed run reached a proxy leader as ONE Phase2aRun whose
    # values are lazy (raw-copied, never parsed by the leader).
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import Phase2aRun

    runs = [m for m in sim.transport.messages
            if isinstance(
                DEFAULT_SERIALIZER.from_bytes(bytes(m.data)),
                Phase2aRun)]
    assert runs, "expected a Phase2aRun in flight"


def test_leader_ingest_run_inactive_bounces_to_batcher():
    sim = make_multipaxos(f=1, num_ingest_batchers=1, seed=3)
    sim.transport.deliver_all_coalesced()
    leader = sim.leaders[1]  # inactive
    run = IngestRun(batcher_index=0,
                    values=(CommandBatch((_request(0).command,)),))
    leader._handle_ingest_run("ingest-batcher-0", run)
    bounced = [m for m in sim.transport.messages
               if m.dst == "ingest-batcher-0"]
    assert bounced
    message = DEFAULT_SERIALIZER.from_bytes(bytes(bounced[-1].data))
    assert isinstance(message, NotLeaderIngest)




# --- what stays refused ----------------------------------------------------


def test_mencius_router_is_refused_naming_its_item():
    with pytest.raises(NotImplementedError, match="item 9"):
        MenciusIngestRouter(object())


# --- parity with the JAX package ------------------------------------------

import importlib  # noqa: E402

from frankenpaxos_tpu_torch.ingest import columns as port_columns  # noqa: E402

from frankenpaxos_tpu import native as ref_native  # noqa: E402
from frankenpaxos_tpu.ingest import columns as ref_columns  # noqa: E402
import frankenpaxos_tpu.protocols.multipaxos  # noqa: E402,F401
from frankenpaxos_tpu.runtime.serializer import (  # noqa: E402
    DEFAULT_SERIALIZER as REF_SERIALIZER,
)


def _ns(pkg: str):
    mp = importlib.import_module(f"{pkg}.protocols.multipaxos.messages")
    mpwire = importlib.import_module(f"{pkg}.protocols.multipaxos.wire")
    ingest = importlib.import_module(f"{pkg}.ingest.messages")
    return mp, mpwire, ingest


def _values(pkg: str, rng, n: int):
    """``n`` one-command batches from seeded clients, as a tuple and as
    the LazyValueArray the wire carries."""
    mp, mpwire, _ = _ns(pkg)
    values = tuple(mp.CommandBatch((mp.Command(mp.CommandId(
        ("10.0.%d.%d" % (int(rng.integers(0, 3)), int(rng.integers(0, 4))),
         int(rng.integers(1000, 1010))),
        int(rng.integers(0, 300)), int(rng.integers(0, 2**40))),
        rng.bytes(int(rng.integers(0, 40)))),)) for _ in range(n))
    lazy = mpwire.decode_value_array(mpwire.encode_value_array(values))
    return values, lazy


def _ingest_messages(pkg: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    _, _, ingest = _ns(pkg)
    out = []
    for _ in range(6):
        values, lazy = _values(pkg, rng, int(rng.integers(0, 9)))
        batcher = int(rng.integers(0, 8))
        seq = int(rng.integers(0, 2**50))
        for vals in (values, lazy):
            run = ingest.IngestRun(batcher_index=batcher, values=vals,
                                   seq=seq)
            out.append(run)
            out.append(ingest.NotLeaderIngest(
                group_index=int(rng.integers(0, 4)), run=run))
        out.append(ingest.IngestCredit(
            group_index=int(rng.integers(0, 4)),
            watermark_seq=int(rng.integers(-1, 2**50))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ingest_codec_bytes_equal_the_references(seed):
    port = _ingest_messages("frankenpaxos_tpu_torch", seed)
    ref = _ingest_messages("frankenpaxos_tpu", seed)
    for p, r in zip(port, ref):
        data = DEFAULT_SERIALIZER.to_bytes(p)
        assert data == REF_SERIALIZER.to_bytes(r), type(p).__name__
        assert data[:1] == b"\x00" and data[1] + 128 in (204, 205, 210)
        # Each package decodes the other's bytes to its own message.
        back = DEFAULT_SERIALIZER.from_bytes(data)
        assert DEFAULT_SERIALIZER.to_bytes(back) == data
        assert frame_lane(data) == (
            LANE_CLIENT if type(p).__name__ == "IngestRun"
            else frame_lane(data))


def _parse_both(fn_name: str, data: bytes):
    """``fn_name`` of both packages' ``ingest/columns.py`` on ``data``:
    (kind, port result, reference result), kind being ``"raise"`` (both
    raised the same exception type), ``"none"`` or ``"parsed"``."""
    results = []
    for mod in (port_columns, ref_columns):
        try:
            results.append(("parsed", getattr(mod, fn_name)(data)))
        except Exception as e:  # noqa: BLE001 - the type is compared
            results.append(("raise", type(e).__name__))
    (pk, pv), (rk, rv) = results
    assert pk == rk, (fn_name, results)
    if pk == "raise":
        assert pv == rv
        return "raise", None, None
    if pv is None or rv is None:
        assert pv is None and rv is None
        return "none", None, None
    return "parsed", pv, rv


def _outcome(fn):
    """``fn()``'s value, or the name of the exception it raised."""
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 - the type is compared
        return ("raise", type(e).__name__)


def _assert_columns_equal(kind: str, p, r) -> None:
    if kind != "parsed":
        return
    np.testing.assert_array_equal(p.cols if hasattr(p, "cols") else p.rows,
                                  r.cols if hasattr(r, "cols") else r.rows)
    for attr in ("raw", "count"):
        if hasattr(r, attr):
            assert getattr(p, attr) == getattr(r, attr)
    if hasattr(r, "buf"):
        assert bytes(p.buf) == bytes(r.buf)


def _mutations(data: bytes, rng) -> list:
    """The frame, torn at several points, and with bytes flipped. A tear
    keeps the two leading tag bytes: the JAX package's native batch scan
    reads past a payload shorter than them (the transport never hands a
    parser one; test_short_payloads_raise covers the port)."""
    out = [data]
    for cut in sorted(set(int(c) for c in rng.integers(
            2, max(len(data), 3), size=6))):
        out.append(data[:cut])
    for _ in range(6):
        flipped = bytearray(data)
        if flipped:
            at = int(rng.integers(0, len(flipped)))
            flipped[at] ^= int(rng.integers(1, 256))
        out.append(bytes(flipped))
    return out


def _client_frames(pkg: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    mp, _, _ = _ns(pkg)
    ser = DEFAULT_SERIALIZER if pkg.endswith("torch") else REF_SERIALIZER
    nat = native if pkg.endswith("torch") else ref_native
    frames = []
    for _ in range(4):
        segs = []
        for i in range(int(rng.integers(1, 7))):
            cid = mp.CommandId(("10.1.0.%d" % int(rng.integers(0, 3)),
                                int(rng.integers(1, 9))),
                               int(rng.integers(0, 50)),
                               int(rng.integers(0, 2**33)))
            command = mp.Command(cid, rng.bytes(int(rng.integers(0, 30))))
            if rng.integers(0, 2):
                segs.append(ser.to_bytes(mp.ClientRequest(command)))
            else:
                segs.append(ser.to_bytes(mp.ClientRequestArray(
                    commands=(command,) * int(rng.integers(1, 4)))))
        frames.append(("parse_client_batch", bytes(nat.batch_header(
            151, [len(s) for s in segs]) + b"".join(segs))))
        frames.append(("parse_client_array", segs[-1]))
    return frames


@pytest.mark.parametrize("seed", range(5))
def test_client_columns_equal_the_references(seed):
    frames = _client_frames("frankenpaxos_tpu_torch", seed)
    assert frames == _client_frames("frankenpaxos_tpu", seed)
    rng = np.random.default_rng(100 + seed)
    kinds = set()
    for fn, data in frames:
        for case in _mutations(data, rng):
            kind, p, r = _parse_both(fn, case)
            kinds.add(kind)
            _assert_columns_equal(kind, p, r)
            if kind == "parsed":
                # The admission refusal path off the same columns (a
                # flipped address byte can scan and then fail to
                # decode: both packages must fail alike).
                for k in range(len(r) + 1):
                    assert _outcome(lambda: [
                        (a, DEFAULT_SERIALIZER.to_bytes(m))
                        for a, m in p.reject_entries(k, 7, 2)]) == \
                        _outcome(lambda: [
                            (a, REF_SERIALIZER.to_bytes(m))
                            for a, m in r.reject_entries(k, 7, 2)])
                    assert p.prefix_raw(k) == r.prefix_raw(k)
    assert "parsed" in kinds and "raise" in kinds


@pytest.mark.parametrize("seed", range(3))
def test_value_view_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    _, lazy = _values("frankenpaxos_tpu_torch", rng, 9)
    rng = np.random.default_rng(seed)
    _, ref_lazy = _values("frankenpaxos_tpu", rng, 9)
    assert lazy.raw == ref_lazy.raw
    p, r = value_view(lazy), ref_columns.value_view(ref_lazy)
    np.testing.assert_array_equal(p.cols, r.cols)
    assert p.addresses() == r.addresses()


def _ack_frames(pkg: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    mp, mpwire, _ = _ns(pkg)
    ser = DEFAULT_SERIALIZER if pkg.endswith("torch") else REF_SERIALIZER
    nat = native if pkg.endswith("torch") else ref_native
    frames = []
    for _ in range(4):
        segs = []
        for _ in range(int(rng.integers(1, 8))):
            kind = int(rng.integers(0, 4))
            slot = int(rng.integers(0, 2**40))
            rnd = int(rng.integers(0, 9))
            g, a = int(rng.integers(0, 3)), int(rng.integers(0, 5))
            if kind == 0:
                segs.append(ser.to_bytes(mp.Phase2b(
                    group_index=g, acceptor_index=a, slot=slot, round=rnd)))
            elif kind == 1:
                segs.append(ser.to_bytes(mp.Phase2bRange(
                    group_index=g, acceptor_index=a,
                    slot_start_inclusive=slot,
                    slot_end_exclusive=slot + int(rng.integers(1, 70)),
                    round=rnd)))
            elif kind == 2:
                segs.append(ser.to_bytes(mpwire.Phase2bAckBatch(
                    ranges=tuple((s, s + int(rng.integers(1, 9)), rnd, g, a)
                                 for s in rng.integers(0, 2**40, size=int(
                                     rng.integers(1, 5))).tolist()))))
            else:
                segs.append(ser.to_bytes(mp.ChosenWatermark(slot=slot)))
        frames.append(bytes(nat.batch_header(150, [len(s) for s in segs])
                            + b"".join(segs)))
    return frames


@pytest.mark.parametrize("data", [b"", b"\x00", b"\x00\x16",
                                  b"\x00\x16\x01\x00"])
def test_short_payloads_raise(data):
    """A payload too short for its count header is torn: ValueError
    from every column parser (never a read past the buffer)."""
    for parse in (parse_ack_batch, parse_client_batch):
        with pytest.raises(ValueError):
            parse(data)


@pytest.mark.parametrize("seed", range(5))
def test_ack_columns_equal_the_references(seed):
    frames = _ack_frames("frankenpaxos_tpu_torch", seed)
    assert frames == _ack_frames("frankenpaxos_tpu", seed)
    rng = np.random.default_rng(200 + seed)
    kinds = set()
    for data in frames:
        for case in _mutations(data, rng):
            kind, p, r = _parse_both("parse_ack_batch", case)
            kinds.add(kind)
            _assert_columns_equal(kind, p, r)
    assert "parsed" in kinds


def _reply_frames(pkg: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    mp, _, _ = _ns(pkg)
    ser = DEFAULT_SERIALIZER if pkg.endswith("torch") else REF_SERIALIZER
    return [ser.to_bytes(mp.ClientReplyArray(entries=tuple(
        (int(rng.integers(0, 64)), int(rng.integers(0, 2**40)),
         int(rng.integers(0, 2**40)), rng.bytes(int(rng.integers(0, 20))))
        for _ in range(int(rng.integers(0, 9))))))
        for _ in range(4)]


@pytest.mark.parametrize("seed", range(5))
def test_reply_columns_equal_the_references(seed):
    frames = _reply_frames("frankenpaxos_tpu_torch", seed)
    assert frames == _reply_frames("frankenpaxos_tpu", seed)
    rng = np.random.default_rng(300 + seed)
    kinds = set()
    for data in frames:
        for case in _mutations(data, rng):
            kind, p, r = _parse_both("parse_reply_array", case)
            kinds.add(kind)
            _assert_columns_equal(kind, p, r)
            if kind == "parsed":
                assert [p.result_bytes(i) for i in range(len(p))] == \
                    [r.result_bytes(i) for i in range(len(r))]
    assert "parsed" in kinds


# --- the cluster scenario, through both harnesses ---------------------------


def _ingest_scenario(harness, **backends) -> tuple:
    """f = 1, two ingest batchers, the leader's in-flight limit below
    the load, batcher 0 crash-restarted mid-run; deliveries FIFO and
    timers fired one at a time in id order, so the two packages see the
    same schedule. Returns the replica logs, the replies in order and
    every Rejected the clients received, in order."""
    sim = harness.make_multipaxos(
        f=1, num_clients=2, coalesced=True, num_ingest_batchers=2,
        leader_admission=dict(admission_inflight_limit=4), seed=3,
        **backends)
    t = sim.transport
    replies: list = []
    rejected: list = []
    for c, client in enumerate(sim.clients):
        handle = client._handle_rejected

        def spy(src, message, handle=handle, c=c):
            rejected.append((c, src, message.entries, message.reason))
            handle(src, message)

        client._handle_rejected = spy
    writes, clients = 24, 2
    issued = [0] * clients

    def issue(c, p):
        i = issued[c]
        if i >= writes:
            return
        issued[c] = i + 1
        payload = b"c%d.%d" % (c, i)

        def done(result, payload=payload):
            replies.append((payload, result))
            issue(c, p)

        sim.clients[c].write(p, payload, done)

    for c in range(clients):
        for p in range(4):
            issue(c, p)
        sim.clients[c].flush_writes()
    for step in range(400):
        if len(replies) == writes * clients:
            break
        while t.messages:
            t.deliver_all_coalesced(100000)
            for client in sim.clients:
                client.flush_writes()
        if step == 3:
            harness.crash_restart_ingest_batcher(sim, 0)
        timers = sorted(
            (x for x in t.running_timers() if x.name.startswith(
                ("resendWrite", "backoff", "ingestFlush"))),
            key=lambda x: x.id)
        if timers:
            t.trigger_timer(timers[0].id)
    logs = [[repr(v) for v in harness.executed_prefix(r)]
            for r in sim.replicas]
    return logs, replies, rejected, sim


@pytest.mark.parametrize("backends", [
    {}, dict(quorum_backend="cuda", phase1_backend="cuda", device="cpu")],
    ids=["dict", "cuda"])
def test_ingest_cluster_scenario_equals_the_references(backends):
    from frankenpaxos_tpu_torch.protocols.multipaxos import harness as th
    from tests.protocols import multipaxos_harness as jh

    logs, replies, rejected, sim = _ingest_scenario(th, **backends)
    ref_logs, ref_replies, ref_rejected, _ = _ingest_scenario(jh)
    assert len(replies) == 48 and len({p for p, _ in replies}) == 48
    assert logs == ref_logs and logs[0] == logs[1]
    assert replies == ref_replies
    assert rejected and rejected == ref_rejected
    assert sum(sim.leaders[0].ingest_counts.values()) > 0


# --- the ProxyLeader's ack-columns sink --------------------------------------


def _deliver_acks_through_sink(sim) -> int:
    """Deliver FIFO, but hand every buffered Phase2b / Phase2bRange to a
    ProxyLeader as ONE control batch frame through its wire sink (what
    TcpTransport does with a batch frame of acks). Returns the rows the
    sinks took."""
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        Phase2b,
        Phase2bRange,
    )

    t = sim.transport
    proxies = {p.address: p for p in sim.proxy_leaders}
    rows = 0
    while t.messages:
        acks: dict = {}
        for m in list(t.messages):
            if m.dst in proxies and isinstance(
                    DEFAULT_SERIALIZER.from_bytes(m.data),
                    (Phase2b, Phase2bRange)):
                t.messages.remove(m)
                acks.setdefault((m.dst, m.src), []).append(m)
            else:
                t.deliver_message(m)
        for (dst, src), messages in acks.items():
            payload = bytes(native.batch_header(
                150, [len(m.data) for m in messages])
                + b"".join(m.data for m in messages))
            parse, handler = proxies[dst].wire_sinks[150]
            parsed = parse(payload)
            assert parsed is not None and parsed.count == len(messages)
            handler(src, parsed)
            rows += len(parsed)
        for dst in sorted({dst for dst, _ in acks}):
            proxies[dst].on_drain()
    return rows


@pytest.mark.parametrize("backends", [
    {}, dict(quorum_backend="cuda", device="cpu"),
    dict(quorum_backend="cuda", tpu_pipelined=True, device="cpu")],
    ids=["dict", "cuda_sync", "cuda_pipelined"])
def test_ack_sink_chooses_what_per_message_delivery_chooses(backends):
    from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
        executed_prefix,
    )

    def run(sink: bool):
        sim = make_multipaxos(f=1, num_clients=2, coalesced="mixed",
                              seed=11, **backends)
        got: dict = {}
        for c, client in enumerate(sim.clients):
            for p in range(6):
                client.write(p, b"s%d.%d" % (c, p),
                             lambda r, k=(c, p): got.__setitem__(k, r))
            client.flush_writes()
        rows = 0
        for _ in range(50):
            if len(got) == 12:
                break
            if sink:
                rows += _deliver_acks_through_sink(sim)
            else:
                sim.transport.deliver_all_coalesced(100000)
            for p in sim.proxy_leaders:
                p.on_drain()  # a pipelined board's flush
            for x in sorted(sim.transport.running_timers(),
                            key=lambda x: x.id):
                if x.name == "tpuDrainFlush":
                    sim.transport.trigger_timer(x.id)
        logs = [[repr(v) for v in executed_prefix(r)]
                for r in sim.replicas]
        return got, logs, rows, sim

    got, logs, rows, sim = run(True)
    want, want_logs, _, _ = run(False)
    assert len(got) == 12 and rows > 0
    assert sorted(got.values()) == sorted(want.values())
    assert logs[0] == logs[1] and sorted(logs[0]) == sorted(want_logs[0])
    assert sum(p.ack_rows["sink"] for p in sim.proxy_leaders) == rows
