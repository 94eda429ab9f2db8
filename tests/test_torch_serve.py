"""The port's twin of ``tests/test_serve.py`` (paxload, serve/):
admission control, priority lanes, backoff, bounded inboxes and the
client retry discipline -- unit tests plus sim round-trips over the
port's MultiPaxos pipeline -- and their parity with the JAX package.

Left out: the Mencius leader's admission (ROADMAP.md queue 1 item 9).
Added: parity with the JAX package on the same inputs -- the
``Rejected`` codec bytes for every reason, ``reject_replies_for`` on
every request shape, and the ``AdmissionController``'s decisions under
one seeded clock script -- and the sim round-trips again with the cuda
backends on the CPU.
"""

from __future__ import annotations

import random

from frankenpaxos_tpu_torch import serve
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
from frankenpaxos_tpu_torch.runtime.serializer import (
    _CODECS_BY_TAG,
    DEFAULT_SERIALIZER,
)
from frankenpaxos_tpu_torch.serve import lanes
from frankenpaxos_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionOptions,
    reject_replies_for,
    TokenBucket,
)
from frankenpaxos_tpu_torch.serve.backoff import Backoff, RETRY_EXHAUSTED
from frankenpaxos_tpu_torch.serve.messages import (
    REASON_CODEL,
    REASON_INFLIGHT,
    REASON_QUEUE,
    REASON_TOKENS,
    Rejected,
)
import pytest


def _import_every_port_protocol() -> None:
    import frankenpaxos_tpu_torch.protocols.epaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.fastmultipaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.fastpaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.matchmakermultipaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.matchmakerpaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.multipaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.simplebpaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.simplegcbpaxos  # noqa: F401
    import frankenpaxos_tpu_torch.protocols.wpaxos  # noqa: F401
    import frankenpaxos_tpu_torch.reconfig  # noqa: F401


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# --- token bucket -------------------------------------------------------


def test_token_bucket_refills_and_caps_at_burst():
    clock = _Clock()
    bucket = TokenBucket(rate=10.0, burst=5.0, clock=clock)
    assert all(bucket.take() for _ in range(5))
    assert not bucket.take()
    clock.t = 0.2  # +2 tokens
    assert bucket.take() and bucket.take() and not bucket.take()
    clock.t = 100.0  # refill far past burst: capped at 5
    assert all(bucket.take() for _ in range(5))
    assert not bucket.take()


def test_token_bucket_burst_defaults_to_rate():
    bucket = TokenBucket(rate=3.0, burst=0.0, clock=_Clock())
    assert bucket.burst == 3.0


# --- admission controller -----------------------------------------------


def test_admit_inflight_budget_and_release():
    ctl = AdmissionController(
        AdmissionOptions(inflight_limit=3), clock=_Clock())
    assert ctl.admit(2) and ctl.admit(1)
    assert not ctl.admit(1)
    assert ctl.last_reason == REASON_INFLIGHT
    ctl.set_inflight(1)  # watermark advanced: drain-granular release
    assert ctl.admit(2) and not ctl.admit(1)
    assert ctl.rejected == {"inflight": 2}
    assert ctl.admitted == 5


def test_admit_token_reason():
    clock = _Clock()
    ctl = AdmissionController(
        AdmissionOptions(token_rate=5.0, token_burst=2.0), clock=clock)
    assert ctl.admit(2)
    assert not ctl.admit(1)
    assert ctl.last_reason == REASON_TOKENS


def test_admit_up_to_partial_prefix():
    ctl = AdmissionController(
        AdmissionOptions(inflight_limit=10, token_rate=100.0,
                         token_burst=7.0), clock=_Clock())
    # inflight allows 10, tokens allow 7: prefix of 7, suffix rejected
    # with the binding constraint as the reason.
    assert ctl.admit_up_to(12) == 7
    assert ctl.last_reason == REASON_TOKENS
    assert ctl.rejected == {"tokens": 5}
    # Now the slot budget binds (7 in flight, limit 10).
    ctl.bucket.tokens = 100.0
    assert ctl.admit_up_to(12) == 3
    assert ctl.rejected == {"tokens": 5, "inflight": 9}


def test_admit_up_to_zero_when_shedding():
    ctl = AdmissionController(
        AdmissionOptions(inflight_limit=10, codel_target_s=0.01),
        clock=_Clock())
    ctl.shedding = True
    assert ctl.admit_up_to(4) == 0
    assert ctl.rejected == {"codel": 4}


def test_codel_shed_mode_self_expires_without_drains():
    # Shedding every client frame pre-delivery (TcpTransport) also
    # stops the drains that feed note_drain_delay -- the latch must
    # self-expire one interval after the last sojourn observation or a
    # pure-client-lane actor (replica serving reads in a write-free
    # period) sheds forever on an empty queue.
    clock = _Clock()
    ctl = AdmissionController(
        AdmissionOptions(codel_target_s=0.01, codel_interval_s=0.1),
        clock=clock)
    ctl.note_drain_delay(0.05)
    clock.t = 0.12
    ctl.note_drain_delay(0.05)  # above target for a full interval
    assert ctl.shedding and ctl.shed_active()
    clock.t = 0.15  # within an interval of the last feed: still binding
    assert ctl.shed_active()
    assert not ctl.admit(1)
    clock.t = 0.23  # one full interval with no drain feed: expired
    assert not ctl.shed_active()
    assert not ctl.shedding
    assert ctl.admit(1)


def test_codel_enters_and_exits_shed_mode():
    clock = _Clock()
    ctl = AdmissionController(
        AdmissionOptions(codel_target_s=0.01, codel_interval_s=0.1),
        clock=clock)
    ctl.note_drain_delay(0.05)  # above target: arming, not yet shedding
    assert not ctl.shedding
    clock.t = 0.05
    ctl.note_drain_delay(0.05)  # above for < interval
    assert not ctl.shedding
    clock.t = 0.12
    ctl.note_drain_delay(0.05)  # above for a full interval -> shed
    assert ctl.shedding
    assert not ctl.admit(1) and ctl.last_reason == REASON_CODEL
    ctl.note_drain_delay(0.001)  # one under-target drain exits
    assert not ctl.shedding
    assert ctl.admit(1)


def test_default_options_admit_everything():
    options = AdmissionOptions()
    assert not options.any_enabled()
    ctl = AdmissionController(options, clock=_Clock())
    assert all(ctl.admit(1000) for _ in range(10))
    assert not ctl.inbox_full(10 ** 9)


# --- priority lanes -----------------------------------------------------


def _encoded(message) -> bytes:
    return DEFAULT_SERIALIZER.to_bytes(message)


def test_client_request_frames_are_client_lane():
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        ClientRequest,
        Command,
        CommandId,
    )

    request = ClientRequest(Command(CommandId("c", 1, 2), b"x"))
    assert lanes.frame_lane(_encoded(request)) == lanes.LANE_CLIENT
    assert lanes.message_lane(request) == lanes.LANE_CLIENT


def test_control_plane_frames_are_never_client_lane():
    """EVERY registered codec whose type is not an explicit client
    request classifies as CONTROL -- phase messages, votes, epoch
    commits, heartbeats, replies can never be shed."""
    _import_every_port_protocol()  # the port's full registry
    checked = 0
    for tag, codec in sorted(_CODECS_BY_TAG.items()):
        name = codec.message_type.__name__
        if name in lanes.CLIENT_LANE_TYPE_NAMES \
                or tag in lanes.CLIENT_LANE_EXTRA_TAGS:
            continue
        if tag < 128:
            head = bytes([tag])
        else:
            head = bytes([0, tag - 128])
        assert lanes.frame_lane(head + b"\0" * 16) == lanes.LANE_CONTROL, \
            f"tag {tag} ({name}) classified as shedable"
        checked += 1
    assert checked > 50  # the registry is fully populated by now


def test_pickle_and_malformed_frames_are_control():
    import pickle

    assert lanes.frame_lane(pickle.dumps(("anything",))) \
        == lanes.LANE_CONTROL
    assert lanes.frame_lane(b"") == lanes.LANE_CONTROL
    assert lanes.frame_lane(b"\x00") == lanes.LANE_CONTROL


def test_rejected_reply_is_control_lane():
    reply = Rejected(entries=((1, 2),), retry_after_ms=10, reason=1)
    assert lanes.frame_lane(_encoded(reply)) == lanes.LANE_CONTROL


# --- backoff ------------------------------------------------------------


def test_backoff_grows_caps_and_jitters_within_bounds():
    backoff = Backoff(initial_s=0.1, max_s=1.0, multiplier=2.0,
                      jitter=0.5)
    rng = random.Random(7)
    for attempt, base in ((0, 0.1), (1, 0.2), (2, 0.4), (6, 1.0)):
        for _ in range(20):
            delay = backoff.delay_s(attempt, rng)
            assert 0.5 * base <= delay <= 1.5 * base


def test_backoff_honors_server_floor():
    backoff = Backoff(initial_s=0.01, jitter=0.0)
    assert backoff.delay_s(0, random.Random(0), floor_s=0.5) == 0.5


def test_retry_exhausted_sentinel_is_falsy():
    assert not RETRY_EXHAUSTED
    assert repr(RETRY_EXHAUSTED) == "RETRY_EXHAUSTED"


# --- reject_replies_for -------------------------------------------------


def test_reject_replies_for_request_array_and_batch():
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        ClientRequest,
        ClientRequestArray,
        ClientRequestBatch,
        Command,
        CommandBatch,
        CommandId,
    )

    single = ClientRequest(Command(CommandId("c1", 5, 9), b"x"))
    [(address, reply)] = reject_replies_for(single, 150)
    assert address == "c1" and reply.entries == ((5, 9),)
    assert reply.retry_after_ms == 150

    array = ClientRequestArray(commands=(
        Command(CommandId("c1", 1, 10), b"a"),
        Command(CommandId("c1", 2, 11), b"b")))
    [(address, reply)] = reject_replies_for(array)
    assert address == "c1" and reply.entries == ((1, 10), (2, 11))

    batch = ClientRequestBatch(CommandBatch((
        Command(CommandId("c1", 1, 1), b"a"),
        Command(CommandId("c2", 7, 2), b"b"),
        Command(CommandId("c1", 3, 3), b"c"))))
    replies = dict(reject_replies_for(batch, reason=REASON_QUEUE))
    assert replies["c1"].entries == ((1, 1), (3, 3))
    assert replies["c2"].entries == ((7, 2),)
    assert replies["c1"].reason == REASON_QUEUE


def test_rejected_codec_roundtrip_extended_page():
    reply = Rejected(entries=((2, 7), (3, 9)), retry_after_ms=250,
                     reason=REASON_INFLIGHT)
    data = DEFAULT_SERIALIZER.to_bytes(reply)
    assert data[0] == 0 and data[1] == 132 - 128  # extended tag page
    assert DEFAULT_SERIALIZER.from_bytes(data) == reply


# --- sim round-trips over the real multipaxos pipeline ------------------


def _drive(sim, n: int = 50) -> None:
    for _ in range(n):
        if not sim.transport.messages:
            break
        sim.transport.deliver_all()
        for client in sim.clients:
            client.flush_writes()


def test_leader_inflight_limit_rejects_then_backoff_completes():
    """Overflow the slot budget: the suffix gets an explicit Rejected,
    the client backs off, and the retries complete once the watermark
    frees capacity -- nothing wedges, nothing is lost."""
    sim = make_multipaxos(
        f=1, coalesced=True,
        leader_admission=dict(admission_inflight_limit=4),
        client_retry_budget=8)
    client = sim.clients[0]
    results: dict = {}
    for i in range(12):
        client.write(i, b"w%d" % i,
                     (lambda r, i=i: results.__setitem__(i, r)))
    client.flush_writes()
    sim.transport.deliver_all()
    leader = sim.leaders[0]
    assert leader.admission.rejected, "slot budget never engaged"
    # Backoff timers re-issue the rejected suffix; trigger them and
    # settle until every write concludes.
    for _ in range(40):
        if len(results) == 12:
            break
        for timer in list(sim.transport.running_timers()):
            if timer.name.startswith("backoff"):
                sim.transport.trigger_timer(timer.id)
        for c in sim.clients:
            c.flush_writes()
        sim.transport.deliver_all()
    assert len(results) == 12
    assert all(r is not RETRY_EXHAUSTED for r in results.values())


def test_retry_budget_exhaustion_is_explicit():
    """With the leader saturated and a tiny retry budget, a refused
    write completes with RETRY_EXHAUSTED -- the bounded-retry
    conclusion, not a silent wedge."""
    sim = make_multipaxos(
        f=1, coalesced=True,
        leader_admission=dict(admission_inflight_limit=1),
        client_retry_budget=2)
    # Let Phase1 finish first, THEN saturate the controller far past
    # the limit so capacity never frees (no watermark advance ever
    # resyncs it down): rejected retries keep failing until the
    # budget runs out.
    sim.transport.deliver_all()
    leader = sim.leaders[0]
    leader.next_slot = leader.chosen_watermark + 10 ** 6
    leader.admission.set_inflight(10 ** 6)
    client = sim.clients[0]
    results: dict = {}
    client.write(0, b"doomed",
                 lambda r: results.__setitem__(0, r))
    client.flush_writes()
    for _ in range(40):
        if results:
            break
        sim.transport.deliver_all()
        for timer in list(sim.transport.running_timers()):
            if timer.name.startswith("backoff"):
                sim.transport.trigger_timer(timer.id)
        client.flush_writes()
        sim.transport.deliver_all()
    assert results[0] is RETRY_EXHAUSTED
    retries = leader.admission.rejected.get("inflight", 0)
    assert retries >= 3  # initial + both budgeted retries


def test_bounded_inbox_reject_newest_sends_rejected():
    sim = make_multipaxos(
        f=1, coalesced=False,
        leader_admission=dict(admission_inbox_capacity=2,
                              admission_inbox_policy="reject"),
        client_retry_budget=1)
    transport = sim.transport
    leader = sim.leaders[0]
    results: dict = {}
    # More single-request frames than the inbox holds, WITHOUT
    # delivering in between: the overflow must be answered now.
    for i in range(6):
        sim.clients[0].write(i, b"w%d" % i,
                             (lambda r, i=i: results.__setitem__(i, r)))
    shed = leader.admission.rejected.get("shed_reject-newest", 0)
    assert shed == 4
    # The synthesized Rejected replies are already buffered for the
    # client even though the leader never saw the frames.
    pending_rejects = [
        m for m in transport.messages
        if DEFAULT_SERIALIZER.from_bytes(m.data).__class__ is Rejected]
    assert len(pending_rejects) == 4
    _drive(sim)


def test_bounded_inbox_drop_oldest_sheds_client_frames_only():
    sim = make_multipaxos(
        f=1, coalesced=False,
        leader_admission=dict(admission_inbox_capacity=2,
                              admission_inbox_policy="drop"))
    transport = sim.transport
    leader = sim.leaders[0]
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import Phase1a

    # Interleave control-plane frames: they must survive the shed.
    transport.send("peer", leader.address,
                   DEFAULT_SERIALIZER.to_bytes(
                       Phase1a(round=3, chosen_watermark=0)))
    for i in range(6):
        sim.clients[0].write(i, b"w%d" % i, lambda r: None)
    assert leader.admission.rejected.get("shed_drop-oldest", 0) == 4
    buffered = [DEFAULT_SERIALIZER.from_bytes(m.data).__class__.__name__
                for m in transport.messages
                if m.dst == leader.address]
    assert buffered.count("Phase1a") == 1
    assert buffered.count("ClientRequest") == 2


def test_admission_off_leaves_hot_path_untouched():
    sim = make_multipaxos(f=1, coalesced=True)
    for actor in sim.transport.actors.values():
        assert actor.admission is None
    assert not sim.transport._inbox_policies
    results: list = []
    sim.clients[0].write(0, b"plain", results.append)
    sim.clients[0].flush_writes()
    _drive(sim)
    assert results and results[0] is not None


def test_crash_clears_inbox_policy_and_restart_recomputes_depth():
    sim = make_multipaxos(
        f=1, coalesced=False,
        leader_admission=dict(admission_inbox_capacity=8))
    transport = sim.transport
    leader = sim.leaders[0]
    sim.clients[0].write(0, b"w", lambda r: None)
    assert transport._inbox_depth[leader.address] == 1
    transport.crash(leader.address)
    assert leader.address not in transport._inbox_policies
    # Re-register the same actor object (its controller survives):
    # buffered client frames are recounted, not trusted from before.
    transport.register(leader.address, leader)
    assert transport._inbox_depth[leader.address] == 1


# --- TcpTransport bounded outbound buffer -------------------------------


def test_tcp_outbound_buffer_bounded_drops_oldest():
    from frankenpaxos_tpu_torch.runtime import FakeLogger
    from frankenpaxos_tpu_torch.runtime.tcp_transport import TcpTransport

    transport = TcpTransport(None, FakeLogger())
    transport.outbound_buffer_cap = 4096
    transport.start()
    try:
        dst = ("127.0.0.1", 1)  # nobody listening

        def fill():
            conn = transport._conn_for(("x", 0), dst)
            conn.connecting = True  # pin: pending only grows
            for i in range(64):
                transport._write(("x", 0), dst, b"%04d" % i + b"p" * 256,
                                 flush=False)
            return conn

        import asyncio

        conn = asyncio.run_coroutine_threadsafe(
            _async_value(fill), transport.loop).result(timeout=5)
        assert conn.pending_bytes <= transport.outbound_buffer_cap
        assert 0 < len(conn.pending) < 64
        # Oldest dropped, newest kept (paxwire entries: the message
        # payload rides entry[1], frame assembly is deferred to flush).
        assert conn.pending[-1][1].endswith(b"p" * 256)
        assert b"0063" in conn.pending[-1][1]
    finally:
        transport.stop()


async def _async_value(f):
    return f()


def test_rejected_has_fuzz_sample():
    """The port's codec samples (the registry-wide parity and round-trip
    tests of test_torch_wire.py) must cover tag 132."""
    from tests.test_torch_wire import codec_samples, PORT

    tags = {DEFAULT_SERIALIZER.to_bytes(m)[:2] for m in codec_samples(PORT)}
    assert bytes([0, 132 - 128]) in tags


def test_phase1_backlog_counts_against_inflight_budget():
    """Regression: while the leader sits in Phase1 (acceptors
    unreachable), admitted commands pile into pending_batches without
    advancing next_slot -- the in-flight budget must count that
    backlog, or a partitioned leader admits without bound (the exact
    unbounded-buffer growth paxload exists to prevent)."""
    sim = make_multipaxos(
        f=1, coalesced=False,
        leader_admission=dict(admission_inflight_limit=4),
        client_retry_budget=0)
    leader = sim.leaders[0]
    # Do NOT deliver: the leader stays in _Phase1 (no Phase1bs).
    assert type(leader.state).__name__ == "_Phase1"
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        ClientRequest,
        Command,
        CommandId,
    )

    for i in range(12):
        leader.receive(sim.clients[0].address, ClientRequest(
            Command(CommandId(sim.clients[0].address, i, 0), b"x")))
    assert len(leader.state.pending_batches) == 4
    assert leader._admitted_backlog == 4
    assert leader.admission.rejected.get("inflight", 0) == 8
    # Phase1 completion moves the backlog into the slot span and
    # must not double-count it.
    sim.transport.deliver_all()
    assert leader._admitted_backlog == 0


def test_duplicate_rejected_backs_off_once():
    """Regression: under overload the original request AND its resend
    both reach the leader and each draws a Rejected -- the second one
    must not consume the retry budget again or schedule a second
    concurrent reissue."""
    sim = make_multipaxos(f=1, coalesced=False, client_retry_budget=4)
    sim.transport.deliver_all()
    client = sim.clients[0]
    client.write(0, b"w", lambda r: None)
    state = client.states[0]
    rejected = Rejected(entries=((0, state.id),), retry_after_ms=0,
                        reason=REASON_INFLIGHT)
    client._handle_rejected(("leader", 1), rejected)
    assert state.attempts == 1 and state.backoff_pending
    client._handle_rejected(("leader", 1), rejected)  # resend's dup
    assert state.attempts == 1, "budget double-consumed"
    backoffs = [t for t in sim.transport.running_timers()
                if t.name.startswith("backoff")]
    assert len(backoffs) == 1, "two concurrent reissue timers"
    # The guard clears at reissue time: a LATER Rejected (for the
    # re-sent request) backs off again.
    sim.transport.trigger_timer(backoffs[0].id)
    assert not state.backoff_pending
    client._handle_rejected(("leader", 1), rejected)
    assert state.attempts == 2 and state.backoff_pending


def test_sim_timer_registry_holds_running_timers_only():
    """Regression: timers registered for the object's lifetime leak
    the registry (and the per-tick running_timers() scan) without
    bound -- clients create a fresh backoff/resend timer per
    operation, and overload runs pump millions."""
    sim = make_multipaxos(f=1, coalesced=False)
    transport = sim.transport
    fired = []
    before = len(transport.timers)
    t = transport.timer("test-addr", "probe", 1.0, lambda: fired.append(1))
    assert len(transport.timers) == before  # not registered until start
    t.start()
    assert transport.timers[t.id] is t
    transport.trigger_timer(t.id)
    assert fired == [1]
    assert t.id not in transport.timers  # one-shot fire deregisters
    t.start()
    t.stop()
    assert t.id not in transport.timers  # stop deregisters


# --- what stays refused ---------------------------------------------------


def test_batched_reads_are_answered():
    """The three batch kinds of a read batcher reach the replica and are
    answered, through its read admission: a ReadRequestBatch and a
    SequentialReadRequestBatch at an executed slot and an
    EventualReadRequestBatch, each command of each one replied to."""
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        Command,
        CommandId,
        EventualReadRequestBatch,
        ReadReply,
        ReadReplyBatch,
        ReadRequestBatch,
        SequentialReadRequestBatch,
    )

    sim = make_multipaxos(f=1, coalesced=False)
    sim.transport.deliver_all()
    replica = sim.replicas[0]
    replica.admission = AdmissionController(
        AdmissionOptions(inflight_limit=4), role="replica_test")
    client = sim.clients[0].address
    for batch in (ReadRequestBatch(slot=-1, commands=(
                      Command(CommandId(client, 0, 0), b"r"),)),
                  SequentialReadRequestBatch(slot=-1, commands=(
                      Command(CommandId(client, 1, 0), b"r"),)),
                  EventualReadRequestBatch(commands=(
                      Command(CommandId(client, 2, 0), b"r"),))):
        sim.transport.messages.clear()
        replica.receive(client, batch)
        replies = [DEFAULT_SERIALIZER.from_bytes(m.data)
                   for m in sim.transport.messages]
        answered = [r.command_id.client_pseudonym for m in replies
                    for r in (m.batch if isinstance(m, ReadReplyBatch)
                              else (m,))
                    if isinstance(r, ReadReply)]
        assert answered == [batch.commands[0].command_id.client_pseudonym]
    assert replica.admission.inflight == 0


def test_read_batch_inflight_budget_binds_within_one_batch():
    """Per-command resyncs from the (unchanged) deferred-read count
    would erase admit()'s increments, so a single ReadRequestBatch would
    admit every read no matter the limit."""
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        Command,
        CommandId,
        ReadRequestBatch,
    )

    sim = make_multipaxos(f=1, coalesced=False)
    sim.transport.deliver_all()
    replica = sim.replicas[0]
    replica.admission = AdmissionController(
        AdmissionOptions(inflight_limit=4), role="replica_test")
    commands = tuple(
        Command(CommandId(sim.clients[0].address, i, 0), b"r")
        for i in range(10))
    # A future slot makes every admitted read DEFERRABLE.
    replica._handle_read_request_batch(
        sim.clients[0].address,
        ReadRequestBatch(slot=replica.executed_watermark + 5,
                         commands=commands))
    assert replica._deferred_read_count == 4
    assert replica.admission.rejected.get("inflight", 0) == 6
    replica.admission.set_inflight(replica._deferred_read_count)
    assert replica.admission.inflight == 4


def test_eventual_read_batch_passes_read_admission():
    """The batcher's EventualReadRequestBatch passes role admission and
    the client lane like the single-message path: the refused suffix
    gets explicit Rejected replies, and the batch settles back to a
    zero backlog."""
    assert "EventualReadRequestBatch" in lanes.CLIENT_LANE_TYPE_NAMES
    assert "SequentialReadRequestBatch" in lanes.CLIENT_LANE_TYPE_NAMES
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        Command,
        CommandId,
        EventualReadRequestBatch,
    )

    sim = make_multipaxos(f=1, coalesced=False)
    sim.transport.deliver_all()
    replica = sim.replicas[0]
    replica.admission = AdmissionController(
        AdmissionOptions(inflight_limit=4), role="replica_test")
    commands = tuple(
        Command(CommandId(sim.clients[0].address, i, 0), b"r")
        for i in range(10))
    replica.receive(sim.clients[0].address,
                    EventualReadRequestBatch(commands=commands))
    assert replica.admission.rejected.get("inflight", 0) == 6
    rejects = [m for m in sim.transport.messages
               if DEFAULT_SERIALIZER.from_bytes(m.data).__class__
               is Rejected]
    assert len(rejects) == 6
    assert replica.admission.inflight == 0


def test_unbatched_read_admission_rejects_past_the_deferred_budget():
    """The read path the port carries: a linearizable read past the
    executed watermark defers and counts against the budget; past it
    the client gets an explicit Rejected."""
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        Command,
        CommandId,
        ReadRequest,
    )

    sim = make_multipaxos(f=1, coalesced=False)
    sim.transport.deliver_all()
    replica = sim.replicas[0]
    replica.admission = AdmissionController(
        AdmissionOptions(inflight_limit=2), role="replica_test")
    client = sim.clients[0].address
    for i in range(5):
        replica.receive(client, ReadRequest(
            slot=replica.executed_watermark + 3,
            command=Command(CommandId(client, i, 0), b"r")))
    assert replica._deferred_read_count == 2
    assert replica.admission.rejected == {"inflight": 3}
    rejects = [m for m in sim.transport.messages
               if DEFAULT_SERIALIZER.from_bytes(m.data).__class__
               is Rejected]
    assert len(rejects) == 3 and all(m.dst == client for m in rejects)


# --- parity with the JAX package -----------------------------------------

from frankenpaxos_tpu_torch.serve import messages as port_messages  # noqa: E402
import numpy as np  # noqa: E402

import frankenpaxos_tpu.protocols.multipaxos  # noqa: E402,F401
from frankenpaxos_tpu.runtime.serializer import (  # noqa: E402
    DEFAULT_SERIALIZER as REF_SERIALIZER,
)
from frankenpaxos_tpu.serve import admission as ref_admission  # noqa: E402
from frankenpaxos_tpu.serve import messages as ref_messages  # noqa: E402


@pytest.mark.parametrize("seed", range(4))
def test_rejected_bytes_equal_the_references_for_every_reason(seed):
    rng = np.random.default_rng(seed)
    for reason in sorted(port_messages.REASON_NAMES):
        n = int(rng.integers(0, 6))
        entries = tuple((int(p), int(c)) for p, c in
                        rng.integers(-2**40, 2**40, size=(n, 2)))
        retry = int(rng.integers(0, 2**31 - 1))
        port = DEFAULT_SERIALIZER.to_bytes(port_messages.Rejected(
            entries=entries, retry_after_ms=retry, reason=reason))
        ref = REF_SERIALIZER.to_bytes(ref_messages.Rejected(
            entries=entries, retry_after_ms=retry, reason=reason))
        assert port == ref
        assert DEFAULT_SERIALIZER.from_bytes(ref) == port_messages.Rejected(
            entries=entries, retry_after_ms=retry, reason=reason)
    assert port_messages.REASON_NAMES == ref_messages.REASON_NAMES


def _requests(pkg, rng) -> list:
    """One request of every shape ``reject_replies_for`` answers (and a
    control message it does not), from ``pkg``'s classes."""
    import importlib

    mp = importlib.import_module(f"{pkg}.protocols.multipaxos.messages")
    ingest = importlib.import_module(f"{pkg}.ingest.messages")
    mpwire = importlib.import_module(f"{pkg}.protocols.multipaxos.wire")
    clients = [("10.0.0.%d" % i, 9000 + i) for i in range(3)]

    def command(i):
        c = clients[int(rng.integers(0, 3))]
        return mp.Command(mp.CommandId(c, int(rng.integers(0, 64)), i),
                          b"v%d" % i)

    commands = tuple(command(i) for i in range(7))
    one = tuple(mp.CommandBatch((c,)) for c in commands)
    lazy = mpwire.decode_value_array(mpwire.encode_value_array(one))
    return [
        mp.ClientRequest(commands[0]),
        mp.ClientRequestArray(commands=tuple(
            mp.Command(mp.CommandId(clients[0], p, p), b"a")
            for p in range(4))),
        mp.ClientRequestArray(commands=()),
        mp.ClientRequestBatch(mp.CommandBatch(commands)),
        ingest.IngestRun(batcher_index=1, values=one, seq=3),
        ingest.IngestRun(batcher_index=1, values=lazy, seq=4),
        mp.Phase1a(round=1, chosen_watermark=0),
    ]


@pytest.mark.parametrize("seed", range(3))
def test_reject_replies_for_equals_the_references(seed):
    port = _requests("frankenpaxos_tpu_torch", np.random.default_rng(seed))
    ref = _requests("frankenpaxos_tpu", np.random.default_rng(seed))
    for p, r in zip(port, ref):
        for reason in (REASON_QUEUE, REASON_INFLIGHT):
            got = [(a, DEFAULT_SERIALIZER.to_bytes(m))
                   for a, m in reject_replies_for(p, 25, reason)]
            want = [(a, REF_SERIALIZER.to_bytes(m))
                    for a, m in ref_admission.reject_replies_for(
                        r, 25, reason)]
            assert got == want, type(p).__name__


_OPTION_SETS = (
    dict(inflight_limit=6),
    dict(token_rate=40.0, token_burst=5.0),
    dict(inflight_limit=9, token_rate=25.0, token_burst=4.0,
         codel_target_s=0.01, codel_interval_s=0.05),
    dict(codel_target_s=0.02, codel_interval_s=0.1, inbox_capacity=3,
         retry_after_ms=40),
)


def _script(controller_cls, options_cls, option_set, seed) -> list:
    """One seeded script of clock steps and controller calls; the trace
    of every result and every piece of state after each call."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    ctl = controller_cls(options_cls(**option_set), clock=clock)
    trace = []
    for _ in range(300):
        clock.t += float(rng.choice([0.0, 0.001, 0.004, 0.02, 0.11]))
        op = int(rng.integers(0, 7))
        n = int(rng.integers(0, 9))
        if op == 0:
            out = ctl.admit(max(n, 1))
        elif op == 1:
            out = ctl.admit_up_to(n)
        elif op == 2:
            out = ctl.set_inflight(int(rng.integers(-2, 12)))
        elif op == 3:
            out = ctl.note_drain_delay(float(rng.choice(
                [0.0005, 0.005, 0.015, 0.03, 0.2])))
        elif op == 4:
            out = ctl.shed_active()
        elif op == 5:
            out = ctl.inbox_full(n)
        else:
            out = ctl.release(n)
        trace.append((op, out, ctl.inflight, ctl.admitted,
                      dict(ctl.rejected), ctl.last_reason, ctl.shedding,
                      None if ctl.bucket is None else ctl.bucket.tokens,
                      ctl.retry_after_ms()))
    return trace


@pytest.mark.parametrize("option_set", _OPTION_SETS)
@pytest.mark.parametrize("seed", range(3))
def test_admission_decisions_equal_the_references(option_set, seed):
    port = _script(AdmissionController, AdmissionOptions, option_set, seed)
    ref = _script(ref_admission.AdmissionController,
                  ref_admission.AdmissionOptions, option_set, seed)
    assert port == ref
    # Every mechanism the set arms was exercised.
    reasons = set()
    for entry in port:
        reasons.update(entry[4])
    assert reasons


def _overload(harness, **backends) -> tuple:
    """The in-flight-limit scenario of
    test_leader_inflight_limit_rejects_then_backoff_completes, recording
    every Rejected the client receives, in order."""
    sim = harness.make_multipaxos(
        f=1, coalesced=True, seed=5,
        leader_admission=dict(admission_inflight_limit=4),
        client_retry_budget=8, **backends)
    client = sim.clients[0]
    seen: list = []
    handle = client._handle_rejected

    def spy(src, rejected):
        seen.append((src, rejected.entries, rejected.reason))
        handle(src, rejected)

    client._handle_rejected = spy
    results: dict = {}
    for i in range(12):
        client.write(i, b"w%d" % i,
                     (lambda r, i=i: results.__setitem__(i, r)))
    client.flush_writes()
    sim.transport.deliver_all()
    for _ in range(40):
        if len(results) == 12:
            break
        for timer in sorted(sim.transport.running_timers(),
                            key=lambda t: t.id):
            if timer.name.startswith("backoff"):
                sim.transport.trigger_timer(timer.id)
        for c in sim.clients:
            c.flush_writes()
        sim.transport.deliver_all()
    logs = [[repr(v) for v in harness.executed_prefix(r)]
            for r in sim.replicas]
    return results, seen, logs


@pytest.mark.parametrize("backends", [
    {}, dict(quorum_backend="cuda", phase1_backend="cuda", device="cpu")],
    ids=["dict", "cuda"])
def test_overload_rejects_and_logs_equal_the_references(backends):
    from frankenpaxos_tpu_torch.protocols.multipaxos import harness as th
    from tests.protocols import multipaxos_harness as jh

    port = _overload(th, **backends)
    ref = _overload(jh)
    assert port[0] == ref[0] and len(port[0]) == 12
    assert port[1] == ref[1] and port[1]
    assert port[2] == ref[2]
