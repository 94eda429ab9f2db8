"""The port's MultiPaxos cluster vs the JAX package's.

(a) The cases of ``tests/protocols/test_multipaxos.py`` that use no WAL,
admission, ingest fabric or property simulator, repeated
against the port's harness, with ``quorum_backend="cuda"`` and
``phase1_backend="cuda"`` on ``device="cpu"`` (the plain versions of
K1, K2, K4, K5 and K8) where the reference used ``"tpu"``.
(b) Cross-package parity: the same seed and writes through the JAX
harness and the port's give equal executed logs on every replica and
equal reply lists, through a failover.
(c) ``Leader._recover_values`` on the same Phase1bs returns identical
lists in both packages, ties included, on both backends.
(d) The reference's ``MultiPaxosSimulated`` property on the port's
``Simulator``, at its eight parametrisations and sizes, and its tpu case
on the cuda backend with ``device="cpu"``.
Plus the read batchers' messages at their roles, and the cluster bench
end to end at a small size.
"""

import random
from typing import Optional

from frankenpaxos_tpu_torch.bench import multipaxos_sim
from frankenpaxos_tpu_torch.election.basic import (
    ElectionOptions,
    ElectionParticipant,
)
from frankenpaxos_tpu_torch.protocols.multipaxos import (
    Acceptor,
    harness as th,
    LeaderOptions,
    messages as tm,
    ProxyLeader,
    ProxyLeaderOptions,
    Replica,
    ReplicaOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
    executed_prefix,
    make_multipaxos,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.leader import _Phase1, Leader
from frankenpaxos_tpu_torch.reconfig import (
    EpochAck,
    EpochCommit,
    EpochPhase2aRun,
    Reconfigure,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, PickleSerializer
from frankenpaxos_tpu_torch.runtime.serializer import (
    DEFAULT_SERIALIZER as SER_WIRE,
)
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
from frankenpaxos_tpu_torch.statemachine import (
    GetRequest,
    KeyValueStore,
    SetRequest,
)
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.protocols.multipaxos import messages as jm
from frankenpaxos_tpu.protocols.multipaxos.leader import _Phase1 as _JPhase1
from tests.protocols import multipaxos_harness as jh

SER = PickleSerializer()
#: The port's device-backed options, on the plain versions.
CUDA = dict(quorum_backend="cuda", phase1_backend="cuda", device="cpu")


def run_write(sim, client_index, pseudonym, payload):
    got = []
    sim.clients[client_index].write(pseudonym, payload, got.append)
    sim.transport.deliver_all()
    return got


# --- (a) the reference's cases, against the port ----------------------------


class TestMultiPaxosIntegration:
    def test_single_write(self):
        sim = make_multipaxos(f=1)
        assert run_write(sim, 0, 0, b"hello") == [b"0"]
        for replica in sim.replicas:
            assert replica.state_machine.get() == [b"hello"]

    def test_sequential_writes_agree(self):
        sim = make_multipaxos(f=1)
        for i in range(10):
            assert run_write(sim, 0, 0, b"cmd%d" % i) == [b"%d" % i]
        logs = [executed_prefix(r) for r in sim.replicas]
        assert logs[0] == logs[1]
        assert len(logs[0]) == 10

    def test_multiple_clients_pseudonyms(self):
        sim = make_multipaxos(f=1, num_clients=3)
        results = []
        for i, client in enumerate(sim.clients):
            client.write(0, b"c%d-p0" % i, results.append)
            client.write(1, b"c%d-p1" % i, results.append)
        sim.transport.deliver_all()
        assert len(results) == 6
        for replica in sim.replicas:
            assert len(replica.state_machine.get()) == 6

    def test_f2(self):
        sim = make_multipaxos(f=2)
        assert run_write(sim, 0, 0, b"x") == [b"0"]

    def test_multiple_acceptor_groups(self):
        sim = make_multipaxos(f=1, num_acceptor_groups=3)
        for i in range(6):
            assert run_write(sim, 0, 0, b"cmd%d" % i) == [b"%d" % i]
        for g in range(3):
            group = sim.acceptors[g * 3:(g + 1) * 3]
            assert any(a.max_voted_slot >= 0 for a in group), g

    def test_flexible_grid(self):
        sim = make_multipaxos(f=1, flexible=True, grid_shape=(2, 3))
        for i in range(5):
            assert run_write(sim, 0, 0, b"cmd%d" % i) == [b"%d" % i]

    def test_batchers(self):
        sim = make_multipaxos(f=1, num_batchers=2, batch_size=2,
                              num_clients=4)
        results = []
        for client in sim.clients:
            client.write(0, b"w", results.append)
        sim.transport.deliver_all()
        for _ in range(5):
            if len(results) == 4:
                break
            for timer in sim.transport.running_timers():
                if timer.name.startswith("resendWrite"):
                    sim.transport.trigger_timer(timer.id)
            sim.transport.deliver_all()
        assert len(results) == 4
        assert len(sim.replicas[0].state_machine.get()) == 4

    def test_proxy_replicas(self):
        sim = make_multipaxos(f=1, num_proxy_replicas=2)
        assert run_write(sim, 0, 0, b"via-proxy") == [b"0"]

    def test_cuda_quorum_backend_matches(self):
        sim = make_multipaxos(f=1, quorum_backend="cuda", device="cpu")
        for i in range(5):
            assert run_write(sim, 0, 0, b"cmd%d" % i) == [b"%d" % i]
        logs = [executed_prefix(r) for r in sim.replicas]
        assert logs[0] == logs[1] and len(logs[0]) == 5

    def test_cuda_backend_flexible_grid(self):
        sim = make_multipaxos(f=1, flexible=True, grid_shape=(2, 3),
                              quorum_backend="cuda", device="cpu")
        for i in range(4):
            assert run_write(sim, 0, 0, b"cmd%d" % i) == [b"%d" % i]

    def test_tpu_phase1_recovery_preserves_log(self):
        """Failover with phase1_backend="cuda" (the reference's "tpu"):
        the new leader's K8 recovery preserves every chosen value."""
        sim = make_multipaxos(f=1, phase1_backend="cuda", device="cpu")
        for i in range(4):
            assert run_write(sim, 0, 0, b"cmd%d" % i) == [b"%d" % i]
        sim.leaders[0].leader_change(is_new_leader=False)
        sim.leaders[1].leader_change(is_new_leader=True)
        sim.transport.deliver_all()
        assert run_write(sim, 0, 0, b"after") == [b"4"]
        logs = [executed_prefix(r) for r in sim.replicas]
        assert logs[0] == logs[1] and len(logs[0]) >= 5

    @pytest.mark.parametrize("num_groups", [1, 2])
    def test_recover_values_tpu_matches_host(self, num_groups):
        """_recover_values oracle equivalence: the host scan vs K8, across
        groups and vote patterns; identical wherever the host answer is
        unambiguous (the reference's test), and K8's choice is always
        one of the top-round values."""
        rng = random.Random(11)
        sim_host = make_multipaxos(f=1, num_acceptor_groups=num_groups,
                                   phase1_backend="host")
        sim_cuda = make_multipaxos(f=1, num_acceptor_groups=num_groups,
                                   phase1_backend="cuda", device="cpu")
        max_slot = 12
        phase1bs = [{} for _ in range(num_groups)]
        for group_index in range(num_groups):
            for acceptor_index in range(3):
                infos = []
                for slot in range(max_slot + 1):
                    if slot % num_groups != group_index \
                            or rng.random() < 0.5:
                        continue
                    infos.append(tm.Phase1bSlotInfo(
                        slot=slot, vote_round=rng.randrange(3),
                        vote_value=b"v%d" % rng.randrange(4)))
                phase1bs[group_index][acceptor_index] = tm.Phase1b(
                    group_index=group_index, acceptor_index=acceptor_index,
                    round=0, info=tuple(infos))
        phase1 = _Phase1(phase1bs=phase1bs, phase1b_acceptors=set(),
                         pending_batches=[], resend_phase1as=None)
        for leader in (sim_host.leaders[0], sim_cuda.leaders[0]):
            leader.chosen_watermark = 2
        host = sim_host.leaders[0]._recover_values(phase1, max_slot)
        cuda = sim_cuda.leaders[0]._recover_values(phase1, max_slot)
        assert len(host) == len(cuda) == max_slot - 1
        for slot, (h, t) in enumerate(zip(host, cuda), start=2):
            votes = [(i.vote_round, i.vote_value)
                     for p in phase1bs[slot % num_groups].values()
                     for i in p.info if i.slot == slot]
            if not votes:
                assert h is tm.NOOP and t is tm.NOOP
                continue
            top = max(r for r, _ in votes)
            top_values = {v for r, v in votes if r == top}
            assert h in top_values and t in top_values
            if len(top_values) == 1:
                assert h == t

    def test_kv_store_write_and_read(self):
        sim = make_multipaxos(f=1, state_machine_factory=KeyValueStore)
        client = sim.clients[0]
        got = []
        client.write(0, SER.to_bytes(SetRequest((("k", "v"),))),
                     got.append)
        sim.transport.deliver_all()
        assert len(got) == 1
        reads = []
        client.read(1, SER.to_bytes(GetRequest(("k",))),
                    lambda r: reads.append(SER.from_bytes(r)))
        sim.transport.deliver_all()
        assert len(reads) == 1
        assert reads[0].key_values == (("k", "v"),)

    def test_sequential_and_eventual_reads(self):
        sim = make_multipaxos(f=1, state_machine_factory=KeyValueStore)
        client = sim.clients[0]
        client.write(0, SER.to_bytes(SetRequest((("k", "v"),))))
        sim.transport.deliver_all()
        seq, ev = [], []
        client.sequential_read(1, SER.to_bytes(GetRequest(("k",))),
                               lambda r: seq.append(SER.from_bytes(r)))
        client.eventual_read(2, SER.to_bytes(GetRequest(("k",))),
                             lambda r: ev.append(SER.from_bytes(r)))
        sim.transport.deliver_all()
        assert seq and seq[0].key_values == (("k", "v"),)
        assert ev and ev[0].key_values == (("k", "v"),)

    def test_write_resend_is_deduplicated(self):
        sim = make_multipaxos(f=1)
        got = []
        sim.clients[0].write(0, b"once", got.append)
        for timer in sim.transport.running_timers():
            if timer.name.startswith("resendWrite"):
                sim.transport.trigger_timer(timer.id)
        sim.transport.deliver_all()
        assert got == [b"0"]
        assert sim.replicas[0].state_machine.get() == [b"once"]

    def test_pending_pseudonym_rejected(self):
        sim = make_multipaxos(f=1)
        sim.clients[0].write(0, b"a")
        with pytest.raises(RuntimeError):
            sim.clients[0].write(0, b"b")


def _v(i):
    return tm.CommandBatch((tm.Command(tm.CommandId("client-0", i, 0),
                                       b"v%d" % i),))


class TestCoalescedRunPipeline:
    """The drain-granular run pipeline (ClientRequestArray ->
    Phase2aRun -> Phase2bRange -> ChosenRun -> ClientReplyArray)
    against the per-message shape."""

    def drive(self, sim, lo, hi, got):
        for p in range(lo, hi):
            sim.clients[0].write(p, b"v%d" % p, got.append)
        sim.clients[0].flush_writes()
        sim.transport.deliver_all_coalesced()

    @pytest.mark.parametrize("backend", ["dict", "cuda"])
    def test_matches_per_message_pipeline(self, backend):
        logs = {}
        for coalesced in (False, True):
            sim = make_multipaxos(f=1, coalesced=coalesced,
                                  quorum_backend=backend, device="cpu")
            got = []
            for wave in range(4):
                self.drive(sim, wave * 50, wave * 50 + 50, got)
            assert sorted(got, key=int) == [b"%d" % p for p in range(200)]
            assert executed_prefix(sim.replicas[0]) \
                == executed_prefix(sim.replicas[1])
            logs[coalesced] = executed_prefix(sim.replicas[0])
        assert len(logs[False]) == len(logs[True]) == 200
        assert logs[False] == logs[True]

    def test_survives_leader_failover(self):
        sim = make_multipaxos(f=1, coalesced=True, **CUDA)
        got = []
        self.drive(sim, 0, 32, got)
        assert len(got) == 32
        before = executed_prefix(sim.replicas[0])
        assert len(before) == 32
        sim.leaders[1].leader_change(is_new_leader=True)
        sim.leaders[0].leader_change(is_new_leader=False)
        sim.transport.deliver_all_coalesced()
        after = executed_prefix(sim.replicas[0])
        assert after[:len(before)] == before
        assert executed_prefix(sim.replicas[1])[:len(before)] == before
        self.drive(sim, 32, 48, got)
        assert len(got) == 48
        final = executed_prefix(sim.replicas[0])
        assert executed_prefix(sim.replicas[1]) == final
        payloads = [v.commands[0].command for v in final
                    if not isinstance(v, tm.Noop) and v.commands]
        assert set(b"v%d" % p for p in range(48)) <= set(payloads)

    def test_proxy_leader_partial_run_emission_and_stray_acks(self):
        sim = make_multipaxos(f=1)
        proxy = sim.proxy_leaders[0]
        proxy.receive("leader-0", tm.Phase2aRun(
            start_slot=0, round=0, values=tuple(_v(i) for i in range(8))))
        sim.transport.messages.clear()

        def ack(acc, lo, hi):
            proxy.receive(f"acceptor-0-{acc}", tm.Phase2bRange(
                group_index=0, acceptor_index=acc,
                slot_start_inclusive=lo, slot_end_exclusive=hi, round=0))

        def chosen():
            return [proxy.serializer.from_bytes(m.data)
                    for m in sim.transport.messages
                    if m.dst == "replica-0"]

        ack(0, 0, 8)
        ack(1, 0, 5)
        proxy.on_drain()
        assert [(c.start_slot, len(c.values)) for c in chosen()] == [(0, 5)]
        sim.transport.messages.clear()
        ack(1, 5, 8)
        proxy.on_drain()
        assert [(c.start_slot, len(c.values)) for c in chosen()] == [(5, 3)]
        assert proxy._runs == {} and proxy._run_starts == []
        assert proxy._done_runs == [(0, 8, 0)]
        sim.transport.messages.clear()
        ack(2, 2, 6)
        proxy.receive("acceptor-0-2", tm.Phase2b(
            group_index=0, acceptor_index=2, slot=3, round=0))
        proxy.on_drain()
        assert [m for m in sim.transport.messages
                if m.dst.startswith("replica")] == []

    def test_proxy_leader_duplicate_run_ignored(self):
        sim = make_multipaxos(f=1)
        proxy = sim.proxy_leaders[0]
        run = tm.Phase2aRun(start_slot=0, round=0, values=(_v(0),))
        sim.transport.messages.clear()
        proxy.receive("leader-0", run)
        forwards = len(sim.transport.messages)
        assert forwards == sim.config.f + 1
        proxy.receive("leader-0", run)
        assert len(sim.transport.messages) == forwards
        assert len(proxy._run_starts) == 1

    def test_proxy_leader_higher_round_run_evicts_stale_pending(self):
        sim = make_multipaxos(f=1)
        proxy = sim.proxy_leaders[0]
        run0 = tm.Phase2aRun(start_slot=0, round=0,
                             values=(_v(0), _v(1), _v(2)))
        sim.transport.messages.clear()
        proxy.receive("leader-0", run0)
        forwards = len(sim.transport.messages)
        proxy.receive("leader-0", run0)
        assert len(sim.transport.messages) == forwards
        proxy.receive("leader-1", tm.Phase2aRun(
            start_slot=0, round=1, values=(_v(0), _v(1), _v(2))))
        assert len(sim.transport.messages) == 2 * forwards
        assert proxy._runs[0][1] == 1 and len(proxy._run_starts) == 1
        sim.transport.messages.clear()
        proxy.receive("acceptor-0-0", tm.Phase2bRange(
            group_index=0, acceptor_index=0, slot_start_inclusive=0,
            slot_end_exclusive=3, round=0))
        proxy.receive("acceptor-0-0", tm.Phase2b(
            group_index=0, acceptor_index=0, slot=1, round=0))
        proxy.on_drain()
        assert [m for m in sim.transport.messages
                if m.dst.startswith("replica")] == []
        for acc in (0, 1):
            proxy.receive(f"acceptor-0-{acc}", tm.Phase2bRange(
                group_index=0, acceptor_index=acc,
                slot_start_inclusive=0, slot_end_exclusive=3, round=1))
        proxy.on_drain()
        chosen = [proxy.serializer.from_bytes(m.data)
                  for m in sim.transport.messages if m.dst == "replica-0"]
        assert [(c.start_slot, len(c.values)) for c in chosen] == [(0, 3)]

    def test_failover_with_proposals_stuck_at_proxies(self):
        sim = make_multipaxos(f=1, coalesced=True, **CUDA)
        got = []
        for p in range(16):
            sim.clients[0].write(p, b"q%d" % p, got.append)
        sim.clients[0].flush_writes()
        for proxy in sim.config.proxy_leader_addresses:
            sim.transport.partition(proxy)
        sim.transport.deliver_all_coalesced()
        assert got == []
        sim.leaders[1].leader_change(is_new_leader=True)
        sim.leaders[0].leader_change(is_new_leader=False)
        for proxy in sim.config.proxy_leader_addresses:
            sim.transport.heal(proxy)
        sim.transport.deliver_all_coalesced()
        for t in list(sim.transport.running_timers()):
            if t.name.startswith("resendWrite"):
                t.run()
        sim.transport.deliver_all_coalesced()
        assert len(got) == 16
        assert executed_prefix(sim.replicas[0]) \
            == executed_prefix(sim.replicas[1])
        executed = sim.replicas[0].state_machine.get()
        for p in range(16):
            assert executed.count(b"q%d" % p) == 1, (p, executed)

    def test_acceptor_phase1b_merges_run_votes(self):
        sim = make_multipaxos(f=1)
        acceptor = sim.acceptors[0]
        v = lambda tag: tm.CommandBatch((tag,))  # noqa: E731
        acceptor.receive("proxy-leader-0", tm.Phase2aRun(
            start_slot=10, round=0, values=(v("a"), v("b"), v("c"))))
        acceptor.receive("proxy-leader-0",
                         tm.Phase2a(slot=11, round=1, value=v("b2")))
        acceptor.receive("leader-1",
                         tm.Phase1a(round=2, chosen_watermark=10))
        sent = [m for m in sim.transport.messages if m.dst == "leader-1"]
        phase1b = acceptor.serializer.from_bytes(sent[-1].data)
        info = {i.slot: (i.vote_round, i.vote_value) for i in phase1b.info}
        assert info[10] == (0, v("a"))
        assert info[11] == (1, v("b2"))
        assert info[12] == (0, v("c"))


class TestAcceptorSameStartTruncation:
    """A shorter same-start Phase2aRun replacing a longer record keeps
    the non-overlapped voted tail."""

    def _phase1b(self, sim, acceptor, round, watermark):
        acceptor.receive("leader-1", tm.Phase1a(round=round,
                                                chosen_watermark=watermark))
        sent = [m for m in sim.transport.messages if m.dst == "leader-1"]
        phase1b = acceptor.serializer.from_bytes(sent[-1].data)
        return phase1b, {i.slot: (i.vote_round, i.vote_value)
                         for i in phase1b.info}

    @pytest.mark.parametrize("backend", ["host", "cuda"])
    def test_truncation_across_leader_change_preserves_tail(self, backend):
        sim = make_multipaxos(f=1, coalesced=True, phase1_backend=backend,
                              device="cpu")
        acceptor = sim.acceptors[0]
        acceptor.receive("proxy-leader-0", tm.Phase2aRun(
            start_slot=10, round=0, values=tuple(_v(i) for i in range(8))))
        acceptor.receive("proxy-leader-0", tm.Phase2aRun(
            start_slot=10, round=1,
            values=tuple(_v(100 + i) for i in range(3))))
        phase1b, info = self._phase1b(sim, acceptor, 2, 10)
        for i in range(3):
            assert info[10 + i] == (1, _v(100 + i))
        for i in range(3, 8):
            assert info[10 + i] == (0, _v(i)), i
        leader = sim.leaders[1]
        leader.chosen_watermark = 10
        phase1 = _Phase1(phase1bs=[{0: phase1b}], phase1b_acceptors=set(),
                         pending_batches=[], resend_phase1as=None)
        values = leader._recover_values(phase1, 17)
        assert values == [_v(100 + i) for i in range(3)] \
            + [_v(i) for i in range(3, 8)]

    def test_truncation_tail_collides_with_existing_run(self):
        sim = make_multipaxos(f=1, coalesced=True)
        acceptor = sim.acceptors[0]
        for start, rnd, tag, n in ((14, 1, 0, 6), (10, 2, 20, 8),
                                   (10, 3, 40, 4)):
            acceptor.receive("proxy-leader-0", tm.Phase2aRun(
                start_slot=start, round=rnd,
                values=tuple(_v(tag + i) for i in range(n))))
        _, info = self._phase1b(sim, acceptor, 4, 10)
        for i in range(4):
            assert info[10 + i] == (3, _v(40 + i))
        for i in range(4, 8):
            assert info[10 + i] == (2, _v(20 + i)), i
        for slot in (18, 19):
            assert info[slot] == (1, _v(slot - 14))


def test_acceptor_emits_phase2b_ranges_per_drain():
    sim = make_multipaxos(f=1)
    acceptor = sim.acceptors[0]
    sim.transport.messages.clear()
    for slot in (10, 11, 12, 20):
        acceptor.receive("proxy-leader-0",
                         tm.Phase2a(slot=slot, round=0, value=tm.NOOP))
    acceptor.on_drain()
    out = [acceptor.serializer.from_bytes(m.data)
           for m in sim.transport.messages if m.src == acceptor.address]
    ranges = [m for m in out if isinstance(m, tm.Phase2bRange)]
    singles = [m for m in out if isinstance(m, tm.Phase2b)]
    assert len(ranges) == 1 and len(singles) == 1
    assert (ranges[0].slot_start_inclusive,
            ranges[0].slot_end_exclusive) == (10, 13)
    assert singles[0].slot == 20


def test_acceptor_packs_fragmented_drains():
    sim = make_multipaxos(f=1)
    acceptor = sim.acceptors[0]
    acceptor._pending_phase2bs = {"proxy": [(s, 0)
                                            for s in range(0, 40, 2)]}
    sent = []
    acceptor.send = lambda dst, m: sent.append(m)
    acceptor.on_drain()
    assert len(sent) == 1 and isinstance(sent[0], tm.Phase2bVotes)
    slots, rounds = tm.unpack_votes2(sent[0].packed)
    assert list(slots) == list(range(0, 40, 2))
    assert set(rounds.tolist()) == {0}
    acceptor._pending_phase2bs = {"proxy": [(s, 0) for s in range(20)]}
    sent.clear()
    acceptor.on_drain()
    assert len(sent) == 1 and isinstance(sent[0], tm.Phase2bRange)


def test_vote_packing_matches_the_reference():
    from frankenpaxos_tpu import native

    rng = np.random.default_rng(4)
    slots = rng.integers(0, 2**40, size=300)
    rounds = rng.integers(-1, 2**31 - 1, size=300).astype(np.int32)
    packed = tm.pack_votes2(slots, rounds)
    assert packed == native.pack_votes2(slots, rounds)
    got = tm.unpack_votes2(packed)
    want = native.unpack_votes2(packed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for bad in (b"\x01", packed[:-1]):
        with pytest.raises(ValueError, match="malformed"):
            tm.unpack_votes2(bad)


def test_sim_transport_coalesced_waves_match_serial():
    sim = make_multipaxos(f=1, quorum_backend="cuda", device="cpu")
    got = []
    for batch in range(3):
        for p in range(8):
            sim.clients[0].write(p, b"b%d.%d" % (batch, p), got.append)
        sim.transport.deliver_all_coalesced()
    assert len(got) == 24
    logs = [executed_prefix(r) for r in sim.replicas]
    assert logs[0] == logs[1] and len(logs[0]) >= 24


def test_pipelined_tpu_backend_matches():
    sim = make_multipaxos(f=1, quorum_backend="cuda", tpu_pipelined=True,
                          device="cpu")
    got = []
    for i in range(5):
        sim.clients[0].write(0, b"cmd%d" % i, got.append)
        for _ in range(10):
            sim.transport.deliver_all()
            if got and got[-1] == b"%d" % i:
                break
            for timer in sim.transport.running_timers():
                if timer.name == "tpuDrainFlush":
                    sim.transport.trigger_timer(timer.id)
        assert got[-1] == b"%d" % i, (i, got)
    logs = [executed_prefix(r) for r in sim.replicas]
    assert logs[0] == logs[1] and len(logs[0]) == 5


# --- (b) cross-package parity -----------------------------------------------


def _norm(value):
    """A log entry of either package as plain tuples."""
    if type(value).__name__ == "Noop":
        return None
    return tuple((c.command_id.client_address, c.command_id.client_pseudonym,
                  c.command_id.client_id, c.command)
                 for c in value.commands)


def _scenario(harness, writes: int, in_flight: int, partial: bool,
              pipelined: bool, **kwargs):
    """``writes`` coalesced writes, then ``in_flight`` more that are
    voted but not yet executed at the failover (replicas partitioned,
    or delivery cut short), then a failover to leader 1, delivery until
    quiet, a round of client resends, and quiet again."""
    sim = harness.make_multipaxos(f=1, coalesced=True, num_clients=2,
                                  tpu_pipelined=pipelined, seed=7, **kwargs)
    transport = sim.transport
    replies = []

    def settle():
        while True:
            while transport.messages:
                transport.deliver_all_coalesced()
            flush = [t for t in transport.running_timers()
                     if t.name == "tpuDrainFlush"]
            if not flush:
                return
            for timer in flush:
                transport.trigger_timer(timer.id)

    def issue(lo, hi):
        for p in range(lo, hi):
            client = sim.clients[p % 2]
            client.write(p, b"w%d" % p,
                         lambda r, p=p: replies.append((p, r)))
        for client in sim.clients:
            client.flush_writes()

    for lo in range(0, writes, 128):
        issue(lo, lo + 128)
        settle()
    if not partial:
        for address in sim.config.replica_addresses:
            transport.partition(address)
    issue(writes, writes + in_flight)
    if partial:
        transport.deliver_all_coalesced(max_steps=6)
    else:
        settle()
        for address in sim.config.replica_addresses:
            transport.heal(address)
    sim.leaders[0].leader_change(is_new_leader=False)
    sim.leaders[1].leader_change(is_new_leader=True)
    settle()
    for timer in list(transport.running_timers()):
        if timer.name.startswith("resendWrite"):
            transport.trigger_timer(timer.id)
    settle()
    logs = [[_norm(v) for v in harness.executed_prefix(r)]
            for r in sim.replicas]
    return logs, replies


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("backends", ["dict", "cuda", "pipelined"])
def test_cluster_matches_the_reference(backends, partial):
    """512 writes, then a failover with 256 slots in flight: equal
    executed logs on every replica and equal reply lists."""
    jax_kwargs = dict(quorum_backend="dict", phase1_backend="host")
    port_kwargs = dict(jax_kwargs)
    if backends != "dict":
        jax_kwargs = dict(quorum_backend="tpu", phase1_backend="tpu")
        port_kwargs = dict(CUDA)
    pipelined = backends == "pipelined"
    jax_logs, jax_replies = _scenario(jh, 512, 256, partial, pipelined,
                                      **jax_kwargs)
    logs, replies = _scenario(th, 512, 256, partial, pipelined,
                              **port_kwargs)
    assert logs[0] == logs[1]
    assert logs == jax_logs
    assert replies == jax_replies
    answered = 768
    if pipelined and not partial:
        # The pipelined board never re-reports a slot it saw chosen in
        # an older round (ROADMAP.md queue 3): the 256 slots chosen
        # while the replicas were cut off, re-proposed by the new
        # leader, are never announced again, in both packages alike.
        answered = 512
    assert sorted(p for p, _ in replies) == list(range(answered))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_pipelined_board_does_not_rereport_an_older_rounds_slot(package):
    """The fault above at its smallest: slot 0 reaches a quorum in round
    0, then again in round 1. The dict oracle reports both (slot, round)
    pairs; the pipelined tracker of either package reports round 0
    only (its board's ``chosen`` bit survives the preemption)."""
    config = make_multipaxos(f=1).config
    if package == "jax":
        from frankenpaxos_tpu.protocols.multipaxos.quorum_tracker import (
            TpuQuorumTracker as Tracker,
        )

        config = jh.make_multipaxos(f=1).config
        tracker = Tracker(config, window=1 << 12, pipelined=True)
    else:
        from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker \
            import TpuQuorumTracker as Tracker

        tracker = Tracker(config, window=1 << 12, pipelined=True,
                          device="cpu")
    reported = []
    for rnd in (0, 1):
        for acceptor in (0, 1):
            tracker.record(0, rnd, 0, acceptor)
        tracker.drain()
        while (dispatch := tracker.take_dispatch()) is not None:
            reported.extend(tracker.collect(dispatch))
    assert reported == [(0, 0)]


# --- (c) _recover_values parity ---------------------------------------------


def _phase1bs(package, rng_seed: int, num_groups: int, max_slot: int):
    """The same random Phase1bs (ties between equal rounds with
    different values included) as either package's messages."""
    rng = random.Random(rng_seed)
    phase1bs = [{} for _ in range(num_groups)]
    for group_index in range(num_groups):
        order = list(range(3))
        rng.shuffle(order)  # arrival order of the Phase1bs
        for acceptor_index in order:
            infos = []
            for slot in range(max_slot + 1):
                if slot % num_groups != group_index or rng.random() < 0.3:
                    continue
                value = (package.NOOP if rng.random() < 0.1 else
                         package.CommandBatch((package.Command(
                             package.CommandId("c", rng.randrange(3), 0),
                             b"v%d" % rng.randrange(4)),)))
                infos.append(package.Phase1bSlotInfo(
                    slot=slot, vote_round=rng.randrange(-1, 3),
                    vote_value=value))
            phase1bs[group_index][acceptor_index] = package.Phase1b(
                group_index=group_index, acceptor_index=acceptor_index,
                round=5, info=tuple(infos))
    return phase1bs


@pytest.mark.parametrize("num_groups", [1, 2])
@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_recover_values_matches_the_reference(backend, num_groups):
    max_slot, watermark = 300, 3
    jax_leader = jh.make_multipaxos(
        f=1, num_acceptor_groups=num_groups,
        phase1_backend="tpu" if backend == "cuda" else "host").leaders[0]
    leader = make_multipaxos(f=1, num_acceptor_groups=num_groups,
                             phase1_backend=backend,
                             device="cpu").leaders[0]
    jax_leader.chosen_watermark = leader.chosen_watermark = watermark
    for seed in range(3):
        want = jax_leader._recover_values(_JPhase1(
            phase1bs=_phase1bs(jm, seed, num_groups, max_slot),
            phase1b_acceptors=set(), pending_batches=[],
            resend_phase1as=None), max_slot)
        got = leader._recover_values(_Phase1(
            phase1bs=_phase1bs(tm, seed, num_groups, max_slot),
            phase1b_acceptors=set(), pending_batches=[],
            resend_phase1as=None), max_slot)
        assert [_norm(v) for v in got] == [_norm(v) for v in want]
        assert len(got) == max_slot + 1 - watermark


# --- the property simulation of tests/protocols/test_multipaxos.py ----------


class WriteCmd:
    def __init__(self, client, pseudonym, payload):
        self.client = client
        self.pseudonym = pseudonym
        self.payload = payload

    def __repr__(self):
        return f"Write({self.client}, {self.pseudonym}, {self.payload!r})"


class TransportCmd:
    def __init__(self, command):
        self.command = command

    def __repr__(self):
        return f"Transport({self.command!r})"


class FlushCmd:
    """Ship one coalescing client's staged writes (flush_writes).

    Flushing is its OWN random command -- several writes stage before a
    flush, so request arrays (and the Phase2aRuns they become) carry
    k > 1 commands INTO the adversarial interleaving of drops,
    partitions, and leader changes, instead of degenerating to k=1
    arrays that never exercise run-store edge paths."""

    def __init__(self, client):
        self.client = client

    def __repr__(self):
        return f"Flush({self.client})"


def prefixes_compatible(a: list, b: list) -> bool:
    n = min(len(a), len(b))
    return a[:n] == b[:n]


class MultiPaxosSimulated(SimulatedSystem):
    """Random writes interleaved with arbitrary deliveries/timer firings
    (the reference interleaves the same way,
    multipaxos/MultiPaxos.scala:229-268)."""

    def __init__(self, **harness_kwargs):
        self.harness_kwargs = harness_kwargs

    def new_system(self, seed):
        sim = make_multipaxos(seed=seed, num_clients=2,
                              **self.harness_kwargs)
        sim._counter = 0
        return sim

    def generate_command(self, sim, rng: random.Random):
        choices = []
        # Writes are only possible for idle pseudonyms. More pseudonyms
        # than a coalescing client can flush at once, so k > 1 writes
        # stage between flushes.
        idle = [(c, p) for c, client in enumerate(sim.clients)
                for p in range(4) if p not in client.states]
        if idle:
            choices.extend(["write"] * 2)
        staged = [c for c, client in enumerate(sim.clients)
                  if getattr(client, "_staged_writes", None)]
        if staged:
            choices.append("flush")
        transport_cmd = sim.transport.generate_command(rng)
        if transport_cmd is not None:
            # Weight transport activity higher: most steps move messages.
            choices.extend(["transport"] * 6)
        if not choices:
            return None
        kind = rng.choice(choices)
        if kind == "write":
            client, pseudonym = rng.choice(idle)
            sim._counter += 1
            return WriteCmd(client, pseudonym,
                            b"w%d" % sim._counter)
        if kind == "flush":
            return FlushCmd(rng.choice(staged))
        return TransportCmd(transport_cmd)

    def run_command(self, sim, command):
        if isinstance(command, WriteCmd):
            client = sim.clients[command.client]
            if command.pseudonym not in client.states:
                client.write(command.pseudonym, command.payload)
        elif isinstance(command, FlushCmd):
            sim.clients[command.client].flush_writes()
        else:
            sim.transport.run_command(command.command)
        return sim

    def get_state(self, sim):
        return tuple(tuple(executed_prefix(r)) for r in sim.replicas)

    def state_invariant(self, sim) -> Optional[str]:
        logs = [executed_prefix(r) for r in sim.replicas]
        for i in range(len(logs)):
            for j in range(i + 1, len(logs)):
                if not prefixes_compatible(logs[i], logs[j]):
                    return (f"replica logs diverge: {logs[i]!r} vs "
                            f"{logs[j]!r}")
        return None

    def step_invariant(self, old_state, new_state) -> Optional[str]:
        for old_log, new_log in zip(old_state, new_state):
            if list(new_log[:len(old_log)]) != list(old_log):
                return f"replica log shrank/rewrote: {old_log} -> {new_log}"
        return None


@pytest.mark.parametrize("kwargs", [
    dict(f=1),
    dict(f=1, num_acceptor_groups=2),
    dict(f=1, flexible=True, grid_shape=(2, 2)),
    dict(f=1, num_batchers=2, batch_size=2),
    dict(f=2),
    dict(f=1, coalesced=True),
    dict(f=1, coalesced=True, flexible=True, grid_shape=(2, 2)),
    dict(f=1, coalesced="mixed"),
], ids=["f1", "groups2", "grid", "batched", "f2", "coalesced",
        "coalesced-grid", "coalesced-mixed"])
def test_simulation_no_divergence(kwargs):
    simulated = MultiPaxosSimulated(**kwargs)
    failure = Simulator(simulated, run_length=150, num_runs=20).run(seed=0)
    assert failure is None, str(failure)


def test_simulation_with_cuda_backend():
    """The reference's tpu-backend case on the port's cuda tracker and
    K8 recovery, on their plain versions."""
    simulated = MultiPaxosSimulated(f=1, **CUDA)
    failure = Simulator(simulated, run_length=60, num_runs=3).run(seed=0)
    assert failure is None, str(failure)



# --- refusals -----------------------------------------------------------------


def test_backend_names():
    with pytest.raises(ValueError, match="quorum_backend"):
        make_multipaxos(f=1, quorum_backend="tpu")
    with pytest.raises(ValueError, match="phase1_backend"):
        make_multipaxos(f=1, phase1_backend="tpu")


def test_cuda_backends_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multipaxos(f=1, quorum_backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multipaxos(f=1, phase1_backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multipaxos_sim.run()


def test_unported_options_are_refused():
    """The WAL, the reconfiguration, the admission and the adaptive
    election options build (each role on a transport of its own), and an
    armed admission option gives the role its controller."""
    from frankenpaxos_tpu_torch.runtime import SimTransport
    from frankenpaxos_tpu_torch.wal import MemStorage, Wal

    sim = make_multipaxos(f=1)
    t, log, cfg = sim.transport, FakeLogger(), sim.config
    acceptor = Acceptor("acceptor-0-0", SimTransport(log), log, cfg,
                        wal=Wal(MemStorage()))
    assert acceptor.wal is not None
    replica = Replica("replica-0", SimTransport(log), log, None, cfg,
                      wal=Wal(MemStorage()))
    assert replica.wal is not None
    replica = Replica("replica-0", SimTransport(log), log, None, cfg,
                      ReplicaOptions(admission_inflight_limit=4))
    assert replica.admission.options.inflight_limit == 4
    admitted = Leader("leader-0", SimTransport(log), log, cfg,
                      LeaderOptions(admission_token_rate=10.0))
    assert admitted.admission.bucket.rate == 10.0
    assert Leader("leader-0", SimTransport(log), log, cfg).admission is None
    leader = Leader("leader-0", SimTransport(log), log, cfg,
                    LeaderOptions(epoch_tag_runs=True))
    assert leader._epoch_tagging
    for options in (ProxyLeaderOptions(epoch_quorums=True),
                    ProxyLeaderOptions(epoch_backend="dict")):
        proxy = ProxyLeader("proxy-leader-0", SimTransport(log), log, cfg,
                            options)
        assert (proxy._epoch_tracker is not None) == options.epoch_quorums
    with pytest.raises(ValueError, match="epoch_backend"):
        ProxyLeader("proxy-leader-0", t, log, cfg,
                    ProxyLeaderOptions(epoch_backend="tpu"))
    adaptive = ElectionParticipant("election-x", t, log, ["election-x"],
                                   options=ElectionOptions(adaptive=True))
    assert adaptive._gap_estimator is not None


def _outcome(role, message):
    """What ``role`` does with ``message``: ("fatal",) or ("ok", the
    types and destinations of what it sent, in order)."""
    transport = role.transport
    transport.messages.clear()
    try:
        role.receive("admin", message)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", type(e).__name__)
    return ("ok", [(m.dst, type(role.serializer.from_bytes(m.data))
                    .__name__) for m in transport.messages])


@pytest.mark.parametrize("message", [
    Reconfigure(members=("a", "b", "c")),
    EpochCommit(epoch=1, start_slot=0, f=1, round=0, members=("a",)),
    EpochAck(epoch=1, round=0),
    EpochPhase2aRun(epoch=1, start_slot=0, round=0, values=()),
])
def test_reconfiguration_messages_are_handled_as_the_reference(message):
    """The leader, a proxy leader and an acceptor each do with a
    reconfiguration message what the JAX package's do: the same raise
    (a message a role never receives is fatal in both) or the same
    sends, and at least one of the three handles it."""
    from frankenpaxos_tpu import reconfig as jreconfig

    jmessage = getattr(jreconfig, type(message).__name__)(
        **message.__dict__)
    sims = [make_multipaxos(f=1), jh.make_multipaxos(f=1)]
    outcomes = []
    for sim, msg in zip(sims, (message, jmessage)):
        sim.transport.deliver_all()
        outcomes.append([
            _outcome(role, msg) for role in (
                sim.leaders[0], sim.proxy_leaders[0], sim.acceptors[0])])
    assert outcomes[0] == outcomes[1]
    assert any(o[0] == "ok" for o in outcomes[0])


def test_read_batcher_paths_run():
    """The read batchers' messages reach their roles: an acceptor
    answers a BatchMaxSlotRequest with its max voted slot, a replica
    answers a ReadRequestBatch, and a client of a deployment with read
    batchers sends its linearizable read to one of them. Writes through
    ingest batchers go to one of those."""
    sim = make_multipaxos(f=1, num_read_batchers=2)
    acceptor = sim.acceptors[0]
    sim.transport.messages.clear()
    acceptor.receive("read-batcher-1", tm.BatchMaxSlotRequest(1, 7))
    reply = SER_WIRE.from_bytes(sim.transport.messages[-1].data)
    assert reply == tm.BatchMaxSlotReply(
        read_batcher_index=1, read_batcher_id=7,
        group_index=acceptor.group_index, acceptor_index=acceptor.index,
        slot=acceptor.max_voted_slot)
    replica = sim.replicas[0]
    command = tm.Command(tm.CommandId(sim.clients[0].address, 0, 0), b"r")
    sim.transport.messages.clear()
    replica.receive("read-batcher-0", tm.ReadRequestBatch(-1, (command,)))
    assert sim.transport.messages
    sim.clients[0].read(1, b"r")
    assert sim.transport.messages[-1].dst in \
        sim.config.read_batcher_addresses
    sim = make_multipaxos(f=1, num_ingest_batchers=2)
    sim.clients[0].write(1, b"w")
    assert sim.transport.messages[-1].dst in sim.config.ingest_batcher_addresses


# --- the cluster bench --------------------------------------------------------


def test_cluster_bench_runs_and_gates_on_cpu():
    result = multipaxos_sim.run("cpu", writes=1024, burst=1024,
                                pipelined_writes=1024, wave=512)
    arms = result["arms"]
    assert result["device"] == "cpu" and result["nvidia_smi"] is None
    for arm in ("steady", "failover", "pipelined"):
        assert arms[arm]["writes"] == 1024
        assert arms[arm]["writes_per_sec"] > 0
        assert 0 <= arms[arm]["per_slot_share"] <= 1
    recovery = arms["failover"]["recovery"]
    assert recovery["shape"] == [1024, 3]
    assert recovery["window"] == [0, 1023]
    assert recovery["k8_device_ms"] is None
    for arm in ("steady", "failover"):
        assert sum(arms[arm]["drain_widths"].values()) > 0
    straggler = arms["pipelined"]["straggler"]
    assert straggler["held_messages"] > 0
    assert straggler["recovery"]["window"] == [512, 1023]
    # CPU tensors run the plain versions: no kernel launched.
    assert not any(result["launches"].values())


def test_cluster_bench_straggler_takes_the_scatter_path(monkeypatch):
    """The pipelined arm's held-back votes meet the new round's in one
    ProxyLeader drain, so real votes (not the prewarm's round -1) reach
    the scatter path, K4's caller."""
    from frankenpaxos_tpu_torch.ops.quorum import TpuQuorumChecker

    original = TpuQuorumChecker.record_and_check_async
    lanes = []

    def spy(self, slots, node_cols, rounds=None, *args, **kwargs):
        lanes.extend(int(r) for r in rounds)
        return original(self, slots, node_cols, rounds, *args, **kwargs)

    monkeypatch.setattr(TpuQuorumChecker, "record_and_check_async", spy)
    multipaxos_sim.pipelined(torch.device("cpu"), 1024, 512)
    assert any(r >= 0 for r in lanes)


def test_cluster_bench_gates_catch_a_wrong_reply(monkeypatch):
    """A replica that answers with a wrong index fails the bench."""
    original = Replica._execute_command

    def off_by_one(self, slot, command, replies):
        original(self, slot, command, replies)
        if replies and replies[-1].slot == 3:
            reply = replies.pop()
            replies.append(tm.ClientReply(reply.command_id, reply.slot,
                                          b"99"))

    monkeypatch.setattr(Replica, "_execute_command", off_by_one)
    with pytest.raises(multipaxos_sim.GateFailure, match="replies"):
        multipaxos_sim.steady(torch.device("cpu"), 128, 128)
