"""The port's WAL and actor-side reconfiguration for MultiPaxos against
the JAX package's.

(a) The cases of ``tests/protocols/test_multipaxos_wal.py`` (the
crash-restart integration cases and the ``MultiPaxosWalSimulated``
property) and the MultiPaxos half of
``tests/protocols/test_protocol_reconfig.py`` (the three scenarios and
``MultiPaxosReconfigSimulated``), repeated against the port's harness
and ``Simulator`` at the reference's own sizes, on ``quorum_backend``
``"dict"`` and on ``"cuda"`` with ``device="cpu"`` (the plain versions
of K6 and K7 behind the epoch tracker, of K1 and K8 before it).
(b) Cross-package: the same seed and reconfiguration scenario through
both harnesses give equal replica logs, epoch maps and WAL bytes, on
each backend pair; ``tests/test_reconfig.py``'s extended-page codec and
WalEpoch cases repeated against the port, and the frames equal the JAX
package's.
(c) The reconfiguration bench (``bench/reconfig_sim.py``) end to end on
the CPU, with the epoch board reached through the K7 reshape and K6
drains in every arm.

Every comparison is exact (logs, epoch maps, bytes); nothing here has a
tolerance.
"""

from __future__ import annotations

import os
import random
import types
from typing import Optional

from frankenpaxos_tpu_torch.bench import reconfig_sim
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols.multipaxos import (
    ProxyLeader,
    ProxyLeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
    add_replacement_acceptor,
    crash_restart_acceptor,
    crash_restart_replica,
    executed_prefix,
    make_multipaxos,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    NOOP,
    Phase2aRun,
)
from frankenpaxos_tpu_torch.reconfig import (
    decode_epoch_config,
    encode_epoch_config,
    EpochAck,
    EpochCommit,
    EpochPhase2aRun,
    EpochStore,
    Reconfigure,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, SimTransport
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
from frankenpaxos_tpu_torch.wal import MemStorage, Wal, WalEpoch
import pytest
import torch

from frankenpaxos_tpu import reconfig as jreconfig
from frankenpaxos_tpu.runtime.serializer import (
    DEFAULT_SERIALIZER as JSERIALIZER,
)
from tests.protocols import multipaxos_harness as jh

#: The port's backends: the dict oracle, and the device-backed options
#: on the plain versions.
BACKENDS = {
    "dict": {},
    "cuda": dict(quorum_backend="cuda", phase1_backend="cuda",
                 device="cpu"),
}
#: The JAX harness's counterpart of each port backend.
JAX_BACKENDS = {
    "dict": {},
    "cuda": dict(quorum_backend="tpu", phase1_backend="tpu"),
}


@pytest.fixture(params=sorted(BACKENDS))
def backend(request):
    return BACKENDS[request.param]


def drive(sim, lo, hi, got):
    for p in range(lo, hi):
        sim.clients[0].write(p % 4, b"v%d" % p, got.append)
        sim.transport.deliver_all()


# --- (a) tests/protocols/test_multipaxos_wal.py ------------------------------


class TestCrashRestartIntegration:
    def test_wal_pipeline_matches_no_wal(self, backend):
        logs = {}
        for wal in (False, True):
            sim = make_multipaxos(f=1, wal=wal, **backend)
            got = []
            drive(sim, 0, 20, got)
            assert got == [b"%d" % i for i in range(20)]
            logs[wal] = executed_prefix(sim.replicas[0])
            assert executed_prefix(sim.replicas[1]) == logs[wal]
        assert logs[False] == logs[True]

    def test_acceptor_crash_restart_preserves_votes_across_failover(
            self, backend):
        sim = make_multipaxos(f=1, wal=True, coalesced=True, **backend)
        got = []
        for p in range(16):
            sim.clients[0].write(p, b"w%d" % p, got.append)
        sim.clients[0].flush_writes()
        sim.transport.deliver_all_coalesced()
        assert len(got) == 16
        before = executed_prefix(sim.replicas[0])

        for i in range(3):  # kill -9 EVERY acceptor, then restart
            crash_restart_acceptor(sim, i)
        for i, acceptor in enumerate(sim.acceptors):
            assert acceptor.max_voted_slot >= 0, i  # recovered votes
        sim.leaders[1].leader_change(is_new_leader=True)
        sim.leaders[0].leader_change(is_new_leader=False)
        sim.transport.deliver_all_coalesced()
        after = executed_prefix(sim.replicas[0])
        assert after[:len(before)] == before

        for p in range(16, 24):
            sim.clients[0].write(p, b"w%d" % p, got.append)
        sim.clients[0].flush_writes()
        sim.transport.deliver_all_coalesced()
        for t in list(sim.transport.running_timers()):
            if t.name.startswith("resendWrite"):
                t.run()
        sim.transport.deliver_all_coalesced()
        assert len(got) == 24

    def test_unsynced_vote_is_never_acked_and_never_recovered(
            self, backend):
        sim = make_multipaxos(f=1, wal=True, **backend)
        acceptor = sim.acceptors[0]
        sim.transport.messages.clear()
        acceptor.receive("proxy-leader-0", Phase2aRun(
            start_slot=0, round=0, values=(NOOP, NOOP)))
        assert acceptor.max_voted_slot == 1  # voted in memory...
        assert sim.transport.messages == []  # ...but nothing acked
        crash_restart_acceptor(sim, 0)
        assert sim.acceptors[0].max_voted_slot == -1  # vote died

        acceptor = sim.acceptors[0]
        acceptor.receive("proxy-leader-0", Phase2aRun(
            start_slot=0, round=0, values=(NOOP, NOOP)))
        acceptor.on_drain()
        assert len(sim.transport.messages) == 1  # the Phase2bRange
        crash_restart_acceptor(sim, 0)
        assert sim.acceptors[0].max_voted_slot == 1

    def test_replica_crash_restart_recovers_sm_and_client_table(
            self, backend):
        sim = make_multipaxos(f=1, wal=True, **backend)
        got = []
        drive(sim, 0, 12, got)
        sm_before = sim.replicas[0].state_machine.get()
        assert len(sm_before) == 12

        crash_restart_replica(sim, 0)
        replica = sim.replicas[0]
        assert replica.state_machine.get() == sm_before
        assert replica.executed_watermark == \
            sim.replicas[1].executed_watermark
        drive(sim, 12, 16, got)
        assert len(got) == 16
        executed = sim.replicas[0].state_machine.get()
        assert executed == sim.replicas[1].state_machine.get()
        for p in range(16):
            assert executed.count(b"v%d" % p) == 1

    def test_replica_compaction_snapshot_then_crash(self, backend):
        sim = make_multipaxos(f=1, wal=True, **backend)
        got = []
        for p in range(80):
            sim.clients[0].write(p % 4, b"big-%03d-" % p + b"x" * 120,
                                 got.append)
            sim.transport.deliver_all()
        assert len(got) == 80
        replica = sim.replicas[0]
        assert replica.wal.metrics.compactions >= 1
        assert replica.log.watermark > 0  # watermark GC reached disk

        sm_before = replica.state_machine.get()
        crash_restart_replica(sim, 0)
        assert sim.replicas[0].state_machine.get() == sm_before
        assert sim.replicas[0].wal.metrics.recovered_records >= 1

        assert any(a.wal.metrics.compactions >= 1 for a in sim.acceptors)
        crash_restart_acceptor(sim, 0)
        assert sim.acceptors[0].max_voted_slot >= 0

    def test_crash_during_leader_change_phase1(self, backend):
        sim = make_multipaxos(f=1, wal=True, **backend)
        got = []
        drive(sim, 0, 4, got)
        sim.leaders[1].leader_change(is_new_leader=True)
        sim.transport.deliver_all()  # Phase1a/1b exchange completes
        rounds = [a.round for a in sim.acceptors]
        crash_restart_acceptor(sim, 0)
        assert sim.acceptors[0].round == rounds[0]  # promise survived


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
    def __init__(self, client):
        self.client = client

    def __repr__(self):
        return f"Flush({self.client})"


class CrashCmd:
    def __init__(self, kind, index):
        self.kind = kind
        self.index = index

    def __repr__(self):
        return f"Crash({self.kind}, {self.index})"


class PartitionCmd:
    def __init__(self, address, heal):
        self.address = address
        self.heal = heal

    def __repr__(self):
        return f"{'Heal' if self.heal else 'Partition'}({self.address})"


class LeaderChangeCmd:
    def __init__(self, index):
        self.index = index

    def __repr__(self):
        return f"LeaderChange({self.index})"


class SettleCmd:
    def __repr__(self):
        return "Settle()"


class MultiPaxosWalSimulated(SimulatedSystem):
    """The reference's WAL chaos system: random writes, flushes,
    deliveries and timers interleaved with crash_restart of acceptors
    and replicas, partitions and forced leader changes, under the same
    oracle (prefix-compatible SM sequences, exactly-once execution,
    one chosen value per slot)."""

    def __init__(self, **harness_kwargs):
        self.harness_kwargs = harness_kwargs

    def new_system(self, seed):
        sim = make_multipaxos(seed=seed, num_clients=2, wal=True,
                              **self.harness_kwargs)
        sim._counter = 0
        sim._crash_epochs = {"acceptor": [0] * len(sim.acceptors),
                             "replica": [0] * len(sim.replicas)}
        return sim

    def generate_command(self, sim, rng: random.Random):
        choices = []
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
            choices.extend(["transport"] * 6)
        if rng.random() < 0.25:
            choices.append("crash")
        if rng.random() < 0.2:
            choices.append("partition")
        if rng.random() < 0.1:
            choices.append("leader_change")
        if rng.random() < 0.08:
            choices.append("settle")
        kind = rng.choice(choices)
        if kind == "write":
            client, pseudonym = rng.choice(idle)
            sim._counter += 1
            return WriteCmd(client, pseudonym, b"w%d" % sim._counter)
        if kind == "flush":
            return FlushCmd(rng.choice(staged))
        if kind == "crash":
            role = rng.choice(["acceptor", "replica"])
            n = len(sim.acceptors if role == "acceptor"
                    else sim.replicas)
            return CrashCmd(role, rng.randrange(n))
        if kind == "partition":
            candidates = ([a.address for a in sim.acceptors]
                          + [r.address for r in sim.replicas]
                          + list(sim.config.proxy_leader_addresses))
            partitioned = [a for a in candidates
                           if a in sim.transport.partitioned]
            if partitioned and rng.random() < 0.6:
                return PartitionCmd(rng.choice(partitioned), heal=True)
            return PartitionCmd(rng.choice(candidates), heal=False)
        if kind == "leader_change":
            return LeaderChangeCmd(rng.randrange(len(sim.leaders)))
        if kind == "settle":
            return SettleCmd()
        return TransportCmd(transport_cmd)

    def run_command(self, sim, command):
        if isinstance(command, WriteCmd):
            client = sim.clients[command.client]
            if command.pseudonym not in client.states:
                client.write(command.pseudonym, command.payload)
        elif isinstance(command, FlushCmd):
            sim.clients[command.client].flush_writes()
        elif isinstance(command, CrashCmd):
            if command.kind == "acceptor":
                crash_restart_acceptor(sim, command.index)
            else:
                crash_restart_replica(sim, command.index)
            sim._crash_epochs[command.kind][command.index] += 1
        elif isinstance(command, PartitionCmd):
            if command.heal:
                sim.transport.heal(command.address)
            else:
                sim.transport.partition(command.address)
        elif isinstance(command, LeaderChangeCmd):
            for i, leader in enumerate(sim.leaders):
                leader.leader_change(is_new_leader=(i == command.index))
        elif isinstance(command, SettleCmd):
            sim.transport.deliver_all_coalesced(max_steps=400)
        else:
            sim.transport.run_command(command.command)
        return sim

    def get_state(self, sim):
        return tuple(
            (sim._crash_epochs["replica"][i],
             tuple(r.state_machine.get()))
            for i, r in enumerate(sim.replicas))

    def state_invariant(self, sim) -> Optional[str]:
        seqs = [r.state_machine.get() for r in sim.replicas]
        for i in range(len(seqs)):
            for j in range(i + 1, len(seqs)):
                n = min(len(seqs[i]), len(seqs[j]))
                if seqs[i][:n] != seqs[j][:n]:
                    return (f"replica SM sequences diverge: {seqs[i]!r} "
                            f"vs {seqs[j]!r}")
        for i, seq in enumerate(seqs):
            if len(set(seq)) != len(seq):
                return f"replica {i} executed a payload twice: {seq!r}"
        logs: dict = {}
        for i, r in enumerate(sim.replicas):
            for slot, value in r.log.items():
                prev = logs.get(slot)
                if prev is not None and prev[1] != value:
                    return (f"slot {slot} chosen twice: replica "
                            f"{prev[0]} has {prev[1]!r}, replica {i} "
                            f"has {value!r}")
                logs[slot] = (i, value)
        return None

    def step_invariant(self, old_state, new_state) -> Optional[str]:
        for (old_epoch, old_seq), (new_epoch, new_seq) in zip(old_state,
                                                              new_state):
            if new_epoch != old_epoch:
                continue  # this replica crashed: its durable prefix
            if list(new_seq[:len(old_seq)]) != list(old_seq):
                return (f"replica SM sequence shrank/rewrote without a "
                        f"crash: {old_seq} -> {new_seq}")
        return None


@pytest.mark.parametrize("kwargs", [
    dict(f=1),
    dict(f=1, coalesced=True),
    dict(f=2, coalesced="mixed"),
], ids=["f1", "f1-coalesced", "f2-mixed"])
def test_simulation_crash_restart_no_divergence(kwargs, backend):
    simulated = MultiPaxosWalSimulated(**kwargs, **backend)
    failure = Simulator(simulated, run_length=150, num_runs=10).run(seed=0)
    assert failure is None, str(failure)


# --- (a) tests/protocols/test_protocol_reconfig.py, MultiPaxos half ---------


def _writer(sim):
    return reconfig_sim.Writer(sim)


def test_multipaxos_reconfigure_out_and_replace(backend):
    sim = make_multipaxos(f=1, num_clients=1, wal=True, **backend)
    w = _writer(sim)
    w.write(5)

    group = list(sim.config.acceptor_addresses[0])
    members = tuple(group[:2] + ["acceptor-0-replacement"])
    add_replacement_acceptor(sim, members, "acceptor-0-replacement")
    sim.transport.crash(group[2])
    sim.leaders[0].receive("admin", Reconfigure(members=members))
    w.write(20)  # enough for watermark gossip to retire epoch 0

    lead = sim.leaders[0]
    assert [c.epoch for c in lead.epochs.known()] == [0, 1]
    assert lead.epochs.current().members == members

    sim.transport.crash(group[1])
    w.write(5)

    seqs = [tuple(r.state_machine.get()) for r in sim.replicas]
    assert seqs[0] == seqs[1]
    assert len(seqs[0]) == 30 and len(set(seqs[0])) == 30
    replacement = sim.acceptors[-1]
    assert replacement._voted_runs or replacement.states, (
        "the replacement never voted")


def test_multipaxos_leader_failover_discovers_epochs(backend):
    sim = make_multipaxos(f=1, num_clients=1, wal=True, **backend)
    w = _writer(sim)
    w.write(3)
    group = list(sim.config.acceptor_addresses[0])
    members = tuple(group[:2] + ["acceptor-0-replacement"])
    add_replacement_acceptor(sim, members, "acceptor-0-replacement")
    sim.transport.crash(group[2])
    sim.leaders[0].receive("admin", Reconfigure(members=members))
    w.write(10)
    assert sim.leaders[1].epochs.known()[-1].epoch in (0, 1)

    sim.leaders[1].epochs = EpochStore.from_members(tuple(group), f=1)
    for i, leader in enumerate(sim.leaders):
        leader.leader_change(is_new_leader=(i == 1))
    w.write(5)
    assert [c.epoch for c in sim.leaders[1].epochs.known()] == [0, 1]
    seqs = [tuple(r.state_machine.get()) for r in sim.replicas]
    assert seqs[0] == seqs[1] and len(seqs[0]) == 18


def test_multipaxos_acceptor_crash_restart_recovers_epoch_map(backend):
    sim = make_multipaxos(f=1, num_clients=1, wal=True, **backend)
    w = _writer(sim)
    w.write(3)
    group = list(sim.config.acceptor_addresses[0])
    members = tuple(group[:2] + ["acceptor-0-replacement"])
    add_replacement_acceptor(sim, members, "acceptor-0-replacement")
    sim.leaders[0].receive("admin", Reconfigure(members=members))
    w.write(5)
    assert sim.acceptors[0]._epoch_commits, "no epoch WAL'd yet"
    before = dict(sim.acceptors[0]._epoch_commits)
    crash_restart_acceptor(sim, 0)
    assert sim.acceptors[0]._epoch_commits == before
    w.write(3)
    seqs = [tuple(r.state_machine.get()) for r in sim.replicas]
    assert seqs[0] == seqs[1] and len(seqs[0]) == 11


class ReconfigureCmd:
    def __init__(self, members: tuple, new_address):
        self.members = members
        self.new_address = new_address

    def __repr__(self):
        return f"Reconfigure(+{self.new_address})"


class MultiPaxosReconfigSimulated(MultiPaxosWalSimulated):
    """The WAL chaos system extended with live reconfigurations, each
    swapping one current member for a fresh replacement mid-traffic,
    under the same oracle."""

    def new_system(self, seed):
        sim = super().new_system(seed)
        sim._replacements = 0
        return sim

    def _active_leader(self, sim):
        for leader in sim.leaders:
            if type(leader.state).__name__ == "_Phase2" \
                    and leader.epochs is not None:
                return leader
        return None

    def generate_command(self, sim, rng: random.Random):
        if rng.random() < 0.07 and sim._replacements < 4:
            leader = self._active_leader(sim)
            if leader is not None and leader._epoch_change is None:
                members = list(leader.epochs.current().members)
                new_address = f"acceptor-0-r{sim._replacements}"
                members[rng.randrange(len(members))] = new_address
                return ReconfigureCmd(tuple(members), new_address)
        return super().generate_command(sim, rng)

    def run_command(self, sim, command):
        if getattr(command, "kind", None) == "acceptor":
            command.index = command.index % len(sim.acceptors)
        if isinstance(command, ReconfigureCmd):
            known = {a.address for a in sim.acceptors}
            if command.new_address not in known:
                add_replacement_acceptor(sim, command.members,
                                         command.new_address)
                sim._crash_epochs["acceptor"].append(0)
                sim._replacements += 1
            for leader in sim.leaders:
                leader.receive("chaos-admin",
                               Reconfigure(members=command.members))
            return sim
        return super().run_command(sim, command)


@pytest.mark.parametrize("kwargs", [dict(f=1),
                                    dict(f=1, coalesced=True)],
                         ids=["f1", "f1-coalesced"])
def test_simulation_reconfig_chaos_no_divergence(kwargs, backend):
    simulated = MultiPaxosReconfigSimulated(**kwargs, **backend)
    failure = Simulator(simulated, run_length=150, num_runs=10).run(seed=0)
    assert failure is None, str(failure)


# --- (b) cross-package -------------------------------------------------------


def _jax_package() -> types.SimpleNamespace:
    return types.SimpleNamespace(
        make_multipaxos=jh.make_multipaxos,
        add_replacement_acceptor=jh.add_replacement_acceptor,
        executed_prefix=jh.executed_prefix,
        Reconfigure=jreconfig.Reconfigure, EpochStore=jreconfig.EpochStore)


def _wal_bytes(sim) -> dict:
    return {address: {name: storage.read(name)
                      for name in storage.segments()}
            for address, storage in sim.wal_storages.items()}


@pytest.mark.parametrize("arm", ["dict", "sync", "epoch_quorums",
                                 "pipelined"])
def test_reconfiguration_scenario_matches_the_reference(arm):
    """The reconfiguration bench's scenario (replace, reconfigure, crash
    a second original, fail over with epoch discovery) through both
    harnesses on MemStorage WALs: equal replica logs, equal epoch maps
    on every leader and acceptor, and byte-equal WAL segments on every
    durable role. The pipelined arm runs ``tpu_pipelined=True`` on both
    harnesses."""
    port = dict(BACKENDS["dict" if arm == "dict" else "cuda"])
    ref = dict(JAX_BACKENDS["dict" if arm == "dict" else "cuda"])
    if arm == "epoch_quorums":
        for kwargs in (port, ref):
            kwargs.update(epoch_quorums=True, epoch_tag_runs=True)
    if arm == "pipelined":
        for kwargs in (port, ref):
            kwargs.update(tpu_pipelined=True)
    got = reconfig_sim.scenario(wal=True, **port)
    want = reconfig_sim.scenario(_jax_package(), wal=True, **ref)
    reconfig_sim.check(got)
    reconfig_sim.check(want)
    assert got["logs"] == want["logs"]
    assert got["results"] == want["results"]
    assert got["epochs"] == want["epochs"]
    for a, b in zip(got["sim"].acceptors, want["sim"].acceptors):
        assert a.address == b.address
        assert [(c.epoch, c.start_slot, c.f, c.round, tuple(c.members))
                for c in a._epoch_commits.values()] == \
            [(c.epoch, c.start_slot, c.f, c.round, tuple(c.members))
             for c in b._epoch_commits.values()]
    wal, jwal = _wal_bytes(got["sim"]), _wal_bytes(want["sim"])
    assert sorted(wal) == sorted(jwal) and len(wal) == 6
    assert wal == jwal


def test_extended_page_codecs_round_trip():
    for message in (
            Reconfigure(members=("x", ("10.0.0.7", 80), "z")),
            EpochCommit(epoch=3, start_slot=999, f=2, round=7,
                        members=tuple(f"m{i}" for i in range(5))),
            EpochAck(epoch=3, round=7)):
        data = DEFAULT_SERIALIZER.to_bytes(message)
        assert data[0] == 0  # the extended page escape
        assert DEFAULT_SERIALIZER.from_bytes(data) == message


def test_epoch_phase2a_run_codec_round_trip():
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        Command,
        CommandBatch,
        CommandId,
    )

    batch = CommandBatch((Command(CommandId(("h", 1), 0, 4), b"p"),))
    run = EpochPhase2aRun(epoch=2, start_slot=17, round=1,
                          values=(batch, NOOP))
    got = DEFAULT_SERIALIZER.from_bytes(DEFAULT_SERIALIZER.to_bytes(run))
    assert (got.epoch, got.start_slot, got.round) == (2, 17, 1)
    assert tuple(got.values) == (batch, NOOP)


def test_wal_epoch_record_survives_recovery():
    storage = MemStorage()
    wal = Wal(storage)
    payload = encode_epoch_config(1, 64, 1, 3,
                                  ("a0", ("10.0.0.2", 9001), "a3"))
    wal.append(WalEpoch(payload=payload))
    wal.sync()
    recovered = Wal(storage).recover()
    assert recovered == [WalEpoch(payload=payload)]
    assert decode_epoch_config(recovered[0].payload) == (
        1, 64, 1, 3, ("a0", ("10.0.0.2", 9001), "a3"))


@pytest.mark.parametrize("name", ["Reconfigure", "EpochCommit", "EpochAck",
                                  "EpochPhase2aRun"])
def test_reconfiguration_frames_equal_the_references(name):
    """Each reconfiguration message encodes to the JAX package's frame,
    and each package decodes the other's; the epoch config payload (the
    WalEpoch body) is the reference's too."""
    from frankenpaxos_tpu.protocols.multipaxos import messages as jm
    from frankenpaxos_tpu_torch.protocols.multipaxos import messages as tm

    def build(rc, mp):
        batch = mp.CommandBatch((mp.Command(
            mp.CommandId(("10.0.0.1", 9000), 2, 7), b"payload"),))
        return {
            "Reconfigure": rc.Reconfigure(members=("x", ("h", 80), "z")),
            "EpochCommit": rc.EpochCommit(epoch=1, start_slot=5, f=1,
                                          round=2,
                                          members=("a", "b", "c")),
            "EpochAck": rc.EpochAck(epoch=1, round=2),
            "EpochPhase2aRun": rc.EpochPhase2aRun(
                epoch=1, start_slot=5, round=2, values=(batch, mp.NOOP)),
        }[name]

    message, jmessage = build(
        types.SimpleNamespace(Reconfigure=Reconfigure,
                              EpochCommit=EpochCommit, EpochAck=EpochAck,
                              EpochPhase2aRun=EpochPhase2aRun), tm), \
        build(jreconfig, jm)
    data, jdata = DEFAULT_SERIALIZER.to_bytes(message), \
        JSERIALIZER.to_bytes(jmessage)
    assert data == jdata
    got = DEFAULT_SERIALIZER.from_bytes(jdata)
    assert type(got) is type(message)
    if name == "EpochPhase2aRun":
        assert tuple(got.values) == tuple(message.values)
    else:
        assert got == message
    assert encode_epoch_config(1, 5, 1, 2, ("a", ("h", 80))) == \
        jreconfig.encode_epoch_config(1, 5, 1, 2, ("a", ("h", 80)))


# --- the epoch tracker's backend and device ----------------------------------


def test_epoch_backend_cuda_without_a_gpu_raises(monkeypatch):
    """``epoch_backend="cuda"`` (or ``""`` after a cuda main tracker)
    with no GPU and no device named raises at construction; nothing
    falls back to the dict tracker. ``device="cpu"`` builds, and the
    epoch tracker then runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = make_multipaxos(f=1)
    log = FakeLogger()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProxyLeader("proxy-leader-0", SimTransport(log), log, sim.config,
                    ProxyLeaderOptions(epoch_backend="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multipaxos(f=1, quorum_backend="cuda", epoch_quorums=True)
    proxy = ProxyLeader("proxy-leader-0", SimTransport(log), log,
                        sim.config, ProxyLeaderOptions(
                            epoch_backend="cuda", epoch_quorums=True),
                        device="cpu")
    tracker = proxy._epoch_tracker
    assert tracker.backend == "cuda"
    assert tracker._checker.device == torch.device("cpu")
    assert tracker._checker.window == 1 << 14


# --- (c) the reconfiguration bench on the CPU --------------------------------


def test_reconfiguration_bench_reaches_k6_and_k7_on_cpu(monkeypatch):
    """Every arm of ``reconfig_sim.run`` passes its gates on the CPU, and
    in each the ProxyLeaders' epoch board takes epoch 1 through the
    reshape (K7's caller) and counts votes in staged drains (K6's)."""
    calls = {"reshape": 0, "runs": 0}
    reshape, run = tq._reshape_board, \
        tq.EpochSegmentedChecker.record_and_check_run

    def spy_reshape(*args, **kwargs):
        calls["reshape"] += 1
        return reshape(*args, **kwargs)

    def spy_run(self, *args, **kwargs):
        calls["runs"] += 1
        return run(self, *args, **kwargs)

    monkeypatch.setattr(tq, "_reshape_board", spy_reshape)
    monkeypatch.setattr(tq.EpochSegmentedChecker, "record_and_check_run",
                        spy_run)
    per_arm = {}
    original = reconfig_sim.scenario

    def counted(*args, **kwargs):
        before = dict(calls)
        out = original(*args, **kwargs)
        per_arm[len(per_arm)] = {k: calls[k] - before[k] for k in calls}
        return out

    monkeypatch.setattr(reconfig_sim, "scenario", counted)
    result = reconfig_sim.run("cpu", tpu_window=1 << 12)
    assert result["nvidia_smi"] is None and result["writes"] == 35
    assert list(result["arms"]) == ["dict", *reconfig_sim.ARMS]
    assert per_arm[0] == {"reshape": 0, "runs": 0}  # the dict run
    for i, arm in enumerate(reconfig_sim.ARMS, start=1):
        assert per_arm[i]["reshape"] >= 1, arm
        assert per_arm[i]["runs"] >= 1, arm
        figures = result["arms"][arm]
        assert figures["epoch_tracker_drains"] == per_arm[i]["runs"]
        assert figures["fsyncs"] > 0 and figures["fsync_ms_per_sync"] > 0
        # CPU tensors run the plain versions: no kernel launched.
        assert not any(figures["launches"].values())


# --- the WAL over the deployed transport -------------------------------------


def test_supernode_wal_one_group_commit_per_pass(tmp_path, monkeypatch):
    """MultiPaxos over loopback TCP with FileStorage WALs under
    ``tmp_path``: every write answered once, and each durable role's
    fsyncs come only from its ``on_drain`` (once per event-loop pass),
    never more than one a pass. A fresh Wal over each role's directory
    recovers what the role logged."""
    from frankenpaxos_tpu_torch.protocols.multipaxos import (
        Acceptor,
        Replica,
        supernode,
    )
    from frankenpaxos_tpu_torch.wal import FileStorage, WalChosenRun

    drains: dict = {}
    syncs_outside: list = []
    in_drain: set = set()
    for cls in (Acceptor, Replica):
        original = cls.on_drain

        def counted(self, original=original):
            drains[self.address] = drains.get(self.address, 0) + 1
            in_drain.add(self.address)
            try:
                original(self)
            finally:
                in_drain.discard(self.address)

        monkeypatch.setattr(cls, "on_drain", counted)
    original_sync = FileStorage.sync

    def sync(self, name):
        if not in_drain:
            syncs_outside.append(self.root)
        original_sync(self, name)

    monkeypatch.setattr(FileStorage, "sync", sync)
    with supernode.Supernode(quorum_backend="cuda", device="cpu",
                             wal_dir=str(tmp_path)) as node:
        figures = node.write_closed_loop(256, 16)
        assert node.wait_executed(256)
        roles = supernode.on_loop(node.transport, lambda: [
            (r.address, r.wal.metrics.syncs, r.wal.storage.root)
            for r in node.acceptors + node.replicas])
    assert len(figures["replies"]) == 256
    assert not syncs_outside
    for address, syncs, root in roles:
        assert 0 < syncs <= drains[address], address
        assert os.path.dirname(root) == str(tmp_path)
    assert sorted(os.listdir(tmp_path)) == [
        "acceptor_0", "acceptor_1", "acceptor_2", "replica_0", "replica_1"]
    records = Wal(FileStorage(str(tmp_path / "replica_0"))).recover()
    assert any(isinstance(r, WalChosenRun) for r in records)
