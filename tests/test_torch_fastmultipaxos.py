"""The port's Fast MultiPaxos (``protocols/fastmultipaxos.py``, with raft
election, heartbeats and thrifty Phase1as) against the JAX package's.

(a) The seven tests of ``tests/protocols/test_fastmultipaxos.py`` on the
port, each with the host quorum backend and with ``"cuda"`` at
``device="cpu"`` (K6's plain version): the fast path, sequential fast
commands, conflicting fast proposals that recover through a classic
round, the standby leader learning choices, thrifty classic Phase2as to
exactly a classic quorum, wait/stagger buffering, and the property
``Simulator`` under round churn (per-slot agreement of the leaders'
logs).
(b) Cross-package: the JAX cluster and the port's from the same seed
through the same drive (the reference test's pump, closed-loop clients,
and random interleavings from equally seeded ``random.Random``s) end with
equal leader logs, client replies, chosen watermarks and rounds.
(c) ``bench/fast_sim.py`` at a small size on the CPU: its gates pass, and
its cuda run's logs and replies equal its host run's.
"""

from __future__ import annotations

import random
from typing import Optional

from frankenpaxos_tpu_torch.bench import fast_sim
from frankenpaxos_tpu_torch.election.raft import RaftElectionOptions
from frankenpaxos_tpu_torch.heartbeat import HeartbeatOptions
from frankenpaxos_tpu_torch.protocols import fastmultipaxos as pfmp
from frankenpaxos_tpu_torch.protocols.fast_harness import (
    make_fastmultipaxos,
    pump,
)
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin, RoundZeroFast
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
from frankenpaxos_tpu_torch.statemachine import AppendLog
from frankenpaxos_tpu_torch.thrifty import RandomThrifty
import pytest

from tests.protocols import test_fastmultipaxos as jt

BACKENDS = [("host", None), ("cuda", "cpu")]


def make_fmp(f=1, num_clients=2, seed=0, backend="host", device=None):
    return make_fastmultipaxos(f=f, num_clients=num_clients, seed=seed,
                               quorum_backend=backend, device=device)


# --- (a) the reference's seven tests --------------------------------------------


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_fast_path_single_client(backend, device):
    transport, _, leaders, acceptors, clients = make_fmp(
        backend=backend, device=device)
    transport.deliver_all()
    got = []
    clients[0].propose(b"fast!", got.append)
    transport.deliver_all()
    assert got == [b"0"]
    assert leaders[0].log
    assert leaders[0].state_machine.get() == [b"fast!"]


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_sequential_fast_commands(backend, device):
    transport, _, leaders, _, clients = make_fmp(backend=backend,
                                                 device=device)
    transport.deliver_all()
    got = []
    for i in range(5):
        clients[0].propose(b"c%d" % i, got.append)
        transport.deliver_all()
        assert pump(transport, lambda: len(got) == i + 1)
    assert leaders[0].state_machine.get() == [b"c%d" % i for i in range(5)]


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_conflicting_fast_proposals_recover(backend, device):
    transport, _, leaders, _, clients = make_fmp(
        num_clients=3, backend=backend, device=device)
    transport.deliver_all()
    got = []
    for i, client in enumerate(clients):
        client.propose(b"x%d" % i, got.append)
    transport.deliver_all()
    assert pump(transport, lambda: len(got) == 3, rounds=25)
    log = leaders[0].state_machine.get()
    assert {b"x0", b"x1", b"x2"} <= set(log)


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_standby_leader_learns_choices(backend, device):
    transport, _, leaders, _, clients = make_fmp(backend=backend,
                                                 device=device)
    transport.deliver_all()
    got = []
    clients[0].propose(b"shared", got.append)
    transport.deliver_all()
    assert got
    assert any(slot in leaders[1].log for slot in leaders[0].log)


def _config(round_system, n=3):
    return pfmp.FastMultiPaxosConfig(
        f=1,
        leader_addresses=("leader-0", "leader-1"),
        leader_election_addresses=("election-0", "election-1"),
        leader_heartbeat_addresses=("lhb-0", "lhb-1"),
        acceptor_addresses=tuple(f"acceptor-{i}" for i in range(n)),
        acceptor_heartbeat_addresses=tuple(f"ahb-{i}" for i in range(n)),
        round_system=round_system)


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_thrifty_classic_phase2as_hit_quorum_size_acceptors(backend,
                                                            device):
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = _config(ClassicRoundRobin(2))
    leaders = [pfmp.FastMultiPaxosLeader(
                   a, transport, logger, config, AppendLog(),
                   options=pfmp.FastMultiPaxosLeaderOptions(
                       thrifty_system=RandomThrifty(),
                       quorum_backend=backend, device=device),
                   seed=i)
               for i, a in enumerate(config.leader_addresses)]
    acceptors = [pfmp.FastMultiPaxosAcceptor(a, transport, logger, config)
                 for a in config.acceptor_addresses]
    client = pfmp.FastMultiPaxosClient("client-0", transport, logger,
                                       config, seed=50)
    transport.deliver_all()
    got = []
    client.propose(b"thrifty", got.append)
    while transport.messages:
        message = transport.messages[0]
        if message.dst.startswith("acceptor-"):
            break
        transport.deliver_message(message)
    targets = set()
    for message in transport.messages:
        if message.dst.startswith("acceptor-"):
            payload = acceptors[0].serializer.from_bytes(message.data)
            if isinstance(payload, pfmp.Phase2a) \
                    and payload.value != pfmp.NOOP \
                    and not payload.any and not payload.any_suffix:
                targets.add(message.dst)
    assert len(targets) == config.classic_quorum_size, targets
    transport.deliver_all()
    assert got == [b"0"]
    assert leaders[0].log


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_wait_stagger_buffers_and_batches_proposals(backend, device):
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = _config(RoundZeroFast(2))
    now = [0.0]
    leaders = [pfmp.FastMultiPaxosLeader(
                   a, transport, logger, config, AppendLog(), seed=i,
                   options=pfmp.FastMultiPaxosLeaderOptions(
                       quorum_backend=backend, device=device))
               for i, a in enumerate(config.leader_addresses)]
    acceptors = [pfmp.FastMultiPaxosAcceptor(
                     a, transport, logger, config,
                     options=pfmp.FastMultiPaxosAcceptorOptions(
                         wait_period_s=0.01, wait_stagger_s=0.005),
                     clock=lambda: now[0])
                 for a in config.acceptor_addresses]
    clients = [pfmp.FastMultiPaxosClient(f"client-{i}", transport, logger,
                                         config, seed=50 + i)
               for i in range(2)]
    transport.deliver_all()
    got = []
    clients[0].propose(b"a", got.append)
    clients[1].propose(b"b", got.append)
    transport.deliver_all()
    assert all(a.buffered_proposals for a in acceptors)
    assert not got
    for timer in list(transport.running_timers()):
        if timer.name == "processBufferedProposeRequests":
            transport.trigger_timer(timer.id)
    assert all(a.buffered_proposals for a in acceptors)
    now[0] += 1.0
    for timer in list(transport.running_timers()):
        if timer.name == "processBufferedProposeRequests":
            transport.trigger_timer(timer.id)
    buffers = [m for m in transport.messages
               if m.dst.startswith("leader-")
               and isinstance(leaders[0].serializer.from_bytes(m.data),
                              pfmp.Phase2bBuffer)]
    assert len(buffers) == 3
    transport.deliver_all()
    assert sorted(got) == [b"0", b"1"]
    for slot in (0, 1):
        votes = {a.log[slot].vote_value for a in acceptors}
        assert len(votes) == 1, votes


class WriteCmd:
    def __init__(self, client: int, payload: bytes):
        self.client, self.payload = client, payload

    def __repr__(self):
        return f"Write({self.client}, {self.payload!r})"


class TransportCmd:
    def __init__(self, command):
        self.command = command

    def __repr__(self):
        return f"Transport({self.command!r})"


class ChurnCmd:
    def __init__(self, leader: int):
        self.leader = leader

    def __repr__(self):
        return f"Chaos(round_churn, {self.leader})"


class FastMultiPaxosSimulated(SimulatedSystem):
    """The reference's ``FastMultiPaxosSimulated`` (``PrefixAgreementSim``
    with one writer a client, per-slot agreement of the leaders' logs,
    and round churn) over the port's cluster."""

    transport_weight = 14

    def __init__(self, backend="host", device=None):
        self.backend, self.device = backend, device

    def new_system(self, seed: int) -> dict:
        transport, _, leaders, acceptors, clients = make_fmp(
            seed=seed, backend=self.backend, device=self.device)
        return dict(transport=transport, leaders=leaders,
                    acceptors=acceptors, clients=clients, counter=0)

    def generate_command(self, system: dict, rng: random.Random):
        choices: list = []
        idle = [c for c, client in enumerate(system["clients"])
                if client.pending is None]
        if idle:
            choices.append("write")
        transport_cmd = system["transport"].generate_command(rng)
        if transport_cmd is not None:
            choices.extend(["transport"] * self.transport_weight)
        if rng.random() <= 0.08:
            choices.append(ChurnCmd(rng.randrange(len(system["leaders"]))))
        if not choices:
            return None
        pick = rng.choice(choices)
        if pick == "write":
            system["counter"] += 1
            return WriteCmd(rng.choice(idle), b"w%d" % system["counter"])
        if pick == "transport":
            return TransportCmd(transport_cmd)
        return pick

    def run_command(self, system: dict, command) -> dict:
        if isinstance(command, WriteCmd):
            client = system["clients"][command.client]
            if client.pending is None:
                client.propose(command.payload)
        elif isinstance(command, TransportCmd):
            system["transport"].run_command(command.command)
        else:
            leader = system["leaders"][command.leader]
            top = max(l.round for l in system["leaders"])
            leader._bump_round_and_restart(top, thrifty=False)
        return system

    def get_state(self, system: dict):
        return None

    def step_invariant(self, old, new) -> Optional[str]:
        return None

    def state_invariant(self, system: dict) -> Optional[str]:
        per_slot: dict = {}
        for i, leader in enumerate(system["leaders"]):
            for slot, value in leader.log.items():
                if slot in per_slot and per_slot[slot][0] != value:
                    return (f"slot {slot} chosen twice: leader "
                            f"{per_slot[slot][1]} has {per_slot[slot][0]!r}, "
                            f"leader {i} has {value!r}")
                per_slot.setdefault(slot, (value, i))
        return None


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_simulation_round_churn_no_divergence(backend, device):
    failure = Simulator(FastMultiPaxosSimulated(backend, device),
                        run_length=250, num_runs=100,
                        minimize=False).run(seed=0)
    assert failure is None, str(failure)


def test_adaptive_deadlines_are_built():
    """The adaptive Raft election deadline and heartbeat deadlines run:
    a leader built with an adaptive election keeps a gap estimator, and
    an adaptive heartbeat participant one RTT estimator a peer."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = _config(RoundZeroFast(2))
    leader = pfmp.FastMultiPaxosLeader(
        "leader-0", transport, logger, config, AppendLog(),
        election_options=RaftElectionOptions(adaptive=True))
    assert leader.election._gap_estimator is not None
    from frankenpaxos_tpu_torch.heartbeat import HeartbeatParticipant
    participant = HeartbeatParticipant("hb", transport, logger, ["hb", "p"],
                                       HeartbeatOptions(adaptive=True))
    assert len(participant.rtt_estimators) == 2


# --- (b) the JAX cluster and the port's ------------------------------------------


def _norm(value):
    if not hasattr(value, "command_id"):
        return ("noop",)
    cid = value.command_id
    return (cid.client_address, cid.client_id, value.command)


def _snapshot(leaders, replies) -> dict:
    return {
        "logs": [{s: _norm(v) for s, v in sorted(l.log.items())}
                 for l in leaders],
        "watermarks": [l.chosen_watermark for l in leaders],
        "rounds": [l.round for l in leaders],
        "states": [l.state_machine.get() for l in leaders],
        "replies": replies,
    }


def _closed_loop(cluster, pump_fn, commands: int, clients: int) -> dict:
    transport, _, leaders, _, fmp_clients = cluster
    transport.deliver_all()
    issued = [0]
    replies: list = []

    def propose(c):
        if issued[0] >= commands:
            return
        payload = b"p%d" % issued[0]
        issued[0] += 1

        def on_reply(result, c=c, payload=payload):
            replies.append((c, payload, result))
            propose(c)

        fmp_clients[c].propose(payload, on_reply)

    for c in range(clients):
        propose(c)
    assert pump_fn(transport, lambda: len(replies) == commands, rounds=400)
    return _snapshot(leaders, replies)


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("f", [1, 2])
def test_closed_loop_matches_the_reference(backend, device, f):
    for seed in range(3):
        ref = _closed_loop(jt.make_fmp(f=f, num_clients=5, seed=seed),
                           jt.pump, 60, 5)
        port = _closed_loop(make_fmp(f=f, num_clients=5, seed=seed,
                                     backend=backend, device=device),
                            pump, 60, 5)
        assert port == ref, seed
        assert len(ref["replies"]) == 60


def _interleaved(cluster, seed: int, steps: int) -> dict:
    transport, _, leaders, _, clients = cluster
    rng = random.Random(seed)
    replies: list = []
    counter = 0
    for _ in range(steps):
        idle = [c for c, client in enumerate(clients)
                if client.pending is None]
        if idle and rng.random() < 0.1:
            c = rng.choice(idle)
            counter += 1
            clients[c].propose(b"w%d" % counter,
                               lambda r, c=c: replies.append((c, r)))
            continue
        if rng.random() < 0.02:
            leader = leaders[rng.randrange(len(leaders))]
            leader._bump_round_and_restart(max(l.round for l in leaders),
                                           thrifty=False)
            continue
        cmd = transport.generate_command(rng)
        if cmd is not None:
            transport.run_command(cmd)
    return _snapshot(leaders, replies)


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_interleavings_match_the_reference(backend, device):
    """Random deliveries, timer firings, writes and round churn, the same
    seed on both packages: equal logs, replies, watermarks and rounds."""
    chosen = 0
    for seed in range(12):
        ref = _interleaved(jt.make_fmp(num_clients=3, seed=seed), seed, 500)
        port = _interleaved(make_fmp(num_clients=3, seed=seed,
                                     backend=backend, device=device),
                            seed, 500)
        assert port == ref, seed
        chosen += sum(len(log) for log in ref["logs"])
    assert chosen > 0


# --- (c) the closed-loop bench ---------------------------------------------------


def test_fast_sim_small():
    result = fast_sim.run("cpu", commands=96, clients=4)
    for arm, runs in result["arms"].items():
        for backend, fig in runs.items():
            assert fig["slots"] >= 96 and fig["commands_per_sec"] > 0
            assert fig["checks"]["classic_quorum"] > 0
            assert fig["check_batch_multi_launches"] == 0  # plain version
            assert fig["check_host_us_p50"] > 0


def test_fast_sim_gates_fire():
    """A cuda run whose log differed from the host run's would fail."""
    with pytest.raises(fast_sim.GateFailure):
        fast_sim._require(False, "the gate")
