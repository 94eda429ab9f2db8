"""The port's Matchmaker MultiPaxos (``protocols/matchmakermultipaxos.py``:
live acceptor reconfiguration, matchmaker epochs, GC, Die; the leader's
phase-1 check of every prior configuration on K6's stateless check)
against the JAX package's.

(a) The tests of ``tests/protocols/test_matchmakermultipaxos.py`` on the
port, each with the ``"dict"`` quorum backend and with ``"cuda"`` at
``device="cpu"`` (K6's plain version): writes through a matchmade
configuration, live reconfiguration, matchmaker GC, the matchmakers' own
epoch change, the Stopped bounce, f matchmaker deaths, the churn and
reconfig-heavy property ``Simulator`` runs, and both ``MMPDriver`` chaos
schedules; and the MMP probe of ``tests/protocols/test_sim_sensitivity.py``
(a weakened write quorum must be caught).
(b) The checker: ``MultiConfigQuorumChecker.check_all`` (one word under
every plane) and ``check_batch`` against ``is_superset_of_read_quorum``
and the JAX package's checker, over the same systems and responder sets
(the JAX planes carried across by ``convert.multi_config_checker_from``),
with a pool over 32 acceptors taking ``check_batch``; the leader's cache
of checkers.
(c) Cross-package: the JAX cluster (``"dict"`` and ``"tpu"`` on JAX's CPU)
and the port's (both backends) through the same scenarios and seeded
interleavings end with equal replica logs, client replies, leader rounds,
and matchmaker configurations and GC watermarks.
(d) No fallback: ``"cuda"`` with no GPU raises, other backend names raise.
(e) ``bench/matchmaker_sim.py`` at a small size on the CPU, its gates
shown to fire.
"""

from __future__ import annotations

import ctypes
import itertools
import random
import struct
import types

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import matchmaker_sim
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols import matchmakermultipaxos as pm
from frankenpaxos_tpu_torch.protocols.matchmaker_harness import make_mmp
from frankenpaxos_tpu_torch.quorums import (
    Grid,
    SimpleMajority,
    UnanimousWrites,
)
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
import numpy as np
import pytest
import torch

from frankenpaxos_tpu import quorums as jq
from frankenpaxos_tpu.ops.quorum import (
    MultiConfigQuorumChecker as JMultiConfigQuorumChecker,
)
from frankenpaxos_tpu.protocols import matchmakermultipaxos as jm
from tests.protocols import test_matchmakermultipaxos as jt

BACKENDS = [("dict", None), ("cuda", "cpu")]
#: The port's quorum systems, by the names of the JAX package's
#: ``quorums`` module.
PORT_QS = types.SimpleNamespace(SimpleMajority=SimpleMajority, Grid=Grid,
                                UnanimousWrites=UnanimousWrites)


def make(backend, device, **kw):
    return make_mmp(quorum_backend=backend, device=device, **kw)


# --- (a) the reference's tests -------------------------------------------------


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_writes_through_matchmade_configuration(backend, device):
    transport, _, _, matchmakers, _, _, replicas, clients = make(
        backend, device)
    transport.deliver_all()
    got = []
    for i in range(3):
        clients[0].write(0, b"w%d" % i, got.append)
        transport.deliver_all()
    assert len(got) == 3
    logs = [r.state_machine.get() for r in replicas]
    assert logs[0] == logs[1] == [b"w0", b"w1", b"w2"]
    assert any(m.configurations for m in matchmakers)


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_live_reconfiguration(backend, device):
    (transport, _, leaders, _, reconfigurer, acceptors, replicas,
     clients) = make(backend, device, num_acceptors=6)
    transport.deliver_all()
    got = []
    clients[0].write(0, b"before", got.append)
    transport.deliver_all()
    assert got == [b"0"]
    reconfigurer.reconfigure(SimpleMajority([3, 4, 5]))
    transport.deliver_all()
    clients[0].write(0, b"after", got.append)
    transport.deliver_all()
    assert got == [b"0", b"1"]
    new_votes = [slot for a in acceptors[3:] for slot in a.votes]
    assert new_votes, "new acceptors never voted"
    logs = [r.state_machine.get() for r in replicas]
    assert logs[0] == logs[1] == [b"before", b"after"]


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_matchmaker_gc(backend, device):
    (transport, _, _, matchmakers, reconfigurer, _, _, clients) = make(
        backend, device)
    transport.deliver_all()
    clients[0].write(0, b"x")
    transport.deliver_all()
    reconfigurer.reconfigure(SimpleMajority([0, 1, 2]))
    transport.deliver_all()
    assert any(m.gc_watermark > 0 for m in matchmakers)
    for matchmaker in matchmakers:
        if matchmaker.configurations:
            assert min(matchmaker.configurations) >= matchmaker.gc_watermark


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_matchmaker_self_reconfiguration(backend, device):
    (transport, _, leaders, matchmakers, reconfigurer, _, replicas,
     clients) = make(backend, device, num_matchmakers=5)
    transport.deliver_all()
    got = []
    clients[0].write(0, b"before", got.append)
    transport.deliver_all()
    assert got == [b"0"]
    reconfigurer.reconfigure_matchmakers([2, 3, 4])
    transport.deliver_all()
    assert reconfigurer.state.configuration.epoch == 1
    assert reconfigurer.state.configuration.matchmaker_indices == (2, 3, 4)
    for leader in leaders:
        assert leader.matchmaker_configuration.epoch == 1
    assert matchmakers[3].configurations == matchmakers[2].configurations
    reconfigurer.reconfigure(SimpleMajority([0, 1, 2]))
    transport.deliver_all()
    clients[0].write(0, b"after", got.append)
    transport.deliver_all()
    assert got == [b"0", b"1"]
    assert any(0 in m.states and len(m.states) > 1 or 1 in m.states
               for m in matchmakers[3:])
    logs = [r.state_machine.get() for r in replicas]
    assert logs[0] == logs[1] == [b"before", b"after"]


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_stopped_epoch_bounces_leader_to_new_epoch(backend, device):
    (transport, config, leaders, _, reconfigurer, _, _, clients) = make(
        backend, device, num_matchmakers=5)
    transport.deliver_all()
    reconfigurer.reconfigure_matchmakers([1, 2, 3])
    transport.deliver_all()
    leaders[0].matchmaker_configuration = \
        pm.initial_matchmaker_configuration(config.f)
    reconfigurer.reconfigure(SimpleMajority([2, 3, 4]))
    transport.deliver_all()
    assert leaders[0].matchmaker_configuration.epoch == 1
    got = []
    clients[0].write(0, b"bounced", got.append)
    transport.deliver_all()
    assert got == [b"0"]


def test_live_reconfiguration_cuda_backend():
    """The reference's tpu-backend case: the same reconfiguration flow
    with every Phase1b checking all prior configurations through K6's
    stateless check (its plain version on the CPU)."""
    (transport, _, leaders, _, reconfigurer, _, replicas, clients) = make(
        "cuda", "cpu", num_acceptors=6)
    transport.deliver_all()
    got = []
    clients[0].write(0, b"before", got.append)
    transport.deliver_all()
    reconfigurer.reconfigure(SimpleMajority([3, 4, 5]))
    transport.deliver_all()
    clients[0].write(0, b"after", got.append)
    transport.deliver_all()
    assert got == [b"0", b"1"]
    logs = [r.state_machine.get() for r in replicas]
    assert logs[0] == logs[1] == [b"before", b"after"]
    assert len(leaders[0]._checkers) == 1


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_survives_f_matchmaker_deaths(backend, device):
    (transport, _, _, matchmakers, reconfigurer, _, _, clients) = make(
        backend, device)
    transport.deliver_all()
    matchmakers[0].receive("chaos", pm.Die())
    got = []
    clients[0].write(0, b"resilient", got.append)
    transport.deliver_all()
    reconfigurer.reconfigure(SimpleMajority([0, 1, 2]))
    transport.deliver_all()
    clients[0].write(0, b"post-reconfig", got.append)
    transport.deliver_all()
    assert got == [b"0", b"1"]


# The reference's randomized simulation (sim_util's PrefixAgreementSim with
# chaos), over the port's Simulator.


class WriteCmd:
    def __init__(self, client: int, pseudonym: int, payload: bytes):
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


class ChaosCmd:
    def __init__(self, label: str, payload=None):
        self.label = label
        self.payload = payload

    def __repr__(self):
        return f"Chaos({self.label}, {self.payload!r})"


def per_slot_agreement(actor_logs):
    per_slot: dict = {}
    for actor_index, entries in actor_logs:
        for slot, value in entries:
            if slot in per_slot:
                other, who = per_slot[slot]
                if other != value:
                    return (f"slot {slot} chosen twice: actor {who} has "
                            f"{other!r}, actor {actor_index} has {value!r}")
            else:
                per_slot[slot] = (value, actor_index)
    return None


class MMPSimulated(SimulatedSystem):
    """The reference's ``MMPSimulated``: writes interleaved with transport
    commands, acceptor reconfigurations, matchmaker epoch changes, one
    matchmaker death and leader churn; per-slot agreement across the
    leaders' and replicas' logs, executed logs that prefix-agree and only
    grow."""

    pseudonyms = (0, 1)
    transport_weight = 14
    NUM_ACCEPTORS = 6
    NUM_MATCHMAKERS = 5
    reconfig_p = 0.05
    leader_churn_p = 0.10

    def __init__(self, backend="dict", device=None):
        self.backend, self.device = backend, device

    def make_system(self, seed):
        (transport, _, leaders, matchmakers, reconfigurer, _, replicas,
         clients) = make(self.backend, self.device,
                         num_acceptors=self.NUM_ACCEPTORS,
                         num_matchmakers=self.NUM_MATCHMAKERS, seed=seed)
        return dict(transport=transport, leaders=leaders,
                    matchmakers=matchmakers, reconfigurer=reconfigurer,
                    replicas=replicas, clients=clients, deaths=0)

    def new_system(self, seed):
        system = self.make_system(seed)
        system["counter"] = 0
        return system

    def logs(self, system):
        return [r.state_machine.get() for r in system["replicas"]]

    def idle_writers(self, system):
        return [(c, p) for c, client in enumerate(system["clients"])
                for p in self.pseudonyms if p not in client.pending]

    def chaos_choices(self, system, rng):
        out = []
        if rng.random() < self.reconfig_p:
            out.append(ChaosCmd(
                "reconfigure",
                tuple(rng.sample(range(self.NUM_ACCEPTORS), 3))))
            out.append(ChaosCmd(
                "reconfigure_matchmakers",
                tuple(sorted(rng.sample(range(self.NUM_MATCHMAKERS), 3)))))
            if system["deaths"] < 1:
                out.append(ChaosCmd("die",
                                    rng.randrange(self.NUM_MATCHMAKERS)))
        if rng.random() < self.leader_churn_p:
            out.append(ChaosCmd("leader_change",
                                rng.randrange(len(system["leaders"]))))
        return out

    def generate_command(self, system, rng):
        choices: list = []
        if self.idle_writers(system):
            choices.append("write")
        transport_cmd = system["transport"].generate_command(rng)
        if transport_cmd is not None:
            choices.extend(["transport"] * self.transport_weight)
        choices.extend(self.chaos_choices(system, rng))
        if not choices:
            return None
        pick = rng.choice(choices)
        if pick == "write":
            client, pseudonym = rng.choice(self.idle_writers(system))
            system["counter"] += 1
            return WriteCmd(client, pseudonym, b"w%d" % system["counter"])
        if pick == "transport":
            return TransportCmd(transport_cmd)
        return pick

    def run_command(self, system, command):
        if isinstance(command, WriteCmd):
            client = system["clients"][command.client]
            if command.pseudonym not in client.pending:
                client.write(command.pseudonym, command.payload)
        elif isinstance(command, TransportCmd):
            system["transport"].run_command(command.command)
        elif command.label == "reconfigure":
            system["reconfigurer"].reconfigure(
                SimpleMajority(command.payload))
        elif command.label == "reconfigure_matchmakers":
            system["reconfigurer"].reconfigure_matchmakers(command.payload)
        elif command.label == "die":
            system["deaths"] += 1
            system["matchmakers"][command.payload].receive("chaos", pm.Die())
        else:
            leader = system["leaders"][command.payload]
            top = max(l.round for l in system["leaders"])
            leader._start_matchmaking(max(top, leader.round))
        return system

    def state_invariant(self, system):
        actors = list(system["leaders"]) + list(system["replicas"])
        error = per_slot_agreement(
            (i, actor.log.items()) for i, actor in enumerate(actors))
        if error:
            return error
        logs = self.logs(system)
        for i in range(len(logs)):
            for j in range(i + 1, len(logs)):
                n = min(len(logs[i]), len(logs[j]))
                if logs[i][:n] != logs[j][:n]:
                    return (f"logs diverge: [{i}] {logs[i]!r} vs "
                            f"[{j}] {logs[j]!r}")
        return None

    def get_state(self, system):
        return tuple(tuple(log) for log in self.logs(system))

    def step_invariant(self, old_state, new_state):
        for i, (old, new) in enumerate(zip(old_state, new_state)):
            if new[:len(old)] != old:
                return (f"log [{i}] did not grow monotonically: "
                        f"{old!r} -> {new!r}")
        return None


class MMPReconfigHeavySimulated(MMPSimulated):
    reconfig_p = 0.12
    leader_churn_p = 0.03


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_simulation_churn_no_divergence(backend, device):
    failure = Simulator(MMPSimulated(backend, device), run_length=250,
                        num_runs=300, minimize=False).run(seed=0)
    assert failure is None, str(failure)


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_simulation_reconfig_heavy_no_divergence(backend, device):
    failure = Simulator(MMPReconfigHeavySimulated(backend, device),
                        run_length=250, num_runs=150,
                        minimize=False).run(seed=0)
    assert failure is None, str(failure)


class MMPChurnProbe(MMPSimulated):
    """The reference probe's sim: the leaders' liveness-only
    resendMatchRequests timers kept stopped, so the phase-2 conflict
    interleavings stay reachable."""

    def make_system(self, seed):
        system = super().make_system(seed)
        for leader in system["leaders"]:
            original = leader._matchmake

            def quiet(*args, _leader=leader, _original=original, **kw):
                _original(*args, **kw)
                if _leader._match_resend_timer is not None:
                    _leader._match_resend_timer.stop()

            leader._matchmake = quiet
            if leader._match_resend_timer is not None:
                leader._match_resend_timer.stop()
        return system


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_mmp_sim_catches_weakened_write_quorum(monkeypatch, backend,
                                               device):
    """A single Phase2b vote must not make a write quorum; the
    leader-churn chaos profile catches it within its seed budget. Read
    quorums stay honest (the cuda arm reads them through K6)."""
    monkeypatch.setattr(
        SimpleMajority, "is_superset_of_read_quorum",
        lambda self, xs: len(set(xs) & self.members) >= self.quorum_size)
    monkeypatch.setattr(SimpleMajority, "is_superset_of_write_quorum",
                        lambda self, nodes: len(nodes) >= 1)
    failure = Simulator(MMPChurnProbe(backend, device), run_length=250,
                        num_runs=300, minimize=False).run(seed=0)
    assert failure is not None, (
        "the MMP churn sim no longer catches a weakened write quorum")
    assert "chosen twice" in failure.error or "diverge" in failure.error


def _fire(transport, name):
    for timer in list(transport.running_timers()):
        if timer.name.startswith(name):
            transport.trigger_timer(timer.id)
    transport.deliver_all()


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_driver_chaos_schedule(backend, device):
    (transport, config, leaders, _, _, _, replicas, clients) = make(
        backend, device, num_acceptors=6, num_matchmakers=5)
    pm.MMPDriver("driver", transport, logger=leaders[0].logger,
                 config=config,
                 workload=pm.DriverChaos(
                     warmup_delay_s=1.0, warmup_period_s=1.0, warmup_num=2,
                     matchmaker_failure_delay_s=2.0,
                     matchmaker_recover_delay_s=3.0,
                     acceptor_failure_delay_s=4.0,
                     acceptor_recover_delay_s=5.0),
                 seed=5)
    transport.deliver_all()
    got = []

    def write(payload):
        clients[0].write(0, payload, got.append)
        for _ in range(12):
            for timer in list(transport.running_timers()):
                if timer.name.startswith("resend"):
                    transport.trigger_timer(timer.id)
            transport.deliver_all()
            if got and got[-1] is not None:
                break

    write(b"w0")
    _fire(transport, "warmupDelay")
    _fire(transport, "warmupRepeat")
    write(b"w1")
    _fire(transport, "warmupRepeat")
    _fire(transport, "matchmakerFailure")
    write(b"w2")
    _fire(transport, "matchmakerRecover")
    write(b"w3")
    _fire(transport, "acceptorFailure")
    _fire(transport, "acceptorRecover")
    write(b"w4")
    assert len(got) == 5, got
    logs = [r.state_machine.get() for r in replicas]
    n = min(len(l) for l in logs)
    assert logs[0][:n] == logs[1][:n]
    assert logs[0] and logs[0][-1] == b"w4"


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_driver_chaos_minimal_matchmaker_cluster(backend, device):
    """On a bare 2f+1-matchmaker cluster the driver kills one and must
    skip the epoch change that can no longer form a live epoch."""
    (transport, config, leaders, _, _, _, _, clients) = make(backend, device)
    pm.MMPDriver("driver", transport, logger=leaders[0].logger,
                 config=config,
                 workload=pm.DriverChaos(
                     warmup_delay_s=1.0, warmup_period_s=1.0, warmup_num=1,
                     matchmaker_failure_delay_s=2.0,
                     matchmaker_recover_delay_s=3.0,
                     acceptor_failure_delay_s=4.0,
                     acceptor_recover_delay_s=5.0), seed=1)
    transport.deliver_all()
    for name in ("warmupDelay", "warmupRepeat", "matchmakerFailure",
                 "matchmakerRecover"):
        _fire(transport, name)
    got = []
    clients[0].write(0, b"alive", got.append)
    for _ in range(12):
        if got:
            break
        for timer in list(transport.running_timers()):
            if timer.name.startswith("resend"):
                transport.trigger_timer(timer.id)
        transport.deliver_all()
    assert got == [b"0"]


@pytest.mark.parametrize("workload,names", [
    (pm.DriverRepeatedReconfiguration(delay_s=1.0, period_s=1.0),
     ("reconfigureDelay", "reconfigureRepeat", "reconfigureRepeat")),
    (pm.DriverMatchmakerReconfiguration(
        warmup_delay_s=1.0, warmup_period_s=1.0, warmup_num=2,
        matchmaker_delay_s=3.0, matchmaker_period_s=1.0, matchmaker_num=2),
     ("warmupDelay", "warmupRepeat", "warmupRepeat", "mmReconfigureDelay",
      "mmReconfigureRepeat", "mmReconfigureRepeat"))])
def test_driver_schedules_match_the_reference(workload, names):
    """The other two driver workloads (on ``driver_util``'s timers) drive
    the port's cluster and the JAX cluster to the same state."""
    def drive(make_cluster, ns):
        (transport, config, leaders, matchmakers, _, _, replicas,
         clients) = make_cluster()
        driver_workload = type(workload).__name__
        ns.MMPDriver("driver", transport, logger=leaders[0].logger,
                     config=config,
                     workload=getattr(ns, driver_workload)(
                         **vars(workload)), seed=3)
        transport.deliver_all()
        got = []
        for i, name in enumerate(names):
            _fire(transport, name)
            clients[0].write(0, b"w%d" % i, got.append)
            transport.deliver_all()
        return _snapshot(leaders, matchmakers, replicas, got)

    ref = drive(lambda: jt.make_mmp(num_acceptors=6, num_matchmakers=5), jm)
    port = drive(lambda: make_mmp(num_acceptors=6, num_matchmakers=5), pm)
    assert port == ref
    assert len(ref["replies"]) == len(names)


# --- (b) the checker -------------------------------------------------------------


def _systems(ns):
    return [ns.SimpleMajority([0, 1, 2]), ns.SimpleMajority([2, 3, 4, 5, 6]),
            ns.Grid([[0, 1], [2, 3], [4, 5]]), ns.UnanimousWrites([5, 6, 7])]


def test_multi_config_checker_matches_host_oracle():
    """``check_all`` and ``check_batch`` == ``is_superset_of_read_quorum``
    == the JAX checker, for every responder set of the pool, with the
    port's planes made from its specs and carried from the JAX
    checker's."""
    universe = tuple(range(8))
    port_systems = _systems(PORT_QS)
    jax_systems = _systems(jq)
    jax = JMultiConfigQuorumChecker(
        [qs.read_spec().reindexed(universe) for qs in jax_systems])
    built = tq.MultiConfigQuorumChecker(
        [qs.read_spec().reindexed(universe) for qs in port_systems],
        device="cpu")
    carried = convert.multi_config_checker_from(jax, device="cpu")
    assert built.multi.bits and carried.multi.bits
    for name in ("masks", "thresholds", "combine_any"):
        assert torch.equal(getattr(built.planes, name),
                           getattr(carried.planes, name)), name
    idx = np.arange(len(port_systems), dtype=np.int32)
    for size in range(len(universe) + 1):
        for responders in itertools.combinations(universe, size):
            want = [qs.is_superset_of_read_quorum(set(responders))
                    for qs in port_systems]
            present = np.zeros((len(idx), len(universe)), dtype=np.uint8)
            present[:, list(responders)] = 1
            assert list(jax.check_batch(present, idx)) == want
            for checker in (built, carried):
                assert checker.check_all(responders).tolist() == want
                assert checker.check_batch(present, idx).tolist() == want


def test_multi_config_checker_past_32_acceptors_takes_check_batch():
    """A pool of 40 acceptors has no word form: ``check_all`` is the
    reference's batch of equal rows, and still equals the oracle."""
    rng = random.Random(40)
    universe = tuple(range(40))
    systems = [SimpleMajority(rng.sample(universe, 5)),
               Grid([rng.sample(universe, 3), rng.sample(universe, 3)]),
               UnanimousWrites([33, 36, 39])]
    checker = tq.MultiConfigQuorumChecker(
        [qs.read_spec().reindexed(universe) for qs in systems], device="cpu")
    assert not checker.multi.bits
    with pytest.raises(ValueError):
        checker.multi.check_word_all(1)
    for _ in range(300):
        responders = set(rng.sample(universe, rng.randrange(41)))
        want = [qs.is_superset_of_read_quorum(responders) for qs in systems]
        assert checker.check_all(responders).tolist() == want


def test_leader_keeps_its_phase1_checkers():
    """A phase 1 over the same prior configurations reuses the checker of
    an earlier one; the cache holds ``CHECKER_CACHE`` checkers at most."""
    (transport, _, leaders, _, reconfigurer, _, replicas, clients) = make(
        "cuda", "cpu", num_acceptors=6)
    leader = leaders[0]
    built = []
    build = leader._build_checker
    leader._build_checker = lambda specs: built.append(len(specs)) or \
        build(specs)
    transport.deliver_all()
    got = []
    for i in range(6):
        reconfigurer.reconfigure(SimpleMajority([0, 1, 2] if i % 2
                                                else [3, 4, 5]))
        transport.deliver_all()
        clients[0].write(0, b"w%d" % i, got.append)
        transport.deliver_all()
    assert len(got) == 6
    # Phase 1s read {0,1,2}, then alternately {3,4,5} and {0,1,2}: two
    # distinct read-spec sets, so two builds.
    assert built == [1, 1]
    assert len(leader._checkers) == 2
    checker = next(iter(leader._checkers.values()))
    for members in itertools.islice(itertools.combinations(range(6), 3),
                                    pm.MMPLeader.CHECKER_CACHE + 3):
        leader._phase1_checker({7: SimpleMajority(members),
                                9: UnanimousWrites(members[:1])})
    assert len(leader._checkers) == pm.MMPLeader.CHECKER_CACHE
    assert checker not in leader._checkers.values()
    logs = [r.state_machine.get() for r in replicas]
    assert logs[0] == logs[1] == [b"w%d" % i for i in range(6)]


def _at(address: int, count: int, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    raw = (ctypes.c_uint8 * (count * dtype.itemsize)).from_address(address)
    return np.frombuffer(raw, dtype=dtype)


@pytest.mark.parametrize("k,n", [(1, 6), (3, 6), (2, 10), (4, 10)])
def test_check_word_all_packs_one_word_under_every_plane(monkeypatch, k, n):
    """The staged one-word form, with ``fpx_check_batch_multi_staged``
    modelled in Python: ONE prebuilt call whose rows are the word at cell
    0 read K times (row stride 0), its indices ``0..K-1`` preset in the
    block, its K answer bytes written back there; the planes' cells ride
    in the parameters (no card pointers) and are never uploaded."""
    from frankenpaxos_tpu_torch.bench.launch_shapes import matchmaker_specs

    monkeypatch.setattr(tq, "_pinned_cells",
                        lambda cells: torch.zeros(cells, dtype=torch.int32))
    monkeypatch.setattr(tq.check_batch_multi, "launches", 0)
    specs = matchmaker_specs(k, n)
    planes_np = tq.pad_specs(specs)
    mc = tq.MultiCheck(*planes_np, device="cpu")
    mc._staging = types.SimpleNamespace(index=0, stream_handle=0)
    mc._cap = 0
    mc._grow(64)
    calls = []

    def model(block):
        a = struct.unpack("=18q", block)
        calls.append(a)
        rows, rs, cs, b, nn, cfg, out, flags = a[:8]
        assert (rs, cs, b, nn) == (0, 1, k, n)
        assert flags == tq._MULTI_BITS | tq._MULTI_MAPPED
        assert a[10:13] == (0, 0, 0), "planes read from the card"
        np.testing.assert_array_equal(_at(a[8], a[9], np.int32),
                                      mc.cells_bits)
        word = int(_at(rows, 1, np.uint32)[0])
        idx = _at(cfg, k, np.int32).copy() if k > 1 else np.zeros(k,
                                                                  np.int32)
        np.testing.assert_array_equal(idx, np.arange(k))
        present = np.tile([(word >> i) & 1 for i in range(n)], (k, 1))
        _at(out, k, np.uint8)[:] = tq.check_batch_multi_plain(
            torch.from_numpy(present.astype(np.int32)),
            torch.from_numpy(idx), mc.planes).numpy()
        return 0

    monkeypatch.setattr(tq._K6_MULTI, "fn", model)
    assert mc._planes is None
    cpu = tq.MultiCheck(*planes_np, device="cpu")
    for word in range(1 << n):
        got = mc.check_word_all(word)
        np.testing.assert_array_equal(got, cpu.check_word_all(word))
        assert calls[-1] == calls[0]  # the one prebuilt packed call
    assert tq.check_batch_multi.launches == 1 << n
    # A batch's rows start past the indices and answers.
    base = mc._block.data_ptr()
    assert calls[0][0] == base and calls[0][5] == (
        base + 4 * mc.ONE_CELLS if k > 1 else 0)
    assert calls[0][6] == base + 4 * mc.all_out
    assert mc.rows_at >= mc.all_out + (k + 3) // 4 and mc.rows_at % 4 == 0


# --- (c) the JAX cluster and the port's ------------------------------------------


def _norm(value):
    if not hasattr(value, "command_id"):
        return ("noop",)
    cid = value.command_id
    return (cid.client_address, cid.client_pseudonym, cid.client_id,
            value.command)


def _snapshot(leaders, matchmakers, replicas, replies) -> dict:
    return {
        "logs": [r.state_machine.get() for r in replicas],
        "leader_logs": [{s: _norm(v) for s, v in sorted(l.log.items())}
                        for l in leaders],
        "replies": replies,
        "rounds": [l.round for l in leaders],
        "epochs": [l.matchmaker_configuration.epoch for l in leaders],
        "configurations": [m.configurations for m in matchmakers],
        "gc_watermarks": [m.gc_watermark for m in matchmakers],
    }


JAX_BACKENDS = ("dict", "tpu")


def _jax_cluster(backend, **kw):
    return jt.make_mmp(quorum_backend=backend, **kw)


def _scenario(cluster, qs, die) -> dict:
    """Writes; reconfigurations to SimpleMajority([3, 4, 5]), a Grid and
    UnanimousWrites; a matchmaker epoch change; a Die'd matchmaker."""
    (transport, _, leaders, matchmakers, reconfigurer, _, replicas,
     clients) = cluster
    transport.deliver_all()
    got = []

    def write(payload):
        clients[0].write(0, payload, got.append)
        clients[1].write(0, payload + b"'", got.append)
        transport.deliver_all()

    write(b"a")
    for system in (qs.SimpleMajority([3, 4, 5]),
                   qs.Grid([[0, 1], [2, 3]]),
                   qs.UnanimousWrites([1, 4, 5])):
        reconfigurer.reconfigure(system)
        transport.deliver_all()
        write(b"b")
    reconfigurer.reconfigure_matchmakers([2, 3, 4])
    transport.deliver_all()
    write(b"c")
    matchmakers[3].receive("chaos", die())
    reconfigurer.reconfigure(qs.SimpleMajority([0, 2, 5]))
    transport.deliver_all()
    write(b"d")
    return _snapshot(leaders, matchmakers, replicas, got)


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("jax_backend", JAX_BACKENDS)
def test_scenario_matches_the_reference(backend, device, jax_backend):
    for seed in range(2):
        ref = _scenario(_jax_cluster(jax_backend, num_acceptors=6,
                                     num_matchmakers=5, seed=seed),
                        jq, jm.Die)
        port = _scenario(make(backend, device, num_acceptors=6,
                              num_matchmakers=5, seed=seed),
                         PORT_QS, pm.Die)
        assert port == ref, seed
        assert len(ref["replies"]) == 12
        assert ref["epochs"] == [1, 1]


def _interleaved(cluster, system_ns, die, seed: int, steps: int) -> dict:
    """A random drive of the sim's kinds of step, with the same seed on
    both packages."""
    (transport, _, leaders, matchmakers, reconfigurer, _, replicas,
     clients) = cluster
    rng = random.Random(seed)
    replies: list = []
    counter, deaths = 0, 0
    for _ in range(steps):
        roll = rng.random()
        if roll < 0.1:
            idle = [(c, p) for c, client in enumerate(clients)
                    for p in (0, 1) if p not in client.pending]
            if idle:
                c, p = rng.choice(idle)
                counter += 1
                clients[c].write(p, b"w%d" % counter,
                                 lambda r, c=c, p=p: replies.append((c, p,
                                                                     r)))
            continue
        if roll < 0.104:
            kind = rng.randrange(3)
            nodes = rng.sample(range(6), 4)
            reconfigurer.reconfigure(
                system_ns.SimpleMajority(nodes[:3]) if kind == 0 else
                system_ns.Grid([nodes[:2], nodes[2:]]) if kind == 1 else
                system_ns.UnanimousWrites(nodes[:3]))
            continue
        if roll < 0.105:
            reconfigurer.reconfigure_matchmakers(
                tuple(sorted(rng.sample(range(5), 3))))
            continue
        if roll < 0.106 and deaths < 1:
            deaths += 1
            matchmakers[rng.randrange(5)].receive("chaos", die())
            continue
        if roll < 0.108:
            leader = leaders[rng.randrange(len(leaders))]
            leader._start_matchmaking(max(max(l.round for l in leaders),
                                          leader.round))
            continue
        # A random in-flight message; a random timer only when none is
        # (timers fired among messages resend MatchRequests whose nacks
        # restart matchmaking faster than a phase 1 can finish).
        commands = transport.possible_commands()
        messages = [c for c in commands
                    if type(c).__name__ == "DeliverMessage"]
        if messages or commands:
            transport.run_command(rng.choice(messages or commands))
    return _snapshot(leaders, matchmakers, replicas, replies)


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("jax_backend", JAX_BACKENDS)
def test_interleavings_match_the_reference(backend, device, jax_backend):
    """Random deliveries, timer firings, writes, reconfigurations of every
    kind, matchmaker epoch changes, a death and leader churn, the same
    seed on both packages: equal logs, replies, rounds, matchmaker
    configurations and GC watermarks."""
    answered = 0
    for seed in range(10 if jax_backend == "dict" else 4):
        ref = _interleaved(_jax_cluster(jax_backend, num_acceptors=6,
                                        num_matchmakers=5, seed=seed),
                           jq, jm.Die, seed, 1500)
        port = _interleaved(make(backend, device, num_acceptors=6,
                                 num_matchmakers=5, seed=seed),
                            PORT_QS, pm.Die, seed, 1500)
        assert port == ref, seed
        answered += len(ref["replies"])
    assert answered > 20


# --- (d) no fallback -------------------------------------------------------------


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mmp(quorum_backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        matchmaker_sim.run()


@pytest.mark.parametrize("backend", ["tpu", "host", "gpu"])
def test_other_backends_are_refused(backend):
    with pytest.raises(ValueError, match="unknown quorum backend"):
        make_mmp(quorum_backend=backend, device="cpu")


# --- (e) the closed-loop bench -----------------------------------------------------


def test_matchmaker_sim_small():
    result = matchmaker_sim.run("cpu", writes=256)
    for arm, runs in result["arms"].items():
        for backend, fig in runs.items():
            assert fig["writes_per_sec"] > 0
            assert fig["configurations"] >= 256 // 32
            assert fig["matchmaker_epoch"] == 1
            assert fig["phase1_checks"] > 0
            assert fig["check_batch_multi_launches"] == 0  # plain version
        cuda = runs["cuda"]
        assert cuda["phase1s"] == sum(int(n) for n in
                                      cuda["k_counts"].values())
        assert set(cuda["k_counts"]) >= {"1", "2"}
        assert 0 < cuda["checker_builds"] <= cuda["phase1s"]


def test_matchmaker_sim_gates_fire(monkeypatch):
    """A cuda run whose replies differed from the dict run's fails."""
    run_arm = matchmaker_sim.run_arm

    def skewed(*args, **kw):
        fig = run_arm(*args, **kw)
        if args[3] == "cuda":
            fig["replies"] = dict(list(fig["replies"].items())[1:])
        return fig

    monkeypatch.setattr(matchmaker_sim, "run_arm", skewed)
    with pytest.raises(matchmaker_sim.GateFailure, match="replies differ"):
        matchmaker_sim.run("cpu", writes=64)
    with pytest.raises(matchmaker_sim.GateFailure):
        matchmaker_sim._require(False, "the gate")
