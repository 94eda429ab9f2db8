"""The port's Matchmaker Paxos (``protocols/matchmakerpaxos.py``, every
role on the host) against the JAX package's.

(a) The four tests of ``tests/protocols/test_matchmakerpaxos.py`` on the
port: a single proposal chosen, competing proposals agreeing, more
acceptors than the minimum, and safety under random reordering.
(b) The Matchmaker Paxos case of
``tests/protocols/test_single_decree_sims.py``: the property ``Simulator``
at the reference's 500 runs x 250 steps (at most one value chosen, a
chosen value never changes), and its sensitivity: phase 1 that adopts no
earlier vote must be caught.
(c) Cross-package: the JAX cluster and the port's from the same seed,
through the same random interleavings, end with equal chosen values,
replies, leader rounds and matchmaker configurations.
"""

from __future__ import annotations

import random
from typing import Optional

from frankenpaxos_tpu_torch.protocols import matchmakerpaxos as pmp
from frankenpaxos_tpu_torch.protocols.matchmaker_harness import (
    make_matchmaker_paxos,
)
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
import pytest

from tests.protocols import test_matchmakerpaxos as jt

NUM_RUNS = 500
RUN_LENGTH = 250


def pump(transport, predicate, rounds=10):
    for _ in range(rounds):
        if predicate():
            return True
        for timer in transport.running_timers():
            transport.trigger_timer(timer.id)
        transport.deliver_all()
    return predicate()


# --- (a) the reference's four tests ----------------------------------------------


def test_single_proposal_chosen():
    transport, _, _, matchmakers, _, clients = make_matchmaker_paxos()
    got = []
    clients[0].propose("x", got.append)
    transport.deliver_all()
    assert pump(transport, lambda: got == ["x"])
    assert any(m.acceptor_groups for m in matchmakers)


def test_competing_proposals_agree():
    transport, _, _, _, _, clients = make_matchmaker_paxos()
    got = []
    clients[0].propose("a", got.append)
    clients[1].propose("b", got.append)
    transport.deliver_all()
    assert pump(transport, lambda: len(got) == 2, rounds=30)
    assert got[0] == got[1]


def test_more_acceptors_than_minimum():
    transport, _, _, _, _, clients = make_matchmaker_paxos(num_acceptors=5)
    got = []
    clients[0].propose("v", got.append)
    transport.deliver_all()
    assert pump(transport, lambda: got == ["v"])


def test_safety_under_reordering():
    for seed in range(15):
        rng = random.Random(seed)
        transport, _, leaders, _, _, clients = make_matchmaker_paxos(
            seed=seed)
        clients[0].propose("a")
        clients[1].propose("b")
        for _ in range(500):
            cmd = transport.generate_command(rng)
            if cmd is None:
                break
            transport.run_command(cmd)
        chosen = {l.state.v for l in leaders
                  if isinstance(l.state, pmp._Chosen)}
        chosen |= {c.chosen_value for c in clients
                   if c.chosen_value is not None}
        assert len(chosen) <= 1, (seed, chosen)


# --- (b) test_single_decree_sims.py's case --------------------------------------


class ProposeCmd:
    def __init__(self, client: int, value):
        self.client = client
        self.value = value

    def __repr__(self):
        return f"Propose({self.client}, {self.value!r})"


class TransportCmd:
    def __init__(self, command):
        self.command = command

    def __repr__(self):
        return f"Transport({self.command!r})"


class MatchmakerPaxosSimulated(SimulatedSystem):
    """The reference's ``SingleDecreeSim`` over the port's Matchmaker
    Paxos (f = 1, 2f + 2 acceptors, three clients)."""

    num_clients = 3
    transport_weight = 8

    def new_system(self, seed: int) -> dict:
        transport, _, leaders, _, _, _ = make_matchmaker_paxos(
            num_acceptors=4, num_clients=0, seed=seed)
        logger = leaders[0].logger
        clients = [pmp.MatchmakerPaxosClient(
            f"client-{i}", transport, logger, leaders[0].config,
            seed=seed + i) for i in range(self.num_clients)]
        return dict(transport=transport, leaders=leaders, clients=clients,
                    proposed=set())

    def chosen_values(self, system: dict) -> set:
        return ({l.state.v for l in system["leaders"]
                 if isinstance(l.state, pmp._Chosen)}
                | {c.chosen_value for c in system["clients"]
                   if c.chosen_value is not None})

    def generate_command(self, system: dict, rng: random.Random):
        choices = []
        idle = [c for c in range(self.num_clients)
                if c not in system["proposed"]]
        if idle:
            choices.append("propose")
        transport_cmd = system["transport"].generate_command(rng)
        if transport_cmd is not None:
            choices.extend(["transport"] * self.transport_weight)
        if not choices:
            return None
        if rng.choice(choices) == "propose":
            client = rng.choice(idle)
            return ProposeCmd(client, f"v{client}")
        return TransportCmd(transport_cmd)

    def run_command(self, system: dict, command) -> dict:
        if isinstance(command, ProposeCmd):
            if command.client not in system["proposed"]:
                system["proposed"].add(command.client)
                system["clients"][command.client].propose(command.value)
        else:
            system["transport"].run_command(command.command)
        return system

    def get_state(self, system: dict):
        return frozenset(self.chosen_values(system))

    def state_invariant(self, system: dict) -> Optional[str]:
        chosen = self.chosen_values(system)
        if len(chosen) > 1:
            return f"more than one value chosen: {sorted(chosen)!r}"
        return None

    def step_invariant(self, old_state, new_state) -> Optional[str]:
        if not old_state <= new_state:
            return (f"a chosen value changed: {set(old_state)!r} -> "
                    f"{set(new_state)!r}")
        return None


def test_matchmakerpaxos_simulation():
    failure = Simulator(MatchmakerPaxosSimulated(), run_length=RUN_LENGTH,
                        num_runs=NUM_RUNS).run(seed=0)
    assert failure is None, str(failure)


def test_matchmakerpaxos_sim_catches_skipped_vote_adoption(monkeypatch):
    """A matchmade leader completing phase 1 over every prior
    configuration must adopt the highest vote it read; proposing its own
    value regardless must be caught."""
    original = pmp.MatchmakerPaxosLeader._handle_phase1b

    def no_adoption(self, src, phase1b):
        phase1b = pmp.Phase1b(round=phase1b.round,
                              acceptor_index=phase1b.acceptor_index,
                              vote=None)
        original(self, src, phase1b)

    monkeypatch.setattr(pmp.MatchmakerPaxosLeader, "_handle_phase1b",
                        no_adoption)
    failure = Simulator(MatchmakerPaxosSimulated(), run_length=RUN_LENGTH,
                        num_runs=NUM_RUNS).run(seed=0)
    assert failure is not None, (
        "the sim failed to catch phase-1 vote adoption being disabled")


# --- (c) the JAX cluster and the port's, interleaving for interleaving ----------


def _drive(cluster, seed: int, steps: int) -> tuple:
    transport, _, leaders, matchmakers, _, clients = cluster
    rng = random.Random(seed)
    replies = []
    for i, client in enumerate(clients):
        client.propose(f"v{i}", lambda v, i=i: replies.append((i, v)))
    trace = []
    for _ in range(steps):
        cmd = transport.generate_command(rng)
        if cmd is None:
            break
        trace.append(type(cmd).__name__)
        transport.run_command(cmd)
    return ([getattr(l.state, "v", None) if type(l.state).__name__
             == "_Chosen" else None for l in leaders],
            [l.round for l in leaders],
            [c.chosen_value for c in clients], replies,
            [{r: (g.round, g.quorum_system)
              for r, g in sorted(m.acceptor_groups.items())}
             for m in matchmakers], trace)


@pytest.mark.parametrize("f", [1, 2])
def test_cluster_matches_the_reference(f):
    """The same seeds through the same interleavings: every leader's
    chosen value and round, every client's chosen value and reply, and
    every matchmaker's stored configurations equal the JAX cluster's. One
    client mostly gets its value chosen; three contend, restarting the
    leaders' rounds."""
    chose = 0
    for clients, steps in ((1, 2000), (3, 600)):
        for seed in range(30):
            ref = _drive(jt.make_matchmaker_paxos(
                f=f, num_clients=clients, seed=seed), seed, steps)
            port = _drive(make_matchmaker_paxos(
                f=f, num_clients=clients, seed=seed), seed, steps)
            assert port == ref, (clients, seed)
            chose += any(v is not None for v in ref[0] + ref[2])
    assert chose > 10
