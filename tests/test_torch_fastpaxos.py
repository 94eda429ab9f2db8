"""The port's single-decree Fast Paxos (``protocols/fastpaxos.py``)
against the JAX package's.

(a) The Fast Paxos cases of ``tests/protocols/test_small_protocols.py``
(the fast path, the classic fallback after a fast-round conflict, safety
under random reordering) and of ``tests/protocols/test_single_decree_sims.py``
(the property ``Simulator`` at the reference's 500 runs x 250 steps, and
the mutation probe: a fast quorum weakened to a classic majority must be
caught), on the port's clusters with the host quorum backend and with
``"cuda"`` at ``device="cpu"`` (K6's plain version).
(b) Cross-package: the same seeds drive the JAX cluster and the port's
through the same random interleavings (each transport's
``generate_command`` from an equally seeded ``random.Random``), to equal
chosen values at every leader and client and equal replies.
"""

from __future__ import annotations

import random
from typing import Optional

from frankenpaxos_tpu_torch.protocols import fastpaxos as pfp
from frankenpaxos_tpu_torch.protocols.fast_harness import make_fastpaxos
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
import pytest

from frankenpaxos_tpu.protocols import fastpaxos as jfp
from frankenpaxos_tpu.runtime import (
    FakeLogger as JFakeLogger,
    LogLevel as JLogLevel,
    SimTransport as JSimTransport,
)

#: The reference's backends on the port: the host oracle and K6's plain
#: version.
BACKENDS = [("host", None), ("cuda", "cpu")]
NUM_RUNS = 500
RUN_LENGTH = 250


# --- (a) test_small_protocols.py's cases ----------------------------------------


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_fast_path(backend, device):
    transport, leaders, acceptors, clients = make_fastpaxos(
        quorum_backend=backend, device=device)
    transport.deliver_all()
    got = []
    clients[0].propose("fast", got.append)
    transport.deliver_all()
    assert got == ["fast"]


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_classic_fallback_on_conflict(backend, device):
    transport, leaders, acceptors, clients = make_fastpaxos(
        quorum_backend=backend, device=device)
    transport.deliver_all()
    got = []
    clients[0].propose("a", got.append)
    clients[1].propose("b", got.append)
    transport.deliver_all()
    for _ in range(10):
        if len(got) == 2:
            break
        for timer in transport.running_timers():
            transport.trigger_timer(timer.id)
        transport.deliver_all()
    assert len(got) == 2
    assert got[0] == got[1]


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_safety_under_reordering(backend, device):
    for seed in range(20):
        rng = random.Random(seed)
        transport, leaders, acceptors, clients = make_fastpaxos(
            quorum_backend=backend, device=device)
        clients[0].propose("a")
        clients[1].propose("b")
        for _ in range(400):
            cmd = transport.generate_command(rng)
            if cmd is None:
                break
            transport.run_command(cmd)
        chosen = ({l.chosen_value for l in leaders
                   if l.chosen_value is not None}
                  | {c.chosen_value for c in clients
                     if c.chosen_value is not None})
        assert len(chosen) <= 1, (seed, chosen)


# --- (a) test_single_decree_sims.py's cases --------------------------------------


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


class FastPaxosSimulated(SimulatedSystem):
    """The reference's ``SingleDecreeSim`` over the port's Fast Paxos:
    one-shot proposals interleaved with transport commands; at most one
    value is ever chosen, and a chosen value never changes."""

    num_clients = 3
    transport_weight = 8

    def __init__(self, quorum_backend: str = "host", device=None):
        self.quorum_backend = quorum_backend
        self.device = device

    def new_system(self, seed: int) -> dict:
        transport, leaders, acceptors, clients = make_fastpaxos(
            num_clients=self.num_clients, quorum_backend=self.quorum_backend,
            device=self.device)
        return dict(transport=transport, leaders=leaders,
                    acceptors=acceptors, clients=clients, proposed=set())

    def chosen_values(self, system: dict) -> set:
        return ({l.chosen_value for l in system["leaders"]
                 if l.chosen_value is not None}
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


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_fastpaxos_simulation(backend, device):
    failure = Simulator(FastPaxosSimulated(backend, device),
                        run_length=RUN_LENGTH,
                        num_runs=NUM_RUNS).run(seed=0)
    assert failure is None, str(failure)


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_fastpaxos_sim_catches_weak_fast_quorum(monkeypatch, backend,
                                                device):
    """Weakening the fast quorum to a classic majority must be caught."""
    monkeypatch.setattr(
        pfp.FastPaxosConfig, "fast_quorum_size",
        property(lambda self: self.classic_quorum_size))
    failure = Simulator(FastPaxosSimulated(backend, device),
                        run_length=RUN_LENGTH,
                        num_runs=NUM_RUNS).run(seed=0)
    assert failure is not None, (
        "the sim failed to catch the fast quorum weakened to a classic "
        "majority")


# --- (b) the JAX cluster and the port's, interleaving for interleaving ----------


def make_reference(f: int = 1, num_clients: int = 2):
    logger = JFakeLogger(JLogLevel.FATAL)
    transport = JSimTransport(logger)
    config = jfp.FastPaxosConfig(
        f=f,
        leader_addresses=tuple(f"leader-{i}" for i in range(f + 1)),
        acceptor_addresses=tuple(f"acceptor-{i}" for i in range(2 * f + 1)))
    leaders = [jfp.FastPaxosLeader(a, transport, logger, config)
               for a in config.leader_addresses]
    acceptors = [jfp.FastPaxosAcceptor(a, transport, logger, config)
                 for a in config.acceptor_addresses]
    clients = [jfp.FastPaxosClient(f"client-{i}", transport, logger, config)
               for i in range(num_clients)]
    return transport, leaders, acceptors, clients


def _drive(cluster, seed: int, steps: int) -> tuple:
    transport, leaders, _, clients = cluster
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
    return ([l.chosen_value for l in leaders],
            [c.chosen_value for c in clients], replies, trace)


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("f", [1, 2])
def test_cluster_matches_the_reference(backend, device, f):
    """The same seeds through the same interleavings: every leader's and
    client's chosen value and every reply equal the JAX cluster's."""
    chose = 0
    for seed in range(40):
        ref = _drive(make_reference(f, num_clients=3), seed, 600)
        port = _drive(make_fastpaxos(f, num_clients=3,
                                     quorum_backend=backend, device=device),
                      seed, 600)
        assert port == ref, seed
        chose += any(v is not None for v in ref[0] + ref[1])
    assert chose > 10
