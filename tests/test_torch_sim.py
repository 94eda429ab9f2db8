"""The port's property ``Simulator`` (``frankenpaxos_tpu_torch/sim/``).

(a) ``tests/test_simulator.py`` repeated on the port: the teaching
systems with known violations (found and minimized) and a correct one.
(b) The Simulator cases of the protocol tests, on the port's clusters
with the host backends and with the ``"cuda"`` ones at ``device="cpu"``:
``test_simulation_committed_agreement`` of ``test_simplebpaxos.py``,
``test_simulation_gc_no_divergence`` of ``test_simplegcbpaxos.py`` (with
the port's own copy of ``tests/protocols/sim_util.PrefixAgreementSim``)
and the two ``EPaxosSimulated`` cases of ``test_epaxos.py``.
(c) Cross-package: the same seed drives the JAX and the port's BPaxos
systems through the same random interleaving, to equal committed
vertices.
"""

import dataclasses
import random
from typing import Optional

from frankenpaxos_tpu_torch.protocols.epaxos.harness import (
    committed_triples,
    make_epaxos,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.harness import (
    committed_log,
    make_bpaxos,
    make_gc_bpaxos,
)
from frankenpaxos_tpu_torch.runtime import (
    Actor,
    FakeLogger,
    PickleSerializer,
    SimTransport,
)
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
from frankenpaxos_tpu_torch.statemachine import SetRequest
import pytest

from frankenpaxos_tpu.runtime import PickleSerializer as JPickleSerializer
from tests.protocols import test_simplebpaxos as jt

SER = PickleSerializer()
JSER = JPickleSerializer()


# --- (a) the simulator itself ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Jugs:
    big: int = 0
    small: int = 0


class DieHard(SimulatedSystem):
    """The "invariant" big != 4 is violated by a 6-step plan."""

    MOVES = ["fill_big", "fill_small", "empty_big", "empty_small",
             "big_to_small", "small_to_big"]

    def new_system(self, seed):
        return Jugs()

    def generate_command(self, system, rng):
        return rng.choice(self.MOVES)

    def run_command(self, system: Jugs, command: str) -> Jugs:
        big, small = system.big, system.small
        if command == "fill_big":
            big = 5
        elif command == "fill_small":
            small = 3
        elif command == "empty_big":
            big = 0
        elif command == "empty_small":
            small = 0
        elif command == "big_to_small":
            poured = min(big, 3 - small)
            big, small = big - poured, small + poured
        elif command == "small_to_big":
            poured = min(small, 5 - big)
            big, small = big + poured, small - poured
        return Jugs(big, small)

    def state_invariant(self, system: Jugs) -> Optional[str]:
        if system.big == 4:
            return f"big jug holds 4 gallons: {system}"
        return None


def test_diehard_finds_and_minimizes_violation():
    simulator = Simulator(DieHard(), run_length=50, num_runs=200)
    failure = simulator.run(seed=0)
    assert failure is not None
    assert len(failure.history) <= 8
    replayed = simulator._replay(failure.seed, failure.history)
    assert replayed is not None
    assert "4 gallons" in replayed.error


@dataclasses.dataclass(frozen=True)
class Withdraw:
    amount: int


@dataclasses.dataclass(frozen=True)
class DepositCmd:
    amount: int


@dataclasses.dataclass(frozen=True)
class WithdrawCmd:
    amount: int


@dataclasses.dataclass(frozen=True)
class BankTransportCmd:
    command: object


class AccountServer(Actor):
    def __init__(self, address, transport, logger):
        super().__init__(address, transport, logger)
        self.balance = 0

    def receive(self, src, message: Withdraw):
        # The balance check happened at the client (a race by design).
        self.balance -= message.amount


class AccountClient(Actor):
    def __init__(self, address, transport, logger, server_address):
        super().__init__(address, transport, logger)
        self.server_address = server_address
        self.believed_balance = 0

    def withdraw(self, amount):
        if self.believed_balance >= amount:
            self.believed_balance -= amount
            self.send(self.server_address, Withdraw(amount))

    def receive(self, src, message):
        pass


@dataclasses.dataclass
class BankSystem:
    transport: SimTransport
    server: AccountServer
    clients: list


class BankAccount(SimulatedSystem):
    """Two clients share an account; concurrent client-side checks let
    the server balance go negative."""

    def new_system(self, seed):
        logger = FakeLogger()
        transport = SimTransport(logger)
        server = AccountServer("server", transport, logger)
        clients = [AccountClient(f"client{i}", transport, logger, "server")
                   for i in range(2)]
        return BankSystem(transport, server, clients)

    def generate_command(self, system: BankSystem, rng: random.Random):
        choices = [DepositCmd(rng.randrange(1, 10)),
                   WithdrawCmd(rng.randrange(1, 10))]
        transport_cmd = system.transport.generate_command(rng)
        if transport_cmd is not None:
            choices.append(BankTransportCmd(transport_cmd))
        return rng.choice(choices)

    def run_command(self, system: BankSystem, command):
        rng_client = system.clients[getattr(command, "amount", 0) % 2]
        if isinstance(command, DepositCmd):
            for c in system.clients:
                c.believed_balance += command.amount
            system.server.balance += command.amount
        elif isinstance(command, WithdrawCmd):
            rng_client.withdraw(command.amount)
        elif isinstance(command, BankTransportCmd):
            system.transport.run_command(command.command)
        return system

    def state_invariant(self, system: BankSystem) -> Optional[str]:
        if system.server.balance < 0:
            return f"balance went negative: {system.server.balance}"
        return None


def test_bankaccount_race_found():
    failure = Simulator(BankAccount(), run_length=60, num_runs=300).run(seed=0)
    assert failure is not None
    assert "negative" in failure.error
    assert len(failure.history) <= 12


class CorrectCounter(SimulatedSystem):
    def new_system(self, seed):
        return 0

    def generate_command(self, system, rng):
        return rng.choice([1, 2, 3])

    def run_command(self, system, command):
        return system + command

    def state_invariant(self, system):
        return None if system >= 0 else "negative"

    def get_state(self, system):
        return system

    def step_invariant(self, old, new):
        return None if new >= old else f"counter shrank: {old} -> {new}"

    def history_invariant(self, states):
        return None if list(states) == sorted(states) else "not monotone"


def test_correct_system_passes():
    simulator = Simulator(CorrectCounter(), run_length=50, num_runs=50)
    assert simulator.run() is None


def test_step_invariant_violation_detected():
    class Shrinking(CorrectCounter):
        def run_command(self, system, command):
            return system - 1 if system > 2 else system + 1

    failure = Simulator(Shrinking(), run_length=20, num_runs=5).run()
    assert failure is not None
    assert "step invariant" in failure.error


# --- (b) the protocols' Simulator cases --------------------------------------


class ProposeCmd:
    def __init__(self, client, pseudonym, key, value):
        self.client = client
        self.pseudonym = pseudonym
        self.key = key
        self.value = value

    def __repr__(self):
        return (f"Propose({self.client}, {self.pseudonym}, "
                f"{self.key}={self.value})")


class TransportCmd:
    def __init__(self, command):
        self.command = command

    def __repr__(self):
        return f"Transport({self.command!r})"


def _agreement(per_replica) -> Optional[str]:
    """Every replica that holds a vertex holds the same value for it."""
    seen: dict = {}
    for log in per_replica:
        for key, value in log.items():
            if key in seen and seen[key] != value:
                return f"replicas disagree on {key}: {seen[key]} vs {value}"
            seen[key] = value
    return None


class ProposeSim(SimulatedSystem):
    """Random conflicting writes + arbitrary deliveries/timer firings
    (the reference's ``BPaxosSimulated`` and ``EPaxosSimulated``)."""

    KEYS = ["a", "b"]

    def __init__(self, make):
        self.make = make

    def new_system(self, seed):
        transport, _, replicas, clients = self.make(seed)
        return dict(transport=transport, replicas=replicas,
                    clients=clients, counter=0)

    def generate_command(self, system, rng: random.Random):
        choices = []
        idle = [(c, p) for c, client in enumerate(system["clients"])
                for p in (0, 1) if p not in client.pending]
        if idle:
            choices.append("propose")
        transport_cmd = system["transport"].generate_command(rng)
        if transport_cmd is not None:
            choices.extend(["transport"] * 6)
        if not choices:
            return None
        if rng.choice(choices) == "propose":
            client, pseudonym = rng.choice(idle)
            system["counter"] += 1
            return ProposeCmd(client, pseudonym, rng.choice(self.KEYS),
                              str(system["counter"]))
        return TransportCmd(transport_cmd)

    def run_command(self, system, command):
        if isinstance(command, ProposeCmd):
            client = system["clients"][command.client]
            if command.pseudonym not in client.pending:
                client.propose(command.pseudonym, SER.to_bytes(
                    SetRequest(((command.key, command.value),))))
        else:
            system["transport"].run_command(command.command)
        return system


class BPaxosSimulated(ProposeSim):
    """Invariant: replicas agree on committed (value, deps) per vertex."""

    def state_invariant(self, system) -> Optional[str]:
        return _agreement(committed_log(r) for r in system["replicas"])


class EPaxosSimulated(ProposeSim):
    """Invariant: replicas agree on each committed instance's value,
    sequence number and dependencies."""

    def state_invariant(self, system) -> Optional[str]:
        return _agreement(
            {i: (t[0], t[1], tuple(sorted(t[2].materialize())))
             for i, t in committed_triples(r).items()}
            for r in system["replicas"])


def _bpaxos(backend):
    return lambda seed: make_bpaxos(num_clients=2, seed=seed,
                                    dep_backend=backend, device="cpu")


@pytest.mark.parametrize("backend,runs", [("host", 15), ("cuda", 5)])
def test_bpaxos_simulation_committed_agreement(backend, runs):
    failure = Simulator(BPaxosSimulated(_bpaxos(backend)), run_length=120,
                        num_runs=runs).run(seed=0)
    assert failure is None, str(failure)


@pytest.mark.parametrize("backend,runs", [("host", 20), ("cuda", 5)])
def test_epaxos_simulation_committed_agreement(backend, runs):
    """The two ``EPaxosSimulated`` cases of ``test_epaxos.py`` (the
    second on ``"cuda"`` where the reference's is on ``"tpu"``)."""
    failure = Simulator(EPaxosSimulated(
        lambda seed: make_epaxos(num_clients=2, seed=seed,
                                 dep_backend=backend, device="cpu")),
        run_length=120, num_runs=runs).run(seed=0)
    assert failure is None, str(failure)


# The port's copy of tests/protocols/sim_util.py's write machinery.


class WriteCmd:
    def __init__(self, client: int, pseudonym: int, payload: bytes):
        self.client = client
        self.pseudonym = pseudonym
        self.payload = payload

    def __repr__(self):
        return f"Write({self.client}, {self.pseudonym}, {self.payload!r})"


class PrefixAgreementSim(SimulatedSystem):
    """Write/transport interleaving with prefix-agreement checks;
    subclasses implement ``make_system`` and ``logs`` (or opt out of
    ``logs`` with their own ``state_invariant``)."""

    pseudonyms = (0, 1)
    transport_weight = 6

    def make_system(self, seed: int) -> dict:
        raise NotImplementedError

    def logs(self, system: dict) -> list:
        raise NotImplementedError

    def idle_writers(self, system: dict) -> list[tuple[int, int]]:
        return [(c, p) for c, client in enumerate(system["clients"])
                for p in self.pseudonyms if p not in client.pending]

    def make_write(self, system: dict, rng: random.Random) -> WriteCmd:
        client, pseudonym = rng.choice(self.idle_writers(system))
        system["counter"] += 1
        return WriteCmd(client, pseudonym, b"w%d" % system["counter"])

    def run_write(self, system: dict, command: WriteCmd) -> None:
        raise NotImplementedError

    def new_system(self, seed: int) -> dict:
        system = self.make_system(seed)
        system.setdefault("counter", 0)
        return system

    def generate_command(self, system: dict, rng: random.Random):
        choices: list = []
        if self.idle_writers(system):
            choices.append("write")
        transport_cmd = system["transport"].generate_command(rng)
        if transport_cmd is not None:
            choices.extend(["transport"] * self.transport_weight)
        if not choices:
            return None
        if rng.choice(choices) == "write":
            return self.make_write(system, rng)
        return TransportCmd(transport_cmd)

    def run_command(self, system: dict, command) -> dict:
        if isinstance(command, WriteCmd):
            self.run_write(system, command)
        else:
            system["transport"].run_command(command.command)
        return system

    def state_invariant(self, system: dict) -> Optional[str]:
        logs = self.logs(system)
        for i in range(len(logs)):
            for j in range(i + 1, len(logs)):
                n = min(len(logs[i]), len(logs[j]))
                if logs[i][:n] != logs[j][:n]:
                    return (f"logs diverge: [{i}] {logs[i]!r} vs "
                            f"[{j}] {logs[j]!r}")
        return None


class GcBPaxosSimulated(PrefixAgreementSim):
    """Proposals + GC pruning under arbitrary reordering, duplication
    and loss. Invariant: replicas agree on the committed (value, deps)
    of every vertex both still hold (GC may prune either side)."""

    transport_weight = 14
    KEYS = ["a", "b"]

    def __init__(self, backend: str = "host"):
        self.backends = (dict(dep_backend="cuda", gc_backend="cuda",
                              device="cpu") if backend == "cuda" else {})

    def make_system(self, seed):
        transport, _, _, _, replicas, clients = make_gc_bpaxos(
            send_gc_every_n=2, seed=seed, **self.backends)
        return dict(transport=transport, replicas=replicas,
                    clients=clients)

    def run_write(self, system, command: WriteCmd):
        client = system["clients"][command.client]
        if command.pseudonym not in client.pending:
            key = self.KEYS[command.pseudonym % len(self.KEYS)]
            client.propose(command.pseudonym, SER.to_bytes(
                SetRequest(((key, command.payload.decode()),))))

    def logs(self, system):
        return []  # execution order is partial; see state_invariant

    def state_invariant(self, system) -> Optional[str]:
        return _agreement(committed_log(r) for r in system["replicas"])


@pytest.mark.parametrize("backend,runs", [("host", 100), ("cuda", 20)])
def test_simulation_gc_no_divergence(backend, runs):
    failure = Simulator(GcBPaxosSimulated(backend), run_length=250,
                        num_runs=runs).run(seed=0)
    assert failure is None, str(failure)


def test_prefix_agreement_sim_requires_logs():
    """A subclass that neither implements ``logs`` nor opts out fails
    loudly (the reference's sim_util rule)."""
    class Forgetful(PrefixAgreementSim):
        make_system = GcBPaxosSimulated.make_system
        run_write = GcBPaxosSimulated.run_write
        KEYS = GcBPaxosSimulated.KEYS
        backends: dict = {}

    with pytest.raises(NotImplementedError):
        Simulator(Forgetful(), run_length=5, num_runs=1).run(seed=0)


# --- (c) one interleaving, both packages -------------------------------------


def _step(command) -> tuple:
    """A generated command without the message bytes (the packages
    encode messages differently)."""
    if isinstance(command, TransportCmd) \
            or type(command).__name__ == "TransportCmd":
        inner = command.command
        message = getattr(inner, "message", None)
        if message is not None:
            return ("deliver", message.id, message.src, message.dst)
        return ("timer", repr(inner))
    return ("propose", repr(command))


def _plain(log: dict, ser) -> dict:
    out = {}
    for vertex, (value, deps) in log.items():
        name = type(value).__name__
        key = ((value.client_address, value.client_pseudonym,
                value.client_id, repr(ser.from_bytes(value.command)))
               if name == "Command" else (name,))
        out[(int(vertex[0]), int(vertex[1]))] = (
            key, tuple((int(a), int(b)) for a, b in deps))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_same_interleaving_in_both_packages(seed):
    """The reference's ``BPaxosSimulated`` (``dep_backend="tpu"``) and
    the port's (``"cuda"`` on the CPU), each generating from the same
    seed: the transports offer the same commands, so both runs take the
    same 120 steps and end with equal committed vertices."""
    ref = jt.BPaxosSimulated(dep_backend="tpu")
    port = BPaxosSimulated(_bpaxos("cuda"))
    systems = [ref.new_system(seed), port.new_system(seed)]
    rngs = [random.Random(seed), random.Random(seed)]
    trace = [[], []]
    for _ in range(120):
        for k, sim in enumerate((ref, port)):
            command = sim.generate_command(systems[k], rngs[k])
            trace[k].append(_step(command))
            if command is not None:
                sim.run_command(systems[k], command)
    assert trace[0] == trace[1]
    for jr, pr in zip(systems[0]["replicas"], systems[1]["replicas"]):
        jlog = {v: (c.command_or_noop,
                    tuple(sorted(c.dependencies.materialize())))
                for v, c in jr.commands.items()}
        assert _plain(committed_log(pr), SER) == _plain(jlog, JSER)
        assert pr.state_machine.get() == jr.state_machine.get()
