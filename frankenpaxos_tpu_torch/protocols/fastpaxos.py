"""Single-decree Fast Paxos (the port's copy of
``frankenpaxos_tpu/protocols/fastpaxos.py``).

Reference behavior: fastpaxos/ (Leader.scala:32-260, Acceptor.scala:30-150,
Client.scala:40-200, Config.scala). Round 0 is the fast round: leader 0
pre-runs Phase1 and issues the distinguished "any" value; clients then
propose directly to acceptors, who vote and reply straight to the client.
A fast quorum (f + floor((f+1)/2) + 1 ... here ``f + majority-of-quorum``)
of matching votes chooses. On conflict or recovery, classic rounds > 0
run through leaders with fast-round vote recovery (the
popular-items/majority-of-quorum rule, Leader.scala:150-190).

The leader's and the client's quorum checks run on the host
(``quorum_backend="host"``) or on K6's stateless check
(``quorum_backend="cuda"``, on ``device``: the card when None, ``"cpu"``
for the plain version), one staged call a check
(``runs/quorums.py::SpecChecker``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from frankenpaxos_tpu_torch.runs.quorums import (
    fast_flexible_specs,
    SpecChecker,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class FastPaxosConfig:
    f: int
    leader_addresses: tuple
    acceptor_addresses: tuple

    @property
    def n(self) -> int:
        return 2 * self.f + 1

    @property
    def classic_quorum_size(self) -> int:
        return self.f + 1

    @property
    def quorum_majority_size(self) -> int:
        return (self.f + 1) // 2 + 1

    @property
    def fast_quorum_size(self) -> int:
        return self.f + self.quorum_majority_size

    def check_valid(self) -> None:
        if len(self.leader_addresses) < self.f + 1:
            raise ValueError("need >= f+1 leaders")
        if len(self.acceptor_addresses) != self.n:
            raise ValueError("need exactly 2f+1 acceptors")


@dataclasses.dataclass(frozen=True)
class ProposeRequest:
    v: str


@dataclasses.dataclass(frozen=True)
class ProposeReply:
    chosen: str


@dataclasses.dataclass(frozen=True)
class Phase1a:
    round: int


@dataclasses.dataclass(frozen=True)
class Phase1b:
    round: int
    acceptor_id: int
    vote_round: int
    vote_value: Optional[str]


@dataclasses.dataclass(frozen=True)
class Phase2a:
    round: int
    # None is the distinguished "any" value (fast round only).
    value: Optional[str]


@dataclasses.dataclass(frozen=True)
class Phase2b:
    acceptor_id: int
    round: int


class FastPaxosLeader(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: FastPaxosConfig,
                 quorum_backend: str = "host", device=None):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        # Quorum predicates in matrix form, sized from the LIVE config
        # (runs/quorums.py): recovery adopts a fast-round value exactly
        # when fast-quorum intersection demands it (>= q1 + qf - n
        # votes among the phase-1 replies).
        specs = fast_flexible_specs(config.n, config.classic_quorum_size,
                                    config.fast_quorum_size)
        self.classic_quorum = SpecChecker(
            specs.classic, quorum_backend,
            metrics=lambda: transport.runtime_metrics, device=device)
        self.recovery_quorum = SpecChecker(
            specs.recovery, quorum_backend,
            metrics=lambda: transport.runtime_metrics, device=device)
        self.index = list(config.leader_addresses).index(address)
        self.round = self.index
        self.status = "idle"
        self.proposed_value: Optional[str] = None
        self.phase1b_responses: dict[int, Phase1b] = {}
        self.phase2b_responses: dict[int, Phase2b] = {}
        self.chosen_value: Optional[str] = None
        self.waiting_clients: list[Address] = []
        # Leader of the fast round starts Phase1 immediately
        # (Leader.scala:77-84).
        if self.round == 0:
            for acceptor in config.acceptor_addresses:
                self.send(acceptor, Phase1a(round=self.round))
            self.status = "phase1"

    def receive(self, src: Address, message) -> None:
        if isinstance(message, ProposeRequest):
            self._handle_propose_request(src, message)
        elif isinstance(message, Phase1b):
            self._handle_phase1b(src, message)
        elif isinstance(message, Phase2b):
            self._handle_phase2b(src, message)
        else:
            self.logger.fatal(f"unexpected leader message {message!r}")

    def _handle_propose_request(self, src: Address,
                                request: ProposeRequest) -> None:
        if self.chosen_value is not None:
            self.send(src, ProposeReply(self.chosen_value))
            return
        if self.status == "idle":
            n = len(self.config.leader_addresses)
            self.round += n
            self.proposed_value = request.v
            self.status = "phase1"
            self.phase1b_responses.clear()
            self.phase2b_responses.clear()
            for acceptor in self.config.acceptor_addresses:
                self.send(acceptor, Phase1a(round=self.round))
        self.waiting_clients.append(src)

    def _handle_phase1b(self, src: Address, response: Phase1b) -> None:
        if self.status != "phase1" or response.round != self.round:
            return
        self.phase1b_responses[response.acceptor_id] = response
        if not self.classic_quorum.check(self.phase1b_responses):
            return
        k = max(r.vote_round for r in self.phase1b_responses.values())
        if k == -1:
            value = self.proposed_value  # may be None -> "any"
        elif k > 0:
            # Classic round: a single vote value.
            values = {r.vote_value for r in self.phase1b_responses.values()
                      if r.vote_round == k}
            self.logger.check_eq(len(values), 1)
            value = next(iter(values))
            self.proposed_value = value
        else:
            # Fast round: a value the fast quorum may have chosen is one
            # whose voters intersect every fast quorum -- the recovery
            # spec (Leader.scala:168-185; runs/quorums.py). Under a
            # valid configuration at most one value can be popular; an
            # ambiguity means the config violates the fast intersection
            # condition, and adoption is not forced, so the leader keeps
            # its own value (the divergence stays observable to sims).
            voters: dict[Optional[str], list[int]] = {}
            for r in self.phase1b_responses.values():
                if r.vote_round == 0:
                    voters.setdefault(r.vote_value, []).append(
                        r.acceptor_id)
            popular = [v for v, ids in voters.items()
                       if self.recovery_quorum.check(ids)]
            if len(popular) == 1:
                value = popular[0]
                self.proposed_value = value
            else:
                value = self.proposed_value
        for acceptor in self.config.acceptor_addresses:
            self.send(acceptor, Phase2a(round=self.round, value=value))
        self.status = "phase2"

    def _handle_phase2b(self, src: Address, response: Phase2b) -> None:
        self.logger.check_gt(response.round, 0)
        if self.status != "phase2" or response.round != self.round:
            return
        self.phase2b_responses[response.acceptor_id] = response
        if not self.classic_quorum.check(self.phase2b_responses):
            return
        self.logger.check(self.proposed_value is not None)
        chosen = self.proposed_value
        if self.chosen_value is not None:
            self.logger.check_eq(self.chosen_value, chosen)
        self.chosen_value = chosen
        self.status = "chosen"
        for client in self.waiting_clients:
            self.send(client, ProposeReply(chosen=chosen))
        self.waiting_clients.clear()


class FastPaxosAcceptor(Actor):
    """(fastpaxos/Acceptor.scala:30-150). ``any_round`` records receipt of
    the distinguished any value: the next client proposal is voted for
    directly, with the Phase2b going to the *client*."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: FastPaxosConfig):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.index = list(config.acceptor_addresses).index(address)
        self.round = -1
        self.vote_round = -1
        self.vote_value: Optional[str] = None
        self.any_round: Optional[int] = None

    def receive(self, src: Address, message) -> None:
        if isinstance(message, ProposeRequest):
            self._handle_propose_request(src, message)
        elif isinstance(message, Phase1a):
            self._handle_phase1a(src, message)
        elif isinstance(message, Phase2a):
            self._handle_phase2a(src, message)
        else:
            self.logger.fatal(f"unexpected acceptor message {message!r}")

    def _handle_propose_request(self, src: Address,
                                request: ProposeRequest) -> None:
        if self.any_round is None:
            return
        r = self.any_round
        if self.round <= r and self.vote_round < r:
            self.round = r
            self.vote_round = r
            self.vote_value = request.v
            self.any_round = None
            self.send(src, Phase2b(acceptor_id=self.index, round=r))

    def _handle_phase1a(self, src: Address, phase1a: Phase1a) -> None:
        if phase1a.round <= self.round:
            return
        self.round = phase1a.round
        self.send(src, Phase1b(round=self.round, acceptor_id=self.index,
                               vote_round=self.vote_round,
                               vote_value=self.vote_value))

    def _handle_phase2a(self, src: Address, phase2a: Phase2a) -> None:
        if phase2a.round < self.round:
            return
        if phase2a.round == self.round and phase2a.round == self.vote_round:
            return
        if phase2a.value is not None:
            self.round = phase2a.round
            self.vote_round = phase2a.round
            self.vote_value = phase2a.value
            self.any_round = None
            self.send(src, Phase2b(acceptor_id=self.index, round=self.round))
        else:
            # The distinguished any value (fast round 0 only).
            if phase2a.round == 0:
                self.any_round = 0


class FastPaxosClient(Actor):
    """(fastpaxos/Client.scala:40-200): proposes straight to acceptors;
    collects fast-quorum Phase2bs itself; falls back to leaders via a
    repropose timer."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: FastPaxosConfig,
                 repropose_period_s: float = 10.0,
                 quorum_backend: str = "host", device=None):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.fast_quorum = SpecChecker(
            fast_flexible_specs(config.n, config.classic_quorum_size,
                                config.fast_quorum_size).fast,
            quorum_backend,
            metrics=lambda: transport.runtime_metrics, device=device)
        self.proposed_value: Optional[str] = None
        self.chosen_value: Optional[str] = None
        self.phase2b_responses: dict[int, Phase2b] = {}
        self.callbacks: list[Callable[[str], None]] = []
        self.repropose_timer = self.timer(
            "repropose", repropose_period_s, self._repropose)

    def propose(self, v: str,
                callback: Optional[Callable[[str], None]] = None) -> None:
        if callback is not None:
            self.callbacks.append(callback)
        if self.chosen_value is not None:
            self._deliver()
            return
        if self.proposed_value is not None:
            return
        self.proposed_value = v
        for acceptor in self.config.acceptor_addresses:
            self.send(acceptor, ProposeRequest(v=v))
        self.repropose_timer.start()

    def _repropose(self) -> None:
        if self.chosen_value is not None or self.proposed_value is None:
            return
        # Fall back to the classic path through the leaders.
        for leader in self.config.leader_addresses:
            self.send(leader, ProposeRequest(v=self.proposed_value))
        self.repropose_timer.start()

    def _deliver(self) -> None:
        for cb in self.callbacks:
            cb(self.chosen_value)
        self.callbacks.clear()

    def _choose(self, chosen: str) -> None:
        if self.chosen_value is not None:
            self.logger.check_eq(self.chosen_value, chosen)
            return
        self.chosen_value = chosen
        self.repropose_timer.stop()
        self._deliver()

    def receive(self, src: Address, message) -> None:
        if isinstance(message, ProposeReply):
            self._choose(message.chosen)
        elif isinstance(message, Phase2b):
            self.logger.check_eq(message.round, 0)
            self.phase2b_responses[message.acceptor_id] = message
            if not self.fast_quorum.check(self.phase2b_responses):
                return
            self.logger.check(self.proposed_value is not None)
            self._choose(self.proposed_value)
        else:
            self.logger.fatal(f"unexpected client message {message!r}")


# Importing for side effect: registers this protocol's binary wire
# codecs with the default serializer (see baseline_wire.py).
from frankenpaxos_tpu_torch.protocols import baseline_wire  # noqa: E402,F401
