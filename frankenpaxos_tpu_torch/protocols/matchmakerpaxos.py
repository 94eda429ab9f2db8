"""MatchmakerPaxos: single-decree Paxos with matchmade configurations (the
port's copy of ``frankenpaxos_tpu/protocols/matchmakerpaxos.py``; every
role runs on the host).

Reference behavior: matchmakerpaxos/ (Leader.scala:35-560,
Matchmaker.scala:32-200, Acceptor.scala:30-210, Config.scala). A leader
is free to pick ANY quorum system of acceptors per round; 2f+1
matchmakers store the per-round configurations. To run round r the
leader:

  1. Matchmaking: sends its chosen quorum system to the matchmakers; a
     quorum of f+1 MatchReplies returns every configuration adopted in
     earlier rounds (monotone: a matchmaker nacks rounds <= its largest).
  2. Phase1: reads a read quorum of EVERY pending earlier configuration
     (the union of one read quorum per round), adopting the
     highest-vote-round value found.
  3. Phase2: writes a write quorum of its own configuration.

The per-round quorum systems are the "quorum-matrix reshape" shape that
ops/quorum.py's MultiConfigQuorumChecker evaluates on the card for
Matchmaker MultiPaxos; this single-decree leader checks them on the host,
as the reference does.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from frankenpaxos_tpu_torch.quorums import (
    quorum_system_from_dict,
    quorum_system_to_dict,
    QuorumSystem,
    SimpleMajority,
)
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class MatchmakerPaxosConfig:
    f: int
    leader_addresses: tuple
    matchmaker_addresses: tuple
    acceptor_addresses: tuple

    @property
    def quorum_size(self) -> int:
        return self.f + 1

    def check_valid(self) -> None:
        if self.f < 1:
            raise ValueError("f must be >= 1")
        if len(self.leader_addresses) < self.f + 1:
            raise ValueError("need >= f+1 leaders")
        if len(self.matchmaker_addresses) != 2 * self.f + 1:
            raise ValueError("need exactly 2f+1 matchmakers")
        if len(self.acceptor_addresses) < self.f + 1:
            raise ValueError("need >= f+1 acceptors")


@dataclasses.dataclass(frozen=True)
class AcceptorGroup:
    round: int
    quorum_system: dict  # wire form of a QuorumSystem over acceptor indices


@dataclasses.dataclass(frozen=True)
class ClientRequest:
    v: str


@dataclasses.dataclass(frozen=True)
class ClientReply:
    chosen: str


@dataclasses.dataclass(frozen=True)
class MatchRequest:
    acceptor_group: AcceptorGroup


@dataclasses.dataclass(frozen=True)
class MatchReply:
    round: int
    matchmaker_index: int
    acceptor_groups: tuple[AcceptorGroup, ...]


@dataclasses.dataclass(frozen=True)
class Phase1a:
    round: int


@dataclasses.dataclass(frozen=True)
class Phase1bVote:
    vote_round: int
    vote_value: str


@dataclasses.dataclass(frozen=True)
class Phase1b:
    round: int
    acceptor_index: int
    vote: Optional[Phase1bVote]


@dataclasses.dataclass(frozen=True)
class Phase2a:
    round: int
    value: str


@dataclasses.dataclass(frozen=True)
class Phase2b:
    round: int
    acceptor_index: int


@dataclasses.dataclass(frozen=True)
class MatchmakerNack:
    round: int


@dataclasses.dataclass(frozen=True)
class AcceptorNack:
    round: int


@dataclasses.dataclass
class _Matchmaking:
    v: str
    quorum_system: QuorumSystem
    match_replies: dict[int, MatchReply]


@dataclasses.dataclass
class _Phase1:
    v: str
    quorum_system: QuorumSystem
    previous_quorum_systems: dict[int, QuorumSystem]
    acceptor_to_rounds: dict[int, set[int]]
    pending_rounds: set[int]
    phase1bs: dict[int, Phase1b]


@dataclasses.dataclass
class _Phase2:
    v: str
    quorum_system: QuorumSystem
    phase2bs: dict[int, Phase2b]


@dataclasses.dataclass
class _Chosen:
    v: str


class MatchmakerPaxosLeader(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerPaxosConfig,
                 seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.index = list(config.leader_addresses).index(address)
        self.round_system = ClassicRoundRobin(len(config.leader_addresses))
        self.round = -1
        self.state: object = None  # Inactive
        self.waiting_clients: list[Address] = []

    def _random_quorum_system(self) -> QuorumSystem:
        """A random f+1 subset under simple majorities
        (Config.scala comment: any quorum system works)."""
        indices = self.rng.sample(range(len(self.config.acceptor_addresses)),
                                  self.config.f + 1)
        return SimpleMajority(indices)

    def _start_matchmaking(self, new_round: int, v: str) -> None:
        self.round = new_round
        quorum_system = self._random_quorum_system()
        request = MatchRequest(AcceptorGroup(
            round=self.round,
            quorum_system=quorum_system_to_dict(quorum_system)))
        for matchmaker in self.config.matchmaker_addresses:
            self.send(matchmaker, request)
        self.state = _Matchmaking(v=v, quorum_system=quorum_system,
                                  match_replies={})

    def receive(self, src: Address, message) -> None:
        if isinstance(message, ClientRequest):
            self._handle_client_request(src, message)
        elif isinstance(message, MatchReply):
            self._handle_match_reply(src, message)
        elif isinstance(message, Phase1b):
            self._handle_phase1b(src, message)
        elif isinstance(message, Phase2b):
            self._handle_phase2b(src, message)
        elif isinstance(message, (MatchmakerNack, AcceptorNack)):
            self._handle_nack(message.round)
        else:
            self.logger.fatal(f"unexpected leader message {message!r}")

    def _handle_client_request(self, src: Address,
                               request: ClientRequest) -> None:
        if isinstance(self.state, _Chosen):
            self.send(src, ClientReply(chosen=self.state.v))
            return
        # Clients force liveness by restarting the protocol
        # (Leader.scala:279-318).
        self.round = self.round_system.next_classic_round(self.index,
                                                          self.round)
        self._start_matchmaking(self.round, request.v)
        self.waiting_clients.append(src)

    def _handle_match_reply(self, src: Address, reply: MatchReply) -> None:
        if not isinstance(self.state, _Matchmaking):
            return
        state = self.state
        if reply.round != self.round:
            self.logger.check_lt(reply.round, self.round)
            return
        state.match_replies[reply.matchmaker_index] = reply
        if len(state.match_replies) < self.config.quorum_size:
            return

        # Collect every configuration from earlier rounds; we must read a
        # read quorum of each (Leader.scala:321-446).
        pending_rounds: set[int] = set()
        previous: dict[int, QuorumSystem] = {}
        acceptor_indices: set[int] = set()
        acceptor_to_rounds: dict[int, set[int]] = {}
        for r in state.match_replies.values():
            for group in r.acceptor_groups:
                pending_rounds.add(group.round)
                qs = quorum_system_from_dict(group.quorum_system)
                previous[group.round] = qs
                acceptor_indices |= qs.random_read_quorum(self.rng)
                for idx in qs.nodes():
                    acceptor_to_rounds.setdefault(idx, set()).add(group.round)

        if not pending_rounds:
            # Nothing was ever configured before: go straight to phase 2.
            self._start_phase2(state.v, state.quorum_system)
            return
        for idx in acceptor_indices:
            self.send(self.config.acceptor_addresses[idx],
                      Phase1a(round=self.round))
        self.state = _Phase1(
            v=state.v, quorum_system=state.quorum_system,
            previous_quorum_systems=previous,
            acceptor_to_rounds=acceptor_to_rounds,
            pending_rounds=pending_rounds, phase1bs={})

    def _start_phase2(self, v: str, quorum_system: QuorumSystem) -> None:
        for idx in quorum_system.random_write_quorum(self.rng):
            self.send(self.config.acceptor_addresses[idx],
                      Phase2a(round=self.round, value=v))
        self.state = _Phase2(v=v, quorum_system=quorum_system, phase2bs={})

    def _handle_phase1b(self, src: Address, phase1b: Phase1b) -> None:
        if not isinstance(self.state, _Phase1):
            return
        state = self.state
        if phase1b.round != self.round:
            self.logger.check_lt(phase1b.round, self.round)
            return
        state.phase1bs[phase1b.acceptor_index] = phase1b
        # A round stops pending once a read quorum of its configuration
        # responded.
        for r in list(state.acceptor_to_rounds.get(phase1b.acceptor_index,
                                                   ())):
            if r in state.pending_rounds and state.previous_quorum_systems[
                    r].is_superset_of_read_quorum(set(state.phase1bs)):
                state.pending_rounds.discard(r)
        if state.pending_rounds:
            return
        votes = [p.vote for p in state.phase1bs.values()
                 if p.vote is not None]
        v = (state.v if not votes
             else max(votes, key=lambda vote: vote.vote_round).vote_value)
        self._start_phase2(v, state.quorum_system)

    def _handle_phase2b(self, src: Address, phase2b: Phase2b) -> None:
        if not isinstance(self.state, _Phase2):
            return
        state = self.state
        if phase2b.round != self.round:
            self.logger.check_lt(phase2b.round, self.round)
            return
        state.phase2bs[phase2b.acceptor_index] = phase2b
        if not state.quorum_system.is_superset_of_write_quorum(
                set(state.phase2bs)):
            return
        for client in self.waiting_clients:
            self.send(client, ClientReply(chosen=state.v))
        self.waiting_clients.clear()
        self.state = _Chosen(v=state.v)

    def _handle_nack(self, nack_round: int) -> None:
        if nack_round <= self.round or self.state is None \
                or isinstance(self.state, _Chosen):
            return
        self.round = self.round_system.next_classic_round(self.index,
                                                          nack_round)
        self._start_matchmaking(self.round, self.state.v)


class Matchmaker(Actor):
    """Stores per-round configurations; replies with all earlier ones
    (Matchmaker.scala:120-180). Monotone: nacks rounds <= the largest
    seen."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerPaxosConfig):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.index = list(config.matchmaker_addresses).index(address)
        self.acceptor_groups: dict[int, AcceptorGroup] = {}

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, MatchRequest):
            self.logger.fatal(f"unexpected matchmaker message {message!r}")
        round = message.acceptor_group.round
        if self.acceptor_groups and round <= max(self.acceptor_groups):
            self.send(src, MatchmakerNack(round=max(self.acceptor_groups)))
            return
        self.send(src, MatchReply(
            round=round, matchmaker_index=self.index,
            acceptor_groups=tuple(
                self.acceptor_groups[r]
                for r in sorted(self.acceptor_groups))))
        self.acceptor_groups[round] = message.acceptor_group


class MatchmakerPaxosAcceptor(Actor):
    """(matchmakerpaxos/Acceptor.scala:30-210)."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerPaxosConfig):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.index = list(config.acceptor_addresses).index(address)
        self.round = -1
        self.vote_round = -1
        self.vote_value: Optional[str] = None

    def receive(self, src: Address, message) -> None:
        if isinstance(message, Phase1a):
            if message.round < self.round:
                self.send(src, AcceptorNack(round=self.round))
                return
            self.round = message.round
            vote = (Phase1bVote(self.vote_round, self.vote_value)
                    if self.vote_value is not None else None)
            self.send(src, Phase1b(round=message.round,
                                   acceptor_index=self.index, vote=vote))
        elif isinstance(message, Phase2a):
            if message.round < self.round:
                self.send(src, AcceptorNack(round=self.round))
                return
            self.round = message.round
            self.vote_round = message.round
            self.vote_value = message.value
            self.send(src, Phase2b(round=message.round,
                                   acceptor_index=self.index))
        else:
            self.logger.fatal(f"unexpected acceptor message {message!r}")


class MatchmakerPaxosClient(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerPaxosConfig,
                 repropose_period_s: float = 10.0, seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.proposed_value: Optional[str] = None
        self.chosen_value: Optional[str] = None
        self.callbacks: list[Callable[[str], None]] = []
        self.repropose_timer = self.timer("repropose", repropose_period_s,
                                          self._repropose)

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
        self._send()
        self.repropose_timer.start()

    def _send(self) -> None:
        leader = self.config.leader_addresses[
            self.rng.randrange(len(self.config.leader_addresses))]
        self.send(leader, ClientRequest(v=self.proposed_value))

    def _repropose(self) -> None:
        if self.chosen_value is None and self.proposed_value is not None:
            self._send()
            self.repropose_timer.start()

    def _deliver(self) -> None:
        for cb in self.callbacks:
            cb(self.chosen_value)
        self.callbacks.clear()

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, ClientReply):
            self.logger.fatal(f"unexpected client message {message!r}")
        if self.chosen_value is None:
            self.chosen_value = message.chosen
            self.repropose_timer.stop()
        self._deliver()


# Importing for side effect: registers this protocol's binary wire
# codecs with the default serializer (see baseline_wire.py).
from frankenpaxos_tpu_torch.protocols import baseline_wire  # noqa: E402,F401
