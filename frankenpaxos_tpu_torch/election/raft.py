"""Raft-style leader election with candidate voting (the port's copy of
``frankenpaxos_tpu/election/raft.py``; the adaptive deadline is not
ported).

Reference behavior: election/raft/Participant.scala:56-430. Rounds with
at most one leader per round: followers that miss pings become
candidates in a higher round and request votes; a majority of votes
makes a leader, which pings everyone. Candidates that stall
(notEnoughVotes timeout) retry in a higher round. Callbacks fire with
the leader's address on follower transitions and on winning an election.
Used by FastMultiPaxos.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional, Sequence

from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class RaftPing:
    round: int


@dataclasses.dataclass(frozen=True)
class VoteRequest:
    round: int


@dataclasses.dataclass(frozen=True)
class Vote:
    round: int


@dataclasses.dataclass(frozen=True)
class RaftElectionOptions:
    ping_period_s: float = 1.0
    no_ping_timeout_min_s: float = 10.0
    no_ping_timeout_max_s: float = 12.0
    not_enough_votes_timeout_min_s: float = 10.0
    not_enough_votes_timeout_max_s: float = 12.0
    # The reference's no-ping deadline from observed inter-ping gaps (on
    # geo.RttEstimator) is not ported yet; True is refused.
    adaptive: bool = False
    adaptive_multiplier: float = 3.0
    min_no_ping_timeout_s: float = 0.01
    initial_no_ping_timeout_s: float = 1.0


class RaftElectionParticipant(Actor):
    """States: leaderless_follower | follower | candidate | leader."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, addresses: Sequence[Address],
                 leader: Optional[Address] = None,
                 options: RaftElectionOptions = RaftElectionOptions(),
                 seed: int = 0):
        if options.adaptive:
            raise NotImplementedError(
                "adaptive no-ping deadlines (on geo.RttEstimator) are not "
                "ported yet (ROADMAP.md queue 1 item 8.4)")
        super().__init__(address, transport, logger)
        self.addresses = list(addresses)
        logger.check(address in self.addresses)
        self.options = options
        self._rng = random.Random(seed)
        self.callbacks: list[Callable[[Address], None]] = []
        self.round = 0
        self.votes: set[Address] = set()
        self.leader_address: Optional[Address] = None
        self._timer = None

        if leader is not None:
            if leader == address:
                self.state = "leader"
                self._start_ping_timer()
            else:
                self.state = "follower"
                self.leader_address = leader
                self._start_no_ping_timer()
        else:
            self.state = "leaderless_follower"
            self._start_no_ping_timer()

    # --- timers -----------------------------------------------------------
    def _stop_timer(self) -> None:
        if self._timer is not None:
            self._timer.stop()
            self._timer = None

    def _start_ping_timer(self) -> None:
        def fire():
            for a in self.addresses:
                self.send(a, RaftPing(round=self.round))
            timer.start()

        timer = self.timer("ping", self.options.ping_period_s, fire)
        timer.start()
        self._timer = timer

    def _no_ping_delay(self) -> float:
        return self._rng.uniform(self.options.no_ping_timeout_min_s,
                                 self.options.no_ping_timeout_max_s)

    def _start_no_ping_timer(self) -> None:
        timer = self.timer("noPing", self._no_ping_delay(),
                           self._transition_to_candidate)
        timer.start()
        self._timer = timer

    def _start_not_enough_votes_timer(self) -> None:
        timer = self.timer(
            "notEnoughVotes",
            self._rng.uniform(self.options.not_enough_votes_timeout_min_s,
                              self.options.not_enough_votes_timeout_max_s),
            self._transition_to_candidate)
        timer.start()
        self._timer = timer

    # --- transitions ------------------------------------------------------
    def register(self, callback: Callable[[Address], None]) -> None:
        self.callbacks.append(callback)

    def _transition_to_follower(self, new_round: int,
                                leader: Address) -> None:
        self._stop_timer()
        self.round = new_round
        self.state = "follower"
        self.leader_address = leader
        self._start_no_ping_timer()
        for callback in self.callbacks:
            callback(leader)

    def _transition_to_candidate(self) -> None:
        self._stop_timer()
        self.round += 1
        self.state = "candidate"
        self.votes = set()
        self._start_not_enough_votes_timer()
        for a in self.addresses:
            self.send(a, VoteRequest(round=self.round))

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, RaftPing):
            self._handle_ping(src, message)
        elif isinstance(message, VoteRequest):
            self._handle_vote_request(src, message)
        elif isinstance(message, Vote):
            self._handle_vote(src, message)
        else:
            self.logger.fatal(f"unexpected election message {message!r}")

    def _handle_ping(self, src: Address, ping: RaftPing) -> None:
        if ping.round < self.round:
            return
        if ping.round > self.round:
            self._transition_to_follower(ping.round, src)
            return
        if self.state == "leaderless_follower":
            self._transition_to_follower(ping.round, src)
        elif self.state == "follower":
            self._timer.reset()
        elif self.state == "candidate":
            self._transition_to_follower(ping.round, src)
        # leader: ping from ourselves; ignore.

    def _handle_vote_request(self, src: Address,
                             request: VoteRequest) -> None:
        if request.round < self.round:
            return
        if request.round > self.round:
            self._stop_timer()
            self.round = request.round
            self.state = "leaderless_follower"
            self.leader_address = None
            self._start_no_ping_timer()
            self.send(src, Vote(round=self.round))
            return
        # Same round: only vote for ourselves as a candidate.
        if self.state == "candidate" and src == self.address:
            self.send(src, Vote(round=self.round))

    def _handle_vote(self, src: Address, vote: Vote) -> None:
        if vote.round < self.round:
            return
        self.logger.check_le(vote.round, self.round)
        if self.state != "candidate":
            return
        self.votes.add(src)
        if len(self.votes) < len(self.addresses) // 2 + 1:
            return
        self._stop_timer()
        self.state = "leader"
        self.leader_address = self.address
        self._start_ping_timer()
        for a in self.addresses:
            self.send(a, RaftPing(round=self.round))
        for callback in self.callbacks:
            callback(self.address)
