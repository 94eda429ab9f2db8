"""Basic ping-based leader election (the port's copy of
``frankenpaxos_tpu/election/basic.py``).

Reference behavior: election/basic/Participant.scala:64-243. A
Raft-flavored rounds scheme that needs only f+1 participants but allows
multiple leaders per round (safety comes from Paxos rounds, not from the
election): a leader pings everyone periodically; a follower that misses
pings for a randomized timeout bumps the round and becomes leader;
leaders step down on pings with larger (round, leader_index) ballots.
Callbacks fire on this participant's Leader<->Follower transitions
(Participant.scala:149-165). Used by MultiPaxos/Mencius leaders
(multipaxos/Leader.scala:192-203).
"""

from __future__ import annotations

import dataclasses
import enum
import random
import time
from typing import Callable, Optional, Sequence

from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class ElectionPing:
    round: int
    leader_index: int


@dataclasses.dataclass(frozen=True)
class ForceNoPing:
    """Test/chaos hook: make a follower immediately seize leadership
    (Participant.scala:221-237)."""


@dataclasses.dataclass(frozen=True)
class ElectionOptions:
    ping_period_s: float = 30.0
    no_ping_timeout_min_s: float = 60.0
    no_ping_timeout_max_s: float = 120.0
    # Jitter tolerance (geo.RttEstimator): with ``adaptive=True`` a
    # follower derives its no-ping deadline from the OBSERVED
    # inter-ping gap distribution -- ``(srtt + 4 * dev) *
    # adaptive_multiplier`` plus its own randomized spread -- instead
    # of the fixed [min, max] window, which false-positives (a
    # spurious leadership seizure) as soon as per-link latency jitter
    # stretches a gap past the constant (tests/test_geo.py). The
    # multiplier is the lost-ping budget (3 = tolerate two lost
    # pings).
    adaptive: bool = False
    adaptive_multiplier: float = 3.0
    min_no_ping_timeout_s: float = 0.01
    # Before two pings there is no gap sample: start conservative
    # (TCP initial-RTO discipline) rather than trusting a fixed
    # window that may sit below one jittered ping gap.
    initial_no_ping_timeout_s: float = 1.0


class ElectionState(enum.Enum):
    LEADER = "leader"
    FOLLOWER = "follower"


class ElectionParticipant(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, addresses: Sequence[Address],
                 initial_leader_index: int = 0,
                 options: ElectionOptions = ElectionOptions(),
                 seed: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(address, transport, logger)
        logger.check(address in addresses)
        logger.check_le(options.no_ping_timeout_min_s,
                        options.no_ping_timeout_max_s)
        logger.check_le(0, initial_leader_index)
        logger.check_lt(initial_leader_index, len(addresses))
        self.addresses = list(addresses)
        self.index = self.addresses.index(address)
        self.options = options
        self._rng = random.Random(seed)
        # Adaptive no-ping deadlines observe inter-ping gaps against
        # this clock; sims inject virtual time (GeoSimTransport.now).
        self.clock = clock or time.monotonic
        if options.adaptive:
            from frankenpaxos_tpu_torch.geo.rtt import RttEstimator

            self._gap_estimator: Optional[RttEstimator] = RttEstimator()
        else:
            self._gap_estimator = None
        self._last_ping_at: Optional[float] = None
        self.callbacks: list[Callable[[int], None]] = []
        self.round = 0
        self.leader_index = initial_leader_index

        self.ping_timer = self.timer("ping", options.ping_period_s,
                                     self._on_ping_timer)
        no_ping_s = self._rng.uniform(options.no_ping_timeout_min_s,
                                      options.no_ping_timeout_max_s)
        if options.adaptive:
            no_ping_s = max(no_ping_s,
                            options.initial_no_ping_timeout_s)
        self.no_ping_timer = self.timer("noPing", no_ping_s,
                                        self._on_no_ping_timeout)

        if self.index == initial_leader_index:
            self.state = ElectionState.LEADER
            self.ping_timer.start()
        else:
            self.state = ElectionState.FOLLOWER
            self.no_ping_timer.start()

    # --- helpers ----------------------------------------------------------
    def register(self, callback: Callable[[int], None]) -> None:
        """Called with the new leader index on Leader<->Follower
        transitions of *this* participant."""
        self.callbacks.append(callback)

    def _ping_all(self) -> None:
        for a in self.addresses:
            if a != self.address:
                self.send(a, ElectionPing(self.round, self.index))

    def _on_ping_timer(self) -> None:
        self._ping_all()
        self.ping_timer.start()

    def _on_no_ping_timeout(self) -> None:
        self.round += 1
        self.leader_index = self.index
        self._change_state(ElectionState.LEADER)

    def _change_state(self, new_state: ElectionState) -> None:
        if self.state == new_state:
            return
        # A gap spanning a non-follower period (or a whole election
        # outage) is not an RTT sample: one would inflate the
        # deviation enough to push the adaptive deadline out for
        # minutes. Restart observation from the next ping.
        self._last_ping_at = None
        if new_state == ElectionState.LEADER:
            self.no_ping_timer.stop()
            self.ping_timer.start()
            self.state = ElectionState.LEADER
            self._ping_all()
        else:
            self.ping_timer.stop()
            self.no_ping_timer.start()
            self.state = ElectionState.FOLLOWER
        for callback in self.callbacks:
            callback(self.leader_index)

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, ElectionPing):
            self._handle_ping(message)
        elif isinstance(message, ForceNoPing):
            self._handle_force_no_ping()
        else:
            self.logger.fatal(f"unexpected election message {message!r}")

    def _observe_ping_gap(self) -> None:
        """Feed the adaptive deadline: the gap between successive
        pings from the current leader is ping_period plus one-way
        delay jitter, and ``(srtt + 4 dev) * multiplier`` bounds how
        long a silence is still ordinary."""
        if self._gap_estimator is None:
            return
        now = self.clock()
        if self._last_ping_at is not None:
            self._gap_estimator.observe(now - self._last_ping_at)
            base = self._gap_estimator.timeout(
                self.options.no_ping_timeout_min_s)
            delay = base * self.options.adaptive_multiplier
            # Keep the randomized spread (split-election avoidance)
            # proportional to the adaptive deadline.
            delay *= 1 + self._rng.uniform(0, 0.5)
            self.no_ping_timer.set_delay(
                max(self.options.min_no_ping_timeout_s, delay))
        self._last_ping_at = now

    def _handle_ping(self, ping: ElectionPing) -> None:
        ping_ballot = (ping.round, ping.leader_index)
        ballot = (self.round, self.leader_index)
        if self.state == ElectionState.FOLLOWER:
            if ping_ballot < ballot:
                self.logger.debug(f"stale ping {ping}")
            elif ping_ballot == ballot:
                self._observe_ping_gap()
                self.no_ping_timer.reset()
            else:
                # A NEW leader's first ping: the gap since the old
                # leader's last ping spans the failover, not the
                # network -- stamp without observing.
                self.round, self.leader_index = ping_ballot
                self._last_ping_at = None
                self._observe_ping_gap()
                self.no_ping_timer.reset()
        else:
            if ping_ballot <= ballot:
                self.logger.debug(f"stale ping {ping}")
            else:
                self.round, self.leader_index = ping_ballot
                self._change_state(ElectionState.FOLLOWER)

    def _handle_force_no_ping(self) -> None:
        if self.state == ElectionState.FOLLOWER:
            self.round += 1
            self.leader_index = self.index
            self._change_state(ElectionState.LEADER)
