"""Fast MultiPaxos: a log of fast and classic rounds (the port's copy of
``frankenpaxos_tpu/protocols/fastmultipaxos.py``).

Reference behavior: fastmultipaxos/ (Leader.scala:35-1350,
Acceptor.scala:60-520, Config.scala). In a fast round, the leader sends
acceptors a distinguished "anySuffix" after phase 1; acceptors then vote
directly for client ProposeRequests in their next open slot, and the
leader collects Phase2bs:

  * fast ready: some value has fastQuorumSize (= f + majority-of-f+1)
    votes -> chosen;
  * fast stuck: no value can still reach a fast quorum -> coordinated
    recovery via the next (classic) round;
  * classic rounds work like MultiPaxos with explicit Phase2as.

Phase-1 recovery uses Fast Paxos's rule: at the max vote round k, a
unique value wins; else a value with >= majority-of-quorum votes wins;
else any (noop). Chosen values are gossiped to other leaders
(ValueChosen) so standbys maintain the log. Election is raft-style
(election/raft).

Liveness/performance knobs:
  * thrifty quorums (Leader.scala:464-500): the leader sends Phase1as
    and classic Phase2as to only quorum-size acceptors chosen by a
    ThriftySystem (with the reference's placeholder uniform delays);
  * wait/stagger buffering (Acceptor.scala:60-90, 200-230): acceptors
    optionally buffer direct client proposals and process them in
    deterministically-sorted batches every wait_period, a heuristic
    that cuts fast-path conflicts; resulting Phase2bs travel in one
    Phase2bBuffer.

The leader's classic, fast and recovery checks run on the host
(``quorum_backend="host"``) or on K6's stateless check
(``quorum_backend="cuda"``, on ``FastMultiPaxosLeaderOptions.device``:
the card when None, ``"cpu"`` for the plain version), one staged call a
check (``runs/quorums.py::SpecChecker``).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Union

from frankenpaxos_tpu_torch.election.raft import (
    RaftElectionOptions,
    RaftElectionParticipant,
)
from frankenpaxos_tpu_torch.heartbeat import (
    HeartbeatOptions,
    HeartbeatParticipant,
)
from frankenpaxos_tpu_torch.roundsystem import RoundSystem, RoundType
from frankenpaxos_tpu_torch.runs.quorums import (
    fast_flexible_specs,
    SpecChecker,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.statemachine import StateMachine
from frankenpaxos_tpu_torch.thrifty import ThriftySystem


@dataclasses.dataclass(frozen=True)
class FastMultiPaxosConfig:
    f: int
    leader_addresses: tuple
    leader_election_addresses: tuple
    leader_heartbeat_addresses: tuple
    acceptor_addresses: tuple
    acceptor_heartbeat_addresses: tuple
    round_system: RoundSystem

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

    def quorum_size(self, round: int) -> int:
        if self.round_system.round_type(round) == RoundType.FAST:
            return self.fast_quorum_size
        return self.classic_quorum_size


@dataclasses.dataclass(frozen=True)
class CommandId:
    client_address: Address
    client_id: int


@dataclasses.dataclass(frozen=True)
class Command:
    command_id: CommandId
    command: bytes


@dataclasses.dataclass(frozen=True)
class Noop:
    pass


NOOP = Noop()
Value = Union[Command, Noop]


@dataclasses.dataclass(frozen=True)
class ProposeRequest:
    command: Command


@dataclasses.dataclass(frozen=True)
class ProposeReply:
    command_id: CommandId
    result: bytes
    # The replying leader's round: clients track it to route classic-
    # round proposals to the right leader (Client.scala:92-103, :182).
    round: int = 0


@dataclasses.dataclass(frozen=True)
class Phase1a:
    round: int
    chosen_watermark: int
    chosen_slots: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Phase1bVote:
    slot: int
    vote_round: int
    value: Value


@dataclasses.dataclass(frozen=True)
class Phase1b:
    acceptor_id: int
    round: int
    votes: tuple[Phase1bVote, ...]


@dataclasses.dataclass(frozen=True)
class Phase1bNack:
    acceptor_id: int
    round: int


@dataclasses.dataclass(frozen=True)
class Phase2a:
    slot: int
    round: int
    # A concrete value, or "any" markers (fast rounds only).
    value: Optional[Value] = None
    any: bool = False
    any_suffix: bool = False


@dataclasses.dataclass(frozen=True)
class Phase2b:
    acceptor_id: int
    slot: int
    round: int
    vote: Value


@dataclasses.dataclass(frozen=True)
class Phase2bBuffer:
    """A batch of Phase2bs from one acceptor drain
    (Acceptor.scala:215-229)."""

    phase2bs: tuple[Phase2b, ...]


@dataclasses.dataclass(frozen=True)
class ValueChosen:
    slot: int
    value: Value


@dataclasses.dataclass
class _AcceptorEntry:
    vote_round: int = -1
    vote_value: Optional[Value] = None
    any_round: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FastMultiPaxosAcceptorOptions:
    """Conflict-avoidance buffering of direct client proposals
    (AcceptorOptions, Acceptor.scala:60-90). With both zero, proposals
    are processed immediately."""

    wait_period_s: float = 0.0
    wait_stagger_s: float = 0.0


class FastMultiPaxosAcceptor(Actor):
    """(fastmultipaxos/Acceptor.scala:60-520)."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: FastMultiPaxosConfig,
                 options: FastMultiPaxosAcceptorOptions =
                 FastMultiPaxosAcceptorOptions(),
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        self.clock = clock
        self.acceptor_id = list(config.acceptor_addresses).index(address)
        self.round = -1
        self.log: dict[int, _AcceptorEntry] = {}
        self.next_slot = 0
        # An "anySuffix" round covers every slot >= its start.
        self.any_suffix: Optional[tuple[int, int]] = None  # (slot, round)
        self.heartbeat = HeartbeatParticipant(
            config.acceptor_heartbeat_addresses[self.acceptor_id], transport,
            logger, list(config.acceptor_heartbeat_addresses),
            HeartbeatOptions())
        # Wait/stagger buffering (Acceptor.scala:140-160).
        self.buffered_proposals: list[
            tuple[float, Address, ProposeRequest]] = []
        self._wait_timer = None
        if options.wait_period_s > 0 or options.wait_stagger_s > 0:
            def process():
                self._process_buffered_proposals()
                self._wait_timer.start()

            self._wait_timer = self.timer(
                "processBufferedProposeRequests", options.wait_period_s,
                process)
            self._wait_timer.start()

    def _entry(self, slot: int) -> _AcceptorEntry:
        entry = self.log.get(slot)
        if entry is None:
            entry = _AcceptorEntry()
            if self.any_suffix is not None \
                    and slot >= self.any_suffix[0]:
                entry.any_round = self.any_suffix[1]
            self.log[slot] = entry
        return entry

    def _leader_of(self, round: int) -> Address:
        return self.config.leader_addresses[
            self.config.round_system.leader(round)]

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
        if self._wait_timer is not None:
            self.buffered_proposals.append((self.clock(), src, request))
            return
        phase2b = self._process_propose_request(src, request)
        if phase2b is not None:
            self.send(self._leader_of(self.round), phase2b)

    def _process_propose_request(self, src: Address,
                                 request: ProposeRequest
                                 ) -> Optional[Phase2b]:
        """Vote directly in our next open slot iff it carries the current
        round's any marker (Acceptor.scala:220-236)."""
        entry = self._entry(self.next_slot)
        if entry.any_round == self.round and entry.vote_round < self.round:
            entry.vote_round = self.round
            entry.vote_value = request.command
            entry.any_round = None
            phase2b = Phase2b(acceptor_id=self.acceptor_id,
                              slot=self.next_slot, round=self.round,
                              vote=request.command)
            self.next_slot += 1
            return phase2b
        return None

    def _process_buffered_proposals(self) -> None:
        """Drain proposals older than the stagger cutoff in a
        deterministic order (processBufferedProposeRequests,
        Acceptor.scala:200-230): identically-configured acceptors that
        buffered the same conflicting proposals vote on them in the
        same order, avoiding fast-path conflicts."""
        cutoff = self.clock() - self.options.wait_stagger_s
        take = 0
        while take < len(self.buffered_proposals) \
                and self.buffered_proposals[take][0] <= cutoff:
            take += 1
        batch = self.buffered_proposals[:take]
        del self.buffered_proposals[:take]
        phase2bs = []
        # Deterministic (hash-seed independent) sort key.
        for _, src, request in sorted(
                batch,
                key=lambda b: (repr(b[1]),
                               repr(b[2].command.command_id),
                               b[2].command.command)):
            phase2b = self._process_propose_request(src, request)
            if phase2b is not None:
                phase2bs.append(phase2b)
        if phase2bs:
            self.send(self._leader_of(self.round),
                      Phase2bBuffer(tuple(phase2bs)))

    def _handle_phase1a(self, src: Address, phase1a: Phase1a) -> None:
        if phase1a.round <= self.round:
            self.send(src, Phase1bNack(acceptor_id=self.acceptor_id,
                                       round=self.round))
            return
        self.round = phase1a.round
        votes = tuple(
            Phase1bVote(slot=slot, vote_round=entry.vote_round,
                        value=entry.vote_value)
            for slot, entry in sorted(self.log.items())
            if slot >= phase1a.chosen_watermark
            and slot not in phase1a.chosen_slots
            and entry.vote_value is not None)
        self.send(self._leader_of(self.round),
                  Phase1b(acceptor_id=self.acceptor_id, round=self.round,
                          votes=votes))

    def _handle_phase2a(self, src: Address, phase2a: Phase2a) -> None:
        """(Acceptor.scala processPhase2a)."""
        if phase2a.round < self.round:
            return
        if phase2a.any_suffix:
            self.round = phase2a.round
            self.any_suffix = (phase2a.slot, phase2a.round)
            for slot, entry in self.log.items():
                if slot >= phase2a.slot:
                    entry.any_round = phase2a.round
            if self.next_slot < phase2a.slot:
                self.next_slot = phase2a.slot
            return
        if phase2a.any:
            self.round = phase2a.round
            self._entry(phase2a.slot).any_round = phase2a.round
            return
        entry = self._entry(phase2a.slot)
        if phase2a.round == entry.vote_round:
            # Already voted this round; re-relay for liveness.
            self.send(self._leader_of(self.round),
                      Phase2b(acceptor_id=self.acceptor_id,
                              slot=phase2a.slot, round=entry.vote_round,
                              vote=entry.vote_value))
            return
        self.round = phase2a.round
        entry.vote_round = phase2a.round
        entry.vote_value = phase2a.value
        entry.any_round = None
        if phase2a.slot >= self.next_slot:
            self.next_slot = phase2a.slot + 1
        self.send(self._leader_of(self.round),
                  Phase2b(acceptor_id=self.acceptor_id, slot=phase2a.slot,
                          round=phase2a.round, vote=phase2a.value))


@dataclasses.dataclass
class _Phase1State:
    phase1bs: dict[int, Phase1b]
    pending_proposals: list[tuple[Address, Command]]


@dataclasses.dataclass
class _Phase2State:
    pending_entries: dict[int, Value]
    phase2bs: dict[int, dict[int, Phase2b]]


@dataclasses.dataclass(frozen=True)
class FastMultiPaxosLeaderOptions:
    """LeaderOptions (Leader.scala:30-60). ``thrifty_system`` None
    means send to every acceptor."""

    thrifty_system: Optional[ThriftySystem] = None
    resend_phase1as_period_s: float = 5.0
    # Also the fast-stuck detection period: a fast round that makes no
    # progress for a full period falls back to a classic round.
    resend_phase2as_period_s: float = 5.0
    # "host": NumPy quorum-spec evaluation; "cuda": K6's stateless check
    # on ``device`` (runs/quorums.SpecChecker) -- bit-identical
    # predicates. ``device`` None is the card; "cpu" the plain version.
    quorum_backend: str = "host"
    device: Optional[str] = None


class FastMultiPaxosLeader(Actor):
    """(fastmultipaxos/Leader.scala:35-1350)."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: FastMultiPaxosConfig,
                 state_machine: StateMachine,
                 options: FastMultiPaxosLeaderOptions =
                 FastMultiPaxosLeaderOptions(),
                 election_options: RaftElectionOptions =
                 RaftElectionOptions(), seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        self.state_machine = state_machine
        self.rng = random.Random(seed)
        # Classic/fast/recovery predicates in matrix form, sized from
        # the LIVE config (runs/quorums.py).
        specs = fast_flexible_specs(config.n, config.classic_quorum_size,
                                    config.fast_quorum_size)
        self.classic_quorum = SpecChecker(
            specs.classic, options.quorum_backend,
            metrics=lambda: transport.runtime_metrics, device=options.device)
        self.fast_quorum = SpecChecker(
            specs.fast, options.quorum_backend,
            metrics=lambda: transport.runtime_metrics, device=options.device)
        self.recovery_quorum = SpecChecker(
            specs.recovery, options.quorum_backend,
            metrics=lambda: transport.runtime_metrics, device=options.device)
        self.leader_id = list(config.leader_addresses).index(address)
        self.round = 0 if config.round_system.leader(0) == self.leader_id \
            else -1
        self.log: dict[int, Value] = {}
        self.chosen_watermark = 0
        self.next_slot = 0
        self.client_table: dict[Address, tuple[int, bytes]] = {}
        # Leaders monitor the ACCEPTORS (Leader.scala:341-353): the
        # alive count gates fast rounds and the delay estimates feed
        # thrifty Closest selection.
        self.heartbeat = HeartbeatParticipant(
            config.leader_heartbeat_addresses[self.leader_id], transport,
            logger, list(config.acceptor_heartbeat_addresses),
            HeartbeatOptions())
        # Liveness: thrifty sends target a bare quorum, so resends go to
        # every acceptor (resendPhase1as/resendPhase2as timers,
        # Leader.scala:355-376).

        def resend_phase1as():
            if isinstance(self.state, _Phase1State):
                self._send_phase1as(thrifty=False)
            self.resend_phase1as_timer.start()

        def resend_phase2as():
            # Fast rounds can wedge without ever looking "stuck" to the
            # per-slot conflict test: acceptors vote a command at their
            # own next_slot, so offset acceptors spread one command over
            # adjacent slots, each collecting an unchoosable-but-
            # "possible" partial quorum forever. If a full resend period
            # passes with votes outstanding and nothing chosen, fall
            # back to coordinated recovery in the next (classic) round
            # (Leader.scala:365-376 + the fast-stuck path of
            # processPhase2b, Leader.scala:690-724).
            progress = (self.chosen_watermark, len(self.log))
            if (isinstance(self.state, _Phase2State)
                    and self.state.phase2bs
                    and progress == self._last_progress
                    and self.config.round_system.round_type(self.round)
                    == RoundType.FAST):
                # Force a CLASSIC round: jumping to another fast round
                # recreates the same offset-votes wedge.
                self._bump_round_and_restart(self.round,
                                             force_classic=True)
                return
            self._last_progress = progress
            self._resend_phase2as()
            self.resend_phase2as_timer.start()

        self._last_progress = (-1, -1)
        self.resend_phase1as_timer = self.timer(
            "resendPhase1as", options.resend_phase1as_period_s,
            resend_phase1as)
        self.resend_phase2as_timer = self.timer(
            "resendPhase2as", options.resend_phase2as_period_s,
            resend_phase2as)
        self.election = RaftElectionParticipant(
            config.leader_election_addresses[self.leader_id], transport,
            logger, list(config.leader_election_addresses),
            leader=config.leader_election_addresses[0],
            options=election_options, seed=seed)
        self.election.register(self._on_leader_change)

        if self.round == 0:
            self._send_phase1as()
            self.state: object = _Phase1State({}, [])
            self.resend_phase1as_timer.start()
        else:
            self.state = None  # Inactive

    # --- helpers ----------------------------------------------------------
    def _other_leaders(self):
        return [a for a in self.config.leader_addresses if a != self.address]

    def _thrifty_acceptors(self, min_size: int) -> list[Address]:
        """thriftyAcceptors (Leader.scala:464-483): pick at least
        ``min_size`` acceptors via the thrifty system, fed by the
        heartbeat's delay estimates (dead acceptors report infinite
        delay, so Closest avoids them)."""
        if self.options.thrifty_system is None:
            return list(self.config.acceptor_addresses)
        delays_by_hb = self.heartbeat.unsafe_network_delay()
        delays = {
            self.config.acceptor_addresses[i]: delays_by_hb.get(hb, 0.0)
            for i, hb in enumerate(
                self.config.acceptor_heartbeat_addresses)}
        return sorted(self.options.thrifty_system.choose(
            delays, min_size, self.rng))

    def _resend_phase2as(self) -> None:
        """Re-send every pending Phase2a to every acceptor
        (Leader.scala:365-376)."""
        if not isinstance(self.state, _Phase2State):
            return
        for slot, value in self.state.pending_entries.items():
            phase2a = Phase2a(slot=slot, round=self.round, value=value)
            for acceptor in self.config.acceptor_addresses:
                self.send(acceptor, phase2a)

    def _send_phase1as(self, thrifty: bool = False) -> None:
        phase1a = Phase1a(round=self.round,
                          chosen_watermark=self.chosen_watermark,
                          chosen_slots=tuple(
                              s for s in sorted(self.log)
                              if s >= self.chosen_watermark))
        targets = (self._thrifty_acceptors(self.config.classic_quorum_size)
                   if thrifty else self.config.acceptor_addresses)
        for acceptor in targets:
            self.send(acceptor, phase1a)

    def _on_leader_change(self, leader_address: Address) -> None:
        is_me = (leader_address
                 == self.config.leader_election_addresses[self.leader_id])
        if not is_me:
            self.state = None
            self.resend_phase1as_timer.stop()
            self.resend_phase2as_timer.stop()
            return
        self._bump_round_and_restart(self.round, thrifty=False)

    def _bump_round_and_restart(self, higher_than: int,
                                thrifty: bool = True,
                                force_classic: bool = False) -> None:
        rs = self.config.round_system
        if not force_classic and len(
                self.heartbeat.unsafe_alive()) >= self.config.fast_quorum_size:
            next_fast = rs.next_fast_round(self.leader_id, higher_than)
            self.round = (next_fast if next_fast is not None
                          else rs.next_classic_round(self.leader_id,
                                                     higher_than))
        else:
            self.round = rs.next_classic_round(self.leader_id, higher_than)
        # Nack/stuck-driven restarts are thrifty (Leader.scala:433); the
        # initial round and election-driven takeovers are not (:359).
        self._send_phase1as(thrifty=thrifty)
        self.state = _Phase1State({}, [])
        self.resend_phase2as_timer.stop()
        self.resend_phase1as_timer.start()

    def _choose_proposal(self, phase1bs: dict[int, Phase1b],
                         slot: int) -> Value:
        """Fast Paxos phase-1 value selection (Leader.scala:482-530).

        At max vote round k, a unique value wins; else a value whose
        round-k voters satisfy the recovery spec (>= q1 + qf - n of
        them, i.e. fast-quorum intersection demands adoption) wins;
        else any round-k vote. An ambiguity between popular values is
        only possible when the configuration violates the fast
        intersection condition; adoption is then not forced."""
        votes = []
        for acceptor_id, phase1b in phase1bs.items():
            vote = next((v for v in phase1b.votes if v.slot == slot), None)
            votes.append((acceptor_id, -1, None) if vote is None
                         else (acceptor_id, vote.vote_round, vote.value))
        k = max(vote_round for _, vote_round, _ in votes)
        if k == -1:
            return NOOP
        at_k = [(acceptor_id, value)
                for acceptor_id, vote_round, value in votes
                if vote_round == k]
        if len({value for _, value in at_k}) == 1:
            return at_k[0][1]
        voters: dict[Value, list[int]] = {}
        for acceptor_id, value in at_k:
            voters.setdefault(value, []).append(acceptor_id)
        popular = [value for value, ids in voters.items()
                   if self.recovery_quorum.check(ids)]
        if len(popular) == 1:
            return popular[0]
        return at_k[0][1]

    def _choose(self, slot: int, value: Value) -> None:
        if slot in self.log:
            return
        self.log[slot] = value
        if isinstance(self.state, _Phase2State):
            self.state.pending_entries.pop(slot, None)
            self.state.phase2bs.pop(slot, None)
        for leader in self._other_leaders():
            self.send(leader, ValueChosen(slot=slot, value=value))
        self._execute_log()

    def _execute_log(self) -> None:
        while self.chosen_watermark in self.log:
            value = self.log[self.chosen_watermark]
            slot = self.chosen_watermark
            self.chosen_watermark += 1
            if slot + 1 > self.next_slot:
                self.next_slot = slot + 1
            if isinstance(value, Noop):
                continue
            cid = value.command_id
            cached = self.client_table.get(cid.client_address)
            if cached is not None and cid.client_id < cached[0]:
                continue
            if cached is not None and cid.client_id == cached[0]:
                result = cached[1]
            else:
                result = self.state_machine.run(value.command)
                self.client_table[cid.client_address] = (cid.client_id,
                                                         result)
            if self.state is not None:  # only the active leader replies
                self.send(cid.client_address,
                          ProposeReply(command_id=cid, result=result,
                                       round=self.round))

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, ProposeRequest):
            self._handle_propose_request(src, message)
        elif isinstance(message, Phase1b):
            self._handle_phase1b(src, message)
        elif isinstance(message, Phase1bNack):
            self._handle_phase1b_nack(src, message)
        elif isinstance(message, Phase2b):
            self._handle_phase2b(src, message)
        elif isinstance(message, Phase2bBuffer):
            for phase2b in message.phase2bs:
                self._handle_phase2b(src, phase2b)
        elif isinstance(message, ValueChosen):
            self._handle_value_chosen(src, message)
        else:
            self.logger.fatal(f"unexpected leader message {message!r}")

    def _handle_propose_request(self, src: Address,
                                request: ProposeRequest) -> None:
        cid = request.command.command_id
        cached = self.client_table.get(cid.client_address)
        if cached is not None and cid.client_id == cached[0]:
            # Only the ACTIVE leader replies (matching _execute_log): a
            # deposed leader's self.round may never have been
            # established at any acceptor, and the client adopts reply
            # rounds monotonically -- a stale reply would permanently
            # misroute its classic-round proposals to this dead leader.
            if self.state is not None:
                self.send(cid.client_address,
                          ProposeReply(command_id=cid, result=cached[1],
                                       round=self.round))
            return
        if isinstance(self.state, _Phase1State):
            self.state.pending_proposals.append((src, request.command))
            return
        if not isinstance(self.state, _Phase2State):
            return  # inactive; the active leader will handle it
        if self.config.round_system.round_type(self.round) \
                == RoundType.FAST:
            return  # clients propose straight to acceptors in fast rounds
        slot = self.next_slot
        self.next_slot += 1
        self.state.pending_entries[slot] = request.command
        phase2a = Phase2a(slot=slot, round=self.round,
                          value=request.command)
        for acceptor in self._thrifty_acceptors(
                self.config.quorum_size(self.round)):
            self.send(acceptor, phase2a)

    def _handle_phase1b(self, src: Address, phase1b: Phase1b) -> None:
        if not isinstance(self.state, _Phase1State) \
                or phase1b.round != self.round:
            return
        state = self.state
        state.phase1bs[phase1b.acceptor_id] = phase1b
        if not self.classic_quorum.check(state.phase1bs):
            return
        # Fill every unchosen slot up to the max voted slot.
        max_slot = max(
            (vote.slot for p in state.phase1bs.values()
             for vote in p.votes), default=-1)
        phase2 = _Phase2State({}, {})
        for slot in range(self.chosen_watermark, max_slot + 1):
            if slot in self.log:
                continue
            value = self._choose_proposal(state.phase1bs, slot)
            phase2.pending_entries[slot] = value
            for acceptor in self._thrifty_acceptors(
                    self.config.quorum_size(self.round)):
                self.send(acceptor, Phase2a(slot=slot, round=self.round,
                                            value=value))
        # next_slot >= chosen_watermark is an invariant here: the ONLY
        # place chosen_watermark advances (the execute loop in
        # _choose) lifts next_slot alongside it, and every chosen slot
        # >= the watermark carries f+1 votes so the Phase1 read quorum
        # reports it (max_slot covers it). This max() therefore cannot
        # land the proposal cursor inside chosen state.
        # paxlint: disable=SAFE903
        self.next_slot = max(self.next_slot, max_slot + 1)
        pending = state.pending_proposals
        self.state = phase2
        self.resend_phase1as_timer.stop()
        self.resend_phase2as_timer.start()
        if self.config.round_system.round_type(self.round) \
                == RoundType.FAST:
            # Open the suffix for direct client proposals.
            for acceptor in self.config.acceptor_addresses:
                self.send(acceptor, Phase2a(slot=self.next_slot,
                                            round=self.round,
                                            any_suffix=True))
        else:
            for src_addr, command in pending:
                self._handle_propose_request(src_addr,
                                             ProposeRequest(command))

    def _handle_phase1b_nack(self, src: Address,
                             nack: Phase1bNack) -> None:
        if nack.round <= self.round or self.state is None:
            return
        self._bump_round_and_restart(nack.round)

    def _handle_phase2b(self, src: Address, phase2b: Phase2b) -> None:
        """(Leader.scala:690-724 phase2bChosenInSlot + processPhase2b)."""
        if not isinstance(self.state, _Phase2State) \
                or phase2b.round != self.round:
            return
        if phase2b.slot in self.log:
            return
        state = self.state
        in_slot = state.phase2bs.setdefault(phase2b.slot, {})
        in_slot[phase2b.acceptor_id] = phase2b
        round_type = self.config.round_system.round_type(self.round)
        if round_type == RoundType.CLASSIC:
            if self.classic_quorum.check(in_slot):
                self._choose(phase2b.slot,
                             state.pending_entries[phase2b.slot])
            return
        # Fast round.
        if not self.classic_quorum.check(in_slot):
            return
        voters: dict[Value, list[int]] = {}
        for acceptor_id, p in in_slot.items():
            voters.setdefault(p.vote, []).append(acceptor_id)
        votes_left = self.config.n - len(in_slot)
        if not any(len(ids) + votes_left >= self.config.fast_quorum_size
                   for ids in voters.values()):
            # Fast stuck: coordinated recovery in the next round.
            self._bump_round_and_restart(self.round)
            return
        for value, ids in voters.items():
            if self.fast_quorum.check(ids):
                self._choose(phase2b.slot, value)
                return

    def _handle_value_chosen(self, src: Address,
                             message: ValueChosen) -> None:
        if message.slot not in self.log:
            self.log[message.slot] = message.value
            self._execute_log()


@dataclasses.dataclass
class _Pending:
    id: int
    command: bytes
    callback: Callable[[bytes], None]
    resend: object


class FastMultiPaxosClient(Actor):
    """Routes by its guess of the current round (Client.scala:92-103,
    :216-223): FAST rounds propose straight to every acceptor; CLASSIC
    rounds propose to the round's leader (acceptors ignore direct
    proposals outside fast rounds, so sending them there would strand
    the command until the resend timer). The guess updates from each
    ProposeReply; resends cover a stale guess."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: FastMultiPaxosConfig,
                 resend_period_s: float = 10.0, seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.resend_period_s = resend_period_s
        self.round = 0
        self.next_id = 0
        self.pending: Optional[_Pending] = None

    def _send_proposal(self, request: ProposeRequest) -> None:
        rs = self.config.round_system
        if rs.round_type(self.round) == RoundType.FAST:
            for acceptor in self.config.acceptor_addresses:
                self.send(acceptor, request)
        else:
            self.send(self.config.leader_addresses[rs.leader(self.round)],
                      request)

    def propose(self, command: bytes,
                callback: Optional[Callable[[bytes], None]] = None) -> None:
        if self.pending is not None:
            raise RuntimeError("a proposal is already pending")
        id = self.next_id
        self.next_id += 1
        request = ProposeRequest(Command(CommandId(self.address, id),
                                         command))
        self._send_proposal(request)

        def resend():
            for leader in self.config.leader_addresses:
                self.send(leader, request)
            for acceptor in self.config.acceptor_addresses:
                self.send(acceptor, request)
            timer.start()

        timer = self.timer(f"resend-{id}", self.resend_period_s, resend)
        timer.start()
        self.pending = _Pending(id, command, callback or (lambda _: None),
                                timer)

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, ProposeReply):
            self.logger.fatal(f"unexpected client message {message!r}")
        self.round = max(self.round, message.round)
        if self.pending is None \
                or message.command_id.client_id != self.pending.id:
            return
        pending = self.pending
        pending.resend.stop()
        self.pending = None
        pending.callback(message.result)

# Importing registers this protocol's binary codecs with the hybrid
# serializer (see fastmultipaxos_wire.py).
from frankenpaxos_tpu_torch.protocols import (  # noqa: E402,F401
    fastmultipaxos_wire,
)
