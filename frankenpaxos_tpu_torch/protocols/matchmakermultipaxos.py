"""Matchmaker MultiPaxos: MultiPaxos with live acceptor reconfiguration
(the port's copy of ``frankenpaxos_tpu/protocols/matchmakermultipaxos.py``).

Reference behavior: matchmakermultipaxos/ (~4,900 LoC Scala: Leader,
Matchmaker.scala:79-700, Reconfigurer.scala:98-720, Acceptor, Replica;
SURVEY.md section 2.2). Every round has its own quorum system over an
arbitrary acceptor set, registered with 2f+1 matchmakers:

  * to start round r, the leader matchmakes: MatchRequest(r, config) to
    the matchmakers of the current matchmaker epoch; f+1 MatchReplies
    return all prior-round configurations; phase 1 reads a read quorum
    of every prior configuration (for the whole log suffix); phase 2
    writes through the new round's own configuration -- the per-round
    quorum-systems shape that ops/quorum.py's MultiConfigQuorumChecker
    batches on device;
  * a Reconfigurer drives acceptor-set changes mid-stream by handing
    the leader a new configuration, which the leader adopts in its next
    round;
  * the matchmakers themselves are reconfigurable: epochs of 2f+1
    logical matchmakers, changed via the reference's
    Stop -> StopAck -> Bootstrap -> BootstrapAck -> MatchPhase1a/1b ->
    MatchPhase2a/2b -> MatchChosen protocol (Matchmaker.scala:462-662,
    Reconfigurer.scala:283-720). Stopped epochs bounce leaders to the
    new epoch via Stopped messages (Leader.scala:2212-2279);
  * GarbageCollect prunes matchmaker configurations below the leader's
    round once phase 1 has read them (Matchmaker.scala:400-460);
  * Die messages support chaos testing of matchmakers
    (Matchmaker.scala:664).

The leader's phase-1 check of every prior configuration runs on the host
(``quorum_backend="dict"``, the reference's per-round loop) or on K6's
stateless check (``quorum_backend="cuda"``, on ``device``: the card when
None, ``"cpu"`` for the plain version). On the card each Phase1b is ONE
staged call: the responder set as one 32-bit word, checked under each of
the K prior configurations' read planes
(``MultiConfigQuorumChecker.check_all``). The leader keeps the checkers of
its recent phase 1s, keyed by their read specs, so a round whose prior
configurations repeat builds none. Phase 2 counts Phase2bs on the host in
both arms, as the reference does.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional, Union

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.protocols.driver_util import (
    delayed_repeating,
    repeating,
)
from frankenpaxos_tpu_torch.quorums import (
    quorum_system_from_dict,
    quorum_system_to_dict,
    QuorumSpec,
    QuorumSystem,
    SimpleMajority,
)
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.statemachine import StateMachine
from frankenpaxos_tpu_torch.utils import BufferMap


@dataclasses.dataclass(frozen=True)
class MatchmakerMultiPaxosConfig:
    f: int
    leader_addresses: tuple
    matchmaker_addresses: tuple
    reconfigurer_addresses: tuple
    acceptor_addresses: tuple
    replica_addresses: tuple

    def check_valid(self) -> None:
        if self.f < 1:
            raise ValueError("f must be >= 1")
        if len(self.leader_addresses) < self.f + 1:
            raise ValueError("need >= f+1 leaders")
        if len(self.matchmaker_addresses) < 2 * self.f + 1:
            raise ValueError("need >= 2f+1 matchmakers")
        if len(self.reconfigurer_addresses) < 1:
            raise ValueError("need >= 1 reconfigurer")
        if len(self.acceptor_addresses) < 2 * self.f + 1:
            raise ValueError("need >= 2f+1 acceptors")
        if len(self.replica_addresses) < self.f + 1:
            raise ValueError("need >= f+1 replicas")


@dataclasses.dataclass(frozen=True)
class MatchmakerConfiguration:
    """An epoch of 2f+1 logical matchmakers (MatchmakerConfiguration in
    the reference's proto; epoch 0 is matchmakers 0..2f)."""

    epoch: int
    reconfigurer_index: int
    matchmaker_indices: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CommandId:
    client_address: Address
    client_pseudonym: int
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
class ClientRequest:
    command: Command


@dataclasses.dataclass(frozen=True)
class ClientReply:
    command_id: CommandId
    result: bytes


# --- leader <-> matchmaker ------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MatchRequest:
    matchmaker_configuration: MatchmakerConfiguration
    round: int
    quorum_system: dict


@dataclasses.dataclass(frozen=True)
class MatchReply:
    epoch: int
    round: int
    matchmaker_index: int
    gc_watermark: int
    configurations: tuple[tuple[int, dict], ...]  # (round, quorum system)


@dataclasses.dataclass(frozen=True)
class MatchmakerNack:
    round: int


@dataclasses.dataclass(frozen=True)
class Stopped:
    """The contacted matchmaker epoch has stopped; move to the next
    epoch (Matchmaker.scala:366-371)."""

    epoch: int


@dataclasses.dataclass(frozen=True)
class GarbageCollect:
    """Prune matchmaker configurations below ``gc_watermark`` once
    phase 1 has read everything it needs (Matchmaker.scala:400-460)."""

    matchmaker_configuration: MatchmakerConfiguration
    gc_watermark: int


@dataclasses.dataclass(frozen=True)
class GarbageCollectAck:
    epoch: int
    matchmaker_index: int
    gc_watermark: int


# --- reconfigurer <-> matchmaker (matchmaker self-reconfiguration) --------
@dataclasses.dataclass(frozen=True)
class Stop:
    matchmaker_configuration: MatchmakerConfiguration


@dataclasses.dataclass(frozen=True)
class StopAck:
    matchmaker_index: int
    epoch: int
    gc_watermark: int
    configurations: tuple[tuple[int, dict], ...]


@dataclasses.dataclass(frozen=True)
class Bootstrap:
    epoch: int
    reconfigurer_index: int
    gc_watermark: int
    configurations: tuple[tuple[int, dict], ...]


@dataclasses.dataclass(frozen=True)
class BootstrapAck:
    matchmaker_index: int
    epoch: int


@dataclasses.dataclass(frozen=True)
class MatchPhase1a:
    matchmaker_configuration: MatchmakerConfiguration
    round: int


@dataclasses.dataclass(frozen=True)
class MatchPhase1b:
    epoch: int
    round: int
    matchmaker_index: int
    vote_round: int
    vote_value: Optional[MatchmakerConfiguration]


@dataclasses.dataclass(frozen=True)
class MatchPhase2a:
    matchmaker_configuration: MatchmakerConfiguration
    round: int
    value: MatchmakerConfiguration


@dataclasses.dataclass(frozen=True)
class MatchPhase2b:
    epoch: int
    round: int
    matchmaker_index: int


@dataclasses.dataclass(frozen=True)
class MatchChosen:
    value: MatchmakerConfiguration


@dataclasses.dataclass(frozen=True)
class MatchNack:
    epoch: int
    round: int


@dataclasses.dataclass(frozen=True)
class ReconfigureMatchmakers:
    """Ask a reconfigurer to replace the matchmakers of
    ``matchmaker_configuration`` with ``new_matchmaker_indices``
    (Reconfigure in Reconfigurer.scala:357-404)."""

    matchmaker_configuration: MatchmakerConfiguration
    new_matchmaker_indices: tuple[int, ...]


# --- leader <-> acceptor --------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Phase1a:
    round: int
    chosen_watermark: int


@dataclasses.dataclass(frozen=True)
class Phase1bSlotInfo:
    slot: int
    vote_round: int
    vote_value: Value


@dataclasses.dataclass(frozen=True)
class Phase1b:
    round: int
    acceptor_index: int
    info: tuple[Phase1bSlotInfo, ...]


@dataclasses.dataclass(frozen=True)
class Phase2a:
    slot: int
    round: int
    value: Value


@dataclasses.dataclass(frozen=True)
class Phase2b:
    slot: int
    round: int
    acceptor_index: int


@dataclasses.dataclass(frozen=True)
class Chosen:
    slot: int
    value: Value


@dataclasses.dataclass(frozen=True)
class AcceptorNack:
    round: int


@dataclasses.dataclass(frozen=True)
class Reconfigure:
    quorum_system: dict


@dataclasses.dataclass(frozen=True)
class Die:
    """Chaos: kill a matchmaker (Matchmaker.scala:664)."""


# --- leader states --------------------------------------------------------
@dataclasses.dataclass
class _Matchmaking:
    quorum_system: QuorumSystem
    matchmaker_configuration: MatchmakerConfiguration
    match_replies: dict[int, MatchReply]
    pending_batches: list[ClientRequest]


@dataclasses.dataclass
class _WaitingForNewMatchmakers:
    """The epoch we were matchmaking in stopped; a reconfigurer is
    finding us new matchmakers (Leader.scala:2229-2251)."""

    quorum_system: QuorumSystem
    pending_batches: list[ClientRequest]
    resend: object


@dataclasses.dataclass
class _Phase1:
    quorum_system: QuorumSystem
    previous: dict[int, QuorumSystem]
    pending_rounds: set[int]
    phase1bs: dict[int, Phase1b]
    pending_batches: list[ClientRequest]
    # quorum_backend="cuda": (sorted prior rounds, MultiConfigQuorumChecker)
    # evaluating "responders cover a read quorum" for every prior
    # configuration over its padded [K, G, N] planes in one call.
    checker: Optional[tuple] = None


@dataclasses.dataclass
class _Phase2:
    quorum_system: QuorumSystem
    pending_values: dict[int, Value]
    phase2bs: dict[int, set[int]]


def initial_matchmaker_configuration(f: int) -> MatchmakerConfiguration:
    return MatchmakerConfiguration(
        epoch=0, reconfigurer_index=-1,
        matchmaker_indices=tuple(range(2 * f + 1)))


#: The leader's quorum backends: the reference's host loop and K6.
QUORUM_BACKENDS = ("dict", "cuda")


class MMPLeader(Actor):
    #: Phase-1 checkers a leader keeps, keyed by their read specs.
    CHECKER_CACHE = 16

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerMultiPaxosConfig,
                 seed: int = 0, quorum_backend: str = "dict",
                 device=None):
        super().__init__(address, transport, logger)
        config.check_valid()
        if quorum_backend not in QUORUM_BACKENDS:
            raise ValueError(f"unknown quorum backend {quorum_backend!r}")
        self.config = config
        self.quorum_backend = quorum_backend
        self.device = resolve_device(device) \
            if quorum_backend == "cuda" else None
        # Phase-1 checkers by read-spec key, oldest first.
        self._checkers: dict = {}
        self.rng = random.Random(seed)
        self.index = list(config.leader_addresses).index(address)
        self.round_system = ClassicRoundRobin(len(config.leader_addresses))
        self.round = -1
        self.next_slot = 0
        self.chosen_watermark = 0
        self.log: BufferMap = BufferMap()
        self.state: object = None  # Inactive
        # Deferred matchmaker GC: set when phase 1 completes, fired once
        # every slot phase 1 recovered has been chosen in our round
        # (the reference's WaitingForLargerChosenWatermark gc state,
        # Leader.scala:2140-2160). GCing any earlier can lose a chosen
        # value: the old configurations would be pruned before their
        # votes were re-written through the new round.
        self._gc_pending: Optional[tuple[MatchmakerConfiguration, int,
                                         int]] = None
        # Highest GC watermark a matchmaker has acked.
        self.gc_acked_watermark = -1
        # The latest matchmaker epoch this leader knows about
        # (Leader.scala:550-552).
        self.matchmaker_configuration = initial_matchmaker_configuration(
            config.f)
        # The configuration to adopt at the next matchmaking, set by the
        # reconfigurer.
        self.next_quorum_system: QuorumSystem = SimpleMajority(
            range(2 * config.f + 1))
        self.match_resend_period_s = 1.0
        self._match_resend_timer = None
        if self.index == 0:
            self._start_matchmaking(self.round)

    # --- matchmaking ------------------------------------------------------
    def _start_matchmaking(self, from_round: int) -> None:
        pending = []
        if isinstance(self.state,
                      (_Matchmaking, _Phase1, _WaitingForNewMatchmakers)):
            pending = self.state.pending_batches
        if from_round >= self.round:
            self.round = self.round_system.next_classic_round(self.index,
                                                              from_round)
        self._matchmake(self.round, self.next_quorum_system, pending)

    def _matchmake(self, round: int, quorum_system: QuorumSystem,
                   pending: list[ClientRequest]) -> None:
        """Send MatchRequests for ``round`` to the current matchmaker
        epoch (startMatchmaking, Leader.scala:905-935)."""
        self._gc_pending = None  # a new round supersedes any pending GC
        self.round = round
        self.state = _Matchmaking(quorum_system,
                                  self.matchmaker_configuration, {}, pending)
        self._send_match_requests()
        # Resend while still matchmaking: the initial MatchRequests can
        # race matchmaker startup or be dropped (resendMatchRequests,
        # Leader.scala:259-272). One reusable timer (created lazily once)
        # whose callback reads current state, so churny reconfigurations
        # don't allocate a timer per round.
        if self._match_resend_timer is None:
            def resend():
                if isinstance(self.state, _Matchmaking):
                    self._send_match_requests()
                    self._match_resend_timer.start()

            self._match_resend_timer = self.timer(
                "resendMatchRequests", self.match_resend_period_s, resend)
        self._match_resend_timer.stop()
        self._match_resend_timer.start()

    def _send_match_requests(self) -> None:
        state = self.state
        assert isinstance(state, _Matchmaking)
        request = MatchRequest(
            matchmaker_configuration=state.matchmaker_configuration,
            round=self.round,
            quorum_system=quorum_system_to_dict(state.quorum_system))
        for i in state.matchmaker_configuration.matchmaker_indices:
            self.send(self.config.matchmaker_addresses[i], request)

    def _acceptor(self, index: int) -> Address:
        return self.config.acceptor_addresses[index]

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, ClientRequest):
            self._handle_client_request(src, message)
        elif isinstance(message, MatchReply):
            self._handle_match_reply(src, message)
        elif isinstance(message, (MatchmakerNack, AcceptorNack)):
            self._handle_nack(message.round)
        elif isinstance(message, Stopped):
            self._handle_stopped(src, message)
        elif isinstance(message, MatchChosen):
            self._handle_match_chosen(src, message)
        elif isinstance(message, GarbageCollectAck):
            self.gc_acked_watermark = max(self.gc_acked_watermark,
                                          message.gc_watermark)
        elif isinstance(message, Phase1b):
            self._handle_phase1b(src, message)
        elif isinstance(message, Phase2b):
            self._handle_phase2b(src, message)
        elif isinstance(message, Reconfigure):
            self._handle_reconfigure(src, message)
        elif isinstance(message, Chosen):
            self._learn(message.slot, message.value)
        else:
            self.logger.fatal(f"unexpected leader message {message!r}")

    def _handle_client_request(self, src: Address,
                               request: ClientRequest) -> None:
        if self.state is None:
            return
        if isinstance(self.state,
                      (_Matchmaking, _Phase1, _WaitingForNewMatchmakers)):
            self.state.pending_batches.append(request)
            return
        self._propose(request.command)

    def _propose(self, value: Value) -> None:
        state: _Phase2 = self.state
        slot = self.next_slot
        self.next_slot += 1
        state.pending_values[slot] = value
        state.phase2bs[slot] = set()
        phase2a = Phase2a(slot=slot, round=self.round, value=value)
        for i in state.quorum_system.random_write_quorum(self.rng):
            self.send(self._acceptor(i), phase2a)

    def _handle_match_reply(self, src: Address, reply: MatchReply) -> None:
        if not isinstance(self.state, _Matchmaking) \
                or reply.round != self.round:
            return
        state = self.state
        if reply.epoch != state.matchmaker_configuration.epoch:
            return
        state.match_replies[reply.matchmaker_index] = reply
        if len(state.match_replies) < self.config.f + 1:
            return
        # Rounds below the highest acked GC watermark were already fully
        # re-chosen through a later configuration; skip reading them even
        # if a laggard matchmaker still reports them.
        gc_watermark = max(r.gc_watermark
                           for r in state.match_replies.values())
        previous: dict[int, QuorumSystem] = {}
        for r in state.match_replies.values():
            for round, qs_dict in r.configurations:
                if round >= gc_watermark:
                    previous[round] = quorum_system_from_dict(qs_dict)
        pending_rounds = set(previous)
        if not pending_rounds:
            self.state = _Phase2(state.quorum_system, {}, {})
            for request in state.pending_batches:
                self._propose(request.command)
            return
        # Phase 1 over a read quorum of every prior configuration.
        targets: set[int] = set()
        for qs in previous.values():
            targets |= qs.random_read_quorum(self.rng)
        phase1a = Phase1a(round=self.round,
                          chosen_watermark=self.chosen_watermark)
        for i in targets:
            self.send(self._acceptor(i), phase1a)
        checker = None
        if self.quorum_backend == "cuda":
            checker = self._phase1_checker(previous)
        self.state = _Phase1(state.quorum_system, previous, pending_rounds,
                             {}, state.pending_batches, checker)

    def _phase1_checker(self, previous: dict[int, QuorumSystem]) -> tuple:
        """``(sorted prior rounds, their checker)``. The quorum-matrix
        reshape: each prior round's read predicate becomes one plane of a
        padded [K, G, N] tensor, so every Phase1b re-checks all prior
        configurations in one call instead of the per-round host loop
        (Leader.scala:1788-1999). A checker of the same read specs made
        for an earlier phase 1 is reused."""
        universe = tuple(range(len(self.config.acceptor_addresses)))
        rounds_sorted = sorted(previous)
        specs = [previous[r].read_spec().reindexed(universe)
                 for r in rounds_sorted]
        key = tuple((s.masks.shape, s.masks.tobytes(), s.thresholds.tobytes(),
                     s.combine) for s in specs)
        checker = self._checkers.pop(key, None)
        if checker is None:
            checker = self._build_checker(specs)
            if len(self._checkers) >= self.CHECKER_CACHE:
                del self._checkers[next(iter(self._checkers))]
        self._checkers[key] = checker
        return rounds_sorted, checker

    def _build_checker(self, specs: list[QuorumSpec]):
        from frankenpaxos_tpu_torch.ops.quorum import MultiConfigQuorumChecker

        return MultiConfigQuorumChecker(specs, device=self.device)

    def _read_quorums_met(self, state: _Phase1,
                          responders: set[int]) -> list[int]:
        """The prior rounds still pending whose configuration
        ``responders`` covers a read quorum of."""
        if state.checker is None:
            return [round for round in state.pending_rounds
                    if state.previous[round].is_superset_of_read_quorum(
                        responders)]
        # Every prior configuration's read plane on the one responder set
        # (the reference's [K, N] batch of equal rows under
        # config_idx = arange(K)).
        rounds_sorted, checker = state.checker
        return [round for round, hit in zip(rounds_sorted,
                                            checker.check_all(responders))
                if hit]

    def _handle_phase1b(self, src: Address, phase1b: Phase1b) -> None:
        if not isinstance(self.state, _Phase1) \
                or phase1b.round != self.round:
            return
        state = self.state
        state.phase1bs[phase1b.acceptor_index] = phase1b
        for round in self._read_quorums_met(state, set(state.phase1bs)):
            state.pending_rounds.discard(round)
        if state.pending_rounds:
            return
        max_slot = max((i.slot for p in state.phase1bs.values()
                        for i in p.info), default=-1)
        # Phase 1 done: matchmaker state below this round becomes
        # prunable -- but only once every recovered slot has been
        # re-chosen through THIS round's configuration, or a crash
        # between GC and phase 2 could lose a chosen value
        # (Leader.scala:2140-2160).
        self._gc_pending = (self.matchmaker_configuration, self.round,
                            max_slot)
        self._maybe_garbage_collect()
        phase2 = _Phase2(state.quorum_system, {}, {})
        pending = state.pending_batches
        self.state = phase2
        for slot in range(self.chosen_watermark, max_slot + 1):
            if self.log.get(slot) is not None:
                continue
            infos = [i for p in state.phase1bs.values() for i in p.info
                     if i.slot == slot]
            value = (max(infos, key=lambda i: i.vote_round).vote_value
                     if infos else NOOP)
            phase2.pending_values[slot] = value
            phase2.phase2bs[slot] = set()
            phase2a = Phase2a(slot=slot, round=self.round, value=value)
            for i in phase2.quorum_system.random_write_quorum(self.rng):
                self.send(self._acceptor(i), phase2a)
        self.next_slot = max(self.next_slot, max_slot + 1,
                             self.chosen_watermark)
        for request in pending:
            self._propose(request.command)

    def _handle_phase2b(self, src: Address, phase2b: Phase2b) -> None:
        if not isinstance(self.state, _Phase2) \
                or phase2b.round != self.round:
            return
        state = self.state
        voters = state.phase2bs.get(phase2b.slot)
        if voters is None:
            return
        voters.add(phase2b.acceptor_index)
        if not state.quorum_system.is_superset_of_write_quorum(voters):
            return
        value = state.pending_values.pop(phase2b.slot)
        del state.phase2bs[phase2b.slot]
        self._learn(phase2b.slot, value)
        for replica in self.config.replica_addresses:
            self.send(replica, Chosen(slot=phase2b.slot, value=value))
        for leader in self.config.leader_addresses:
            if leader != self.address:
                self.send(leader, Chosen(slot=phase2b.slot, value=value))

    def _learn(self, slot: int, value: Value) -> None:
        if self.log.get(slot) is None:
            self.log.put(slot, value)
        while self.log.get(self.chosen_watermark) is not None:
            self.chosen_watermark += 1
        self.next_slot = max(self.next_slot, self.chosen_watermark)
        self._maybe_garbage_collect()

    def _maybe_garbage_collect(self) -> None:
        if self._gc_pending is None:
            return
        mc, round, max_slot = self._gc_pending
        if self.chosen_watermark <= max_slot:
            return
        self._gc_pending = None
        gc = GarbageCollect(matchmaker_configuration=mc, gc_watermark=round)
        for i in mc.matchmaker_indices:
            self.send(self.config.matchmaker_addresses[i], gc)

    def _handle_nack(self, nack_round: int) -> None:
        if nack_round < self.round or self.state is None:
            return
        self._start_matchmaking(max(self.round, nack_round))

    def _handle_stopped(self, src: Address, stopped: Stopped) -> None:
        """Our matchmaker epoch stopped mid-matchmaking: ask a
        reconfigurer for the new epoch (Leader.scala:2229-2251)."""
        if not isinstance(self.state, _Matchmaking):
            return
        if stopped.epoch != self.state.matchmaker_configuration.epoch:
            return
        stale_configuration = self.state.matchmaker_configuration

        def send_reconfigure():
            # Re-sample each attempt: a sample that includes a dead
            # matchmaker can never bootstrap (the reconfigurer waits for
            # ALL 2f+1 BootstrapAcks), so retries must try new sets.
            request = ReconfigureMatchmakers(
                matchmaker_configuration=stale_configuration,
                new_matchmaker_indices=tuple(self.rng.sample(
                    range(len(self.config.matchmaker_addresses)),
                    2 * self.config.f + 1)))
            self.send(self.rng.choice(self.config.reconfigurer_addresses),
                      request)

        def resend():
            send_reconfigure()
            timer.start()

        send_reconfigure()
        timer = self.timer("resendReconfigure", 5.0, resend)
        timer.start()
        self.state = _WaitingForNewMatchmakers(
            self.state.quorum_system, self.state.pending_batches, timer)

    def _handle_match_chosen(self, src: Address,
                             chosen: MatchChosen) -> None:
        """Adopt a newer matchmaker epoch (Leader.scala:2281-2310)."""
        if chosen.value.epoch <= self.matchmaker_configuration.epoch:
            return
        self.matchmaker_configuration = chosen.value
        if isinstance(self.state, (_WaitingForNewMatchmakers, _Matchmaking)):
            if isinstance(self.state, _WaitingForNewMatchmakers):
                self.state.resend.stop()
            self._matchmake(self.round, self.state.quorum_system,
                            self.state.pending_batches)

    def _handle_reconfigure(self, src: Address,
                            reconfigure: Reconfigure) -> None:
        """Adopt a new acceptor configuration in our next round
        (the Reconfigurer's handoff)."""
        if self.state is None:
            return
        self.next_quorum_system = quorum_system_from_dict(
            reconfigure.quorum_system)
        self._start_matchmaking(self.round)


# --- matchmaker per-epoch states (Matchmaker.scala:128-166) ---------------
@dataclasses.dataclass
class _MatchmakerLog:
    gc_watermark: int
    configurations: dict[int, dict]  # round -> quorum system dict


@dataclasses.dataclass
class _Pending:
    """Bootstrapped for a new epoch but not yet told the epoch was
    chosen; one candidate log per proposing reconfigurer."""

    logs: dict[int, _MatchmakerLog]


@dataclasses.dataclass
class _Normal:
    log: _MatchmakerLog


@dataclasses.dataclass
class _HasStopped:
    log: _MatchmakerLog


@dataclasses.dataclass
class _MatchmakerAcceptorState:
    """Single-decree acceptor state for choosing the next epoch's
    configuration (Matchmaker.scala:154-166)."""

    round: int = -1
    vote_round: int = -1
    vote_value: Optional[MatchmakerConfiguration] = None


class MMPMatchmaker(Actor):
    """Stores per-round acceptor configurations, epoch by epoch;
    monotone; supports GC, the Stop/Bootstrap/MatchPhase1/2 epoch
    change, and Die (Matchmaker.scala:79-700)."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerMultiPaxosConfig):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.index = list(config.matchmaker_addresses).index(address)
        self.states: dict[int, object] = {}
        self.acceptor_states: dict[int, _MatchmakerAcceptorState] = {}
        if self.index < 2 * config.f + 1:
            self.states[0] = _Normal(_MatchmakerLog(0, {}))
            self.acceptor_states[0] = _MatchmakerAcceptorState()
        self.dead = False

    # Compatibility views over the newest epoch's log (used by tests
    # and the viz tooling).
    @property
    def configurations(self) -> dict[int, dict]:
        log = self._newest_log()
        return dict(log.configurations) if log else {}

    @property
    def gc_watermark(self) -> int:
        log = self._newest_log()
        return log.gc_watermark if log else 0

    def _newest_log(self) -> Optional[_MatchmakerLog]:
        for epoch in sorted(self.states, reverse=True):
            state = self.states[epoch]
            if isinstance(state, (_Normal, _HasStopped)):
                return state.log
        return None

    def _to_normal(self, epoch: int,
                   reconfigurer_index: int) -> Optional[_Normal]:
        """Resolve the state for ``epoch`` to Normal, promoting a
        Pending log from ``reconfigurer_index`` (the 'pretend we just
        learned we were chosen' path, Matchmaker.scala:296-312)."""
        state = self.states.get(epoch)
        if isinstance(state, _Pending):
            log = state.logs.get(reconfigurer_index)
            if log is None:
                self.logger.fatal(
                    f"matchmaker {self.index}: no pending log from "
                    f"reconfigurer {reconfigurer_index} in epoch {epoch}")
            state = _Normal(log)
            self.states[epoch] = state
        if isinstance(state, _Normal):
            return state
        return None

    def _to_stopped(self, epoch: int,
                    reconfigurer_index: int) -> _HasStopped:
        state = self.states.get(epoch)
        if isinstance(state, _Pending):
            log = state.logs.get(reconfigurer_index)
            if log is None:
                self.logger.fatal(
                    f"matchmaker {self.index}: no pending log from "
                    f"reconfigurer {reconfigurer_index} in epoch {epoch}")
            state = _HasStopped(log)
        elif isinstance(state, _Normal):
            state = _HasStopped(state.log)
        elif state is None:
            self.logger.fatal(
                f"matchmaker {self.index}: unknown epoch {epoch}")
        self.states[epoch] = state
        return state

    def receive(self, src: Address, message) -> None:
        if self.dead:
            return
        if isinstance(message, MatchRequest):
            self._handle_match_request(src, message)
        elif isinstance(message, GarbageCollect):
            self._handle_garbage_collect(src, message)
        elif isinstance(message, Stop):
            self._handle_stop(src, message)
        elif isinstance(message, Bootstrap):
            self._handle_bootstrap(src, message)
        elif isinstance(message, MatchPhase1a):
            self._handle_match_phase1a(src, message)
        elif isinstance(message, MatchPhase2a):
            self._handle_match_phase2a(src, message)
        elif isinstance(message, MatchChosen):
            self._handle_match_chosen(src, message)
        elif isinstance(message, Die):
            self.dead = True
        else:
            self.logger.fatal(f"unexpected matchmaker message {message!r}")

    def _handle_match_request(self, src: Address,
                              request: MatchRequest) -> None:
        mc = request.matchmaker_configuration
        if mc.epoch not in self.states:
            # Leaders only contact an epoch's matchmakers after every
            # one of them was bootstrapped (Matchmaker.scala:283-289).
            self.logger.fatal(
                f"matchmaker {self.index}: MatchRequest in unknown "
                f"epoch {mc.epoch}")
        normal = self._to_normal(mc.epoch, mc.reconfigurer_index)
        if normal is None:  # HasStopped: bounce to the next epoch.
            self.send(src, Stopped(epoch=mc.epoch))
            return
        log = normal.log
        if request.round < log.gc_watermark:
            self.send(src, MatchmakerNack(round=log.gc_watermark - 1))
            return
        if log.configurations and request.round <= max(log.configurations):
            self.send(src, MatchmakerNack(round=max(log.configurations)))
            return
        # dict(...) per entry: the outer tuple alone would embed the
        # LIVE quorum-system dicts -- SimTransport delivers by
        # reference, so any future in-place edit would time-travel to
        # the leader (the ALIAS1001 hazard class); copying at this
        # cold-path send closes the repo's one shallow-alias edge.
        self.send(src, MatchReply(
            epoch=mc.epoch, round=request.round,
            matchmaker_index=self.index,
            gc_watermark=log.gc_watermark,
            configurations=tuple(
                (r, dict(log.configurations[r]))
                for r in sorted(log.configurations)
                if r < request.round)))
        log.configurations[request.round] = request.quorum_system

    def _handle_garbage_collect(self, src: Address,
                                gc: GarbageCollect) -> None:
        mc = gc.matchmaker_configuration
        if mc.epoch not in self.states:
            return
        normal = self._to_normal(mc.epoch, mc.reconfigurer_index)
        if normal is None:
            self.send(src, Stopped(epoch=mc.epoch))
            return
        log = normal.log
        log.gc_watermark = max(log.gc_watermark, gc.gc_watermark)
        for round in [r for r in log.configurations
                      if r < log.gc_watermark]:
            del log.configurations[round]
        self.send(src, GarbageCollectAck(
            epoch=mc.epoch, matchmaker_index=self.index,
            gc_watermark=log.gc_watermark))

    def _handle_stop(self, src: Address, stop: Stop) -> None:
        mc = stop.matchmaker_configuration
        stopped = self._to_stopped(mc.epoch, mc.reconfigurer_index)
        # Copy the inner quorum-system dicts like _handle_match_request
        # does: tuple(items()) alone is a shallow freeze.
        self.send(src, StopAck(
            matchmaker_index=self.index, epoch=mc.epoch,
            gc_watermark=stopped.log.gc_watermark,
            configurations=tuple(
                (r, dict(qs)) for r, qs in sorted(
                    stopped.log.configurations.items()))))

    def _handle_bootstrap(self, src: Address, bootstrap: Bootstrap) -> None:
        log = _MatchmakerLog(bootstrap.gc_watermark,
                             dict(bootstrap.configurations))
        state = self.states.get(bootstrap.epoch)
        if state is None:
            self.states[bootstrap.epoch] = _Pending(
                {bootstrap.reconfigurer_index: log})
            self.acceptor_states[bootstrap.epoch] = \
                _MatchmakerAcceptorState()
        elif isinstance(state, _Pending):
            state.logs[bootstrap.reconfigurer_index] = log
        # Normal/HasStopped: state unchanged, but ack for liveness.
        self.send(src, BootstrapAck(matchmaker_index=self.index,
                                    epoch=bootstrap.epoch))

    def _handle_match_phase1a(self, src: Address,
                              phase1a: MatchPhase1a) -> None:
        mc = phase1a.matchmaker_configuration
        self._to_stopped(mc.epoch, mc.reconfigurer_index)
        acceptor = self.acceptor_states[mc.epoch]
        if phase1a.round < acceptor.round:
            self.send(src, MatchNack(epoch=mc.epoch, round=acceptor.round))
            return
        self.send(src, MatchPhase1b(
            epoch=mc.epoch, round=phase1a.round,
            matchmaker_index=self.index,
            vote_round=acceptor.vote_round,
            vote_value=acceptor.vote_value))
        acceptor.round = phase1a.round

    def _handle_match_phase2a(self, src: Address,
                              phase2a: MatchPhase2a) -> None:
        mc = phase2a.matchmaker_configuration
        self._to_stopped(mc.epoch, mc.reconfigurer_index)
        acceptor = self.acceptor_states[mc.epoch]
        if phase2a.round < acceptor.round:
            self.send(src, MatchNack(epoch=mc.epoch, round=acceptor.round))
            return
        self.send(src, MatchPhase2b(epoch=mc.epoch, round=phase2a.round,
                                    matchmaker_index=self.index))
        acceptor.round = phase2a.round
        acceptor.vote_round = phase2a.round
        acceptor.vote_value = phase2a.value

    def _handle_match_chosen(self, src: Address,
                             chosen: MatchChosen) -> None:
        epoch = chosen.value.epoch
        state = self.states.get(epoch)
        if isinstance(state, _Pending):
            log = state.logs.get(chosen.value.reconfigurer_index)
            if log is None:
                self.logger.fatal(
                    f"matchmaker {self.index}: MatchChosen from unknown "
                    f"reconfigurer {chosen.value.reconfigurer_index}")
            self.states[epoch] = _Normal(log)


# --- reconfigurer states (Reconfigurer.scala:118-178) ---------------------
@dataclasses.dataclass
class _Idle:
    configuration: MatchmakerConfiguration


@dataclasses.dataclass
class _Stopping:
    configuration: MatchmakerConfiguration
    new_configuration: MatchmakerConfiguration
    stop_acks: dict[int, StopAck]
    resend: object


@dataclasses.dataclass
class _Bootstrapping:
    configuration: MatchmakerConfiguration
    new_configuration: MatchmakerConfiguration
    bootstrap_acks: dict[int, BootstrapAck]
    resend: object


@dataclasses.dataclass
class _MatchPhase1:
    configuration: MatchmakerConfiguration
    new_configuration: MatchmakerConfiguration
    round: int
    phase1bs: dict[int, MatchPhase1b]
    resend: object


@dataclasses.dataclass
class _MatchPhase2:
    configuration: MatchmakerConfiguration
    new_configuration: MatchmakerConfiguration
    round: int
    phase2bs: dict[int, MatchPhase2b]
    resend: object


class MMPReconfigurer(Actor):
    """Drives acceptor-set changes (handed to the leaders, which
    matchmake them into their next round) and matchmaker-set changes
    (the reference's Stop -> Bootstrap -> MatchPhase1/2 -> MatchChosen
    protocol, Reconfigurer.scala:98-720)."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerMultiPaxosConfig,
                 resend_period_s: float = 5.0, seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.resend_period_s = resend_period_s
        self.index = list(config.reconfigurer_addresses).index(address)
        self.round_system = ClassicRoundRobin(
            len(config.reconfigurer_addresses))
        self.state: object = _Idle(
            initial_matchmaker_configuration(config.f))

    # --- external API -----------------------------------------------------
    def reconfigure(self, quorum_system: QuorumSystem) -> None:
        """Change the *acceptor* set: hand the leaders a new quorum
        system for their next round."""
        message = Reconfigure(quorum_system_to_dict(quorum_system))
        for leader in self.config.leader_addresses:
            self.send(leader, message)

    def reconfigure_matchmakers(self, indices) -> None:
        """Change the *matchmaker* set to ``indices`` (2f+1 of them)."""
        if not isinstance(self.state, _Idle):
            self.logger.debug("reconfiguration already in progress")
            return
        self._stop_epoch(self.state.configuration, tuple(indices))

    # --- helpers ----------------------------------------------------------
    def _matchmaker(self, index: int) -> Address:
        return self.config.matchmaker_addresses[index]

    def _resend_timer(self, name: str, message, indices) -> object:
        def resend():
            for i in indices:
                self.send(self._matchmaker(i), message)
            timer.start()

        timer = self.timer(name, self.resend_period_s, resend)
        timer.start()
        return timer

    def _stop_epoch(self, configuration: MatchmakerConfiguration,
                    new_indices: tuple[int, ...]) -> None:
        stop = Stop(matchmaker_configuration=configuration)
        for i in configuration.matchmaker_indices:
            self.send(self._matchmaker(i), stop)
        self.state = _Stopping(
            configuration=configuration,
            new_configuration=MatchmakerConfiguration(
                epoch=configuration.epoch + 1,
                reconfigurer_index=self.index,
                matchmaker_indices=new_indices),
            stop_acks={},
            resend=self._resend_timer("resendStops", stop,
                                      configuration.matchmaker_indices))

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, Reconfigure):
            for leader in self.config.leader_addresses:
                self.send(leader, message)
        elif isinstance(message, ReconfigureMatchmakers):
            self._handle_reconfigure_matchmakers(src, message)
        elif isinstance(message, StopAck):
            self._handle_stop_ack(src, message)
        elif isinstance(message, BootstrapAck):
            self._handle_bootstrap_ack(src, message)
        elif isinstance(message, MatchPhase1b):
            self._handle_match_phase1b(src, message)
        elif isinstance(message, MatchPhase2b):
            self._handle_match_phase2b(src, message)
        elif isinstance(message, MatchChosen):
            self._handle_match_chosen(src, message)
        elif isinstance(message, MatchNack):
            self._handle_match_nack(src, message)
        else:
            self.logger.fatal(f"unexpected reconfigurer message {message!r}")

    def _handle_reconfigure_matchmakers(
            self, src: Address, request: ReconfigureMatchmakers) -> None:
        if not isinstance(self.state, _Idle):
            return
        if request.matchmaker_configuration.epoch < \
                self.state.configuration.epoch:
            # Stale: the requester is behind; tell it the current epoch.
            self.send(src, MatchChosen(value=self.state.configuration))
            return
        self._stop_epoch(request.matchmaker_configuration,
                         request.new_matchmaker_indices)

    def _handle_stop_ack(self, src: Address, ack: StopAck) -> None:
        if not isinstance(self.state, _Stopping) \
                or ack.epoch != self.state.configuration.epoch:
            return
        state = self.state
        state.stop_acks[ack.matchmaker_index] = ack
        if len(state.stop_acks) < self.config.f + 1:
            return
        state.resend.stop()
        # Union the stopped logs, trim garbage, bootstrap the new epoch
        # (Reconfigurer.scala:436-470).
        gc_watermark = max(a.gc_watermark for a in state.stop_acks.values())
        configurations: dict[int, dict] = {}
        for a in state.stop_acks.values():
            for round, qs in a.configurations:
                if round >= gc_watermark:
                    configurations[round] = qs
        bootstrap = Bootstrap(
            epoch=state.new_configuration.epoch,
            reconfigurer_index=self.index,
            gc_watermark=gc_watermark,
            configurations=tuple(sorted(configurations.items())))
        for i in state.new_configuration.matchmaker_indices:
            self.send(self._matchmaker(i), bootstrap)
        self.state = _Bootstrapping(
            configuration=state.configuration,
            new_configuration=state.new_configuration,
            bootstrap_acks={},
            resend=self._resend_timer(
                "resendBootstraps", bootstrap,
                state.new_configuration.matchmaker_indices))

    def _handle_bootstrap_ack(self, src: Address,
                              ack: BootstrapAck) -> None:
        if not isinstance(self.state, _Bootstrapping) \
                or ack.epoch != self.state.new_configuration.epoch:
            return
        state = self.state
        state.bootstrap_acks[ack.matchmaker_index] = ack
        # Wait for ALL new matchmakers (Reconfigurer.scala:489-492).
        if len(state.bootstrap_acks) < 2 * self.config.f + 1:
            return
        state.resend.stop()
        self._start_match_phase1(
            state.configuration, state.new_configuration,
            self.round_system.next_classic_round(self.index, -1))

    def _start_match_phase1(self, configuration: MatchmakerConfiguration,
                            new_configuration: MatchmakerConfiguration,
                            round: int) -> None:
        phase1a = MatchPhase1a(matchmaker_configuration=configuration,
                               round=round)
        for i in configuration.matchmaker_indices:
            self.send(self._matchmaker(i), phase1a)
        self.state = _MatchPhase1(
            configuration=configuration,
            new_configuration=new_configuration,
            round=round, phase1bs={},
            resend=self._resend_timer("resendMatchPhase1as", phase1a,
                                      configuration.matchmaker_indices))

    def _handle_match_phase1b(self, src: Address,
                              phase1b: MatchPhase1b) -> None:
        if not isinstance(self.state, _MatchPhase1) \
                or phase1b.epoch != self.state.configuration.epoch \
                or phase1b.round != self.state.round:
            return
        state = self.state
        state.phase1bs[phase1b.matchmaker_index] = phase1b
        if len(state.phase1bs) < self.config.f + 1:
            return
        state.resend.stop()
        # Safe value: highest vote-round vote, else our proposal.
        votes = [p for p in state.phase1bs.values()
                 if p.vote_value is not None]
        value = (max(votes, key=lambda p: p.vote_round).vote_value
                 if votes else state.new_configuration)
        phase2a = MatchPhase2a(
            matchmaker_configuration=state.configuration,
            round=state.round, value=value)
        for i in state.configuration.matchmaker_indices:
            self.send(self._matchmaker(i), phase2a)
        self.state = _MatchPhase2(
            configuration=state.configuration,
            new_configuration=value,
            round=state.round, phase2bs={},
            resend=self._resend_timer(
                "resendMatchPhase2as", phase2a,
                state.configuration.matchmaker_indices))

    def _handle_match_phase2b(self, src: Address,
                              phase2b: MatchPhase2b) -> None:
        if not isinstance(self.state, _MatchPhase2) \
                or phase2b.epoch != self.state.configuration.epoch \
                or phase2b.round != self.state.round:
            return
        state = self.state
        state.phase2bs[phase2b.matchmaker_index] = phase2b
        if len(state.phase2bs) < self.config.f + 1:
            return
        state.resend.stop()
        # Inform the new matchmakers, other reconfigurers, and leaders.
        chosen = MatchChosen(value=state.new_configuration)
        for leader in self.config.leader_addresses:
            self.send(leader, chosen)
        for reconfigurer in self.config.reconfigurer_addresses:
            if reconfigurer != self.address:
                self.send(reconfigurer, chosen)
        for i in state.new_configuration.matchmaker_indices:
            self.send(self._matchmaker(i), chosen)
        self.state = _Idle(configuration=state.new_configuration)

    def _handle_match_chosen(self, src: Address,
                             chosen: MatchChosen) -> None:
        epoch = self.state.configuration.epoch
        if chosen.value.epoch <= epoch:
            return
        if not isinstance(self.state, _Idle):
            self.state.resend.stop()
        self.state = _Idle(chosen.value)

    def _handle_match_nack(self, src: Address, nack: MatchNack) -> None:
        if not isinstance(self.state, (_MatchPhase1, _MatchPhase2)):
            return
        state = self.state
        if nack.epoch != state.configuration.epoch \
                or nack.round <= state.round:
            return
        state.resend.stop()
        self._start_match_phase1(
            state.configuration, state.new_configuration,
            self.round_system.next_classic_round(self.index, nack.round))


@dataclasses.dataclass
class _VoteState:
    vote_round: int
    vote_value: Value


class MMPAcceptor(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerMultiPaxosConfig):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.index = list(config.acceptor_addresses).index(address)
        self.round = -1
        self.votes: dict[int, _VoteState] = {}

    def receive(self, src: Address, message) -> None:
        if isinstance(message, Phase1a):
            if message.round < self.round:
                self.send(src, AcceptorNack(round=self.round))
                return
            self.round = message.round
            info = tuple(
                Phase1bSlotInfo(slot=slot, vote_round=state.vote_round,
                                vote_value=state.vote_value)
                for slot, state in sorted(self.votes.items())
                if slot >= message.chosen_watermark)
            self.send(src, Phase1b(round=message.round,
                                   acceptor_index=self.index, info=info))
        elif isinstance(message, Phase2a):
            if message.round < self.round:
                self.send(src, AcceptorNack(round=self.round))
                return
            self.round = message.round
            self.votes[message.slot] = _VoteState(message.round,
                                                  message.value)
            self.send(src, Phase2b(slot=message.slot, round=message.round,
                                   acceptor_index=self.index))
        else:
            self.logger.fatal(f"unexpected acceptor message {message!r}")


class MMPReplica(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerMultiPaxosConfig,
                 state_machine: StateMachine):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.state_machine = state_machine
        self.index = list(config.replica_addresses).index(address)
        self.log: BufferMap = BufferMap()
        self.executed_watermark = 0
        self.client_table: dict[tuple, tuple[int, bytes]] = {}

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, Chosen):
            self.logger.fatal(f"unexpected replica message {message!r}")
        if self.log.get(message.slot) is None:
            self.log.put(message.slot, message.value)
        while True:
            value = self.log.get(self.executed_watermark)
            if value is None:
                return
            slot = self.executed_watermark
            self.executed_watermark += 1
            if isinstance(value, Noop):
                continue
            cid = value.command_id
            key = (cid.client_address, cid.client_pseudonym)
            cached = self.client_table.get(key)
            if cached is not None and cid.client_id < cached[0]:
                continue
            if cached is not None and cid.client_id == cached[0]:
                result = cached[1]
            else:
                result = self.state_machine.run(value.command)
                self.client_table[key] = (cid.client_id, result)
            if slot % len(self.config.replica_addresses) == self.index:
                self.send(cid.client_address,
                          ClientReply(command_id=cid, result=result))


@dataclasses.dataclass
class _PendingWrite:
    id: int
    command: bytes
    callback: Callable[[bytes], None]
    resend: object


class MMPClient(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerMultiPaxosConfig,
                 resend_period_s: float = 10.0, seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.resend_period_s = resend_period_s
        self.ids: dict[int, int] = {}
        self.pending: dict[int, _PendingWrite] = {}

    def write(self, pseudonym: int, command: bytes,
              callback: Optional[Callable[[bytes], None]] = None) -> None:
        if pseudonym in self.pending:
            raise RuntimeError(f"pseudonym {pseudonym} has a pending op")
        id = self.ids.get(pseudonym, 0)
        request = ClientRequest(Command(
            CommandId(self.address, pseudonym, id), command))

        def send_it():
            for leader in self.config.leader_addresses:
                self.send(leader, request)

        def resend():
            send_it()
            timer.start()

        send_it()
        timer = self.timer(f"resend-{pseudonym}", self.resend_period_s,
                           resend)
        timer.start()
        self.pending[pseudonym] = _PendingWrite(id, command,
                                                callback or (lambda _: None),
                                                timer)
        self.ids[pseudonym] = id + 1

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, ClientReply):
            self.logger.fatal(f"unexpected client message {message!r}")
        pending = self.pending.get(message.command_id.client_pseudonym)
        if pending is None or pending.id != message.command_id.client_id:
            return
        pending.resend.stop()
        del self.pending[message.command_id.client_pseudonym]
        pending.callback(message.result)


# --- driver-based chaos workloads ------------------------------------------
# (jvm/.../matchmakermultipaxos/Driver.scala + DriverWorkload.proto: the
# scripted schedules behind the VLDB'20 matchmaker experiments --
# repeated acceptor reconfiguration, matchmaker epoch changes, leader
# failure, and the combined Chaos schedule.)


@dataclasses.dataclass(frozen=True)
class DriverDoNothing:
    pass


@dataclasses.dataclass(frozen=True)
class DriverRepeatedReconfiguration:
    """Every ``period_s`` (after ``delay_s``), reconfigure the acceptor
    set to a random 2f+1 subset (DriverWorkload.proto:14-18)."""

    delay_s: float
    period_s: float


@dataclasses.dataclass(frozen=True)
class DriverMatchmakerReconfiguration:
    """Warmup acceptor reconfigurations, then matchmaker epoch changes
    (DriverWorkload.proto:31-41)."""

    warmup_delay_s: float
    warmup_period_s: float
    warmup_num: int
    matchmaker_delay_s: float
    matchmaker_period_s: float
    matchmaker_num: int


@dataclasses.dataclass(frozen=True)
class DriverChaos:
    """The combined chaos schedule (DriverWorkload.proto:50-66):
    warmups, then a matchmaker failure and recovery-by-epoch-change,
    plus an acceptor-set failure and recovery."""

    warmup_delay_s: float
    warmup_period_s: float
    warmup_num: int
    matchmaker_failure_delay_s: float
    matchmaker_recover_delay_s: float
    acceptor_failure_delay_s: float
    acceptor_recover_delay_s: float


MMPDriverWorkload = Union[DriverDoNothing, DriverRepeatedReconfiguration,
                          DriverMatchmakerReconfiguration, DriverChaos]


class MMPDriver(Actor):
    """Executes a scripted chaos schedule against a MatchmakerMultiPaxos
    deployment (Driver.scala:30+): acceptor reconfigurations via the
    reconfigurer's Reconfigure broadcast, matchmaker epoch changes via
    ReconfigureMatchmakers, matchmaker deaths via Die."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MatchmakerMultiPaxosConfig,
                 workload: MMPDriverWorkload, seed: int = 0):
        super().__init__(address, transport, logger)
        self.config = config
        self.workload = workload
        self.rng = random.Random(seed)
        self.timers: list = []
        # Last known matchmaker epoch; refreshed by MatchChosen bounces
        # from the reconfigurer when this falls behind.
        self.matchmaker_configuration = initial_matchmaker_configuration(
            config.f)
        self._killed: set[int] = set()
        self._start()

    # --- actions -----------------------------------------------------------
    def reconfigure_acceptors(self) -> None:
        n = len(self.config.acceptor_addresses)
        subset = self.rng.sample(range(n), 2 * self.config.f + 1)
        message = Reconfigure(
            quorum_system_to_dict(SimpleMajority(subset)))
        for leader in self.config.leader_addresses:
            self.send(leader, message)

    def reconfigure_matchmakers(self) -> None:
        # Never bootstrap an epoch onto a matchmaker this driver killed:
        # Bootstrap needs every new matchmaker to ack.
        candidates = [i for i in range(len(
            self.config.matchmaker_addresses)) if i not in self._killed]
        needed = 2 * self.config.f + 1
        if len(candidates) < needed:
            self.logger.warn(
                f"only {len(candidates)} live matchmakers; epoch change "
                f"needs {needed} -- skipped")
            return
        subset = sorted(self.rng.sample(candidates, needed))
        self.send(self.config.reconfigurer_addresses[0],
                  ReconfigureMatchmakers(
                      matchmaker_configuration=
                      self.matchmaker_configuration,
                      new_matchmaker_indices=tuple(subset)))

    def kill_matchmaker(self, index: int) -> None:
        self._killed.add(index)
        self.send(self.config.matchmaker_addresses[index], Die())

    # --- schedule wiring ---------------------------------------------------
    def _delayed_repeating(self, name: str, delay_s: float,
                           period_s: float, n: int, fire) -> None:
        self.timers += delayed_repeating(self, name, delay_s, period_s, n,
                                         fire)

    def _once(self, name: str, delay_s: float, fire) -> None:
        t = self.timer(name, delay_s, fire)
        t.start()
        self.timers.append(t)

    def _start(self) -> None:
        w = self.workload
        if isinstance(w, DriverDoNothing):
            return
        if isinstance(w, DriverRepeatedReconfiguration):
            self.timers += repeating(self, "reconfigure", w.delay_s,
                                     w.period_s,
                                     self.reconfigure_acceptors)
            return
        if isinstance(w, DriverMatchmakerReconfiguration):
            self._delayed_repeating("warmup", w.warmup_delay_s,
                                    w.warmup_period_s, w.warmup_num,
                                    self.reconfigure_acceptors)
            self._delayed_repeating("mmReconfigure", w.matchmaker_delay_s,
                                    w.matchmaker_period_s,
                                    w.matchmaker_num,
                                    self.reconfigure_matchmakers)
            return
        if isinstance(w, DriverChaos):
            self._delayed_repeating("warmup", w.warmup_delay_s,
                                    w.warmup_period_s, w.warmup_num,
                                    self.reconfigure_acceptors)
            self._once("matchmakerFailure", w.matchmaker_failure_delay_s,
                       lambda: self.kill_matchmaker(self.rng.choice(
                           self.matchmaker_configuration
                           .matchmaker_indices)))
            self._once("matchmakerRecover", w.matchmaker_recover_delay_s,
                       self.reconfigure_matchmakers)
            self._once("acceptorFailure", w.acceptor_failure_delay_s,
                       self.reconfigure_acceptors)
            self._once("acceptorRecover", w.acceptor_recover_delay_s,
                       self.reconfigure_acceptors)
            return
        self.logger.fatal(f"unknown driver workload {w!r}")

    def receive(self, src: Address, message) -> None:
        if isinstance(message, MatchChosen):
            # The reconfigurer bounced a stale-epoch request; retry with
            # the fresh epoch so scheduled churn isn't silently halved.
            self.matchmaker_configuration = message.value
            self.reconfigure_matchmakers()
            return
        self.logger.fatal(f"driver got unexpected message {message!r}")

# Importing registers the steady-state binary codecs with the hybrid
# serializer (see matchmakermultipaxos_wire.py).
from frankenpaxos_tpu_torch.protocols import matchmakermultipaxos_wire  # noqa: E402,F401
