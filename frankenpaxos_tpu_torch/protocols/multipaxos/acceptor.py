"""MultiPaxos Acceptor (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/acceptor.py``).

Reference behavior: multipaxos/Acceptor.scala:59-255. Per-slot
{vote_round, vote_value} state, a single monotone ``round``, nacks for
stale rounds (Phase2a nacks go to the round's *leader*, not the proxy
leader that forwarded it), ``max_voted_slot`` serving quorum reads.

With ``wal=`` (a ``wal.Wal``) promises, votes, runs and epochs are
logged and every ack that depends on one leaves after the drain's
group-commit fsync (``wal.DurableRole``); a restart recovers them. The
acceptor is the matchmaker of reconfiguration: it logs each EpochCommit
before it acks it and reports the epochs it holds in every Phase1b.

Not ported yet, and refused: the read batchers' BatchMaxSlotRequest
(ROADMAP.md queue 1 item 8.3).
"""

from __future__ import annotations

import dataclasses
try:
    from sortedcontainers import SortedDict  # type: ignore[import-untyped]
except ImportError:  # stripped environments: pure-Python fallback
    from frankenpaxos_tpu_torch.utils.sorted_compat import SortedDict

from frankenpaxos_tpu_torch import native
from frankenpaxos_tpu_torch.protocols.multipaxos.config import MultiPaxosConfig
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    BatchMaxSlotRequest,
    CommandBatchOrNoop,
    MaxSlotReply,
    MaxSlotRequest,
    Nack,
    Phase1a,
    Phase1b,
    Phase1bSlotInfo,
    Phase2a,
    Phase2aRun,
    Phase2b,
    Phase2bRange,
    Phase2bVotes,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    decode_value,
    decode_value_array,
    encode_value,
    encode_value_array,
)
from frankenpaxos_tpu_torch.reconfig import (
    decode_epoch_config,
    encode_epoch_config,
    EpochAck,
    EpochCommit,
)
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.wal import (
    DurableRole,
    WalEpoch,
    WalPromise,
    WalSnapshot,
    WalVote,
    WalVoteRun,
)
import numpy as np


@dataclasses.dataclass(frozen=True)
class AcceptorOptions:
    measure_latencies: bool = True
    # Ack contiguous same-round Phase2a runs voted within one event-loop
    # drain as ONE Phase2bRange per proxy leader (see
    # messages.Phase2bRange). Lone votes still go as plain Phase2bs, so
    # per-message delivery (the adversarial sims) is byte-identical to
    # the reference shape.
    range_phase2bs: bool = True


@dataclasses.dataclass
class _VoteState:
    vote_round: int
    vote_value: CommandBatchOrNoop


class Acceptor(Actor, DurableRole):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MultiPaxosConfig,
                 options: AcceptorOptions = AcceptorOptions(),
                 collectors: Collectors | None = None, wal=None):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        collectors = collectors or FakeCollectors()
        self.metrics_latency = collectors.summary(
            "multipaxos_acceptor_requests_latency_seconds", labels=("type",))
        self.metrics_requests = collectors.counter(
            "multipaxos_acceptor_requests_total", labels=("type",))
        self.group_index = next(
            g for g, group in enumerate(config.acceptor_addresses)
            if address in group)
        self.index = list(
            config.acceptor_addresses[self.group_index]).index(address)
        self.round_system = ClassicRoundRobin(config.num_leaders)
        self.round = -1
        self.states: SortedDict = SortedDict()  # slot -> _VoteState
        # Committed reconfiguration epochs (reconfig/):
        # epoch id -> EpochCommit, round-monotone per id. The acceptor
        # is a MATCHMAKER for the epoch map: entries are WAL'd before
        # the EpochAck leaves (group commit), and every Phase1b reports
        # them so a new leader's read quorum always discovers activated
        # epochs (the Flexible-Paxos intersection condition).
        self._epoch_commits: dict[int, EpochCommit] = {}
        # Run-voted state (Phase2aRun): start -> (end, round, values) --
        # one O(1) record per run instead of per-slot _VoteStates. A
        # slot's authoritative vote is the HIGHEST round across both
        # stores (see _voted_info); the acceptor's monotone ``round``
        # means later votes never have a lower round, and equal-round
        # double-votes carry the same value (one proposal per
        # (slot, round)), so max-round resolution is exact.
        self._voted_runs: SortedDict = SortedDict()
        self.max_voted_slot = -1
        # Phase2b acks staged during this drain: dst -> [(slot, round)].
        self._pending_phase2bs: dict[Address, list] = {}
        # Durability (wal/): promises and votes append to the WAL as
        # they are handled, and every ack that DEPENDS on one is held
        # back until on_drain's single group-commit fsync releases it
        # (DurableRole) -- a crashed acceptor can therefore never have
        # acked state it will not recover. wal=None (the default) is
        # the reference's in-memory behavior.
        self._wal_init(wal)
        if wal is not None:
            self._recover_from_wal()

    # --- durability -------------------------------------------------------
    def _recover_from_wal(self) -> None:
        for record in self.wal.recover(self.logger):
            if isinstance(record, WalSnapshot):
                # A compaction base: everything replayed so far is
                # superseded state re-logged after this marker.
                self.round = -1
                self.states.clear()
                self._voted_runs.clear()
                self.max_voted_slot = -1
            elif isinstance(record, WalPromise):
                self.round = max(self.round, record.round)
            elif isinstance(record, WalVote):
                self.round = max(self.round, record.round)
                self.states[record.slot] = _VoteState(
                    record.round, decode_value(record.value))
                self.max_voted_slot = max(self.max_voted_slot,
                                          record.slot)
            elif isinstance(record, WalVoteRun):
                self.round = max(self.round, record.round)
                self._store_run(record.start_slot, record.round,
                                decode_value_array(record.values))
            elif isinstance(record, WalEpoch):
                epoch, start, f, rnd, members = decode_epoch_config(
                    record.payload)
                known = self._epoch_commits.get(epoch)
                if known is None or rnd > known.round:
                    self._epoch_commits[epoch] = EpochCommit(
                        epoch=epoch, start_slot=start, f=f, round=rnd,
                        members=members)
            else:
                self.logger.fatal(
                    f"unexpected acceptor WAL record {record!r}")

    def _wal_compact(self) -> None:
        """Rewrite the log as one snapshot marker + the live voted
        state (one fsync), reclaiming every older segment."""
        records = [WalPromise(round=self.round)]
        for epoch in sorted(self._epoch_commits):
            c = self._epoch_commits[epoch]
            records.append(WalEpoch(payload=encode_epoch_config(
                c.epoch, c.start_slot, c.f, c.round, c.members)))
        for start, (end, rnd, values) in self._voted_runs.items():
            records.append(WalVoteRun(
                start_slot=start, stride=1, round=rnd,
                values=encode_value_array(values)))
        for slot, vs in self.states.items():
            records.append(WalVote(
                slot=slot, round=vs.vote_round,
                value=encode_value(vs.vote_value)))
        self.wal.compact(WalSnapshot(payload=b""), records)

    def receive(self, src: Address, message) -> None:
        # timed(label) handler latency summaries (Leader.scala:281-293).
        if self.options.measure_latencies:
            with self.metrics_latency.labels(
                    type(message).__name__).time():
                self._receive_impl(src, message)
        else:
            self._receive_impl(src, message)

    def _receive_impl(self, src: Address, message) -> None:
        if isinstance(message, Phase1a):
            self.metrics_requests.labels("Phase1a").inc()
            self._handle_phase1a(src, message)
        elif isinstance(message, Phase2a):
            self.metrics_requests.labels("Phase2a").inc()
            self._handle_phase2a(src, message)
        elif isinstance(message, Phase2aRun):
            self.metrics_requests.labels("Phase2aRun").inc()
            self._handle_phase2a_run(src, message)
        elif isinstance(message, MaxSlotRequest):
            self.metrics_requests.labels("MaxSlotRequest").inc()
            self._handle_max_slot_request(src, message)
        elif isinstance(message, BatchMaxSlotRequest):
            raise NotImplementedError(
                "BatchMaxSlotRequest: read batchers are not ported yet "
                "(ROADMAP.md queue 1 item 8.3: read batchers)")
        elif isinstance(message, EpochCommit):
            self.metrics_requests.labels("EpochCommit").inc()
            self._handle_epoch_commit(src, message)
        else:
            self.logger.fatal(f"unexpected acceptor message {message!r}")

    def _handle_epoch_commit(self, src: Address,
                             commit: EpochCommit) -> None:
        """Store one epoch map entry (round-monotone per epoch id),
        WAL it, and ack only after the drain's group commit -- the
        matchmaker write: f+1 of these durable acks IS the epoch's
        commit point."""
        if commit.round < self.round:
            # A stale leader defining epochs: nack so it re-runs Phase1
            # (mirroring the Phase2a round check).
            self.send(src, Nack(round=self.round))
            return
        known = self._epoch_commits.get(commit.epoch)
        if known is None or commit.round > known.round:
            self._epoch_commits[commit.epoch] = commit
            if self.wal is not None and known != commit:
                self.wal.append(WalEpoch(payload=encode_epoch_config(
                    commit.epoch, commit.start_slot, commit.f,
                    commit.round, commit.members)))
        elif known is not None and commit.round == known.round \
                and known != commit:
            self.logger.fatal(
                f"conflicting EpochCommits at one round: {known!r} "
                f"vs {commit!r}")
        # Duplicate commits re-ack (the leader's resend protocol).
        self._wal_send(src, EpochAck(epoch=commit.epoch,
                                     round=commit.round))

    def _handle_phase1a(self, src: Address, phase1a: Phase1a) -> None:
        if phase1a.round < self.round:
            self.logger.debug(
                f"acceptor got Phase1a in round {phase1a.round} but is in "
                f"round {self.round}")
            self.send(src, Nack(round=self.round))
            return
        if self.wal is not None and phase1a.round > self.round:
            self.wal.append(WalPromise(round=phase1a.round))
        self.round = phase1a.round
        # The promise must be durable before the leader may trust it
        # (a crashed acceptor re-promising a lower round would let two
        # leaders both believe they own a round): held for group
        # commit.
        self._wal_send(src, Phase1b(
            group_index=self.group_index, acceptor_index=self.index,
            round=self.round,
            info=self._voted_info(phase1a.chosen_watermark),
            epochs=tuple(self._epoch_commits[e]
                         for e in sorted(self._epoch_commits))))

    def _voted_info(self, minimum: int) -> tuple:
        """Every voted slot >= ``minimum`` with its HIGHEST-round vote,
        merging the per-slot store and the run store (a failover that
        ignored run votes would recover Noop over accepted values --
        data loss). Recovery-only cold path, so runs expand per slot
        here and nowhere else."""
        best: dict[int, tuple] = {
            slot: (self.states[slot].vote_round,
                   self.states[slot].vote_value)
            for slot in self.states.irange(minimum=minimum)}
        for start, (end, rnd, values) in self._voted_runs.items():
            if end <= minimum:
                continue
            for slot in range(max(start, minimum), end):
                cur = best.get(slot)
                if cur is None or rnd > cur[0]:
                    best[slot] = (rnd, values[slot - start])
        return tuple(
            Phase1bSlotInfo(slot=slot, vote_round=rnd, vote_value=value)
            for slot, (rnd, value) in sorted(best.items()))

    def _handle_phase2a(self, src: Address, phase2a: Phase2a) -> None:
        if phase2a.round < self.round:
            self.logger.debug(
                f"acceptor got Phase2a in round {phase2a.round} but is in "
                f"round {self.round}")
            # Nack the round's leader, not the forwarding proxy leader
            # (Acceptor.scala:184-200).
            leader = self.config.leader_addresses[
                self.round_system.leader(phase2a.round)]
            self.send(leader, Nack(round=self.round))
            return
        self.round = phase2a.round
        self.states[phase2a.slot] = _VoteState(vote_round=self.round,
                                               vote_value=phase2a.value)
        self.max_voted_slot = max(self.max_voted_slot, phase2a.slot)
        if self.wal is not None:
            self.wal.append(WalVote(
                slot=phase2a.slot, round=self.round,
                value=encode_value(phase2a.value)))
        if self.options.range_phase2bs:
            # Stage the ack; on_drain coalesces contiguous runs per
            # destination into Phase2bRanges (and, durable, releases
            # them only after the drain's group commit).
            self._pending_phase2bs.setdefault(src, []).append(
                (phase2a.slot, self.round))
        else:
            self._wal_send(src, Phase2b(group_index=self.group_index,
                                        acceptor_index=self.index,
                                        slot=phase2a.slot,
                                        round=self.round))

    def _handle_phase2a_run(self, src: Address, run: Phase2aRun) -> None:
        """A whole contiguous proposal run in one O(1) update: one round
        check, one run record, one ranged ack -- the per-drain shape of
        Acceptor.scala:184-220's per-slot handlePhase2a."""
        if run.round < self.round:
            leader = self.config.leader_addresses[
                self.round_system.leader(run.round)]
            self.send(leader, Nack(round=self.round))
            return
        self.round = run.round
        end = self._store_run(run.start_slot, run.round, run.values)
        if self.wal is not None:
            # Logging the run re-encodes its value array -- a RAW COPY
            # of the inbound lazy segment, never a re-materialization.
            self.wal.append(WalVoteRun(
                start_slot=run.start_slot, stride=1, round=run.round,
                values=encode_value_array(run.values)))
        # Ack immediately as one range: the run is already a contiguous
        # same-round block, so drain-end staging (whose merge loop is
        # per-slot) would cost Python without saving messages. Durable
        # mode holds it for the drain's group commit instead.
        self._wal_send(src, Phase2bRange(group_index=self.group_index,
                                         acceptor_index=self.index,
                                         slot_start_inclusive=run.start_slot,
                                         slot_end_exclusive=end,
                                         round=run.round))

    def _store_run(self, start_slot: int, round: int, values) -> int:
        """Merge one contiguous voted run into the run store; returns
        the run's exclusive end. Shared by the live Phase2aRun handler
        and WAL replay so truncation-tail semantics cannot drift."""
        end = start_slot + len(values)
        old = self._voted_runs.get(start_slot)
        self._voted_runs[start_slot] = (end, round, values)
        if old is not None and old[0] > end:
            # A shorter same-start run replaces a longer record (a
            # re-proposed prefix after leader change): the non-overlapped
            # voted tail [end, old_end) must survive as its own record,
            # or Phase1 recovery would lose those votes (choosing Noop
            # over accepted values). ``end`` cannot equal an existing
            # start (same-start keys collide only at run.start_slot), so
            # this insert never clobbers a longer record.
            old_end, old_round, old_values = old
            tail = old_values[end - start_slot:]
            if self._voted_runs.get(end) is None:
                self._voted_runs[end] = (old_end, old_round, tail)
            else:
                # A record already starts at ``end``: spill the tail
                # into the per-slot store instead of clobbering it
                # (_voted_info max-round-merges both stores).
                for off, slot in enumerate(range(end, old_end)):
                    cur = self.states.get(slot)
                    if cur is None or cur.vote_round < old_round:
                        self.states[slot] = _VoteState(old_round,
                                                       tail[off])
        self.max_voted_slot = max(self.max_voted_slot, end - 1)
        return end

    def on_drain(self) -> None:
        pending, self._pending_phase2bs = self._pending_phase2bs, {}
        for dst, acks in pending.items():
            acks.sort()
            runs = self._runs_of(acks)
            # A heavily FRAGMENTED drain (thrifty sampling shreds the
            # proxy's contiguous Phase2a run into short per-acceptor
            # pieces) ships as ONE packed-array message instead of one
            # message per run: packed here, the ProxyLeader unpacks
            # straight into its tracker's arrays -- per-vote Python
            # disappears from both sides.
            if len(runs) > 4 and len(acks) >= 16:
                slots = np.fromiter((s for s, _ in acks), dtype=np.int64,
                                    count=len(acks))
                rounds = np.fromiter((r for _, r in acks), dtype=np.int32,
                                     count=len(acks))
                self._wal_send(dst, Phase2bVotes(
                    group_index=self.group_index,
                    acceptor_index=self.index,
                    packed=native.pack_votes2(slots, rounds)))
                continue
            for run in runs:
                if len(run) == 1:
                    self._wal_send(dst, Phase2b(
                        group_index=self.group_index,
                        acceptor_index=self.index,
                        slot=run[0][0], round=run[0][1]))
                else:
                    self._wal_send(dst, Phase2bRange(
                        group_index=self.group_index,
                        acceptor_index=self.index,
                        slot_start_inclusive=run[0][0],
                        slot_end_exclusive=run[-1][0] + 1,
                        round=run[0][1]))
        # GROUP COMMIT (DurableRole): one fsync covers every record
        # this drain appended, then -- and only then -- the acks it
        # produced go out.
        self._wal_drain()

    @staticmethod
    def _runs_of(acks: list) -> list:
        """Split sorted (slot, round) acks into contiguous same-round
        runs."""
        runs = []
        start = 0
        for i in range(1, len(acks) + 1):
            if (i < len(acks)
                    and acks[i][0] == acks[i - 1][0] + 1
                    and acks[i][1] == acks[i - 1][1]):
                continue
            runs.append(acks[start:i])
            start = i
        return runs

    def _handle_max_slot_request(self, src: Address,
                                 request: MaxSlotRequest) -> None:
        self.send(src, MaxSlotReply(command_id=request.command_id,
                                    group_index=self.group_index,
                                    acceptor_index=self.index,
                                    slot=self.max_voted_slot))
