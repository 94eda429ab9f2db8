"""WPaxos Leader: one per zone, owning a subset of the object groups
(the port's copy of ``frankenpaxos_tpu/protocols/wpaxos/leader.py``).

Steady state (the latency win the whole subsystem exists for): a
client in the home zone sends WRequest -> the leader assigns the next
slot in the group's log and Phase2a's its OWN ZONE'S acceptor row ->
a row majority acks -> chosen. Nothing crosses a zone boundary.

An object STEAL is a paxepoch-flavored epoch change (docs/GEO.md):

  stealer --WPhase1a(group, ballot, epoch)--> every acceptor
  acceptor: WAL the promise, THEN --WPhase1b--> stealer (group commit)
  stealer: read quorum (a majority of EVERY row -- which contains a
           row-majority of the old home zone: the f+1 old-epoch
           durable acks) => epoch COMMITTED; adopt in-flight votes,
           set start_slot to the chosen watermark (the handover
           bound), re-propose the unchosen tail under the new ballot,
           broadcast WEpochCommit until a read quorum of acceptors
           acked it durably.

Vote counting is drain-granular through ``geo.GeoQuorumTracker``: the
dict oracle, or (``quorum_backend="cuda"``) the port's
``EpochSegmentedChecker`` with K6 per 256 votes of a drain and each
slot's quorum plane selected by its steal epoch; every advance of a
group's chosen watermark releases the board's columns through K5.
``device`` reaches the trackers (``cuda`` when None).

Admission control (the ``admission_*`` options, ``serve/admission.py``):
a refused request's client gets an explicit ``Rejected``, and every
drain resyncs the in-flight budget to the open proposals. With a
``RuntimeMetrics`` on the transport every drain exports this leader's
commits and its running rejected delta, labeled with its zone's region
(``region_goodput`` / ``region_shed``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch, ObjectEpochStore
from frankenpaxos_tpu_torch.geo.quorum import GeoQuorumTracker
from frankenpaxos_tpu_torch.protocols.wpaxos.config import WPaxosConfig
from frankenpaxos_tpu_torch.protocols.wpaxos.messages import (
    Command,
    CommandBatch,
    NOOP,
    Steal,
    WChosen,
    WEpochAck,
    WEpochCommit,
    WNack,
    WNotOwner,
    WPhase1a,
    WPhase1b,
    WPhase2a,
    WPhase2b,
    WRecover,
    WReply,
    WRequest,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class WPaxosLeaderOptions:
    resend_phase1a_period_s: float = 1.0
    resend_epoch_commit_period_s: float = 1.0
    #: Base delay before RETRYING a nacked steal at an escalated
    #: ballot (randomized +-50% per leader). Immediate re-escalation
    #: turns two leaders racing for one group into a ballot duel at
    #: network speed -- the classic dueling-proposers livelock, seen
    #: as a stalled deployed smoke on a contended host.
    steal_backoff_s: float = 0.25
    # paxchaos adaptive placement: per-group request-origin EWMA on
    # the OWNING leader, evaluated on a timer. When a REMOTE zone's
    # share of a group's traffic stays above ``placement_dominance``
    # for ``placement_hysteresis_checks`` consecutive checks AND the
    # group has been owned at least ``placement_min_dwell_s``, the
    # owner hands the group off (sends the dominant zone's leader a
    # Steal trigger). Hysteresis + min-dwell are what make the PR 13
    # boomerang (instant re-steal wars) unconstructible: a freshly
    # moved group cannot move again until it has both dwelled and
    # re-proven a different dominant origin. 0 (the default) disables
    # the whole policy -- no timer, no counters, no hot-path cost
    # beyond one None test per owned-group request.
    placement_check_period_s: float = 0.0
    placement_ewma_alpha: float = 0.5
    placement_dominance: float = 0.6
    placement_min_dwell_s: float = 1.0
    placement_hysteresis_checks: int = 2
    placement_min_samples: int = 4
    quorum_backend: str = "dict"     # "dict" oracle | "cuda" (K6, K5)
    tpu_window: int = 4096
    recover_reply_limit: int = 256
    # paxload admission control (serve/admission.py): flat knobs.
    # All-zero = no controller; the admission-off hot path is one None
    # test.
    admission_token_rate: float = 0.0
    admission_token_burst: float = 0.0
    admission_inflight_limit: int = 0
    admission_inbox_capacity: int = 0
    admission_inbox_policy: str = "reject"
    admission_codel_target_s: float = 0.0
    admission_codel_interval_s: float = 0.1
    admission_retry_after_ms: int = 0

    def admission_options(self):
        from frankenpaxos_tpu_torch.serve.admission import options_from_flat

        return options_from_flat(self)


@dataclasses.dataclass
class _Group:
    """Leadership state for one OWNED (active) group."""

    ballot: int
    next_slot: int
    # slot -> (value, client address | None, CommandId | None)
    proposals: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Steal:
    ballot: int
    epoch: int
    phase1bs: dict = dataclasses.field(default_factory=dict)
    buffered: list = dataclasses.field(default_factory=list)
    started_at: float = 0.0


class WPaxosLeader(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: WPaxosConfig,
                 options: WPaxosLeaderOptions = WPaxosLeaderOptions(),
                 device=None):
        if options.quorum_backend not in ("dict", "cuda"):
            raise ValueError(
                f"quorum_backend must be 'dict' or 'cuda', got "
                f"{options.quorum_backend!r}")
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        self.zone = config.leader_addresses.index(address)
        self.grid = config.grid()
        self._read_spec = self.grid.read_spec()
        self._acceptor_ids = {
            addr: config.acceptor_id(zone, i)
            for zone, row in enumerate(config.acceptor_addresses)
            for i, addr in enumerate(row)}
        self.epochs = ObjectEpochStore(config.num_groups,
                                       config.initial_home)
        self.trackers = [
            GeoQuorumTracker(self.epochs, g, self.grid,
                             backend=options.quorum_backend,
                             window=options.tpu_window, device=device)
            for g in range(config.num_groups)]
        # Groups this leader currently owns and may propose in.
        # ALWAYS acquired through a steal (even a group whose initial
        # home is this zone -- the first request triggers a self-steal
        # at a fresh ballot): a leader that crashed and restarted
        # amnesiac can therefore never reuse a ballot it already
        # proposed under, which is what makes leaders safely
        # WAL-free. Epoch-0 entries are routing hints only.
        self.active: dict[int, _Group] = {}
        self.stealing: dict[int, _Steal] = {}
        # Per-group chosen log + contiguous chosen watermark. Kept for
        # the leader's tenure AND after losing ownership (replicas
        # recover holes from any leader that remembers the value).
        self.chosen: list[dict] = [dict()
                                   for _ in range(config.num_groups)]
        self.chosen_watermark: list[int] = [0] * config.num_groups
        # Duplicate suppression: (group, client, pseudonym) ->
        # [max client_id seen, cached result or None, slot].
        self._dedup: dict = {}
        # Highest ballot ever refused to us per group (nack floor).
        self._ballot_floor: dict[int, int] = {}
        self._dirty: set[int] = set()
        # WChosen/WReply staged during the current handler/drain;
        # shipped as ONE transport batch per destination (paxwire:
        # one writev, coalesced batch frames) by _flush_chosen.
        self._chosen_outbox: list = []
        self._reply_outbox: list = []
        # Steal telemetry for bench/geo_lt.py: group -> dict with
        # virtual timestamps (started/active/first_commit).
        self.steal_events: list[dict] = []
        self._open_steal_events: dict[int, dict] = {}
        # Virtual clock when the transport has one, wall clock
        # otherwise (steal telemetry AND the admission controller's
        # token bucket both need a clock that actually advances).
        if hasattr(transport, "now"):
            self._clock = lambda: transport.now
        else:
            import time

            self._clock = time.monotonic
        # String-seeded (sha512 -- deterministic across processes) so
        # sims replay identically; only the steal-retry jitter draws
        # from it.
        self._rng = random.Random(f"wpaxos-leader|{self.zone}")
        self._phase1_timers: dict[int, object] = {}
        self._steal_retry_timers: dict[int, object] = {}
        # paxchaos adaptive placement (armed only by the knob -- the
        # unarmed path carries one None test per owned-group request).
        self._placement = None
        if options.placement_check_period_s > 0:
            self._placement = {
                "counts": {},    # group -> {origin zone: ewma weight}
                "streak": {},    # group -> [dominant zone, checks]
                "acquired": {},  # group -> clock() at activation
            }
            #: Completed hand-offs, for the scenario telemetry:
            #: dicts of group / to_zone / t_s / share.
            self.placement_handoffs: list = []
            timer = self.timer("placementCheck",
                               options.placement_check_period_s,
                               self._placement_check)
            self._placement_timer = timer
            timer.start()
        # group -> (timer, entry, set of acked acceptor ids)
        self._epoch_resends: dict[int, tuple] = {}
        # paxload admission (serve/): built only when a knob arms it.
        self._rejected_exported = 0
        admission_options = options.admission_options()
        if admission_options is not None:
            from frankenpaxos_tpu_torch.serve.admission import (
                AdmissionController,
            )

            self.admission = AdmissionController(
                admission_options, role=f"wpaxos_leader_{self.zone}",
                clock=self._clock,
                metrics=transport.runtime_metrics)
            transport.note_admission(address, self)

    # --- handlers -----------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, WPhase2b):
            self._handle_phase2b(src, message)
        elif isinstance(message, WRequest):
            self._handle_request(src, message)
        elif isinstance(message, WPhase1b):
            self._handle_phase1b(src, message)
        elif isinstance(message, WNack):
            self._handle_nack(src, message)
        elif isinstance(message, WEpochCommit):
            self._handle_epoch_commit(src, message)
        elif isinstance(message, WEpochAck):
            self._handle_epoch_ack(src, message)
        elif isinstance(message, WRecover):
            self._handle_recover(src, message)
        elif isinstance(message, Steal):
            self.steal(message.group)
        else:
            self.logger.fatal(f"unexpected leader message {message!r}")

    # --- the client path ----------------------------------------------------
    def _handle_request(self, src: Address, m: WRequest) -> None:
        group = m.group
        if not 0 <= group < self.config.num_groups:
            return
        if group in self.active:
            if self._placement is not None and m.origin_zone >= 0:
                counts = self._placement["counts"].setdefault(group, {})
                counts[m.origin_zone] = counts.get(m.origin_zone, 0.0) \
                    + 1.0
            self._admit_and_propose(src, m)
            return
        steal = self.stealing.get(group)
        if steal is not None:
            steal.buffered.append((src, m))
            return
        entry = self.epochs.current(group)
        if m.steal or entry.home_zone == self.zone:
            floor = self._ballot_floor.get(group, -1)
            if not m.steal and floor > entry.ballot \
                    and self.config.ballot_zone(floor) != self.zone:
                # Our epoch store says this is our home group, but we
                # have already been NACKED at a higher ballot whose
                # zone-partitioned number names another zone's leader:
                # a steal is in flight (or committed) and its
                # WEpochCommit just has not reached us yet. Redirect
                # the client there instead of stealing our old home
                # straight back -- the boomerang re-steal otherwise
                # turns every planned migration into a ballot war
                # (follow-the-sun found this: the sun could never set
                # on a zone with any residual traffic). The hint is
                # routing advice only; if the preemptor is actually
                # dead, the client's failover budget comes back with
                # steal=True, which bypasses this branch.
                self.send(src, WNotOwner(
                    group=group, command_id=m.command.command_id,
                    home_zone=self.config.ballot_zone(floor),
                    ballot=floor))
                return
            # Failover resend (the client gave up on the home zone),
            # or our own un-acquired home group (bootstrap, or an
            # amnesiac restart): acquire it with a fresh-ballot steal.
            self.steal(group, buffered=(src, m))
            return
        self.send(src, WNotOwner(
            group=group, command_id=m.command.command_id,
            home_zone=entry.home_zone, ballot=entry.ballot))

    def _admit_and_propose(self, src: Address, m: WRequest) -> None:
        cid = m.command.command_id
        key = (m.group, cid.client_address, cid.client_pseudonym)
        entry = self._dedup.get(key)
        if entry is not None and cid.client_id < entry[0]:
            return  # superseded: the client has moved on
        if entry is not None and cid.client_id == entry[0]:
            if entry[1] is not None:
                self.send(src, WReply(command_id=cid, group=m.group,
                                      slot=entry[2], result=entry[1]))
            elif entry[2] in self.active[m.group].proposals:
                # In flight: the client's resend doubles as our
                # Phase2a retransmit (no per-slot leader timer).
                value, _, _ = self.active[m.group].proposals[entry[2]]
                self._send_phase2a(m.group, entry[2], value)
            return
        if self.admission is not None and not self.admission.admit():
            from frankenpaxos_tpu_torch.serve.messages import Rejected

            self.send(src, Rejected(
                entries=((cid.client_pseudonym, cid.client_id),),
                retry_after_ms=self.admission.retry_after_ms(),
                reason=self.admission.last_reason))
            return
        self._propose(m.group, m.command, src)

    def _propose(self, group: int, command: Command,
                 client: Optional[Address]) -> None:
        st = self.active[group]
        slot = st.next_slot
        st.next_slot += 1
        value = CommandBatch((command,))
        st.proposals[slot] = (value, client, command.command_id)
        cid = command.command_id
        self._dedup[(group, cid.client_address,
                     cid.client_pseudonym)] = [cid.client_id, None, slot]
        self._send_phase2a(group, slot, value)

    def _send_phase2a(self, group: int, slot: int, value) -> None:
        """Fan a proposal to the row governing ``slot`` -- the HOME
        row in steady state, an older epoch's row for handover-gap
        recovery (slots below the new epoch's start stay under the
        old plane, so their quorum lives in the old home zone)."""
        entry = self.epochs.epoch_of_slot(group, slot)
        st = self.active[group]
        self.broadcast(self.config.row_addresses(entry.home_zone),
                       WPhase2a(group=group, slot=slot,
                                ballot=st.ballot, value=value))

    # --- vote counting (drain-granular) -------------------------------------
    def _handle_phase2b(self, src: Address, m: WPhase2b) -> None:
        self.trackers[m.group].record(m.slot, m.ballot, m.acceptor)
        self._dirty.add(m.group)

    def on_drain(self) -> None:
        commits = 0
        for group in sorted(self._dirty):
            self._dirty.discard(group)
            newly = self.trackers[group].drain()
            if not newly:
                continue
            st = self.active.get(group)
            for slot, ballot in newly:
                if st is None or ballot != st.ballot:
                    continue  # a stale tenure's quorum
                proposal = st.proposals.pop(slot, None)
                if proposal is None:
                    continue
                value, client, cid = proposal
                commits += 1
                self._record_chosen(group, slot, value)
                if client is not None:
                    result = value.commands[0].command \
                        if isinstance(value, CommandBatch) else b""
                    self._reply_outbox.append(
                        (client, WReply(command_id=cid, group=group,
                                        slot=slot, result=result)))
                    key = (group, cid.client_address,
                           cid.client_pseudonym)
                    entry = self._dedup.get(key)
                    if entry is not None and entry[0] == cid.client_id:
                        entry[1] = result
                        entry[2] = slot
            event = self._open_steal_events.get(group)
            if event is not None and "first_commit_s" not in event:
                event["first_commit_s"] = self._clock()
                if "active_s" in event:
                    self._close_steal_event(group)
        self._flush_chosen()
        # Resync the admission in-flight measure where it CHANGES --
        # quorums landing this drain popped proposals (and
        # steals/releases moved whole groups). Admit()'s increments
        # accrue between drains; without this resync the slot budget
        # saturates after inflight_limit admits and the leader
        # rejects forever.
        if self.admission is not None:
            self.admission.set_inflight(
                sum(len(st.proposals)
                    for st in self.active.values()))
        # Per-region serving health: commits this drain and the
        # running rejected/shed delta, labeled with this leader's zone.
        metrics = self.transport.runtime_metrics
        if metrics is not None:
            region = self.config.zones[self.zone]
            if commits:
                metrics.region_goodput(region, commits)
            if self.admission is not None:
                total = sum(self.admission.rejected.values())
                delta = total - self._rejected_exported
                if delta:
                    metrics.region_shed(region, delta)
                    self._rejected_exported = total

    def _record_chosen(self, group: int, slot: int, value) -> None:
        self.chosen[group][slot] = value
        self._chosen_outbox.append(WChosen(group=group, slot=slot,
                                           value=value))
        wm = self.chosen_watermark[group]
        released = []
        while wm in self.chosen[group]:
            released.append(wm)
            wm += 1
        if released:
            self.chosen_watermark[group] = wm
            self.trackers[group].release(released)

    def _flush_chosen(self) -> None:
        if self._chosen_outbox:
            messages, self._chosen_outbox = self._chosen_outbox, []
            for replica in self.config.replica_addresses:
                self.send_batch(replica, messages)
        if self._reply_outbox:
            replies, self._reply_outbox = self._reply_outbox, []
            per_client: dict = {}
            for client, reply in replies:
                per_client.setdefault(client, []).append(reply)
            for client, messages in per_client.items():
                self.send_batch(client, messages)

    # --- stealing -----------------------------------------------------------
    def steal(self, group: int, buffered: Optional[tuple] = None) -> None:
        """Begin (or join) a steal of ``group`` to this zone."""
        if group in self.active:
            if buffered is not None:
                self._admit_and_propose(buffered[0], buffered[1])
            return
        st = self.stealing.get(group)
        if st is not None:
            if buffered is not None:
                st.buffered.append(buffered)
            return
        floor = max(self.epochs.max_ballot(group),
                    self._ballot_floor.get(group, -1))
        ballot = self.config.next_ballot(self.zone, floor)
        st = _Steal(ballot=ballot,
                    epoch=self.epochs.current(group).epoch + 1,
                    started_at=self._clock())
        if buffered is not None:
            st.buffered.append(buffered)
        self.stealing[group] = st
        self._open_steal_events[group] = {
            "group": group,
            "from_zone": self.epochs.current(group).home_zone,
            "to_zone": self.zone,
            "started_s": st.started_at,
        }
        self._broadcast_phase1a(group)
        timer = self._phase1_timers.get(group)
        if timer is None:
            timer = self.timer(
                f"resendPhase1a-{group}",
                self.options.resend_phase1a_period_s,
                lambda g=group: self._resend_phase1a(g))
            self._phase1_timers[group] = timer
        timer.start()

    def _broadcast_phase1a(self, group: int) -> None:
        st = self.stealing[group]
        self.broadcast(self.config.all_acceptors(),
                       WPhase1a(group=group, ballot=st.ballot,
                                epoch=st.epoch))

    def _resend_phase1a(self, group: int) -> None:
        if group in self.stealing:
            self._broadcast_phase1a(group)
            self._phase1_timers[group].start()

    def _handle_phase1b(self, src: Address, m: WPhase1b) -> None:
        st = self.stealing.get(m.group)
        if st is None or m.ballot != st.ballot:
            return
        st.phase1bs[m.acceptor] = m
        for entry in m.epochs:
            if self.epochs.offer(entry) in ("new", "replaced"):
                self.trackers[m.group].note_epochs()
        if self._read_spec.check(st.phase1bs.keys()):
            self._complete_steal(m.group)

    def _complete_steal(self, group: int) -> None:
        st = self.stealing.pop(group)
        timer = self._phase1_timers.get(group)
        if timer is not None:
            timer.stop()
        # Adopt: per slot, the highest-ballot vote; and prove chosen-ness
        # where a row majority voted one (slot, ballot) -- those values
        # are already decided and need no re-proposal.
        adopted: dict[int, tuple] = {}      # slot -> (ballot, value)
        voters: dict[tuple, set] = {}       # (slot, ballot) -> ids
        for acceptor_id, phase1b in st.phase1bs.items():
            for vote in phase1b.votes:
                best = adopted.get(vote.slot)
                if best is None or vote.ballot > best[0]:
                    adopted[vote.slot] = (vote.ballot, vote.value)
                voters.setdefault((vote.slot, vote.ballot),
                                  set()).add(acceptor_id)
        for (slot, ballot), ids in voters.items():
            if slot in self.chosen[group]:
                continue
            plane = self.epochs.epoch_of_slot(group, slot)
            if self.grid.home_write_spec(plane.home_zone).check(ids):
                self._record_chosen(group, slot, adopted[slot][1])
        # The watermark-bounded handover: the new epoch opens at the
        # first slot not known chosen; everything below stays with the
        # old era's history.
        start_slot = max(self.chosen_watermark[group],
                         self.epochs.current(group).start_slot)
        entry = GeoEpoch(group=group, epoch=st.epoch,
                         start_slot=start_slot, home_zone=self.zone,
                         ballot=st.ballot)
        verdict = self.epochs.offer(entry)
        if verdict not in ("new", "replaced"):
            # A higher-ballot steal won while we gathered acks; its
            # WEpochCommit (or our next nack) routes clients there.
            self._open_steal_events.pop(group, None)
            return
        self.trackers[group].note_epochs()
        max_voted = max(adopted, default=start_slot - 1)
        state = _Group(ballot=st.ballot,
                       next_slot=max(start_slot, max_voted + 1))
        self.active[group] = state
        # Recover the unchosen tail: adopted values (or noops for
        # holes) re-proposed under OUR ballot. Slots >= start_slot
        # count under the new home plane; the handover gap below it
        # stays under its old plane (and row) by _send_phase2a.
        for slot in range(min([start_slot] + list(adopted)),
                          state.next_slot):
            if slot in self.chosen[group] \
                    or slot in state.proposals:
                continue
            vote = adopted.get(slot)
            value = vote[1] if vote is not None else NOOP
            state.proposals[slot] = (value, None, None)
            self._send_phase2a(group, slot, value)
        event = self._open_steal_events.get(group)
        if event is not None:
            event["active_s"] = self._clock()
            event["epoch"] = st.epoch
            event["start_slot"] = start_slot
            if not state.proposals and "first_commit_s" not in event:
                # Nothing to recover: the steal is fully live now.
                event["first_commit_s"] = event["active_s"]
            if "first_commit_s" in event:
                self._close_steal_event(group)
        # Commit the epoch entry durably at the acceptors (resent
        # until a read quorum acked -- any future Phase1 then
        # discovers it) and tell the other leaders for routing.
        self._epoch_resends[group] = (
            self._epoch_timer(group), entry, set())
        self._broadcast_epoch_commit(group)
        self._epoch_resends[group][0].start()
        if self._placement is not None:
            # A freshly acquired group starts a clean dwell window
            # with no inherited traffic history.
            self._placement["acquired"][group] = self._clock()
            self._placement["counts"].pop(group, None)
            self._placement["streak"].pop(group, None)
        for src, request in st.buffered:
            self._admit_and_propose(src, request)

    def _close_steal_event(self, group: int) -> None:
        event = self._open_steal_events.pop(group, None)
        if event is not None:
            self.steal_events.append(event)

    def _epoch_timer(self, group: int):
        existing = self._epoch_resends.get(group)
        if existing is not None:
            existing[0].stop()
            return existing[0]
        return self.timer(
            f"resendEpochCommit-{group}",
            self.options.resend_epoch_commit_period_s,
            lambda g=group: self._resend_epoch_commit(g))

    def _broadcast_epoch_commit(self, group: int) -> None:
        _, entry, acked = self._epoch_resends[group]
        message = WEpochCommit(entry=entry)
        self.broadcast(
            [a for a in self.config.all_acceptors()
             if self._acceptor_ids[a] not in acked], message)
        self.broadcast(
            [lead for lead in self.config.leader_addresses
             if lead != self.address], message)

    def _resend_epoch_commit(self, group: int) -> None:
        record = self._epoch_resends.get(group)
        if record is None:
            return
        self._broadcast_epoch_commit(group)
        record[0].start()

    def _handle_epoch_ack(self, src: Address, m: WEpochAck) -> None:
        record = self._epoch_resends.get(m.group)
        if record is None or record[1].epoch != m.epoch:
            return
        timer, entry, acked = record
        acceptor_id = self._acceptor_ids.get(src)
        if acceptor_id is None:
            return
        acked.add(acceptor_id)
        if self._read_spec.check(acked):
            timer.stop()
            del self._epoch_resends[m.group]

    # --- preemption ---------------------------------------------------------
    def _handle_nack(self, src: Address, m: WNack) -> None:
        self._ballot_floor[m.group] = max(
            self._ballot_floor.get(m.group, -1), m.ballot)
        st = self.stealing.get(m.group)
        if st is not None and m.ballot > st.ballot:
            # Escalate ABOVE the refused ballot -- but after a
            # randomized backoff, never immediately: the competing
            # stealer gets a window to finish, breaking the duel.
            self._phase1_timers[m.group].stop()
            timer = self._steal_retry_timers.get(m.group)
            if timer is None:
                timer = self.timer(
                    f"retrySteal-{m.group}",
                    self.options.steal_backoff_s,
                    lambda g=m.group: self._retry_steal(g))
                self._steal_retry_timers[m.group] = timer
            timer.set_delay(self.options.steal_backoff_s
                            * (0.5 + self._rng.random()))
            timer.reset()
            return
        state = self.active.get(m.group)
        if state is not None and m.ballot > state.ballot:
            self._release_ownership(m.group)

    def _retry_steal(self, group: int) -> None:
        st = self.stealing.get(group)
        if st is None:
            return
        floor = max(self.epochs.max_ballot(group),
                    self._ballot_floor.get(group, -1), st.ballot)
        st.ballot = self.config.next_ballot(self.zone, floor)
        st.epoch = self.epochs.current(group).epoch + 1
        st.phase1bs.clear()
        self._broadcast_phase1a(group)
        self._phase1_timers[group].start()

    def _handle_epoch_commit(self, src: Address, m: WEpochCommit) -> None:
        entry = m.entry
        if self.epochs.offer(entry) in ("new", "replaced"):
            self.trackers[entry.group].note_epochs()
            state = self.active.get(entry.group)
            if state is not None and entry.home_zone != self.zone \
                    and entry.ballot > state.ballot:
                self._release_ownership(entry.group)

    def _release_ownership(self, group: int) -> None:
        state = self.active.pop(group, None)
        if state is None:
            return
        if self._placement is not None:
            self._placement["counts"].pop(group, None)
            self._placement["streak"].pop(group, None)
            self._placement["acquired"].pop(group, None)
        entry = self.epochs.current(group)
        for slot, (value, client, cid) in state.proposals.items():
            if client is not None:
                self.send(client, WNotOwner(
                    group=group, command_id=cid,
                    home_zone=entry.home_zone, ballot=entry.ballot))

    # --- adaptive placement (paxchaos) --------------------------------------
    def _placement_check(self) -> None:
        """One placement-policy evaluation: for every owned group,
        decide whether a remote zone's request-origin EWMA dominates
        enough (for long enough) to hand the group off. The hand-off
        is a Steal trigger to the dominant zone's leader -- the normal
        fresh-ballot steal flow moves the group, this leader gets
        preempted and redirects stragglers via the nack-floor hint
        (the anti-boomerang path PR 13 fixed)."""
        opts = self.options
        state = self._placement
        counts_by_group = state["counts"]
        for group in list(self.active):
            counts = counts_by_group.get(group)
            if not counts:
                continue
            total = sum(counts.values())
            zone = max(counts, key=counts.get)
            share = counts[zone] / total
            streak = state["streak"].setdefault(group, [zone, 0])
            if zone != self.zone and total >= opts.placement_min_samples \
                    and share >= opts.placement_dominance:
                if streak[0] == zone:
                    streak[1] += 1
                else:
                    streak[0], streak[1] = zone, 1
            else:
                streak[0], streak[1] = zone, 0
            dwell = self._clock() - state["acquired"].get(group, 0.0)
            if streak[1] >= opts.placement_hysteresis_checks \
                    and dwell >= opts.placement_min_dwell_s:
                self.send(self.config.leader_addresses[zone],
                          Steal(group=group))
                self.placement_handoffs.append({
                    "group": group, "to_zone": zone,
                    "t_s": round(self._clock(), 3),
                    "share": round(share, 3)})
                counts_by_group.pop(group, None)
                state["streak"].pop(group, None)
                continue
            # EWMA decay: old traffic fades at alpha per check, so
            # dominance tracks the CURRENT origin mix.
            alpha = opts.placement_ewma_alpha
            for origin in list(counts):
                counts[origin] *= (1.0 - alpha)
                if counts[origin] < 0.05:
                    del counts[origin]
        self._placement_timer.start()

    # --- replica hole recovery ----------------------------------------------
    def _handle_recover(self, src: Address, m: WRecover) -> None:
        sent = 0
        for slot in sorted(self.chosen[m.group]):
            if slot < m.slot:
                continue
            self.send(src, WChosen(group=m.group, slot=slot,
                                   value=self.chosen[m.group][slot]))
            sent += 1
            if sent >= self.options.recover_reply_limit:
                break
