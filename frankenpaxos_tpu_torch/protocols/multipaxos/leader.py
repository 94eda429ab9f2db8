"""MultiPaxos Leader (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/leader.py``).

Reference behavior: multipaxos/Leader.scala:95-723. A state machine over
{Inactive, Phase1, Phase2}:

  * Phase1 (startPhase1, Leader.scala:409-430): send Phase1a with the
    chosen watermark to f+1 acceptors per group (or a grid read quorum);
    collect Phase1b until per-group quorums (or grid read quorum); adopt
    the highest-vote-round value per slot in [chosen_watermark, max_slot]
    -- `safeValue`, Leader.scala:318-330 -- propose them, jump to Phase2,
    replay pending batches.
  * Phase2 (processClientRequestBatch, Leader.scala:331-408): assign the
    next slot, hand the Phase2a to a proxy leader (round-robin in Hash
    mode, own colocated one otherwise).
  * Nacks bump the round and re-run Phase1 (Leader.scala:669-696);
    Recover triggers a leader change so holes get repaired
    (Leader.scala:698-722); the embedded election participant drives
    Inactive <-> active transitions (Leader.scala:192-203).

Phase-1 recovery runs on the host (``phase1_backend="host"``, the
reference's per-slot scan) or as one K8 reduction on the GPU
(``"cuda"``, ``ops/value.py``); the reference's ``"tpu"`` is refused.
A recovery across several epochs takes the host scan on either backend,
as the reference's does.

Live reconfiguration (reconfig/): ``Reconfigure`` defines epoch e+1 at
``next_slot``; the leader broadcasts the round-tagged EpochCommit
(resent by the ``resendEpochCommit`` timer) and buffers proposals until
f+1 acceptors of the old epoch have durably acked it; then proposals go
out as epoch-tagged runs (EpochPhase2aRun), split at epoch boundaries.
A new leader discovers epochs from the Phase1bs, runs Phase 1 with a
read quorum in every epoch still covering undecided slots, and re-sends
the epoch map to the proxy leaders.

Admission control (the ``admission_*`` options, ``serve/admission.py``):
an in-flight budget fed from ``next_slot - chosen_watermark`` plus the
Phase-1 backlog, partial admission of a coalesced array or run, and
explicit ``Rejected`` replies for the refused suffix. The ingest fabric
(``ingest/``): client batch frames and un-batched arrays reach the
leader's wire sinks as columns and are proposed as ONE ``Phase2aRun``
whose value bytes are the clients' own; an ``IngestRun`` from a batcher
is proposed the same way, and each batcher gets one ``IngestCredit`` a
drain.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional

from frankenpaxos_tpu_torch.election.basic import (
    ElectionOptions,
    ElectionParticipant,
)
from frankenpaxos_tpu_torch.ingest.columns import (
    CLIENT_ARRAY_TAG,
    parse_client_array,
    parse_client_batch,
    reject_value_suffix,
    value_view,
)
from frankenpaxos_tpu_torch.ingest.messages import (
    IngestCredit,
    IngestRun,
    NotLeaderIngest,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.config import (
    DistributionScheme,
    MultiPaxosConfig,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    ChosenWatermark,
    ClientRequest,
    ClientRequestArray,
    ClientRequestBatch,
    CommandBatch,
    LeaderInfoReplyBatcher,
    LeaderInfoReplyClient,
    LeaderInfoRequestBatcher,
    LeaderInfoRequestClient,
    Nack,
    NOOP,
    NotLeaderBatcher,
    NotLeaderClient,
    Phase1a,
    Phase1b,
    Phase2a,
    Phase2aRun,
    Recover,
)
from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops import value as value_ops
from frankenpaxos_tpu_torch.reconfig import (
    EpochAck,
    EpochCommit,
    EpochConfig,
    EpochPhase2aRun,
    EpochStore,
    Reconfigure,
)
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.paxwire import CLIENT_BATCH_TAG
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class LeaderOptions:
    resend_phase1as_period_s: float = 5.0
    flush_phase2as_every_n: int = 1
    # Assign this many CONSECUTIVE slots to one proxy leader before
    # rotating to the next (Hash scheme only). The reference rotates
    # per slot (Leader.scala:331-408); chunked rotation is the
    # TPU-first layout: each proxy leader's slot space stays
    # contiguous, so acceptors' ranged acks stay whole ranges and the
    # device tracker's drain blocks stay dense instead of shredding
    # into stride-N singles. Pure load balancing -- any proxy leader
    # can handle any slot -- so protocol semantics are unchanged.
    proxy_leader_chunk: int = 256
    noop_flush_period_s: float = 0.0  # 0 disables
    election_options: ElectionOptions = ElectionOptions()
    measure_latencies: bool = True
    # "host": the reference's per-slot safeValue scan. "cuda": one
    # batched K8 (ops/value.safe_values_staged) over the whole recovery
    # window.
    phase1_backend: str = "host"
    # Tag every run proposal with its epoch (EpochPhase2aRun) even while
    # the store holds a single epoch. Off by default -- the single-epoch
    # steady state pays no reconfiguration overhead. Once a real
    # reconfiguration commits, tagging engages regardless.
    epoch_tag_runs: bool = False
    resend_epoch_commit_period_s: float = 1.0
    # Admission control: not ported yet; anything but the all-zero
    # default is refused.
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


class _Inactive:
    pass


@dataclasses.dataclass
class _Phase1:
    # group index -> acceptor index -> Phase1b
    phase1bs: list[dict[int, Phase1b]]
    phase1b_acceptors: set[tuple[int, int]]
    pending_batches: list[ClientRequestBatch]
    resend_phase1as: object  # Timer
    # Every Phase1b by sender address (the recovery window's max slot
    # is taken over all of them). Across epochs, (group, index)
    # coordinates can collide -- a replacement reuses a dead member's
    # config slot -- but addresses cannot.
    by_addr: dict = dataclasses.field(default_factory=dict)
    # The Phase1a in flight, for epoch-discovery extension sends.
    phase1a: Optional[Phase1a] = None


@dataclasses.dataclass
class _Phase2:
    noop_flush: Optional[object] = None  # Timer


@dataclasses.dataclass
class _EpochChange:
    """An epoch change in flight (the reconfiguration state machine):
    PENDING until a write quorum of OLD-epoch acceptors durably acked
    the EpochCommit (proposals buffer -- the handover window), then
    ACTIVE (buffered proposals open the new epoch's slots) while
    resends keep chasing the stragglers' acks."""

    config: EpochConfig
    commit: EpochCommit
    targets: set
    acks: set
    resend: object  # Timer
    pending: list   # buffered CommandBatchOrNoop values
    activated: bool = False
    # True when RE-driving an adopted epoch (post-failover, or a
    # Phase2 leader learning one from a peer broadcast): same gate --
    # an epoch may be proposed into only once f+1 of its PREDECESSOR's
    # acceptors durably hold its commit, because that is what makes
    # every future leader's Phase1 discover it (chaos-found: an
    # adopted-but-undurable epoch let a later leader re-propose its
    # slots under the old quorums -- a second chosen value).
    recommit: bool = False


class Leader(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MultiPaxosConfig,
                 options: LeaderOptions = LeaderOptions(),
                 collectors: Collectors | None = None, seed: int = 0,
                 device=None):
        if options.phase1_backend not in ("host", "cuda"):
            raise ValueError(
                f"phase1_backend must be 'host' or 'cuda', got "
                f"{options.phase1_backend!r}")
        # K8's device: resolved now, so that "cuda" without a GPU (and
        # no device named) fails at construction, not at a failover.
        self.device = (resolve_device(device)
                       if options.phase1_backend == "cuda" else None)
        if self.device is not None:
            # K8's staging (its stream) and C entry made now, not at
            # the first failover.
            value_ops.recovery_staging(self.device)
        super().__init__(address, transport, logger)
        config.check_valid()
        logger.check(address in config.leader_addresses)
        self.config = config
        self.options = options
        self.rng = random.Random(seed)
        collectors = collectors or FakeCollectors()
        self.metrics_latency = collectors.summary(
            "multipaxos_leader_requests_latency_seconds", labels=("type",))
        self.metrics_requests = collectors.counter(
            "multipaxos_leader_requests_total", labels=("type",))
        self.index = list(config.leader_addresses).index(address)
        self.grid = config.quorum_grid() if config.flexible else None
        self._row_size = len(config.acceptor_addresses[0])
        self.round_system = ClassicRoundRobin(config.num_leaders)
        # Live reconfiguration (reconfig/): the epoch store is THE
        # authority for acceptor-set reads on this role. Supported for
        # the workhorse shape -- one non-flexible 2f+1 group; grids and
        # slot-striped multi-group configs stay epoch-frozen.
        self.epochs: Optional[EpochStore] = None
        if not config.flexible and config.num_acceptor_groups == 1:
            self.epochs = EpochStore.from_members(
                tuple(config.acceptor_addresses[0]), config.f)
        self._epoch_change: Optional[_EpochChange] = None
        # Post-failover epoch re-broadcast state: {"epoch", "commits",
        # "pending" (proxies yet to ack), "timer"} or None.
        self._epoch_sync: Optional[dict] = None
        # Active leader's round, or the largest known active round.
        self.round = self.round_system.next_classic_round(0, -1)
        self.next_slot = 0
        self.chosen_watermark = 0
        self._current_proxy_leader = 0
        self._unflushed_phase2as = 0
        self._chunk_sent = 0
        # Commands admitted while in _Phase1 (sitting in
        # pending_batches with no slot yet): the in-flight resyncs
        # must count them, or a long Phase1 admits without bound.
        self._admitted_backlog = 0
        # paxload admission (serve/): built only when an option arms
        # it, so admission-off deployments keep the exact pre-paxload
        # hot path (Actor.admission stays None for the transports too).
        admission_options = options.admission_options()
        if admission_options is not None:
            from frankenpaxos_tpu_torch.serve.admission import (
                AdmissionController,
            )

            self.admission = AdmissionController(
                admission_options, role=f"leader_{self.index}",
                metrics=transport.runtime_metrics)
            transport.note_admission(address, self)
        # paxingest (ingest/): client batch frames and un-batched
        # coalesced arrays land as SoA columns and propose as ONE run --
        # the wire-to-device fast path for direct client->leader
        # deployments (batcher'd deployments arrive as IngestRun).
        self.wire_sinks = {
            CLIENT_BATCH_TAG: (parse_client_batch,
                               self._handle_client_columns),
            CLIENT_ARRAY_TAG: (parse_client_array,
                               self._handle_client_columns),
        }
        # paxfan descriptor pipelining: per-batcher drained-seq
        # high-water accumulated across one event-loop pass (the leader
        # drains SEVERAL pipelined runs per pass) and flushed as ONE
        # IngestCredit per batcher in on_drain.
        self._ingest_credit_hw: dict = {}
        #: Ingest deliveries by kind: IngestRuns from batchers and
        #: client frames taken as columns by the wire sinks.
        self.ingest_counts = {"IngestRun": 0, "client_columns": 0}
        #: The last K8 recovery: its shape and host seconds spent
        #: building the matrices, in the call (transfers included) and
        #: mapping ids back to values.
        self.last_recovery: Optional[dict] = None

        # Embedded election participant (Leader.scala:192-203).
        self.election = ElectionParticipant(
            config.leader_election_addresses[self.index], transport, logger,
            config.leader_election_addresses, initial_leader_index=0,
            options=options.election_options, seed=seed)
        self.election.register(
            lambda leader_index: self.leader_change(leader_index == self.index))

        self.state: object = (self._start_phase1(self.round,
                                                 self.chosen_watermark)
                              if self.index == 0 else _Inactive())

    # --- helpers ----------------------------------------------------------
    def _acceptor_address(self, flat: int) -> Address:
        return self.config.acceptor_addresses[flat // self._row_size][
            flat % self._row_size]

    def _proxy_leader_address(self) -> Address:
        if self.config.distribution_scheme == DistributionScheme.HASH:
            return self.config.proxy_leader_addresses[
                self._current_proxy_leader]
        return self.config.proxy_leader_addresses[self.index]

    def _advance_proxy_leader(self) -> None:
        self._current_proxy_leader = (
            (self._current_proxy_leader + 1) % self.config.num_proxy_leaders)

    def _recover_values(self, phase1: "_Phase1", max_slot: int) -> list:
        """Safe values for ``[chosen_watermark, max_slot]``, one per slot.

        The host path replays the reference's per-slot scan; the cuda path
        lifts the whole recovery window into one ``[S, N]`` reduction
        (K8, ops/value.safe_values_staged) -- votes are written straight
        into the (round, value-id) matrices of K8's pinned block, ONE
        staged call returns each slot's highest-round value id, and the
        host maps ids back to values (Leader.scala:504-576's scan as a
        single reduction); on ``device="cpu"`` the plain version.
        """
        # Non-flexible mode partitions slots over acceptor groups
        # (slot % G owns the slot); in FLEXIBLE mode the "groups" are
        # grid ROWS -- every acceptor votes on every slot, so recovery
        # must scan ALL Phase1bs for every slot. Applying the
        # partitioning rule to a grid dropped reported votes whose
        # acceptor sat in the "wrong" row and recovered Noop over a
        # chosen value (found by the reference's 500x250 soak,
        # multipaxos/f1-grid seed 493: replica logs diverged).
        # Multi-epoch recovery: every answering acceptor's votes are
        # scanned for every slot. Non-members of a slot's epoch can
        # hold no votes for it (proposals only ever fan to the epoch's
        # members), so the scan is a superset of the epoch's read
        # quorum -- the safe-value rule over exactly the right config.
        # K8's matrices index votes by (group, index) coordinates,
        # which collide across epochs, so the host scan is the
        # multi-epoch path on both backends, as in the reference.
        if self.epochs is not None and self.epochs.multi_epoch:
            return self._safe_values(
                (info for phase1b in phase1.by_addr.values()
                 for info in phase1b.info), max_slot)
        if self.options.phase1_backend != "cuda":
            return self._recover_values_host(phase1, max_slot)
        t0 = time.perf_counter()
        num_slots = max_slot + 1 - self.chosen_watermark
        if num_slots <= 0:
            return []
        num_groups = self.config.num_acceptor_groups
        n_cols = num_groups * self._row_size
        padded = 1
        while padded < num_slots:
            padded *= 2
        # NO_VOTE / 0 prefilled; on a card, views of K8's pinned block.
        vote_rounds, value_ids = value_ops.recovery_matrices(
            padded, n_cols, self.device)
        values_by_id: list = []
        id_by_value: dict = {}
        for group_index, group in enumerate(phase1.phase1bs):
            for acceptor_index, phase1b in group.items():
                col = group_index * self._row_size + acceptor_index
                for info in phase1b.info:
                    if not (self.chosen_watermark <= info.slot <= max_slot):
                        continue
                    # Slot-partitioning filter only in non-flexible
                    # mode (see the host path above).
                    if (not self.config.flexible
                            and info.slot % num_groups != group_index):
                        continue
                    vid = id_by_value.get(info.vote_value)
                    if vid is None:
                        vid = len(values_by_id)
                        id_by_value[info.vote_value] = vid
                        values_by_id.append(info.vote_value)
                    row = info.slot - self.chosen_watermark
                    vote_rounds[row, col] = info.vote_round
                    value_ids[row, col] = vid
        t1 = time.perf_counter()
        has_vote, chosen = value_ops.safe_values_staged(
            vote_rounds, value_ids, self.device)
        has_vote = has_vote[:num_slots]
        chosen = chosen[:num_slots]
        t2 = time.perf_counter()
        values = [values_by_id[vid] if hit else NOOP
                  for hit, vid in zip(has_vote.tolist(), chosen.tolist())]
        self.last_recovery = {
            "shape": list(vote_rounds.shape),
            "build_s": t1 - t0, "call_s": t2 - t1,
            "map_s": time.perf_counter() - t2}
        return values

    def _recover_values_host(self, phase1: "_Phase1", max_slot: int
                             ) -> list:
        """The reference's per-slot ``safeValue`` scan
        (Leader.scala:318-330) over each slot's own group's Phase1bs."""
        num_groups = self.config.num_acceptor_groups
        flexible = self.config.flexible
        return self._safe_values(
            (info for group_index, group in enumerate(phase1.phase1bs)
             for phase1b in group.values() for info in phase1b.info
             if flexible or info.slot % num_groups == group_index),
            max_slot)

    def _safe_values(self, infos, max_slot: int) -> list:
        """``safeValue`` for every slot of ``[chosen_watermark,
        max_slot]`` over the votes ``infos`` in their order: the first
        vote with the strictly highest round, else Noop. One pass over
        the votes instead of one pass per slot; the choices are the
        reference's."""
        lo = self.chosen_watermark
        best: dict = {}  # slot -> (vote_round, vote_value)
        for info in infos:
            slot = info.slot
            if not lo <= slot <= max_slot:
                continue
            cur = best.get(slot)
            if info.vote_round > (-1 if cur is None else cur[0]):
                best[slot] = (info.vote_round, info.vote_value)
        return [best[s][1] if s in best else NOOP
                for s in range(lo, max_slot + 1)]

    @property
    def _epoch_tagging(self) -> bool:
        """Whether proposals carry epoch tags: always once a real
        reconfiguration committed (the proxy must never mis-route a
        run across the handover), or forced by ``epoch_tag_runs`` for
        the steady-state overhead A/B."""
        return self.epochs is not None and (
            self.epochs.multi_epoch or self.options.epoch_tag_runs)

    def _epoch_buffering(self) -> "Optional[list]":
        """The pending-change buffer while an epoch change awaits its
        activation quorum (the handover window), else None."""
        change = self._epoch_change
        if change is not None and not change.activated:
            return change.pending
        return None

    def _send_epoch_runs(self, values: tuple) -> None:
        """Propose ``values`` at contiguous slots from ``next_slot`` as
        epoch-tagged runs, SPLIT at epoch activation boundaries -- a
        proposal run never spans two acceptor sets (each segment's
        quorum is one epoch's)."""
        k = len(values)
        at = 0
        while at < k:
            slot = self.next_slot + at
            config = self.epochs.epoch_of_slot(slot)
            end = k
            nxt = self.epochs.config(config.epoch + 1)
            if nxt is not None:
                end = min(k, nxt.start_slot - self.next_slot)
            dst = self._proxy_leader_address()
            self.send(dst, EpochPhase2aRun(
                epoch=config.epoch, start_slot=slot, round=self.round,
                values=tuple(values[at:end])))
            self._account_sent_slots(dst, end - at)
            at = end
        self.next_slot += k

    def _account_sent_slots(self, dst: Address, k: int) -> None:
        """Rotate proxy leaders every `chunk` slots (>= the flush batch,
        so a no-flush run never strands bytes on a just-left dst). The
        ONE place the rotation schedule lives -- shared by the per-slot
        and run proposal paths."""
        self._chunk_sent += k
        chunk = max(self.options.proxy_leader_chunk,
                    self.options.flush_phase2as_every_n)
        if self._chunk_sent >= chunk:
            if self._unflushed_phase2as:
                self.flush(dst)
                self._unflushed_phase2as = 0
            self._advance_proxy_leader()
            self._chunk_sent = 0
        elif (self._unflushed_phase2as
              >= self.options.flush_phase2as_every_n):
            self.flush(dst)
            self._unflushed_phase2as = 0

    def _send_phase2a(self, phase2a: Phase2a,
                      force_flush: bool = False) -> None:
        dst = self._proxy_leader_address()
        if self.options.flush_phase2as_every_n <= 1:
            self.send(dst, phase2a)
        else:
            self.send_no_flush(dst, phase2a)
            self._unflushed_phase2as += 1
        self._account_sent_slots(dst, 1)
        if force_flush and self._unflushed_phase2as:
            self.flush(dst)
            self._unflushed_phase2as = 0

    def _process_client_request_batch(self, batch: ClientRequestBatch) -> None:
        if not isinstance(self.state, _Phase2):
            self.logger.fatal(
                f"leader processing a batch outside Phase2: {self.state}")
        pending = self._epoch_buffering()
        if pending is not None:
            pending.append(batch.batch)
            return
        if self._epoch_tagging:
            self._send_epoch_runs((batch.batch,))
            return
        self._send_phase2a(Phase2a(slot=self.next_slot, round=self.round,
                                   value=batch.batch))
        self.next_slot += 1

    # --- phase 1 ----------------------------------------------------------
    def _phase1_epochs(self) -> list:
        """The epochs a Phase1 recovering ``[chosen_watermark, inf)``
        must hold a read quorum in -- Phase1-with-both-configs across a
        handover (the Flexible-Paxos intersection condition)."""
        return self.epochs.epochs_covering(self.chosen_watermark)

    def _start_phase1(self, round: int, chosen_watermark: int) -> _Phase1:
        phase1a = Phase1a(round=round, chosen_watermark=chosen_watermark)
        if self.epochs is not None:
            # Thrifty f+1 sample per covered epoch (a majority is both
            # the read and write quorum); resend widens to every member.
            # dict.fromkeys, not a set: iteration must stay
            # deterministic (sim replay, golden traces) under string
            # hash randomization.
            targets: dict = {}
            for config in self._phase1_epochs():
                targets.update(dict.fromkeys(self.rng.sample(
                    list(config.members), config.quorum_size)))
            for acceptor in targets:
                self.send(acceptor, phase1a)
        elif not self.config.flexible:
            # self.epochs is None on this path: multi-group striping
            # is epoch-frozen. A thrifty f+1 sample per group (a
            # majority is both the read and the write quorum).
            for group in self.config.acceptor_addresses:
                for acceptor in self.rng.sample(list(group),
                                                self.config.f + 1):
                    self.send(acceptor, phase1a)
        else:
            for flat in self.grid.random_read_quorum(self.rng):
                self.send(self._acceptor_address(flat), phase1a)

        def resend():
            if self.epochs is not None:
                targets: dict = {}
                for config in self._phase1_epochs():
                    targets.update(dict.fromkeys(config.members))
                for acceptor in targets:
                    self.send(acceptor, phase1a)
            else:
                for group in self.config.acceptor_addresses:
                    for acceptor in group:
                        self.send(acceptor, phase1a)
            timer.start()

        timer = self.timer("resendPhase1as",
                           self.options.resend_phase1as_period_s, resend)
        timer.start()
        # Fresh Phase1 = fresh (empty) pending backlog.
        self._admitted_backlog = 0
        return _Phase1(
            phase1bs=[{} for _ in range(self.config.num_acceptor_groups)],
            phase1b_acceptors=set(),
            pending_batches=[],
            resend_phase1as=timer,
            phase1a=phase1a)

    def _make_noop_flush_timer(self) -> Optional[object]:
        """In non-flexible mode with multiple groups, periodically propose
        noops so no acceptor group starves (Leader.scala:240-280)."""
        if self.config.flexible or self.options.noop_flush_period_s <= 0:
            return None

        def flush_noop():
            if not isinstance(self.state, _Phase2):
                self.logger.fatal("noop flush outside Phase2")
            # force_flush: an anti-starvation noop must reach its
            # acceptor group NOW, not sit in a no-flush buffer; and
            # rotation is _send_phase2a's job (an extra advance here
            # would split the proxy-leader chunk and strand buffered
            # Phase2as on the just-left dst).
            self._send_phase2a(Phase2a(slot=self.next_slot, round=self.round,
                                       value=NOOP), force_flush=True)
            self.next_slot += 1
            timer.start()

        timer = self.timer("noopFlush", self.options.noop_flush_period_s,
                           flush_noop)
        timer.start()
        return timer

    def _stop_state_timers(self) -> None:
        if isinstance(self.state, _Phase1):
            self.state.resend_phase1as.stop()
        elif isinstance(self.state, _Phase2) and self.state.noop_flush:
            self.state.noop_flush.stop()

    def _abort_epoch_change(self) -> None:
        """Round churn aborts an in-flight change: the commit was
        round-tagged, so its acks are dead; a successor leader adopting
        the (possibly partially acked) entry from Phase1bs supersedes
        or re-drives it. Buffered proposals are dropped -- clients
        resend, and the replica client table keeps that exactly-once."""
        change = self._epoch_change
        if change is None:
            return
        change.resend.stop()
        if change.pending:
            self.logger.debug(
                f"epoch change aborted with {len(change.pending)} "
                f"buffered proposals (clients will resend)")
        self._epoch_change = None

    def leader_change(self, is_new_leader: bool) -> None:
        """Election callback (Leader.scala:432-459)."""
        self._stop_state_timers()
        self._abort_epoch_change()
        self._stop_epoch_sync()
        if not is_new_leader:
            self.state = _Inactive()
            return
        self.round = self.round_system.next_classic_round(self.index,
                                                          self.round)
        self.state = self._start_phase1(self.round, self.chosen_watermark)

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        # timed(label) handler latency summaries (Leader.scala:281-293).
        if self.options.measure_latencies:
            with self.metrics_latency.labels(
                    type(message).__name__).time():
                self._receive_impl(src, message)
        else:
            self._receive_impl(src, message)

    def _receive_impl(self, src: Address, message) -> None:
        handlers = [
            (Phase1b, "Phase1b", self._handle_phase1b),
            (ClientRequest, "ClientRequest", self._handle_client_request),
            (ClientRequestArray, "ClientRequestArray",
             self._handle_client_request_array),
            (ClientRequestBatch, "ClientRequestBatch",
             self._handle_client_request_batch),
            (IngestRun, "IngestRun", self._handle_ingest_run),
            (LeaderInfoRequestClient, "LeaderInfoRequestClient",
             self._handle_leader_info_request_client),
            (LeaderInfoRequestBatcher, "LeaderInfoRequestBatcher",
             self._handle_leader_info_request_batcher),
            (Nack, "Nack", self._handle_nack),
            (ChosenWatermark, "ChosenWatermark",
             self._handle_chosen_watermark),
            (Recover, "Recover", self._handle_recover),
            (Reconfigure, "Reconfigure", self._handle_reconfigure),
            (EpochAck, "EpochAck", self._handle_epoch_ack),
            (EpochCommit, "EpochCommit", self._handle_epoch_commit),
        ]
        for klass, label, handler in handlers:
            if isinstance(message, klass):
                self.metrics_requests.labels(label).inc()
                handler(src, message)
                return
        self.logger.fatal(f"unexpected leader message {message!r}")

    def _adopt_epochs(self, commits) -> bool:
        """Merge epoch entries discovered in a Phase1b into the store
        (highest round per epoch id wins); returns True when coverage
        changed (the caller extends Phase1a to the new members)."""
        changed = False
        for commit in sorted(commits, key=lambda c: (c.epoch, c.round)):
            try:
                outcome = self.epochs.offer(
                    EpochConfig(epoch=commit.epoch,
                                start_slot=commit.start_slot,
                                f=commit.f, members=commit.members),
                    commit.round)
            except ValueError as e:
                self.logger.warn(f"discovered epoch rejected: {e}")
                continue
            changed = changed or outcome in ("new", "replaced")
        return changed

    def _handle_phase1b(self, src: Address, phase1b: Phase1b) -> None:
        if not isinstance(self.state, _Phase1):
            self.logger.debug("Phase1b outside Phase1; ignoring")
            return
        phase1 = self.state
        if phase1b.round != self.round:
            self.logger.debug(
                f"Phase1b in round {phase1b.round} != {self.round}; ignoring")
            self.logger.check_lt(phase1b.round, self.round)
            return

        phase1.by_addr[src] = phase1b
        if self.epochs is not None and phase1b.epochs \
                and self._adopt_epochs(phase1b.epochs):
            # Coverage grew mid-Phase1: the newly discovered epochs'
            # members must answer too before recovery may finish.
            members: dict = {}
            for config in self._phase1_epochs():
                members.update(dict.fromkeys(config.members))
            for acceptor in members:
                if acceptor not in phase1.by_addr:
                    self.send(acceptor, phase1.phase1a)
        if self.epochs is not None and self.epochs.multi_epoch:
            # Phase1-with-both-configs: a read quorum in EVERY epoch
            # still covering undecided slots (quorum intersection per
            # epoch is what makes crossing the handover safe).
            answered = set(phase1.by_addr)
            for config in self._phase1_epochs():
                if not config.has_read_quorum(answered):
                    return
        else:
            phase1.phase1bs[phase1b.group_index][phase1b.acceptor_index] \
                = phase1b
            if not self.config.flexible:
                if any(len(group) < self.config.f + 1
                       for group in phase1.phase1bs):
                    return
            else:
                phase1.phase1b_acceptors.add(
                    (phase1b.group_index, phase1b.acceptor_index))
                flat = {g * self._row_size + i
                        for g, i in phase1.phase1b_acceptors}
                if not self.grid.is_superset_of_read_quorum(flat):
                    return

        max_slot = max(
            (info.slot
             for p1b in phase1.by_addr.values()
             for info in p1b.info),
            default=-1)
        values = self._recover_values(phase1, max_slot)
        for slot, value in zip(range(self.chosen_watermark, max_slot + 1),
                               values):
            if self._epoch_tagging:
                # Route recovery proposals by their slot's epoch so the
                # proxy fans each to the right acceptor set.
                config = self.epochs.epoch_of_slot(slot)
                dst = self._proxy_leader_address()
                self.send(dst, EpochPhase2aRun(
                    epoch=config.epoch, start_slot=slot,
                    round=self.round, values=(value,)))
                self._account_sent_slots(dst, 1)
            else:
                self._send_phase2a(Phase2a(slot=slot, round=self.round,
                                           value=value))
        # next_slot must clear the chosen watermark, not just the voted
        # max: Phase1bs report nothing below the watermark (every slot
        # there is already chosen), so with no votes ABOVE it,
        # ``max_slot + 1`` alone would re-propose fresh commands into
        # already-chosen slots -- choosing a second value for a slot
        # (a partition + leader-churn schedule of the reference's chaos
        # soak found this). Any CHOSEN slot >= the watermark is covered by
        # quorum intersection: some Phase1b carries its vote, so
        # max_slot clears it.
        self.next_slot = max(max_slot + 1, self.chosen_watermark)

        phase1.resend_phase1as.stop()
        self.state = _Phase2(self._make_noop_flush_timer())
        if self.epochs is not None and self.epochs.multi_epoch:
            newest_epoch = self.epochs.current().epoch
            reporters = {
                addr for addr, p1b in phase1.by_addr.items()
                if any(c.epoch == newest_epoch for c in p1b.epochs)}
            self._ensure_epoch_durability(reporters)
        for batch in phase1.pending_batches:
            self._process_client_request_batch(batch)
        # The backlog just moved into the span (next_slot advanced per
        # batch); resync so it isn't double-counted.
        self._admitted_backlog = 0
        if self.admission is not None:
            self._sync_inflight()

    def _sync_inflight(self) -> None:
        """Resync the controller to the LIVE in-flight measure:
        proposed-minus-chosen span (the run pipeline's own count of
        outstanding work) plus the Phase1 backlog of admitted-but-
        unslotted commands. Called only where the measure actually
        changes (watermark advances, Phase1 exit) -- between resyncs
        ``admit()``'s own increments accumulate, so the budget binds
        even while next_slot is frozen in Phase1."""
        self.admission.set_inflight(
            self.next_slot - self.chosen_watermark
            + self._admitted_backlog)

    def _admit(self, message, n: int) -> bool:
        """paxload admission for ``n`` client commands (serve/): on
        refusal, answer with explicit Rejected wire replies so clients
        back off instead of re-sending into the congestion.
        Control-plane messages never pass through here -- only the
        three client-request shapes do."""
        admission = self.admission
        if admission is None:
            return True
        if admission.admit(n):
            return True
        from frankenpaxos_tpu_torch.serve.admission import reject_replies_for

        for client, reply in reject_replies_for(
                message, admission.retry_after_ms(),
                admission.last_reason):
            self.send(client, reply)
        return False

    def _admit_prefix(self, commands: tuple) -> tuple:
        """Partial admission for a coalesced array: serve the prefix
        the budget allows, explicitly reject the suffix (one Rejected
        -- all commands in an array come from ONE client)."""
        admission = self.admission
        if admission is None:
            return commands
        k = admission.admit_up_to(len(commands))
        if k < len(commands):
            from frankenpaxos_tpu_torch.serve.admission import (
                reject_replies_for,
            )

            for address, reply in reject_replies_for(
                    ClientRequestArray(commands=commands[k:]),
                    retry_after_ms=admission.retry_after_ms(),
                    reason=admission.last_reason):
                self.send(address, reply)
        return commands[:k]

    def _handle_client_request(self, src: Address,
                               request: ClientRequest) -> None:
        if isinstance(self.state, _Inactive):
            self.send(src, NotLeaderClient())
        elif not self._admit(request, 1):
            pass
        elif isinstance(self.state, _Phase1):
            self._admitted_backlog += 1
            self.state.pending_batches.append(
                ClientRequestBatch(CommandBatch((request.command,))))
        else:
            self._process_client_request_batch(
                ClientRequestBatch(CommandBatch((request.command,))))

    def _handle_client_request_array(self, src: Address,
                                     array: ClientRequestArray) -> None:
        """A drain's worth of independent requests: assign each its own
        slot from a CONTIGUOUS block and propose the whole block as one
        Phase2aRun (the per-drain shape of Leader.scala:331-408's
        per-slot processClientRequestBatch)."""
        if not array.commands:
            return
        if isinstance(self.state, _Inactive):
            self.send(src, NotLeaderClient())
            return
        commands = self._admit_prefix(array.commands)
        if not commands:
            return
        if len(commands) < len(array.commands):
            array = ClientRequestArray(commands=commands)
        if isinstance(self.state, _Phase1):
            self._admitted_backlog += len(array.commands)
            for command in array.commands:
                self.state.pending_batches.append(
                    ClientRequestBatch(CommandBatch((command,))))
            return
        self._propose_value_run(
            tuple(CommandBatch((c,)) for c in array.commands))

    def _propose_value_run(self, values) -> None:
        """Post-admission Phase2 proposal of one-value-per-slot
        ``values`` -- a tuple, or a LazyValueArray whose raw segment is
        forwarded without a parse (the ingest fast path). The shared
        tail of the array / wire-column / IngestRun paths."""
        if self.config.num_acceptor_groups > 1 and not self.config.flexible:
            # Slots stripe over acceptor groups (slot % G) in this mode,
            # so a contiguous run has no single acceptor audience; fall
            # back to per-slot proposals (iterating decodes a lazy
            # array -- this config is off the zero-object path).
            for value in values:
                self._send_phase2a(Phase2a(slot=self.next_slot,
                                           round=self.round,
                                           value=value))
                self.next_slot += 1
            return
        pending = self._epoch_buffering()
        if pending is not None:
            # Handover window: the epoch change has not reached its
            # activation quorum yet, and these commands' slots belong
            # to the NEW epoch -- hold them so in-flight runs drain in
            # the old epoch while the commit settles.
            pending.extend(values)
            return
        if self._epoch_tagging:
            self._send_epoch_runs(tuple(values))
            return
        run = Phase2aRun(
            start_slot=self.next_slot, round=self.round, values=values)
        k = len(values)
        self.next_slot += k
        dst = self._proxy_leader_address()
        self.send(dst, run)
        # A run counts as k slots toward the proxy-leader chunk
        # rotation (runs never use the no-flush buffer).
        self._account_sent_slots(dst, k)

    # --- paxingest (ingest/) ----------------------------------------------
    def _note_ingest(self, cmds: int, nbytes: int) -> None:
        metrics = self.transport.runtime_metrics
        if metrics is not None:
            metrics.ingest_batch(cmds, nbytes)

    def on_drain(self) -> None:
        """Flush accumulated pipelining credits: ONE watermark-granular
        IngestCredit per batcher per drain, regardless of how many runs
        this pass consumed. Control-lane (serve/lanes.py), so shedding
        never wedges the batchers' windows."""
        if self._ingest_credit_hw:
            credits, self._ingest_credit_hw = self._ingest_credit_hw, {}
            for src, hw in credits.items():
                self.send(src, IngestCredit(group_index=0,
                                            watermark_seq=hw))

    def _handle_client_columns(self, src: Address, colrun) -> None:
        """Wire-sink handler: a whole ClientFrameBatch as SoA columns.
        The hot branch proposes the frame as ONE Phase2aRun whose value
        bytes are the clients' own wire bytes (LazyValueArray over the
        scanned segment -- re-encoding is a raw copy); inactive /
        Phase1 / refused-suffix conditions keep per-message
        semantics on the cold path."""
        n = len(colrun)
        if n == 0:
            return
        self.ingest_counts["client_columns"] += 1
        if isinstance(self.state, _Inactive):
            # One bounce per frame: every segment shares the sending
            # connection, and redirect discovery is per-client anyway.
            self.send(src, NotLeaderClient())
            return
        k = n
        admission = self.admission
        if admission is not None:
            k = admission.admit_up_to(n)
            if k < n:
                for address, reply in colrun.reject_entries(
                        k, admission.retry_after_ms(),
                        admission.last_reason):
                    self.send(address, reply)
            if k == 0:
                return
        if isinstance(self.state, _Phase1):
            self._admitted_backlog += k
            for command in colrun.commands(k):  # cold: Phase1 only
                self.state.pending_batches.append(
                    ClientRequestBatch(CommandBatch((command,))))
            return
        values = colrun.lazy_values(k)
        self._note_ingest(k, len(values.raw))
        self._propose_value_run(values)

    def _handle_ingest_run(self, src: Address, run: IngestRun) -> None:
        """A disseminator's pre-batched run descriptor: assign a
        contiguous slot block and forward the pre-encoded values as one
        Phase2aRun -- the leader touches only run metadata (count, raw
        bytes). ``src`` is the batcher, so the inactive bounce returns
        the RUN for re-routing after leader discovery."""
        values = run.values
        n = len(values)
        if n == 0:
            return
        self.ingest_counts["IngestRun"] += 1
        if isinstance(self.state, _Inactive):
            self.send(src, NotLeaderIngest(group_index=0, run=run))
            return
        # Credit the batcher's pipelining window: this run is consumed
        # on every non-bounce path below (proposed, Phase1-buffered, or
        # fully rejected back to clients). Accumulated per batcher,
        # flushed once in on_drain.
        hw = self._ingest_credit_hw.get(src)
        if hw is None or run.seq > hw:
            self._ingest_credit_hw[src] = run.seq
        k = n
        admission = self.admission
        if admission is not None:
            k = admission.admit_up_to(n)
            if k < n:
                reject_value_suffix(self.send, values, k, admission)
                if k == 0:
                    return
                view = value_view(values)
                values = (view.lazy_values(k) if view is not None
                          else tuple(values)[:k])
        if isinstance(self.state, _Phase1):
            self._admitted_backlog += k
            for value in tuple(values)[:k]:  # cold: Phase1 only
                self.state.pending_batches.append(
                    ClientRequestBatch(value))
            return
        self._note_ingest(k, len(getattr(values, "raw", b"")))
        self._propose_value_run(values)

    def _handle_client_request_batch(self, src: Address,
                                     batch: ClientRequestBatch) -> None:
        if isinstance(self.state, _Inactive):
            # Bounce the batch back so the batcher can re-route it
            # (Leader.scala:606-634).
            self.send(src, NotLeaderBatcher(client_request_batch=batch))
        elif not self._admit(batch, len(batch.batch.commands)):
            pass
        elif isinstance(self.state, _Phase1):
            self._admitted_backlog += len(batch.batch.commands)
            self.state.pending_batches.append(batch)
        else:
            self._process_client_request_batch(batch)

    def _handle_leader_info_request_client(self, src: Address, _) -> None:
        if not isinstance(self.state, _Inactive):
            self.send(src, LeaderInfoReplyClient(round=self.round))

    def _handle_leader_info_request_batcher(self, src: Address, _) -> None:
        if not isinstance(self.state, _Inactive):
            self.send(src, LeaderInfoReplyBatcher(round=self.round))

    def _handle_nack(self, src: Address, nack: Nack) -> None:
        if nack.round <= self.round:
            self.logger.debug(f"stale Nack in round {nack.round}; ignoring")
            return
        if isinstance(self.state, _Inactive):
            self.round = nack.round
        else:
            self.round = self.round_system.next_classic_round(self.index,
                                                              nack.round)
            self.leader_change(is_new_leader=True)

    def _handle_chosen_watermark(self, src: Address,
                                 msg: ChosenWatermark) -> None:
        self.chosen_watermark = max(self.chosen_watermark, msg.slot)
        if self.admission is not None:
            # Drain-granular release: the watermark advance IS the
            # signal that in-flight slots completed their quorums.
            self._sync_inflight()

    def _handle_recover(self, src: Address, recover: Recover) -> None:
        # Re-running Phase1 recovers every unchosen slot below some chosen
        # one (Leader.scala:698-722).
        if not isinstance(self.state, _Inactive):
            self.leader_change(is_new_leader=True)

    # --- reconfiguration (reconfig/) ------------------------------------
    def _handle_reconfigure(self, src: Address,
                            msg: Reconfigure) -> None:
        """Start the leader-driven config-change flow: define epoch
        e+1 over ``msg.members`` with activation watermark ``next_slot``
        (in-flight runs below it drain in the old epoch), broadcast the
        round-tagged EpochCommit, and buffer new proposals until a
        write quorum of OLD-epoch acceptors has durably acked it."""
        if self.epochs is None:
            self.logger.warn(
                "Reconfigure ignored: epochs need a single non-flexible "
                "acceptor group")
            return
        if not isinstance(self.state, _Phase2):
            self.logger.debug("Reconfigure ignored outside Phase2 "
                              "(admin should retry at the leader)")
            return
        if self._epoch_change is not None:
            if not self._epoch_change.activated:
                self.logger.debug(
                    "Reconfigure ignored: a change is mid-activation")
                return
            # The previous change is ACTIVE and only chasing straggler
            # acks (possibly of dead members); the new change's commit
            # flow supersedes those resends.
            self._abort_epoch_change()
        current = self.epochs.current()
        members = tuple(msg.members)
        if members == current.members:
            return
        if self.next_slot < current.start_slot:
            # This leader adopted the current epoch but has not
            # proposed up to its activation watermark yet; a successor
            # epoch must start at or above it (epoch starts are
            # monotone). Let the admin retry once caught up.
            self.logger.debug("Reconfigure ignored: next_slot below "
                              "the current epoch's start")
            return
        try:
            config = EpochConfig(epoch=current.epoch + 1,
                                 start_slot=self.next_slot,
                                 f=self.config.f, members=members)
        except ValueError as e:
            self.logger.warn(f"Reconfigure rejected: {e}")
            return
        self._drive_epoch_change(config, predecessor=current,
                                 recommit=False)

    def _drive_epoch_change(self, config: EpochConfig,
                            predecessor: "EpochConfig | None",
                            recommit: bool) -> None:
        """Broadcast + resend one epoch's commit until the activation
        gate (f+1 of the PREDECESSOR's acceptors durably acked) opens;
        proposals buffer meanwhile (the handover window). Targets:
        both acceptor sets (old = the matchmakers, new = the set that
        must know its own era), every proxy leader (they route and
        count -- and their acks release stashed epoch-tagged runs),
        every peer leader (so a failover has the map before its Phase1
        even asks)."""
        commit = EpochCommit(epoch=config.epoch,
                             start_slot=config.start_slot,
                             f=config.f, round=self.round,
                             members=config.members)
        targets: dict = dict.fromkeys(
            predecessor.members if predecessor else ())
        targets.update(dict.fromkeys(config.members))
        targets.update(dict.fromkeys(self.config.proxy_leader_addresses))
        targets.update(dict.fromkeys(
            a for a in self.config.leader_addresses if a != self.address))

        def resend():
            change = self._epoch_change
            if change is None or change.config is not config:
                return
            for dst in change.targets:
                if dst not in change.acks:
                    self.send(dst, change.commit)
            timer.start()

        timer = self.timer("resendEpochCommit",
                           self.options.resend_epoch_commit_period_s,
                           resend)
        timer.start()
        self._epoch_change = _EpochChange(
            config=config, commit=commit, targets=set(targets),
            acks=set(), resend=timer, pending=[], recommit=recommit)
        for dst in targets:
            self.send(dst, commit)

    def _ensure_epoch_durability(self, reporters) -> None:
        """Before this leader proposes into an ADOPTED newest epoch,
        its commit must be provably durable at f+1 of its
        predecessor's acceptors (else a future Phase1 could miss it
        and re-propose its slots under the old quorums). ``reporters``
        are the acceptors whose Phase1bs carried the epoch. Two proofs
        stand: the reporters already form the predecessor write quorum,
        or the chosen watermark is STRICTLY past the epoch's activation
        slot -- a slot chosen UNDER the epoch implies, inductively,
        that some gate-compliant leader activated it with the durable
        quorum (whose WALs outlive any crash). Proven: only the proxies
        need a gateless resync. Unproven: drive a GATED re-commit that
        buffers proposals until the predecessor quorum acks."""
        newest = self.epochs.current()
        pred = self.epochs.config(newest.epoch - 1)
        if pred is None or pred.has_write_quorum(reporters) \
                or self.chosen_watermark > newest.start_slot:
            self._start_epoch_sync()
            return
        self._drive_epoch_change(newest, predecessor=pred,
                                 recommit=True)

    def _start_epoch_sync(self) -> None:
        sync_commits = [
            EpochCommit(epoch=c.epoch, start_slot=c.start_slot, f=c.f,
                        round=self.round, members=c.members)
            for c in self.epochs.known()[1:]]
        pending = set(self.config.proxy_leader_addresses)

        def resend():
            sync = self._epoch_sync
            if sync is None or sync["commits"] is not sync_commits:
                return
            for dst in sync["pending"]:
                for commit in sync_commits:
                    self.send(dst, commit)
            timer.start()

        timer = self.timer("resendEpochSync",
                           self.options.resend_epoch_commit_period_s,
                           resend)
        timer.start()
        self._epoch_sync = {"epoch": sync_commits[-1].epoch,
                            "commits": sync_commits,
                            "pending": pending, "timer": timer}
        for dst in self.config.proxy_leader_addresses:
            for commit in sync_commits:
                self.send(dst, commit)

    def _stop_epoch_sync(self) -> None:
        if self._epoch_sync is not None:
            self._epoch_sync["timer"].stop()
            self._epoch_sync = None

    def _handle_epoch_ack(self, src: Address, ack: EpochAck) -> None:
        sync = self._epoch_sync
        if sync is not None and ack.epoch == sync["epoch"] \
                and ack.round == self.round:
            sync["pending"].discard(src)
            if not sync["pending"]:
                self._stop_epoch_sync()
        change = self._epoch_change
        if change is None or ack.epoch != change.config.epoch \
                or ack.round != self.round:
            return
        change.acks.add(src)
        if not change.activated:
            pred = self.epochs.config(change.config.epoch - 1)
            if pred is None or pred.has_write_quorum(change.acks):
                # COMMIT POINT: f+1 predecessor-epoch acceptors hold
                # the epoch WAL-durably -- any future leader's
                # old-epoch read quorum will discover it. Activate:
                # the buffered proposals open the new epoch's slots.
                try:
                    self.epochs.offer(change.config, self.round)
                except ValueError as e:
                    # The store moved under the change (a concurrent
                    # adoption): abort; clients resend the buffer.
                    self.logger.warn(f"epoch activation aborted: {e}")
                    self._abort_epoch_change()
                    return
                change.activated = True
                # Post-activation the resends only need to reach the
                # parties that ROUTE by the epoch (proxies) and the
                # new members; stop chasing old-epoch/peer-leader
                # stragglers -- in the canonical repair the
                # reconfigured-OUT member is dead and would be pinged
                # forever.
                change.targets &= (
                    set(self.config.proxy_leader_addresses)
                    | set(change.config.members))
                pending, change.pending = change.pending, []
                if pending:
                    self._send_epoch_runs(tuple(pending))
        if change.activated and change.targets <= change.acks:
            change.resend.stop()
            self._epoch_change = None

    def _handle_epoch_commit(self, src: Address,
                             commit: EpochCommit) -> None:
        """A peer leader's commit broadcast: adopt the entry (so this
        leader's next Phase1 covers it without discovery) and ack so
        the committer's resends stop."""
        if self.epochs is None:
            return
        try:
            outcome = self.epochs.offer(
                EpochConfig(epoch=commit.epoch,
                            start_slot=commit.start_slot,
                            f=commit.f, members=commit.members),
                commit.round)
        except ValueError as e:
            self.logger.warn(f"peer EpochCommit rejected: {e}")
            return
        if outcome in ("new", "replaced", "dup"):
            self.send(src, EpochAck(epoch=commit.epoch,
                                    round=commit.round))
        if outcome in ("new", "replaced") \
                and isinstance(self.state, _Phase2) \
                and self._epoch_change is None:
            # An ACTIVE leader adopting a peer's epoch mid-Phase2: it
            # must not propose into the adopted epoch on the peer's
            # word alone -- gate on its own durable predecessor-quorum
            # proof exactly like the post-Phase1 path.
            self._ensure_epoch_durability(reporters=())
