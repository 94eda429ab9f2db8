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
Not ported yet (ROADMAP.md, the next slice), and refused: admission
control (the ``admission_*`` options), epoch-tagged proposals and the
reconfiguration messages, and the ingest fabric (IngestRun and the
client wire sinks; no such message exists in the port).
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
from frankenpaxos_tpu_torch.reconfig import RECONFIG_MESSAGES
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
import numpy as np
import torch


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
    # batched K8 (ops/value.safe_values) over the whole recovery window.
    phase1_backend: str = "host"
    # Epoch-tagged proposals (reconfiguration): not ported yet; True is
    # refused.
    epoch_tag_runs: bool = False
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

    def admission_armed(self) -> bool:
        return any((self.admission_token_rate, self.admission_token_burst,
                    self.admission_inflight_limit,
                    self.admission_inbox_capacity,
                    self.admission_codel_target_s,
                    self.admission_retry_after_ms))


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
    # is taken over all of them).
    by_addr: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Phase2:
    noop_flush: Optional[object] = None  # Timer


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
        if options.admission_armed():
            raise NotImplementedError(
                "admission control is not ported yet (ROADMAP.md, the "
                "next slice: admission)")
        if options.epoch_tag_runs:
            raise NotImplementedError(
                "epoch-tagged proposals are not ported yet (ROADMAP.md, "
                "the next slice: reconfiguration)")
        # K8's device: resolved now, so that "cuda" without a GPU (and
        # no device named) fails at construction, not at a failover.
        self.device = (resolve_device(device)
                       if options.phase1_backend == "cuda" else None)
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
        # Active leader's round, or the largest known active round.
        self.round = self.round_system.next_classic_round(0, -1)
        self.next_slot = 0
        self.chosen_watermark = 0
        self._current_proxy_leader = 0
        self._unflushed_phase2as = 0
        self._chunk_sent = 0
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
        (K8, ops/value.safe_values) -- votes become (round, value-id)
        matrices, the device returns each slot's highest-round value id,
        and the host maps ids back to values (Leader.scala:504-576's
        scan as a single reduction).
        """
        # Non-flexible mode partitions slots over acceptor groups
        # (slot % G owns the slot); in FLEXIBLE mode the "groups" are
        # grid ROWS -- every acceptor votes on every slot, so recovery
        # must scan ALL Phase1bs for every slot. Applying the
        # partitioning rule to a grid dropped reported votes whose
        # acceptor sat in the "wrong" row and recovered Noop over a
        # chosen value (found by the reference's 500x250 soak,
        # multipaxos/f1-grid seed 493: replica logs diverged).
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
        vote_rounds = np.full((padded, n_cols), value_ops.NO_VOTE,
                              dtype=np.int32)
        value_ids = np.zeros((padded, n_cols), dtype=np.int32)
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
        has_vote, chosen = value_ops.safe_values(
            torch.from_numpy(vote_rounds).to(self.device),
            torch.from_numpy(value_ids).to(self.device))
        has_vote = has_vote.cpu().numpy()[:num_slots]
        chosen = chosen.cpu().numpy()[:num_slots]
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
        (Leader.scala:318-330): for each slot, the first vote with the
        strictly highest round over the slot's Phase1bs in arrival
        order, else Noop. One pass over the votes instead of one pass
        per slot; the choices are the same."""
        lo = self.chosen_watermark
        num_groups = self.config.num_acceptor_groups
        best: dict = {}  # slot -> (vote_round, vote_value)
        for group_index, group in enumerate(phase1.phase1bs):
            for phase1b in group.values():
                for info in phase1b.info:
                    slot = info.slot
                    if not lo <= slot <= max_slot or (
                            not self.config.flexible
                            and slot % num_groups != group_index):
                        continue
                    cur = best.get(slot)
                    if info.vote_round > (-1 if cur is None else cur[0]):
                        best[slot] = (info.vote_round, info.vote_value)
        return [best[s][1] if s in best else NOOP
                for s in range(lo, max_slot + 1)]

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
        self._send_phase2a(Phase2a(slot=self.next_slot, round=self.round,
                                   value=batch.batch))
        self.next_slot += 1

    # --- phase 1 ----------------------------------------------------------
    def _start_phase1(self, round: int, chosen_watermark: int) -> _Phase1:
        phase1a = Phase1a(round=round, chosen_watermark=chosen_watermark)
        if not self.config.flexible:
            # A thrifty f+1 sample per group (a majority is both the
            # read and the write quorum); the resend widens to every
            # acceptor.
            for group in self.config.acceptor_addresses:
                for acceptor in self.rng.sample(list(group),
                                                self.config.f + 1):
                    self.send(acceptor, phase1a)
        else:
            for flat in self.grid.random_read_quorum(self.rng):
                self.send(self._acceptor_address(flat), phase1a)

        def resend():
            for group in self.config.acceptor_addresses:
                for acceptor in group:
                    self.send(acceptor, phase1a)
            timer.start()

        timer = self.timer("resendPhase1as",
                           self.options.resend_phase1as_period_s, resend)
        timer.start()
        return _Phase1(
            phase1bs=[{} for _ in range(self.config.num_acceptor_groups)],
            phase1b_acceptors=set(),
            pending_batches=[],
            resend_phase1as=timer)

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

    def leader_change(self, is_new_leader: bool) -> None:
        """Election callback (Leader.scala:432-459)."""
        self._stop_state_timers()
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
            (LeaderInfoRequestClient, "LeaderInfoRequestClient",
             self._handle_leader_info_request_client),
            (LeaderInfoRequestBatcher, "LeaderInfoRequestBatcher",
             self._handle_leader_info_request_batcher),
            (Nack, "Nack", self._handle_nack),
            (ChosenWatermark, "ChosenWatermark",
             self._handle_chosen_watermark),
            (Recover, "Recover", self._handle_recover),
        ]
        for klass, label, handler in handlers:
            if isinstance(message, klass):
                self.metrics_requests.labels(label).inc()
                handler(src, message)
                return
        if isinstance(message, RECONFIG_MESSAGES):
            raise NotImplementedError(
                f"{type(message).__name__}: actor-side reconfiguration is "
                f"not ported yet (ROADMAP.md, the next slice: "
                f"reconfiguration)")
        self.logger.fatal(f"unexpected leader message {message!r}")

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

        if phase1b.epochs:
            raise NotImplementedError(
                "Phase1b reports epochs: actor-side reconfiguration is "
                "not ported yet (ROADMAP.md, the next slice: "
                "reconfiguration)")
        phase1.by_addr[src] = phase1b
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
        for batch in phase1.pending_batches:
            self._process_client_request_batch(batch)

    def _handle_client_request(self, src: Address,
                               request: ClientRequest) -> None:
        if isinstance(self.state, _Inactive):
            self.send(src, NotLeaderClient())
        elif isinstance(self.state, _Phase1):
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
        if isinstance(self.state, _Phase1):
            for command in array.commands:
                self.state.pending_batches.append(
                    ClientRequestBatch(CommandBatch((command,))))
            return
        self._propose_value_run(
            tuple(CommandBatch((c,)) for c in array.commands))

    def _propose_value_run(self, values) -> None:
        """Phase2 proposal of the one-value-per-slot tuple ``values``."""
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
        run = Phase2aRun(
            start_slot=self.next_slot, round=self.round, values=values)
        k = len(values)
        self.next_slot += k
        dst = self._proxy_leader_address()
        self.send(dst, run)
        # A run counts as k slots toward the proxy-leader chunk
        # rotation (runs never use the no-flush buffer).
        self._account_sent_slots(dst, k)

    def _handle_client_request_batch(self, src: Address,
                                     batch: ClientRequestBatch) -> None:
        if isinstance(self.state, _Inactive):
            # Bounce the batch back so the batcher can re-route it
            # (Leader.scala:606-634).
            self.send(src, NotLeaderBatcher(client_request_batch=batch))
        elif isinstance(self.state, _Phase1):
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

    def _handle_recover(self, src: Address, recover: Recover) -> None:
        # Re-running Phase1 recovers every unchosen slot below some chosen
        # one (Leader.scala:698-722).
        if not isinstance(self.state, _Inactive):
            self.leader_change(is_new_leader=True)
