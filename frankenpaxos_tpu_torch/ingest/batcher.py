"""IngestBatcher: the HT-Paxos-style disseminator role (the port's copy
of ``frankenpaxos_tpu/ingest/batcher.py``).

Client fan-in (thousands of connections) terminates HERE instead of at
the ordering leader. The batcher absorbs ``ClientRequest`` /
``ClientRequestArray`` traffic -- on the deployed transport, whole
``ClientFrameBatch`` frames land through the wire-sink fast path as
SoA columns, never as per-message objects -- runs the serve/ admission
discipline at the edge, and once per drain ships the staged commands
as pre-encoded :class:`~frankenpaxos_tpu_torch.ingest.messages.IngestRun`
descriptors to the current round's leader. The leader touches only run
metadata; the value bytes it forwards are the bytes the clients sent.

Batchers are WAL-free BY DESIGN: their only state is unflushed
staging, and clients keep their retry budgets -- a batcher death costs
client retries (resent commands stay exactly-once through the replica
client table), never acked-write loss. The chaos sim twin
(tests/test_torch_ingest_chaos.py) kills and restarts batchers
under partitions to hold exactly that line.

Routing is protocol-pluggable: :class:`MultiPaxosIngestRouter` targets
the round's single leader; the reference's ``MenciusIngestRouter``,
which spreads runs over leader groups, waits for Mencius (ROADMAP.md
queue 1 item 9) and raises. Leader discovery reuses the protocols' existing
``LeaderInfoRequestBatcher``/``LeaderInfoReplyBatcher`` flow; an
inactive leader bounces the run back as ``NotLeaderIngest``.
"""

from __future__ import annotations

import collections
import dataclasses
import random

import numpy as np

from frankenpaxos_tpu_torch.ingest.columns import (
    CLIENT_ARRAY_TAG,
    ColumnRun,
    parse_client_array,
    parse_client_batch,
)
from frankenpaxos_tpu_torch.ingest.messages import (
    IngestCredit,
    IngestRun,
    NotLeaderIngest,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.paxwire import CLIENT_BATCH_TAG
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport

#: Cap on the distinct-session tracking set behind the
#: fpx_runtime_ingest_shard_owned_keys gauge: past this the gauge
#: saturates rather than the set growing with a million-session tier.
_MAX_TRACKED_KEYS = 1 << 17


@dataclasses.dataclass(frozen=True)
class IngestBatcherOptions:
    #: Commands per IngestRun descriptor built from LOOSE (decoded)
    #: commands; column runs ship at their wire-batch granularity.
    max_run: int = 4096
    #: Safety-net flush for staging that outlives a drain (0 disables;
    #: on both transports on_drain normally flushes every pass).
    flush_period_s: float = 0.01
    #: paxfan descriptor pipelining: max un-credited IngestRuns in
    #: flight per leader group. The batcher ships AHEAD of leader
    #: acks up to this window (the leader drains several runs per
    #: event-loop pass and replies with one watermark-granular
    #: IngestCredit per drain); 0 disables the window (ship
    #: immediately, unbounded -- the pre-paxfan behavior).
    pipeline_window: int = 16
    #: Consecutive blocked safety-net ticks before a wedged window
    #: resets. Credits ride the control lane and survive client-lane
    #: shedding, but a leader crash can still swallow them -- the
    #: reset re-opens the window (duplicate deliveries stay
    #: exactly-once through the replica client table).
    pipeline_stall_ticks: int = 50
    # paxload admission control at the ingest edge (serve/admission.py):
    # all zeros admits everything and builds NO controller.
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


class MultiPaxosIngestRouter:
    """Route runs to the MultiPaxos round's leader."""

    num_groups = 1

    def __init__(self, config):
        from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin

        self.config = config
        self.round_system = ClassicRoundRobin(config.num_leaders)
        self.round = 0

    def leader(self, group: int) -> Address:
        return self.config.leader_addresses[
            self.round_system.leader(self.round)]

    def choose_group(self, rng: random.Random) -> int:
        return 0

    def discovery_targets(self, group: int) -> list:
        return list(self.config.leader_addresses)

    def info_request(self):
        from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
            LeaderInfoRequestBatcher,
        )

        return LeaderInfoRequestBatcher()

    def is_info_reply(self, message) -> bool:
        from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
            LeaderInfoReplyBatcher,
        )

        return isinstance(message, LeaderInfoReplyBatcher)

    def note_info(self, message) -> None:
        self.round = max(self.round, message.round)


class MenciusIngestRouter:
    """The reference's router of runs over Mencius leader groups. Mencius
    is not ported yet (ROADMAP.md queue 1 item 9), so this raises."""

    def __init__(self, config):
        raise NotImplementedError(
            "Mencius is not ported yet (ROADMAP.md queue 1 item 9), so "
            "its ingest router is refused")


class IngestBatcher(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, router, index: int = 0,
                 options: IngestBatcherOptions = IngestBatcherOptions(),
                 seed: int = 0):
        super().__init__(address, transport, logger)
        self.router = router
        self.index = index
        self.options = options
        self.rng = random.Random(seed)
        # Staged work, flushed once per drain: ColumnRun prefixes from
        # the wire-sink fast path (raw bytes, no objects) and loose
        # decoded Commands from the per-message path.
        self._staged_columns: list = []   # (ColumnRun, admitted k)
        self._staged_commands: list = []  # Command
        # (group, IngestRun) bounced by inactive leaders, awaiting
        # leader discovery.
        self._pending_runs: list = []
        # paxfan descriptor pipelining: per-group run sequencing, the
        # in-flight (un-credited) seq sets bounding the window, the
        # overflow queue of runs waiting for credit, and the stall
        # escape. _last_leader detects failovers: a leader change
        # voids that group's outstanding credits.
        num_groups = router.num_groups
        self._next_seq = [0] * num_groups
        self._inflight: list = [set() for _ in range(num_groups)]
        self._window_queue: list = [collections.deque()
                                    for _ in range(num_groups)]
        self._stall_ticks = [0] * num_groups
        self._last_leader: list = [None] * num_groups
        self.failovers = 0
        # Shard telemetry: distinct sessions seen (capped) and this
        # shard's structural ring share (skew = share * N; 1.0 = even).
        self._seen_keys: set = set()
        num_batchers = getattr(router.config, "num_ingest_batchers", 0)
        if num_batchers > 1:
            from frankenpaxos_tpu_torch.ingest.fan import BatcherRing

            share = BatcherRing(num_batchers).arc_share()
            self.ring_skew = share[index % num_batchers] * num_batchers
        else:
            self.ring_skew = 1.0
        admission_options = options.admission_options()
        if admission_options is not None:
            from frankenpaxos_tpu_torch.serve.admission import (
                AdmissionController,
            )

            self.admission = AdmissionController(
                admission_options, role=f"ingest_batcher_{index}",
                metrics=transport.runtime_metrics)
            transport.note_admission(address, self)
        # The zero-object fast path: client batch frames AND un-batched
        # coalesced arrays land here as columns
        # (runtime/tcp_transport.py dispatches by leading tag).
        self.wire_sinks = {
            CLIENT_BATCH_TAG: (parse_client_batch,
                               self._handle_client_columns),
            CLIENT_ARRAY_TAG: (parse_client_array,
                               self._handle_client_columns),
        }
        self._flush_timer = None
        if options.flush_period_s > 0:
            self._flush_timer = self.timer(
                "ingestFlush", options.flush_period_s, self._timer_flush)

    # --- staging ----------------------------------------------------------
    def _arm_flush(self) -> None:
        if self._flush_timer is not None and not (
                self._staged_columns or self._staged_commands):
            # First stage of this drain: (re)arm the safety-net flush.
            self._flush_timer.stop()
            self._flush_timer.start()

    def _timer_flush(self) -> None:
        if self._staged_columns or self._staged_commands:
            self.flush_ingest()
        for group in range(self.router.num_groups):
            if not self._window_queue[group]:
                continue
            if not self._inflight[group]:
                self._pump(group)
            elif self._bump_stall(group):
                self._pump(group)
            # Queued runs outlive this tick: keep the safety net armed.
            self._flush_timer.stop()
            self._flush_timer.start()

    def _bump_stall(self, group: int) -> bool:
        """Stall escape: runs queued, window full, no credit arriving.
        Credits ride the control lane, but a crashed leader can still
        swallow them -- after pipeline_stall_ticks consecutive blocked
        ticks, void the window and ship (duplicate deliveries stay
        exactly-once through the replica client table)."""
        self._stall_ticks[group] += 1
        if self._stall_ticks[group] < self.options.pipeline_stall_ticks:
            return False
        self.logger.warn(
            f"ingest batcher {self.index}: pipeline window for group "
            f"{group} wedged ({len(self._inflight[group])} un-credited "
            "runs); resetting window")
        self._inflight[group].clear()
        self._stall_ticks[group] = 0
        self.failovers += 1
        self._note_failover()
        return True

    def _handle_client_columns(self, src: Address,
                               colrun: ColumnRun) -> None:
        """Wire-sink handler: a whole client frame batch as columns."""
        n = len(colrun)
        if n == 0:
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
        self._arm_flush()
        if len(self._seen_keys) < _MAX_TRACKED_KEYS:
            # Distinct sessions behind the owned_keys gauge: one
            # vectorized unique over the admitted pseudonym column --
            # no per-command Python.
            self._seen_keys.update(
                np.unique(colrun.cols[:k, 1]).tolist())
        # Ownership contract: the parser output may view the
        # transport's receive buffer, which is compacted after this
        # dispatch returns. Staging past the dispatch takes ownership.
        self._staged_columns.append((colrun.to_owned(), k))

    def _admit(self, message, n: int) -> bool:
        admission = self.admission
        if admission is None or admission.admit(n):
            return True
        from frankenpaxos_tpu_torch.serve.admission import reject_replies_for

        for client, reply in reject_replies_for(
                message, admission.retry_after_ms(),
                admission.last_reason):
            self.send(client, reply)
        return False

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        name = type(message).__name__
        if name == "ClientRequest":
            if self._admit(message, 1):
                self._arm_flush()
                self._staged_commands.append(message.command)
                self._track_key(
                    message.command.command_id.client_pseudonym)
        elif name == "ClientRequestArray":
            if self._admit(message, len(message.commands)):
                self._arm_flush()
                self._staged_commands.extend(message.commands)
                for command in message.commands:
                    self._track_key(command.command_id.client_pseudonym)
        elif isinstance(message, IngestCredit):
            self._handle_credit(message)
        elif isinstance(message, NotLeaderIngest):
            self._handle_not_leader(src, message)
        elif self.router.is_info_reply(message):
            self.router.note_info(message)
            self._note_leader_changes()
            self._resend_pending()
        else:
            self.logger.fatal(
                f"unexpected ingest batcher message {message!r}")

    def _handle_not_leader(self, src: Address,
                           bounce: NotLeaderIngest) -> None:
        # A bounced run is out of the window -- it re-enters on resend.
        self._inflight[bounce.group_index].discard(bounce.run.seq)
        self._pending_runs.append((bounce.group_index, bounce.run))
        request = self.router.info_request()
        for dst in self.router.discovery_targets(bounce.group_index):
            self.send(dst, request)

    def _handle_credit(self, credit: IngestCredit) -> None:
        """Leader ack: every seq <= watermark drained; reopen window."""
        group = credit.group_index
        inflight = self._inflight[group]
        for seq in [s for s in inflight if s <= credit.watermark_seq]:
            inflight.discard(seq)
        self._stall_ticks[group] = 0
        self._pump(group)

    def _note_leader_changes(self) -> None:
        """A leader change voids that group's outstanding credits: the
        new leader never saw the old in-flight runs (resends go through
        _pending_runs), so holding the window shut against it would
        wedge the pipeline."""
        for group in range(self.router.num_groups):
            leader = self.router.leader(group)
            if leader != self._last_leader[group]:
                if self._last_leader[group] is not None:
                    self.failovers += 1
                    self._note_failover()
                    self._inflight[group].clear()
                    self._stall_ticks[group] = 0
                self._last_leader[group] = leader
                self._pump(group)

    def _resend_pending(self) -> None:
        pending, self._pending_runs = self._pending_runs, []
        for group, run in pending:
            self._inflight[group].add(run.seq)
            self.send(self.router.leader(group), run)

    # --- flush ------------------------------------------------------------
    def on_drain(self) -> None:
        self.flush_ingest()

    def flush_ingest(self) -> None:
        """Ship everything staged this drain as pre-encoded runs."""
        if self._staged_columns:
            staged, self._staged_columns = self._staged_columns, []
            for colrun, k in staged:
                values = colrun.lazy_values(k)
                # lazy_values wraps
                # colrun.raw, which ingest_scan returns as an OWNED
                # bytes copy (never the receive buffer; buf is the
                # borrowed side and to_owned() already copied it at
                # staging), so queuing past the drain is safe.
                self._ship(self.router.choose_group(self.rng),
                           values, nbytes=len(values.raw))
        if self._staged_commands:
            from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
                CommandBatch,
            )

            staged_cmds, self._staged_commands = \
                self._staged_commands, []
            max_run = self.options.max_run
            for at in range(0, len(staged_cmds), max_run):
                chunk = staged_cmds[at:at + max_run]
                self._ship(self.router.choose_group(self.rng),
                           tuple(CommandBatch((c,)) for c in chunk))

    def _ship(self, group: int, values, nbytes: int = 0) -> None:
        self._window_queue[group].append((values, nbytes))
        self._pump(group)

    def _pump(self, group: int) -> None:
        """Ship queued runs up to the pipeline window. seq is assigned
        at ACTUAL ship time (not staging time) so the per-(batcher,
        group) stream stays gap-free and monotone even when runs sit
        queued behind a closed window."""
        window = self.options.pipeline_window
        queue = self._window_queue[group]
        inflight = self._inflight[group]
        metrics = self.transport.runtime_metrics
        shipped = 0
        while queue and (window <= 0 or len(inflight) < window):
            values, nbytes = queue.popleft()
            seq = self._next_seq[group]
            self._next_seq[group] += 1
            run = IngestRun(batcher_index=self.index, values=values,
                            seq=seq)
            if window > 0:
                inflight.add(seq)
            self.send(self.router.leader(group), run)
            shipped += len(values)
            if metrics is not None:
                raw = getattr(values, "raw", None)
                metrics.ingest_batch(
                    len(values),
                    nbytes or (len(raw) + 8 if raw is not None else 0))
        if metrics is not None:
            if shipped:
                metrics.ingest_shard_routed(self.index, shipped)
            metrics.ingest_shard_state(
                self.index, owned_keys=len(self._seen_keys),
                pipeline_depth=sum(len(s) for s in self._inflight),
                skew=self.ring_skew)
        if queue and self._flush_timer is not None:
            # Window closed with work still queued: the safety-net
            # tick is the credit-loss backstop, keep it armed.
            self._flush_timer.stop()
            self._flush_timer.start()

    # --- shard telemetry --------------------------------------------------
    def _track_key(self, pseudonym: int) -> None:
        if len(self._seen_keys) < _MAX_TRACKED_KEYS:
            self._seen_keys.add(pseudonym)

    def _note_failover(self) -> None:
        metrics = self.transport.runtime_metrics
        if metrics is not None:
            metrics.ingest_shard_failover(self.index)
