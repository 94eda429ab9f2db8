"""MultiPaxos Replica (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/replica.py``).

Reference behavior: multipaxos/Replica.scala:151-691. A BufferMap log
(Replica.scala:194), in-order ``execute_log`` advancing the executed
watermark (Replica.scala:394-453), a simple client table (in-order
execution per client), chosen-watermark gossip every N entries with
responsibility round-robin'd across replicas (Replica.scala:421-447), a
randomized hole-recovery timer (Replica.scala:238-260), and deferred
reads parked until their slot executes (Replica.scala:203-211,455-530).

With ``wal=`` (a ``wal.Wal``) chosen entries are logged, client replies
leave after the drain's group-commit fsync (``wal.DurableRole``), and a
restart rebuilds the state machine from the latest snapshot plus the
chosen runs logged after it.

Read admission (the ``admission_*`` options, ``serve/admission.py``)
sheds READ traffic only: the in-flight measure is the deferred-read
backlog, and a refused read's client gets an explicit ``Rejected``;
the batched reads of read batchers admit command by command against one
sync a batch.
"""

from __future__ import annotations

import dataclasses
import random
import struct
from typing import Optional

from frankenpaxos_tpu_torch.protocols.multipaxos.config import (
    DistributionScheme,
    MultiPaxosConfig,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    Chosen,
    ChosenRun,
    ChosenWatermark,
    ClientReply,
    ClientReplyArray,
    ClientReplyBatch,
    Command,
    CommandBatch,
    EventualReadRequest,
    EventualReadRequestBatch,
    Noop,
    ReadReply,
    ReadReplyBatch,
    ReadRequest,
    ReadRequestBatch,
    Recover,
    SequentialReadRequest,
    SequentialReadRequestBatch,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_address,
    _put_bytes,
    _take_address,
    _take_bytes,
    decode_value_array,
    encode_value_array,
)
from frankenpaxos_tpu_torch.runs.records import log_chosen_values, wal_log_chosen_run
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.statemachine import StateMachine
from frankenpaxos_tpu_torch.utils import BufferMap
from frankenpaxos_tpu_torch.wal import DurableRole, WalChosenRun, WalSnapshot


@dataclasses.dataclass(frozen=True)
class ReplicaOptions:
    log_grow_size: int = 5000
    unsafe_dont_use_client_table: bool = False
    send_chosen_watermark_every_n_entries: int = 100
    recover_log_entry_min_period_s: float = 10.0
    recover_log_entry_max_period_s: float = 20.0
    unsafe_dont_recover: bool = False
    measure_latencies: bool = True
    # paxload read-path admission (serve/admission.py): a replica
    # sheds READ traffic only -- Chosen/ChosenRun deliveries are the
    # write pipeline's control plane and never pass the controller.
    # The in-flight measure here is the deferred-read backlog. All
    # zeros (default) builds no controller.
    admission_token_rate: float = 0.0
    admission_token_burst: float = 0.0
    admission_inflight_limit: int = 0
    admission_inbox_capacity: int = 0
    admission_inbox_policy: str = "reject"
    admission_codel_target_s: float = 0.0
    admission_codel_interval_s: float = 0.1
    admission_retry_after_ms: int = 0


class Replica(Actor, DurableRole):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, state_machine: StateMachine,
                 config: MultiPaxosConfig,
                 options: ReplicaOptions = ReplicaOptions(),
                 collectors: Collectors | None = None, seed: int = 0,
                 wal=None):
        super().__init__(address, transport, logger)
        config.check_valid()
        logger.check(address in config.replica_addresses)
        self.config = config
        self.options = options
        self.state_machine = state_machine
        self.rng = random.Random(seed)
        collectors = collectors or FakeCollectors()
        self.metrics_latency = collectors.summary(
            "multipaxos_replica_requests_latency_seconds", labels=("type",))
        self.metrics_executed = collectors.counter(
            "multipaxos_replica_executed_commands_total")
        self.metrics_reads = collectors.counter(
            "multipaxos_replica_executed_reads_total")
        self.index = list(config.replica_addresses).index(address)
        self.log: BufferMap = BufferMap(options.log_grow_size)
        self.deferred_reads: BufferMap = BufferMap(options.log_grow_size)
        # Every entry below executed_watermark has been executed; numChosen
        # counts chosen entries -- together they detect pending holes.
        self.executed_watermark = 0
        self.num_chosen = 0
        # (client address, pseudonym) -> (largest executed id, its reply).
        self.client_table: dict[tuple, tuple[int, bytes]] = {}
        # Durability (wal/): chosen entries append to the WAL as they
        # arrive and client replies are held back until on_drain's
        # group-commit fsync releases them (DurableRole), so an
        # acknowledged write is always recoverable from this replica's
        # own log. Compaction snapshots the SM at the executed
        # watermark and reclaims every segment behind it (the
        # watermark GC extended to disk). wal=None is the reference's
        # in-memory behavior.
        self._wal_init(wal)
        # paxload read-path admission (serve/): built only when armed.
        self._deferred_read_count = 0
        self._wm_dirty = False  # executed advanced since last drain
        from frankenpaxos_tpu_torch.serve.admission import (
            AdmissionController,
            options_from_flat,
        )

        admission_options = options_from_flat(options)
        if admission_options is not None:
            self.admission = AdmissionController(
                admission_options, role=f"replica_{self.index}",
                metrics=transport.runtime_metrics)
            transport.note_admission(address, self)
        self.recover_timer = None
        if wal is not None:
            self._recover_from_wal()
        if not options.unsafe_dont_recover:
            self.recover_timer = self.timer(
                "recover",
                self.rng.uniform(options.recover_log_entry_min_period_s,
                                 options.recover_log_entry_max_period_s),
                self._recover)
            if wal is not None and self.executed_watermark < self.num_chosen:
                # Recovered with holes (chosen records above a gap):
                # start hole recovery immediately on rejoin.
                self.recover_timer.start()

    # --- durability -------------------------------------------------------
    def _snapshot_payload(self) -> bytes:
        """SM snapshot + executed watermark + client table, encoded
        with the wire helpers (no code execution on decode except the
        addresses' own escape hatch)."""
        out = bytearray()
        out += struct.pack("<q", self.executed_watermark)
        _put_bytes(out, self.state_machine.to_bytes())
        out += struct.pack("<i", len(self.client_table))
        for (address, pseudonym), (client_id, result) in \
                self.client_table.items():
            _put_address(out, address)
            out += struct.pack("<qq", pseudonym, client_id)
            _put_bytes(out, result)
        return bytes(out)

    def _restore_snapshot(self, payload: bytes) -> None:
        (watermark,) = struct.unpack_from("<q", payload, 0)
        sm_bytes, at = _take_bytes(payload, 8)
        (n,) = struct.unpack_from("<i", payload, at)
        at += 4
        table: dict = {}
        for _ in range(n):
            address, at = _take_address(payload, at)
            pseudonym, client_id = struct.unpack_from("<qq", payload, at)
            result, at = _take_bytes(payload, at + 16)
            table[(address, pseudonym)] = (client_id, result)
        self.state_machine.from_bytes(sm_bytes)
        self.executed_watermark = watermark
        # Every slot below the watermark is chosen and executed; the
        # log is GC'd to the watermark, so replayed/late entries below
        # it read as duplicates (see _log_chosen).
        self.num_chosen = watermark
        self.client_table = table
        self.log.garbage_collect(watermark)
        self.deferred_reads.garbage_collect(watermark)

    def _recover_from_wal(self) -> None:
        for record in self.wal.recover(self.logger):
            if isinstance(record, WalSnapshot):
                # Compaction base: reset, then restore.
                self.log = BufferMap(self.options.log_grow_size)
                self.executed_watermark = 0
                self.num_chosen = 0
                self.client_table = {}
                self._restore_snapshot(record.payload)
            elif isinstance(record, WalChosenRun):
                self._log_chosen(
                    record.start_slot,
                    decode_value_array(record.values))
            else:
                self.logger.fatal(
                    f"unexpected replica WAL record {record!r}")
        # Re-execute the recovered contiguous prefix (deterministic:
        # same entries, same order). Replies are DISCARDED -- every
        # reply the pre-crash replica sent was covered by a synced
        # record, and unacked clients resend (the client table keeps
        # re-execution exactly-once).
        self._execute_log()

    def _log_chosen(self, start_slot: int, values) -> int:
        """Put a contiguous run of chosen values into the log
        (runs/records.py); returns how many were new. Shared by the
        live handlers and WAL replay."""
        new, _ = log_chosen_values(self.log, self.executed_watermark,
                                   start_slot, 1, values)
        self.num_chosen += new
        return new

    def _wal_compact(self) -> None:
        """Snapshot the SM at the executed watermark and reclaim every
        segment behind it -- the in-memory watermark GC extended to
        disk. Chosen-but-unexecuted entries above the watermark (holes
        pending) are re-logged after the snapshot marker."""
        records = []
        for slot, value in self.log.items(start=self.executed_watermark):
            records.append(WalChosenRun(
                start_slot=slot, stride=1,
                values=encode_value_array((value,))))
        self.wal.compact(WalSnapshot(payload=self._snapshot_payload()),
                         records)
        self.log.garbage_collect(self.executed_watermark)
        self.deferred_reads.garbage_collect(self.executed_watermark)

    def on_drain(self) -> None:
        # Drain-granular watermark tail: the every-N notification
        # leaves the leader's view up to N-1 slots stale when the
        # pipeline goes quiet mid-decade. One extra message per drain,
        # from one replica (slot-round-robin), closes the tail.
        if (self._wm_dirty
                and self.executed_watermark
                % self.options.send_chosen_watermark_every_n_entries
                and self.executed_watermark % self.config.num_replicas
                == self.index):
            self._send_chosen_watermark()
        self._wm_dirty = False
        # GROUP COMMIT (DurableRole): one fsync covers every chosen
        # entry this drain logged; only then do the replies it
        # produced go out.
        self._wal_drain()

    def _send_chosen_watermark(self) -> None:
        watermark = ChosenWatermark(slot=self.executed_watermark)
        proxy = self._proxy_replica_address()
        if proxy is not None:
            self._wal_send(proxy, watermark)
        else:
            for leader in self.config.leader_addresses:
                self._wal_send(leader, watermark)

    # --- helpers ----------------------------------------------------------
    def _proxy_replica_address(self) -> Optional[Address]:
        if not self.config.proxy_replica_addresses:
            return None
        if self.config.distribution_scheme == DistributionScheme.HASH:
            return self.config.proxy_replica_addresses[
                self.rng.randrange(self.config.num_proxy_replicas)]
        return self.config.proxy_replica_addresses[self.index]

    def _recover(self) -> None:
        recover = Recover(slot=self.executed_watermark)
        proxy = self._proxy_replica_address()
        if proxy is not None:
            self.send(proxy, recover)
        else:
            for leader in self.config.leader_addresses:
                self.send(leader, recover)
        self.recover_timer.start()

    def _execute_command(self, slot: int, command: Command,
                         replies: list[ClientReply]) -> None:
        """Execute with exactly-once + reply-once-per-slot-owner semantics
        (Replica.scala:300-344)."""
        cid = command.command_id
        key = (cid.client_address, cid.client_pseudonym)
        cached = self.client_table.get(key)
        if cached is not None:
            largest_id, cached_result = cached
            if cid.client_id < largest_id:
                return
            if cid.client_id == largest_id:
                replies.append(ClientReply(cid, slot, cached_result))
                return
        result = self.state_machine.run(command.command)
        if not self.options.unsafe_dont_use_client_table:
            self.client_table[key] = (cid.client_id, result)
        if slot % self.config.num_replicas == self.index:
            replies.append(ClientReply(cid, slot, result))
        self.metrics_executed.inc()

    def _execute_log(self) -> list[ClientReply]:
        """Execute the contiguous chosen prefix (Replica.scala:394-453)."""
        replies: list[ClientReply] = []
        while True:
            value = self.log.get(self.executed_watermark)
            if value is None:
                return replies
            slot = self.executed_watermark
            if isinstance(value, CommandBatch):
                for command in value.commands:
                    self._execute_command(slot, command, replies)
            else:
                assert isinstance(value, Noop)
            reads = self.deferred_reads.get(slot)
            if reads is not None:
                self._process_deferred_reads(reads)
            self.executed_watermark += 1
            self._wm_dirty = True

            every_n = self.options.send_chosen_watermark_every_n_entries
            if (self.executed_watermark % every_n == 0
                    and (self.executed_watermark // every_n)
                    % self.config.num_replicas == self.index):
                self._send_chosen_watermark()

    def _execute_read(self, command: Command) -> ReadReply:
        result = self.state_machine.run(command.command)
        self.metrics_reads.inc()
        return ReadReply(command_id=command.command_id,
                         slot=self.executed_watermark - 1, result=result)

    def _send_read_replies(self, replies: list[ReadReply]) -> None:
        proxy = self._proxy_replica_address()
        if len(replies) > 1 and proxy is not None:
            self.send(proxy, ReadReplyBatch(batch=tuple(replies)))
        else:
            for reply in replies:
                self.send(reply.command_id.client_address, reply)

    def _process_deferred_reads(self, reads: list[Command]) -> None:
        self._deferred_read_count -= len(reads)
        if self.admission is not None:
            self.admission.set_inflight(self._deferred_read_count)
        self._send_read_replies([self._execute_read(c) for c in reads])

    def _defer_read(self, slot: int, command: Command) -> None:
        reads = self.deferred_reads.get(slot)
        if reads is None:
            self.deferred_reads.put(slot, [command])
        else:
            reads.append(command)
        self._deferred_read_count += 1

    def _admit_read(self, command: Command, sync: bool = True) -> bool:
        """paxload read admission: the in-flight measure is the
        deferred-read backlog; refusal answers the CLIENT (not the
        read batcher) with an explicit Rejected so its backoff engages
        instead of a resend storm. ``sync=False`` skips the backlog
        resync so batch callers can sync ONCE and let ``admit()``'s
        increments accumulate across the batch -- resyncing per
        command would erase them and the limit would never bind
        within one batch."""
        admission = self.admission
        if admission is None:
            return True
        if sync:
            admission.set_inflight(self._deferred_read_count)
        if admission.admit(1):
            return True
        from frankenpaxos_tpu_torch.serve.messages import Rejected

        cid = command.command_id
        self.send(cid.client_address, Rejected(
            entries=((cid.client_pseudonym, cid.client_id),),
            retry_after_ms=admission.retry_after_ms(),
            reason=admission.last_reason))
        return False

    def receive(self, src: Address, message) -> None:
        # timed(label) handler latency summaries (Leader.scala:281-293).
        if self.options.measure_latencies:
            with self.metrics_latency.labels(
                    type(message).__name__).time():
                self._receive_impl(src, message)
        else:
            self._receive_impl(src, message)

    def _receive_impl(self, src: Address, message) -> None:
        if isinstance(message, Chosen):
            self._handle_chosen(src, message)
        elif isinstance(message, ChosenRun):
            self._handle_chosen_run(src, message)
        elif isinstance(message, ReadRequest):
            self._handle_read_request(src, message)
        elif isinstance(message, SequentialReadRequest):
            self._handle_sequential_read_request(src, message)
        elif isinstance(message, EventualReadRequest):
            self._handle_eventual_read_request(src, message)
        elif isinstance(message, ReadRequestBatch):
            self._handle_read_request_batch(src, message)
        elif isinstance(message, SequentialReadRequestBatch):
            self._handle_read_request_batch(src, ReadRequestBatch(
                slot=message.slot, commands=message.commands))
        elif isinstance(message, EventualReadRequestBatch):
            self._handle_eventual_read_batch(message)
        else:
            self.logger.fatal(f"unexpected replica message {message!r}")

    def _wal_log_chosen_run(self, start_slot: int, values,
                            all_new: bool) -> None:
        """Append the run's NEW entries to the WAL (runs/records.py):
        all-new runs log the inbound lazy value array as ONE raw copy;
        a partially-duplicate run falls back to per-new-slot records
        (rare: a resend or post-failover overlap)."""
        wal_log_chosen_run(self.wal, self.log.get, start_slot, 1, values,
                           all_new=all_new, encode=encode_value_array)

    def _handle_chosen(self, src: Address, chosen: Chosen) -> None:
        """(Replica.scala:572-628)."""
        if self._log_chosen(chosen.slot, (chosen.value,)) == 0:
            return  # duplicate Chosen
        if self.wal is not None:
            self._wal_log_chosen_run(chosen.slot, (chosen.value,),
                                     all_new=True)
        replies = self._execute_log()
        if replies:
            proxy = self._proxy_replica_address()
            if proxy is not None:
                self._wal_send(proxy,
                               ClientReplyBatch(batch=tuple(replies)))
            else:
                for reply in replies:
                    self._wal_send(reply.command_id.client_address, reply)
        self._restart_recover_timer()

    def _handle_chosen_run(self, src: Address, run: ChosenRun) -> None:
        """A contiguous drain of chosen values in one message: log the
        whole run, execute once, and ship each client ONE reply array
        for the drain instead of one ClientReply per command."""
        new = self._log_chosen(run.start_slot, run.values)
        if new == 0:
            return
        if self.wal is not None:
            self._wal_log_chosen_run(run.start_slot, run.values,
                                     all_new=(new == len(run.values)))
        replies = self._execute_log()
        if replies:
            proxy = self._proxy_replica_address()
            if proxy is not None:
                self._wal_send(proxy,
                               ClientReplyBatch(batch=tuple(replies)))
            else:
                by_client: dict = {}
                for r in replies:
                    cid = r.command_id
                    by_client.setdefault(cid.client_address, []).append(
                        (cid.client_pseudonym, cid.client_id, r.slot,
                         r.result))
                for address, entries in by_client.items():
                    self._wal_send(address,
                                   ClientReplyArray(entries=tuple(entries)))
        self._restart_recover_timer()

    def _restart_recover_timer(self) -> None:
        # Recover timer runs only while there are unexecuted chosen slots
        # above a hole.
        if self.recover_timer is not None:
            if self.executed_watermark < self.num_chosen:
                self.recover_timer.start()
            else:
                self.recover_timer.stop()

    def _handle_read_request(self, src: Address,
                             request: ReadRequest) -> None:
        """Linearizable read at a slot; defer until executed
        (Replica.scala:455-530)."""
        if not self._admit_read(request.command):
            return
        if request.slot >= self.executed_watermark:
            self._defer_read(request.slot, request.command)
            return
        self.send(src, self._execute_read(request.command))

    def _handle_sequential_read_request(self, src: Address,
                                        request: SequentialReadRequest
                                        ) -> None:
        # Sequential consistency: wait until we've executed past the
        # client's last seen slot (Client.scala:697+).
        self._handle_read_request(src, ReadRequest(slot=request.slot,
                                                   command=request.command))

    def _handle_eventual_read_request(self, src: Address,
                                      request: EventualReadRequest) -> None:
        if not self._admit_read(request.command):
            return
        self.send(src, self._execute_read(request.command))

    def _handle_eventual_read_batch(self, batch) -> None:
        """Batched eventual reads execute immediately (no defer), but
        still pass read admission: each refused command's client gets
        a Rejected, like the single-message path. Sync once per batch
        so the limit binds within it, then settle back to the
        deferred-read backlog."""
        admission = self.admission
        if admission is None:
            commands = batch.commands
        else:
            admission.set_inflight(self._deferred_read_count)
            commands = [c for c in batch.commands
                        if self._admit_read(c, sync=False)]
        try:
            if commands:
                self._send_read_replies(
                    [self._execute_read(c) for c in commands])
        finally:
            if admission is not None:
                admission.set_inflight(self._deferred_read_count)

    def _handle_read_request_batch(self, src: Address,
                                   batch: ReadRequestBatch) -> None:
        """Batched deferrable reads (Replica.scala:478-530
        handleDeferrableReads)."""
        admission = self.admission
        if admission is None:
            # Admission-off fast path: no per-command filter call (the
            # disabled-path budget is one attribute load + is-None per
            # frame, see runtime/actor.py).
            commands = batch.commands
        else:
            admission.set_inflight(self._deferred_read_count)
            commands = [c for c in batch.commands
                        if self._admit_read(c, sync=False)]
        try:
            if not commands:
                return
            if batch.slot >= self.executed_watermark:
                for command in commands:
                    self._defer_read(batch.slot, command)
                return
            self._send_read_replies(
                [self._execute_read(c) for c in commands])
        finally:
            # Settle to the true backlog: deferred reads are in
            # _deferred_read_count; immediately-executed ones release.
            if admission is not None:
                admission.set_inflight(self._deferred_read_count)
