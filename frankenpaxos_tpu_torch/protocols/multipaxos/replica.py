"""MultiPaxos Replica (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/replica.py``).

Reference behavior: multipaxos/Replica.scala:151-691. A BufferMap log
(Replica.scala:194), in-order ``execute_log`` advancing the executed
watermark (Replica.scala:394-453), a simple client table (in-order
execution per client), chosen-watermark gossip every N entries with
responsibility round-robin'd across replicas (Replica.scala:421-447), a
randomized hole-recovery timer (Replica.scala:238-260), and deferred
reads parked until their slot executes (Replica.scala:203-211,455-530).

Not ported yet, and refused: the WAL (``wal=``; ROADMAP.md queue 1 item
4), read admission (the ``admission_*`` options; item 8.1) and the
batched reads of read batchers (item 8.3).
"""

from __future__ import annotations

import dataclasses
import random
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
from frankenpaxos_tpu_torch.runs.records import log_chosen_values
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.statemachine import StateMachine
from frankenpaxos_tpu_torch.utils import BufferMap


@dataclasses.dataclass(frozen=True)
class ReplicaOptions:
    log_grow_size: int = 5000
    unsafe_dont_use_client_table: bool = False
    send_chosen_watermark_every_n_entries: int = 100
    recover_log_entry_min_period_s: float = 10.0
    recover_log_entry_max_period_s: float = 20.0
    unsafe_dont_recover: bool = False
    measure_latencies: bool = True
    # Read admission: not ported yet; anything but the all-zero default
    # is refused.
    admission_token_rate: float = 0.0
    admission_token_burst: float = 0.0
    admission_inflight_limit: int = 0
    admission_inbox_capacity: int = 0
    admission_inbox_policy: str = "reject"
    admission_codel_target_s: float = 0.0
    admission_codel_interval_s: float = 0.1
    admission_retry_after_ms: int = 0


class Replica(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, state_machine: StateMachine,
                 config: MultiPaxosConfig,
                 options: ReplicaOptions = ReplicaOptions(),
                 collectors: Collectors | None = None, seed: int = 0,
                 wal=None):
        if wal is not None:
            raise NotImplementedError(
                "the WAL is not ported yet (ROADMAP.md queue 1 item 4: "
                "WAL)")
        if any((options.admission_token_rate, options.admission_token_burst,
                options.admission_inflight_limit,
                options.admission_inbox_capacity,
                options.admission_codel_target_s,
                options.admission_retry_after_ms)):
            raise NotImplementedError(
                "read admission is not ported yet (ROADMAP.md queue 1 "
                "item 8.1: admission)")
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
        self._wm_dirty = False  # executed advanced since last drain
        self.recover_timer = None
        if not options.unsafe_dont_recover:
            self.recover_timer = self.timer(
                "recover",
                self.rng.uniform(options.recover_log_entry_min_period_s,
                                 options.recover_log_entry_max_period_s),
                self._recover)

    def _log_chosen(self, start_slot: int, values) -> int:
        """Put a contiguous run of chosen values into the log
        (runs/records.py); returns how many were new."""
        new, _ = log_chosen_values(self.log, self.executed_watermark,
                                   start_slot, 1, values)
        self.num_chosen += new
        return new

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

    def _send_chosen_watermark(self) -> None:
        watermark = ChosenWatermark(slot=self.executed_watermark)
        proxy = self._proxy_replica_address()
        if proxy is not None:
            self.send(proxy, watermark)
        else:
            for leader in self.config.leader_addresses:
                self.send(leader, watermark)

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
        self._send_read_replies([self._execute_read(c) for c in reads])

    def _defer_read(self, slot: int, command: Command) -> None:
        reads = self.deferred_reads.get(slot)
        if reads is None:
            self.deferred_reads.put(slot, [command])
        else:
            reads.append(command)

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
        elif isinstance(message, (ReadRequestBatch,
                                  SequentialReadRequestBatch,
                                  EventualReadRequestBatch)):
            raise NotImplementedError(
                f"{type(message).__name__}: read batchers are not ported "
                f"yet (ROADMAP.md queue 1 item 8.3: read batchers)")
        else:
            self.logger.fatal(f"unexpected replica message {message!r}")

    def _handle_chosen(self, src: Address, chosen: Chosen) -> None:
        """(Replica.scala:572-628)."""
        if self._log_chosen(chosen.slot, (chosen.value,)) == 0:
            return  # duplicate Chosen
        replies = self._execute_log()
        if replies:
            proxy = self._proxy_replica_address()
            if proxy is not None:
                self.send(proxy, ClientReplyBatch(batch=tuple(replies)))
            else:
                for reply in replies:
                    self.send(reply.command_id.client_address, reply)
        self._restart_recover_timer()

    def _handle_chosen_run(self, src: Address, run: ChosenRun) -> None:
        """A contiguous drain of chosen values in one message: log the
        whole run, execute once, and ship each client ONE reply array
        for the drain instead of one ClientReply per command."""
        if self._log_chosen(run.start_slot, run.values) == 0:
            return
        replies = self._execute_log()
        if replies:
            proxy = self._proxy_replica_address()
            if proxy is not None:
                self.send(proxy, ClientReplyBatch(batch=tuple(replies)))
            else:
                by_client: dict = {}
                for r in replies:
                    cid = r.command_id
                    by_client.setdefault(cid.client_address, []).append(
                        (cid.client_pseudonym, cid.client_id, r.slot,
                         r.result))
                for address, entries in by_client.items():
                    self.send(address,
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
        self.send(src, self._execute_read(request.command))
