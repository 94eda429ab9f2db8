"""MultiPaxos ReadBatcher.

Reference behavior: multipaxos/ReadBatcher.scala:28-640. Batches client
reads to amortize the quorum MaxSlot round:

  * ``size,N,timeout``: flush at N reads, or at the timeout;
  * ``time,timeout``: flush on a period;
  * ``adaptive``: (linearizable only) a new batch starts as soon as the
    previous batch's max-slot quorum resolves -- batch size adapts to
    quorum latency.

Linearizable flushes send one BatchMaxSlotRequest (tagged with a batch
id) to f+1 of a random acceptor group; on an f+1 quorum of replies the
whole batch reads at ``max_slot + num_groups - 1`` at a random replica.
Sequential/eventual batches go straight to a replica.
"""

from __future__ import annotations

import dataclasses
import random

from frankenpaxos_tpu_torch.protocols.multipaxos.config import MultiPaxosConfig
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    BatchMaxSlotReply,
    BatchMaxSlotRequest,
    Command,
    EventualReadRequest,
    EventualReadRequestBatch,
    ReadRequest,
    ReadRequestBatch,
    SequentialReadRequest,
    SequentialReadRequestBatch,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class ReadBatchingScheme:
    """kind in {"size", "time", "adaptive"} (ReadBatcher.scala:28-66)."""

    kind: str = "size"
    batch_size: int = 10
    timeout_s: float = 1.0


class ReadBatcher(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MultiPaxosConfig,
                 scheme: ReadBatchingScheme = ReadBatchingScheme(),
                 seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        if scheme.kind not in ("size", "time", "adaptive"):
            raise ValueError(f"unknown read batching scheme {scheme.kind}")
        self.config = config
        self.scheme = scheme
        self.rng = random.Random(seed)
        self.index = list(config.read_batcher_addresses).index(address)
        self._row_size = len(config.acceptor_addresses[0])
        self.grid = config.quorum_grid() if config.flexible else None

        self.linearizable_id = 0
        self.linearizable_batch: list[Command] = []
        self.pending_linearizable: dict[int, list[Command]] = {}
        self.batch_max_slot_replies: dict[int, dict[int, int]] = {}
        # Adaptive: is a max-slot quorum in flight?
        self._adaptive_inflight = False

        self.sequential_slot = -1
        self.sequential_batch: list[Command] = []
        self.eventual_batch: list[Command] = []

        if scheme.kind in ("size", "time"):
            self.linearizable_timer = self.timer(
                "linearizableTimer", scheme.timeout_s,
                self._flush_linearizable_timer)
            self.linearizable_timer.start()
            self.sequential_timer = self.timer(
                "sequentialTimer", scheme.timeout_s,
                self._flush_sequential_timer)
            self.sequential_timer.start()
            self.eventual_timer = self.timer(
                "eventualTimer", scheme.timeout_s,
                self._flush_eventual_timer)
            self.eventual_timer.start()
        else:
            self.linearizable_timer = None
            self.sequential_timer = None
            self.eventual_timer = None

    # --- flushing ---------------------------------------------------------
    def _flush_linearizable(self) -> None:
        if not self.linearizable_batch:
            return
        request = BatchMaxSlotRequest(read_batcher_index=self.index,
                                      read_batcher_id=self.linearizable_id)
        if not self.config.flexible:
            group = list(self.config.acceptor_addresses[
                self.rng.randrange(self.config.num_acceptor_groups)])
            quorum = self.rng.sample(group, self.config.f + 1)
        else:
            quorum = [
                self.config.acceptor_addresses[flat // self._row_size]
                [flat % self._row_size]
                for flat in self.grid.random_read_quorum(self.rng)]
        for acceptor in quorum:
            self.send(acceptor, request)
        self.batch_max_slot_replies[self.linearizable_id] = {}
        self.pending_linearizable[self.linearizable_id] = \
            self.linearizable_batch
        self.linearizable_id += 1
        self.linearizable_batch = []
        self._adaptive_inflight = True

    def _flush_linearizable_timer(self) -> None:
        self._flush_linearizable()
        self.linearizable_timer.start()

    def _flush_sequential(self) -> None:
        if not self.sequential_batch:
            return
        self.send(self._random_replica(), SequentialReadRequestBatch(
            slot=self.sequential_slot,
            commands=tuple(self.sequential_batch)))
        self.sequential_slot = -1
        self.sequential_batch = []

    def _flush_sequential_timer(self) -> None:
        self._flush_sequential()
        self.sequential_timer.start()

    def _flush_eventual(self) -> None:
        if not self.eventual_batch:
            return
        self.send(self._random_replica(), EventualReadRequestBatch(
            commands=tuple(self.eventual_batch)))
        self.eventual_batch = []

    def _flush_eventual_timer(self) -> None:
        self._flush_eventual()
        self.eventual_timer.start()

    def _random_replica(self) -> Address:
        return self.config.replica_addresses[
            self.rng.randrange(self.config.num_replicas)]

    # --- handlers ---------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, ReadRequest):
            self._handle_read_request(src, message)
        elif isinstance(message, SequentialReadRequest):
            self._handle_sequential(src, message)
        elif isinstance(message, EventualReadRequest):
            self._handle_eventual(src, message)
        elif isinstance(message, BatchMaxSlotReply):
            self._handle_batch_max_slot_reply(src, message)
        else:
            self.logger.fatal(f"unexpected read batcher message {message!r}")

    def _handle_read_request(self, src: Address,
                             request: ReadRequest) -> None:
        self.linearizable_batch.append(request.command)
        if self.scheme.kind == "size":
            if len(self.linearizable_batch) >= self.scheme.batch_size:
                self._flush_linearizable()
                self.linearizable_timer.reset()
        elif self.scheme.kind == "adaptive":
            if not self._adaptive_inflight:
                self._flush_linearizable()

    def _handle_sequential(self, src: Address,
                           request: SequentialReadRequest) -> None:
        if self.scheme.kind == "adaptive":
            self.logger.fatal(
                "adaptive batching cannot serve sequential reads")
        self.sequential_slot = max(self.sequential_slot, request.slot)
        self.sequential_batch.append(request.command)
        if self.scheme.kind == "size" \
                and len(self.sequential_batch) >= self.scheme.batch_size:
            self._flush_sequential()
            self.sequential_timer.reset()

    def _handle_eventual(self, src: Address,
                         request: EventualReadRequest) -> None:
        if self.scheme.kind == "adaptive":
            self.logger.fatal(
                "adaptive batching cannot serve eventual reads")
        self.eventual_batch.append(request.command)
        if self.scheme.kind == "size" \
                and len(self.eventual_batch) >= self.scheme.batch_size:
            self._flush_eventual()
            self.eventual_timer.reset()

    def _handle_batch_max_slot_reply(self, src: Address,
                                     reply: BatchMaxSlotReply) -> None:
        replies = self.batch_max_slot_replies.get(reply.read_batcher_id)
        if replies is None:
            return
        replies[(reply.group_index, reply.acceptor_index)] = reply.slot
        if not self.config.flexible:
            if len(replies) < self.config.f + 1:
                return
        else:
            flat = {g * self._row_size + i for g, i in replies}
            if not self.grid.is_superset_of_read_quorum(flat):
                return
        max_slot = max(replies.values())
        if self.config.flexible:
            slot = max_slot
        else:
            slot = max_slot + self.config.num_acceptor_groups - 1
        batch = self.pending_linearizable.pop(reply.read_batcher_id)
        del self.batch_max_slot_replies[reply.read_batcher_id]
        self.send(self._random_replica(),
                  ReadRequestBatch(slot=slot, commands=tuple(batch)))
        self._adaptive_inflight = False
        # Adaptive: immediately launch the next batch if reads queued up.
        if self.scheme.kind == "adaptive" and self.linearizable_batch:
            self._flush_linearizable()
