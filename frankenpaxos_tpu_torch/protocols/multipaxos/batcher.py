"""MultiPaxos Batcher: accumulate client writes into batches for the
leader.

The port's copy of ``frankenpaxos_tpu/protocols/multipaxos/batcher.py``.

Reference behavior: multipaxos/Batcher.scala:67-190. Client requests
append to a growing batch; at ``batch_size`` the batch goes to the
current round's leader. A NotLeaderBatcher bounce stashes the batch and
asks every leader who leads (LeaderInfoRequestBatcher); the reply updates
the round and flushes stashed batches.
"""

from __future__ import annotations

import dataclasses

from frankenpaxos_tpu_torch.protocols.multipaxos.config import MultiPaxosConfig
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    ClientRequest,
    ClientRequestBatch,
    Command,
    CommandBatch,
    LeaderInfoReplyBatcher,
    LeaderInfoRequestBatcher,
    NotLeaderBatcher,
)
from frankenpaxos_tpu_torch.roundsystem import ClassicRoundRobin
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class BatcherOptions:
    batch_size: int = 100
    # Flush a PARTIAL batch after this long (0 disables). The reference
    # only flushes on batch_size (Batcher.scala:100-135), which assumes
    # offered load >> batch_size; under a closed-loop trickle a partial
    # batch would otherwise strand its commands (and the client loops
    # waiting on them) forever.
    flush_period_s: float = 0.05
    measure_latencies: bool = True


class Batcher(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MultiPaxosConfig,
                 options: BatcherOptions = BatcherOptions(),
                 collectors: Collectors | None = None):
        super().__init__(address, transport, logger)
        config.check_valid()
        logger.check_ge(options.batch_size, 1)
        self.config = config
        self.options = options
        collectors = collectors or FakeCollectors()
        self.metrics_latency = collectors.summary(
            "multipaxos_batcher_requests_latency_seconds", labels=("type",))
        self.metrics_batches = collectors.counter(
            "multipaxos_batcher_batches_sent_total")
        self.round_system = ClassicRoundRobin(config.num_leaders)
        self.round = 0
        self.growing_batch: list[Command] = []
        self.pending_resend_batches: list[ClientRequestBatch] = []
        self._flush_timer = None
        if options.flush_period_s > 0:
            self._flush_timer = self.timer(
                "batchFlush", options.flush_period_s, self._flush_partial)

    def _leader_address(self) -> Address:
        return self.config.leader_addresses[self.round_system.leader(
            self.round)]

    def _flush_partial(self) -> None:
        # One-shot: re-armed by _handle_client_request when the next
        # batch starts growing.
        if self.growing_batch:
            self._send_batch()

    def _send_batch(self) -> None:
        self.send(self._leader_address(), ClientRequestBatch(
            CommandBatch(tuple(self.growing_batch))))
        self.growing_batch.clear()
        self.metrics_batches.inc()

    def receive(self, src: Address, message) -> None:
        # timed(label) handler latency summaries (Leader.scala:281-293).
        if self.options.measure_latencies:
            with self.metrics_latency.labels(
                    type(message).__name__).time():
                self._receive_impl(src, message)
        else:
            self._receive_impl(src, message)

    def _receive_impl(self, src: Address, message) -> None:
        if isinstance(message, ClientRequest):
            self._handle_client_request(src, message)
        elif isinstance(message, NotLeaderBatcher):
            self._handle_not_leader(src, message)
        elif isinstance(message, LeaderInfoReplyBatcher):
            self._handle_leader_info(src, message)
        else:
            self.logger.fatal(f"unexpected batcher message {message!r}")

    def _handle_client_request(self, src: Address,
                               request: ClientRequest) -> None:
        self.growing_batch.append(request.command)
        if len(self.growing_batch) >= self.options.batch_size:
            self._send_batch()
        elif self._flush_timer is not None \
                and len(self.growing_batch) == 1:
            # Arm the partial-batch flush when a batch starts growing.
            self._flush_timer.stop()
            self._flush_timer.start()

    def _handle_not_leader(self, src: Address,
                           bounce: NotLeaderBatcher) -> None:
        self.pending_resend_batches.append(bounce.client_request_batch)
        for leader in self.config.leader_addresses:
            self.send(leader, LeaderInfoRequestBatcher())

    def _handle_leader_info(self, src: Address,
                            reply: LeaderInfoReplyBatcher) -> None:
        if reply.round <= self.round and self.pending_resend_batches:
            # Stale info, but we still owe resends once a new round shows.
            pass
        if reply.round > self.round:
            self.round = reply.round
        for batch in self.pending_resend_batches:
            self.send(self._leader_address(), batch)
        self.pending_resend_batches.clear()
