"""MultiPaxos ProxyReplica: fans client replies out, off the replica's
critical path.

The port's copy of ``frankenpaxos_tpu/protocols/multipaxos/proxy_replica.py``.

Reference behavior: multipaxos/ProxyReplica.scala:69-218 -- unbatch
ClientReplyBatch / ReadReplyBatch to clients (with flush-every-N
coalescing) and forward ChosenWatermark / Recover on to all leaders.
"""

from __future__ import annotations

import dataclasses

from frankenpaxos_tpu_torch.protocols.multipaxos.config import MultiPaxosConfig
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    ChosenWatermark,
    ClientReplyBatch,
    ReadReplyBatch,
    Recover,
)
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class ProxyReplicaOptions:
    flush_every_n: int = 1
    measure_latencies: bool = True


class ProxyReplica(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MultiPaxosConfig,
                 options: ProxyReplicaOptions = ProxyReplicaOptions(),
                 collectors: Collectors | None = None):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        collectors = collectors or FakeCollectors()
        self.metrics_latency = collectors.summary(
            "multipaxos_proxy_replica_requests_latency_seconds", labels=("type",))
        self.metrics_requests = collectors.counter(
            "multipaxos_proxy_replica_requests_total", labels=("type",))
        self._unflushed = 0
        self._unflushed_clients: set[Address] = set()

    def _send_coalesced(self, dst: Address, message) -> None:
        if self.options.flush_every_n <= 1:
            self.send(dst, message)
            return
        self.send_no_flush(dst, message)
        self._unflushed_clients.add(dst)
        self._unflushed += 1
        if self._unflushed >= self.options.flush_every_n:
            for client in self._unflushed_clients:
                self.flush(client)
            self._unflushed_clients.clear()
            self._unflushed = 0

    def receive(self, src: Address, message) -> None:
        # timed(label) handler latency summaries (Leader.scala:281-293).
        if self.options.measure_latencies:
            with self.metrics_latency.labels(
                    type(message).__name__).time():
                self._receive_impl(src, message)
        else:
            self._receive_impl(src, message)

    def _receive_impl(self, src: Address, message) -> None:
        if isinstance(message, ClientReplyBatch):
            self.metrics_requests.labels("ClientReplyBatch").inc()
            for reply in message.batch:
                self._send_coalesced(reply.command_id.client_address, reply)
        elif isinstance(message, ReadReplyBatch):
            self.metrics_requests.labels("ReadReplyBatch").inc()
            for reply in message.batch:
                self._send_coalesced(reply.command_id.client_address, reply)
        elif isinstance(message, (ChosenWatermark, Recover)):
            label = type(message).__name__
            self.metrics_requests.labels(label).inc()
            for leader in self.config.leader_addresses:
                self.send(leader, message)
        else:
            self.logger.fatal(f"unexpected proxy replica message {message!r}")
