"""EPaxos Client.

Reference behavior: epaxos/Client.scala: per-pseudonym increasing command
ids; each command goes to a (rotating) replica with a resend timer; any
replica may answer (the column owner replies, or a resend lands at
another replica that answers from its client table).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from frankenpaxos_tpu_torch.protocols.epaxos.messages import (
    ClientReply,
    ClientRequest,
    Command,
)
from frankenpaxos_tpu_torch.protocols.epaxos.replica import EPaxosConfig
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass
class _Pending:
    id: int
    command: bytes
    callback: Callable[[bytes], None]
    resend_timer: object


class EPaxosClient(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: EPaxosConfig,
                 resend_period_s: float = 10.0, seed: int = 0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.rng = random.Random(seed)
        self.resend_period_s = resend_period_s
        self.ids: dict[int, int] = {}
        self.pending: dict[int, _Pending] = {}

    def propose(self, pseudonym: int, command: bytes,
                callback: Optional[Callable[[bytes], None]] = None) -> None:
        if pseudonym in self.pending:
            raise RuntimeError(
                f"pseudonym {pseudonym} already has a pending command")
        id = self.ids.get(pseudonym, 0)
        request = ClientRequest(Command(self.address, pseudonym, id, command))
        replica = self.config.replica_addresses[
            self.rng.randrange(len(self.config.replica_addresses))]
        self.send(replica, request)

        def resend():
            # Resend to a (possibly different) replica.
            target = self.config.replica_addresses[
                self.rng.randrange(len(self.config.replica_addresses))]
            self.send(target, request)
            timer.start()

        timer = self.timer(f"resend-{pseudonym}", self.resend_period_s,
                           resend)
        timer.start()
        self.pending[pseudonym] = _Pending(id, command,
                                           callback or (lambda _: None),
                                           timer)
        self.ids[pseudonym] = id + 1

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, ClientReply):
            self.logger.fatal(f"unexpected client message {message!r}")
        pending = self.pending.get(message.client_pseudonym)
        if pending is None or pending.id != message.client_id:
            self.logger.debug(f"stale reply {message}")
            return
        pending.resend_timer.stop()
        del self.pending[message.client_pseudonym]
        pending.callback(message.result)
