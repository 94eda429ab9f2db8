"""Echo: the hello-world protocol exercising the runtime contract (the
port's copy of ``frankenpaxos_tpu/protocols/echo.py``).

Reference behavior: echo/ (echo/Echo.proto, echo/Server.scala,
echo/Client.scala): a client sends a string, the server echoes it back;
the client counts replies and can ping periodically.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class EchoRequest:
    msg: str


@dataclasses.dataclass(frozen=True)
class EchoReply:
    msg: str


class EchoServer(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger):
        super().__init__(address, transport, logger)
        self.num_messages_received = 0

    def receive(self, src: Address, message: EchoRequest) -> None:
        self.num_messages_received += 1
        self.logger.debug(f"echoing {message.msg!r} to {src}")
        self.send(src, EchoReply(msg=message.msg))


class EchoClient(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, server_address: Address,
                 ping_period_s: float = 1.0):
        super().__init__(address, transport, logger)
        self.server_address = server_address
        self.num_messages_received = 0
        self._callbacks: list[Callable[[str], None]] = []
        self.ping_timer = self.timer("ping", ping_period_s, self._ping)

    def _ping(self) -> None:
        self.send(self.server_address, EchoRequest(msg="ping"))
        self.ping_timer.start()

    def echo(self, msg: str,
             callback: Optional[Callable[[str], None]] = None) -> None:
        if callback is not None:
            self._callbacks.append(callback)
        self.send(self.server_address, EchoRequest(msg=msg))

    def receive(self, src: Address, message: EchoReply) -> None:
        self.num_messages_received += 1
        if self._callbacks:
            self._callbacks.pop(0)(message.msg)


# Importing for side effect: registers this protocol's binary wire
# codecs with the default serializer (see baseline_wire.py).
from frankenpaxos_tpu_torch.protocols import baseline_wire  # noqa: E402,F401
