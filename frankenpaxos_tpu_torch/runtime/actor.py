"""Actor and Chan.

The port's copy of ``frankenpaxos_tpu/runtime/actor.py``. Reference
behavior: Actor.scala:7-51 (address/transport/logger; declares
InboundMessage + serializer + receive; registers itself at construction;
chan/send/sendNoFlush/flush helpers; timer factory) and Chan.scala:3-17
(typed channel serializing the *destination's* inbound type).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Generic, TypeVar

from frankenpaxos_tpu_torch.obs.trace import stage_scope
from frankenpaxos_tpu_torch.runtime.logger import Logger
from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER, Serializer
from frankenpaxos_tpu_torch.runtime.transport import Address, Timer, Transport

M = TypeVar("M")


class Chan(Generic[M]):
    """A typed channel from a source actor to a destination address
    (Chan.scala:3-17)."""

    def __init__(self, transport: Transport, src: Address, dst: Address,
                 serializer: Serializer[M]):
        self.transport = transport
        self.src = src
        self.dst = dst
        self.serializer = serializer

    def send(self, message: M) -> None:
        self.transport.send(self.src, self.dst,
                            self.serializer.to_bytes(message))

    def send_no_flush(self, message: M) -> None:
        self.transport.send_no_flush(self.src, self.dst,
                                     self.serializer.to_bytes(message))

    def flush(self) -> None:
        self.transport.flush(self.src, self.dst)



class Actor(abc.ABC):
    """A single-threaded protocol role.

    Subclasses set ``serializer`` (for their own inbound messages) and
    implement ``receive``. Like the reference (Actor.scala:19-20), an
    actor registers with its transport at construction.
    """

    # The hybrid default encodes registered hot message types with
    # their fixed-layout binary codecs and pickles the long tail; a
    # subclass can still pin its own serializer.
    serializer: Serializer = DEFAULT_SERIALIZER

    # paxload (serve/): an attached serve.AdmissionController makes the
    # transports enforce this actor's bounded client-lane inbox and
    # CoDel drain-delay shedding, and lets the role's own handlers
    # admit/reject client commands. None (the default) keeps every
    # hook to one attribute load + an ``is None`` test.
    admission = None

    # paxingest (ingest/): the zero-object wire-sink fast path. None
    # (the default) keeps delivery untouched. An opted-in actor sets a
    # ``{leading wire tag: (parser, handler)}`` mapping: when a frame's
    # payload leads with a mapped tag, TcpTransport calls
    # ``parser(payload)`` under its corrupt-frame guard (ValueError =
    # torn/corrupt, log-and-drop; None = unsupported shape, fall back
    # to ordinary per-message decode+deliver) and, on success, hands
    # the parsed descriptor to ``handler(src, parsed)`` with normal
    # handler semantics -- no per-message objects in between. The
    # parsed object must expose ``count`` (messages represented) for
    # drain bookkeeping. Sinks would be bypassed under a tracer (not
    # ported yet, ROADMAP.md queue 1 item 8.5) -- and role-level
    # admission is the SINK's job: the transport's client-lane inbox
    # shed does not see sink frames.
    wire_sinks = None

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger):
        self.address = address
        self.transport = transport
        self.logger = logger
        transport.register(address, self)

    @abc.abstractmethod
    def receive(self, src: Address, message: Any) -> None:
        ...

    def receive_batch(self, batch: list) -> None:
        """paxsim: a consecutive same-destination run of one delivery
        wave, as raw ``(src, frame_bytes)`` pairs in arrival order.
        This default decodes and feeds ``receive`` one frame at a time
        -- bit-identical to per-message delivery, which is why the sim
        wave engine may group through it. SoA-native actors (bench
        sinks, loadgen-style drivers) override it to consume the run
        as arrays with no per-message Python; the engine only routes
        through an OVERRIDE (sim_transport._run_wave), so this body is
        the contract, not a hot path. Overrides MUST process frames in
        order for the determinism contract to hold."""
        serializer = self.serializer
        receive = self.receive
        for src, data in batch:
            receive(src, serializer.from_bytes(data))

    def on_drain(self) -> None:
        """Called by the transport after it finishes delivering a batch of
        inbound messages. Actors that stage work for batched device kernels
        (e.g. ProxyLeader vote collection onto the TpuQuorumChecker) flush
        it here -- the host-side analog of "one jitted step per event-loop
        drain" (SURVEY.md section 7)."""

    # --- helpers (Actor.scala:26-50) --------------------------------------
    def chan(self, dst: Address,
             serializer: Serializer | None = None) -> Chan:
        return Chan(self.transport, self.address, dst,
                    serializer or DEFAULT_SERIALIZER)

    def send(self, dst: Address, message: Any,
             serializer: Serializer | None = None) -> None:
        self.chan(dst, serializer).send(message)

    def send_no_flush(self, dst: Address, message: Any,
                      serializer: Serializer | None = None) -> None:
        self.chan(dst, serializer).send_no_flush(message)

    def broadcast(self, dsts, message: Any,
                  serializer: Serializer | None = None) -> None:
        """Send one message to many destinations, serializing it ONCE.
        The per-destination Chan.send path re-encodes identical bytes N
        times -- measurable when the message carries a whole drain's
        values (Phase2aRun to a write quorum, ChosenRun to every
        replica)."""
        data = (serializer or DEFAULT_SERIALIZER).to_bytes(message)
        for dst in dsts:
            self.transport.send(self.address, dst, data)

    def send_batch(self, dst: Address, messages,
                   serializer: Serializer | None = None) -> None:
        """A drain's messages for ONE destination as one transport
        batch: encoded per message, flushed once."""
        ser = serializer or DEFAULT_SERIALIZER
        self.transport.send_batch(
            self.address, dst, [ser.to_bytes(m) for m in messages])

    def flush(self, dst: Address) -> None:
        self.transport.flush(self.address, dst)

    def trace_stage(self, name: str):
        """A drain-stage scope (obs/trace.py): times ``name`` into the
        transport's runtime drain-stage histogram when one is attached;
        a shared no-op otherwise."""
        transport = self.transport
        return stage_scope(transport.tracer, transport.runtime_metrics,
                           name)

    def timer(self, name: str, delay_s: float,
              f: Callable[[], None]) -> Timer:
        return self.transport.timer(self.address, name, delay_s, f)
