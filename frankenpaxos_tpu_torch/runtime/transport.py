"""Transport and Timer contracts of the port (its copy of
``frankenpaxos_tpu/runtime/transport.py``).

Reference behavior: Transport.scala:44-99 (associated Address/Timer types;
register/send/sendNoFlush/flush/timer) and Timer.scala:23-42
(name/start/stop/reset; names are non-unique, purely for debugging).

THE CONTRACT (Transport.scala:37-40): a transport is a single-threaded
event loop. ``Actor.receive`` and timer callbacks run serially on one
logical thread; protocol code never needs locks and stays deterministic.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Hashable, TYPE_CHECKING

if TYPE_CHECKING:
    from frankenpaxos_tpu_torch.runtime.actor import Actor

# Addresses are opaque hashable values; each transport documents its
# concrete address type (host:port tuples for TCP, strings for sim).
Address = Hashable


class Timer(abc.ABC):
    """A restartable one-shot timer owned by an actor's event loop."""

    @property
    @abc.abstractmethod
    def name(self) -> str:
        ...

    @abc.abstractmethod
    def start(self) -> None:
        ...

    @abc.abstractmethod
    def stop(self) -> None:
        ...

    def reset(self) -> None:
        self.stop()
        self.start()

    def set_delay(self, delay_s: float) -> None:
        """Update the delay used by the NEXT start(); a running
        countdown is unaffected. Transports whose timers support
        retuning override this -- it is how RTT-adaptive timeouts
        (geo.RttEstimator: heartbeat fail periods, election no-ping
        deadlines) retune without reconstructing timers."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support set_delay")


class Transport(abc.ABC):
    """Asynchronous, unordered, at-most-once message delivery between
    registered actors, plus timers -- all on one event loop."""

    # True for transports that run a real event-loop thread
    # (TcpTransport): actors may then offload blocking work to worker
    # threads. SimTransport runs inline on the caller's thread, so
    # everything must stay synchronous.
    threaded: bool = False

    # paxtrace (obs/): an attached obs.Tracer makes the transport emit
    # receive/timer/drain spans and propagate trace contexts at the
    # frame layer; an attached obs.RuntimeMetrics feeds the
    # drain-granular runtime metrics (stage histograms, queue depth).
    # None (the default) keeps every hook to one attribute load + an
    # ``is None`` test.
    tracer = None
    runtime_metrics = None

    @abc.abstractmethod
    def register(self, address: Address, actor: "Actor") -> None:
        """Register ``actor`` to receive messages addressed to ``address``.
        At most one actor per address (Transport.scala:58-63)."""

    @abc.abstractmethod
    def send(self, src: Address, dst: Address, data: bytes) -> None:
        ...

    @abc.abstractmethod
    def send_no_flush(self, src: Address, dst: Address, data: bytes) -> None:
        """Queue without flushing; enables write batching
        (NettyTcpTransport.scala:455-495)."""

    @abc.abstractmethod
    def flush(self, src: Address, dst: Address) -> None:
        ...

    def send_batch(self, src: Address, dst: Address, datas) -> None:
        """Queue a drain's already-encoded messages to one destination
        and flush ONCE; the default is the portable send_no_flush/flush
        spelling, so the simulated transports need no batching
        support."""
        for data in datas:
            self.send_no_flush(src, dst, data)
        self.flush(src, dst)

    @abc.abstractmethod
    def timer(self, address: Address, name: str, delay_s: float,
              f: Callable[[], None]) -> Timer:
        """Create a stopped timer on ``address``'s event loop firing ``f``
        after ``delay_s`` once started."""

    def stage(self) -> Any:
        """Optional hook: transports that batch device work override this."""
        return None

    def note_admission(self, address: Address, actor: "Actor") -> None:
        """paxload (serve/): a role that attaches an
        ``AdmissionController`` AFTER construction-time registration
        calls this so the transport can arm per-destination state (the
        sim's bounded inbox). Default: nothing -- TcpTransport reads
        ``actor.admission`` at delivery time."""
