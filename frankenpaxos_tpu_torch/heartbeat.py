"""Heartbeat failure detector (the port's copy of
``frankenpaxos_tpu/heartbeat.py``).

Reference behavior: heartbeat/Participant.scala:72-209. Every participant
pings the others; a pong resets that peer's retry count, updates an EWMA
estimate of network delay, and schedules the next ping after
``success_period``; a missing pong retries after ``fail_period`` and
after ``num_retries`` consecutive misses the peer is deemed dead. The
``alive`` set and delay estimates feed ThriftySystem.Closest.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class Ping:
    index: int       # index of the *target* in the sender's address list
    nanotime: int


@dataclasses.dataclass(frozen=True)
class Pong:
    index: int
    nanotime: int


@dataclasses.dataclass(frozen=True)
class HeartbeatOptions:
    """Mimics TCP keepalive's interval/time/retry knobs
    (Participant.scala:38-60).

    ``adaptive=True`` derives each peer's fail deadline from OBSERVED
    round-trip times instead of the fixed ``fail_period_s``: a
    Jacobson/Karels estimator (geo.RttEstimator, EWMA + mean
    deviation) per peer, with the deadline at ``srtt + 4 * dev``
    clamped to ``[min_fail_period_s, max_fail_period_s]``. Fixed
    deadlines false-positive the moment links have real latency and
    jitter (a WAN brownout under GeoTopology blows straight through
    any constant chosen for the fast path -- tests/test_geo.py);
    ``fail_period_s`` remains the deadline until the first pong."""

    fail_period_s: float = 5.0
    success_period_s: float = 10.0
    num_retries: int = 3
    network_delay_alpha: float = 0.9
    adaptive: bool = False
    min_fail_period_s: float = 0.01
    max_fail_period_s: float = 120.0
    # Until the first pong there is no RTT sample, so adaptive mode
    # starts CONSERVATIVE (TCP's initial-RTO discipline) instead of
    # trusting a constant that may sit below the real RTT.
    initial_fail_period_s: float = 1.0


class HeartbeatParticipant(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, addresses: Sequence[Address],
                 options: HeartbeatOptions = HeartbeatOptions(),
                 clock: Callable[[], int] = time.monotonic_ns):
        super().__init__(address, transport, logger)
        logger.check_le(0, options.network_delay_alpha)
        logger.check_le(options.network_delay_alpha, 1)
        self.addresses = list(addresses)
        self.options = options
        self.clock = clock
        self.num_retries = [0] * len(self.addresses)
        self.network_delay_nanos: dict[int, float] = {}
        if options.adaptive:
            from frankenpaxos_tpu_torch.geo.rtt import RttEstimator

            self.rtt_estimators = [RttEstimator()
                                   for _ in self.addresses]
        else:
            self.rtt_estimators = None
        self.alive: set[Address] = set(self.addresses)
        initial_fail_s = (max(options.fail_period_s,
                              options.initial_fail_period_s)
                          if options.adaptive else options.fail_period_s)
        self.fail_timers = [
            self.timer(f"fail-{a}", initial_fail_s,
                       lambda i=i: self._fail(i))
            for i, a in enumerate(self.addresses)]
        self.success_timers = [
            self.timer(f"success-{a}", options.success_period_s,
                       lambda i=i: self._succeed(i))
            for i, a in enumerate(self.addresses)]
        for i, a in enumerate(self.addresses):
            self.send(a, Ping(index=i, nanotime=self.clock()))
            self.fail_timers[i].start()

    def receive(self, src: Address, message) -> None:
        if isinstance(message, Ping):
            self.send(src, Pong(index=message.index,
                                nanotime=message.nanotime))
        elif isinstance(message, Pong):
            self._handle_pong(message)
        else:
            self.logger.fatal(f"unexpected heartbeat message {message!r}")

    def _handle_pong(self, pong: Pong) -> None:
        rtt_nanos = self.clock() - pong.nanotime
        delay = rtt_nanos / 2
        alpha = self.options.network_delay_alpha
        old = self.network_delay_nanos.get(pong.index)
        self.network_delay_nanos[pong.index] = (
            delay if old is None else alpha * delay + (1 - alpha) * old)
        if self.rtt_estimators is not None:
            # Jitter-tolerant deadlines (geo.RttEstimator): retune the
            # peer's fail timer to srtt + 4*dev before its next start,
            # so one WAN jitter spike no longer burns a retry.
            estimator = self.rtt_estimators[pong.index]
            estimator.observe(rtt_nanos / 1e9)
            self.fail_timers[pong.index].set_delay(min(
                self.options.max_fail_period_s,
                max(self.options.min_fail_period_s,
                    estimator.timeout(self.options.fail_period_s))))
        self.alive.add(self.addresses[pong.index])
        self.num_retries[pong.index] = 0
        self.fail_timers[pong.index].stop()
        self.success_timers[pong.index].start()

    def _fail(self, index: int) -> None:
        self.num_retries[index] += 1
        if self.num_retries[index] >= self.options.num_retries:
            self.alive.discard(self.addresses[index])
        self.send(self.addresses[index],
                  Ping(index=index, nanotime=self.clock()))
        self.fail_timers[index].start()

    def _succeed(self, index: int) -> None:
        self.send(self.addresses[index],
                  Ping(index=index, nanotime=self.clock()))
        self.fail_timers[index].start()

    # Callable only from the same event loop (Participant.scala:186-208).
    def unsafe_alive(self) -> set[Address]:
        return set(self.alive)

    def unsafe_network_delay(self) -> dict[Address, float]:
        """Seconds of estimated one-way delay; infinity for dead peers."""
        delays = {}
        for i, a in enumerate(self.addresses):
            nanos = self.network_delay_nanos.get(i)
            if nanos is not None and a in self.alive:
                delays[a] = nanos / 1e9
            else:
                delays[a] = float("inf")
        return delays
