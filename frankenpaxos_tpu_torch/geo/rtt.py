"""RttEstimator: EWMA + mean-deviation timeout bounds
(the port's copy of ``frankenpaxos_tpu/geo/rtt.py``).

The Jacobson/Karels retransmission estimator (SIGCOMM '88, the TCP
RTO): a smoothed RTT plus a smoothed mean deviation, with the timeout
at ``srtt + k * dev``. Fixed protocol timeouts false-positive the
moment links have real latency and jitter (a 5s heartbeat deadline is
fine on localhost and fatal across a degraded WAN link with 10s
brownouts); every geo-aware timer -- heartbeat fail periods, election
no-ping timeouts, client resends -- derives its delay from one of
these instead (docs/GEO.md).
"""

from __future__ import annotations


class RttEstimator:
    def __init__(self, alpha: float = 0.125, beta: float = 0.25,
                 k: float = 4.0, floor_s: float = 1e-4,
                 ceil_s: float = 120.0):
        if not 0 < alpha <= 1 or not 0 < beta <= 1:
            raise ValueError(f"gains outside (0, 1]: {alpha}, {beta}")
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.floor_s = floor_s
        self.ceil_s = ceil_s
        self.srtt: float | None = None
        self.dev: float = 0.0
        self.samples = 0

    def observe(self, rtt_s: float) -> None:
        rtt_s = max(0.0, rtt_s)
        if self.srtt is None:
            # First sample: the classic initialization (dev = rtt/2
            # keeps the first timeout conservative).
            self.srtt = rtt_s
            self.dev = rtt_s / 2
        else:
            err = rtt_s - self.srtt
            self.srtt += self.alpha * err
            self.dev += self.beta * (abs(err) - self.dev)
        self.samples += 1

    def timeout(self, default_s: float) -> float:
        """The adaptive deadline, or ``default_s`` before any sample
        has arrived. Clamped to ``[floor_s, ceil_s]`` so a zero-RTT
        sim link cannot spin a timer and a wedged link cannot push
        the deadline out forever."""
        if self.srtt is None:
            return default_s
        return min(self.ceil_s,
                   max(self.floor_s, self.srtt + self.k * self.dev))
