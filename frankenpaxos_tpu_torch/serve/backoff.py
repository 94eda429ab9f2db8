"""Client-side retry discipline (paxload): jittered exponential
backoff with retry budgets.

The contract (docs/SERVING.md):

  * ``Rejected`` means the leader is ALIVE but saturated -> back off
    (jittered exponential, honoring the server's ``retry_after_ms``
    hint as a floor) and retry the SAME leader. Re-sending immediately
    would feed the congestion the server just shed.
  * Timeout means the leader may be GONE -> the existing
    resend/failover path (re-send, leader discovery on NotLeader) at
    the configured resend period.
  * Both consume the per-operation RETRY BUDGET when one is set; an
    exhausted budget completes the operation with the
    :data:`RETRY_EXHAUSTED` sentinel instead of retrying forever --
    every request ends in an ack, an explicit rejection give-up, or a
    bounded-retry exhaustion, never a silent wedge.

A budget of 0 (the default) preserves the pre-paxload behavior:
unlimited resends, no backoff -- sims and benches that predate the
serving tier are untouched.
"""

from __future__ import annotations

import dataclasses
import random


class _RetryExhausted:
    """Sentinel delivered to a write/read callback when the retry
    budget runs out (compare by identity: ``result is
    RETRY_EXHAUSTED``). Falsy so naive truthiness checks treat it as
    'no result'."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "RETRY_EXHAUSTED"


RETRY_EXHAUSTED = _RetryExhausted()


@dataclasses.dataclass(frozen=True)
class Backoff:
    """Jittered exponential backoff schedule: attempt k (0-based)
    sleeps ``initial * multiplier**k``, capped at ``max_s``, with
    uniform jitter of ±``jitter`` fraction. Full-jitter-style spread
    keeps a synchronized burst of rejected clients from re-arriving as
    a synchronized retry storm."""

    initial_s: float = 0.05
    max_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.5

    def delay_s(self, attempt: int, rng: random.Random,
                floor_s: float = 0.0) -> float:
        base = min(self.max_s, self.initial_s * self.multiplier ** attempt)
        lo = base * (1.0 - self.jitter)
        hi = base * (1.0 + self.jitter)
        return max(floor_s, lo + (hi - lo) * rng.random())
