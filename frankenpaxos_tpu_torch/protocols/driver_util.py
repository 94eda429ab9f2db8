"""Shared scheduling helper for driver-based chaos workloads (the port's
copy of ``frankenpaxos_tpu/protocols/driver_util.py``;
jvm/.../horizontal/Driver.scala:98-129 and
jvm/.../matchmakermultipaxos/Driver.scala:127-160 use the same
delayedTimer shape)."""

from __future__ import annotations

from typing import Callable, Optional


def delayed_repeating(actor, name: str, delay_s: float, period_s: float,
                      n: int, fire: Callable[[], None],
                      on_last: Optional[Callable[[], None]] = None) -> list:
    """After ``delay_s``, fire ``n`` times at ``period_s`` intervals:
    ``fire`` for the first ``n - 1`` firings, then ``on_last`` (or
    ``fire``) for the final one. Returns the created timers."""
    remaining = {"n": n}

    def tick():
        if remaining["n"] > 1:
            remaining["n"] -= 1
            fire()
            repeat.start()
        elif remaining["n"] == 1:
            remaining["n"] = 0
            (on_last or fire)()

    repeat = actor.timer(f"{name}Repeat", period_s, tick)
    delay = actor.timer(f"{name}Delay", delay_s, repeat.start)
    delay.start()
    return [delay, repeat]


def repeating(actor, name: str, delay_s: float, period_s: float,
              fire: Callable[[], None]) -> list:
    """After ``delay_s``, fire every ``period_s`` forever. Returns the
    created timers."""
    def tick():
        fire()
        repeat.start()

    repeat = actor.timer(f"{name}Repeat", period_s, tick)
    delay = actor.timer(f"{name}Delay", delay_s, repeat.start)
    delay.start()
    return [delay, repeat]
