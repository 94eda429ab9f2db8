"""Thrifty node selection (the port's copy of ``frankenpaxos_tpu/thrifty.py``):
message only ``min`` nodes when only ``min`` replies are needed.

Reference behavior: thrifty/ThriftySystem.scala:28-77 -- NotThrifty (all
nodes), Random (a random min-subset), Closest (the min closest by the
heartbeat delay estimate).
"""

from __future__ import annotations

import abc
import random
from typing import Mapping

from frankenpaxos_tpu_torch.runtime.transport import Address


class ThriftySystem(abc.ABC):
    @abc.abstractmethod
    def choose(self, delays: Mapping[Address, float], min_size: int,
               rng: random.Random) -> set[Address]:
        """Pick the subset of ``delays``' keys to actually message."""


class NotThrifty(ThriftySystem):
    def choose(self, delays, min_size, rng) -> set[Address]:
        return set(delays.keys())


class RandomThrifty(ThriftySystem):
    def choose(self, delays, min_size, rng) -> set[Address]:
        return set(rng.sample(sorted(delays.keys(), key=str), min_size))


class ClosestThrifty(ThriftySystem):
    def choose(self, delays, min_size, rng) -> set[Address]:
        ranked = sorted(delays.items(), key=lambda kv: (kv[1], str(kv[0])))
        return {a for a, _ in ranked[:min_size]}


def thrifty_system_by_name(name: str) -> ThriftySystem:
    systems = {
        "NotThrifty": NotThrifty,
        "Random": RandomThrifty,
        "Closest": ClosestThrifty,
    }
    if name not in systems:
        raise ValueError(f"{name} is not one of {', '.join(sorted(systems))}")
    return systems[name]()
