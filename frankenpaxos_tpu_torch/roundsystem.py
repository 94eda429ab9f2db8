"""Round systems: map rounds to leaders and to {classic, fast}.

Reference behavior: roundsystem/RoundSystem.scala:14-45 (API) and its
implementations at :60 (ClassicRoundRobin), :118 (ClassicStutteredRoundRobin),
:183 (RoundZeroFast), :229 (MixedRoundRobin), :291 (RenamedRoundSystem),
:335 (RotatedRoundSystem), :386 (RotatedClassicRoundRobin /
RotatedRoundZeroFast).

These are tiny pure functions; they run on host. ``leader_of`` /
``round_type_of`` also ship vectorized forms for use inside jitted
pipelines (e.g. Mencius slot striping).
"""

from __future__ import annotations

import abc
import enum
from typing import Optional

import numpy as np


class RoundType(enum.Enum):
    CLASSIC = "classic"
    FAST = "fast"


class RoundSystem(abc.ABC):
    """Assignment of every round to a unique leader and a round type.

    Every leader must own infinitely many classic rounds; fast rounds are
    optional (RoundSystem.scala:14-45).
    """

    @abc.abstractmethod
    def num_leaders(self) -> int:
        ...

    @abc.abstractmethod
    def leader(self, round: int) -> int:
        ...

    @abc.abstractmethod
    def round_type(self, round: int) -> RoundType:
        ...

    @abc.abstractmethod
    def next_classic_round(self, leader_index: int, round: int) -> int:
        """Smallest classic round of ``leader_index`` strictly after ``round``.

        A negative ``round`` asks for the leader's first classic round.
        """

    @abc.abstractmethod
    def next_fast_round(self, leader_index: int, round: int) -> Optional[int]:
        """Smallest fast round of ``leader_index`` strictly after ``round``,
        or None if the leader has no further fast rounds."""

    def leaders_of(self, rounds: np.ndarray) -> np.ndarray:
        """Vectorized ``leader`` (overridden where a closed form exists)."""
        return np.fromiter((self.leader(int(r)) for r in np.asarray(rounds)),
                           dtype=np.int64, count=np.asarray(rounds).size)


class ClassicRoundRobin(RoundSystem):
    """Round r is a classic round led by ``r % n`` (RoundSystem.scala:60-87)."""

    def __init__(self, n: int):
        self.n = n

    def __repr__(self):
        return f"ClassicRoundRobin({self.n})"

    def num_leaders(self) -> int:
        return self.n

    def leader(self, round: int) -> int:
        return round % self.n

    def round_type(self, round: int) -> RoundType:
        return RoundType.CLASSIC

    def next_classic_round(self, leader_index: int, round: int) -> int:
        if round < 0:
            return leader_index
        # First round congruent to leader_index (mod n) strictly above round.
        base = self.n * (round // self.n) + (leader_index % self.n)
        return base if base > round else base + self.n

    def next_fast_round(self, leader_index: int, round: int) -> Optional[int]:
        return None

    def leaders_of(self, rounds: np.ndarray) -> np.ndarray:
        return np.asarray(rounds) % self.n


class ClassicStutteredRoundRobin(RoundSystem):
    """Round-robin in stutters: leader ``(r // stutter) % n``
    (RoundSystem.scala:118-168)."""

    def __init__(self, n: int, stutter_length: int):
        self.n = n
        self.stutter_length = stutter_length

    def __repr__(self):
        return f"ClassicStutteredRoundRobin({self.n}, {self.stutter_length})"

    def num_leaders(self) -> int:
        return self.n

    def leader(self, round: int) -> int:
        return (round // self.stutter_length) % self.n

    def round_type(self, round: int) -> RoundType:
        return RoundType.CLASSIC

    def next_classic_round(self, leader_index: int, round: int) -> int:
        if round < 0:
            return leader_index * self.stutter_length
        if self.leader(round + 1) == leader_index:
            return round + 1
        chunk = self.n * self.stutter_length
        start_of_stutter = (chunk * (round // chunk)
                            + leader_index * self.stutter_length)
        if self.leader(round) < leader_index:
            return start_of_stutter
        return start_of_stutter + chunk

    def next_fast_round(self, leader_index: int, round: int) -> Optional[int]:
        return None

    def leaders_of(self, rounds: np.ndarray) -> np.ndarray:
        return (np.asarray(rounds) // self.stutter_length) % self.n


class RoundZeroFast(RoundSystem):
    """Round 0 is fast (leader 0); rounds 1.. are classic round-robin
    (RoundSystem.scala:183-213)."""

    def __init__(self, n: int):
        self.n = n
        self._rr = ClassicRoundRobin(n)

    def __repr__(self):
        return f"RoundZeroFast({self.n})"

    def num_leaders(self) -> int:
        return self.n

    def leader(self, round: int) -> int:
        return 0 if round == 0 else (round - 1) % self.n

    def round_type(self, round: int) -> RoundType:
        return RoundType.FAST if round == 0 else RoundType.CLASSIC

    def next_classic_round(self, leader_index: int, round: int) -> int:
        return 1 + self._rr.next_classic_round(leader_index, round - 1)

    def next_fast_round(self, leader_index: int, round: int) -> Optional[int]:
        if leader_index == 0 and round < 0:
            return 0
        return None


class MixedRoundRobin(RoundSystem):
    """Contiguous (fast, classic) round pairs per leader, round-robin
    (RoundSystem.scala:229-266)."""

    def __init__(self, n: int):
        self.n = n
        self._rr = ClassicRoundRobin(n)

    def __repr__(self):
        return f"MixedRoundRobin({self.n})"

    def num_leaders(self) -> int:
        return self.n

    def leader(self, round: int) -> int:
        return (round // 2) % self.n

    def round_type(self, round: int) -> RoundType:
        return RoundType.FAST if round % 2 == 0 else RoundType.CLASSIC

    def next_classic_round(self, leader_index: int, round: int) -> int:
        if round >= 0 and round % 2 == 0 and self.leader(round) == leader_index:
            return round + 1
        return self.next_fast_round(leader_index, round) + 1

    def next_fast_round(self, leader_index: int, round: int) -> Optional[int]:
        if round < 0:
            return leader_index * 2
        return self._rr.next_classic_round(leader_index, round // 2) * 2


class RenamedRoundSystem(RoundSystem):
    """Adapt a round system by permuting leader identities
    (RoundSystem.scala:291-333)."""

    def __init__(self, round_system: RoundSystem, renaming: dict[int, int]):
        self.round_system = round_system
        self.renaming = dict(renaming)
        self.unrenaming = {v: k for k, v in renaming.items()}

    def __repr__(self):
        return f"Renamed({self.round_system!r}, {self.renaming})"

    def num_leaders(self) -> int:
        return self.round_system.num_leaders()

    def leader(self, round: int) -> int:
        return self.renaming[self.round_system.leader(round)]

    def round_type(self, round: int) -> RoundType:
        return self.round_system.round_type(round)

    def next_classic_round(self, leader_index: int, round: int) -> int:
        return self.round_system.next_classic_round(
            self.unrenaming[leader_index], round)

    def next_fast_round(self, leader_index: int, round: int) -> Optional[int]:
        return self.round_system.next_fast_round(
            self.unrenaming[leader_index], round)


class RotatedRoundSystem(RenamedRoundSystem):
    """Renaming that rotates leader identities by ``rotation``
    (RoundSystem.scala:335-383)."""

    def __init__(self, round_system: RoundSystem, rotation: int):
        n = round_system.num_leaders()
        super().__init__(round_system, {i: (i + rotation) % n
                                        for i in range(n)})
        self.rotation = rotation


class RotatedClassicRoundRobin(RotatedRoundSystem):
    """ClassicRoundRobin whose round 0 belongs to ``first_leader``
    (RoundSystem.scala:386-414)."""

    def __init__(self, n: int, first_leader: int):
        super().__init__(ClassicRoundRobin(n), first_leader)

    def __repr__(self):
        return (f"RotatedClassicRoundRobin({self.round_system.num_leaders()}, "
                f"{self.rotation})")


class RotatedRoundZeroFast(RotatedRoundSystem):
    """RoundZeroFast whose fast round belongs to ``first_leader``
    (RoundSystem.scala:416-445)."""

    def __init__(self, n: int, first_leader: int):
        super().__init__(RoundZeroFast(n), first_leader)

    def __repr__(self):
        return (f"RotatedRoundZeroFast({self.round_system.num_leaders()}, "
                f"{self.rotation})")
