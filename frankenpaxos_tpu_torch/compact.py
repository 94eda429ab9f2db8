"""Compact add-only sets: watermark + sparse overflow.

Reference behavior: compact/CompactSet.scala:24-80 (the API contract:
add/contains/union/diff/materialized_diff/add_all/subtract_all/
subtract_one/size/uncompacted_size/subset/materialize) and
compact/IntPrefixSet.scala:206+ (the integer implementation: a watermark
``w`` meaning "0..w-1 all present" plus a sparse set of values >= w).

An IntPrefixSet is the host twin of a device (watermark scalar, tail
bitmask) pair: the chosen-slot sets, executed-command id sets, and
EPaxos/BPaxos dependency sets all compact this way.
"""

from __future__ import annotations

import abc
from typing import Generic, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")


class CompactSet(abc.ABC, Generic[T]):
    """Add-only set that best-effort compacts to O(1) space
    (CompactSet.scala:24-80)."""

    @abc.abstractmethod
    def add(self, x: T) -> bool:
        """Add x; returns whether x was already present."""

    @abc.abstractmethod
    def contains(self, x: T) -> bool:
        ...

    @abc.abstractmethod
    def union(self, other) -> "CompactSet[T]":
        ...

    @abc.abstractmethod
    def diff(self, other) -> "CompactSet[T]":
        ...

    @abc.abstractmethod
    def materialized_diff(self, other) -> Iterable[T]:
        ...

    @abc.abstractmethod
    def add_all(self, other) -> "CompactSet[T]":
        ...

    @abc.abstractmethod
    def subtract_all(self, other) -> "CompactSet[T]":
        ...

    @abc.abstractmethod
    def subtract_one(self, x: T) -> "CompactSet[T]":
        ...

    @property
    @abc.abstractmethod
    def size(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def uncompacted_size(self) -> int:
        ...

    @abc.abstractmethod
    def subset(self) -> "CompactSet[T]":
        """A monotone, especially-compact subset of self."""

    @abc.abstractmethod
    def materialize(self) -> set[T]:
        ...


class IntPrefixSet(CompactSet[int]):
    """{0..watermark-1} union values, with values >= watermark sparse.

    Reference: compact/IntPrefixSet.scala:206+ (construction, compaction on
    add, union/diff over (watermark, values) pairs, proto ser/de).
    """

    __slots__ = ("watermark", "values")

    def __init__(self, watermark: int = 0,
                 values: Optional[Iterable[int]] = None):
        self.watermark = watermark
        self.values: set[int] = set(values) if values else set()
        self._compact()

    @classmethod
    def from_watermark(cls, watermark: int) -> "IntPrefixSet":
        return cls(watermark)

    @classmethod
    def from_set(cls, values: Iterable[int]) -> "IntPrefixSet":
        return cls(0, values)

    def __repr__(self):
        return f"IntPrefixSet({self.watermark}, {sorted(self.values)})"

    def __eq__(self, other):
        return (isinstance(other, IntPrefixSet)
                and self.watermark == other.watermark
                and self.values == other.values)

    def __hash__(self):
        return hash((self.watermark, frozenset(self.values)))

    def _absorb(self) -> None:
        # Absorb the contiguous run at the watermark into the watermark.
        # Values strictly below the old watermark cannot appear here
        # (add() refuses them; only construction/bulk ops introduce
        # them, and those run the full _compact), so no filter pass is
        # needed -- a rebuild per add() would make scattered adds
        # quadratic (libbench caught exactly that).
        while self.watermark in self.values:
            self.values.discard(self.watermark)
            self.watermark += 1

    def _compact(self) -> None:
        # Drop values below the watermark, then absorb the run at it.
        self.values = {x for x in self.values if x >= self.watermark}
        self._absorb()

    def add(self, x: int) -> bool:
        if self.contains(x):
            return True
        self.values.add(x)
        self._absorb()
        return False

    def contains(self, x: int) -> bool:
        return x < self.watermark or x in self.values

    def union(self, other: "IntPrefixSet") -> "IntPrefixSet":
        return IntPrefixSet(max(self.watermark, other.watermark),
                            self.values | other.values)

    def diff(self, other: "IntPrefixSet") -> "IntPrefixSet":
        return IntPrefixSet.from_set(set(self.materialized_diff(other)))

    def materialized_diff(self, other: "IntPrefixSet") -> Iterator[int]:
        """Lazily yield elements of self not in other
        (IntPrefixSet.DiffIterator)."""
        for x in range(min(self.watermark, other.watermark), self.watermark):
            if not other.contains(x):
                yield x
        for x in self.values:
            if not other.contains(x):
                yield x

    def add_all(self, other: "IntPrefixSet") -> "IntPrefixSet":
        self.watermark = max(self.watermark, other.watermark)
        self.values |= other.values
        self._compact()
        return self

    def subtract_all(self, other: "IntPrefixSet") -> "IntPrefixSet":
        remaining = set(self.materialized_diff(other))
        self.watermark = 0
        self.values = remaining
        self._compact()
        return self

    def subtract_one(self, x: int) -> "IntPrefixSet":
        # Subtracting below the watermark un-compacts the prefix.
        if x < self.watermark:
            self.values |= set(range(self.watermark))
            self.watermark = 0
        self.values.discard(x)
        self._absorb()
        return self

    @property
    def size(self) -> int:
        return self.watermark + len(self.values)

    @property
    def uncompacted_size(self) -> int:
        return len(self.values)

    def copy(self) -> "IntPrefixSet":
        # Already compact: copy the pair without compacting it again.
        out = IntPrefixSet.__new__(IntPrefixSet)
        out.watermark = self.watermark
        out.values = set(self.values)
        return out

    def subset(self) -> "IntPrefixSet":
        """The watermark-only part; monotone (IntPrefixSet `subset`)."""
        return IntPrefixSet.from_watermark(self.watermark)

    def materialize(self) -> set[int]:
        return set(range(self.watermark)) | self.values

    def to_dict(self) -> dict:
        """Wire form (IntPrefixSetProto)."""
        return {"watermark": self.watermark, "values": sorted(self.values)}

    @classmethod
    def from_dict(cls, d: dict) -> "IntPrefixSet":
        return cls(d["watermark"], d["values"])


class FakeCompactSet(CompactSet[T]):
    """An uncompacted CompactSet for tests (compact/FakeCompactSet.scala)."""

    def __init__(self, values: Optional[Iterable[T]] = None):
        self._values: set[T] = set(values) if values else set()

    def __repr__(self):
        return f"FakeCompactSet({self._values!r})"

    def __eq__(self, other):
        return (isinstance(other, FakeCompactSet)
                and self._values == other._values)

    def add(self, x: T) -> bool:
        existed = x in self._values
        self._values.add(x)
        return existed

    def contains(self, x: T) -> bool:
        return x in self._values

    def union(self, other: "FakeCompactSet[T]") -> "FakeCompactSet[T]":
        return FakeCompactSet(self._values | other._values)

    def diff(self, other: "FakeCompactSet[T]") -> "FakeCompactSet[T]":
        return FakeCompactSet(self._values - other._values)

    def materialized_diff(self, other: "FakeCompactSet[T]") -> Iterable[T]:
        return self._values - other._values

    def add_all(self, other: "FakeCompactSet[T]") -> "FakeCompactSet[T]":
        self._values |= other._values
        return self

    def subtract_all(self, other: "FakeCompactSet[T]") -> "FakeCompactSet[T]":
        self._values -= other._values
        return self

    def subtract_one(self, x: T) -> "FakeCompactSet[T]":
        self._values.discard(x)
        return self

    @property
    def size(self) -> int:
        return len(self._values)

    @property
    def uncompacted_size(self) -> int:
        return len(self._values)

    def subset(self) -> "FakeCompactSet[T]":
        return FakeCompactSet(self._values)

    def materialize(self) -> set[T]:
        return set(self._values)
