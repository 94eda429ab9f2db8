"""InstancePrefixSet: a compact set of EPaxos instances.

Reference behavior: epaxos/InstancePrefixSet.scala:12-60. An EPaxos
instance is (replica_index, instance_number); a set of instances is one
IntPrefixSet per replica column. Dependency sets compact to per-replica
watermark vectors -- the host twin of the device representation in
ops/depset.py.
"""

from __future__ import annotations

from itertools import repeat
from typing import Iterable, Iterator, NamedTuple

from frankenpaxos_tpu_torch.compact import IntPrefixSet
from frankenpaxos_tpu_torch.utils.topk import TopK, TopOne


class Instance(NamedTuple):
    replica_index: int
    instance_number: int


class InstancePrefixSet:
    def __init__(self, num_replicas: int,
                 int_prefix_sets: list[IntPrefixSet] | None = None):
        self.num_replicas = num_replicas
        self.columns = (int_prefix_sets
                        or [IntPrefixSet() for _ in range(num_replicas)])

    def __repr__(self):
        return f"InstancePrefixSet({self.columns!r})"

    def __eq__(self, other):
        return (isinstance(other, InstancePrefixSet)
                and self.columns == other.columns)

    def __hash__(self):
        return hash(tuple((c.watermark, frozenset(c.values))
                          for c in self.columns))

    @classmethod
    def from_watermarks(cls, watermarks: Iterable[int]) -> "InstancePrefixSet":
        cols = [IntPrefixSet.from_watermark(w) for w in watermarks]
        return cls(len(cols), cols)

    @classmethod
    def from_top_one(cls, top_one: TopOne) -> "InstancePrefixSet":
        return cls.from_watermarks(top_one.get())

    @classmethod
    def from_top_k(cls, top_k: TopK) -> "InstancePrefixSet":
        cols = []
        for ids in top_k.get():
            if not ids:
                cols.append(IntPrefixSet())
            else:
                # The smallest of the top-k becomes a watermark ("everything
                # up to here might conflict"); the rest stay sparse
                # (InstancePrefixSet.scala fromTopK).
                cols.append(IntPrefixSet(ids[0] + 1, ids[1:]))
        return cls(len(cols), cols)

    def add(self, instance: Instance) -> bool:
        return self.columns[instance[0]].add(instance[1])

    def contains(self, instance: Instance) -> bool:
        return self.columns[instance[0]].contains(instance[1])

    def add_all(self, other: "InstancePrefixSet") -> "InstancePrefixSet":
        for mine, theirs in zip(self.columns, other.columns):
            mine.add_all(theirs)
        return self

    def subtract_one(self, instance: Instance) -> "InstancePrefixSet":
        self.columns[instance[0]].subtract_one(instance[1])
        return self

    def materialized_diff(self, other: "InstancePrefixSet"
                          ) -> Iterator[Instance]:
        for r, (mine, theirs) in enumerate(zip(self.columns, other.columns)):
            for i in mine.materialized_diff(theirs):
                yield Instance(r, i)

    @property
    def size(self) -> int:
        return sum(c.size for c in self.columns)

    @property
    def uncompacted_size(self) -> int:
        return sum(c.uncompacted_size for c in self.columns)

    def materialize(self) -> set[Instance]:
        # The reference builds each Instance in a Python comprehension;
        # ``tuple.__new__`` mapped over ``zip`` builds the same set in C,
        # which matters because a committed watermark prefix
        # materializes every id below it.
        out: set[Instance] = set()
        for r, c in enumerate(self.columns):
            out.update(map(tuple.__new__, repeat(Instance),
                           zip(repeat(r), c.materialize())))
        return out

    def __iter__(self) -> Iterator[Instance]:
        return iter(self.materialize())

    def watermarks(self) -> list[int]:
        return [c.watermark for c in self.columns]

    def copy(self) -> "InstancePrefixSet":
        return InstancePrefixSet(self.num_replicas,
                                 [c.copy() for c in self.columns])

    def to_dict(self) -> dict:
        return {"num_replicas": self.num_replicas,
                "columns": [c.to_dict() for c in self.columns]}

    @classmethod
    def from_dict(cls, d: dict) -> "InstancePrefixSet":
        return cls(d["num_replicas"],
                   [IntPrefixSet.from_dict(c) for c in d["columns"]])
