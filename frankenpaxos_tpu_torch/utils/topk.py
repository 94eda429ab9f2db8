"""TopOne / TopK: per-leader maxima of seen vertex ids.

Reference behavior: util/TopOne.scala:6+, util/TopK.scala:6+,
util/VertexIdLike.scala:9+. Used by BPaxos-family dependency tracking:
a TopOne over vertex ids is a per-leader watermark vector (``max id + 1``
seen per leader column); TopK keeps the k largest ids per leader.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Generic, TypeVar

import numpy as np

try:
    from sortedcontainers import SortedSet  # type: ignore[import-untyped]
except ImportError:  # stripped environments: pure-Python fallback
    from frankenpaxos_tpu_torch.utils.sorted_compat import SortedSet

V = TypeVar("V")


@dataclasses.dataclass(frozen=True)
class VertexIdLike(Generic[V]):
    """How to view V as a (leader_index, id) vertex id
    (util/VertexIdLike.scala:9)."""

    leader_index: Callable[[V], int]
    id: Callable[[V], int]


# The standard view for tuple-shaped vertex ids ((leader_index, id)
# tuples or NamedTuples like EPaxos Instance / BPaxos VertexId).
TUPLE_VERTEX_LIKE: "VertexIdLike" = VertexIdLike(
    leader_index=lambda v: v[0], id=lambda v: v[1])


class TopOne(Generic[V]):
    """Per-leader ``max(id) + 1`` over everything put (TopOne.scala:6+)."""

    def __init__(self, num_leaders: int, like: VertexIdLike[V]):
        self.like = like
        self.top_ones = np.zeros(num_leaders, dtype=np.int64)

    def put(self, x: V) -> None:
        i = self.like.leader_index(x)
        self.top_ones[i] = max(self.top_ones[i], self.like.id(x) + 1)

    def get(self) -> list[int]:
        return self.top_ones.tolist()

    def merge_equals(self, other: "TopOne[V]") -> None:
        np.maximum(self.top_ones, other.top_ones, out=self.top_ones)


class TopK(Generic[V]):
    """The k largest ids seen per leader (TopK.scala:6+)."""

    def __init__(self, k: int, num_leaders: int, like: VertexIdLike[V]):
        self.k = k
        self.like = like
        self.top: list[SortedSet] = [SortedSet() for _ in range(num_leaders)]

    def put(self, x: V) -> None:
        ids = self.top[self.like.leader_index(x)]
        ids.add(self.like.id(x))
        if len(ids) > self.k:
            ids.pop(0)

    def get(self) -> list[list[int]]:
        return [list(ids) for ids in self.top]

    def merge_equals(self, other: "TopK[V]") -> None:
        for ids, other_ids in zip(self.top, other.top):
            ids.update(other_ids)
            while len(ids) > self.k:
                ids.pop(0)
