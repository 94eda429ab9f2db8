"""Matrix form of a quorum predicate.

Every quorum system in the reference (quorums/SimpleMajority.scala:19-56,
quorums/Grid.scala:5-57, quorums/UnanimousWrites.scala:17-57) answers
``isReadQuorum(nodes)`` / ``isWriteQuorum(nodes)`` with set operations over
small integer sets. All of them are instances of one algebraic shape:

    counts[g]    = |nodes intersect group[g]|          (a matvec)
    satisfied[g] = counts[g] >= threshold[g]
    result       = ANY(satisfied)  or  ALL(satisfied)

- SimpleMajority read/write: one group (the members), threshold f+1, ANY.
- Grid read  ("some full row present"):   groups = rows, threshold = row
  size, ANY.
- Grid write ("one node from every row"): groups = rows, threshold = 1, ALL.
- UnanimousWrites write: one group, threshold = n, ANY; read: threshold 1.

Batched over a window of slots, ``counts = masks @ votes`` over the
``[acceptors x window]`` vote matrix is what the device kernels evaluate
(ops/quorum.py); a grid spec takes a fused OR/AND chain instead.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

ANY = "any"
ALL = "all"


@dataclasses.dataclass(frozen=True)
class QuorumSpec:
    """A quorum predicate in matrix form over a fixed node universe.

    Attributes:
      masks: ``[G, N]`` uint8 membership matrix; ``masks[g, i] == 1`` iff
        universe node ``i`` belongs to group ``g``.
      thresholds: ``[G]`` int32; group ``g`` is satisfied when at least
        ``thresholds[g]`` of its members responded.
      combine: ``"any"`` or ``"all"`` over satisfied groups.
      universe: the node ids, in column order, that the masks index.
    """

    masks: np.ndarray
    thresholds: np.ndarray
    combine: str
    universe: tuple[int, ...]

    def __post_init__(self):
        masks = np.asarray(self.masks, dtype=np.uint8)
        thresholds = np.asarray(self.thresholds, dtype=np.int32)
        if masks.ndim != 2:
            raise ValueError(f"masks must be [G, N], got shape {masks.shape}")
        if thresholds.shape != (masks.shape[0],):
            raise ValueError(
                f"thresholds shape {thresholds.shape} != ({masks.shape[0]},)")
        if masks.shape[1] != len(self.universe):
            raise ValueError(
                f"masks have {masks.shape[1]} columns but universe has "
                f"{len(self.universe)} nodes")
        if self.combine not in (ANY, ALL):
            raise ValueError(f"combine must be 'any' or 'all': {self.combine}")
        object.__setattr__(self, "masks", masks)
        object.__setattr__(self, "thresholds", thresholds)
        object.__setattr__(self, "universe", tuple(self.universe))

    @property
    def num_groups(self) -> int:
        return self.masks.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.masks.shape[1]

    def as_arrays(self) -> "tuple[np.ndarray, np.ndarray, bool]":
        """``(masks [G, N] int32, thresholds [G] int32, combine_any)``
        -- the factored predicate form every device kernel consumes
        (ops/quorum, bench/pipeline); one conversion point instead of
        hand-rolled triples at each call site."""
        return (np.asarray(self.masks, dtype=np.int32),
                np.asarray(self.thresholds, dtype=np.int32),
                self.combine == ANY)

    def column_of(self, node_id: int) -> int:
        return self.universe.index(node_id)

    def present_vector(self, nodes: Sequence[int]) -> np.ndarray:
        """``[N]`` uint8 indicator of which universe nodes are in ``nodes``."""
        present = np.zeros(self.num_nodes, dtype=np.uint8)
        node_set = set(nodes)
        for i, node_id in enumerate(self.universe):
            if node_id in node_set:
                present[i] = 1
        return present

    def evaluate(self, present: np.ndarray) -> np.ndarray:
        """Host/NumPy evaluation; the oracle the device kernel is tested against.

        Args:
          present: ``[..., N]`` bool/uint8 responder indicator(s).

        Returns:
          ``[...]`` bool: whether each responder set satisfies the predicate.
        """
        present = np.asarray(present)
        counts = present.astype(np.int32) @ self.masks.T.astype(np.int32)
        satisfied = counts >= self.thresholds
        if self.combine == ANY:
            return satisfied.any(axis=-1)
        return satisfied.all(axis=-1)

    def check(self, nodes: Sequence[int]) -> bool:
        return bool(self.evaluate(self.present_vector(nodes)))

    def reindexed(self, universe: Sequence[int]) -> "QuorumSpec":
        """The same predicate over a larger/reordered node universe.

        Nodes of the new universe not mentioned by this spec get all-zero
        mask columns (their votes never count). Every node of the current
        universe must appear in the new one. Used to pad per-group or
        per-configuration quorum systems into one fixed-width matrix
        (Matchmaker reconfiguration; MultiPaxos acceptor groups).
        """
        universe = tuple(universe)
        col = {node_id: i for i, node_id in enumerate(universe)}
        masks = np.zeros((self.num_groups, len(universe)), dtype=np.uint8)
        for g in range(self.num_groups):
            for i, node_id in enumerate(self.universe):
                if self.masks[g, i]:
                    masks[g, col[node_id]] = 1
        return QuorumSpec(masks=masks, thresholds=self.thresholds,
                          combine=self.combine, universe=universe)


def pad_specs(specs: Sequence[QuorumSpec]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad several same-universe specs to a common group count.

    Returns ``(masks [K, Gmax, N], thresholds [K, Gmax], combine_any [K])``
    where padding groups are always-satisfied under ALL (threshold 0) and
    never-satisfied under ANY (threshold N+1). This is the ragged-quorum
    plan of SURVEY.md section 7: reshaped configurations become one padded
    tensor plus validity handled through thresholds.
    """
    if not specs:
        raise ValueError("need at least one spec")
    n = specs[0].num_nodes
    for s in specs:
        if s.universe != specs[0].universe:
            raise ValueError("all specs must share a universe; reindex first")
    gmax = max(s.num_groups for s in specs)
    masks = np.zeros((len(specs), gmax, n), dtype=np.uint8)
    thresholds = np.zeros((len(specs), gmax), dtype=np.int32)
    combine_any = np.zeros(len(specs), dtype=bool)
    for k, s in enumerate(specs):
        g = s.num_groups
        masks[k, :g] = s.masks
        thresholds[k, :g] = s.thresholds
        combine_any[k] = s.combine == ANY
        if s.combine == ANY:
            thresholds[k, g:] = n + 1  # unsatisfiable padding
        else:
            thresholds[k, g:] = 0  # always-satisfied padding
    return masks, thresholds, combine_any
