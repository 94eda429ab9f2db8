"""Read-write quorum systems.

A quorum system is a node universe plus sets of read quorums R and write
quorums W such that every r in R intersects every w in W (Flexible Paxos).
Reference behavior: quorums/QuorumSystem.scala:16-24 (trait: nodes,
randomReadQuorum, randomWriteQuorum, isReadQuorum, isWriteQuorum,
isSuperSetOfReadQuorum, isSuperSetOfWriteQuorum) and the three
implementations SimpleMajority.scala:19-56, Grid.scala:5-57,
UnanimousWrites.scala:17-57; wire ser/de QuorumSystem.scala:26-61.

Each system also exposes ``read_spec()`` / ``write_spec()`` -- its
:class:`~frankenpaxos_tpu_torch.quorums.spec.QuorumSpec` matrix form -- which is
what the device kernels consume.
"""

from __future__ import annotations

import abc
import random
from typing import Iterable, Sequence

from frankenpaxos_tpu_torch.quorums.spec import ALL, ANY, QuorumSpec
import numpy as np


class QuorumSystem(abc.ABC):
    """Abstract read-write quorum system over integer node ids."""

    @abc.abstractmethod
    def nodes(self) -> frozenset[int]:
        ...

    @abc.abstractmethod
    def random_read_quorum(self, rng: random.Random) -> set[int]:
        ...

    @abc.abstractmethod
    def random_write_quorum(self, rng: random.Random) -> set[int]:
        ...

    def is_read_quorum(self, xs: Iterable[int]) -> bool:
        xs = set(xs)
        if not xs <= self.nodes():
            raise ValueError(f"{xs} is not a subset of {set(self.nodes())}")
        return self.is_superset_of_read_quorum(xs)

    def is_write_quorum(self, xs: Iterable[int]) -> bool:
        xs = set(xs)
        if not xs <= self.nodes():
            raise ValueError(f"{xs} is not a subset of {set(self.nodes())}")
        return self.is_superset_of_write_quorum(xs)

    def is_superset_of_read_quorum(self, xs: Iterable[int]) -> bool:
        return bool(self.read_spec().check(set(xs)))

    def is_superset_of_write_quorum(self, xs: Iterable[int]) -> bool:
        return bool(self.write_spec().check(set(xs)))

    @abc.abstractmethod
    def read_spec(self) -> QuorumSpec:
        """Matrix form of the read-quorum predicate."""

    @abc.abstractmethod
    def write_spec(self) -> QuorumSpec:
        """Matrix form of the write-quorum predicate."""


class SimpleMajority(QuorumSystem):
    """Every majority is both a read and a write quorum.

    Reference: quorums/SimpleMajority.scala:19-56.
    """

    def __init__(self, members: Iterable[int]):
        self.members = frozenset(members)
        if not self.members:
            raise ValueError("SimpleMajority needs at least one member")
        self.quorum_size = len(self.members) // 2 + 1
        self._universe = tuple(sorted(self.members))

    def __repr__(self):
        return f"SimpleMajority(members={sorted(self.members)})"

    def nodes(self) -> frozenset[int]:
        return self.members

    def random_read_quorum(self, rng: random.Random) -> set[int]:
        return set(rng.sample(self._universe, self.quorum_size))

    def random_write_quorum(self, rng: random.Random) -> set[int]:
        return self.random_read_quorum(rng)

    def read_spec(self) -> QuorumSpec:
        return QuorumSpec(
            masks=np.ones((1, len(self._universe)), dtype=np.uint8),
            thresholds=np.array([self.quorum_size], dtype=np.int32),
            combine=ANY,
            universe=self._universe,
        )

    def write_spec(self) -> QuorumSpec:
        return self.read_spec()


class Grid(QuorumSystem):
    """Nodes arranged in a grid: every row is a read quorum; one node from
    every row is a write quorum.

    Reference: quorums/Grid.scala:5-57. Matrix form (SURVEY.md section 2.3):
    read = ANY row fully present; write = ALL rows touched.
    """

    def __init__(self, grid: Sequence[Sequence[int]]):
        if not grid:
            raise ValueError("Grid needs at least one row")
        if any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("Grid rows must be equal-sized")
        self.grid = tuple(tuple(row) for row in grid)
        self._rows = [frozenset(row) for row in self.grid]
        self._nodes = frozenset().union(*self._rows)
        self._universe = tuple(sorted(self._nodes))

    def __repr__(self):
        return f"Grid(grid={self.grid})"

    def nodes(self) -> frozenset[int]:
        return self._nodes

    def random_read_quorum(self, rng: random.Random) -> set[int]:
        return set(self.grid[rng.randrange(len(self.grid))])

    def random_write_quorum(self, rng: random.Random) -> set[int]:
        i = rng.randrange(len(self.grid[0]))
        return {row[i] for row in self.grid}

    def is_superset_of_read_quorum(self, xs: Iterable[int]) -> bool:
        xs = set(xs)
        return any(row <= xs for row in self._rows)

    def is_superset_of_write_quorum(self, xs: Iterable[int]) -> bool:
        xs = set(xs)
        return all(row & xs for row in self._rows)

    def _row_masks(self) -> np.ndarray:
        masks = np.zeros((len(self._rows), len(self._universe)), dtype=np.uint8)
        col = {node: i for i, node in enumerate(self._universe)}
        for g, row in enumerate(self._rows):
            for node in row:
                masks[g, col[node]] = 1
        return masks

    def read_spec(self) -> QuorumSpec:
        masks = self._row_masks()
        return QuorumSpec(
            masks=masks,
            thresholds=masks.sum(axis=1).astype(np.int32),
            combine=ANY,
            universe=self._universe,
        )

    def write_spec(self) -> QuorumSpec:
        masks = self._row_masks()
        return QuorumSpec(
            masks=masks,
            thresholds=np.ones(len(self._rows), dtype=np.int32),
            combine=ALL,
            universe=self._universe,
        )


class ZoneGrid(QuorumSystem):
    """WPaxos-flavored asymmetric grid: rows are availability ZONES.

    The transpose of :class:`Grid`'s asymmetry, tuned for wide-area
    deployments (paxgeo, docs/GEO.md): a WRITE (Phase2) quorum is a
    majority of ANY single row -- in steady state the leader uses its
    home zone's row, so commits never cross a zone boundary -- while a
    READ (Phase1) quorum takes a majority of EVERY row, the cross-zone
    column sweep an object steal pays exactly once. Intersection
    (Flexible Paxos, arxiv 1608.06696): a read quorum contains a
    majority of whichever row a write quorum majority came from, and
    two majorities of one row always intersect. This is the f_z = 0
    WPaxos deployment (arxiv 1703.08905): zone-local commits, with a
    full-zone outage stalling steals of that zone's objects until f+1
    of its members recover from their WALs.
    """

    def __init__(self, grid: Sequence[Sequence[int]]):
        if not grid:
            raise ValueError("ZoneGrid needs at least one row")
        if any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("ZoneGrid rows must be equal-sized")
        self.grid = tuple(tuple(row) for row in grid)
        self._rows = [frozenset(row) for row in self.grid]
        self._nodes = frozenset().union(*self._rows)
        if len(self._nodes) != sum(len(r) for r in self._rows):
            raise ValueError("ZoneGrid rows must be disjoint")
        self._universe = tuple(sorted(self._nodes))
        self.row_majority = len(self.grid[0]) // 2 + 1

    def __repr__(self):
        return f"ZoneGrid(grid={self.grid})"

    def nodes(self) -> frozenset[int]:
        return self._nodes

    def random_read_quorum(self, rng: random.Random) -> set[int]:
        out: set[int] = set()
        for row in self.grid:
            out.update(rng.sample(row, self.row_majority))
        return out

    def random_write_quorum(self, rng: random.Random) -> set[int]:
        row = self.grid[rng.randrange(len(self.grid))]
        return set(rng.sample(row, self.row_majority))

    def is_superset_of_read_quorum(self, xs: Iterable[int]) -> bool:
        xs = set(xs)
        return all(len(row & xs) >= self.row_majority
                   for row in self._rows)

    def is_superset_of_write_quorum(self, xs: Iterable[int]) -> bool:
        xs = set(xs)
        return any(len(row & xs) >= self.row_majority
                   for row in self._rows)

    def _row_masks(self) -> np.ndarray:
        masks = np.zeros((len(self._rows), len(self._universe)),
                         dtype=np.uint8)
        col = {node: i for i, node in enumerate(self._universe)}
        for g, row in enumerate(self._rows):
            for node in row:
                masks[g, col[node]] = 1
        return masks

    def read_spec(self) -> QuorumSpec:
        return QuorumSpec(
            masks=self._row_masks(),
            thresholds=np.full(len(self._rows), self.row_majority,
                               dtype=np.int32),
            combine=ALL,
            universe=self._universe,
        )

    def write_spec(self) -> QuorumSpec:
        return QuorumSpec(
            masks=self._row_masks(),
            thresholds=np.full(len(self._rows), self.row_majority,
                               dtype=np.int32),
            combine=ANY,
            universe=self._universe,
        )

    def home_write_spec(self, row_index: int) -> QuorumSpec:
        """The write predicate ANCHORED at one row: a majority of row
        ``row_index`` over the FULL grid universe (other rows' columns
        are zero-masked, so their votes never count). This is the
        per-epoch Phase2 spec paxgeo feeds the fused checkers -- each
        object-steal epoch selects its home zone's plane."""
        if not 0 <= row_index < len(self.grid):
            raise ValueError(f"row {row_index} outside 0.."
                             f"{len(self.grid) - 1}")
        masks = np.zeros((1, len(self._universe)), dtype=np.uint8)
        col = {node: i for i, node in enumerate(self._universe)}
        for node in self.grid[row_index]:
            masks[0, col[node]] = 1
        return QuorumSpec(
            masks=masks,
            thresholds=np.array([self.row_majority], dtype=np.int32),
            combine=ANY,
            universe=self._universe,
        )


class UnanimousWrites(QuorumSystem):
    """One write quorum (all members); every non-empty subset reads.

    Reference: quorums/UnanimousWrites.scala:17-57. Used by fast-path
    protocols (UnanimousBPaxos).
    """

    def __init__(self, members: Iterable[int]):
        self.members = frozenset(members)
        if not self.members:
            raise ValueError("UnanimousWrites needs at least one member")
        self._universe = tuple(sorted(self.members))

    def __repr__(self):
        return f"UnanimousWrites(members={sorted(self.members)})"

    def nodes(self) -> frozenset[int]:
        return self.members

    def random_read_quorum(self, rng: random.Random) -> set[int]:
        return {rng.choice(self._universe)}

    def random_write_quorum(self, rng: random.Random) -> set[int]:
        return set(self.members)

    def read_spec(self) -> QuorumSpec:
        return QuorumSpec(
            masks=np.ones((1, len(self._universe)), dtype=np.uint8),
            thresholds=np.array([1], dtype=np.int32),
            combine=ANY,
            universe=self._universe,
        )

    def write_spec(self) -> QuorumSpec:
        return QuorumSpec(
            masks=np.ones((1, len(self._universe)), dtype=np.uint8),
            thresholds=np.array([len(self._universe)], dtype=np.int32),
            combine=ANY,
            universe=self._universe,
        )


def quorum_system_to_dict(qs: QuorumSystem) -> dict:
    """Wire form (the analog of QuorumSystemProto, QuorumSystem.scala:26-44)."""
    if isinstance(qs, SimpleMajority):
        return {"kind": "simple_majority", "members": sorted(qs.members)}
    if isinstance(qs, UnanimousWrites):
        return {"kind": "unanimous_writes", "members": sorted(qs.members)}
    if isinstance(qs, ZoneGrid):
        return {"kind": "zone_grid", "grid": [list(row) for row in qs.grid]}
    if isinstance(qs, Grid):
        return {"kind": "grid", "grid": [list(row) for row in qs.grid]}
    raise TypeError(f"unserializable quorum system {qs!r}")


def quorum_system_from_dict(d: dict) -> QuorumSystem:
    """Inverse of :func:`quorum_system_to_dict` (QuorumSystem.scala:45-61)."""
    kind = d["kind"]
    if kind == "simple_majority":
        return SimpleMajority(d["members"])
    if kind == "unanimous_writes":
        return UnanimousWrites(d["members"])
    if kind == "grid":
        return Grid(d["grid"])
    if kind == "zone_grid":
        return ZoneGrid(d["grid"])
    raise ValueError(f"unknown quorum system kind {kind!r}")
