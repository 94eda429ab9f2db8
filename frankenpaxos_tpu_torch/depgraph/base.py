"""DependencyGraph contract.

Reference behavior: depgraph/DependencyGraph.scala:127-193. A vertex is
*eligible* for execution iff it and everything transitively reachable
from it is committed. ``execute`` returns eligible vertices in an order
compatible with the graph: reverse topological order of strongly
connected components, with components internally ordered by
(sequence number, key) for determinism. Once returned, a vertex is never
returned again. ``blockers`` are uncommitted keys found blocking
eligibility -- the protocol recovers those (EPaxos explicit prepare /
BPaxos vertex recovery).
"""

from __future__ import annotations

import abc
from typing import Generic, Hashable, Iterable, Optional, TypeVar

K = TypeVar("K", bound=Hashable)


class DependencyGraph(abc.ABC, Generic[K]):
    @abc.abstractmethod
    def commit(self, key: K, sequence_number, dependencies: Iterable[K]
               ) -> None:
        """Add a committed vertex; does not execute anything."""

    def execute(self, num_blockers: Optional[int] = None
                ) -> tuple[list[K], set[K]]:
        components, blockers = self.execute_by_component(num_blockers)
        return [key for component in components for key in component], blockers

    def append_execute(self, num_blockers: Optional[int],
                       executables: list[K], blockers: set[K]) -> None:
        new_executables, new_blockers = self.execute(num_blockers)
        executables.extend(new_executables)
        blockers.update(new_blockers)

    @abc.abstractmethod
    def execute_by_component(self, num_blockers: Optional[int] = None
                             ) -> tuple[list[list[K]], set[K]]:
        ...

    @abc.abstractmethod
    def update_executed(self, keys: Iterable[K]) -> None:
        """Inform the graph that ``keys`` were executed out-of-band
        (e.g. learned via snapshot)."""

    @property
    @abc.abstractmethod
    def num_vertices(self) -> int:
        ...
