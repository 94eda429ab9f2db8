"""A from-scratch dependency graph used as a test oracle.

The reference tests its fast Tarjan implementation against library-backed
ones (JgraphtDependencyGraph.scala:23, ScalaGraphDependencyGraph.scala:19;
depgraph/DependencyGraphTest.scala runs all implementations against each
other). This plays that role: recompute eligibility and Kosaraju-style
SCCs from scratch on every ``execute`` -- slow and obviously correct.
"""

from __future__ import annotations

from typing import Hashable, Iterable, Optional, TypeVar

from frankenpaxos_tpu_torch.depgraph.base import DependencyGraph

K = TypeVar("K", bound=Hashable)


class NaiveDependencyGraph(DependencyGraph[K]):
    def __init__(self, key_sort=None):
        self.committed: dict[K, tuple[object, set]] = {}
        self.executed: set[K] = set()
        self._key_sort = key_sort or (lambda k: k)

    def commit(self, key, sequence_number, dependencies) -> None:
        if key in self.executed or key in self.committed:
            return
        self.committed[key] = (sequence_number, set(dependencies))

    def update_executed(self, keys: Iterable[K]) -> None:
        for key in keys:
            self.executed.add(key)
            self.committed.pop(key, None)

    @property
    def num_vertices(self) -> int:
        return len(self.committed)

    def _eligible_and_blockers(self) -> tuple[set[K], set[K]]:
        """Eligible = transitive closure stays within committed."""
        eligible: set[K] = set()
        blockers: set[K] = set()
        for start in self.committed:
            seen: set[K] = set()
            frontier = [start]
            ok = True
            while frontier:
                v = frontier.pop()
                if v in seen or v in self.executed:
                    continue
                seen.add(v)
                if v not in self.committed:
                    ok = False
                    blockers.add(v)
                    continue
                frontier.extend(self.committed[v][1])
            if ok:
                eligible.add(start)
        return eligible, blockers

    def execute_by_component(self, num_blockers: Optional[int] = None
                             ) -> tuple[list[list[K]], set[K]]:
        eligible, blockers = self._eligible_and_blockers()
        # Kosaraju on the eligible subgraph.
        graph = {v: [w for w in self.committed[v][1]
                     if w in eligible and w not in self.executed]
                 for v in eligible}
        order: list[K] = []
        seen: set[K] = set()
        for start in graph:
            if start in seen:
                continue
            # Iterative DFS with postorder.
            stack = [(start, iter(graph[start]))]
            seen.add(start)
            while stack:
                v, it = stack[-1]
                advanced = False
                for w in it:
                    if w not in seen:
                        seen.add(w)
                        stack.append((w, iter(graph[w])))
                        advanced = True
                        break
                if not advanced:
                    order.append(v)
                    stack.pop()
        reverse: dict[K, list[K]] = {v: [] for v in graph}
        for v, ws in graph.items():
            for w in ws:
                reverse[w].append(v)
        assigned: set[K] = set()
        components: list[list[K]] = []
        for v in reversed(order):
            if v in assigned:
                continue
            component = []
            frontier = [v]
            while frontier:
                u = frontier.pop()
                if u in assigned:
                    continue
                assigned.add(u)
                component.append(u)
                frontier.extend(reverse[u])
            component.sort(key=lambda k: (self.committed[k][0],
                                          self._key_sort(k)))
            components.append(component)
        # Kosaraju (on reversed postorder over the forward graph) yields
        # components in topological order; execution wants reverse.
        components.reverse()
        for component in components:
            for key in component:
                self.executed.add(key)
                self.committed.pop(key, None)
        return components, blockers
