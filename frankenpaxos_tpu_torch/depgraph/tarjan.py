"""Tarjan-based dependency graph with interlaced eligibility.

Reference behavior: depgraph/TarjanDependencyGraph.scala:149-450.
Tarjan's SCC algorithm emits components in reverse topological order in
a single pass -- exactly the execution order a dependency graph needs --
and eligibility (all transitive deps committed) is computed during the
same pass: hitting an uncommitted dependency marks the whole stack
ineligible and unwinds immediately (TarjanDependencyGraph.scala:354-446).

This implementation is iterative (explicit frame stack): EPaxos logs
routinely hold dependency chains far deeper than Python's recursion
limit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Iterable, Optional, TypeVar

from frankenpaxos_tpu_torch.depgraph.base import DependencyGraph

K = TypeVar("K", bound=Hashable)


@dataclasses.dataclass
class _Vertex:
    sequence_number: object
    dependencies: set


@dataclasses.dataclass
class _Meta:
    number: int
    low_link: int
    stack_index: int
    eligible: bool


class TarjanDependencyGraph(DependencyGraph[K]):
    def __init__(self, key_sort: Callable = None):
        self.vertices: dict[K, _Vertex] = {}
        self.executed: set[K] = set()
        self._key_sort = key_sort or (lambda k: k)

    # --- API --------------------------------------------------------------
    def commit(self, key: K, sequence_number, dependencies: Iterable[K]
               ) -> None:
        if key in self.executed or key in self.vertices:
            return  # already committed/executed (debug-warn in reference)
        self.vertices[key] = _Vertex(sequence_number, set(dependencies))

    def update_executed(self, keys: Iterable[K]) -> None:
        for key in keys:
            self.executed.add(key)
            self.vertices.pop(key, None)

    def execute_by_component(self, num_blockers: Optional[int] = None
                             ) -> tuple[list[list[K]], set[K]]:
        self._metadatas: dict[K, _Meta] = {}
        self._stack: list[K] = []
        components: list[list[K]] = []
        blockers: set[K] = set()
        for key in list(self.vertices):
            if key in self._metadatas:
                continue
            self._strong_connect(key, components, blockers)
            # An ineligible root leaves its whole path on the stack; clear
            # it (TarjanDependencyGraph.scala:326-332).
            if not self._metadatas[key].eligible:
                self._stack.clear()
            if num_blockers is not None and len(blockers) >= num_blockers:
                break
        # Returned components leave the graph permanently.
        for component in components:
            for key in component:
                self.executed.add(key)
                self.vertices.pop(key, None)
        return components, blockers

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    # --- the interlaced Tarjan pass ---------------------------------------
    def _strong_connect(self, root: K, components: list[list[K]],
                        blockers: set[K]) -> None:
        vertices, md, stack = self.vertices, self._metadatas, self._stack

        # frame = [key, dependency iterator, aborted]
        frames: list[list] = []

        def enter(v: K) -> None:
            md[v] = _Meta(number=len(md), low_link=len(md),
                          stack_index=len(stack), eligible=True)
            stack.append(v)
            deps = vertices[v].dependencies - self.executed
            frames.append([v, iter(sorted(deps, key=self._key_sort)), False])

        enter(root)
        while frames:
            frame = frames[-1]
            v = frame[0]
            descended = False
            if not frame[2]:
                for w in frame[1]:
                    if w not in vertices:
                        # Uncommitted dependency: v (and the whole stack
                        # above) is ineligible; record the blocker.
                        md[v].eligible = False
                        blockers.add(w)
                        frame[2] = True
                        break
                    if w not in md:
                        enter(w)
                        descended = True
                        break
                    if not md[w].eligible:
                        md[v].eligible = False
                        frame[2] = True
                        break
                    if md[w].stack_index != -1:
                        # On-stack child: classic Tarjan lowlink update
                        # uses the child's *number*.
                        md[v].low_link = min(md[v].low_link, md[w].number)
                    # Off-stack eligible child: nothing to do.
                if descended:
                    continue
            # Frame finished (deps exhausted or aborted).
            frames.pop()
            if not frame[2] and md[v].low_link == md[v].number:
                # v roots its SCC: everything at/above its stack index.
                idx = md[v].stack_index
                component = stack[idx:]
                del stack[idx:]
                for w in component:
                    md[w].stack_index = -1
                component.sort(key=lambda k: (vertices[k].sequence_number,
                                              self._key_sort(k)))
                components.append(component)
            if frames:
                parent = frames[-1]
                p = parent[0]
                if not md[v].eligible:
                    md[p].eligible = False
                    parent[2] = True
                else:
                    md[p].low_link = min(md[p].low_link, md[v].low_link)
