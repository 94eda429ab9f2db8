"""Incremental Tarjan dependency graph.

Reference behavior: depgraph/IncrementalTarjanDependencyGraph.scala:29+.
Unlike TarjanDependencyGraph -- which reruns Tarjan's algorithm from
scratch on every ``execute`` -- the incremental variant keeps the
traversal state (metadata, SCC stack, explicit call stack) across calls.
When the walk reaches an uncommitted dependency it *pauses*: the call
stack is left in place, the uncommitted key is reported as the (single)
blocker, and the next ``execute`` resumes exactly where the walk
stopped. It never redoes work, at the cost of sometimes delaying the
execution of vertices that are already eligible (neither strictly better
nor worse than the from-scratch variant; see the reference's comment at
IncrementalTarjanDependencyGraph.scala:10-27).

Implementation notes mirroring the reference:
- ``commit`` prunes executed dependencies and orders committed
  dependencies before uncommitted ones so a pass runs as far as possible
  before pausing (IncrementalTarjanDependencyGraph.scala:96-108).
- ``execute`` returns at most one blocker per call.
- ``update_executed`` is only supported between passes (the reference
  leaves it unimplemented outright,
  IncrementalTarjanDependencyGraph.scala:111-116).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Iterable, Optional, TypeVar

from frankenpaxos_tpu_torch.depgraph.base import DependencyGraph

K = TypeVar("K", bound=Hashable)

_PAUSED = "paused"
_SUCCESS = "success"


@dataclasses.dataclass
class _Vertex:
    sequence_number: object
    dependencies: list  # committed-first at commit time


@dataclasses.dataclass
class _Meta:
    number: int
    low_link: int
    on_stack: bool
    current_dependency: int


class IncrementalTarjanDependencyGraph(DependencyGraph[K]):
    def __init__(self, key_sort: Callable = None):
        self.vertices: dict[K, _Vertex] = {}
        self.executed: set[K] = set()
        self._key_sort = key_sort or (lambda k: k)
        # Pass state persisted across execute() calls.
        self._metadatas: dict[K, _Meta] = {}
        self._stack: list[K] = []
        self._callstack: list[K] = []
        self._executables: list[list[K]] = []
        self._blocker: Optional[K] = None

    # --- API --------------------------------------------------------------
    def commit(self, key: K, sequence_number, dependencies: Iterable[K]
               ) -> None:
        if key in self.vertices or key in self.executed:
            return
        deps = set(dependencies) - self.executed
        committed = [d for d in deps if d in self.vertices]
        uncommitted = [d for d in deps if d not in self.vertices]
        order = self._key_sort
        self.vertices[key] = _Vertex(
            sequence_number,
            sorted(committed, key=order) + sorted(uncommitted, key=order))

    def update_executed(self, keys: Iterable[K]) -> None:
        if self._callstack:
            raise NotImplementedError(
                "update_executed mid-pass is unsupported (the reference "
                "leaves it unimplemented entirely, "
                "IncrementalTarjanDependencyGraph.scala:111-116)")
        for key in keys:
            self.executed.add(key)
            self.vertices.pop(key, None)

    def execute_by_component(self, num_blockers: Optional[int] = None
                             ) -> tuple[list[list[K]], set[K]]:
        # Resume a paused walk first.
        if self._callstack:
            if self._strong_connect() == _PAUSED:
                return self._collect_executables(), self._take_blocker()

        for key in list(self.vertices):
            if key not in self._metadatas:
                self._callstack.append(key)
                if self._strong_connect() == _PAUSED:
                    return self._collect_executables(), self._take_blocker()

        # Completed a full pass: safe to start numbering afresh next time.
        assert not self._callstack
        assert not self._stack
        self._metadatas.clear()
        return self._collect_executables(), self._take_blocker()

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    # --- internals --------------------------------------------------------
    def _take_blocker(self) -> set[K]:
        blocker = {self._blocker} if self._blocker is not None else set()
        self._blocker = None
        return blocker

    def _collect_executables(self) -> list[list[K]]:
        for component in self._executables:
            for key in component:
                self.vertices.pop(key, None)
                self.executed.add(key)
        out = self._executables
        self._executables = []
        return out

    def _strong_connect(self) -> str:
        """Run the manually-stacked Tarjan walk until the call stack
        drains (_SUCCESS) or an uncommitted dependency pauses it
        (_PAUSED). Mirrors IncrementalTarjanDependencyGraph.scala:172-266."""
        md, stack, callstack = self._metadatas, self._stack, self._callstack
        while callstack:
            v = callstack[-1]
            meta = md.get(v)
            if meta is None:
                meta = _Meta(number=len(md), low_link=len(md),
                             on_stack=True, current_dependency=0)
                md[v] = meta
                stack.append(v)

            deps = self.vertices[v].dependencies
            descended = False
            while meta.current_dependency < len(deps):
                w = deps[meta.current_dependency]
                if w in self.executed:
                    pass  # executed mid-pass: satisfied.
                elif w not in self.vertices:
                    self._blocker = w
                    return _PAUSED
                elif w not in md:
                    callstack.append(w)
                    descended = True
                    break
                elif md[w].on_stack:
                    meta.low_link = min(meta.low_link, md[w].number)
                meta.current_dependency += 1
            if descended:
                continue

            # All dependencies processed: maybe root an SCC, then unwind.
            if meta.low_link == meta.number:
                component: list[K] = []
                while True:
                    w = stack.pop()
                    md[w].on_stack = False
                    component.append(w)
                    if w == v:
                        break
                component.sort(
                    key=lambda k: (self.vertices[k].sequence_number,
                                   self._key_sort(k)))
                self._executables.append(component)
            callstack.pop()
            if callstack:
                parent = md[callstack[-1]]
                parent.low_link = min(parent.low_link, meta.low_link)
                parent.current_dependency += 1
        return _SUCCESS
