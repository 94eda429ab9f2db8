"""Zigzag Tarjan dependency graph.

Reference behavior: depgraph/ZigzagTarjanDependencyGraph.scala:135+.
Specialized to BPaxos/EPaxos-style vertex ids -- keys that decompose
into a ``(leader_index, id)`` pair with dense per-leader id spaces.
Vertices live in one BufferMap per leader column and the traversal
*zigzags* across columns in executed-watermark order
(ZigzagTarjanDependencyGraph.scala:330-348): try to execute the vertex
at each column's watermark, round-robin; a column whose watermark vertex
is missing (reported as a blocker) or ineligible drops out of the
rotation; the pass ends when no column can advance. Visiting vertices in
id order makes the log prefix dense behind the watermarks, so garbage
collection is a pure BufferMap prefix drop, run every
``gc_every_n_commands`` executed commands
(ZigzagTarjanDependencyGraph.scala:225-231).

The SCC walk itself is the same interlaced-eligibility Tarjan pass as
TarjanDependencyGraph (strongConnect,
ZigzagTarjanDependencyGraph.scala:408-538), with its single-vertex fast
path. Implemented iteratively: EPaxos dependency chains routinely exceed
Python's recursion limit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Iterable, Optional, TypeVar

from frankenpaxos_tpu_torch.depgraph.base import DependencyGraph
from frankenpaxos_tpu_torch.utils.buffer_map import BufferMap
from frankenpaxos_tpu_torch.utils.topk import TUPLE_VERTEX_LIKE, VertexIdLike

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


class ZigzagTarjanDependencyGraph(DependencyGraph[K]):
    def __init__(self, num_leaders: int,
                 like: VertexIdLike = TUPLE_VERTEX_LIKE,
                 make: Callable[[int, int], K] = lambda l, i: (l, i),
                 grow_size: int = 1000,
                 gc_every_n_commands: int = 1000,
                 key_sort: Callable = None):
        self.num_leaders = num_leaders
        self.like = like
        self.make = make
        self.gc_every_n_commands = gc_every_n_commands
        self.vertices: list[BufferMap[_Vertex]] = [
            BufferMap(grow_size) for _ in range(num_leaders)]
        self.executed_watermark = [0] * num_leaders
        self.executed: set[K] = set()
        self._key_sort = key_sort or (lambda k: k)
        self._num_vertices = 0
        self._num_commands_since_gc = 0

    # --- API --------------------------------------------------------------
    def commit(self, key: K, sequence_number, dependencies: Iterable[K]
               ) -> None:
        leader, vid = self.like.leader_index(key), self.like.id(key)
        if self._is_executed(key) or self.vertices[leader].contains(vid):
            return
        self.vertices[leader].put(vid, _Vertex(sequence_number,
                                               set(dependencies)))
        self._num_vertices += 1

    def update_executed(self, keys: Iterable[K]) -> None:
        for key in keys:
            if self._is_executed(key):
                continue
            self.executed.add(key)
            if self._get(key) is not None:
                self._num_vertices -= 1
        # GC accounting happens when execute()'s watermark skip passes
        # these keys -- counting here too would double-count.

    def execute_by_component(self, num_blockers: Optional[int] = None
                             ) -> tuple[list[list[K]], set[K]]:
        metadatas: dict[K, _Meta] = {}
        stack: list[K] = []
        components: list[list[K]] = []
        blockers: set[K] = set()

        columns = list(range(self.num_leaders))
        index = 0
        # GC is a prefix drop at the watermarks, so the GC trigger counts
        # watermark *advances*: every vertex passes under its column's
        # watermark exactly once -- via the skip loop (executed
        # out-of-band or as a cross-column component member) or via the
        # post-execute advance below -- never both.
        advances = 0
        while columns:
            leader = columns[index]
            # Skip ids executed out-of-band (executed.leaderIndexWatermark
            # in the reference's watermark advance,
            # ZigzagTarjanDependencyGraph.scala:334-337).
            while self.make(leader, self.executed_watermark[leader]) \
                    in self.executed:
                self.executed.discard(
                    self.make(leader, self.executed_watermark[leader]))
                self.executed_watermark[leader] += 1
                advances += 1
            vid = self.executed_watermark[leader]
            if self._execute_key(leader, vid, metadatas, stack,
                                 components, blockers):
                self.executed_watermark[leader] += 1
                advances += 1
                index += 1
            else:
                columns.pop(index)
            if index >= len(columns):
                index = 0
            # num_blockers is deliberately NOT an early exit: every column
            # must get its turn or eligible vertices in later columns
            # starve (the reference's zigzag executeImpl ignores
            # numBlockers for the same reason,
            # ZigzagTarjanDependencyGraph.scala:330-348).

        self._num_vertices -= sum(len(c) for c in components)
        self._num_commands_since_gc += advances
        if self._num_commands_since_gc >= self.gc_every_n_commands:
            self._garbage_collect()
            self._num_commands_since_gc = 0
        return components, blockers

    @property
    def num_vertices(self) -> int:
        return self._num_vertices

    # --- internals --------------------------------------------------------
    def _is_executed(self, key: K) -> bool:
        """Ids below a column's executed watermark are provably executed;
        the ``executed`` set only carries the sparse above-watermark tail
        (the reference's watermark-compressed VertexIdPrefixSet)."""
        return (self.like.id(key)
                < self.executed_watermark[self.like.leader_index(key)]
                or key in self.executed)

    def _get(self, key: K) -> Optional[_Vertex]:
        return self.vertices[self.like.leader_index(key)].get(
            self.like.id(key))

    def _garbage_collect(self) -> None:
        for leader in range(self.num_leaders):
            self.vertices[leader].garbage_collect(
                self.executed_watermark[leader])
        self.executed = {
            k for k in self.executed
            if self.like.id(k)
            >= self.executed_watermark[self.like.leader_index(k)]}

    def _execute_key(self, leader: int, vid: int, metadatas, stack,
                     components, blockers) -> bool:
        key = self.make(leader, vid)
        if self._is_executed(key):
            return True
        if self.vertices[leader].get(vid) is None:
            # Only a genuine hole -- a missing id with committed vertices
            # above it in the same column -- is a blocker worth
            # recovering. A merely-drained column would otherwise hand
            # EPaxos/BPaxos a never-proposed instance to recover,
            # noop-committing in a perpetual cycle on an idle cluster.
            # (Deviation from the reference, which reports the tail
            # unconditionally, ZigzagTarjanDependencyGraph.scala:361-364;
            # dependency-driven blockers still surface via
            # _strong_connect.)
            if vid <= self.vertices[leader].largest_key:
                blockers.add(key)
            return False
        meta = metadatas.get(key)
        if meta is not None:
            return meta.eligible
        eligible = self._strong_connect(key, metadatas, stack, components,
                                        blockers)
        if not eligible:
            # Everything left on the stack is ineligible too
            # (ZigzagTarjanDependencyGraph.scala:384-394).
            for w in stack:
                metadatas[w].eligible = False
                metadatas[w].stack_index = -1
            stack.clear()
        return eligible

    def _strong_connect(self, root: K, md, stack, components,
                        blockers) -> bool:
        """Iterative interlaced-eligibility Tarjan from ``root``; returns
        the root's eligibility. Components formed along the way are
        appended to ``components`` and marked executed immediately;
        BufferMap pruning is deferred to GC."""
        frames: list[list] = []

        def enter(v: K) -> None:
            meta = _Meta(number=len(md), low_link=len(md),
                         stack_index=len(stack), eligible=True)
            md[v] = meta
            stack.append(v)
            deps = [d for d in sorted(self._get(v).dependencies,
                                      key=self._key_sort)
                    if not self._is_executed(d)]
            frames.append([v, iter(deps), False])

        enter(root)
        while frames:
            frame = frames[-1]
            v = frame[0]
            meta = md[v]
            descended = False
            if not frame[2]:
                for w in frame[1]:
                    if self._is_executed(w):
                        continue
                    if self._get(w) is None:
                        meta.eligible = False
                        meta.stack_index = -1
                        blockers.add(w)
                        frame[2] = True
                        break
                    wmeta = md.get(w)
                    if wmeta is None:
                        enter(w)
                        descended = True
                        break
                    if not wmeta.eligible:
                        meta.eligible = False
                        meta.stack_index = -1
                        frame[2] = True
                        break
                    if wmeta.stack_index != -1:
                        meta.low_link = min(meta.low_link, wmeta.number)
                if descended:
                    continue
            frames.pop()
            if not frame[2] and meta.low_link == meta.number:
                component = stack[meta.stack_index:]
                del stack[meta.stack_index:]
                for w in component:
                    md[w].stack_index = -1
                    self.executed.add(w)
                component.sort(
                    key=lambda k: (self._get(k).sequence_number,
                                   self._key_sort(k)))
                components.append(component)
            if frames:
                parent = frames[-1]
                pmeta = md[parent[0]]
                if not meta.eligible:
                    pmeta.eligible = False
                    pmeta.stack_index = -1
                    parent[2] = True
                else:
                    pmeta.low_link = min(pmeta.low_link, meta.low_link)
        return md[root].eligible
