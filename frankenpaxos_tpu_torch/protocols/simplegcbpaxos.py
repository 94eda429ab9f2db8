"""Simple GC BPaxos: SimpleBPaxos plus vertex garbage collection.

The port's copy of ``frankenpaxos_tpu/protocols/simplegcbpaxos.py``,
with ``gc_backend="cuda"`` in place of the reference's ``"tpu"``: every
GC-bearing role folds the replicas' frontiers by K12
(``ops/csrc/watermark.cu``) on its ``device``. Its messages travel
through the binary codecs of ``simplegcbpaxos_wire.py`` (the
reference's tags and bytes), registered when this module is imported.

Reference behavior: simplegcbpaxos/ (GarbageCollector.scala:56-180,
Proposer.scala:599-626, Acceptor.scala:269-287, Replica.scala:500-600,
DepServiceNode GC). Replicas gossip their executed frontier (a
per-leader watermark vector) to GarbageCollector nodes every N
executions; collectors relay GarbageCollect to proposers, acceptors, and
dep service nodes, which fold the frontiers into an f+1
QuorumWatermarkVector and prune all per-vertex state below the quorum
watermark -- once f+1 replicas have executed a vertex, its consensus
state is unrecoverable-needed and reclaimable.

Replicas that fall behind the GC watermark catch up from snapshots
(Replica.scala:195-214, 496-560, 743-880): every
``snapshot_every_n * num_replicas`` executed commands a replica asks a
leader to propose a *snapshot vertex* (SnapshotRequest,
Leader.scala:246-251). The dep service makes it depend on everything it
has seen and makes later commands depend on it
(DepServiceNode.scala:269-300 putSnapshot). Executing the snapshot
vertex captures (state machine bytes, client table, executed-vertex
watermark); a replica whose Recover hits a peer that already garbage
collected the vertex receives the whole snapshot as a CommitSnapshot
and re-executes only its unsnapshotted history on top.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from frankenpaxos_tpu_torch.clienttable import ClientTable
from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import (
    Commit,
    Recover,
    SimpleBPaxosConfig,
    VertexId,
    VertexIdPrefixSet,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.replica import (
    BPaxosReplica,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.roles import (
    BPaxosAcceptor,
    BPaxosDepServiceNode,
    BPaxosLeader,
    BPaxosProposer,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.utils.watermark import (
    check_backend,
    QuorumWatermarkVector,
)


@dataclasses.dataclass(frozen=True)
class GcBPaxosConfig(SimpleBPaxosConfig):
    garbage_collector_addresses: tuple = ()

    def check_valid(self) -> None:
        super().check_valid()
        if len(self.garbage_collector_addresses) \
                != len(self.replica_addresses):
            raise ValueError("collectors must mirror replicas")


@dataclasses.dataclass(frozen=True)
class GarbageCollect:
    replica_index: int
    frontier: tuple[int, ...]  # per-leader executed watermark vector


@dataclasses.dataclass(frozen=True)
class SnapshotMarker:
    """A proposal value meaning 'snapshot here' (the reference's
    CommandOrSnapshot Snapshot arm, SimpleGcBPaxos.proto:91-122)."""


SNAPSHOT = SnapshotMarker()


@dataclasses.dataclass(frozen=True)
class SnapshotRequest:
    """Replica -> leader: please get a snapshot vertex chosen
    (Replica.scala:595-604, Leader.scala:246-251)."""


@dataclasses.dataclass(frozen=True)
class CommitSnapshot:
    """A full snapshot, sent to a replica whose Recover hit a vertex we
    already garbage collected (Replica.scala:743-756)."""

    id: int
    watermark: dict  # VertexIdPrefixSet wire form
    state_machine: bytes
    client_table: dict  # ClientTable wire form


@dataclasses.dataclass
class _Snapshot:
    id: int
    watermark: VertexIdPrefixSet
    state_machine: bytes
    client_table: dict


class GarbageCollector(Actor):
    """Relays GarbageCollect to proposers, acceptors, and dep nodes
    (GarbageCollector.scala:56-180)."""

    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: GcBPaxosConfig):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config

    def receive(self, src: Address, message) -> None:
        if not isinstance(message, GarbageCollect):
            self.logger.fatal(f"unexpected collector message {message!r}")
        for dst in (tuple(self.config.proposer_addresses)
                    + tuple(self.config.acceptor_addresses)
                    + tuple(self.config.dep_service_node_addresses)):
            self.send(dst, message)


class _GcWatermarkMixin:
    """Fold GarbageCollect frontiers into an f+1 quorum watermark vector
    and prune per-vertex state below it.

    ``gc_backend="cuda"`` evaluates the quorum-watermark reduction by
    K12 on ``device`` (ops/watermark.py: a selection over the [replicas
    x leaders] frontier matrix's columns -- the QuorumWatermark.scala:
    31-50 math as one batched kernel); ``"host"`` is the numpy oracle.
    """

    def _init_gc(self, config: GcBPaxosConfig, gc_backend: str = "host",
                 device=None) -> None:
        check_backend(gc_backend, "gc_backend")
        self._gc_backend = gc_backend
        # K12's device, resolved now: "cuda" without a GPU (and no device
        # named) fails at construction, not at the first GarbageCollect.
        self.device = (resolve_device(device) if gc_backend == "cuda"
                       else None)
        self._gc_vector = QuorumWatermarkVector(
            n=len(config.replica_addresses),
            depth=len(config.leader_addresses))
        self.gc_watermark = [0] * len(config.leader_addresses)

    def _handle_garbage_collect(self, message: GarbageCollect) -> None:
        self._gc_vector.update(message.replica_index, message.frontier)
        self.gc_watermark = self._gc_vector.watermark(
            quorum_size=self.config.f + 1, backend=self._gc_backend,
            device=self.device)
        self._prune()

    def _collectable(self, vertex_id: VertexId) -> bool:
        return vertex_id.instance_number \
            < self.gc_watermark[vertex_id.replica_index]

    def _prune(self) -> None:
        for vertex_id in [v for v in self.states if self._collectable(v)]:
            state = self.states.pop(vertex_id)
            resend = getattr(state, "resend", None)
            if resend is not None:
                resend.stop()


class GcBPaxosLeader(BPaxosLeader):
    """BPaxosLeader that can also get snapshot vertices chosen
    (Leader.scala:246-251): a SnapshotRequest is handled exactly like a
    client request whose 'command' is the snapshot marker."""

    def receive(self, src: Address, message) -> None:
        if isinstance(message, SnapshotRequest):
            self._start_vertex(SNAPSHOT)
            return
        super().receive(src, message)


class GcBPaxosProposer(_GcWatermarkMixin, BPaxosProposer):
    def __init__(self, *args, gc_backend: str = "host", device=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._init_gc(self.config, gc_backend, device)

    def receive(self, src: Address, message) -> None:
        if isinstance(message, GarbageCollect):
            self._handle_garbage_collect(message)
            return
        if isinstance(message, Recover) \
                and self._collectable(message.vertex_id):
            # The vertex was garbage collected: f+1 replicas executed
            # it, so the recovering replica will get it from a peer's
            # snapshot instead. Proposing a fresh noop here would run
            # consensus against acceptors that pruned their votes.
            return
        super().receive(src, message)


class GcBPaxosAcceptor(_GcWatermarkMixin, BPaxosAcceptor):
    def __init__(self, *args, gc_backend: str = "host", device=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._init_gc(self.config, gc_backend, device)

    def receive(self, src: Address, message) -> None:
        if isinstance(message, GarbageCollect):
            self._handle_garbage_collect(message)
            return
        super().receive(src, message)


class GcBPaxosDepServiceNode(_GcWatermarkMixin, BPaxosDepServiceNode):
    def __init__(self, *args, gc_backend: str = "host", device=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._init_gc(self.config, gc_backend, device)
        # Highest vertex id + 1 seen per leader column, and the latest
        # snapshot vertex: a snapshot depends on everything seen before
        # it, and everything after depends on the snapshot
        # (DepServiceNode.scala:269-300 putSnapshot/highWatermark).
        self._high_watermark = [0] * len(self.config.leader_addresses)
        self._last_snapshot: Optional[VertexId] = None

    def _prune(self) -> None:
        # Dep nodes prune the dependency cache, not per-vertex consensus
        # state. Top-k conflict indexes don't support removal; stale
        # entries only add extra dependencies, which is safe
        # (DepServiceNode "fast conflict indexes don't remove").
        for vertex_id in [v for v in self.dependencies_cache
                          if self._collectable(v)]:
            del self.dependencies_cache[vertex_id]

    def receive(self, src: Address, message) -> None:
        if isinstance(message, GarbageCollect):
            self._handle_garbage_collect(message)
            return
        super().receive(src, message)

    def _compute_dependencies(self, vertex_id: VertexId,
                              command) -> VertexIdPrefixSet:
        """Snapshot vertices depend on everything seen; later commands
        depend on the latest snapshot (DepServiceNode.scala:269-300).
        Both are computed before the first reply is cached, keeping deps
        deterministic across re-asks."""
        if isinstance(command, SnapshotMarker):
            dependencies = VertexIdPrefixSet.from_watermarks(
                self._high_watermark)
            if self._last_snapshot is not None:
                dependencies.add(self._last_snapshot)
            dependencies.subtract_one(vertex_id)
            self._last_snapshot = vertex_id
        else:
            dependencies = super()._compute_dependencies(vertex_id, command)
            if self._last_snapshot is not None:
                dependencies.add(self._last_snapshot)
        column = vertex_id.replica_index
        self._high_watermark[column] = max(self._high_watermark[column],
                                           vertex_id.instance_number + 1)
        return dependencies


class GcBPaxosReplica(BPaxosReplica):
    """Gossips its executed frontier every N executions
    (Replica.scala:575-600), periodically requests snapshot vertices,
    answers peer Recovers from its snapshot, and catches up from
    CommitSnapshots (Replica.scala:496-560, 743-880)."""

    def __init__(self, *args, send_gc_every_n: int = 10,
                 snapshot_every_n: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.send_gc_every_n = send_gc_every_n
        self.snapshot_every_n = snapshot_every_n
        self._since_gc_send = 0
        # Staggered so replicas request snapshots at different times
        # (Replica.scala:274-279).
        self._since_snapshot_request = snapshot_every_n * self.index
        num_leaders = len(self.config.leader_addresses)
        # Contiguous executed prefix per leader column.
        self._frontier = [0] * num_leaders
        # Every executed vertex (incl. noops and snapshots), the
        # snapshot watermark source (Replica.scala:353-365).
        self.executed_vertices = VertexIdPrefixSet(num_leaders)
        self.snapshot: Optional[_Snapshot] = None
        # Command vertices actually run since the last snapshot, in
        # execution order (Replica.scala:368-374).
        self.history: list[VertexId] = []

    # --- execution hooks --------------------------------------------------
    def _unexecuted_dependencies(self, dependencies) -> set:
        # Snapshot vertices depend on the entire seen history; only the
        # unexecuted remainder constrains execution order, and only it
        # is worth materializing.
        return dependencies.materialized_diff(self.executed_vertices)

    def _execute(self, vertex_id: VertexId, value) -> None:
        self.executed_vertices.add(vertex_id)
        if isinstance(value, SnapshotMarker):
            self._take_snapshot()
        else:
            before = self.executed_count
            super()._execute(vertex_id, value)
            if self.executed_count > before:
                self.history.append(vertex_id)
        self._after_execute(vertex_id)

    def _after_execute(self, vertex_id: VertexId) -> None:
        # Advance the contiguous frontier for the vertex's column.
        column = vertex_id.replica_index
        executed = self.dependency_graph.executed
        while VertexId(column, self._frontier[column]) in executed:
            self._frontier[column] += 1
        self._since_gc_send += 1
        if self._since_gc_send >= self.send_gc_every_n:
            self._since_gc_send = 0
            self.send(self.config.garbage_collector_addresses[self.index],
                      GarbageCollect(replica_index=self.index,
                                     frontier=tuple(self._frontier)))
        if self.snapshot_every_n > 0:
            self._since_snapshot_request += 1
            n = self.snapshot_every_n * len(self.config.replica_addresses)
            if self._since_snapshot_request % n == 0:
                self._since_snapshot_request = 0
                leader = self.rng.choice(self.config.leader_addresses)
                self.send(leader, SnapshotRequest())

    def _take_snapshot(self) -> None:
        """Capture (sm bytes, client table, executed watermark) and drop
        snapshotted per-vertex state (Replica.scala:508-531)."""
        self.snapshot = _Snapshot(
            id=self.snapshot.id + 1 if self.snapshot else 0,
            watermark=self.executed_vertices.copy(),
            state_machine=self.state_machine.to_bytes(),
            client_table=self.client_table.to_dict())
        self.history.clear()
        self._prune_commands_below(self.executed_vertices.watermarks())

    def _prune_commands_below(self, watermarks: list[int]) -> None:
        for vertex_id in [v for v in self.commands
                          if v.instance_number
                          < watermarks[v.replica_index]]:
            del self.commands[vertex_id]

    # --- recovery ---------------------------------------------------------
    def _make_recover_timer(self, vertex_id: VertexId) -> object:
        attempt = [0]

        def fire():
            # Ask the vertex's proposer (noop if nothing was proposed)
            # AND one peer replica, rotating per attempt: if proposers
            # already garbage collected the vertex, only a peer's
            # snapshot has it (Replica.scala:607-650) -- but asking
            # every peer at once would pull one snapshot-sized reply
            # per peer when the first suffices.
            self.send(self.config.proposer_addresses[
                vertex_id.replica_index % len(
                    self.config.proposer_addresses)],
                Recover(vertex_id=vertex_id))
            peers = [i for i in range(len(self.config.replica_addresses))
                     if i != self.index]
            if peers:
                peer = peers[attempt[0] % len(peers)]
                attempt[0] += 1
                self.send(self.config.replica_addresses[peer],
                          Recover(vertex_id=vertex_id))
            timer.start()

        timer = self.timer(f"recoverVertex {vertex_id}",
                           self.rng.uniform(self.recover_min,
                                            self.recover_max), fire)
        timer.start()
        return timer

    def receive(self, src: Address, message) -> None:
        if isinstance(message, Recover):
            self._handle_peer_recover(src, message)
            return
        if isinstance(message, CommitSnapshot):
            self._handle_commit_snapshot(src, message)
            return
        super().receive(src, message)

    def _handle_peer_recover(self, src: Address, recover: Recover) -> None:
        """A peer is missing a vertex: send our snapshot if it swallowed
        the vertex, else the Commit if we still have it
        (Replica.scala:743-786)."""
        vertex_id = recover.vertex_id
        committed = self.commands.get(vertex_id)
        if committed is not None:
            # A single Commit is a much cheaper answer than the whole
            # snapshot; prefer it whenever we still have the vertex.
            self.send(src, Commit(
                vertex_id=vertex_id,
                command_or_noop=committed.command_or_noop,
                dependencies=committed.dependencies.copy()))
            return
        if self.snapshot is not None \
                and self.snapshot.watermark.contains(vertex_id):
            self.send(src, CommitSnapshot(
                id=self.snapshot.id,
                watermark=self.snapshot.watermark.to_dict(),
                state_machine=self.snapshot.state_machine,
                client_table=self.snapshot.client_table))

    def _handle_commit_snapshot(self, src: Address,
                                commit: CommitSnapshot) -> None:
        """Adopt a newer snapshot wholesale, then re-execute our
        unsnapshotted suffix on top (Replica.scala:788-880)."""
        if self.snapshot is not None and commit.id <= self.snapshot.id:
            return
        watermark = VertexIdPrefixSet.from_dict(commit.watermark)
        # Only vertices the snapshot newly marks executed need to reach
        # the dependency graph (bounds the materialization). The diff is
        # lazy -- force it before add_all mutates executed_vertices.
        newly_executed = list(
            watermark.materialized_diff(self.executed_vertices))
        self.state_machine.from_bytes(commit.state_machine)
        self.client_table = ClientTable.from_dict(commit.client_table)
        self.executed_vertices.add_all(watermark)
        self.snapshot = _Snapshot(commit.id, watermark.copy(),
                                  commit.state_machine, commit.client_table)
        # Recovery timers for snapshotted vertices are moot.
        for vertex_id in [v for v in self.recover_vertex_timers
                          if watermark.contains(v)]:
            self.recover_vertex_timers.pop(vertex_id).stop()
        # Drop per-vertex state the snapshot covers.
        watermarks = watermark.watermarks()
        self._prune_commands_below(watermarks)
        for column, mark in enumerate(watermarks):
            self._frontier[column] = max(self._frontier[column], mark)
        # Re-execute executed-but-unsnapshotted commands: their effects
        # were wiped when we replaced the state machine.
        old_history, self.history = self.history, []
        for vertex_id in old_history:
            if watermark.contains(vertex_id):
                continue
            committed = self.commands.get(vertex_id)
            if committed is None:
                self.logger.fatal(
                    f"unsnapshotted history vertex {vertex_id} has no "
                    f"Committed entry")
            self._execute(vertex_id, committed.command_or_noop)
        # Tell the graph, then see what became eligible.
        self.dependency_graph.update_executed(newly_executed)
        self._execute_graph()



# Register the snapshot cold-path codecs (tags 206-207). At the bottom
# to dodge the import cycle: the codec module imports our dataclasses.
from frankenpaxos_tpu_torch.protocols import simplegcbpaxos_wire  # noqa: E402,F401
