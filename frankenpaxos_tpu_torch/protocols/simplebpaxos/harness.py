"""Wire a whole SimpleBPaxos or SimpleGcBPaxos deployment over one
SimTransport.

The port's counterpart of ``tests/protocols/test_simplebpaxos.py::
make_bpaxos`` and ``tests/protocols/test_simplegcbpaxos.py::
make_gc_bpaxos`` (they live in the package because
``bench/bpaxos_sim.py`` and ``chip_smoke.py`` build clusters with them):
``f + 1`` leaders and proposers, ``2f + 1`` dep-service nodes and
acceptors, the replicas (and, for GC, one garbage collector per replica)
and the clients in one process, with the same addresses, options and
per-role seeds as the reference's, drawn in the same order, so that the
same proposals give the same message order, committed vertices and
replies in both packages.

``dep_backend="cuda"`` puts the Leaders' dep-service unions on K10 and
``gc_backend="cuda"`` the GC roles' quorum watermarks on K12, both on
``device`` (None means ``cuda``, which raises without a GPU).
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import (
    SimpleBPaxosConfig,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.replica import (
    BPaxosClient,
    BPaxosReplica,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.roles import (
    BPaxosAcceptor,
    BPaxosDepServiceNode,
    BPaxosLeader,
    BPaxosProposer,
)
from frankenpaxos_tpu_torch.protocols.simplegcbpaxos import (
    GarbageCollector,
    GcBPaxosAcceptor,
    GcBPaxosConfig,
    GcBPaxosDepServiceNode,
    GcBPaxosLeader,
    GcBPaxosProposer,
    GcBPaxosReplica,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.statemachine import KeyValueStore


def _addresses(f: int, num_replicas: int) -> dict:
    n = 2 * f + 1
    return dict(
        f=f,
        leader_addresses=tuple(f"leader-{i}" for i in range(f + 1)),
        proposer_addresses=tuple(f"proposer-{i}" for i in range(f + 1)),
        dep_service_node_addresses=tuple(f"dep-{i}" for i in range(n)),
        acceptor_addresses=tuple(f"acceptor-{i}" for i in range(n)),
        replica_addresses=tuple(f"replica-{i}"
                                for i in range(num_replicas)))


def make_bpaxos(f=1, num_clients=1, seed=0, dep_backend="host",
                device=None):
    """``(transport, config, replicas, clients)``, as the reference's
    ``make_bpaxos`` returns them."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = SimpleBPaxosConfig(**_addresses(f, f + 1))
    for i, a in enumerate(config.leader_addresses):
        BPaxosLeader(a, transport, logger, config, seed=seed + i,
                     dep_backend=dep_backend, device=device)
    for i, a in enumerate(config.proposer_addresses):
        BPaxosProposer(a, transport, logger, config, seed=seed + 10 + i)
    for a in config.dep_service_node_addresses:
        BPaxosDepServiceNode(a, transport, logger, config, KeyValueStore())
    for a in config.acceptor_addresses:
        BPaxosAcceptor(a, transport, logger, config)
    replicas = [BPaxosReplica(a, transport, logger, config,
                              KeyValueStore(), seed=seed + 30 + i)
                for i, a in enumerate(config.replica_addresses)]
    clients = [BPaxosClient(f"client-{i}", transport, logger, config,
                            seed=seed + 50 + i)
               for i in range(num_clients)]
    return transport, config, replicas, clients


def make_gc_bpaxos(f=1, send_gc_every_n=3, seed=0, num_replicas=None,
                   snapshot_every_n=0, dep_backend="host",
                   gc_backend="host", device=None, num_clients=1):
    """``(transport, config, proposers, acceptors, replicas, clients)``,
    as the reference's ``make_gc_bpaxos`` returns them (its one client is
    ``client-0``; ``num_clients`` adds ``client-1`` ... after it). The
    leaders, dep-service nodes and collectors are in
    ``transport.actors``."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    num_replicas = num_replicas or f + 1
    config = GcBPaxosConfig(
        **_addresses(f, num_replicas),
        garbage_collector_addresses=tuple(f"gc-{i}"
                                          for i in range(num_replicas)))
    gc = dict(gc_backend=gc_backend, device=device)
    for i, a in enumerate(config.leader_addresses):
        GcBPaxosLeader(a, transport, logger, config, seed=seed + i,
                       dep_backend=dep_backend, device=device)
    proposers = [GcBPaxosProposer(a, transport, logger, config,
                                  seed=seed + 10 + i, **gc)
                 for i, a in enumerate(config.proposer_addresses)]
    for a in config.dep_service_node_addresses:
        GcBPaxosDepServiceNode(a, transport, logger, config, KeyValueStore(),
                               **gc)
    acceptors = [GcBPaxosAcceptor(a, transport, logger, config, **gc)
                 for a in config.acceptor_addresses]
    replicas = [GcBPaxosReplica(a, transport, logger, config,
                                KeyValueStore(),
                                send_gc_every_n=send_gc_every_n,
                                snapshot_every_n=snapshot_every_n,
                                seed=seed + 30 + i)
                for i, a in enumerate(config.replica_addresses)]
    for a in config.garbage_collector_addresses:
        GarbageCollector(a, transport, logger, config)
    clients = [BPaxosClient(f"client-{i}", transport, logger, config,
                            seed=seed + 50 + i)
               for i in range(num_clients)]
    return transport, config, proposers, acceptors, replicas, clients


def gc_roles(transport: SimTransport) -> list:
    """Every GC-bearing role (proposers, dep-service nodes, acceptors),
    in the order they were built."""
    gc = (GcBPaxosProposer, GcBPaxosDepServiceNode, GcBPaxosAcceptor)
    return [a for a in transport.actors.values() if isinstance(a, gc)]


def unpruned(role) -> set:
    """The vertices a GC role still holds state for: a dep-service
    node's dependency cache, a proposer's or acceptor's states."""
    if isinstance(role, BPaxosDepServiceNode):
        return set(role.dependencies_cache)
    return set(role.states)


def committed(replica: BPaxosReplica) -> dict:
    """``vertex -> (command_or_noop, dependencies)`` of every committed
    vertex the replica holds (a GC replica drops those its snapshot
    covers). The dependency sets compare as canonical IntPrefixSet
    columns: equal iff their materialized sets are."""
    return {v: (c.command_or_noop, c.dependencies)
            for v, c in replica.commands.items()}


def committed_log(replica: BPaxosReplica) -> dict:
    """:func:`committed` with materialized dependency sets:
    ``vertex -> (command_or_noop, sorted deps)``."""
    return {v: (value, tuple(sorted(deps.materialize())))
            for v, (value, deps) in committed(replica).items()}
