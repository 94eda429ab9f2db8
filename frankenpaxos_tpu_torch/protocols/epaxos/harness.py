"""Wire a whole EPaxos deployment over one SimTransport.

The port's counterpart of ``tests/protocols/test_epaxos.py::make_epaxos``
(it lives in the package because ``bench/epaxos_sim.py`` and
``chip_smoke.py`` build clusters with it): ``2f + 1`` replicas and
``num_clients`` clients in one process, driven by explicit message
deliveries and timer firings, with the same addresses, options and
per-role seeds as the reference's, so that the same proposals give the
same message order, committed triples and replies in both packages.

``device`` reaches the replicas with ``dep_backend="cuda"`` (None means
``cuda``, which raises without a GPU).
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.protocols.epaxos.client import EPaxosClient
from frankenpaxos_tpu_torch.protocols.epaxos.replica import (
    CommittedEntry,
    EPaxosConfig,
    EPaxosReplica,
    EPaxosReplicaOptions,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.statemachine import KeyValueStore


def make_epaxos(f=1, num_clients=1, state_machine_factory=KeyValueStore,
                seed=0, top_k=1, dependency_graph="tarjan",
                dep_backend="host", device=None):
    """``(transport, config, replicas, clients)``, as the reference's
    ``make_epaxos`` returns them."""
    logger = FakeLogger(LogLevel.FATAL)
    transport = SimTransport(logger)
    config = EPaxosConfig(
        f=f, replica_addresses=tuple(f"replica-{i}" for i in range(2 * f + 1)))
    replicas = [
        EPaxosReplica(a, transport, logger, config, state_machine_factory(),
                      EPaxosReplicaOptions(top_k_dependencies=top_k,
                                           dependency_graph=dependency_graph,
                                           dep_backend=dep_backend),
                      seed=seed + i, device=device)
        for i, a in enumerate(config.replica_addresses)]
    clients = [EPaxosClient(f"client-{i}", transport, logger, config,
                            seed=seed + 100 + i)
               for i in range(num_clients)]
    return transport, config, replicas, clients


def committed_triples(replica: EPaxosReplica) -> dict:
    """``instance -> (command_or_noop, sequence_number, dependencies)``
    of every committed entry of the replica's log."""
    return {i: (e.triple.command_or_noop, e.triple.sequence_number,
                e.triple.dependencies)
            for i, e in replica.cmd_log.items()
            if isinstance(e, CommittedEntry)}


def committed_log(replica: EPaxosReplica) -> dict:
    """The committed log with materialized dependency sets:
    ``instance -> (command_or_noop, sequence_number, sorted deps)``."""
    return {instance: (triple[0], triple[1],
                       tuple(sorted(triple[2].materialize())))
            for instance, triple in committed_triples(replica).items()}
