"""Compartmentalized MultiPaxos in the port (the counterpart of
``frankenpaxos_tpu/protocols/multipaxos/``).

Roles: Batcher -> Leader -> ProxyLeader -> Acceptor (groups or grid) ->
ProxyLeader -> Replica -> ProxyReplica -> Client, over the port's
``SimTransport`` or ``TcpTransport``. The ProxyLeader's Phase2b vote
collection runs on a pluggable quorum tracker (``quorum_tracker``;
backend ``"cuda"`` batches votes onto the GPU vote board once per
event-loop drain), and the Leader's Phase-1 recovery on K8
(``phase1_backend="cuda"``).
Client frames reach the Leader (or an ingest batcher, ``ingest/``) as
columns, and the ProxyLeaders take whole batch frames of vote acks as
range rows. ``harness.make_multipaxos`` wires a whole deployment over
the simulated transport, ``supernode.Supernode`` one over real TCP.
"""

from frankenpaxos_tpu_torch.ingest import wire as _ingest_wire  # noqa: F401
# Importing registers the hot-path binary codecs with the hybrid
# serializer (its module docstring explains the wire schema) -- the
# protocol's own page plus the ingest plane's IngestRun/NotLeaderIngest/
# IngestCredit descriptors (ingest/wire.py; an unregistered IngestRun
# would silently pickle).
from frankenpaxos_tpu_torch.protocols.multipaxos import wire  # noqa: F401

from frankenpaxos_tpu_torch.protocols.multipaxos.acceptor import (
    Acceptor,
    AcceptorOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.batcher import (
    Batcher,
    BatcherOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.client import (
    Client,
    ClientOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.config import (
    DistributionScheme,
    MultiPaxosConfig,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.leader import (
    Leader,
    LeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.proxy_leader import (
    ProxyLeader,
    ProxyLeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.proxy_replica import (
    ProxyReplica,
    ProxyReplicaOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.replica import (
    Replica,
    ReplicaOptions,
)

__all__ = [
    "Acceptor",
    "AcceptorOptions",
    "Batcher",
    "BatcherOptions",
    "Client",
    "ClientOptions",
    "DistributionScheme",
    "Leader",
    "LeaderOptions",
    "MultiPaxosConfig",
    "ProxyLeader",
    "ProxyLeaderOptions",
    "ProxyReplica",
    "ProxyReplicaOptions",
    "Replica",
    "ReplicaOptions",
]
