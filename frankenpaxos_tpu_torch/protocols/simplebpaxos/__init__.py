"""Simple BPaxos: disaggregated generalized consensus.

The port's copy of ``frankenpaxos_tpu/protocols/simplebpaxos/``, with
the Leader's ``dep_backend="cuda"`` (K10) in place of ``"tpu"``. The
port's ``SimTransport`` pickles messages, so the binary codecs of the
reference's ``wire.py`` are not ported yet (ROADMAP.md queue 1).

Reference behavior: simplebpaxos/ (~2,200 LoC Scala; SURVEY.md section
2.2). Leaders assign vertices and ask a dependency-service quorum for
conflicts; per-vertex Paxos (proposers + acceptors) chooses
(command, deps); replicas execute in dependency-graph SCC order.
"""

from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import (
    SimpleBPaxosConfig,
    VertexId,
    VertexIdPrefixSet,
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

__all__ = [
    "BPaxosAcceptor",
    "BPaxosClient",
    "BPaxosDepServiceNode",
    "BPaxosLeader",
    "BPaxosProposer",
    "BPaxosReplica",
    "SimpleBPaxosConfig",
    "VertexId",
    "VertexIdPrefixSet",
]

# Importing registers the BPaxos binary codecs with the hybrid
# serializer (shared by SimpleGcBPaxos; see wire.py for the layout).
from frankenpaxos_tpu_torch.protocols.simplebpaxos import wire  # noqa: E402,F401
