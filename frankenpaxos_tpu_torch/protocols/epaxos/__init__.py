"""EPaxos: leaderless generalized consensus.

The port's copy of ``frankenpaxos_tpu/protocols/epaxos/``. Reference
behavior: epaxos/ (~2,400 LoC Scala; SURVEY.md section 2.2). One Replica
role holding every sub-role; dependency sets as InstancePrefixSets
(per-replica watermark columns -- the device twin is ``ops/depset.py``,
whose K10 and K11 the replica runs with ``dep_backend="cuda"``);
execution via Tarjan SCC ordering. The port's ``SimTransport`` pickles
messages, so the binary codecs of the reference's ``wire.py`` are not
ported yet (ROADMAP.md: with paxwire).
"""

from frankenpaxos_tpu_torch.protocols.epaxos.client import EPaxosClient
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance,
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.protocols.epaxos.replica import (
    EPaxosConfig,
    EPaxosReplica,
    EPaxosReplicaOptions,
)

__all__ = [
    "EPaxosClient",
    "EPaxosConfig",
    "EPaxosReplica",
    "EPaxosReplicaOptions",
    "Instance",
    "InstancePrefixSet",
]
