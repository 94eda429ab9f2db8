"""WPaxos: wide-area per-object multi-leader Paxos (the port's copy of
``frankenpaxos_tpu/protocols/wpaxos/``).

Per-object leader placement across zones with asymmetric flexible
grid quorums (WPaxos, arxiv 1703.08905; quorum relaxation licensed by
Flexible Paxos, arxiv 1608.06696): commands partition by object into
groups, each group's leader lives in the object's home zone and
commits through a zone-local ``ZoneGrid`` row, and moving an object is
an epoch change (``geo.ObjectEpochStore``) committed by a cross-zone
Phase1.

The leaders count votes on the card with ``quorum_backend="cuda"``
(``geo.GeoQuorumTracker``: K6 per drain chunk, K5 on every watermark
advance). Every message rides ``wire.py``'s codecs. Not ported yet: the
WAL (``wal=`` is refused; ROADMAP.md queue 1 item 4) and admission
control (item 8.1).
"""

from frankenpaxos_tpu_torch.protocols.wpaxos import wire  # noqa: F401  - registers codecs
from frankenpaxos_tpu_torch.protocols.wpaxos.acceptor import WPaxosAcceptor
from frankenpaxos_tpu_torch.protocols.wpaxos.client import (
    WPaxosClient,
    WPaxosClientOptions,
)
from frankenpaxos_tpu_torch.protocols.wpaxos.config import WPaxosConfig
from frankenpaxos_tpu_torch.protocols.wpaxos.leader import (
    WPaxosLeader,
    WPaxosLeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.wpaxos.replica import WPaxosReplica

__all__ = [
    "WPaxosAcceptor",
    "WPaxosClient",
    "WPaxosClientOptions",
    "WPaxosConfig",
    "WPaxosLeader",
    "WPaxosLeaderOptions",
    "WPaxosReplica",
]
