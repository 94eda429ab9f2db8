"""Read/write quorum systems (Flexible-Paxos style).

Reference behavior: shared/src/main/scala/frankenpaxos/quorums/
(QuorumSystem.scala:16-24, SimpleMajority.scala:19-56, Grid.scala:5-57,
UnanimousWrites.scala:17-57).

Every quorum system factors into a :class:`QuorumSpec` -- a
``[groups x nodes]`` membership-mask matrix plus per-group thresholds and
an any/all combiner -- so that "is this set of responders a quorum?"
becomes a weighted count + compare + reduction per slot column, batched
over a whole window of slots by the CUDA kernels in ops/quorum.py.

This is the port's own copy of ``frankenpaxos_tpu.quorums`` (pure numpy,
same semantics): the port imports nothing of the JAX package.
"""

from frankenpaxos_tpu_torch.quorums.spec import QuorumSpec
from frankenpaxos_tpu_torch.quorums.systems import (
    Grid,
    quorum_system_from_dict,
    quorum_system_to_dict,
    QuorumSystem,
    SimpleMajority,
    UnanimousWrites,
    ZoneGrid,
)

__all__ = [
    "QuorumSpec",
    "QuorumSystem",
    "SimpleMajority",
    "Grid",
    "ZoneGrid",
    "UnanimousWrites",
    "quorum_system_from_dict",
    "quorum_system_to_dict",
]
