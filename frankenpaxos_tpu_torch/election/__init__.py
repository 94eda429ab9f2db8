"""Leader election (the port's copy of ``frankenpaxos_tpu/election/``):
the basic ping election and the raft-style one that Fast MultiPaxos
uses."""

from frankenpaxos_tpu_torch.election.basic import (
    ElectionOptions,
    ElectionParticipant,
    ElectionState,
)
from frankenpaxos_tpu_torch.election.raft import (
    RaftElectionOptions,
    RaftElectionParticipant,
)

__all__ = ["ElectionOptions", "ElectionParticipant", "ElectionState",
           "RaftElectionOptions", "RaftElectionParticipant"]
