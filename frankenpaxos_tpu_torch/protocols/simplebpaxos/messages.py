"""SimpleBPaxos messages and config.

The port's copy of ``frankenpaxos_tpu/protocols/simplebpaxos/
messages.py``. Reference behavior: simplebpaxos/SimpleBPaxos.proto,
Config.scala. Vertex ids are (leader_index, id); dependency sets are
VertexIdPrefixSets -- structurally identical to EPaxos InstancePrefixSets
(per-leader IntPrefixSet columns), which we reuse.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance as VertexId,
    InstancePrefixSet as VertexIdPrefixSet,
)
from frankenpaxos_tpu_torch.runtime.transport import Address


@dataclasses.dataclass(frozen=True)
class SimpleBPaxosConfig:
    f: int
    leader_addresses: tuple
    proposer_addresses: tuple
    dep_service_node_addresses: tuple
    acceptor_addresses: tuple
    replica_addresses: tuple

    @property
    def n(self) -> int:
        return 2 * self.f + 1

    @property
    def quorum_size(self) -> int:
        return self.f + 1

    def check_valid(self) -> None:
        if len(self.leader_addresses) < self.f + 1:
            raise ValueError("need >= f+1 leaders")
        if len(self.proposer_addresses) != len(self.leader_addresses):
            raise ValueError("proposers must mirror leaders")
        if len(self.dep_service_node_addresses) != self.n:
            raise ValueError("need 2f+1 dep service nodes")
        if len(self.acceptor_addresses) != self.n:
            raise ValueError("need 2f+1 acceptors")
        if len(self.replica_addresses) < self.f + 1:
            raise ValueError("need >= f+1 replicas")


@dataclasses.dataclass(frozen=True)
class Command:
    client_address: Address
    client_pseudonym: int
    client_id: int
    command: bytes


@dataclasses.dataclass(frozen=True)
class Noop:
    pass


NOOP = Noop()
CommandOrNoop = Union[Command, Noop]


@dataclasses.dataclass(frozen=True)
class VoteValue:
    command_or_noop: CommandOrNoop
    dependencies: VertexIdPrefixSet


@dataclasses.dataclass(frozen=True)
class ClientRequest:
    command: Command


@dataclasses.dataclass(frozen=True)
class DependencyRequest:
    vertex_id: VertexId
    command: Command


@dataclasses.dataclass(frozen=True)
class DependencyReply:
    vertex_id: VertexId
    dep_service_node_index: int
    dependencies: VertexIdPrefixSet


@dataclasses.dataclass(frozen=True)
class Propose:
    vertex_id: VertexId
    command: Command
    dependencies: VertexIdPrefixSet


@dataclasses.dataclass(frozen=True)
class Phase1a:
    vertex_id: VertexId
    round: int


@dataclasses.dataclass(frozen=True)
class Phase1b:
    vertex_id: VertexId
    acceptor_id: int
    round: int
    vote_round: int
    vote_value: Optional[VoteValue]


@dataclasses.dataclass(frozen=True)
class Phase2a:
    vertex_id: VertexId
    round: int
    vote_value: VoteValue


@dataclasses.dataclass(frozen=True)
class Phase2b:
    vertex_id: VertexId
    acceptor_id: int
    round: int


@dataclasses.dataclass(frozen=True)
class Nack:
    vertex_id: VertexId
    higher_round: int


@dataclasses.dataclass(frozen=True)
class Commit:
    vertex_id: VertexId
    command_or_noop: CommandOrNoop
    dependencies: VertexIdPrefixSet


@dataclasses.dataclass(frozen=True)
class Recover:
    vertex_id: VertexId


@dataclasses.dataclass(frozen=True)
class ClientReply:
    client_pseudonym: int
    client_id: int
    result: bytes
