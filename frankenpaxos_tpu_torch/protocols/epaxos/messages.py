"""EPaxos wire messages (reference: epaxos/EPaxos.proto)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance,
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.runtime.transport import Address

# Ballots order lexicographically by (ordering, replica_index)
# (EPaxos.proto:46-52).
Ballot = tuple[int, int]
NULL_BALLOT: Ballot = (-1, -1)


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


class CommandStatus(enum.Enum):
    NOT_SEEN = "not_seen"
    PRE_ACCEPTED = "pre_accepted"
    ACCEPTED = "accepted"
    COMMITTED = "committed"


@dataclasses.dataclass(frozen=True)
class ClientRequest:
    command: Command


@dataclasses.dataclass(frozen=True)
class PreAccept:
    instance: Instance
    ballot: Ballot
    command_or_noop: CommandOrNoop
    sequence_number: int
    dependencies: InstancePrefixSet


@dataclasses.dataclass(frozen=True)
class PreAcceptOk:
    instance: Instance
    ballot: Ballot
    replica_index: int
    sequence_number: int
    dependencies: InstancePrefixSet


@dataclasses.dataclass(frozen=True)
class Accept:
    instance: Instance
    ballot: Ballot
    command_or_noop: CommandOrNoop
    sequence_number: int
    dependencies: InstancePrefixSet


@dataclasses.dataclass(frozen=True)
class AcceptOk:
    instance: Instance
    ballot: Ballot
    replica_index: int


@dataclasses.dataclass(frozen=True)
class Commit:
    instance: Instance
    command_or_noop: CommandOrNoop
    sequence_number: int
    dependencies: InstancePrefixSet


@dataclasses.dataclass(frozen=True)
class Nack:
    instance: Instance
    largest_ballot: Ballot


@dataclasses.dataclass(frozen=True)
class Prepare:
    instance: Instance
    ballot: Ballot


@dataclasses.dataclass(frozen=True)
class PrepareOk:
    ballot: Ballot
    instance: Instance
    replica_index: int
    vote_ballot: Ballot
    status: CommandStatus
    command_or_noop: Optional[CommandOrNoop]
    sequence_number: Optional[int]
    dependencies: Optional[InstancePrefixSet]


@dataclasses.dataclass(frozen=True)
class ClientReply:
    client_pseudonym: int
    client_id: int
    result: bytes
