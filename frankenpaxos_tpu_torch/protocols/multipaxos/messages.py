"""MultiPaxos wire messages (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/messages.py``).

Reference behavior: multipaxos/MultiPaxos.proto (one dataclass per
message; the per-role ``<Role>Inbound`` oneof envelopes are unnecessary
in Python -- receive() dispatches on type). Also the Phase2bVotes
payload packing, the reference's ``native.pack_votes2`` /
``unpack_votes2`` in their numpy form; the roles pack and unpack through
the port's ``native`` module, and the tests hold the two equal.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Union

import numpy as np

from frankenpaxos_tpu_torch.runtime.transport import Address


@dataclasses.dataclass(frozen=True)
class CommandId:
    """Uniquely identifies a command: (client, pseudonym, id)
    (MultiPaxos.proto CommandId)."""

    client_address: Address
    client_pseudonym: int
    client_id: int


@dataclasses.dataclass(frozen=True)
class Command:
    command_id: CommandId
    command: bytes


@dataclasses.dataclass(frozen=True)
class Noop:
    pass


NOOP = Noop()


@dataclasses.dataclass(frozen=True)
class CommandBatch:
    commands: tuple[Command, ...]


# A log entry value: a batch of commands or a noop filler.
CommandBatchOrNoop = Union[CommandBatch, Noop]


# --- client <-> batcher/leader ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientRequest:
    command: Command


@dataclasses.dataclass(frozen=True)
class ClientRequestBatch:
    batch: CommandBatch


@dataclasses.dataclass(frozen=True)
class NotLeaderClient:
    pass


@dataclasses.dataclass(frozen=True)
class LeaderInfoRequestClient:
    pass


@dataclasses.dataclass(frozen=True)
class LeaderInfoReplyClient:
    round: int


@dataclasses.dataclass(frozen=True)
class NotLeaderBatcher:
    client_request_batch: ClientRequestBatch


@dataclasses.dataclass(frozen=True)
class LeaderInfoRequestBatcher:
    pass


@dataclasses.dataclass(frozen=True)
class LeaderInfoReplyBatcher:
    round: int


# --- phase 1 ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase1a:
    round: int
    chosen_watermark: int


@dataclasses.dataclass(frozen=True)
class Phase1bSlotInfo:
    slot: int
    vote_round: int
    vote_value: CommandBatchOrNoop


@dataclasses.dataclass(frozen=True)
class Phase1b:
    group_index: int
    acceptor_index: int
    round: int
    info: tuple[Phase1bSlotInfo, ...]
    # Epoch discovery (reconfig/): every EpochCommit this acceptor has
    # WAL-durably accepted, as a tuple of reconfig.messages.EpochCommit.
    # The Flexible-Paxos intersection condition rides here: a new
    # leader's old-epoch read quorum intersects any activated epoch's
    # commit write quorum, so at least one Phase1b reports it and the
    # leader extends Phase1 to cover the new members.
    epochs: tuple = ()


# --- phase 2 ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase2a:
    slot: int
    round: int
    value: CommandBatchOrNoop


@dataclasses.dataclass(frozen=True)
class Phase2b:
    group_index: int
    acceptor_index: int
    slot: int
    round: int


@dataclasses.dataclass(frozen=True)
class Phase2bRange:
    """One acceptor's votes for a contiguous slot run in one round.

    A TPU-first departure from the reference's per-slot Phase2b
    (MultiPaxos.proto Phase2b): an acceptor that voted a contiguous run
    of Phase2as within one event-loop drain acks them in ONE message,
    making vote traffic (and the ProxyLeader's per-vote Python) scale
    with drains rather than slots -- the shape the vote board's dense
    record_block path consumes directly."""

    group_index: int
    acceptor_index: int
    slot_start_inclusive: int
    slot_end_exclusive: int
    round: int


@dataclasses.dataclass(frozen=True)
class Phase2bVotes:
    """One acceptor's votes for a FRAGMENTED slot set in one drain.

    Thrifty quorum sampling shreds an acceptor's per-drain votes into
    many short runs; rather than one Phase2b(Range) per run, the whole
    drain ships as a single message whose payload is the packed array
    form of :func:`pack_votes2` -- the ProxyLeader unpacks straight into
    the numpy arrays its quorum tracker consumes, so neither side runs
    per-vote Python."""

    group_index: int
    acceptor_index: int
    packed: bytes  # pack_votes2(slots, rounds)


#: One packed vote: int64 slot, int32 round, little-endian, unpadded.
_VOTE2_DTYPE = np.dtype([("slot", "<i8"), ("round", "<i4")])


def pack_votes2(slots: np.ndarray, rounds: np.ndarray) -> bytes:
    """One acceptor's vote batch -> bytes (the Phase2bVotes payload):
    ``[u32 count][count * (i64 slot, i32 round)]``; the acceptor's
    identity rides the message."""
    out = np.empty(len(slots), dtype=_VOTE2_DTYPE)
    out["slot"], out["round"] = slots, rounds
    return struct.pack("<I", len(slots)) + out.tobytes()


def unpack_votes2(buf: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_votes2`: ``(int64 slots, int32 rounds)``.
    Raises ``ValueError`` on a payload shorter than its count claims,
    before allocating anything of the claimed size."""
    if len(buf) < 4:
        raise ValueError("malformed vote batch: short count header")
    (n,) = struct.unpack_from("<I", buf, 0)
    if len(buf) < 4 + _VOTE2_DTYPE.itemsize * n:
        raise ValueError(f"malformed vote batch: count {n} exceeds "
                         f"payload ({len(buf)} bytes)")
    rec = np.frombuffer(buf, dtype=_VOTE2_DTYPE, count=n, offset=4)
    return rec["slot"].copy(), rec["round"].copy()


@dataclasses.dataclass(frozen=True)
class ClientRequestArray:
    """A transport-level coalescing of INDEPENDENT client requests.

    Unlike ClientRequestBatch (the reference's batcher output,
    Batcher.scala:60-90, where the whole batch shares ONE log slot and
    so trades latency for throughput), every command here gets its OWN
    slot at the leader -- the array only exists so a client's burst of
    writes crosses the wire as one message per event-loop drain instead
    of one per command. Latency semantics are identical to sending each
    ClientRequest individually; this is the client edge of the
    drain-granular run pipeline (Phase2aRun/ChosenRun)."""

    commands: tuple  # tuple[Command, ...]


@dataclasses.dataclass(frozen=True)
class Phase2aRun:
    """Phase2as for a CONTIGUOUS slot run in one round, one message.

    The proposal-side twin of Phase2bRange: the reference proposes one
    Phase2a per slot (Leader.scala:331-408, one protobuf + one send
    each); a leader that assigned a whole drain's commands contiguous
    slots proposes them in ONE message whose values array lines up with
    [start_slot, start_slot + len(values)). Acceptors store the run as
    one O(1) record and ack it with one Phase2bRange -- per-slot Python
    disappears from the propose/ack path entirely."""

    start_slot: int
    round: int
    values: tuple  # tuple[CommandBatchOrNoop, ...], one per slot


@dataclasses.dataclass(frozen=True)
class ChosenRun:
    """Chosen values for a contiguous slot run, one message per replica
    per drain (vs one Chosen per slot, Replica.scala:572-628)."""

    start_slot: int
    values: tuple  # tuple[CommandBatchOrNoop, ...], one per slot


@dataclasses.dataclass(frozen=True)
class ClientReplyArray:
    """One replica's drain of replies to ONE client, coalesced.

    Entries are (pseudonym, client_id, slot, result) -- the client
    address rides the wire header (the message is addressed to it), so
    per-entry addresses would be dead bytes."""

    entries: tuple  # tuple[(int, int, int, bytes), ...]


@dataclasses.dataclass(frozen=True)
class Chosen:
    slot: int
    value: CommandBatchOrNoop


@dataclasses.dataclass(frozen=True)
class Nack:
    round: int


@dataclasses.dataclass(frozen=True)
class ChosenWatermark:
    slot: int


@dataclasses.dataclass(frozen=True)
class Recover:
    slot: int


# --- replies ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientReply:
    command_id: CommandId
    slot: int
    result: bytes


@dataclasses.dataclass(frozen=True)
class ClientReplyBatch:
    batch: tuple[ClientReply, ...]


# --- reads ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaxSlotRequest:
    command_id: CommandId


@dataclasses.dataclass(frozen=True)
class MaxSlotReply:
    command_id: CommandId
    group_index: int
    acceptor_index: int
    slot: int


@dataclasses.dataclass(frozen=True)
class ReadRequest:
    slot: int
    command: Command


@dataclasses.dataclass(frozen=True)
class SequentialReadRequest:
    slot: int
    command: Command


@dataclasses.dataclass(frozen=True)
class EventualReadRequest:
    command: Command


@dataclasses.dataclass(frozen=True)
class ReadReply:
    command_id: CommandId
    slot: int
    result: bytes


@dataclasses.dataclass(frozen=True)
class ReadReplyBatch:
    batch: tuple[ReadReply, ...]


@dataclasses.dataclass(frozen=True)
class ReadRequestBatch:
    slot: int
    commands: tuple[Command, ...]


@dataclasses.dataclass(frozen=True)
class SequentialReadRequestBatch:
    slot: int
    commands: tuple[Command, ...]


@dataclasses.dataclass(frozen=True)
class EventualReadRequestBatch:
    commands: tuple[Command, ...]


# --- read batcher -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchMaxSlotRequest:
    read_batcher_index: int
    read_batcher_id: int


@dataclasses.dataclass(frozen=True)
class BatchMaxSlotReply:
    read_batcher_index: int
    read_batcher_id: int
    group_index: int
    acceptor_index: int
    slot: int
