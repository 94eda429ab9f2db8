"""Fixed-layout binary codecs for the MultiPaxos hot-path messages (the
port's copy of ``frankenpaxos_tpu/protocols/multipaxos/wire.py``; the
bytes are the reference's, so the two packages talk over one socket).

The reference's every message is a protobuf with a per-role oneof
envelope (ProtoSerializer.scala:3-11, multipaxos/MultiPaxos.proto:
489-588). Here the hot-path messages -- the ones a steady-state write
touches: ClientRequest -> Phase2a -> Phase2b -> Chosen -> ClientReply,
plus the gossip/watermark traffic around them -- get hand-laid-out
binary codecs registered with the runtime's HybridSerializer (see
runtime/serializer.py); cold-path messages (Phase1*, reads,
reconfiguration) stay pickled. Layouts are little-endian fixed-width
structs with length-prefixed strings/bytes: decodable from any
language, no code execution on decode, and several times faster than
pickling dataclasses.

Importing this module (protocols.multipaxos does) registers the codecs
process-wide; both sides of every channel share the schema.
"""

from __future__ import annotations

import dataclasses
import struct

from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    BatchMaxSlotReply,
    BatchMaxSlotRequest,
    Chosen,
    ChosenRun,
    ChosenWatermark,
    ClientReply,
    ClientReplyArray,
    ClientReplyBatch,
    ClientRequest,
    ClientRequestArray,
    ClientRequestBatch,
    Command,
    CommandBatch,
    CommandId,
    EventualReadRequest,
    EventualReadRequestBatch,
    LeaderInfoReplyBatcher,
    LeaderInfoReplyClient,
    LeaderInfoRequestBatcher,
    LeaderInfoRequestClient,
    MaxSlotReply,
    MaxSlotRequest,
    Nack,
    NOOP,
    Noop,
    NotLeaderBatcher,
    NotLeaderClient,
    Phase1a,
    Phase1b,
    Phase1bSlotInfo,
    Phase2a,
    Phase2aRun,
    Phase2b,
    Phase2bRange,
    Phase2bVotes,
    ReadReply,
    ReadReplyBatch,
    ReadRequest,
    ReadRequestBatch,
    Recover,
    SequentialReadRequest,
    SequentialReadRequestBatch,
)
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")
_I32 = struct.Struct("<i")
_QI = struct.Struct("<qi")
_QQII = struct.Struct("<qqii")


def _put_bytes(out: bytearray, data: bytes) -> None:
    out += _I32.pack(len(data))
    out += data


def _take_bytes(buf: bytes, at: int) -> tuple[bytes, int]:
    (n,) = _I32.unpack_from(buf, at)
    at += 4
    return buf[at:at + n], at + n


def _put_address(out: bytearray, address) -> None:
    """Addresses are (host, port) tuples on TCP, plain strings in sims;
    anything else (exotic sim addresses) rides a pickled escape hatch."""
    if (isinstance(address, tuple) and len(address) == 2
            and isinstance(address[0], str)
            and isinstance(address[1], int)):
        host, port = address
        out.append(1)
        _put_bytes(out, host.encode())
        out += _I32.pack(port)
    elif isinstance(address, str):
        out.append(0)
        _put_bytes(out, address.encode())
    else:
        from frankenpaxos_tpu_torch.runtime import serializer

        out.append(2)
        _put_bytes(out, serializer.guarded_pickle_dumps(address, "address"))


def _take_address(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    raw, at = _take_bytes(buf, at)
    if kind == 1:
        (port,) = _I32.unpack_from(buf, at)
        return (raw.decode(), port), at + 4
    if kind == 2:
        from frankenpaxos_tpu_torch.runtime import serializer

        return serializer.guarded_pickle_loads(raw, "address"), at
    return raw.decode(), at


def _put_cid(out: bytearray, cid: CommandId) -> None:
    _put_address(out, cid.client_address)
    out += _I64I64.pack(cid.client_pseudonym, cid.client_id)


def _take_cid(buf: bytes, at: int) -> tuple[CommandId, int]:
    address, at = _take_address(buf, at)
    pseudonym, id = _I64I64.unpack_from(buf, at)
    return CommandId(address, pseudonym, id), at + 16


def _put_command(out: bytearray, command: Command) -> None:
    _put_cid(out, command.command_id)
    _put_bytes(out, command.command)


def _take_command(buf: bytes, at: int) -> tuple[Command, int]:
    cid, at = _take_cid(buf, at)
    payload, at = _take_bytes(buf, at)
    return Command(cid, payload), at


def _put_value(out: bytearray, value) -> None:
    """CommandBatchOrNoop."""
    if isinstance(value, Noop):
        out.append(0)
        return
    out.append(1)
    out += _I32.pack(len(value.commands))
    for command in value.commands:
        _put_command(out, command)


def _take_value(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == 0:
        return NOOP, at
    (n,) = _I32.unpack_from(buf, at)
    at += 4
    commands = []
    for _ in range(n):
        command, at = _take_command(buf, at)
        commands.append(command)
    return CommandBatch(tuple(commands)), at


def encode_value(value) -> bytes:
    """One CommandBatchOrNoop as a standalone byte segment (the WAL's
    WalVote payload; same layout Phase2a carries on the wire)."""
    out = bytearray()
    _put_value(out, value)
    return bytes(out)


def decode_value(data: bytes):
    value, _ = _take_value(data, 0)
    return value


def encode_value_array(values) -> bytes:
    """A value array as a standalone byte segment (the WAL's
    WalVoteRun/WalChosenRun payload). Encoding a LazyValueArray -- the
    form runs arrive in -- is a raw copy: logging a drain's Phase2aRun
    never re-materializes its values."""
    out = bytearray()
    _put_value_array(out, values)
    return bytes(out)


def decode_value_array(data: bytes) -> LazyValueArray:
    values, _ = _take_value_array(data, 0)
    return values


class Phase2bCodec(MessageCodec):
    """The single hottest message (2f+1 per slot)."""

    message_type = Phase2b
    tag = 1

    def encode(self, out, message):
        out += _QQII.pack(message.slot, message.round,
                          message.group_index, message.acceptor_index)

    def decode(self, buf, at):
        slot, round, group, acceptor = _QQII.unpack_from(buf, at)
        return Phase2b(group_index=group, acceptor_index=acceptor,
                       slot=slot, round=round), at + 24


class Phase2aCodec(MessageCodec):
    message_type = Phase2a
    tag = 2

    def encode(self, out, message):
        out += _I64I64.pack(message.slot, message.round)
        _put_value(out, message.value)

    def decode(self, buf, at):
        slot, round = _I64I64.unpack_from(buf, at)
        value, at = _take_value(buf, at + 16)
        return Phase2a(slot=slot, round=round, value=value), at


class ChosenCodec(MessageCodec):
    message_type = Chosen
    tag = 3

    def encode(self, out, message):
        out += _I64.pack(message.slot)
        _put_value(out, message.value)

    def decode(self, buf, at):
        (slot,) = _I64.unpack_from(buf, at)
        value, at = _take_value(buf, at + 8)
        return Chosen(slot=slot, value=value), at


class ClientRequestCodec(MessageCodec):
    message_type = ClientRequest
    tag = 4

    def encode(self, out, message):
        _put_command(out, message.command)

    def decode(self, buf, at):
        command, at = _take_command(buf, at)
        return ClientRequest(command), at


class ClientRequestBatchCodec(MessageCodec):
    message_type = ClientRequestBatch
    tag = 5

    def encode(self, out, message):
        _put_value(out, message.batch)

    def decode(self, buf, at):
        batch, at = _take_value(buf, at)
        return ClientRequestBatch(batch), at


class ClientReplyCodec(MessageCodec):
    message_type = ClientReply
    tag = 6

    def encode(self, out, message):
        _put_reply(out, message)

    def decode(self, buf, at):
        return _take_reply(buf, at, ClientReply)


class ChosenWatermarkCodec(MessageCodec):
    message_type = ChosenWatermark
    tag = 7

    def encode(self, out, message):
        out += _I64.pack(message.slot)

    def decode(self, buf, at):
        (slot,) = _I64.unpack_from(buf, at)
        return ChosenWatermark(slot=slot), at + 8


_P2BR = struct.Struct("<qqqii")  # start, end, round, group, acceptor


class Phase2bRangeCodec(MessageCodec):
    message_type = Phase2bRange
    tag = 13

    def encode(self, out, message):
        out += _P2BR.pack(message.slot_start_inclusive,
                          message.slot_end_exclusive, message.round,
                          message.group_index, message.acceptor_index)

    def decode(self, buf, at):
        start, end, round, group, acceptor = _P2BR.unpack_from(buf, at)
        return Phase2bRange(group_index=group, acceptor_index=acceptor,
                            slot_start_inclusive=start,
                            slot_end_exclusive=end,
                            round=round), at + _P2BR.size


class Phase2bVotesCodec(MessageCodec):
    message_type = Phase2bVotes
    # 114: payload records widened from (i32 slot, i32 round) to
    # (i64 slot, i32 round). The tag bump makes any decoder that only
    # knows the 8-byte layout drop the frame loudly (unknown tag)
    # instead of silently mis-decoding 12-byte records.
    tag = 114

    def encode(self, out, message):
        out += _I32.pack(message.group_index)
        out += _I32.pack(message.acceptor_index)
        _put_bytes(out, message.packed)

    def decode(self, buf, at):
        (group,) = _I32.unpack_from(buf, at)
        (acceptor,) = _I32.unpack_from(buf, at + 4)
        packed, at = _take_bytes(buf, at + 8)
        # Validate the packed payload's count against its length HERE,
        # inside decode, so a malformed/hostile payload raises in the
        # transport's corrupt-frame guard (clean log-and-drop) instead
        # of inside the ProxyLeader's handler -- and before
        # unpack_votes2 sizes any allocation by the claimed count.
        from frankenpaxos_tpu_torch import native

        native.check_votes2(packed)
        return Phase2bVotes(group_index=group, acceptor_index=acceptor,
                            packed=packed), at


# --- run-pipeline array codecs ---------------------------------------------
# Structure-of-arrays layouts: client addresses are hoisted into a
# per-message dedup TABLE and commands reference them by index, so a
# 1024-command run encodes its (usually one) client address once, not
# 1024 times. Address encode/decode was the dominant per-command
# serialization cost in the AoS form. Decoding yields a
# LazyValueArray: hot-path consumers that only forward or store the
# values (ProxyLeader, Acceptor) never materialize Command objects --
# re-encoding a lazy array is a raw bytes copy.

_CMD_ENTRY = struct.Struct("<iqq")  # address index, pseudonym, client id


class LazyValueArray:
    """Decode-on-demand view over an encoded value array segment.

    Iteration/indexing (Replica execution, Phase1b recovery) decodes
    the whole segment once and caches it; forwarding (ProxyLeader ->
    acceptors, ChosenRun emission of a full run) re-encodes by copying
    ``raw`` without ever parsing it."""

    __slots__ = ("raw", "n", "_values")

    def __init__(self, raw: bytes, n: int):
        self.raw = raw
        self.n = n
        self._values = None

    def _decode(self) -> tuple:
        if self._values is None:
            try:
                self._values = _parse_value_array(self.raw, 0, self.n)[0]
            except (struct.error, IndexError, KeyError,
                    UnicodeDecodeError, OverflowError, MemoryError) as e:
                # The lazy twin of HybridSerializer.from_bytes'
                # containment normalization: corruption surfacing at
                # first ACCESS still comes out as ValueError.
                raise ValueError(
                    f"corrupt value array (n={self.n}): {e}") from e
        return self._values

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(self._decode())

    def __getitem__(self, i):
        return self._decode()[i]

    def __eq__(self, other):
        if isinstance(other, LazyValueArray):
            return self._decode() == other._decode()
        if isinstance(other, tuple):
            return self._decode() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"LazyValueArray(n={self.n})"


def _put_value_array(out: bytearray, values) -> None:
    """count + byte length + [address table | per-value body]. The byte
    length lets decode wrap the segment lazily without parsing it."""
    if isinstance(values, LazyValueArray):
        out += _I32.pack(values.n)
        out += _I32.pack(len(values.raw))
        out += values.raw
        return
    table: dict = {}
    table_bytes = bytearray()
    body = bytearray()
    for value in values:
        if isinstance(value, Noop):
            body.append(0)
            continue
        body.append(1)
        body += _I32.pack(len(value.commands))
        for command in value.commands:
            cid = command.command_id
            idx = table.get(cid.client_address)
            if idx is None:
                idx = len(table)
                table[cid.client_address] = idx
                _put_address(table_bytes, cid.client_address)
            body += _CMD_ENTRY.pack(idx, cid.client_pseudonym,
                                    cid.client_id)
            _put_bytes(body, command.command)
    out += _I32.pack(len(values))
    out += _I32.pack(4 + len(table_bytes) + len(body))
    out += _I32.pack(len(table))
    out += table_bytes
    out += body


_I32I32 = struct.Struct("<ii")


def _take_value_array(buf: bytes, at: int) -> tuple:
    """-> (LazyValueArray, next offset).

    The count and byte length are validated HERE, inside codec decode,
    so a hostile frame claiming 2^30 values raises in the transport's
    corrupt-frame guard before any consumer sizes an allocation by the
    count (every value costs >= 1 body byte, so n is bounded by the
    actual payload). CONTENT parsing stays deferred: a length-valid but
    content-corrupt segment surfaces as ValueError at first access in
    the consuming actor -- the same trust level as the pickled cold
    path in this single-trust-domain deployment model."""
    n, nbytes = _I32I32.unpack_from(buf, at)
    at += 8
    if n < 0 or nbytes < 4 or at + nbytes > len(buf) or n + 4 > nbytes:
        raise ValueError(
            f"malformed value array: count {n} / length {nbytes} "
            f"exceed payload ({len(buf) - at} bytes left)")
    return LazyValueArray(buf[at:at + nbytes], n), at + nbytes


def _parse_value_array(buf: bytes, at: int, n: int) -> tuple:
    (t,) = _I32.unpack_from(buf, at)
    at += 4
    addresses = []
    for _ in range(t):
        address, at = _take_address(buf, at)
        addresses.append(address)
    values = []
    for _ in range(n):
        kind = buf[at]
        at += 1
        if kind == 0:
            values.append(NOOP)
            continue
        (k,) = _I32.unpack_from(buf, at)
        at += 4
        commands = []
        for _ in range(k):
            idx, pseudonym, id = _CMD_ENTRY.unpack_from(buf, at)
            payload, at = _take_bytes(buf, at + 20)
            commands.append(Command(
                CommandId(addresses[idx], pseudonym, id), payload))
        values.append(CommandBatch(tuple(commands)))
    return tuple(values), at


class ClientRequestArrayCodec(MessageCodec):
    """All commands in one array come from ONE client by construction
    (the client stages its own writes), so the address is encoded once
    for the whole message."""

    message_type = ClientRequestArray
    tag = 115

    def encode(self, out, message):
        _put_address(out, message.commands[0].command_id.client_address)
        out += _I32.pack(len(message.commands))
        for command in message.commands:
            cid = command.command_id
            out += _I64I64.pack(cid.client_pseudonym, cid.client_id)
            _put_bytes(out, command.command)

    def decode(self, buf, at):
        address, at = _take_address(buf, at)
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        commands = []
        for _ in range(n):
            pseudonym, id = _I64I64.unpack_from(buf, at)
            payload, at = _take_bytes(buf, at + 16)
            commands.append(Command(
                CommandId(address, pseudonym, id), payload))
        return ClientRequestArray(commands=tuple(commands)), at


class Phase2aRunCodec(MessageCodec):
    message_type = Phase2aRun
    tag = 116

    def encode(self, out, message):
        out += _I64I64.pack(message.start_slot, message.round)
        _put_value_array(out, message.values)

    def decode(self, buf, at):
        start, round = _I64I64.unpack_from(buf, at)
        values, at = _take_value_array(buf, at + 16)
        return Phase2aRun(start_slot=start, round=round,
                          values=values), at


class ChosenRunCodec(MessageCodec):
    message_type = ChosenRun
    tag = 117

    def encode(self, out, message):
        out += _I64.pack(message.start_slot)
        _put_value_array(out, message.values)

    def decode(self, buf, at):
        (start,) = _I64.unpack_from(buf, at)
        values, at = _take_value_array(buf, at + 8)
        return ChosenRun(start_slot=start, values=values), at


_REPLY_ENTRY = struct.Struct("<qqq")  # pseudonym, client_id, slot


class ClientReplyArrayCodec(MessageCodec):
    message_type = ClientReplyArray
    tag = 118

    def encode(self, out, message):
        out += _I32.pack(len(message.entries))
        for pseudonym, client_id, slot, result in message.entries:
            out += _REPLY_ENTRY.pack(pseudonym, client_id, slot)
            _put_bytes(out, result)

    def decode(self, buf, at):
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        entries = []
        for _ in range(n):
            pseudonym, client_id, slot = _REPLY_ENTRY.unpack_from(buf, at)
            result, at = _take_bytes(buf, at + 24)
            entries.append((pseudonym, client_id, slot, result))
        return ClientReplyArray(entries=tuple(entries)), at


# --- read-path codecs -------------------------------------------------------
# The read hot path (the Evelyn read-scale mechanism): MaxSlotRequest ->
# MaxSlotReply quorum, then a Read*Request to one replica answered with
# a ReadReplyBatch. These carry every benchmarked read, so they get
# fixed layouts like the write path; the read-BATCHER shapes
# (ReadRequestBatch et al.) stay pickled until a deployment exercises
# them.


class MaxSlotRequestCodec(MessageCodec):
    message_type = MaxSlotRequest
    tag = 119

    def encode(self, out, message):
        _put_cid(out, message.command_id)

    def decode(self, buf, at):
        cid, at = _take_cid(buf, at)
        return MaxSlotRequest(command_id=cid), at


_IIQ = struct.Struct("<iiq")


class MaxSlotReplyCodec(MessageCodec):
    message_type = MaxSlotReply
    tag = 120

    def encode(self, out, message):
        _put_cid(out, message.command_id)
        out += _IIQ.pack(message.group_index, message.acceptor_index,
                         message.slot)

    def decode(self, buf, at):
        cid, at = _take_cid(buf, at)
        group, acceptor, slot = _IIQ.unpack_from(buf, at)
        return MaxSlotReply(command_id=cid, group_index=group,
                            acceptor_index=acceptor,
                            slot=slot), at + _IIQ.size


class _SlotCommandCodec(MessageCodec):
    """Shared layout for the (slot, command) read requests."""

    def encode(self, out, message):
        out += _I64.pack(message.slot)
        _put_command(out, message.command)

    def decode(self, buf, at):
        (slot,) = _I64.unpack_from(buf, at)
        command, at = _take_command(buf, at + 8)
        return self.message_type(slot=slot, command=command), at


class ReadRequestCodec(_SlotCommandCodec):
    message_type = ReadRequest
    tag = 121


class SequentialReadRequestCodec(_SlotCommandCodec):
    message_type = SequentialReadRequest
    tag = 122


class EventualReadRequestCodec(MessageCodec):
    message_type = EventualReadRequest
    tag = 123

    def encode(self, out, message):
        _put_command(out, message.command)

    def decode(self, buf, at):
        command, at = _take_command(buf, at)
        return EventualReadRequest(command=command), at


def _put_reply(out: bytearray, reply) -> None:
    """ReadReply and ClientReply share the (command_id, slot, result)
    shape."""
    _put_cid(out, reply.command_id)
    out += _I64.pack(reply.slot)
    _put_bytes(out, reply.result)


def _take_reply(buf: bytes, at: int, cls) -> tuple:
    cid, at = _take_cid(buf, at)
    (slot,) = _I64.unpack_from(buf, at)
    result, at = _take_bytes(buf, at + 8)
    return cls(command_id=cid, slot=slot, result=result), at


class _ReplyBatchCodec(MessageCodec):
    """Shared layout for the (count + replies) batch messages."""

    reply_type: type

    def encode(self, out, message):
        out += _I32.pack(len(message.batch))
        for reply in message.batch:
            _put_reply(out, reply)

    def decode(self, buf, at):
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        batch = []
        for _ in range(n):
            reply, at = _take_reply(buf, at, self.reply_type)
            batch.append(reply)
        return self.message_type(batch=tuple(batch)), at


class ReadReplyBatchCodec(_ReplyBatchCodec):
    message_type = ReadReplyBatch
    reply_type = ReadReply
    tag = 124


class ClientReplyBatchCodec(_ReplyBatchCodec):
    message_type = ClientReplyBatch
    reply_type = ClientReply
    tag = 125


# The read-BATCHER path and the leader-change client redirects, on the
# extended tag page (133+; primary 1..127 is fully allocated). paxflow
# FLOW405 surfaced the batch shapes: they are named in serve/lanes.py's
# client lane, but the frame-layer classifier is TAG-based, so without
# codecs their pickled frames rode the control lane and could never be
# shed. The redirect shapes (NotLeader*/LeaderInfo*) are hot exactly
# during failover storms, when every queued client op resends at once.


class _CommandsBatchCodec(MessageCodec):
    """Shared layout for the (slot, commands) read request batches."""

    def encode(self, out, message):
        out += _I64.pack(message.slot)
        out += _I32.pack(len(message.commands))
        for command in message.commands:
            _put_command(out, command)

    def decode(self, buf, at):
        (slot,) = _I64.unpack_from(buf, at)
        (n,) = _I32.unpack_from(buf, at + 8)
        at += 12
        commands = []
        for _ in range(n):
            command, at = _take_command(buf, at)
            commands.append(command)
        return self.message_type(slot=slot,
                                 commands=tuple(commands)), at


class ReadRequestBatchCodec(_CommandsBatchCodec):
    message_type = ReadRequestBatch
    tag = 133


class SequentialReadRequestBatchCodec(_CommandsBatchCodec):
    message_type = SequentialReadRequestBatch
    tag = 134


class EventualReadRequestBatchCodec(MessageCodec):
    message_type = EventualReadRequestBatch
    tag = 135

    def encode(self, out, message):
        out += _I32.pack(len(message.commands))
        for command in message.commands:
            _put_command(out, command)

    def decode(self, buf, at):
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        commands = []
        for _ in range(n):
            command, at = _take_command(buf, at)
            commands.append(command)
        return EventualReadRequestBatch(commands=tuple(commands)), at


class BatchMaxSlotRequestCodec(MessageCodec):
    message_type = BatchMaxSlotRequest
    tag = 136

    def encode(self, out, message):
        out += _QI.pack(message.read_batcher_id,
                        message.read_batcher_index)

    def decode(self, buf, at):
        batcher_id, index = _QI.unpack_from(buf, at)
        return BatchMaxSlotRequest(read_batcher_index=index,
                                   read_batcher_id=batcher_id), at + 12


_QIIIQ = struct.Struct("<qiiiq")


class BatchMaxSlotReplyCodec(MessageCodec):
    message_type = BatchMaxSlotReply
    tag = 137

    def encode(self, out, message):
        out += _QIIIQ.pack(message.read_batcher_id,
                            message.read_batcher_index,
                            message.group_index,
                            message.acceptor_index, message.slot)

    def decode(self, buf, at):
        batcher_id, index, group, acceptor, slot = \
            _QIIIQ.unpack_from(buf, at)
        return BatchMaxSlotReply(read_batcher_index=index,
                                 read_batcher_id=batcher_id,
                                 group_index=group,
                                 acceptor_index=acceptor,
                                 slot=slot), at + _QIIIQ.size


class _EmptyCodec(MessageCodec):
    """Zero-field redirect markers: the tag IS the message."""

    def encode(self, out, message):
        pass

    def decode(self, buf, at):
        return self.message_type(), at


class NotLeaderClientCodec(_EmptyCodec):
    message_type = NotLeaderClient
    tag = 138


class LeaderInfoRequestClientCodec(_EmptyCodec):
    message_type = LeaderInfoRequestClient
    tag = 139


class LeaderInfoReplyClientCodec(MessageCodec):
    message_type = LeaderInfoReplyClient
    tag = 140

    def encode(self, out, message):
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        return LeaderInfoReplyClient(round=round), at + 8


class NotLeaderBatcherCodec(MessageCodec):
    message_type = NotLeaderBatcher
    tag = 141

    def encode(self, out, message):
        _put_value(out, message.client_request_batch.batch)

    def decode(self, buf, at):
        batch, at = _take_value(buf, at)
        return NotLeaderBatcher(
            client_request_batch=ClientRequestBatch(batch)), at


class LeaderInfoRequestBatcherCodec(_EmptyCodec):
    message_type = LeaderInfoRequestBatcher
    tag = 142


class LeaderInfoReplyBatcherCodec(MessageCodec):
    message_type = LeaderInfoReplyBatcher
    tag = 143

    def encode(self, out, message):
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        return LeaderInfoReplyBatcher(round=round), at + 8


# --- paxwire ack coalescing (tag 152) ---------------------------------------
# A drain's per-message Phase2b stream from one acceptor to one proxy
# leader merges into ONE frame of run-granular ack ranges at the
# TRANSPORT's flush (runtime/paxwire.py coalescer registry): 25 bytes
# per ack become ~32 bytes per contiguous RUN. Receivers expand the
# batch back into the messages the ProxyLeader already handles --
# width-1 entries as plain Phase2b (its never-sent-a-Phase2a tripwire
# stays armed), wider runs as Phase2bRange.

_ACK_RANGE = struct.Struct("<qqqii")  # start, end, round, group, acceptor


@dataclasses.dataclass(frozen=True)
class Phase2bAckBatch:
    """Coalesced Phase2b acks: (start, end, round, group, acceptor)
    runs, in first-ack order."""

    ranges: tuple

    def __wire_expand__(self, serializer):
        for start, end, round, group, acceptor in self.ranges:
            if end - start == 1:
                yield Phase2b(group_index=group, acceptor_index=acceptor,
                              slot=start, round=round)
            else:
                yield Phase2bRange(group_index=group,
                                   acceptor_index=acceptor,
                                   slot_start_inclusive=start,
                                   slot_end_exclusive=end, round=round)


class Phase2bAckBatchCodec(MessageCodec):
    message_type = Phase2bAckBatch
    tag = 152
    # Encoded by the transport's flush-time coalescer, decoded and
    # expanded by the transport -- no role send site (paxflow FLOW403
    # skips transport_layer codecs).
    transport_layer = True

    def encode(self, out, message):
        out += _I32.pack(len(message.ranges))
        for entry in message.ranges:
            out += _ACK_RANGE.pack(*entry)

    def decode(self, buf, at):
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        if n < 0 or at + n * _ACK_RANGE.size > len(buf):
            raise ValueError(
                f"malformed ack batch: count {n} exceeds payload")
        ranges = []
        for _ in range(n):
            ranges.append(_ACK_RANGE.unpack_from(buf, at))
            at += _ACK_RANGE.size
        return Phase2bAckBatch(ranges=tuple(ranges)), at


def _coalesce_phase2b(payloads: list):
    """paxwire coalescer for runs of tag-1 (Phase2b) payloads: merge
    slot-contiguous same-(round, group, acceptor) acks into ranges.
    Acks are commutative on the quorum trackers, so reordering inside
    the run is safe. Returns None (decline -> generic batch frame) on
    any unexpected layout."""
    acks = []
    for payload in payloads:
        if len(payload) != 25 or payload[0] != Phase2bCodec.tag:
            return None
        acks.append(_QQII.unpack_from(payload, 1))
    # Sort by (round, group, acceptor, slot); emit contiguous runs.
    acks.sort(key=lambda a: (a[1], a[2], a[3], a[0]))
    ranges = []
    for slot, round, group, acceptor in acks:
        if ranges:
            start, end, pround, pgroup, pacceptor = ranges[-1]
            if (pround, pgroup, pacceptor) == (round, group, acceptor):
                if slot == end:
                    ranges[-1] = (start, end + 1, pround, pgroup,
                                  pacceptor)
                    continue
                if slot < end:  # duplicate ack; keep it a lone entry
                    ranges.append((slot, slot + 1, round, group,
                                   acceptor))
                    continue
        ranges.append((slot, slot + 1, round, group, acceptor))
    out = bytearray((0, Phase2bAckBatchCodec.tag - 128))
    Phase2bAckBatchCodec().encode(
        out, Phase2bAckBatch(ranges=tuple(ranges)))
    return bytes(out)


def _coalesce_client_replies(payloads: list):
    """paxwire coalescer for runs of tag-118 (ClientReplyArray)
    payloads: one drain can queue several reply arrays to one client
    (one per ChosenRun executed that pass); merge them so the drain's
    replies to that client flush as ONE frame -- and the client's
    reply sink scans ONE column batch (ingest/columns.py
    ReplyColumns). Entries are independent acks, so concatenation in
    send order preserves semantics. Returns None (decline) on any
    unexpected layout."""
    total = 0
    for payload in payloads:
        if len(payload) < 5 or payload[0] != ClientReplyArrayCodec.tag:
            return None
        (n,) = _I32.unpack_from(payload, 1)
        if n < 0:
            return None
        total += n
    out = bytearray((ClientReplyArrayCodec.tag,))
    out += _I32.pack(total)
    for payload in payloads:
        out += payload[5:]
    return bytes(out)


def _register_coalescers() -> None:
    from frankenpaxos_tpu_torch.runtime import paxwire

    paxwire.register_coalescer(Phase2bCodec.tag, _coalesce_phase2b)
    paxwire.register_coalescer(ClientReplyArrayCodec.tag,
                               _coalesce_client_replies)


# --- cold-path codecs (extended tags 153-156) -------------------------------
# The failover path: Phase1a/Phase1b/Nack/Recover are per-leader-change
# rather than per-command, but a failover STORM is exactly when the
# wire is busiest -- and the paxwire batch encoder can only vectorize
# messages with fixed layouts.


class Phase1aCodec(MessageCodec):
    message_type = Phase1a
    tag = 153

    def encode(self, out, message):
        out += _I64I64.pack(message.round, message.chosen_watermark)

    def decode(self, buf, at):
        round, watermark = _I64I64.unpack_from(buf, at)
        return Phase1a(round=round, chosen_watermark=watermark), at + 16


def _put_vote_value(out: bytearray, value) -> None:
    """A Phase1b vote value: the ordinary CommandBatchOrNoop layout
    (kinds 0/1), with a pickled escape hatch (kind 2) for the exotic
    values sim harnesses store in acceptors (the same trade-off as the
    address escape hatch; Phase1b is per-failover, never hot)."""
    if isinstance(value, Noop):
        out.append(0)
        return
    if isinstance(value, CommandBatch):
        tmp = bytearray()
        try:
            _put_value(tmp, value)
        except (AttributeError, TypeError, struct.error):
            pass  # toy commands: fall through to the escape hatch
        else:
            out += tmp
            return
    from frankenpaxos_tpu_torch.runtime import serializer

    out.append(2)
    _put_bytes(out, serializer.guarded_pickle_dumps(
        value, "phase1b vote value"))


def _take_vote_value(buf: bytes, at: int):
    if buf[at] == 2:
        from frankenpaxos_tpu_torch.runtime import serializer

        raw, at = _take_bytes(buf, at + 1)
        return serializer.guarded_pickle_loads(
            bytes(raw), "phase1b vote value"), at
    return _take_value(buf, at)


class Phase1bCodec(MessageCodec):
    """Votes ride (slot, vote_round, value) entries; discovered epochs
    ride as length-prefixed sub-frames through the serializer (the
    reconfig EpochCommit codec, tag 129)."""

    message_type = Phase1b
    tag = 154

    def encode(self, out, message):
        from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER

        out += _I32.pack(message.group_index)
        out += _I32.pack(message.acceptor_index)
        out += _I64.pack(message.round)
        out += _I32.pack(len(message.info))
        for info in message.info:
            out += _I64I64.pack(info.slot, info.vote_round)
            _put_vote_value(out, info.vote_value)
        out += _I32.pack(len(message.epochs))
        for epoch in message.epochs:
            _put_bytes(out, DEFAULT_SERIALIZER.to_bytes(epoch))

    def decode(self, buf, at):
        from frankenpaxos_tpu_torch.runtime.serializer import DEFAULT_SERIALIZER

        group, acceptor = _I32I32.unpack_from(buf, at)
        (round,) = _I64.unpack_from(buf, at + 8)
        (n,) = _I32.unpack_from(buf, at + 16)
        at += 20
        info = []
        for _ in range(n):
            slot, vote_round = _I64I64.unpack_from(buf, at)
            value, at = _take_vote_value(buf, at + 16)
            info.append(Phase1bSlotInfo(slot=slot, vote_round=vote_round,
                                        vote_value=value))
        (k,) = _I32.unpack_from(buf, at)
        at += 4
        epochs = []
        for _ in range(k):
            raw, at = _take_bytes(buf, at)
            epochs.append(DEFAULT_SERIALIZER.from_bytes(bytes(raw)))
        return Phase1b(group_index=group, acceptor_index=acceptor,
                       round=round, info=tuple(info),
                       epochs=tuple(epochs)), at


class NackCodec(MessageCodec):
    message_type = Nack
    tag = 155

    def encode(self, out, message):
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        return Nack(round=round), at + 8


class RecoverCodec(MessageCodec):
    message_type = Recover
    tag = 156

    def encode(self, out, message):
        out += _I64.pack(message.slot)

    def decode(self, buf, at):
        (slot,) = _I64.unpack_from(buf, at)
        return Recover(slot=slot), at + 8


for _codec in (Phase2bCodec(), Phase2aCodec(), ChosenCodec(),
               ClientRequestCodec(), ClientRequestBatchCodec(),
               ClientReplyCodec(), ChosenWatermarkCodec(),
               Phase2bRangeCodec(), Phase2bVotesCodec(),
               ClientRequestArrayCodec(), Phase2aRunCodec(),
               ChosenRunCodec(), ClientReplyArrayCodec(),
               MaxSlotRequestCodec(), MaxSlotReplyCodec(),
               ReadRequestCodec(), SequentialReadRequestCodec(),
               EventualReadRequestCodec(), ReadReplyBatchCodec(),
               ClientReplyBatchCodec(), ReadRequestBatchCodec(),
               SequentialReadRequestBatchCodec(),
               EventualReadRequestBatchCodec(),
               BatchMaxSlotRequestCodec(), BatchMaxSlotReplyCodec(),
               NotLeaderClientCodec(), LeaderInfoRequestClientCodec(),
               LeaderInfoReplyClientCodec(), NotLeaderBatcherCodec(),
               LeaderInfoRequestBatcherCodec(),
               LeaderInfoReplyBatcherCodec(), Phase2bAckBatchCodec(),
               Phase1aCodec(), Phase1bCodec(), NackCodec(),
               RecoverCodec()):
    register_codec(_codec)

_register_coalescers()
