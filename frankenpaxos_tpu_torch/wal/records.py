"""WAL record types and their fixed-layout codecs (the port's copy of
``frankenpaxos_tpu/wal/records.py``; the same record tags and bytes).

Records are protocol-NEUTRAL: value payloads are opaque byte segments
already encoded by the owning role's wire helpers
(``multipaxos.wire.encode_value`` / ``encode_value_array``), so one
record set serves every protocol family and a run record's payload is a
raw copy of the LazyValueArray segment that arrived on the wire --
logging a drain's Phase2aRun never re-encodes its values.

Records live in their OWN tag space (``WAL_SERIALIZER``), not the wire
registry: they never cross the network, and a closed record set lets
recovery refuse unknown tags outright -- there is NO pickle fallback
here, so replaying a log never executes code. The codec classes follow
the MessageCodec shape (message_type + tag + encode/decode); a malformed
record raises ValueError, never another exception type. WAL frames also
carry a CRC (wal/log.py), so a corrupt record on disk is normally caught
before decode.
"""

from __future__ import annotations

import dataclasses
import struct

from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec

_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")
_QQQ = struct.Struct("<qqq")
_I32 = struct.Struct("<i")


@dataclasses.dataclass(frozen=True)
class WalPromise:
    """The acceptor promised (or voted in) ``round``."""

    round: int


@dataclasses.dataclass(frozen=True)
class WalVote:
    """A single-slot vote: ``value`` is one wire-encoded
    CommandBatchOrNoop (``wire.encode_value``)."""

    slot: int
    round: int
    value: bytes


@dataclasses.dataclass(frozen=True)
class WalVoteRun:
    """A whole voted run in one record: ``values`` is the wire's
    value-array segment (``wire.encode_value_array`` -- a raw copy of
    the inbound Phase2aRun's lazy payload). ``stride`` is 1 for
    MultiPaxos runs and the owner's slot stride for a striped log."""

    start_slot: int
    stride: int
    round: int
    values: bytes


@dataclasses.dataclass(frozen=True)
class WalNoopRange:
    """A noop-range vote (a striped log's skip machinery): the acceptor voted
    Noop for every slot it owns in [start, end)."""

    slot_start_inclusive: int
    slot_end_exclusive: int
    round: int


@dataclasses.dataclass(frozen=True)
class WalChosenRun:
    """Chosen log entries at a replica: slots start, start + stride,
    ...; ``values`` is a value-array segment."""

    start_slot: int
    stride: int
    values: bytes


@dataclasses.dataclass(frozen=True)
class WalEpoch:
    """A committed reconfiguration epoch (reconfig/): ``payload`` is
    the role-encoded EpochConfig (``reconfig.wire.encode_epoch_config``
    -- epoch id, activation start slot, f, member addresses). Durable
    BEFORE the EpochAck leaves the acceptor: a crashed acceptor can
    never have acked an epoch it will not recover, which is what makes
    the old-epoch write quorum of acks a real matchmaker commit."""

    payload: bytes


@dataclasses.dataclass(frozen=True)
class WalGeoPromise:
    """paxgeo (protocols/wpaxos): the acceptor promised ``ballot`` for
    object group ``group``. Durable BEFORE the Phase1b ack leaves the
    acceptor -- a row-majority of these durable acks from the old home
    zone is an object steal's commit point."""

    group: int
    ballot: int


@dataclasses.dataclass(frozen=True)
class WalGeoVote:
    """paxgeo: a per-(group, slot) vote; ``value`` is one wire-encoded
    CommandBatchOrNoop (``wire.encode_value``, shared with
    multipaxos)."""

    group: int
    slot: int
    ballot: int
    value: bytes


@dataclasses.dataclass(frozen=True)
class WalGeoEpoch:
    """paxgeo: a committed object-steal epoch entry; ``payload`` is
    the role-encoded GeoEpoch (``wpaxos.wire.encode_geo_epoch`` --
    group, epoch, activation start slot, home zone, ballot). One
    layout for the wire and the log, like WalEpoch."""

    payload: bytes


@dataclasses.dataclass(frozen=True)
class WalSnapshot:
    """A compaction base: everything before this record is superseded.

    For replicas ``payload`` carries the SM snapshot + executed
    watermark + client table (role-encoded); for acceptors it is empty
    (their compaction re-logs live state as ordinary records after the
    marker)."""

    payload: bytes


def _take_bytes(buf: bytes, at: int) -> tuple[bytes, int]:
    """Length-prefixed bytes with HOSTILE-LENGTH validation: a negative
    or overrunning count raises ValueError inside decode (the
    transport corrupt-frame guard / recovery CRC both treat that as a
    clean drop)."""
    (n,) = _I32.unpack_from(buf, at)
    at += 4
    if n < 0 or at + n > len(buf):
        raise ValueError(
            f"malformed WAL byte segment: length {n} exceeds payload "
            f"({len(buf) - at} bytes left)")
    return buf[at:at + n], at + n


class WalPromiseCodec(MessageCodec):
    message_type = WalPromise
    tag = 1

    def encode(self, out, message):
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        return WalPromise(round=round), at + 8


class WalVoteCodec(MessageCodec):
    message_type = WalVote
    tag = 2

    def encode(self, out, message):
        out += _I64I64.pack(message.slot, message.round)
        out += _I32.pack(len(message.value))
        out += message.value

    def decode(self, buf, at):
        slot, round = _I64I64.unpack_from(buf, at)
        value, at = _take_bytes(buf, at + 16)
        return WalVote(slot=slot, round=round, value=value), at


class WalVoteRunCodec(MessageCodec):
    message_type = WalVoteRun
    tag = 3

    def encode(self, out, message):
        out += _QQQ.pack(message.start_slot, message.stride,
                         message.round)
        out += _I32.pack(len(message.values))
        out += message.values

    def decode(self, buf, at):
        start, stride, round = _QQQ.unpack_from(buf, at)
        values, at = _take_bytes(buf, at + 24)
        return WalVoteRun(start_slot=start, stride=stride, round=round,
                          values=values), at


class WalNoopRangeCodec(MessageCodec):
    message_type = WalNoopRange
    tag = 4

    def encode(self, out, message):
        out += _QQQ.pack(message.slot_start_inclusive,
                         message.slot_end_exclusive, message.round)

    def decode(self, buf, at):
        start, end, round = _QQQ.unpack_from(buf, at)
        return WalNoopRange(slot_start_inclusive=start,
                            slot_end_exclusive=end, round=round), at + 24


class WalChosenRunCodec(MessageCodec):
    message_type = WalChosenRun
    tag = 5

    def encode(self, out, message):
        out += _I64I64.pack(message.start_slot, message.stride)
        out += _I32.pack(len(message.values))
        out += message.values

    def decode(self, buf, at):
        start, stride = _I64I64.unpack_from(buf, at)
        values, at = _take_bytes(buf, at + 16)
        return WalChosenRun(start_slot=start, stride=stride,
                            values=values), at


class WalEpochCodec(MessageCodec):
    message_type = WalEpoch
    tag = 7

    def encode(self, out, message):
        out += _I32.pack(len(message.payload))
        out += message.payload

    def decode(self, buf, at):
        payload, at = _take_bytes(buf, at)
        return WalEpoch(payload=payload), at


class WalGeoPromiseCodec(MessageCodec):
    message_type = WalGeoPromise
    tag = 8

    def encode(self, out, message):
        out += _I64I64.pack(message.group, message.ballot)

    def decode(self, buf, at):
        group, ballot = _I64I64.unpack_from(buf, at)
        return WalGeoPromise(group=group, ballot=ballot), at + 16


class WalGeoVoteCodec(MessageCodec):
    message_type = WalGeoVote
    tag = 9

    def encode(self, out, message):
        out += _QQQ.pack(message.group, message.slot, message.ballot)
        out += _I32.pack(len(message.value))
        out += message.value

    def decode(self, buf, at):
        group, slot, ballot = _QQQ.unpack_from(buf, at)
        value, at = _take_bytes(buf, at + 24)
        return WalGeoVote(group=group, slot=slot, ballot=ballot,
                          value=value), at


class WalGeoEpochCodec(MessageCodec):
    message_type = WalGeoEpoch
    tag = 10

    def encode(self, out, message):
        out += _I32.pack(len(message.payload))
        out += message.payload

    def decode(self, buf, at):
        payload, at = _take_bytes(buf, at)
        return WalGeoEpoch(payload=payload), at


class WalSnapshotCodec(MessageCodec):
    message_type = WalSnapshot
    tag = 6

    def encode(self, out, message):
        out += _I32.pack(len(message.payload))
        out += message.payload

    def decode(self, buf, at):
        payload, at = _take_bytes(buf, at)
        return WalSnapshot(payload=payload), at


_RECORD_CODECS_BY_TYPE: dict[type, MessageCodec] = {}
_RECORD_CODECS_BY_TAG: dict[int, MessageCodec] = {}


class WalRecordSerializer:
    """The record-space twin of HybridSerializer, WITHOUT the pickle
    fallback: the record set is closed, so an unknown tag in a
    CRC-valid frame is corruption (or a future format) and raises
    ValueError instead of ever evaluating bytes."""

    def to_bytes(self, record) -> bytes:
        codec = _RECORD_CODECS_BY_TYPE.get(type(record))
        if codec is None:
            raise ValueError(
                f"no WAL record codec for {type(record).__name__}")
        out = bytearray((codec.tag,))
        codec.encode(out, record)
        return bytes(out)

    def from_bytes(self, data: bytes):
        if not data:
            # A zero-length frame passes the CRC check (crc32(b"") is
            # 0), so a zero-filled torn tail reaches here: refuse with
            # the ValueError the recovery loop treats as a torn frame.
            raise ValueError("empty WAL record payload")
        codec = _RECORD_CODECS_BY_TAG.get(data[0])
        if codec is None:
            raise ValueError(f"unknown WAL record tag {data[0]}")
        try:
            record, _ = codec.decode(data, 1)
        except (struct.error, IndexError) as e:
            raise ValueError(f"corrupt WAL record: {e}") from e
        return record


WAL_SERIALIZER = WalRecordSerializer()

for _codec in (WalPromiseCodec(), WalVoteCodec(), WalVoteRunCodec(),
               WalNoopRangeCodec(), WalChosenRunCodec(),
               WalSnapshotCodec(), WalEpochCodec(),
               WalGeoPromiseCodec(), WalGeoVoteCodec(),
               WalGeoEpochCodec()):
    _RECORD_CODECS_BY_TYPE[_codec.message_type] = _codec
    _RECORD_CODECS_BY_TAG[_codec.tag] = _codec
