"""Fixed-layout codecs for every WPaxos message (extended tags 160-172;
the port's copy of ``frankenpaxos_tpu/protocols/wpaxos/wire.py``, the
reference's bytes).

Every frame is lane-classifiable by its leading tag (serve/lanes.py:
WRequest is client lane), and the registry-wide corrupt-frame fuzz
(tests/test_torch_wire.py) holds each decode to the ValueError
containment contract.

Address/command/value layouts are shared with multipaxos (one value
codec family serves both protocols), and ``encode_geo_epoch`` /
``decode_geo_epoch`` are the reference's WAL payload codec for
``WalGeoEpoch`` too (the port's WAL is ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_cid,
    _put_command,
    _put_value,
    _take_cid,
    _take_command,
    _take_value,
)
from frankenpaxos_tpu_torch.protocols.wpaxos.messages import (
    Steal,
    WChosen,
    WEpochAck,
    WEpochCommit,
    WNack,
    WNotOwner,
    WPhase1a,
    WPhase1b,
    WPhase2a,
    WPhase2b,
    WRecover,
    WReply,
    WRequest,
    WVote,
)
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_QQ = struct.Struct("<qq")
_QQQ = struct.Struct("<qqq")
_QQQQ = struct.Struct("<qqqq")
_GEO_EPOCH = struct.Struct("<qqqqq")  # group, epoch, start, home, ballot

#: Hostile-count bound: no real Phase1b carries more votes/epochs than
#: this; a corrupt length field must not size an allocation.
_MAX_ITEMS = 1 << 20


def encode_geo_epoch(entry: GeoEpoch) -> bytes:
    """One GeoEpoch as a standalone byte segment (the WalGeoEpoch
    payload; the same layout WEpochCommit carries on the wire)."""
    return _GEO_EPOCH.pack(entry.group, entry.epoch, entry.start_slot,
                           entry.home_zone, entry.ballot)


def decode_geo_epoch(data: bytes) -> GeoEpoch:
    try:
        group, epoch, start, home, ballot = _GEO_EPOCH.unpack_from(
            data, 0)
    except struct.error as e:
        raise ValueError(f"corrupt geo epoch: {e!r}") from e
    return GeoEpoch(group=group, epoch=epoch, start_slot=start,
                    home_zone=home, ballot=ballot)


def _put_geo_epoch(out: bytearray, entry: GeoEpoch) -> None:
    out += encode_geo_epoch(entry)


def _take_geo_epoch(buf: bytes, at: int):
    group, epoch, start, home, ballot = _GEO_EPOCH.unpack_from(buf, at)
    return GeoEpoch(group=group, epoch=epoch, start_slot=start,
                    home_zone=home, ballot=ballot), at + _GEO_EPOCH.size


def _take_count(buf: bytes, at: int):
    (n,) = _I32.unpack_from(buf, at)
    if not 0 <= n <= _MAX_ITEMS:
        raise ValueError(f"malformed item count {n}")
    return n, at + 4


class WRequestCodec(MessageCodec):
    message_type = WRequest
    tag = 160

    def encode(self, out, message):
        out += _I64.pack(message.group)
        out.append(1 if message.steal else 0)
        # origin_zone as one signed byte (-1 = unknown; no topology
        # runs 127+ zones through a single client).
        out.append(message.origin_zone & 0xFF)
        _put_command(out, message.command)

    def decode(self, buf, at):
        (group,) = _I64.unpack_from(buf, at)
        steal = buf[at + 8] != 0
        origin = buf[at + 9]
        if origin > 127:
            origin -= 256
        command, at = _take_command(buf, at + 10)
        return WRequest(group=group, command=command, steal=steal,
                        origin_zone=origin), at


class WReplyCodec(MessageCodec):
    message_type = WReply
    tag = 161

    def encode(self, out, message):
        out += _QQ.pack(message.group, message.slot)
        _put_cid(out, message.command_id)
        out += _I32.pack(len(message.result))
        out += message.result

    def decode(self, buf, at):
        group, slot = _QQ.unpack_from(buf, at)
        cid, at = _take_cid(buf, at + 16)
        n, at = _take_count(buf, at)
        if at + n > len(buf):
            raise ValueError(f"result overruns frame ({n} bytes)")
        result = bytes(buf[at:at + n])
        return WReply(command_id=cid, group=group, slot=slot,
                      result=result), at + n


class WNotOwnerCodec(MessageCodec):
    message_type = WNotOwner
    tag = 162

    def encode(self, out, message):
        out += _QQQ.pack(message.group, message.home_zone,
                         message.ballot)
        _put_cid(out, message.command_id)

    def decode(self, buf, at):
        group, home, ballot = _QQQ.unpack_from(buf, at)
        cid, at = _take_cid(buf, at + 24)
        return WNotOwner(group=group, command_id=cid, home_zone=home,
                         ballot=ballot), at


class StealCodec(MessageCodec):
    message_type = Steal
    tag = 163

    def encode(self, out, message):
        out += _I64.pack(message.group)

    def decode(self, buf, at):
        (group,) = _I64.unpack_from(buf, at)
        return Steal(group=group), at + 8


class WPhase1aCodec(MessageCodec):
    message_type = WPhase1a
    tag = 164

    def encode(self, out, message):
        out += _QQQ.pack(message.group, message.ballot, message.epoch)

    def decode(self, buf, at):
        group, ballot, epoch = _QQQ.unpack_from(buf, at)
        return WPhase1a(group=group, ballot=ballot, epoch=epoch), at + 24


class WPhase1bCodec(MessageCodec):
    message_type = WPhase1b
    tag = 165

    def encode(self, out, message):
        out += _QQQQ.pack(message.group, message.ballot, message.epoch,
                          message.acceptor)
        out += _I32.pack(len(message.votes))
        for vote in message.votes:
            out += _QQ.pack(vote.slot, vote.ballot)
            _put_value(out, vote.value)
        out += _I32.pack(len(message.epochs))
        for entry in message.epochs:
            _put_geo_epoch(out, entry)

    def decode(self, buf, at):
        group, ballot, epoch, acceptor = _QQQQ.unpack_from(buf, at)
        at += 32
        n, at = _take_count(buf, at)
        votes = []
        for _ in range(n):
            slot, vote_ballot = _QQ.unpack_from(buf, at)
            value, at = _take_value(buf, at + 16)
            votes.append(WVote(slot=slot, ballot=vote_ballot,
                               value=value))
        n, at = _take_count(buf, at)
        epochs = []
        for _ in range(n):
            entry, at = _take_geo_epoch(buf, at)
            epochs.append(entry)
        return WPhase1b(group=group, ballot=ballot, epoch=epoch,
                        acceptor=acceptor, votes=tuple(votes),
                        epochs=tuple(epochs)), at


class WPhase2aCodec(MessageCodec):
    message_type = WPhase2a
    tag = 166

    def encode(self, out, message):
        out += _QQQ.pack(message.group, message.slot, message.ballot)
        _put_value(out, message.value)

    def decode(self, buf, at):
        group, slot, ballot = _QQQ.unpack_from(buf, at)
        value, at = _take_value(buf, at + 24)
        return WPhase2a(group=group, slot=slot, ballot=ballot,
                        value=value), at


class WPhase2bCodec(MessageCodec):
    message_type = WPhase2b
    tag = 167

    def encode(self, out, message):
        out += _QQQQ.pack(message.group, message.slot, message.ballot,
                          message.acceptor)

    def decode(self, buf, at):
        group, slot, ballot, acceptor = _QQQQ.unpack_from(buf, at)
        return WPhase2b(group=group, slot=slot, ballot=ballot,
                        acceptor=acceptor), at + 32


class WNackCodec(MessageCodec):
    message_type = WNack
    tag = 168

    def encode(self, out, message):
        out += _QQQ.pack(message.group, message.ballot,
                         message.home_zone)

    def decode(self, buf, at):
        group, ballot, home = _QQQ.unpack_from(buf, at)
        return WNack(group=group, ballot=ballot, home_zone=home), at + 24


class WChosenCodec(MessageCodec):
    message_type = WChosen
    tag = 169

    def encode(self, out, message):
        out += _QQ.pack(message.group, message.slot)
        _put_value(out, message.value)

    def decode(self, buf, at):
        group, slot = _QQ.unpack_from(buf, at)
        value, at = _take_value(buf, at + 16)
        return WChosen(group=group, slot=slot, value=value), at


class WEpochCommitCodec(MessageCodec):
    message_type = WEpochCommit
    tag = 170

    def encode(self, out, message):
        _put_geo_epoch(out, message.entry)

    def decode(self, buf, at):
        entry, at = _take_geo_epoch(buf, at)
        return WEpochCommit(entry=entry), at


class WEpochAckCodec(MessageCodec):
    message_type = WEpochAck
    tag = 171

    def encode(self, out, message):
        out += _QQ.pack(message.group, message.epoch)

    def decode(self, buf, at):
        group, epoch = _QQ.unpack_from(buf, at)
        return WEpochAck(group=group, epoch=epoch), at + 16


class WRecoverCodec(MessageCodec):
    message_type = WRecover
    tag = 172

    def encode(self, out, message):
        out += _QQ.pack(message.group, message.slot)

    def decode(self, buf, at):
        group, slot = _QQ.unpack_from(buf, at)
        return WRecover(group=group, slot=slot), at + 16


for _codec in (WRequestCodec(), WReplyCodec(), WNotOwnerCodec(),
               StealCodec(), WPhase1aCodec(), WPhase1bCodec(),
               WPhase2aCodec(), WPhase2bCodec(), WNackCodec(),
               WChosenCodec(), WEpochCommitCodec(), WEpochAckCodec(),
               WRecoverCodec()):
    register_codec(_codec)
