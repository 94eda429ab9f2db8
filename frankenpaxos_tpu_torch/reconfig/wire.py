"""Fixed-layout codecs for the reconfiguration messages (the port's copy
of ``frankenpaxos_tpu/reconfig/wire.py``; the same frames byte for
byte).

The primary wire tag space 1..127 is full, so these live on the
EXTENDED PAGE (0x00-escape + one tag byte, tags 128..131 --
runtime/serializer.py). Layouts follow the repo's codec conventions:
little-endian fixed-width structs, length-prefixed address/value
segments, hostile-length validation inside decode (a malformed frame
raises ValueError).

``encode_epoch_config``/``decode_epoch_config`` double as the WAL
payload codec for ``wal.records.WalEpoch`` -- one layout for the wire
and the log, so a recovered epoch is bit-identical to a broadcast one.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.reconfig.messages import (
    EpochAck,
    EpochCommit,
    EpochPhase2aRun,
    Reconfigure,
)
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I64I64 = struct.Struct("<qq")
_I32 = struct.Struct("<i")
_QQQ = struct.Struct("<qqq")

#: Per-frame member-count sanity bound: a hostile count field must not
#: size an allocation (no real acceptor set comes close).
_MAX_MEMBERS = 4096


def _mp_wire():
    """The multipaxos wire helpers (address + SoA value-array
    layouts), bound at CALL time: importing them at module load would
    close an import cycle (protocols.multipaxos's roles import
    reconfig, whose package init loads this module). Registration
    below needs no helper; the first encode/decode resolves this to an
    already-initialized module either way."""
    from frankenpaxos_tpu_torch.protocols.multipaxos import wire

    return wire


def _put_members(out: bytearray, members) -> None:
    w = _mp_wire()
    out += _I32.pack(len(members))
    for address in members:
        w._put_address(out, address)


def _take_members(buf: bytes, at: int) -> tuple:
    w = _mp_wire()
    (n,) = _I32.unpack_from(buf, at)
    at += 4
    if not 0 <= n <= _MAX_MEMBERS:
        raise ValueError(f"malformed member list: count {n}")
    members = []
    for _ in range(n):
        address, at = w._take_address(buf, at)
        members.append(address)
    return tuple(members), at


_QQIQ = struct.Struct("<qqiq")  # epoch, start_slot, f, round


def encode_epoch_config(epoch: int, start_slot: int, f: int,
                        round: int, members) -> bytes:
    """The (epoch, start_slot, f, round, members) body shared by the
    EpochCommit codec and the WalEpoch record payload."""
    out = bytearray()
    out += _QQIQ.pack(epoch, start_slot, f, round)
    _put_members(out, members)
    return bytes(out)


def decode_epoch_config(data: bytes) -> tuple:
    """-> (epoch, start_slot, f, round, members)."""
    try:
        epoch, start_slot, f, round = _QQIQ.unpack_from(data, 0)
        members, _ = _take_members(data, _QQIQ.size)
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt epoch config: {e!r}") from e
    return epoch, start_slot, f, round, members


class ReconfigureCodec(MessageCodec):
    message_type = Reconfigure
    tag = 128

    def encode(self, out, message):
        _put_members(out, message.members)

    def decode(self, buf, at):
        members, at = _take_members(buf, at)
        return Reconfigure(members=members), at


class EpochCommitCodec(MessageCodec):
    message_type = EpochCommit
    tag = 129

    def encode(self, out, message):
        out += _QQIQ.pack(message.epoch, message.start_slot, message.f,
                          message.round)
        _put_members(out, message.members)

    def decode(self, buf, at):
        epoch, start_slot, f, round = _QQIQ.unpack_from(buf, at)
        members, at = _take_members(buf, at + _QQIQ.size)
        return EpochCommit(epoch=epoch, start_slot=start_slot, f=f,
                           round=round, members=members), at


class EpochAckCodec(MessageCodec):
    message_type = EpochAck
    tag = 130

    def encode(self, out, message):
        out += _I64I64.pack(message.epoch, message.round)

    def decode(self, buf, at):
        epoch, round = _I64I64.unpack_from(buf, at)
        return EpochAck(epoch=epoch, round=round), at + 16


class EpochPhase2aRunCodec(MessageCodec):
    """The run-pipeline proposal with an epoch tag: the SoA value
    array rides the multipaxos lazy layout, so forwarding one of these
    (proxy leader -> acceptors, re-wrapped as a plain Phase2aRun) is a
    raw bytes copy of the segment."""

    message_type = EpochPhase2aRun
    tag = 131

    def encode(self, out, message):
        out += _QQQ.pack(message.epoch, message.start_slot,
                         message.round)
        _mp_wire()._put_value_array(out, message.values)

    def decode(self, buf, at):
        epoch, start, round = _QQQ.unpack_from(buf, at)
        values, at = _mp_wire()._take_value_array(buf, at + 24)
        return EpochPhase2aRun(epoch=epoch, start_slot=start,
                               round=round, values=values), at


for _codec in (ReconfigureCodec(), EpochCommitCodec(), EpochAckCodec(),
               EpochPhase2aRunCodec()):
    register_codec(_codec)
