"""Binary codecs for the FastMultiPaxos steady-state path (the port's copy
of ``frankenpaxos_tpu/protocols/fastmultipaxos_wire.py``: the reference's
tags and bytes).

Covers the whole per-command loop: direct client proposals
(ProposeRequest), the leader/acceptor Phase2a (including the fast-round
any/anySuffix markers), per-vote Phase2b and the acceptor-drain
Phase2bBuffer, the ValueChosen gossip, and ProposeReply. Phase 1 /
election traffic is per-failover and stays pickled."""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.protocols import fastmultipaxos as fmp
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_address,
    _put_bytes,
    _take_address,
    _take_bytes,
)
from frankenpaxos_tpu_torch.runtime.serializer import (
    MessageCodec,
    register_codec,
)

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")
_QQQ = struct.Struct("<qqq")

# --- FastMultiPaxos ---------------------------------------------------------


def _fmp_put_command(out: bytearray, command: fmp.Command) -> None:
    cid = command.command_id
    _put_address(out, cid.client_address)
    out += _I64.pack(cid.client_id)
    _put_bytes(out, command.command)


def _fmp_take_command(buf: bytes, at: int):
    address, at = _take_address(buf, at)
    (client_id,) = _I64.unpack_from(buf, at)
    payload, at = _take_bytes(buf, at + 8)
    return fmp.Command(fmp.CommandId(address, client_id), payload), at


class FMPProposeRequestCodec(MessageCodec):
    message_type = fmp.ProposeRequest
    tag = 70

    def encode(self, out, message):
        _fmp_put_command(out, message.command)

    def decode(self, buf, at):
        command, at = _fmp_take_command(buf, at)
        return fmp.ProposeRequest(command), at


class FMPProposeReplyCodec(MessageCodec):
    message_type = fmp.ProposeReply
    tag = 71

    def encode(self, out, message):
        cid = message.command_id
        _put_address(out, cid.client_address)
        out += _I64I64.pack(cid.client_id, message.round)
        _put_bytes(out, message.result)

    def decode(self, buf, at):
        address, at = _take_address(buf, at)
        client_id, round = _I64I64.unpack_from(buf, at)
        result, at = _take_bytes(buf, at + 16)
        return fmp.ProposeReply(fmp.CommandId(address, client_id),
                                result, round=round), at



def _fmp_put_value(out: bytearray, value) -> None:
    if isinstance(value, fmp.Noop):
        out.append(0)
    else:
        out.append(1)
        _fmp_put_command(out, value)


def _fmp_take_value(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == 0:
        return fmp.NOOP, at
    return _fmp_take_command(buf, at)


class FMPPhase2aCodec(MessageCodec):
    """value None / any / anySuffix pack into one kind byte."""

    message_type = fmp.Phase2a
    tag = 72

    def encode(self, out, message):
        out += _I64I64.pack(message.slot, message.round)
        if message.any_suffix:
            out.append(3)
        elif message.any:
            out.append(2)
        elif message.value is None:
            out.append(4)
        else:
            _fmp_put_value(out, message.value)

    def decode(self, buf, at):
        slot, round = _I64I64.unpack_from(buf, at)
        at += 16
        kind = buf[at]
        if kind in (2, 3, 4):
            at += 1
            return fmp.Phase2a(
                slot=slot, round=round, value=None,
                any=(kind == 2), any_suffix=(kind == 3)), at
        value, at = _fmp_take_value(buf, at)
        return fmp.Phase2a(slot=slot, round=round, value=value), at


class FMPPhase2bCodec(MessageCodec):
    message_type = fmp.Phase2b
    tag = 73

    def encode(self, out, message):
        out += _QQQ.pack(message.acceptor_id, message.slot, message.round)
        _fmp_put_value(out, message.vote)

    def decode(self, buf, at):
        acceptor, slot, round = _QQQ.unpack_from(buf, at)
        vote, at = _fmp_take_value(buf, at + _QQQ.size)
        return fmp.Phase2b(acceptor_id=acceptor, slot=slot, round=round,
                           vote=vote), at


class FMPPhase2bBufferCodec(MessageCodec):
    message_type = fmp.Phase2bBuffer
    tag = 74

    def encode(self, out, message):
        out += _I32.pack(len(message.phase2bs))
        inner = FMPPhase2bCodec()
        for phase2b in message.phase2bs:
            inner.encode(out, phase2b)

    def decode(self, buf, at):
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        inner = FMPPhase2bCodec()
        phase2bs = []
        for _ in range(n):
            phase2b, at = inner.decode(buf, at)
            phase2bs.append(phase2b)
        return fmp.Phase2bBuffer(tuple(phase2bs)), at


class FMPValueChosenCodec(MessageCodec):
    message_type = fmp.ValueChosen
    tag = 75

    def encode(self, out, message):
        out += _I64.pack(message.slot)
        _fmp_put_value(out, message.value)

    def decode(self, buf, at):
        (slot,) = _I64.unpack_from(buf, at)
        value, at = _fmp_take_value(buf, at + 8)
        return fmp.ValueChosen(slot=slot, value=value), at


class FMPPhase1bNackCodec(MessageCodec):
    """Round-race feedback on the fast path (paxwire's extended tag
    page): per-failover, but a failover storm is when the wire is
    busiest."""

    message_type = fmp.Phase1bNack
    tag = 157

    def encode(self, out, message):
        out += _I64I64.pack(message.acceptor_id, message.round)

    def decode(self, buf, at):
        acceptor_id, round = _I64I64.unpack_from(buf, at)
        return fmp.Phase1bNack(acceptor_id=acceptor_id,
                               round=round), at + 16


for _codec in (FMPProposeRequestCodec(), FMPProposeReplyCodec(),
               FMPPhase2aCodec(), FMPPhase2bCodec(),
               FMPPhase2bBufferCodec(), FMPValueChosenCodec(),
               FMPPhase1bNackCodec()):
    register_codec(_codec)
