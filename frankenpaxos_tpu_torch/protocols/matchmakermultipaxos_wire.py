"""Binary codecs for the MatchmakerMultiPaxos steady-state write path
and the matchmaker-epoch-change cold path (the port's copy of
``frankenpaxos_tpu/protocols/matchmakermultipaxos_wire.py``: the
reference's tags and bytes).

The per-command hot loop (ClientRequest -> Phase2a -> Phase2b ->
Chosen -> ClientReply, Matchmaker.proto's MultiPaxos core) rides tags
48-52. The matchmaker self-reconfiguration single-decree Paxos
(MatchPhase1a/1b/2a/2b/MatchChosen/MatchNack), the Stopped bounce and
the GC pair ride extended tags 181-189 (paxsafe COD301 burn-down):
per-epoch traffic, but it is exactly what is on the wire during a
matchmaker failover, and pickled frames are refused under
``set_pickle_fallback(False)``. The whole-log transfer messages
(Stop/StopAck/Bootstrap/BootstrapAck/ReconfigureMatchmakers, tags
195-199, paxsim COD301 burn-down) carry round -> quorum-system DICT
logs; their wire form encodes the four structured quorum-system
shapes (`quorums.systems.quorum_system_to_dict`: simple_majority /
unanimous_writes member sets, grid / zone_grid int matrices)
fixed-layout, with a guarded-pickle escape hatch for exotic dicts so
``set_pickle_fallback(False)`` still covers the hatch.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.protocols import matchmakermultipaxos as m
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
_I32I32 = struct.Struct("<ii")
_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")
_QQQ = struct.Struct("<qqq")


def _put_command(out: bytearray, command: m.Command) -> None:
    cid = command.command_id
    _put_address(out, cid.client_address)
    out += _I64I64.pack(cid.client_pseudonym, cid.client_id)
    _put_bytes(out, command.command)


def _take_command(buf: bytes, at: int):
    address, at = _take_address(buf, at)
    pseudonym, id = _I64I64.unpack_from(buf, at)
    payload, at = _take_bytes(buf, at + 16)
    return m.Command(m.CommandId(address, pseudonym, id), payload), at


def _put_value(out: bytearray, value) -> None:
    if isinstance(value, m.Noop):
        out.append(0)
    else:
        out.append(1)
        _put_command(out, value)


def _take_value(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == 0:
        return m.NOOP, at
    return _take_command(buf, at)


class MMPClientRequestCodec(MessageCodec):
    message_type = m.ClientRequest
    tag = 48

    def encode(self, out, message):
        _put_command(out, message.command)

    def decode(self, buf, at):
        command, at = _take_command(buf, at)
        return m.ClientRequest(command), at


class MMPPhase2aCodec(MessageCodec):
    message_type = m.Phase2a
    tag = 49

    def encode(self, out, message):
        out += _I64I64.pack(message.slot, message.round)
        _put_value(out, message.value)

    def decode(self, buf, at):
        slot, round = _I64I64.unpack_from(buf, at)
        value, at = _take_value(buf, at + 16)
        return m.Phase2a(slot=slot, round=round, value=value), at


class MMPPhase2bCodec(MessageCodec):
    message_type = m.Phase2b
    tag = 50

    def encode(self, out, message):
        out += _QQQ.pack(message.slot, message.round,
                         message.acceptor_index)

    def decode(self, buf, at):
        slot, round, acceptor = _QQQ.unpack_from(buf, at)
        return m.Phase2b(slot=slot, round=round,
                         acceptor_index=acceptor), at + _QQQ.size


class MMPChosenCodec(MessageCodec):
    message_type = m.Chosen
    tag = 51

    def encode(self, out, message):
        out += _I64.pack(message.slot)
        _put_value(out, message.value)

    def decode(self, buf, at):
        (slot,) = _I64.unpack_from(buf, at)
        value, at = _take_value(buf, at + 8)
        return m.Chosen(slot=slot, value=value), at


class MMPClientReplyCodec(MessageCodec):
    message_type = m.ClientReply
    tag = 52

    def encode(self, out, message):
        cid = message.command_id
        _put_address(out, cid.client_address)
        out += _I64I64.pack(cid.client_pseudonym, cid.client_id)
        _put_bytes(out, message.result)

    def decode(self, buf, at):
        address, at = _take_address(buf, at)
        pseudonym, id = _I64I64.unpack_from(buf, at)
        result, at = _take_bytes(buf, at + 16)
        return m.ClientReply(m.CommandId(address, pseudonym, id),
                             result), at


def _put_mc(out: bytearray, mc: m.MatchmakerConfiguration) -> None:
    out += _I64.pack(mc.epoch)
    out += _I32.pack(mc.reconfigurer_index)
    out += _I32.pack(len(mc.matchmaker_indices))
    for index in mc.matchmaker_indices:
        out += _I32.pack(index)


def _take_mc(buf: bytes, at: int):
    (epoch,) = _I64.unpack_from(buf, at)
    reconfigurer, n = _I32I32.unpack_from(buf, at + 8)
    if n < 0 or n > (len(buf) - at - 16) // 4:
        raise ValueError(f"hostile matchmaker-index count {n}")
    at += 16
    indices = []
    for _ in range(n):
        (index,) = _I32.unpack_from(buf, at)
        if not 0 <= index < (1 << 20):
            # Value validation at the trust boundary (see
            # fasterpaxos_wire._take_delegates): out-of-range indices
            # must die as corrupt frames, not as IndexErrors (or
            # silent negative-index wraps) inside the matchmaker.
            raise ValueError(f"hostile matchmaker index {index}")
        indices.append(index)
        at += 4
    return m.MatchmakerConfiguration(epoch, reconfigurer,
                                     tuple(indices)), at


class MMPStoppedCodec(MessageCodec):
    message_type = m.Stopped
    tag = 181

    def encode(self, out, message):
        out += _I64.pack(message.epoch)

    def decode(self, buf, at):
        (epoch,) = _I64.unpack_from(buf, at)
        return m.Stopped(epoch=epoch), at + 8


class MMPGarbageCollectCodec(MessageCodec):
    message_type = m.GarbageCollect
    tag = 182

    def encode(self, out, message):
        _put_mc(out, message.matchmaker_configuration)
        out += _I64.pack(message.gc_watermark)

    def decode(self, buf, at):
        mc, at = _take_mc(buf, at)
        (watermark,) = _I64.unpack_from(buf, at)
        return m.GarbageCollect(mc, watermark), at + 8


class MMPGarbageCollectAckCodec(MessageCodec):
    message_type = m.GarbageCollectAck
    tag = 183

    def encode(self, out, message):
        out += _I64.pack(message.epoch)
        out += _I32.pack(message.matchmaker_index)
        out += _I64.pack(message.gc_watermark)

    def decode(self, buf, at):
        (epoch,) = _I64.unpack_from(buf, at)
        (index,) = _I32.unpack_from(buf, at + 8)
        (watermark,) = _I64.unpack_from(buf, at + 12)
        return m.GarbageCollectAck(epoch, index, watermark), at + 20


class MMPMatchPhase1aCodec(MessageCodec):
    message_type = m.MatchPhase1a
    tag = 184

    def encode(self, out, message):
        _put_mc(out, message.matchmaker_configuration)
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        mc, at = _take_mc(buf, at)
        (round,) = _I64.unpack_from(buf, at)
        return m.MatchPhase1a(mc, round), at + 8


class MMPMatchPhase1bCodec(MessageCodec):
    message_type = m.MatchPhase1b
    tag = 185

    def encode(self, out, message):
        out += _I64I64.pack(message.epoch, message.round)
        out += _I32.pack(message.matchmaker_index)
        out += _I64.pack(message.vote_round)
        if message.vote_value is None:
            out.append(0)
        else:
            out.append(1)
            _put_mc(out, message.vote_value)

    def decode(self, buf, at):
        epoch, round = _I64I64.unpack_from(buf, at)
        (index,) = _I32.unpack_from(buf, at + 16)
        (vote_round,) = _I64.unpack_from(buf, at + 20)
        at += 28
        kind = buf[at]
        at += 1
        vote_value = None
        if kind == 1:
            vote_value, at = _take_mc(buf, at)
        elif kind != 0:
            raise ValueError(f"bad MatchPhase1b vote flag {kind}")
        return m.MatchPhase1b(epoch=epoch, round=round,
                              matchmaker_index=index,
                              vote_round=vote_round,
                              vote_value=vote_value), at


class MMPMatchPhase2aCodec(MessageCodec):
    message_type = m.MatchPhase2a
    tag = 186

    def encode(self, out, message):
        _put_mc(out, message.matchmaker_configuration)
        out += _I64.pack(message.round)
        _put_mc(out, message.value)

    def decode(self, buf, at):
        mc, at = _take_mc(buf, at)
        (round,) = _I64.unpack_from(buf, at)
        value, at = _take_mc(buf, at + 8)
        return m.MatchPhase2a(mc, round, value), at


class MMPMatchPhase2bCodec(MessageCodec):
    message_type = m.MatchPhase2b
    tag = 187

    def encode(self, out, message):
        out += _I64I64.pack(message.epoch, message.round)
        out += _I32.pack(message.matchmaker_index)

    def decode(self, buf, at):
        epoch, round = _I64I64.unpack_from(buf, at)
        (index,) = _I32.unpack_from(buf, at + 16)
        return m.MatchPhase2b(epoch=epoch, round=round,
                              matchmaker_index=index), at + 20


class MMPMatchChosenCodec(MessageCodec):
    message_type = m.MatchChosen
    tag = 188

    def encode(self, out, message):
        _put_mc(out, message.value)

    def decode(self, buf, at):
        value, at = _take_mc(buf, at)
        return m.MatchChosen(value), at


class MMPMatchNackCodec(MessageCodec):
    message_type = m.MatchNack
    tag = 189

    def encode(self, out, message):
        out += _I64I64.pack(message.epoch, message.round)

    def decode(self, buf, at):
        epoch, round = _I64I64.unpack_from(buf, at)
        return m.MatchNack(epoch=epoch, round=round), at + 16


# --- whole-log transfers: round -> quorum-system dict logs ----------------

_QS_KINDS = {"simple_majority": 0, "unanimous_writes": 1,
             "grid": 2, "zone_grid": 3}
_QS_KIND_NAMES = {v: k for k, v in _QS_KINDS.items()}
_QS_PICKLED = 255
_MAX_QS_INT = 1 << 20


def _put_qs_dict(out: bytearray, d) -> None:
    """One quorum-system dict (quorums.systems.quorum_system_to_dict).
    The four structured shapes encode fixed-layout; anything else --
    unknown kind, non-int members -- rides the guarded pickle hatch,
    so exotic payloads still honor ``set_pickle_fallback``."""
    from frankenpaxos_tpu_torch.runtime import serializer

    kind = _QS_KINDS.get(d.get("kind")) if isinstance(d, dict) else None
    if kind in (0, 1):
        members = d.get("members")
        if (isinstance(members, list)
                and all(type(x) is int and 0 <= x < _MAX_QS_INT
                        for x in members)):
            out.append(kind)
            out += _I32.pack(len(members))
            for x in members:
                out += _I32.pack(x)
            return
    elif kind in (2, 3):
        grid = d.get("grid")
        if (isinstance(grid, list)
                and all(isinstance(row, list)
                        and all(type(x) is int and 0 <= x < _MAX_QS_INT
                                for x in row)
                        for row in grid)):
            out.append(kind)
            out += _I32.pack(len(grid))
            for row in grid:
                out += _I32.pack(len(row))
                for x in row:
                    out += _I32.pack(x)
            return
    out.append(_QS_PICKLED)
    _put_bytes(out, serializer.guarded_pickle_dumps(
        d, "quorum-system dict"))


def _take_qs_dict(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == _QS_PICKLED:
        from frankenpaxos_tpu_torch.runtime import serializer

        raw, at = _take_bytes(buf, at)
        return serializer.guarded_pickle_loads(
            raw, "quorum-system dict"), at
    if kind in (0, 1):
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        if n < 0 or n > (len(buf) - at) // 4:
            raise ValueError(f"hostile quorum-member count {n}")
        members = []
        for _ in range(n):
            (x,) = _I32.unpack_from(buf, at)
            if not 0 <= x < _MAX_QS_INT:
                raise ValueError(f"hostile quorum member {x}")
            members.append(x)
            at += 4
        return {"kind": _QS_KIND_NAMES[kind], "members": members}, at
    if kind in (2, 3):
        (rows,) = _I32.unpack_from(buf, at)
        at += 4
        if rows < 0 or rows > (len(buf) - at) // 4:
            raise ValueError(f"hostile quorum-grid row count {rows}")
        grid = []
        for _ in range(rows):
            (cols,) = _I32.unpack_from(buf, at)
            at += 4
            if cols < 0 or cols > (len(buf) - at) // 4:
                raise ValueError(
                    f"hostile quorum-grid column count {cols}")
            row = []
            for _ in range(cols):
                (x,) = _I32.unpack_from(buf, at)
                if not 0 <= x < _MAX_QS_INT:
                    raise ValueError(f"hostile quorum-grid entry {x}")
                row.append(x)
                at += 4
            grid.append(row)
        return {"kind": _QS_KIND_NAMES[kind], "grid": grid}, at
    raise ValueError(f"bad quorum-system kind byte {kind}")


def _put_configurations(out: bytearray, configurations) -> None:
    out += _I32.pack(len(configurations))
    for round, qs_dict in configurations:
        out += _I64.pack(round)
        _put_qs_dict(out, qs_dict)


def _take_configurations(buf: bytes, at: int):
    (n,) = _I32.unpack_from(buf, at)
    at += 4
    # Each entry is at least round (8) + kind byte (1).
    if n < 0 or n > (len(buf) - at) // 9:
        raise ValueError(f"hostile configuration count {n}")
    configurations = []
    for _ in range(n):
        (round,) = _I64.unpack_from(buf, at)
        qs_dict, at = _take_qs_dict(buf, at + 8)
        configurations.append((round, qs_dict))
    return tuple(configurations), at


class MMPStopCodec(MessageCodec):
    message_type = m.Stop
    tag = 195

    def encode(self, out, message):
        _put_mc(out, message.matchmaker_configuration)

    def decode(self, buf, at):
        mc, at = _take_mc(buf, at)
        return m.Stop(mc), at


class MMPStopAckCodec(MessageCodec):
    message_type = m.StopAck
    tag = 196

    def encode(self, out, message):
        out += _I32.pack(message.matchmaker_index)
        out += _I64I64.pack(message.epoch, message.gc_watermark)
        _put_configurations(out, message.configurations)

    def decode(self, buf, at):
        (index,) = _I32.unpack_from(buf, at)
        epoch, watermark = _I64I64.unpack_from(buf, at + 4)
        configurations, at = _take_configurations(buf, at + 20)
        return m.StopAck(matchmaker_index=index, epoch=epoch,
                         gc_watermark=watermark,
                         configurations=configurations), at


class MMPBootstrapCodec(MessageCodec):
    message_type = m.Bootstrap
    tag = 197

    def encode(self, out, message):
        out += _I64.pack(message.epoch)
        out += _I32.pack(message.reconfigurer_index)
        out += _I64.pack(message.gc_watermark)
        _put_configurations(out, message.configurations)

    def decode(self, buf, at):
        (epoch,) = _I64.unpack_from(buf, at)
        (index,) = _I32.unpack_from(buf, at + 8)
        (watermark,) = _I64.unpack_from(buf, at + 12)
        configurations, at = _take_configurations(buf, at + 20)
        return m.Bootstrap(epoch=epoch, reconfigurer_index=index,
                           gc_watermark=watermark,
                           configurations=configurations), at


class MMPBootstrapAckCodec(MessageCodec):
    message_type = m.BootstrapAck
    tag = 198

    def encode(self, out, message):
        out += _I32.pack(message.matchmaker_index)
        out += _I64.pack(message.epoch)

    def decode(self, buf, at):
        (index,) = _I32.unpack_from(buf, at)
        (epoch,) = _I64.unpack_from(buf, at + 4)
        return m.BootstrapAck(matchmaker_index=index,
                              epoch=epoch), at + 12


class MMPReconfigureMatchmakersCodec(MessageCodec):
    message_type = m.ReconfigureMatchmakers
    tag = 199

    def encode(self, out, message):
        _put_mc(out, message.matchmaker_configuration)
        out += _I32.pack(len(message.new_matchmaker_indices))
        for index in message.new_matchmaker_indices:
            out += _I32.pack(index)

    def decode(self, buf, at):
        mc, at = _take_mc(buf, at)
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        if n < 0 or n > (len(buf) - at) // 4:
            raise ValueError(f"hostile matchmaker-index count {n}")
        indices = []
        for _ in range(n):
            (index,) = _I32.unpack_from(buf, at)
            if not 0 <= index < _MAX_QS_INT:
                raise ValueError(f"hostile matchmaker index {index}")
            indices.append(index)
            at += 4
        return m.ReconfigureMatchmakers(
            matchmaker_configuration=mc,
            new_matchmaker_indices=tuple(indices)), at


for _codec in (MMPClientRequestCodec(), MMPPhase2aCodec(),
               MMPPhase2bCodec(), MMPChosenCodec(),
               MMPClientReplyCodec(), MMPStoppedCodec(),
               MMPGarbageCollectCodec(), MMPGarbageCollectAckCodec(),
               MMPMatchPhase1aCodec(), MMPMatchPhase1bCodec(),
               MMPMatchPhase2aCodec(), MMPMatchPhase2bCodec(),
               MMPMatchChosenCodec(), MMPMatchNackCodec(),
               MMPStopCodec(), MMPStopAckCodec(), MMPBootstrapCodec(),
               MMPBootstrapAckCodec(),
               MMPReconfigureMatchmakersCodec()):
    register_codec(_codec)
