"""Binary codecs of the small protocols (the port's part of
``frankenpaxos_tpu/protocols/baseline_wire.py``): Fast Paxos's (tags
90-95) and Matchmaker Paxos's (tags 103-112), with the reference's bytes.
The reference's other five protocols (echo, unreplicated,
batchedunreplicated, paxos, caspaxos) bring theirs with their ports
(``ROADMAP.md`` queue 1 item 9).

Layouts follow the house style (multipaxos/wire.py): little-endian
fixed-width ints, length-prefixed bytes, kind-byte tagged unions for
optionals. No code execution on decode.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.protocols import (
    fastpaxos as fp,
    matchmakerpaxos as mp,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_bytes,
    _take_bytes,
)
from frankenpaxos_tpu_torch.runtime.serializer import (
    MessageCodec,
    register_codec,
)

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")


def _put_str(out: bytearray, s: str) -> None:
    _put_bytes(out, s.encode())


def _take_str(buf: bytes, at: int):
    raw, at = _take_bytes(buf, at)
    return raw.decode(), at


# --- fastpaxos ----------------------------------------------------------------


def _put_opt_str(out: bytearray, s) -> None:
    if s is None:
        out.append(0)
    else:
        out.append(1)
        _put_str(out, s)


def _take_opt_str(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == 0:
        return None, at
    return _take_str(buf, at)


def _single_decree_codecs(ns, base_tag: int, prefix: str) -> list:
    """Codec classes for one single-decree package (the reference's paxos
    and fastpaxos share these shapes, including fastpaxos's ``value=None``
    "any" marker in Phase2a, which _put_opt_str covers)."""

    class ProposeRequestCodec(MessageCodec):
        message_type = ns.ProposeRequest
        tag = base_tag

        def encode(self, out, message):
            _put_str(out, message.v)

        def decode(self, buf, at):
            v, at = _take_str(buf, at)
            return ns.ProposeRequest(v), at

    class ProposeReplyCodec(MessageCodec):
        message_type = ns.ProposeReply
        tag = base_tag + 1

        def encode(self, out, message):
            _put_str(out, message.chosen)

        def decode(self, buf, at):
            chosen, at = _take_str(buf, at)
            return ns.ProposeReply(chosen), at

    class Phase1aCodec(MessageCodec):
        message_type = ns.Phase1a
        tag = base_tag + 2

        def encode(self, out, message):
            out += _I64.pack(message.round)

        def decode(self, buf, at):
            (round,) = _I64.unpack_from(buf, at)
            return ns.Phase1a(round), at + 8

    class Phase1bCodec(MessageCodec):
        message_type = ns.Phase1b
        tag = base_tag + 3

        def encode(self, out, message):
            out += _I64.pack(message.round)
            out += _I64I64.pack(message.acceptor_id, message.vote_round)
            _put_opt_str(out, message.vote_value)

        def decode(self, buf, at):
            (round,) = _I64.unpack_from(buf, at)
            acceptor_id, vote_round = _I64I64.unpack_from(buf, at + 8)
            vote_value, at = _take_opt_str(buf, at + 24)
            return ns.Phase1b(round, acceptor_id, vote_round, vote_value), at

    class Phase2aCodec(MessageCodec):
        message_type = ns.Phase2a
        tag = base_tag + 4

        def encode(self, out, message):
            out += _I64.pack(message.round)
            _put_opt_str(out, message.value)

        def decode(self, buf, at):
            (round,) = _I64.unpack_from(buf, at)
            value, at = _take_opt_str(buf, at + 8)
            return ns.Phase2a(round, value), at

    class Phase2bCodec(MessageCodec):
        message_type = ns.Phase2b
        tag = base_tag + 5

        def encode(self, out, message):
            out += _I64I64.pack(message.acceptor_id, message.round)

        def decode(self, buf, at):
            acceptor_id, round = _I64I64.unpack_from(buf, at)
            return ns.Phase2b(acceptor_id, round), at + 16

    codecs = [ProposeRequestCodec, ProposeReplyCodec, Phase1aCodec,
              Phase1bCodec, Phase2aCodec, Phase2bCodec]
    for codec in codecs:
        codec.__name__ = prefix + codec.__name__
        codec.__qualname__ = codec.__name__
    return codecs


_FASTPAXOS_CODECS = _single_decree_codecs(fp, 90, "FastPaxos")


# --- matchmakerpaxos --------------------------------------------------------

_QS_KINDS = ("simple_majority", "unanimous_writes", "grid")


def _put_int_list(out: bytearray, xs) -> None:
    """Order-preserving (unlike _put_int_set): the wire dict's member
    and grid-row lists must round-trip exactly for message equality."""
    out += _I32.pack(len(xs))
    for x in xs:
        out += _I64.pack(x)


def _take_int_list(buf: bytes, at: int):
    (n,) = _I32.unpack_from(buf, at)
    at += 4
    xs = []
    for _ in range(n):
        (x,) = _I64.unpack_from(buf, at)
        xs.append(x)
        at += 8
    return xs, at


def _put_quorum_system_dict(out: bytearray, d: dict) -> None:
    """The QuorumSystemProto analog (QuorumSystem.scala:26-44) in binary:
    kind byte + member list, or kind byte + row-major grid."""
    kind = d["kind"]
    out.append(_QS_KINDS.index(kind))
    if kind == "grid":
        out += _I32.pack(len(d["grid"]))
        for row in d["grid"]:
            _put_int_list(out, row)
    else:
        _put_int_list(out, d["members"])


def _take_quorum_system_dict(buf: bytes, at: int):
    kind = _QS_KINDS[buf[at]]
    at += 1
    if kind == "grid":
        (n,) = _I32.unpack_from(buf, at)
        at += 4
        grid = []
        for _ in range(n):
            row, at = _take_int_list(buf, at)
            grid.append(row)
        return {"kind": kind, "grid": grid}, at
    members, at = _take_int_list(buf, at)
    return {"kind": kind, "members": members}, at


def _put_acceptor_group(out: bytearray, group: mp.AcceptorGroup) -> None:
    out += _I64.pack(group.round)
    _put_quorum_system_dict(out, group.quorum_system)


def _take_acceptor_group(buf: bytes, at: int):
    (round,) = _I64.unpack_from(buf, at)
    qs, at = _take_quorum_system_dict(buf, at + 8)
    return mp.AcceptorGroup(round, qs), at


class MpxClientRequestCodec(MessageCodec):
    message_type = mp.ClientRequest
    tag = 103

    def encode(self, out, message):
        _put_str(out, message.v)

    def decode(self, buf, at):
        v, at = _take_str(buf, at)
        return mp.ClientRequest(v), at


class MpxClientReplyCodec(MessageCodec):
    message_type = mp.ClientReply
    tag = 104

    def encode(self, out, message):
        _put_str(out, message.chosen)

    def decode(self, buf, at):
        chosen, at = _take_str(buf, at)
        return mp.ClientReply(chosen), at


class MpxMatchRequestCodec(MessageCodec):
    message_type = mp.MatchRequest
    tag = 105

    def encode(self, out, message):
        _put_acceptor_group(out, message.acceptor_group)

    def decode(self, buf, at):
        group, at = _take_acceptor_group(buf, at)
        return mp.MatchRequest(group), at


class MpxMatchReplyCodec(MessageCodec):
    message_type = mp.MatchReply
    tag = 106

    def encode(self, out, message):
        out += _I64I64.pack(message.round, message.matchmaker_index)
        out += _I32.pack(len(message.acceptor_groups))
        for group in message.acceptor_groups:
            _put_acceptor_group(out, group)

    def decode(self, buf, at):
        round, matchmaker_index = _I64I64.unpack_from(buf, at)
        (n,) = _I32.unpack_from(buf, at + 16)
        at += 20
        groups = []
        for _ in range(n):
            group, at = _take_acceptor_group(buf, at)
            groups.append(group)
        return mp.MatchReply(round, matchmaker_index, tuple(groups)), at


class MpxPhase1aCodec(MessageCodec):
    message_type = mp.Phase1a
    tag = 107

    def encode(self, out, message):
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        return mp.Phase1a(round), at + 8


class MpxPhase1bCodec(MessageCodec):
    message_type = mp.Phase1b
    tag = 108

    def encode(self, out, message):
        out += _I64I64.pack(message.round, message.acceptor_index)
        if message.vote is None:
            out.append(0)
        else:
            out.append(1)
            out += _I64.pack(message.vote.vote_round)
            _put_str(out, message.vote.vote_value)

    def decode(self, buf, at):
        round, acceptor_index = _I64I64.unpack_from(buf, at)
        at += 16
        kind = buf[at]
        at += 1
        vote = None
        if kind == 1:
            (vote_round,) = _I64.unpack_from(buf, at)
            vote_value, at = _take_str(buf, at + 8)
            vote = mp.Phase1bVote(vote_round, vote_value)
        return mp.Phase1b(round, acceptor_index, vote), at


class MpxPhase2aCodec(MessageCodec):
    message_type = mp.Phase2a
    tag = 109

    def encode(self, out, message):
        out += _I64.pack(message.round)
        _put_str(out, message.value)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        value, at = _take_str(buf, at + 8)
        return mp.Phase2a(round, value), at


class MpxPhase2bCodec(MessageCodec):
    message_type = mp.Phase2b
    tag = 110

    def encode(self, out, message):
        out += _I64I64.pack(message.round, message.acceptor_index)

    def decode(self, buf, at):
        round, acceptor_index = _I64I64.unpack_from(buf, at)
        return mp.Phase2b(round, acceptor_index), at + 16


class MpxMatchmakerNackCodec(MessageCodec):
    message_type = mp.MatchmakerNack
    tag = 111

    def encode(self, out, message):
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        return mp.MatchmakerNack(round), at + 8


class MpxAcceptorNackCodec(MessageCodec):
    message_type = mp.AcceptorNack
    tag = 112

    def encode(self, out, message):
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        (round,) = _I64.unpack_from(buf, at)
        return mp.AcceptorNack(round), at + 8


for _codec_cls in _FASTPAXOS_CODECS + [
        MpxClientRequestCodec, MpxClientReplyCodec, MpxMatchRequestCodec,
        MpxMatchReplyCodec, MpxPhase1aCodec, MpxPhase1bCodec,
        MpxPhase2aCodec, MpxPhase2bCodec, MpxMatchmakerNackCodec,
        MpxAcceptorNackCodec]:
    register_codec(_codec_cls())
