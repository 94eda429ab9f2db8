"""Binary codecs of the small protocols (the port's part of
``frankenpaxos_tpu/protocols/baseline_wire.py``): Fast Paxos's, with the
reference's tags (90-95) and bytes. The reference's other six protocols
(echo, unreplicated, batchedunreplicated, paxos, caspaxos,
matchmakerpaxos) bring theirs with their ports (``ROADMAP.md`` queue 1
items 7 and 9).

Layouts follow the house style (multipaxos/wire.py): little-endian
fixed-width ints, length-prefixed bytes, kind-byte tagged unions for
optionals. No code execution on decode.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.protocols import fastpaxos as fp
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_bytes,
    _take_bytes,
)
from frankenpaxos_tpu_torch.runtime.serializer import (
    MessageCodec,
    register_codec,
)

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

for _codec_cls in _FASTPAXOS_CODECS:
    register_codec(_codec_cls())
