"""Message serialization (the port's copy of
``frankenpaxos_tpu/runtime/serializer.py``). The binary codecs register
when their protocol package is imported (``protocols/multipaxos/wire.py``
and its relatives); a message type without one pickles.

Reference behavior: Serializer.scala:5-10 / ProtoSerializer.scala:3-11 --
every inbound message type has a serializer with ``to_bytes`` /
``from_bytes`` plus a debug ``to_pretty_string``.

Protocol messages here are plain dataclasses; the default wire format is
pickle (simple, complete). The framing layer (tcp_transport / the C++
codec) is format-agnostic, so a fixed-layout binary codec can replace
pickle per-message-type without touching protocol code.

SECURITY: the no-code-execution-on-decode property holds ONLY for
messages carried by a registered ``MessageCodec`` (wire tags 1..255;
128+ ride the 0x00-prefixed extended page).
Unregistered message types -- and a handful of escape hatches inside
binary codecs, e.g. exotic sim addresses -- fall back to pickle, and
``pickle.loads`` on attacker-controlled bytes executes arbitrary code.
The reference avoids this wholesale by using protobuf everywhere
(ProtoSerializer.scala:3-11). Deployments whose transport crosses a
trust boundary must call ``set_pickle_fallback(False)``: decoding then
hard-errors on any pickle frame (first byte >= 0x80) instead of
evaluating it, and encoding an unregistered type raises at the sender.
"""

from __future__ import annotations

import abc
import pickle
import struct
from typing import Generic, TypeVar

M = TypeVar("M")


class Serializer(abc.ABC, Generic[M]):
    @abc.abstractmethod
    def to_bytes(self, message: M) -> bytes:
        ...

    @abc.abstractmethod
    def from_bytes(self, data: bytes) -> M:
        ...

    def to_pretty_string(self, message: M) -> str:
        return repr(message)


class PickleSerializer(Serializer[M]):
    """Default serializer for dataclass messages."""

    def to_bytes(self, message: M) -> bytes:
        return pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL)

    def from_bytes(self, data: bytes) -> M:
        return pickle.loads(data)


class MessageCodec(abc.ABC):
    """A fixed-layout binary codec for ONE message type (the
    ProtoSerializer.scala:3-11 analog: schema'd, language-agnostic, no
    arbitrary code execution on decode)."""

    #: The message class this codec handles.
    message_type: type
    #: Wire tag. 1..127 encode as a single leading byte (pickle streams
    #: start with 0x80, so one byte discriminates binary-coded from
    #: pickled messages). Tags 128..255 live on the EXTENDED PAGE:
    #: byte 0x00 -- never a primary tag, never a pickle opcode -- is the
    #: escape prefix, and the second byte carries ``tag - 128``. The
    #: primary page is full (every protocol family carries codecs); new
    #: subsystems allocate from the extended page.
    tag: int

    @abc.abstractmethod
    def encode(self, out: bytearray, message) -> None:
        ...

    @abc.abstractmethod
    def decode(self, buf: bytes, at: int) -> tuple:
        """-> (message, next_offset)."""


_CODECS_BY_TYPE: dict[type, MessageCodec] = {}
_CODECS_BY_TAG: dict[int, MessageCodec] = {}

#: Whether HybridSerializer (and codec escape hatches) may pickle.
#: Default True: sims and single-trust-domain deployments keep the
#: complete-coverage fallback. See the module docstring for the
#: security trade-off.
_PICKLE_FALLBACK = True


def set_pickle_fallback(enabled: bool) -> None:
    """Globally allow/forbid the pickle wire fallback. With it disabled,
    decode raises on pickle frames instead of executing them, and encode
    raises on message types without a registered codec."""
    global _PICKLE_FALLBACK
    _PICKLE_FALLBACK = enabled


def pickle_fallback_enabled() -> bool:
    return _PICKLE_FALLBACK


def guarded_pickle_loads(raw: bytes, what: str):
    """The ONE entry point for pickle escape hatches inside binary
    codecs (exotic addresses/values/commands): every hatch must decode
    through here so ``set_pickle_fallback(False)`` covers it."""
    if not _PICKLE_FALLBACK:
        raise ValueError(
            f"pickle fallback disabled: refusing pickled {what} inside "
            f"binary frame")
    try:
        return pickle.loads(raw)
    except Exception as e:
        # A corrupt frame can route arbitrary bytes into this hatch (a
        # flipped address-kind byte -- found by the registry-wide
        # containment fuzz), and pickle.loads raises open-ended
        # exception types on garbage. Normalize to the ValueError
        # containment channel like every other decode failure.
        raise ValueError(f"corrupt pickled {what}: {e!r}") from e


def guarded_pickle_dumps(obj, what: str) -> bytes:
    """Encode-side twin of :func:`guarded_pickle_loads`: fail at the
    sender instead of emitting a frame the receiver must refuse."""
    if not _PICKLE_FALLBACK:
        raise ValueError(
            f"pickle fallback disabled: cannot encode {what} {obj!r} in "
            f"a binary frame")
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def register_codec(codec: MessageCodec) -> None:
    """Install a binary codec for its message type (process-global: the
    codec IS the wire schema, so every actor must agree on it)."""
    if not 1 <= codec.tag <= 255:
        raise ValueError(f"tag {codec.tag} outside 1..255")
    existing = _CODECS_BY_TAG.get(codec.tag)
    if existing is not None and type(existing) is not type(codec):
        raise ValueError(f"tag {codec.tag} already taken by {existing}")
    _CODECS_BY_TYPE[codec.message_type] = codec
    _CODECS_BY_TAG[codec.tag] = codec


class HybridSerializer(Serializer[M]):
    """Binary fixed-layout encoding for registered hot message types
    (Phase2a/Phase2b/Chosen/ClientRequest...); pickle for the long tail.

    The first byte discriminates: 1..127 selects a registered codec,
    0x00 escapes to the extended tag page (the second byte selects tag
    ``128 + byte``), and 0x80+ is a pickle stream (every pickle
    protocol >= 2 starts with the PROTO opcode 0x80). Senders and
    receivers therefore interoperate in any mix of
    registered/unregistered types.
    """

    def to_bytes(self, message: M) -> bytes:
        codec = _CODECS_BY_TYPE.get(type(message))
        if codec is None:
            if not _PICKLE_FALLBACK:
                raise ValueError(
                    f"pickle fallback disabled and no codec registered "
                    f"for {type(message).__name__}")
            return pickle.dumps(message,
                                protocol=pickle.HIGHEST_PROTOCOL)
        if codec.tag > 127:
            out = bytearray((0, codec.tag - 128))
        else:
            out = bytearray((codec.tag,))
        codec.encode(out, message)
        return bytes(out)

    def from_bytes(self, data: bytes) -> M:
        tag = data[0]
        if tag >= 128:
            if not _PICKLE_FALLBACK:
                raise ValueError(
                    "pickle fallback disabled: refusing to decode a "
                    "pickle frame (first byte >= 0x80)")
            return pickle.loads(data)
        at = 1
        if tag == 0:
            # Extended page: 0x00 escape + one tag byte. A bare 0x00
            # frame is corruption, not a message.
            if len(data) < 2:
                raise ValueError("truncated extended-tag frame")
            tag = 128 + data[1]
            at = 2
        codec = _CODECS_BY_TAG.get(tag)
        if codec is None:
            raise ValueError(f"no codec registered for wire tag {tag}")
        try:
            message, _ = codec.decode(data, at)
        except ValueError:
            raise
        except (struct.error, IndexError, KeyError, UnicodeDecodeError,
                OverflowError, MemoryError) as e:
            # THE CONTAINMENT CONTRACT (fuzzed over the whole codec
            # registry in tests/test_wire_codecs.py): a corrupt binary
            # frame decodes to garbage or raises ValueError -- never an
            # uncontrolled exception type. The transport's
            # corrupt-frame guard logs-and-drops on any Exception, but
            # OTHER decode sites (WAL replay, tests, tools) rely on
            # ValueError being the one failure channel.
            raise ValueError(
                f"corrupt frame for wire tag {tag}: {e!r}") from e
        return message


#: Shared default: one instance so registrations apply everywhere.
DEFAULT_SERIALIZER: HybridSerializer = HybridSerializer()
