"""Fixed-layout codec for ``Rejected`` (extended tag page, tag 132).

Follows the repo codec conventions (reconfig/wire.py is the extended
page's style reference): little-endian fixed-width structs, hostile
count validation inside decode so the registry-wide corrupt-frame fuzz
(tests/test_wire_codecs.py) can hold it to the ValueError containment
contract.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec
from frankenpaxos_tpu_torch.serve.messages import Rejected

_HDR = struct.Struct("<iib")  # count, retry_after_ms, reason
_I64I64 = struct.Struct("<qq")

#: Per-frame entry-count sanity bound: a hostile count must not size an
#: allocation. A drain's coalesced array tops out far below this.
_MAX_ENTRIES = 1 << 20


class RejectedCodec(MessageCodec):
    message_type = Rejected
    tag = 132

    def encode(self, out, message):
        out += _HDR.pack(len(message.entries), message.retry_after_ms,
                         message.reason)
        for pseudonym, client_id in message.entries:
            out += _I64I64.pack(pseudonym, client_id)

    def decode(self, buf, at):
        n, retry_after_ms, reason = _HDR.unpack_from(buf, at)
        at += _HDR.size
        if not 0 <= n <= _MAX_ENTRIES:
            raise ValueError(f"malformed Rejected: count {n}")
        if at + 16 * n > len(buf):
            raise ValueError("truncated Rejected entries")
        entries = tuple(_I64I64.unpack_from(buf, at + 16 * i)
                        for i in range(n))
        return Rejected(entries=entries, retry_after_ms=retry_after_ms,
                        reason=reason), at + 16 * n


register_codec(RejectedCodec())
