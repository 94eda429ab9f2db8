"""Fixed-layout codecs for the ingest plane (extended tags 204-205, 210);
the port's copy of ``frankenpaxos_tpu/ingest/wire.py``.

``IngestRun`` is the disseminator/sequencer hot path: its payload is
the run pipeline's canonical value-array segment, so a batcher that
scanned client frames into columns encodes the run as a RAW COPY, and
the leader's ``Phase2aRun`` re-encode is another raw copy -- the bytes
a client put on the wire reach the acceptors untouched. ``seq``
(paxfan descriptor pipelining) rides as a fixed i64 ahead of the
segment; ``IngestCredit`` is the leader's 12-byte watermark reply.
The bytes are the JAX package's (``frankenpaxos_tpu/ingest/wire.py``),
held equal in tests/test_torch_ingest.py.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.ingest.messages import (
    IngestCredit,
    IngestRun,
    NotLeaderIngest,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_value_array,
    _take_value_array,
)
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I32 = struct.Struct("<i")
_I32I32 = struct.Struct("<ii")
_I32Q = struct.Struct("<iq")
_I32I32Q = struct.Struct("<iiq")


class IngestRunCodec(MessageCodec):
    message_type = IngestRun
    tag = 204

    def encode(self, out, message):
        out += _I32Q.pack(message.batcher_index, message.seq)
        _put_value_array(out, message.values)

    def decode(self, buf, at):
        batcher_index, seq = _I32Q.unpack_from(buf, at)
        values, at = _take_value_array(buf, at + 12)
        return IngestRun(batcher_index=batcher_index,
                         values=values, seq=seq), at


class NotLeaderIngestCodec(MessageCodec):
    message_type = NotLeaderIngest
    tag = 205

    def encode(self, out, message):
        out += _I32I32Q.pack(message.group_index,
                             message.run.batcher_index,
                             message.run.seq)
        _put_value_array(out, message.run.values)

    def decode(self, buf, at):
        group_index, batcher_index, seq = _I32I32Q.unpack_from(buf, at)
        values, at = _take_value_array(buf, at + 16)
        return NotLeaderIngest(
            group_index=group_index,
            run=IngestRun(batcher_index=batcher_index,
                          values=values, seq=seq)), at


class IngestCreditCodec(MessageCodec):
    message_type = IngestCredit
    tag = 210

    def encode(self, out, message):
        out += _I32Q.pack(message.group_index, message.watermark_seq)

    def decode(self, buf, at):
        group_index, watermark_seq = _I32Q.unpack_from(buf, at)
        return IngestCredit(group_index=group_index,
                            watermark_seq=watermark_seq), at + 12


register_codec(IngestRunCodec())
register_codec(NotLeaderIngestCodec())
register_codec(IngestCreditCodec())
