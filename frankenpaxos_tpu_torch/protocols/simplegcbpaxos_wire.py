"""Binary codecs for the SimpleGcBPaxos snapshot cold path (the last two
protocol messages that would otherwise pickle).

``SnapshotRequest`` is a field-less poke; ``CommitSnapshot`` is the
whole-snapshot transfer a recovering replica receives when the vertex
it asked for was already garbage collected. Both ride the wire only on
the recovery/GC path, but that is exactly the window where a cluster
must also survive ``set_pickle_fallback(False)``, so they get
fixed-layout codecs like BPaxosRecover (tag 200) before them.

Wire forms reuse the neighbours' layouts verbatim: the snapshot
watermark is a ``VertexIdPrefixSet`` dict (EPaxos column layout via
``_put_deps``/``_take_deps``); the client table is the
``ClientTable.to_dict`` kv list with ``(Address, pseudonym)`` keys.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.protocols.epaxos.wire import _put_deps, _take_deps
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_address,
    _put_bytes,
    _take_address,
    _take_bytes,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import VertexIdPrefixSet
from frankenpaxos_tpu_torch.protocols.simplegcbpaxos import (
    CommitSnapshot,
    SnapshotRequest,
)
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")


def _put_int_prefix_set(out: bytearray, d: dict) -> None:
    """IntPrefixSet wire dict: [i64 watermark][i32 n][n x i64]."""
    out += _I64.pack(d["watermark"])
    values = d["values"]
    out += _I32.pack(len(values))
    for value in values:
        out += _I64.pack(value)


def _take_int_prefix_set(buf: bytes, at: int):
    (watermark,) = _I64.unpack_from(buf, at)
    (n,) = _I32.unpack_from(buf, at + 8)
    at += 12
    values = []
    for _ in range(n):
        (v,) = _I64.unpack_from(buf, at)
        values.append(v)
        at += 8
    # ``to_dict`` emits sorted values and encode preserves order, so
    # the decoded dict is bit-for-bit the canonical wire form.
    return {"watermark": watermark, "values": values}, at


def _put_client_table(out: bytearray, d: dict) -> None:
    """ClientTable wire dict (clienttable.ClientTable.to_dict): a kv
    list keyed by ``(client Address, i64 pseudonym)``."""
    kv = d["kv"]
    out += _I32.pack(len(kv))
    for entry in kv:
        address, pseudonym = entry["client"]
        _put_address(out, address)
        out += _I64I64.pack(pseudonym, entry["largest_id"])
        _put_bytes(out, entry["largest_output"])
        _put_int_prefix_set(out, entry["executed_ids"])


def _take_client_table(buf: bytes, at: int):
    (n,) = _I32.unpack_from(buf, at)
    at += 4
    kv = []
    for _ in range(n):
        address, at = _take_address(buf, at)
        pseudonym, largest_id = _I64I64.unpack_from(buf, at)
        largest_output, at = _take_bytes(buf, at + 16)
        executed_ids, at = _take_int_prefix_set(buf, at)
        kv.append({
            "client": (address, pseudonym),
            "largest_id": largest_id,
            "largest_output": largest_output,
            "executed_ids": executed_ids,
        })
    return {"kv": kv}, at


class SnapshotRequestCodec(MessageCodec):
    message_type = SnapshotRequest
    tag = 206

    def encode(self, out, message):
        pass

    def decode(self, buf, at):
        return SnapshotRequest(), at


class CommitSnapshotCodec(MessageCodec):
    """The watermark rides the EPaxos deps column layout: the message
    field is the ``to_dict`` wire form, so encode lifts it back into a
    VertexIdPrefixSet and decode lowers it again -- ``to_dict`` is
    canonical (sorted values), so the round trip is exact."""

    message_type = CommitSnapshot
    tag = 207

    def encode(self, out, message):
        out += _I64.pack(message.id)
        _put_deps(out, VertexIdPrefixSet.from_dict(message.watermark))
        _put_bytes(out, message.state_machine)
        _put_client_table(out, message.client_table)

    def decode(self, buf, at):
        (id,) = _I64.unpack_from(buf, at)
        watermark, at = _take_deps(buf, at + 8)
        state_machine, at = _take_bytes(buf, at)
        client_table, at = _take_client_table(buf, at)
        return CommitSnapshot(id=id, watermark=watermark.to_dict(),
                              state_machine=state_machine,
                              client_table=client_table), at


for _codec in (SnapshotRequestCodec(), CommitSnapshotCodec()):
    register_codec(_codec)
