"""DepRun wire messages: drain-coalesced dependency-reply runs.

The dependency-carrying acks of the graph protocols (EPaxos
PreAcceptOk, tag 14's reply tag 15; SimpleBPaxos DependencyReply, tag
23) dominate their hot paths the way Phase2b dominates multipaxos --
and like Phase2b they arrive in same-peer runs at every transport
flush. The paxwire coalescers here fold such a run into ONE fixed-
layout extended-page message whose dependency sets travel as flat
columns::

    [i32 B][i32 L]
    B x entry header            (protocol-specific fixed struct)
    B*L x i64 watermarks        (row-major [entry][leader])
    B*L x i32 counts            (sparse-tail lengths)
    sum(counts) x i64 values    (concatenated sparse ids)

The column blocks decode with ``np.frombuffer`` and scatter straight
into a ``[B, L, W]`` DepSetBatch (``runs/depruns.py``), so a receiver
can union or compare the whole drain in one vmapped reduction instead
of B host-set walks. Receivers that want the original messages get
them via ``__wire_expand__`` -- like Phase2bAckBatch, coalescing
changes the frame and decode cost, never the delivered semantics, and
the protocol role x message topology is untouched (these codecs are
``transport_layer``; no role ever sends one).

Tags 208 and 209 (next free extended tags after 207).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from frankenpaxos_tpu_torch.runs import depruns
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I32I32 = struct.Struct("<ii")
# instance (replica i32, number i64) + ballot (i64, i32) + sender
# replica i32 + sequence number i64 (the PreAcceptOk fixed prefix).
_EPAXOS_ENTRY = struct.Struct("<iqqiiq")
# vertex (leader i32, id i64) + dep service node i32.
_BPAXOS_ENTRY = struct.Struct("<iqi")


def _put_columns(out: bytearray, watermarks, counts, values) -> None:
    out += np.asarray(watermarks, dtype="<i8").tobytes()
    out += np.asarray(counts, dtype="<i4").tobytes()
    out += np.asarray(values, dtype="<i8").tobytes()


def _take_columns(buf, at: int, num_columns: int):
    """Decode the three column blocks; ValueError on a hostile or torn
    count table (the transport's corrupt-frame containment channel)."""
    end = at + 12 * num_columns
    if end > len(buf):
        raise ValueError(
            f"malformed dep run: {num_columns} columns exceed payload")
    watermarks = np.frombuffer(buf, dtype="<i8", count=num_columns,
                               offset=at)
    counts = np.frombuffer(buf, dtype="<i4", count=num_columns,
                           offset=at + 8 * num_columns)
    if counts.size and int(counts.min()) < 0:
        raise ValueError("malformed dep run: negative tail count")
    total = int(counts.sum())
    if end + 8 * total > len(buf):
        raise ValueError(
            f"malformed dep run: {total} values exceed payload")
    values = np.frombuffer(buf, dtype="<i8", count=total, offset=end)
    return (tuple(int(w) for w in watermarks),
            tuple(int(c) for c in counts),
            tuple(int(v) for v in values), end + 8 * total)


def _expand_deps(run):
    """Per-entry InstancePrefixSets from a run's flat columns."""
    from frankenpaxos_tpu_torch.compact import IntPrefixSet
    from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
        InstancePrefixSet,
    )

    for watermarks, counts, values in depruns.split_columns(
            run.num_leaders, run.watermarks, run.counts, run.values):
        columns = []
        offset = 0
        for watermark, count in zip(watermarks, counts):
            columns.append(IntPrefixSet(
                watermark, set(values[offset:offset + count])))
            offset += count
        yield InstancePrefixSet(run.num_leaders, columns)


@dataclasses.dataclass(frozen=True)
class PreAcceptOkRun:
    """A drain's EPaxos PreAcceptOks in column form, send order
    preserved. ``headers[b]`` is ``(instance_replica, instance_number,
    ballot_ordering, ballot_replica, replica_index, sequence_number)``.
    """

    num_leaders: int
    headers: tuple
    watermarks: tuple
    counts: tuple
    values: tuple

    def __wire_expand__(self, serializer):
        from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
            Instance,
        )
        from frankenpaxos_tpu_torch.protocols.epaxos.messages import PreAcceptOk

        for header, deps in zip(self.headers, _expand_deps(self)):
            inst_replica, inst_number, b0, b1, replica, seq = header
            yield PreAcceptOk(instance=Instance(inst_replica, inst_number),
                              ballot=(b0, b1), replica_index=replica,
                              sequence_number=seq, dependencies=deps)


@dataclasses.dataclass(frozen=True)
class DepReplyRun:
    """A drain's BPaxos DependencyReplies in column form. ``headers[b]``
    is ``(vertex_leader_index, vertex_instance_number, node_index)``."""

    num_leaders: int
    headers: tuple
    watermarks: tuple
    counts: tuple
    values: tuple

    def __wire_expand__(self, serializer):
        from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import (
            DependencyReply,
            VertexId,
        )

        for header, deps in zip(self.headers, _expand_deps(self)):
            leader, number, node = header
            yield DependencyReply(vertex_id=VertexId(leader, number),
                                  dep_service_node_index=node,
                                  dependencies=deps)


class _DepRunCodec(MessageCodec):
    """Shared run layout; subclasses fix the entry-header struct."""

    entry_struct: struct.Struct

    def encode(self, out, message):
        out += _I32I32.pack(len(message.headers), message.num_leaders)
        for header in message.headers:
            out += self.entry_struct.pack(*header)
        _put_columns(out, message.watermarks, message.counts,
                     message.values)

    def decode(self, buf, at):
        num_entries, num_leaders = _I32I32.unpack_from(buf, at)
        at += 8
        entry_size = self.entry_struct.size
        if (num_entries < 0 or num_leaders <= 0
                or at + num_entries * entry_size > len(buf)):
            raise ValueError(
                f"malformed dep run: {num_entries} entries x "
                f"{num_leaders} leaders exceeds payload")
        headers = []
        for _ in range(num_entries):
            headers.append(self.entry_struct.unpack_from(buf, at))
            at += entry_size
        watermarks, counts, values, at = _take_columns(
            buf, at, num_entries * num_leaders)
        return self.message_type(
            num_leaders=num_leaders, headers=tuple(headers),
            watermarks=watermarks, counts=counts, values=values), at


class PreAcceptOkRunCodec(_DepRunCodec):
    message_type = PreAcceptOkRun
    tag = 208
    entry_struct = _EPAXOS_ENTRY
    # Encoded by the transport's flush-time coalescer, decoded and
    # expanded by the transport -- no role send site (paxflow FLOW403
    # skips transport_layer codecs; the marker must sit in the
    # registered class's own body for the AST scan).
    transport_layer = True


class DepReplyRunCodec(_DepRunCodec):
    message_type = DepReplyRun
    tag = 209
    entry_struct = _BPAXOS_ENTRY
    transport_layer = True


def _encode_run(codec: _DepRunCodec, run) -> bytes:
    out = bytearray((0, codec.tag - 128))
    codec.encode(out, run)
    return bytes(out)


def _coalesce_pre_accept_ok(payloads: list):
    """paxwire coalescer for runs of tag-15 (PreAcceptOk) payloads.
    Declines (None -> generic batch frame) on any unexpected layout."""
    from frankenpaxos_tpu_torch.protocols.epaxos.wire import PreAcceptOkCodec

    codec = PreAcceptOkCodec()
    messages = []
    for payload in payloads:
        if not payload or payload[0] != PreAcceptOkCodec.tag:
            return None
        message, end = codec.decode(payload, 1)
        if end != len(payload):
            return None
        messages.append(message)
    columns = depruns.sets_to_columns([m.dependencies for m in messages])
    if columns is None:
        return None
    num_leaders, watermarks, counts, values = columns
    return _encode_run(PreAcceptOkRunCodec(), PreAcceptOkRun(
        num_leaders=num_leaders,
        headers=tuple((m.instance.replica_index,
                       m.instance.instance_number, m.ballot[0],
                       m.ballot[1], m.replica_index, m.sequence_number)
                      for m in messages),
        watermarks=watermarks, counts=counts, values=values))


def _coalesce_dependency_reply(payloads: list):
    """paxwire coalescer for runs of tag-23 (DependencyReply) payloads."""
    from frankenpaxos_tpu_torch.protocols.simplebpaxos.wire import (
        DependencyReplyCodec,
    )

    codec = DependencyReplyCodec()
    messages = []
    for payload in payloads:
        if not payload or payload[0] != DependencyReplyCodec.tag:
            return None
        message, end = codec.decode(payload, 1)
        if end != len(payload):
            return None
        messages.append(message)
    columns = depruns.sets_to_columns([m.dependencies for m in messages])
    if columns is None:
        return None
    num_leaders, watermarks, counts, values = columns
    return _encode_run(DepReplyRunCodec(), DepReplyRun(
        num_leaders=num_leaders,
        headers=tuple((m.vertex_id.replica_index,
                       m.vertex_id.instance_number,
                       m.dep_service_node_index) for m in messages),
        watermarks=watermarks, counts=counts, values=values))


def _register() -> None:
    from frankenpaxos_tpu_torch.runtime import paxwire

    register_codec(PreAcceptOkRunCodec())
    register_codec(DepReplyRunCodec())
    # The protocol ack tags these runs coalesce (epaxos/wire.py
    # PreAcceptOkCodec, simplebpaxos/wire.py DependencyReplyCodec) --
    # literal here so this module never imports a protocol at load.
    paxwire.register_coalescer(15, _coalesce_pre_accept_ok)
    paxwire.register_coalescer(23, _coalesce_dependency_reply)


_register()
