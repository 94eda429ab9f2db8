"""Binary codecs for the SimpleBPaxos / SimpleGcBPaxos hot path.

The BPaxos command path (DependencyRequest -> DependencyReply ->
Propose -> Phase2a/Phase2b -> Commit, simplebpaxos/SimpleBPaxos.proto)
carries a VertexIdPrefixSet on most hops; its wire form reuses the
EPaxos column layout (``_put_deps``/``_take_deps`` in
protocols/epaxos/wire.py -- VertexIdPrefixSet IS InstancePrefixSet).
SimpleGcBPaxos shares these message types.
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
from frankenpaxos_tpu_torch.protocols.simplebpaxos.messages import (
    ClientReply,
    ClientRequest,
    Command,
    Commit,
    DependencyReply,
    DependencyRequest,
    Nack,
    NOOP,
    Noop,
    Phase1a,
    Phase1b,
    Phase2a,
    Phase2b,
    Propose,
    Recover,
    VertexId,
    VoteValue,
)
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")
_VID = struct.Struct("<iq")  # (leader_index, id)


def _put_vertex(out: bytearray, vertex_id: VertexId) -> None:
    out += _VID.pack(vertex_id.replica_index, vertex_id.instance_number)


def _take_vertex(buf: bytes, at: int):
    leader, id = _VID.unpack_from(buf, at)
    return VertexId(leader, id), at + _VID.size


def _put_command(out: bytearray, command) -> None:
    """A Command, or (GcBPaxos) a sentinel like SnapshotMarker riding a
    pickled escape hatch."""
    if isinstance(command, Command):
        out.append(0)
        _put_address(out, command.client_address)
        out += _I64I64.pack(command.client_pseudonym, command.client_id)
        _put_bytes(out, command.command)
    else:
        from frankenpaxos_tpu_torch.runtime import serializer

        out.append(1)
        _put_bytes(out, serializer.guarded_pickle_dumps(command, "command"))


def _take_command(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == 1:
        from frankenpaxos_tpu_torch.runtime import serializer

        raw, at = _take_bytes(buf, at)
        return serializer.guarded_pickle_loads(raw, "command"), at
    address, at = _take_address(buf, at)
    pseudonym, id = _I64I64.unpack_from(buf, at)
    payload, at = _take_bytes(buf, at + 16)
    return Command(address, pseudonym, id, payload), at


def _put_vote_value(out: bytearray, value: VoteValue) -> None:
    if isinstance(value.command_or_noop, Noop):
        out.append(0)
    else:
        out.append(1)
        _put_command(out, value.command_or_noop)
    _put_deps(out, value.dependencies)


def _take_vote_value(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == 0:
        command = NOOP
    else:
        command, at = _take_command(buf, at)
    deps, at = _take_deps(buf, at)
    return VoteValue(command, deps), at


class BPaxosClientRequestCodec(MessageCodec):
    message_type = ClientRequest
    tag = 21

    def encode(self, out, message):
        _put_command(out, message.command)

    def decode(self, buf, at):
        command, at = _take_command(buf, at)
        return ClientRequest(command), at


class DependencyRequestCodec(MessageCodec):
    message_type = DependencyRequest
    tag = 22

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        _put_command(out, message.command)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        command, at = _take_command(buf, at)
        return DependencyRequest(vertex_id, command), at


class DependencyReplyCodec(MessageCodec):
    message_type = DependencyReply
    tag = 23

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        out += _I32.pack(message.dep_service_node_index)
        _put_deps(out, message.dependencies)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        (node,) = _I32.unpack_from(buf, at)
        deps, at = _take_deps(buf, at + 4)
        return DependencyReply(vertex_id, node, deps), at


class ProposeCodec(MessageCodec):
    message_type = Propose
    tag = 24

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        _put_command(out, message.command)
        _put_deps(out, message.dependencies)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        command, at = _take_command(buf, at)
        deps, at = _take_deps(buf, at)
        return Propose(vertex_id, command, deps), at


class BPaxosPhase2aCodec(MessageCodec):
    message_type = Phase2a
    tag = 25

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        out += _I64.pack(message.round)
        _put_vote_value(out, message.vote_value)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        (round,) = _I64.unpack_from(buf, at)
        value, at = _take_vote_value(buf, at + 8)
        return Phase2a(vertex_id, round, value), at


class BPaxosPhase2bCodec(MessageCodec):
    message_type = Phase2b
    tag = 26

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        out += _I64I64.pack(message.acceptor_id, message.round)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        acceptor, round = _I64I64.unpack_from(buf, at)
        return Phase2b(vertex_id, acceptor, round), at + 16


class BPaxosCommitCodec(MessageCodec):
    """Commit shares the command-or-noop + deps framing with
    VoteValue, so it reuses that codec pair."""

    message_type = Commit
    tag = 27

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        _put_vote_value(out, VoteValue(message.command_or_noop,
                                       message.dependencies))

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        value, at = _take_vote_value(buf, at)
        return Commit(vertex_id, value.command_or_noop,
                      value.dependencies), at


class BPaxosClientReplyCodec(MessageCodec):
    message_type = ClientReply
    tag = 28

    def encode(self, out, message):
        out += _I64I64.pack(message.client_pseudonym, message.client_id)
        _put_bytes(out, message.result)

    def decode(self, buf, at):
        pseudonym, id = _I64I64.unpack_from(buf, at)
        result, at = _take_bytes(buf, at + 16)
        return ClientReply(pseudonym, id, result), at


# --- the recovery cold path (extended tags 176-178) -------


class BPaxosPhase1aCodec(MessageCodec):
    message_type = Phase1a
    tag = 176

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        out += _I64.pack(message.round)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        (round,) = _I64.unpack_from(buf, at)
        return Phase1a(vertex_id=vertex_id, round=round), at + 8


class BPaxosPhase1bCodec(MessageCodec):
    message_type = Phase1b
    tag = 177

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        out += _I32.pack(message.acceptor_id)
        out += _I64I64.pack(message.round, message.vote_round)
        if message.vote_value is None:
            out.append(0)
        else:
            out.append(1)
            _put_vote_value(out, message.vote_value)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        (acceptor_id,) = _I32.unpack_from(buf, at)
        round, vote_round = _I64I64.unpack_from(buf, at + 4)
        present = buf[at + 20]
        at += 21
        vote_value = None
        if present:
            vote_value, at = _take_vote_value(buf, at)
        return Phase1b(vertex_id=vertex_id, acceptor_id=acceptor_id,
                       round=round, vote_round=vote_round,
                       vote_value=vote_value), at


class BPaxosNackCodec(MessageCodec):
    message_type = Nack
    tag = 178

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)
        out += _I64.pack(message.higher_round)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        (higher_round,) = _I64.unpack_from(buf, at)
        return Nack(vertex_id=vertex_id,
                    higher_round=higher_round), at + 8


class BPaxosRecoverCodec(MessageCodec):
    """Hole recovery for a committed-but-unexecuted vertex (the cold
    path): per-hole traffic, but it is exactly what is on
    the wire while a replica catches up after a crash, and pickled
    frames are refused under ``set_pickle_fallback(False)``."""

    message_type = Recover
    tag = 200

    def encode(self, out, message):
        _put_vertex(out, message.vertex_id)

    def decode(self, buf, at):
        vertex_id, at = _take_vertex(buf, at)
        return Recover(vertex_id=vertex_id), at


for _codec in (BPaxosClientRequestCodec(), DependencyRequestCodec(),
               DependencyReplyCodec(), ProposeCodec(),
               BPaxosPhase2aCodec(), BPaxosPhase2bCodec(),
               BPaxosCommitCodec(), BPaxosClientReplyCodec(),
               BPaxosPhase1aCodec(), BPaxosPhase1bCodec(),
               BPaxosNackCodec(), BPaxosRecoverCodec()):
    register_codec(_codec)

# Importing for side effect: registers the drain-coalesced DepReplyRun
# codec and its paxwire coalescer for tag 23.
from frankenpaxos_tpu_torch.runs import wire as _run_wire  # noqa: E402,F401
