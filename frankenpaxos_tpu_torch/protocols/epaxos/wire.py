"""Binary codecs for the EPaxos hot-path messages.

The EPaxos command path (PreAccept -> PreAcceptOk -> [Accept ->
AcceptOk] -> Commit, epaxos/EPaxos.proto) carries an
``InstancePrefixSet`` on every hop; pickling those nested column
objects dominated serialization. The binary layout packs each column
as ``[i64 watermark][u32 n][n x i64 sparse values]`` -- the same
(watermark, sparse tail) factorization the device DepSetBatch uses.
"""

from __future__ import annotations

import struct

from frankenpaxos_tpu_torch.compact import IntPrefixSet
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance,
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.protocols.epaxos.messages import (
    Accept,
    AcceptOk,
    ClientReply,
    ClientRequest,
    Command,
    CommandStatus,
    Commit,
    Nack,
    NOOP,
    Noop,
    PreAccept,
    PreAcceptOk,
    Prepare,
    PrepareOk,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    _put_address,
    _put_bytes,
    _take_address,
    _take_bytes,
)
from frankenpaxos_tpu_torch.runtime.serializer import MessageCodec, register_codec

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_I64I64 = struct.Struct("<qq")
# instance (replica i32, number i64) + ballot (ordering i64, replica i32)
_HDR = struct.Struct("<iqqi")


def _put_header(out: bytearray, instance: Instance, ballot) -> None:
    out += _HDR.pack(instance.replica_index, instance.instance_number,
                     ballot[0], ballot[1])


def _take_header(buf: bytes, at: int):
    r, n, b0, b1 = _HDR.unpack_from(buf, at)
    return Instance(r, n), (b0, b1), at + _HDR.size


def _put_command_or_noop(out: bytearray, value) -> None:
    if isinstance(value, Noop):
        out.append(0)
        return
    out.append(1)
    _put_address(out, value.client_address)
    out += _I64I64.pack(value.client_pseudonym, value.client_id)
    _put_bytes(out, value.command)


def _take_command_or_noop(buf: bytes, at: int):
    kind = buf[at]
    at += 1
    if kind == 0:
        return NOOP, at
    address, at = _take_address(buf, at)
    pseudonym, id = _I64I64.unpack_from(buf, at)
    payload, at = _take_bytes(buf, at + 16)
    return Command(address, pseudonym, id, payload), at


def _put_deps(out: bytearray, deps: InstancePrefixSet) -> None:
    out += _I32.pack(len(deps.columns))
    for column in deps.columns:
        out += _I64.pack(column.watermark)
        out += _I32.pack(len(column.values))
        for value in column.values:
            out += _I64.pack(value)


def _take_deps(buf: bytes, at: int):
    (num_columns,) = _I32.unpack_from(buf, at)
    at += 4
    columns = []
    for _ in range(num_columns):
        (watermark,) = _I64.unpack_from(buf, at)
        (n,) = _I32.unpack_from(buf, at + 8)
        at += 12
        values = set()
        for _ in range(n):
            (v,) = _I64.unpack_from(buf, at)
            values.add(v)
            at += 8
        columns.append(IntPrefixSet(watermark, values))
    return InstancePrefixSet(num_columns, columns), at


class _PhaseCodec(MessageCodec):
    """Shared layout for PreAccept/Accept/Commit (header + command +
    seq + deps) and their Oks (header + replica + seq + deps)."""

    has_command = True

    def encode(self, out, message):
        _put_header(out, message.instance, message.ballot)
        if self.has_command:
            _put_command_or_noop(out, message.command_or_noop)
        else:
            out += _I32.pack(message.replica_index)
        out += _I64.pack(message.sequence_number)
        _put_deps(out, message.dependencies)

    def decode(self, buf, at):
        instance, ballot, at = _take_header(buf, at)
        if self.has_command:
            value, at = _take_command_or_noop(buf, at)
        else:
            (replica,) = _I32.unpack_from(buf, at)
            at += 4
        (seq,) = _I64.unpack_from(buf, at)
        deps, at = _take_deps(buf, at + 8)
        if self.has_command:
            return self.message_type(
                instance=instance, ballot=ballot, command_or_noop=value,
                sequence_number=seq, dependencies=deps), at
        return self.message_type(
            instance=instance, ballot=ballot, replica_index=replica,
            sequence_number=seq, dependencies=deps), at


class PreAcceptCodec(_PhaseCodec):
    message_type = PreAccept
    tag = 14


class PreAcceptOkCodec(_PhaseCodec):
    message_type = PreAcceptOk
    tag = 15
    has_command = False


class AcceptCodec(_PhaseCodec):
    message_type = Accept
    tag = 16


class AcceptOkCodec(MessageCodec):
    message_type = AcceptOk
    tag = 20

    def encode(self, out, message):
        _put_header(out, message.instance, message.ballot)
        out += _I32.pack(message.replica_index)

    def decode(self, buf, at):
        instance, ballot, at = _take_header(buf, at)
        (replica,) = _I32.unpack_from(buf, at)
        return AcceptOk(instance=instance, ballot=ballot,
                        replica_index=replica), at + 4


class CommitCodec(MessageCodec):
    """Commit carries no ballot (EPaxos.proto Commit)."""

    message_type = Commit
    tag = 17

    def encode(self, out, message):
        instance = message.instance
        out += _I32.pack(instance.replica_index)
        out += _I64.pack(instance.instance_number)
        _put_command_or_noop(out, message.command_or_noop)
        out += _I64.pack(message.sequence_number)
        _put_deps(out, message.dependencies)

    def decode(self, buf, at):
        (replica,) = _I32.unpack_from(buf, at)
        (number,) = _I64.unpack_from(buf, at + 4)
        value, at = _take_command_or_noop(buf, at + 12)
        (seq,) = _I64.unpack_from(buf, at)
        deps, at = _take_deps(buf, at + 8)
        return Commit(instance=Instance(replica, number),
                      command_or_noop=value, sequence_number=seq,
                      dependencies=deps), at


class EPaxosClientRequestCodec(MessageCodec):
    message_type = ClientRequest
    tag = 18

    def encode(self, out, message):
        _put_command_or_noop(out, message.command)

    def decode(self, buf, at):
        command, at = _take_command_or_noop(buf, at)
        return ClientRequest(command), at


class EPaxosClientReplyCodec(MessageCodec):
    message_type = ClientReply
    tag = 19

    def encode(self, out, message):
        out += _I64I64.pack(message.client_pseudonym, message.client_id)
        _put_bytes(out, message.result)

    def decode(self, buf, at):
        pseudonym, id = _I64I64.unpack_from(buf, at)
        result, at = _take_bytes(buf, at + 16)
        return ClientReply(pseudonym, id, result), at


# --- the recovery cold path (extended tags 173-175) -------

_STATUS_CODES = {
    CommandStatus.NOT_SEEN: 0,
    CommandStatus.PRE_ACCEPTED: 1,
    CommandStatus.ACCEPTED: 2,
    CommandStatus.COMMITTED: 3,
}
_STATUS_BY_CODE = {v: k for k, v in _STATUS_CODES.items()}


class PrepareCodec(MessageCodec):
    message_type = Prepare
    tag = 173

    def encode(self, out, message):
        _put_header(out, message.instance, message.ballot)

    def decode(self, buf, at):
        instance, ballot, at = _take_header(buf, at)
        return Prepare(instance=instance, ballot=ballot), at


class EPaxosNackCodec(MessageCodec):
    message_type = Nack
    tag = 174

    def encode(self, out, message):
        _put_header(out, message.instance, message.largest_ballot)

    def decode(self, buf, at):
        instance, ballot, at = _take_header(buf, at)
        return Nack(instance=instance, largest_ballot=ballot), at


class PrepareOkCodec(MessageCodec):
    """header + replica + vote ballot + status byte + optional
    (command, seq, deps) -- absent exactly when the acceptor had
    NOT_SEEN state (the reply's Optionals)."""

    message_type = PrepareOk
    tag = 175

    def encode(self, out, message):
        _put_header(out, message.instance, message.ballot)
        out += _I32.pack(message.replica_index)
        out += _I64.pack(message.vote_ballot[0])
        out += _I32.pack(message.vote_ballot[1])
        out.append(_STATUS_CODES[message.status])
        if message.command_or_noop is None:
            out.append(0)
            return
        out.append(1)
        _put_command_or_noop(out, message.command_or_noop)
        out += _I64.pack(message.sequence_number)
        _put_deps(out, message.dependencies)

    def decode(self, buf, at):
        instance, ballot, at = _take_header(buf, at)
        (replica,) = _I32.unpack_from(buf, at)
        (b0,) = _I64.unpack_from(buf, at + 4)
        (b1,) = _I32.unpack_from(buf, at + 12)
        at += 16
        status = _STATUS_BY_CODE.get(buf[at])
        if status is None:
            raise ValueError(f"unknown PrepareOk status {buf[at]}")
        present = buf[at + 1]
        at += 2
        if not present:
            return PrepareOk(ballot=ballot, instance=instance,
                             replica_index=replica,
                             vote_ballot=(b0, b1), status=status,
                             command_or_noop=None,
                             sequence_number=None,
                             dependencies=None), at
        value, at = _take_command_or_noop(buf, at)
        (seq,) = _I64.unpack_from(buf, at)
        deps, at = _take_deps(buf, at + 8)
        return PrepareOk(ballot=ballot, instance=instance,
                         replica_index=replica, vote_ballot=(b0, b1),
                         status=status, command_or_noop=value,
                         sequence_number=seq, dependencies=deps), at


for _codec in (PreAcceptCodec(), PreAcceptOkCodec(), AcceptCodec(),
               AcceptOkCodec(), CommitCodec(),
               EPaxosClientRequestCodec(), EPaxosClientReplyCodec(),
               PrepareCodec(), EPaxosNackCodec(), PrepareOkCodec()):
    register_codec(_codec)

# Importing for side effect: registers the drain-coalesced
# PreAcceptOkRun codec and its paxwire coalescer for tag 15.
from frankenpaxos_tpu_torch.runs import wire as _run_wire  # noqa: E402,F401
