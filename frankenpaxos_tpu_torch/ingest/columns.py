"""SoA column views over undecoded wire bytes (the zero-object path);
the port's copy of ``frankenpaxos_tpu/ingest/columns.py``.

A :class:`ColumnRun` is the ingestion plane's descriptor for a run of
client commands that never materialized as Python objects: the
canonical value-array segment (``raw`` -- what ``LazyValueArray``
wraps and ``Phase2aRun`` forwards as a raw copy) plus int64 columns
``(addr_idx, pseudonym, client_id, value_off, value_len)`` indexing
into ``buf``. Everything a consumer needs off the hot path -- reply
routing, admission rejects, cold-path decode -- reads the columns or
the (tiny, per-client) address table, never per-command objects.

All scans ride ``native.ingest_scan`` / ``native.value_columns`` with
bit-identical pure-Python fallbacks (tests/test_torch_native.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from frankenpaxos_tpu_torch import native

#: Column indices in ``ColumnRun.cols``.
COL_ADDR, COL_PSEUDONYM, COL_ID, COL_OFF, COL_LEN = range(5)

#: The un-batched coalesced-client frame tag
#: (multipaxos wire.ClientRequestArrayCodec.tag) -- sinks register it
#: alongside the batch tag so a lone array frame also lands as columns.
CLIENT_ARRAY_TAG = 115


class ColumnRun:
    """One drain-granular run as SoA columns over undecoded bytes."""

    __slots__ = ("raw", "cols", "buf", "_addresses", "_body_start")

    def __init__(self, raw: bytes, cols: np.ndarray, buf):
        self.raw = raw
        self.cols = cols
        self.buf = buf
        self._addresses = None
        self._body_start = None

    def __len__(self) -> int:
        return len(self.cols)

    @property
    def count(self) -> int:
        return len(self.cols)

    def addresses(self) -> list:
        """The decoded address table (one entry per CLIENT, not per
        command -- the only per-entry Python this view ever builds)."""
        if self._addresses is None:
            import struct

            from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
                _take_address,
            )

            (t,) = struct.unpack_from("<i", self.raw, 0)
            at = 4
            addresses = []
            for _ in range(t):
                address, at = _take_address(self.raw, at)
                addresses.append(address)
            self._addresses = addresses
            self._body_start = at
        return self._addresses

    def value_bytes(self, i: int) -> bytes:
        off = int(self.cols[i, COL_OFF])
        return bytes(self.buf[off:off + int(self.cols[i, COL_LEN])])

    def to_owned(self) -> "ColumnRun":
        """An ownership-safe twin whose ``buf`` no longer borrows the
        transport's receive buffer. ``cols`` offsets index into
        ``buf``, so the copy preserves them verbatim; when ``buf`` is
        already immutable ``bytes`` the run owns its storage and is
        returned as-is. Wire-sink handlers MUST call this before
        staging a run past the dispatch."""
        if type(self.buf) is bytes:
            return self
        owned = ColumnRun(raw=self.raw, cols=self.cols,
                          buf=bytes(self.buf))
        owned._addresses = self._addresses
        owned._body_start = self._body_start
        return owned

    def values(self, k: "Optional[int]" = None):
        """Cold path: decode the first ``k`` entries into the ordinary
        CommandBatch tuple (Phase1 stash, unsupported-shape
        fallbacks)."""
        from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
            LazyValueArray,
        )

        decoded = tuple(LazyValueArray(self.raw, len(self.cols)))
        return decoded if k is None else decoded[:k]

    def commands(self, k: "Optional[int]" = None) -> list:
        return [value.commands[0] for value in self.values(k)]

    def prefix_raw(self, k: int) -> bytes:
        """The value-array segment for the first ``k`` entries. Bodies
        are contiguous and self-delimiting, so a prefix is a SLICE --
        the (deduped) address table stays whole; entries past ``k`` may
        leave unused table rows, which decode ignores."""
        if k >= len(self.cols):
            return self.raw
        lens = self.cols[:, COL_LEN]
        body = 29 * len(self.cols) + int(lens.sum())
        body_start = len(self.raw) - body
        return self.raw[:body_start + 29 * k + int(lens[:k].sum())]

    def lazy_values(self, k: "Optional[int]" = None):
        from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
            LazyValueArray,
        )

        if k is None or k >= len(self.cols):
            return LazyValueArray(self.raw, len(self.cols))
        return LazyValueArray(self.prefix_raw(k), k)

    def reject_entries(self, k: int, retry_after_ms: int,
                       reason: int) -> list:
        """Explicit ``Rejected`` replies for the suffix past ``k``,
        grouped per client straight off the columns -- the admission
        refusal path without a single decoded Command."""
        from frankenpaxos_tpu_torch.serve.messages import Rejected

        cols = self.cols[k:]
        if not len(cols):
            return []
        addresses = self.addresses()
        out = []
        for idx in np.unique(cols[:, COL_ADDR]):
            rows = cols[cols[:, COL_ADDR] == idx]
            entries = tuple(
                (int(p), int(c))
                for p, c in zip(rows[:, COL_PSEUDONYM], rows[:, COL_ID]))
            out.append((addresses[int(idx)], Rejected(
                entries=entries, retry_after_ms=retry_after_ms,
                reason=reason)))
        return out


def reject_value_suffix(send, values, k: int, admission) -> None:
    """Explicit Rejected replies for a run's refused suffix (entries
    past ``k``): column-routed when the descriptor supports it, decoded
    otherwise -- refusal is the cold path either way. ``send`` is the
    rejecting actor's ``send`` bound method. Shared by the MultiPaxos
    and Mencius leaders' IngestRun admission."""
    view = value_view(values)
    if view is not None:
        for address, reply in view.reject_entries(
                k, admission.retry_after_ms(), admission.last_reason):
            send(address, reply)
        return
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
        ClientRequestBatch,
        CommandBatch,
        Noop,
    )
    from frankenpaxos_tpu_torch.serve.admission import reject_replies_for

    commands = tuple(
        command for value in tuple(values)[k:]
        if not isinstance(value, Noop)
        for command in value.commands)
    if not commands:
        return
    for address, reply in reject_replies_for(
            ClientRequestBatch(CommandBatch(commands)),
            admission.retry_after_ms(), admission.last_reason):
        send(address, reply)


def parse_client_batch(data) -> "Optional[ColumnRun]":
    """One-pass scan of a ClientFrameBatch payload (leading 0x00+tag
    included) into a ColumnRun. None = unsupported shape (mixed tags,
    exotic addresses): the caller falls back to per-message decode.
    Raises ValueError on a torn/corrupt table (the transport's
    corrupt-frame containment channel)."""
    scanned = native.ingest_scan(data, 2)
    if scanned is None:
        return None
    raw, cols = scanned
    return ColumnRun(raw=raw, cols=cols, buf=data)


def parse_client_array(data) -> "Optional[ColumnRun]":
    """One-pass scan of a SINGLE ClientRequestArray frame payload (a
    coalescing client's un-batched message, leading tag 115) into a
    ColumnRun -- wrapped as a one-segment batch so the native scan
    applies unchanged. Same None/ValueError contract as
    :func:`parse_client_batch`."""
    wrapped = bytes(native.batch_header(151, [len(data)])) \
        + bytes(data)
    scanned = native.ingest_scan(wrapped, 2)
    if scanned is None:
        return None
    raw, cols = scanned
    # Offsets index the wrapped buffer; keep it as the view's buf.
    return ColumnRun(raw=raw, cols=cols, buf=wrapped)


def value_view(values) -> "Optional[ColumnRun]":
    """Columns over an already-landed run (``IngestRun.values`` as a
    LazyValueArray): the leader's admission/reject path without decode.
    None for plain tuples or segments holding anything but one-command
    batches."""
    raw = getattr(values, "raw", None)
    if raw is None:
        return None
    cols = native.value_columns(raw, len(values))
    if cols is None:
        return None
    return ColumnRun(raw=raw, cols=cols, buf=raw)


# --- Phase2b ack columns -----------------------------------------------------
# The control-plane twin: a batch frame whose segments are vote acks
# (plain Phase2b tag 1, Phase2bRange tag 13, coalesced Phase2bAckBatch
# tag 152) lands as ONE (n, 5) int64 array of (start, end, round,
# group, acceptor) rows -- the proxy leader's quorum tracker consumes
# ranges without a Phase2b/Phase2bRange object per segment.

_ACK_REC = np.dtype([("start", "<i8"), ("end", "<i8"), ("round", "<i8"),
                     ("group", "<i4"), ("acceptor", "<i4")])
_P2B_TAG = 1
_P2B_RANGE_TAG = 13
_ACK_BATCH_TAG = 152


class AckColumns:
    """A batch frame's vote acks as (n, 5) int64 rows of (start, end,
    round, group, acceptor). ``count`` reports the SEGMENT count (the
    messages the frame replaced) for drain bookkeeping; singleton rows
    are width-1 ranges."""

    __slots__ = ("rows", "count")

    def __init__(self, rows: np.ndarray, count: int):
        self.rows = rows
        self.count = count

    def __len__(self) -> int:
        return len(self.rows)


# --- client reply columns ----------------------------------------------------
# The RETURN-path twin (paxfan): a ClientReplyArray frame (tag 118) --
# a replica's per-client fan-out for one ChosenRun drain, or several of
# them merged by the flush-time coalescer -- lands as ONE (n, 5) int64
# array of (pseudonym, client_id, slot, result_off, result_len) rows.
# An open-loop SoA client acks a whole drain of replies with numpy
# column ops, never one ClientReply tuple per command.

#: multipaxos wire.ClientReplyArrayCodec.tag -- the reply-array frame a
#: reply sink registers for.
REPLY_ARRAY_TAG = 118

#: Column indices in ``ReplyColumns.cols``.
RCOL_PSEUDONYM, RCOL_ID, RCOL_SLOT, RCOL_OFF, RCOL_LEN = range(5)


class ReplyColumns:
    """One reply-array frame's entries as SoA columns over undecoded
    bytes (the return-path :class:`ColumnRun`)."""

    __slots__ = ("cols", "buf")

    def __init__(self, cols: np.ndarray, buf):
        self.cols = cols
        self.buf = buf

    def __len__(self) -> int:
        return len(self.cols)

    def result_bytes(self, i: int) -> bytes:
        off = int(self.cols[i, RCOL_OFF])
        return bytes(self.buf[off:off + int(self.cols[i, RCOL_LEN])])

    def to_owned(self) -> "ReplyColumns":
        """Ownership-safe twin (see :meth:`ColumnRun.to_owned`): sinks
        MUST call this before staging past the dispatch."""
        if type(self.buf) is bytes:
            return self
        return ReplyColumns(cols=self.cols, buf=bytes(self.buf))


def parse_reply_array(data) -> "Optional[ReplyColumns]":
    """One-pass scan of a ClientReplyArray frame payload (leading tag
    118 included) into ReplyColumns. None = unsupported shape (the
    caller falls back to per-message decode); ValueError = torn/corrupt
    (the transport's corrupt-frame containment channel)."""
    if not len(data) or data[0] != REPLY_ARRAY_TAG:
        return None
    cols = native.reply_columns(data, 1)
    if cols is None:
        return None
    return ReplyColumns(cols=cols, buf=data)


def parse_ack_batch(data) -> "Optional[AckColumns]":
    """Scan a control batch frame of vote acks into range rows. None =
    some segment is not an ack shape (fall back to per-message decode);
    ValueError = torn/corrupt (corrupt-frame containment)."""
    import struct

    segs = native.scan_batch(data, 2)
    parts: list = []   # arrays, in segment (send) order
    pending: list = []  # scalar rows awaiting the next array boundary

    def flush_pending() -> None:
        if pending:
            parts.append(np.asarray(pending,
                                    dtype=np.int64).reshape(-1, 5))
            pending.clear()

    for s, e in segs:
        if e - s < 1:
            raise ValueError("malformed ack batch: empty segment")
        tag = data[s]
        if tag == _P2B_TAG and e - s == 25:
            slot, rnd, group, acceptor = struct.unpack_from(
                "<qqii", data, s + 1)
            pending.append((slot, slot + 1, rnd, group, acceptor))
        elif tag == _P2B_RANGE_TAG and e - s == 33:
            pending.append(struct.unpack_from("<qqqii", data, s + 1))
        elif tag == 0 and e - s >= 6 \
                and data[s + 1] == _ACK_BATCH_TAG - 128:
            (n,) = struct.unpack_from("<i", data, s + 2)
            if n < 0 or s + 6 + n * _ACK_REC.itemsize != e:
                raise ValueError(
                    f"malformed ack batch: count {n} vs segment")
            rec = np.frombuffer(data, dtype=_ACK_REC, count=n,
                                offset=s + 6)
            flush_pending()
            parts.append(np.column_stack([
                rec["start"], rec["end"], rec["round"],
                rec["group"].astype(np.int64),
                rec["acceptor"].astype(np.int64)]))
        else:
            return None
    flush_pending()
    if not parts:
        return AckColumns(np.empty((0, 5), dtype=np.int64), len(segs))
    merged = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return AckColumns(merged, len(segs))
