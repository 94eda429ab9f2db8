"""ctypes loader for the port's native wire codec (with pure-Python
fallbacks); the port's copy of ``frankenpaxos_tpu/native/__init__.py``.

``g++`` compiles this package's own ``codec.cpp`` at first use into
``native/_build/libfpxcodec-<hash>.so``, the hash taken over the source
and the flags, so an edited source builds a new library and a stale one
is never loaded. Processes that build at once (test workers) take turns
on a lock file; the second finds the first one's library. Nothing is
written beside the source, and no other package's library is loaded.
Every entry point has a NumPy/struct fallback, bit-identical to the
native path, so the framework runs where no compiler exists;
:func:`load` says which one runs (the library, or ``None`` with the
reason in :func:`load_error`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "codec.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LEN = struct.Struct(">I")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_load_error: Optional[str] = None


def library_path() -> str:
    """Where the library built from this source and these flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libfpxcodec-{digest.hexdigest()[:16]}.so")


def _build(target: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(target):
                return
            tmp = f"{target}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                               check=True, capture_output=True)
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_error() -> Optional[str]:
    """Why :func:`load` returned None (None while it has not failed)."""
    return _load_error


def load() -> Optional[ctypes.CDLL]:
    """The codec library, building it if needed; None when it cannot be
    built or loaded (then every entry point runs its Python fallback)."""
    global _lib, _load_failed, _load_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        target = library_path()
        if not os.path.exists(target):
            _build(target)
        lib = ctypes.CDLL(target)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fpx_encode_frame.restype = ctypes.c_longlong
        lib.fpx_encode_frame.argtypes = [
            u8p, ctypes.c_uint32, u8p, ctypes.c_uint32, u8p,
            ctypes.c_uint64]
        lib.fpx_encode_frames.restype = ctypes.c_longlong
        lib.fpx_encode_frames.argtypes = [
            u8p, ctypes.c_uint32, u8p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint32, u8p, ctypes.c_uint64]
        lib.fpx_scan_frames.restype = ctypes.c_longlong
        lib.fpx_scan_frames.argtypes = [
            u8p, ctypes.c_uint64, u64p, ctypes.c_uint32, u64p]
        lib.fpx_batch_header.restype = ctypes.c_longlong
        lib.fpx_batch_header.argtypes = [
            ctypes.c_uint8, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint32, u8p, ctypes.c_uint64]
        lib.fpx_scan_batch.restype = ctypes.c_longlong
        lib.fpx_scan_batch.argtypes = [
            u8p, ctypes.c_uint64, u64p, ctypes.c_uint32]
        lib.fpx_pack_votes.restype = ctypes.c_longlong
        lib.fpx_pack_votes.argtypes = [
            i32p, i32p, i32p, ctypes.c_uint32, u8p, ctypes.c_uint64]
        lib.fpx_unpack_votes.restype = ctypes.c_longlong
        lib.fpx_unpack_votes.argtypes = [
            u8p, ctypes.c_uint64, i32p, i32p, i32p, ctypes.c_uint32]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fpx_pack_votes2.restype = ctypes.c_longlong
        lib.fpx_pack_votes2.argtypes = [
            i64p, i32p, ctypes.c_uint32, u8p, ctypes.c_uint64]
        lib.fpx_unpack_votes2.restype = ctypes.c_longlong
        lib.fpx_unpack_votes2.argtypes = [
            u8p, ctypes.c_uint64, i64p, i32p, ctypes.c_uint32]
        lib.fpx_ingest_scan.restype = ctypes.c_longlong
        lib.fpx_ingest_scan.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, u64p, i64p,
            ctypes.c_uint32]
        lib.fpx_value_columns.restype = ctypes.c_longlong
        lib.fpx_value_columns.argtypes = [
            u8p, ctypes.c_uint64, i64p, ctypes.c_uint32,
            ctypes.c_uint32]
        lib.fpx_reply_columns.restype = ctypes.c_longlong
        lib.fpx_reply_columns.argtypes = [
            u8p, ctypes.c_uint64, i64p, ctypes.c_uint32]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _load_failed = True
        stderr = getattr(e, "stderr", None)
        _load_error = (f"{e!r}: {stderr.decode(errors='replace')}"
                       if stderr else repr(e))
    return _lib


def _as_u8p(buf) -> ctypes.POINTER(ctypes.c_uint8):  # type: ignore[misc]
    return (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf) if buf else \
        ctypes.cast(0, ctypes.POINTER(ctypes.c_uint8))


_U8P = ctypes.POINTER(ctypes.c_uint8)


# Deliberately exports a (pointer, keepalive) pair: every call site
# dels BOTH immediately after the native call, before any buffer
# resize/compaction can run (a live export makes it raise BufferError).
def _as_u8p_view(buf, offset: int = 0):
    """READ-ONLY pointer to ``buf[offset:]`` WITHOUT copying the buffer
    (the `_as_u8p` copy was the receive path's quadratic cost: every
    4096-frame scan pass re-copied the whole inbound buffer). Returns
    ``(pointer, keepalive)`` -- the caller must hold ``keepalive`` for
    the duration of the native call and drop it before mutating ``buf``
    (a live ``from_buffer`` export makes ``bytearray`` resizes raise
    BufferError)."""
    n = len(buf) - offset
    if n <= 0:
        return ctypes.cast(0, _U8P), None
    if isinstance(buf, (bytearray, memoryview)):
        # The ARRAY OBJECT itself is the pointer argument (ctypes
        # accepts arrays where POINTER(c_uint8) is declared). Never
        # ``ctypes.cast`` it: the cast pointer participates in a
        # reference cycle, so the buffer export would survive until a
        # gc pass and any bytearray resize in between would raise
        # BufferError. Dropping the array releases it immediately.
        arr = (ctypes.c_uint8 * n).from_buffer(buf, offset)
        return arr, arr
    # bytes (immutable): c_char_p points at the object's internal
    # storage; no copy, kept alive by holding the bytes object itself.
    base = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
    return ctypes.cast(ctypes.c_void_p(base + offset), _U8P), buf


def encode_frame(header: bytes, payload: bytes) -> bytes:
    """One wire frame: [u32 total][u32 hlen][header][payload]."""
    lib = load()
    if lib is None:
        inner = _LEN.pack(len(header)) + header + payload
        return _LEN.pack(len(inner)) + inner
    out = (ctypes.c_uint8 * (12 + len(header) + len(payload)))()
    n = lib.fpx_encode_frame(_as_u8p(header), len(header),
                             _as_u8p(payload), len(payload), out, len(out))
    if n == -2:
        raise ValueError("frame exceeds the 10 MiB cap")
    assert n >= 0
    return bytes(out[:n])


def encode_frames(header: bytes, payloads: list[bytes]) -> bytes:
    """Coalesce many same-header frames into one write buffer."""
    lib = load()
    if lib is None:
        return b"".join(encode_frame(header, p) for p in payloads)
    blob = b"".join(payloads)
    lens = (ctypes.c_uint32 * len(payloads))(*[len(p) for p in payloads])
    cap = sum(12 + len(header) + len(p) for p in payloads)
    out = (ctypes.c_uint8 * max(cap, 1))()
    n = lib.fpx_encode_frames(_as_u8p(header), len(header), _as_u8p(blob),
                              lens, len(payloads), out, len(out))
    if n == -2:
        raise ValueError("frame exceeds the 10 MiB cap")
    assert n >= 0
    return bytes(out[:n])


def scan_frames(buf, max_frames: int = 4096, offset: int = 0
                ) -> tuple[list[tuple[int, int]], int]:
    """Complete frames' (start, end) inner offsets + consumed cursor.

    ``buf`` may be bytes, bytearray, or a memoryview; the scan starts
    at ``offset`` and NEVER copies the buffer (the transport keeps an
    offset cursor into its growing inbound bytearray instead of
    re-slicing per pass). Returned offsets and the consumed cursor are
    ABSOLUTE positions in ``buf``."""
    lib = load()
    if lib is None:
        frames, pos, end = [], offset, len(buf)
        while pos + 4 <= end and len(frames) < max_frames:
            (inner,) = _LEN.unpack_from(buf, pos)
            if inner > 10 * 1024 * 1024:
                raise ValueError("frame exceeds the 10 MiB cap")
            if pos + 4 + inner > end:
                break
            frames.append((pos + 4, pos + 4 + inner))
            pos += 4 + inner
        return frames, pos
    offsets = (ctypes.c_uint64 * (2 * max_frames))()
    consumed = ctypes.c_uint64()
    ptr, keepalive = _as_u8p_view(buf, offset)
    try:
        n = lib.fpx_scan_frames(ptr, len(buf) - offset, offsets,
                                max_frames, ctypes.byref(consumed))
    finally:
        del ptr, keepalive  # release the buffer export before returning
    if n == -2:
        raise ValueError("frame exceeds the 10 MiB cap")
    return ([(offset + offsets[2 * i], offset + offsets[2 * i + 1])
             for i in range(n)],
            offset + consumed.value)


# --- paxwire batch frames ---------------------------------------------------
# One batch frame carries a whole drain's same-type messages to a peer:
#   [0x00][batch tag - 128][u32le count][count * u32le seg_len][segments]
# The header (everything before the segments) is built in ONE native
# call; the segments ride as raw scatter/gather slices (sendmsg) or one
# join -- either way the bytes on the wire are identical.

_U32LE = struct.Struct("<I")


def batch_header(tag: int, seg_lens) -> bytes:
    """The batch payload header for extended-page wire ``tag`` over
    segments of the given lengths (the vectorized encode: one dispatch
    per drain's batch, not one struct.pack per message)."""
    n = len(seg_lens)
    lib = load()
    if lib is None:
        out = bytearray(2 + 4 + 4 * n)
        out[0] = 0
        out[1] = tag - 128
        _U32LE.pack_into(out, 2, n)
        pos = 6
        for seg_len in seg_lens:
            _U32LE.pack_into(out, pos, seg_len)
            pos += 4
        return bytes(out)
    lens = (ctypes.c_uint32 * n)(*seg_lens)
    out = (ctypes.c_uint8 * (6 + 4 * n))()
    written = lib.fpx_batch_header(tag - 128, lens, n, out, len(out))
    assert written == len(out)
    return bytes(out)


def scan_batch(buf, at: int, max_segs: int = 1 << 20
               ) -> list[tuple[int, int]]:
    """Segment (start, end) offsets of a batch payload whose u32 count
    sits at ``buf[at:]`` (the two leading tag bytes already consumed).
    Raises ValueError on a malformed table -- the containment channel
    for torn/corrupt batch frames (count or lengths exceeding the
    payload, trailing garbage)."""
    lib = load()
    n_left = len(buf) - at
    if lib is None:
        if n_left < 4:
            raise ValueError("malformed batch frame: short count header")
        (n,) = _U32LE.unpack_from(buf, at)
        if n > max_segs or 4 + 4 * n > n_left:
            raise ValueError(
                f"malformed batch frame: count {n} exceeds payload")
        pos = at + 4 + 4 * n
        segs = []
        for i in range(n):
            (seg_len,) = _U32LE.unpack_from(buf, at + 4 + 4 * i)
            if pos + seg_len > len(buf):
                raise ValueError(
                    "malformed batch frame: segment overruns payload")
            segs.append((pos, pos + seg_len))
            pos += seg_len
        if pos != len(buf):
            raise ValueError("malformed batch frame: trailing garbage")
        return segs
    # Cap the offsets table by what the payload could possibly hold so
    # a hostile count can never size a huge allocation.
    cap = min(max_segs, max(n_left // 4, 1))
    offsets = (ctypes.c_uint64 * (2 * cap))()
    ptr, keepalive = _as_u8p_view(buf, at)
    try:
        n = lib.fpx_scan_batch(ptr, n_left, offsets, cap)
    finally:
        del ptr, keepalive
    if n < 0:
        raise ValueError("malformed batch frame")
    return [(at + offsets[2 * i], at + offsets[2 * i + 1])
            for i in range(n)]


# --- paxingest column scans (ingest/, docs/TRANSPORT.md) --------------------
# The zero-object decode path: a ClientFrameBatch payload scans ONCE into
# (a) the run pipeline's value-array segment (LazyValueArray.raw layout,
# deduped first-seen address table) and (b) SoA descriptor columns
# (addr_idx, pseudonym, client_id, value_off, value_len) -- no
# per-message Python object between recv() and the leader's Phase2aRun.
# Contract shared by native and fallback: ValueError = torn/corrupt
# (the transport's corrupt-frame containment channel); None = well-formed
# but unsupported shape (mixed tags, exotic address kinds, trailing
# bytes) -- the caller falls back to ordinary per-message decode.

_CLIENT_REQUEST_TAG = 4    # multipaxos ClientRequest
_CLIENT_ARRAY_TAG = 115    # multipaxos ClientRequestArray (coalesced)
_MAX_INGEST_ADDRS = 4096   # codec.cpp kMaxIngestAddrs (parity)
_COLS = 5  # addr_idx, pseudonym, client_id, value_off, value_len
_I64X2 = struct.Struct("<qq")


def _py_ingest_scan(buf, at: int, max_cmds: int = 1 << 20):
    n_left = len(buf) - at
    if n_left < 4:
        raise ValueError("malformed batch frame: short count header")
    (n,) = _U32LE.unpack_from(buf, at)
    if 4 + 4 * n > n_left:
        raise ValueError(
            f"malformed batch frame: count {n} exceeds payload")
    # The same effective cap the native wrapper sizes its buffers by
    # (bit-for-bit verdict parity; see ingest_scan).
    max_cmds = min(max_cmds, n_left // 20 + 8)
    if n > max_cmds:
        return None
    rows: list = []
    addr_spans: list = []   # each unique address's raw bytes
    addr_index: dict = {}   # raw bytes -> index
    seg_at = at + 4 + 4 * n
    for i in range(n):
        (seg_len,) = _U32LE.unpack_from(buf, at + 4 + 4 * i)
        if seg_at + seg_len > len(buf):
            raise ValueError(
                "malformed batch frame: segment overruns payload")
        if seg_len < 2:
            raise ValueError("malformed ingest segment: too short")
        tag = buf[seg_at]
        if tag not in (_CLIENT_REQUEST_TAG, _CLIENT_ARRAY_TAG):
            return None
        kind = buf[seg_at + 1]
        if seg_len < 6:
            raise ValueError("malformed ingest segment: short address")
        (alen,) = _U32LE.unpack_from(buf, seg_at + 2)
        a_end = 6 + alen
        if kind == 1:
            a_end += 4
        elif kind not in (0, 2):
            return None
        if a_end > seg_len:
            raise ValueError("malformed ingest segment: short address")
        araw = bytes(buf[seg_at + 1:seg_at + a_end])
        idx = addr_index.get(araw)
        if idx is None:
            if len(addr_spans) == _MAX_INGEST_ADDRS:
                return None  # mirrors codec.cpp kMaxIngestAddrs
            idx = len(addr_spans)
            addr_index[araw] = idx
            addr_spans.append(araw)
        if tag == _CLIENT_REQUEST_TAG:
            entry_at, n_entries = a_end, 1
        else:
            if a_end + 4 > seg_len:
                raise ValueError(
                    "malformed ingest segment: short array count")
            (n_entries,) = _U32LE.unpack_from(buf, seg_at + a_end)
            entry_at = a_end + 4
        for _ in range(n_entries):
            if entry_at + 20 > seg_len:
                raise ValueError(
                    "malformed ingest segment: short command")
            (vlen,) = _U32LE.unpack_from(buf,
                                         seg_at + entry_at + 16)
            if entry_at + 20 + vlen > seg_len:
                raise ValueError(
                    "malformed ingest segment: value overruns segment")
            if len(rows) == max_cmds:
                return None
            pseudonym, client_id = _I64X2.unpack_from(
                buf, seg_at + entry_at)
            rows.append((idx, pseudonym, client_id,
                         seg_at + entry_at + 20, vlen))
            entry_at += 20 + vlen
        if entry_at != seg_len:
            return None  # trailing bytes: let the codec decide
        seg_at += seg_len
    if seg_at != len(buf):
        raise ValueError("malformed batch frame: trailing garbage")
    cols = np.asarray(rows, dtype=np.int64).reshape(-1, _COLS)
    out = bytearray()
    out += _U32LE.pack(len(addr_spans))
    for araw in addr_spans:
        out += araw
    for idx, pseudonym, client_id, voff, vlen in rows:
        out.append(1)
        out += _U32LE.pack(1)
        out += _U32LE.pack(idx)
        out += _I64X2.pack(pseudonym, client_id)
        out += _U32LE.pack(vlen)
        out += buf[voff:voff + vlen]
    return bytes(out), cols


def ingest_scan(buf, at: int = 2, max_cmds: int = 1 << 20):
    """Scan a ClientFrameBatch payload (``buf[at:]`` starts at the u32
    segment count) into ``(value_array_raw, columns)`` in one pass, or
    None when the batch's shape is unsupported. Raises ValueError on a
    torn/corrupt table -- the corrupt-frame containment channel."""
    lib = load()
    if lib is None:
        return _py_ingest_scan(buf, at, max_cmds)
    n_left = len(buf) - at
    if n_left < 4:
        raise ValueError("malformed batch frame: short count header")
    (n_segs,) = _U32LE.unpack_from(buf, at)
    if 4 + 4 * n_segs > n_left:
        raise ValueError(
            f"malformed batch frame: count {n_segs} exceeds payload")
    # Capacity bound: every command consumes >= 20 payload bytes (its
    # fixed entry header), so n_left // 20 can never under-size. The
    # output segment adds <= 9 bytes of body header per command plus
    # the (deduped) address table, covered by the same bound.
    cap = min(max_cmds, n_left // 20 + 8)
    cols = np.empty((cap, _COLS), dtype=np.int64)
    out = (ctypes.c_uint8 * (n_left + 32 * cap + 64))()
    out_len = ctypes.c_uint64()
    ptr, keepalive = _as_u8p_view(buf, at)
    try:
        n = lib.fpx_ingest_scan(
            ptr, n_left, out, len(out), ctypes.byref(out_len),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    finally:
        del ptr, keepalive
    if n == -1:
        raise ValueError("malformed ingest batch frame")
    if n < 0:
        return None  # -3 unsupported shape (-2 cannot happen: cap sized)
    # Offsets were computed relative to buf[at:]; make them absolute.
    cols = cols[:n]
    cols[:, 3] += at
    return bytes(out[:out_len.value]), cols


def _py_value_columns(raw, n: int):
    cols = np.empty((n, _COLS), dtype=np.int64)
    if len(raw) < 4:
        raise ValueError("malformed value array: short table header")
    (t,) = _U32LE.unpack_from(raw, 0)
    at = 4
    for _ in range(t):
        if at + 5 > len(raw):
            raise ValueError("malformed value array: torn address table")
        kind = raw[at]
        (alen,) = _U32LE.unpack_from(raw, at + 1)
        at += 5 + alen
        if kind == 1:
            at += 4
        elif kind not in (0, 2):
            return None
        if at > len(raw):
            raise ValueError("malformed value array: torn address table")
    for i in range(n):
        if at + 1 > len(raw):
            raise ValueError("malformed value array: torn body")
        if raw[at] != 1:
            return None  # noop or exotic value
        if at + 5 > len(raw):
            raise ValueError("malformed value array: torn body")
        (k,) = _U32LE.unpack_from(raw, at + 1)
        if k != 1:
            return None  # multi-command batch
        if at + 29 > len(raw):
            raise ValueError("malformed value array: torn entry")
        (idx,) = _U32LE.unpack_from(raw, at + 5)
        if idx >= t:
            raise ValueError("malformed value array: address index")
        pseudonym, client_id = _I64X2.unpack_from(raw, at + 9)
        (vlen,) = _U32LE.unpack_from(raw, at + 25)
        if at + 29 + vlen > len(raw):
            raise ValueError("malformed value array: value overrun")
        cols[i] = (idx, pseudonym, client_id, at + 29, vlen)
        at += 29 + vlen
    if at != len(raw):
        raise ValueError("malformed value array: trailing garbage")
    return cols


def value_columns(raw, n: int, max_cmds: int = 1 << 20):
    """SoA descriptor columns from a value-array raw segment
    (LazyValueArray.raw): per entry (addr_idx, pseudonym, client_id,
    value_off, value_len), offsets absolute into ``raw``. None when the
    segment holds anything but one-command batches (noops, wide
    batches); ValueError on corruption."""
    lib = load()
    if n > max_cmds:
        return None
    if lib is None:
        return _py_value_columns(raw, n)
    cols = np.empty((max(n, 1), _COLS), dtype=np.int64)
    ptr, keepalive = _as_u8p_view(raw, 0)
    try:
        got = lib.fpx_value_columns(
            ptr, len(raw),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, n)
    finally:
        del ptr, keepalive
    if got == -1:
        raise ValueError("malformed value array")
    if got < 0:
        return None
    return cols[:n]


_REPLY_ENTRY_HDR = struct.Struct("<qqq")  # pseudonym, client_id, slot


def _py_reply_columns(buf, at: int, max_replies: int):
    n_left = len(buf) - at
    if n_left < 4:
        raise ValueError("malformed reply array: short count header")
    (n,) = struct.unpack_from("<i", buf, at)
    if n < 0 or 4 + 28 * n > n_left:
        raise ValueError(
            f"malformed reply array: count {n} exceeds payload")
    if n > max_replies:
        return None
    cols = np.empty((n, _COLS), dtype=np.int64)
    pos = at + 4
    for i in range(n):
        if pos + 28 > len(buf):
            raise ValueError("malformed reply array: torn entry")
        pseudonym, client_id, slot = _REPLY_ENTRY_HDR.unpack_from(
            buf, pos)
        (rlen,) = _U32LE.unpack_from(buf, pos + 24)
        if pos + 28 + rlen > len(buf):
            raise ValueError(
                "malformed reply array: result overruns payload")
        cols[i] = (pseudonym, client_id, slot, pos + 28, rlen)
        pos += 28 + rlen
    if pos != len(buf):
        raise ValueError("malformed reply array: trailing garbage")
    return cols


def reply_columns(buf, at: int = 1, max_replies: int = 1 << 20):
    """A ClientReplyArray payload's entries as (n, 5) int64 SoA columns
    of (pseudonym, client_id, slot, result_off, result_len) -- the
    RETURN-path twin of :func:`ingest_scan`. ``buf[at:]`` starts at the
    i32 entry count (the leading tag byte consumed by the caller);
    offsets are absolute into ``buf``. None when the count exceeds
    ``max_replies``; ValueError on a torn/corrupt payload (the
    corrupt-frame containment channel)."""
    lib = load()
    if lib is None:
        return _py_reply_columns(buf, at, max_replies)
    n_left = len(buf) - at
    # Capacity bound mirrors the native pre-cap check: every entry
    # consumes >= 28 payload bytes.
    cap = min(max_replies, max(n_left, 0) // 28 + 1)
    cols = np.empty((cap, _COLS), dtype=np.int64)
    ptr, keepalive = _as_u8p_view(buf, at)
    try:
        n = lib.fpx_reply_columns(
            ptr, n_left,
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    finally:
        del ptr, keepalive
    if n == -1:
        raise ValueError("malformed reply array")
    if n < 0:
        return None  # -2: count past max_replies
    cols = cols[:n]
    cols[:, 3] += at
    return cols


def pack_votes(slots: np.ndarray, nodes: np.ndarray,
               rounds: np.ndarray) -> bytes:
    """Phase2b vote batch -> bytes (feeds TpuQuorumChecker directly)."""
    slots = np.ascontiguousarray(slots, dtype=np.int32)
    nodes = np.ascontiguousarray(nodes, dtype=np.int32)
    rounds = np.ascontiguousarray(rounds, dtype=np.int32)
    lib = load()
    if lib is None:
        out = np.empty((slots.shape[0], 3), dtype="<i4")
        out[:, 0], out[:, 1], out[:, 2] = slots, nodes, rounds
        return struct.pack("<I", slots.shape[0]) + out.tobytes()
    n = slots.shape[0]
    out = (ctypes.c_uint8 * (4 + 12 * n))()
    written = lib.fpx_pack_votes(
        slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, out, len(out))
    assert written == len(out)
    return bytes(out)


# Packed 12-byte (i64 slot, i32 round) records -- the Phase2bVotes
# payload entry. Slots are i64 to match the rest of the wire (the
# Phase2b/Phase2bRange codecs carry '<q' slots).
_VOTE2_DTYPE = np.dtype([("slot", "<i8"), ("round", "<i4")])


def pack_votes2(slots: np.ndarray, rounds: np.ndarray) -> bytes:
    """Single-acceptor vote batch -> bytes (Phase2bVotes payload): two
    columns only -- the acceptor identity rides the message header, so
    no dead node column on the wire."""
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    rounds = np.ascontiguousarray(rounds, dtype=np.int32)
    lib = load()
    if lib is None:
        out = np.empty(slots.shape[0], dtype=_VOTE2_DTYPE)
        out["slot"], out["round"] = slots, rounds
        return struct.pack("<I", slots.shape[0]) + out.tobytes()
    n = slots.shape[0]
    out = (ctypes.c_uint8 * (4 + 12 * n))()
    written = lib.fpx_pack_votes2(
        slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, out, len(out))
    assert written == len(out)
    return bytes(out)


def _check_count(buf: bytes, record_size: int) -> int:
    """Validate a [u32 count][count * record] payload's framing WITHOUT
    allocating anything proportional to the claimed count; returns the
    count. Raising here (ValueError) is the defense against hostile
    counts (a u32 count of 0xFFFFFFFF would otherwise drive a ~48 GB
    numpy allocation before any bounds check ran)."""
    if len(buf) < 4:
        raise ValueError("malformed vote batch: short count header")
    (n,) = struct.unpack_from("<I", buf, 0)
    if len(buf) < 4 + record_size * n:
        raise ValueError(
            f"malformed vote batch: count {n} exceeds payload "
            f"({len(buf)} bytes)")
    return n


def check_votes2(buf: bytes) -> int:
    """Validate a packed Phase2bVotes payload; returns the count. The
    message codec calls this inside decode so a malformed payload is
    dropped by the transport's corrupt-frame guard, never reaching an
    actor."""
    return _check_count(buf, _VOTE2_DTYPE.itemsize)


def unpack_votes2(buf: bytes) -> tuple[np.ndarray, np.ndarray]:
    n = check_votes2(buf)
    lib = load()
    if lib is None:
        rec = np.frombuffer(buf, dtype=_VOTE2_DTYPE, count=n, offset=4)
        return rec["slot"].copy(), rec["round"].copy()
    slots = np.empty(n, dtype=np.int64)
    rounds = np.empty(n, dtype=np.int32)
    got = lib.fpx_unpack_votes2(
        _as_u8p(buf), len(buf),
        slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    if got < 0:
        raise ValueError("malformed vote batch")
    return slots, rounds


def unpack_votes(buf: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = _check_count(buf, 12)  # 3 x i32 records
    lib = load()
    if lib is None:
        flat = np.frombuffer(buf, dtype="<i4", count=3 * n, offset=4)
        triples = flat.reshape(n, 3)
        return (triples[:, 0].copy(), triples[:, 1].copy(),
                triples[:, 2].copy())
    slots = np.empty(n, dtype=np.int32)
    nodes = np.empty(n, dtype=np.int32)
    rounds = np.empty(n, dtype=np.int32)
    got = lib.fpx_unpack_votes(
        _as_u8p(buf), len(buf),
        slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    if got < 0:
        raise ValueError("malformed vote batch")
    return slots, nodes, rounds
