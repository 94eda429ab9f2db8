"""The write-ahead log: CRC framing, group commit, segments, recovery
(the port's copy of ``frankenpaxos_tpu/wal/log.py``: the same frames,
CRC, segment names and thresholds, so the same records give the same
bytes on disk).

THE GROUP-COMMIT RULE: ``append`` only stages a record in an in-memory
buffer; nothing is durable -- and no acknowledgement depending on it
may leave the actor -- until ``sync()`` runs. Roles call ``sync()``
once per ``on_drain`` (the event-loop drain boundary), so a drain of k
messages costs ONE buffered file write + ONE fsync, and every ack the
drain produced is released only after that fsync returns. A crash
between append and sync loses exactly the staged records -- and, by
the rule, no peer ever saw an ack for them.

FRAME FORMAT: each record is
``<u32 len><u32 crc32(payload)><payload>`` little-endian, where payload
is a WAL-record frame (record tag byte + fixed-layout body, in the
record-private tag space of wal/records.py). Recovery walks segments in order and stops at the
first torn or CRC-failing frame: a partial group commit at the tail is
truncated away, which is exactly the crash contract (those records were
never acknowledged).

SEGMENTS & COMPACTION: records append to ``seg-<n>.wal``; when the live
segment exceeds ``segment_bytes`` the next sync rotates to a fresh one.
``compact(records)`` writes a WalSnapshot marker + the re-logged live
state as the first records of a NEW segment (one fsync), then deletes
every older segment -- roles trigger it from the same watermark GC
that bounds their in-memory state, so the log on disk stays O(live
state), not O(history).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Iterable
import zlib

from frankenpaxos_tpu_torch.wal.records import WAL_SERIALIZER, WalSnapshot

_FRAME = struct.Struct("<II")  # record length, crc32(payload)

#: Refuse absurd frame lengths during recovery (a corrupt length field
#: must not size an allocation): no drain's record comes close.
MAX_RECORD = 64 * 1024 * 1024


class FileStorage:
    """Real files under a directory; ``sync`` is flush + ``os.fsync``.

    One WAL per role process, so handles are plain (no locking): the
    single-threaded event-loop contract covers the WAL exactly as it
    covers role state.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._handles: dict[str, object] = {}

    def segments(self) -> list[str]:
        return sorted(n for n in os.listdir(self.root)
                      if n.startswith("seg-") and n.endswith(".wal"))

    def read(self, name: str) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def append(self, name: str, data: bytes) -> None:
        handle = self._handles.get(name)
        if handle is None:
            handle = open(os.path.join(self.root, name), "ab")
            self._handles[name] = handle
        handle.write(data)

    def sync(self, name: str) -> None:
        handle = self._handles.get(name)
        if handle is not None:
            handle.flush()
            os.fsync(handle.fileno())

    def delete(self, name: str) -> None:
        handle = self._handles.pop(name, None)
        if handle is not None:
            handle.close()
        try:
            os.unlink(os.path.join(self.root, name))
        except FileNotFoundError:
            pass

    def truncate(self, name: str, size: int) -> None:
        path = os.path.join(self.root, name)
        with open(path, "r+b") as f:
            f.truncate(size)
            f.flush()
            os.fsync(f.fileno())

    def size(self, name: str) -> int:
        try:
            return os.path.getsize(os.path.join(self.root, name))
        except FileNotFoundError:
            return 0

    def close(self) -> None:
        for handle in self._handles.values():
            handle.close()
        self._handles.clear()


class MemStorage:
    """The sim's crash-surviving stand-in: a dict of byte arrays OWNED
    BY THE HARNESS, not the actor. ``crash_restart`` discards the Wal
    object (and with it the unsynced group-commit buffer) but keeps
    this storage -- precisely the durability boundary a real crash
    draws, with byte-identical framing to FileStorage."""

    def __init__(self):
        self.files: dict[str, bytearray] = {}
        self.fsyncs = 0

    def segments(self) -> list[str]:
        return sorted(self.files)

    def read(self, name: str) -> bytes:
        return bytes(self.files[name])

    def append(self, name: str, data: bytes) -> None:
        self.files.setdefault(name, bytearray()).extend(data)

    def sync(self, name: str) -> None:
        self.fsyncs += 1

    def delete(self, name: str) -> None:
        self.files.pop(name, None)

    def truncate(self, name: str, size: int) -> None:
        if name in self.files:
            del self.files[name][size:]

    def size(self, name: str) -> int:
        return len(self.files.get(name, b""))

    def close(self) -> None:
        pass


@dataclasses.dataclass
class WalMetrics:
    """Group-commit accounting."""

    records_appended: int = 0
    syncs: int = 0  # sync() calls that flushed something (= fsyncs)
    bytes_synced: int = 0
    records_synced: int = 0
    compactions: int = 0
    segments_deleted: int = 0
    recovered_records: int = 0
    truncated_tail_bytes: int = 0

    def bytes_per_sync(self) -> float:
        return self.bytes_synced / self.syncs if self.syncs else 0.0


class Wal:
    def __init__(self, storage, segment_bytes: int = 1 << 20,
                 compact_every_bytes: int = 4 << 20):
        self.storage = storage
        self.segment_bytes = segment_bytes
        self.compact_every_bytes = compact_every_bytes
        self.metrics = WalMetrics()
        self._buf = bytearray()
        self._buf_records = 0
        self._bytes_since_compact = 0
        segments = storage.segments()
        if segments:
            self._seg_index = int(segments[-1][4:-4])
        else:
            self._seg_index = 0
        self._segment = f"seg-{self._seg_index:08d}.wal"

    # --- write path -------------------------------------------------------
    def append(self, record) -> None:
        """Stage one record for the drain's group commit. NOT durable
        until sync(); callers must hold back any ack that depends on
        it (the group-commit rule)."""
        payload = WAL_SERIALIZER.to_bytes(record)
        self._buf += _FRAME.pack(len(payload), zlib.crc32(payload))
        self._buf += payload
        self._buf_records += 1
        self.metrics.records_appended += 1

    def sync(self) -> None:
        """Group commit: write + fsync everything staged since the last
        sync (one fsync per drain, amortized over the drain's records).
        No-op when nothing is staged."""
        if not self._buf:
            return
        buf, self._buf = bytes(self._buf), bytearray()
        records, self._buf_records = self._buf_records, 0
        self.storage.append(self._segment, buf)
        self.storage.sync(self._segment)
        self.metrics.syncs += 1
        self.metrics.bytes_synced += len(buf)
        self.metrics.records_synced += records
        self._bytes_since_compact += len(buf)
        if self.storage.size(self._segment) >= self.segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._seg_index += 1
        self._segment = f"seg-{self._seg_index:08d}.wal"

    def wants_compaction(self) -> bool:
        return self._bytes_since_compact >= self.compact_every_bytes

    def compact(self, snapshot: WalSnapshot, records: Iterable) -> None:
        """Snapshot + reclaim: write ``snapshot`` followed by the
        re-logged live state as the first records of a fresh segment
        (one fsync), then delete every older segment. The caller
        passes exactly the state a restart must rebuild -- everything
        behind its watermark is gone from disk after this returns."""
        self.sync()  # staged records belong to the OLD log order
        old = self.storage.segments()
        self._rotate()
        self.append(snapshot)
        for record in records:
            self.append(record)
        buf, self._buf = bytes(self._buf), bytearray()
        records_n, self._buf_records = self._buf_records, 0
        self.storage.append(self._segment, buf)
        self.storage.sync(self._segment)
        self.metrics.syncs += 1
        self.metrics.bytes_synced += len(buf)
        self.metrics.records_synced += records_n
        for name in old:
            self.storage.delete(name)
            self.metrics.segments_deleted += 1
        self.metrics.compactions += 1
        self._bytes_since_compact = 0

    # --- recovery ---------------------------------------------------------
    def recover(self, logger=None) -> list:
        """All durable records in log order, stopping cleanly at the
        first torn/corrupt frame (an interrupted group commit at the
        tail -- records that, by the group-commit rule, were never
        acknowledged). Subsequent appends go to a FRESH segment so new
        records never land after truncated garbage."""
        records: list = []
        truncated = False
        for name in self.storage.segments():
            if truncated:
                # A torn frame in a NON-last segment cannot happen
                # through the append path (rotation only follows a
                # successful fsync); if it somehow does, everything
                # after it is unordered history -- drop it rather than
                # replaying out-of-order state.
                self.storage.delete(name)
                self.metrics.segments_deleted += 1
                continue
            data = self.storage.read(name)
            at = 0
            while at + _FRAME.size <= len(data):
                length, crc = _FRAME.unpack_from(data, at)
                start = at + _FRAME.size
                if length > MAX_RECORD or start + length > len(data):
                    break
                payload = data[start:start + length]
                if zlib.crc32(payload) != crc:
                    break
                try:
                    records.append(WAL_SERIALIZER.from_bytes(payload))
                except ValueError:
                    break
                at = start + length
            if at < len(data):
                # Torn tail (an interrupted group commit): physically
                # truncate it so recovery is IDEMPOTENT -- a later
                # restart must not re-find the garbage and mistake
                # segments written since for post-tear history.
                truncated = True
                self.metrics.truncated_tail_bytes += len(data) - at
                if logger is not None:
                    logger.warn(
                        f"wal: truncating torn tail of {name} "
                        f"({len(data) - at} bytes after offset {at})")
                self.storage.truncate(name, at)
        if records or truncated:
            self._rotate()
        self.metrics.recovered_records = len(records)
        return records

    def close(self) -> None:
        self.storage.close()
