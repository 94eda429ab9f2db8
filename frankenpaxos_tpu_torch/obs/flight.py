"""The crash flight recorder: a fixed-size ring of recent events that
survives ``kill -9``.

A SIGKILL'd role gets no chance to dump anything -- no signal handler,
no atexit, no buffered-file flush. So the recorder writes every record
straight into an ``mmap``'d file: the kernel owns the dirty pages, and
when the process dies they are still there for whoever reads the file
next (a chaos run's post-mortem). Records are
fixed-size slots written round-robin with a monotone sequence number,
so the reader reconstructs the last-N-events order without any footer
or index that a crash could tear.

LAYOUT (little-endian)::

    header:  8s magic "FPXFLT1\\n" | u32 slot_count | u32 slot_size
    slot:    u64 seq (0 = never written) | f64 t | u16 len | text bytes

Torn slots are possible only for the single record being written at
the instant of death; the reader drops any slot whose text length
exceeds its slot and keeps everything else.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Optional

MAGIC = b"FPXFLT1\n"
_HEADER = struct.Struct("<8sII")
_SLOT = struct.Struct("<QdH")


class FlightRecorder:
    """Fixed-size per-role event ring; ``path=None`` keeps it in memory
    (the sim's variant -- SimTransport crashes are object deaths, so a
    plain buffer owned by the harness survives them)."""

    def __init__(self, path: Optional[str] = None, slots: int = 1024,
                 slot_size: int = 192):
        self.path = path
        self.slots = slots
        self.slot_size = slot_size
        self._seq = 0
        size = _HEADER.size + slots * slot_size
        if path is None:
            self._buf = bytearray(size)
            self._mm = None
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # O_RDWR + ftruncate (not "wb") so a restarted role REUSES
            # the ring, seeding its sequence past the crash's records
            # instead of clobbering them.
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                if os.fstat(fd).st_size != size:
                    os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self._buf = self._mm
            header = bytes(self._buf[:_HEADER.size])
            if header[:8] == MAGIC:
                magic, old_slots, old_size = _HEADER.unpack(header)
                if (old_slots, old_size) == (slots, slot_size):
                    self._seq = max(
                        (seq for seq, _, _ in _iter_slots(
                            self._buf, slots, slot_size)), default=0)
        _HEADER.pack_into(self._buf, 0, MAGIC, slots, slot_size)

    def record(self, t: float, text: str) -> None:
        """Write one record into the next slot. Cheap enough for the
        hot path: one pack_into + one memcpy into the mapping."""
        self._seq += 1
        offset = _HEADER.size + (
            (self._seq - 1) % self.slots) * self.slot_size
        data = text.encode("utf-8", "replace")[
            :self.slot_size - _SLOT.size]
        _SLOT.pack_into(self._buf, offset, self._seq, t, len(data))
        start = offset + _SLOT.size
        self._buf[start:start + len(data)] = data
        # Zero the slot's tail so a shorter record never leaves a
        # previous record's bytes visible past its length.
        end = offset + self.slot_size
        self._buf[start + len(data):end] = bytes(
            end - start - len(data))

    def records(self) -> list:
        """All live records, oldest first: [(seq, t, text)]."""
        return sorted(_iter_slots(self._buf, self.slots, self.slot_size))

    def dump(self) -> dict:
        return {"slots": self.slots, "slot_size": self.slot_size,
                "records": [{"seq": seq, "t": round(t, 9), "text": text}
                            for seq, t, text in self.records()]}

    def close(self) -> None:
        if self._mm is not None:
            self._mm.flush()
            self._mm.close()
            self._mm = None
            self._buf = bytearray(0)

    # --- post-mortem readers ----------------------------------------------
    @classmethod
    def read(cls, path: str) -> list:
        """Records from a (possibly crashed) role's ring file, oldest
        first -- the post-mortem entry point; never needs the writing
        process to have exited cleanly."""
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < _HEADER.size:
            raise ValueError(f"{path}: truncated flight-recorder file")
        magic, slots, slot_size = _HEADER.unpack_from(data, 0)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad flight-recorder magic")
        if _HEADER.size + slots * slot_size > len(data):
            raise ValueError(f"{path}: flight-recorder file shorter "
                             f"than its declared ring")
        return sorted(_iter_slots(data, slots, slot_size))

    @classmethod
    def dump_file(cls, path: str, out_path: str) -> dict:
        """Read ``path`` and write the post-mortem JSON to
        ``out_path``; returns the dump dict."""
        dump = {"source": path,
                "records": [{"seq": seq, "t": round(t, 9), "text": text}
                            for seq, t, text in cls.read(path)]}
        with open(out_path, "w") as f:
            json.dump(dump, f, indent=2)
        return dump


def _iter_slots(buf, slots: int, slot_size: int):
    for i in range(slots):
        offset = _HEADER.size + i * slot_size
        seq, t, length = _SLOT.unpack_from(buf, offset)
        if seq == 0 or length > slot_size - _SLOT.size:
            continue  # empty, or torn by the crash mid-write
        start = offset + _SLOT.size
        text = bytes(buf[start:start + length]).decode("utf-8",
                                                       "replace")
        yield seq, t, text
