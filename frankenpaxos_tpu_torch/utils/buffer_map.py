"""BufferMap: a dense int-keyed log with a garbage-collection watermark.

Reference behavior: util/BufferMap.scala:8-66. Semantics:

- ``get``/``put``/``contains`` over integer keys;
- keys below the GC ``watermark`` read as absent and writes to them are
  silently dropped (they were already executed/collected);
- ``garbage_collect(w)`` discards everything below ``w``; the watermark
  only increases.

This is the host twin of the device window layout (ops/quorum.py's
VoteBoard ring): dense storage + watermark is the memory model for the
unbounded replicated log across the framework.
"""

from __future__ import annotations

from typing import Generic, Iterator, Optional, TypeVar

V = TypeVar("V")


class BufferMap(Generic[V]):
    def __init__(self, grow_size: int = 5000):
        self.grow_size = grow_size
        self._buffer: list[Optional[V]] = [None] * grow_size
        self._watermark = 0
        self._largest_key = -1

    def __repr__(self):
        return f"BufferMap(watermark={self._watermark}, {self.to_dict()!r})"

    @property
    def watermark(self) -> int:
        return self._watermark

    @property
    def largest_key(self) -> int:
        return self._largest_key

    def get(self, key: int) -> Optional[V]:
        i = key - self._watermark
        if i < 0 or i >= len(self._buffer):
            return None
        return self._buffer[i]

    def put(self, key: int, value: V) -> None:
        self._largest_key = max(self._largest_key, key)
        i = key - self._watermark
        if i < 0:
            return
        if i >= len(self._buffer):
            self._buffer.extend([None] * (i + 1 + self.grow_size
                                          - len(self._buffer)))
        self._buffer[i] = value

    def contains(self, key: int) -> bool:
        return self.get(key) is not None

    def garbage_collect(self, watermark: int) -> None:
        if watermark <= self._watermark:
            return
        drop = min(watermark - self._watermark, len(self._buffer))
        del self._buffer[:drop]
        self._watermark = watermark

    def items(self, start: int = 0) -> Iterator[tuple[int, V]]:
        """Present (key, value) pairs from ``max(start, watermark)`` up to
        the largest key ever put."""
        for key in range(max(start, self._watermark), self._largest_key + 1):
            value = self.get(key)
            if value is not None:
                yield key, value

    def to_dict(self) -> dict[int, V]:
        return dict(self.items())
