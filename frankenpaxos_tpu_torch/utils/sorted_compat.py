"""Pure-Python fallbacks for ``sortedcontainers``.

``sortedcontainers`` is a runtime dependency, but some execution
environments lack it. The framework only leans on a tiny slice of its API -- TopK's
``SortedSet`` (add/pop/update/iterate) and the acceptors' ``SortedDict``
(mapping + ``irange(minimum=...)``) -- so these bisect-backed stand-ins
keep every protocol importable with identical semantics at somewhat
worse asymptotics. Import sites prefer the real library when present::

    try:
        from sortedcontainers import SortedDict
    except ImportError:
        from frankenpaxos_tpu_torch.utils.sorted_compat import SortedDict
"""

from __future__ import annotations

import bisect
from typing import Iterable, Iterator


class SortedSet:
    """Ordered unique values: the subset of
    ``sortedcontainers.SortedSet`` used by ``utils.topk.TopK``."""

    def __init__(self, iterable: Iterable = ()):
        self._items: list = sorted(set(iterable))

    def add(self, value) -> None:
        i = bisect.bisect_left(self._items, value)
        if i == len(self._items) or self._items[i] != value:
            self._items.insert(i, value)

    def update(self, iterable: Iterable) -> None:
        for value in iterable:
            self.add(value)

    def pop(self, index: int = -1):
        return self._items.pop(index)

    def discard(self, value) -> None:
        i = bisect.bisect_left(self._items, value)
        if i < len(self._items) and self._items[i] == value:
            self._items.pop(i)

    def __contains__(self, value) -> bool:
        i = bisect.bisect_left(self._items, value)
        return i < len(self._items) and self._items[i] == value

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator:
        return iter(self._items)

    def __repr__(self) -> str:
        return f"SortedSet({self._items!r})"


class SortedDict(dict):
    """A dict iterated in key order, plus ``irange``: the subset of
    ``sortedcontainers.SortedDict`` the acceptors use.

    Keys are re-sorted lazily: inserts are O(1) and each ordered read
    (``irange``/``items``/``keys``/iteration) sorts once if anything
    changed since the last read -- the acceptor access pattern is long
    insert runs punctuated by occasional Phase1b scans, where this is
    near-optimal.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sorted: list | None = None

    def __setitem__(self, key, value) -> None:
        if key not in self:
            self._sorted = None
        super().__setitem__(key, value)

    def __delitem__(self, key) -> None:
        super().__delitem__(key)
        self._sorted = None

    def pop(self, *args):
        self._sorted = None
        return super().pop(*args)

    def popitem(self):
        self._sorted = None
        return super().popitem()

    def clear(self) -> None:
        super().clear()
        self._sorted = None

    def setdefault(self, key, default=None):
        if key not in self:
            self._sorted = None
        return super().setdefault(key, default)

    def update(self, *args, **kwargs) -> None:
        super().update(*args, **kwargs)
        self._sorted = None

    def _keys(self) -> list:
        if self._sorted is None:
            self._sorted = sorted(super().keys())
        return self._sorted

    def irange(self, minimum=None, maximum=None) -> Iterator:
        keys = self._keys()
        lo = 0 if minimum is None else bisect.bisect_left(keys, minimum)
        hi = len(keys) if maximum is None else bisect.bisect_right(
            keys, maximum)
        return iter(keys[lo:hi])

    def __iter__(self) -> Iterator:
        return iter(self._keys())

    def keys(self):
        return self._keys()

    def values(self):
        return [self[k] for k in self._keys()]

    def items(self):
        return [(k, self[k]) for k in self._keys()]

    def peekitem(self, index: int = -1):
        key = self._keys()[index]
        return key, self[key]
