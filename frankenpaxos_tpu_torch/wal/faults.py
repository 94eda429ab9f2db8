"""Deterministic WAL storage-fault injection (the port's copy of
``frankenpaxos_tpu/wal/faults.py``).

A single fsync stalling for tens of milliseconds holds a whole group
commit, and every ack behind it. :class:`FsyncStallStorage` wraps any
WAL storage (MemStorage in sims, FileStorage on disk) and injects a
stall after every ``stall_every``-th ``sync``. Stall durations are drawn
from a STRING-SEEDED ``random.Random`` keyed ``(seed, label, sync
index)`` -- sha512 seeding, PYTHONHASHSEED-proof -- so a fault schedule
is byte-reproducible per seed. The wrapper reports each stall to
``on_stall`` (a geo sim bridges that to ``GeoSimTransport.stall_sender``
so the stalled role's drain releases its held acks late in VIRTUAL
time: wal/role.py holds acks until the fsync returns).

OFF BY DEFAULT, ZERO HOT-PATH COST: fault injection is a wrapping
storage object that only exists when a caller arms it. The unwrapped
Wal/FileStorage/MemStorage path is not touched by this module at all.
"""

from __future__ import annotations

import random
from typing import Callable, Optional


class FsyncStallStorage:
    """A WAL storage decorator injecting deterministic fsync stalls.

    Two fault shapes:

    * COUNT cadence -- ``stall_every=k`` stalls every k-th sync;
      ``stall_s`` is the mean stall with one-sided uniform jitter of
      +-``jitter`` fraction, drawn from the string-seeded RNG.
    * PERIODIC WINDOWS -- ``stall_period_s``/``stall_window_s``: the
      device is slow for the first ``window`` seconds of every
      ``period`` (the background-flush shape from "Paxos in the
      Cloud"); a sync landing inside a window stalls to the window's
      end. Windows are anchored at ``clock()`` ZERO, so two wrapped
      storages sharing a clock (the sim's virtual clock; the host
      wall clock across deployed role processes) have ALIGNED
      windows -- which is what makes overlap faults reproducible in
      the deployed world, where count cadences drift apart the
      moment one stall compresses the stalled role's backlog into a
      single drain.

    Neither armed (the default): the wrapper only counts syncs."""

    def __init__(self, inner, *, seed: int = 0, label: str = "",
                 stall_every: int = 0, stall_s: float = 0.05,
                 jitter: float = 0.5,
                 stall_period_s: float = 0.0,
                 stall_window_s: float = 0.0,
                 clock: Optional[Callable[[], float]] = None,
                 on_stall: Optional[Callable[[float], None]] = None,
                 blocking: bool = False):
        self.inner = inner
        self.seed = seed
        self.label = label
        self.stall_every = stall_every
        self.stall_s = stall_s
        self.jitter = jitter
        self.stall_period_s = stall_period_s
        self.stall_window_s = stall_window_s
        if clock is None and stall_period_s:
            import time

            clock = time.time  # shared across a host's processes
        self.clock = clock
        self.on_stall = on_stall
        #: Deployed mode: actually SLEEP through the stall
        #: inside sync() -- the role's single event-loop thread blocks
        #: exactly like it would inside a real slow fsync, holding the
        #: group commit and every ack behind it wall-clock. Sim arms
        #: ``on_stall`` + the transport bridge instead (virtual time).
        self.blocking = blocking
        self.syncs = 0
        #: Every injected stall duration, in order (a caller
        #: records the schedule beside its results).
        self.stalls: list[float] = []
        self._rng = random.Random(0)

    def _emit(self, stall: float) -> None:
        self.stalls.append(stall)
        if self.on_stall is not None:
            self.on_stall(stall)
        if self.blocking:
            import time

            time.sleep(stall)

    # --- the fault site ----------------------------------------------------
    def sync(self, name: str) -> None:
        self.inner.sync(name)
        self.syncs += 1
        if self.stall_period_s:
            phase = self.clock() % self.stall_period_s
            if phase < self.stall_window_s:
                self._emit(self.stall_window_s - phase)
            return
        if not self.stall_every or self.syncs % self.stall_every:
            return
        rng = self._rng
        rng.seed(f"fsync-stall|{self.seed}|{self.label}|{self.syncs}")
        lo = 1.0 - self.jitter
        self._emit(self.stall_s * (lo + 2 * self.jitter * rng.random()))

    # --- transparent delegation --------------------------------------------
    def segments(self) -> list:
        return self.inner.segments()

    def read(self, name: str) -> bytes:
        return self.inner.read(name)

    def append(self, name: str, data: bytes) -> None:
        self.inner.append(name, data)

    def delete(self, name: str) -> None:
        self.inner.delete(name)

    def truncate(self, name: str, size: int) -> None:
        self.inner.truncate(name, size)

    def size(self, name: str) -> int:
        return self.inner.size(name)

    def close(self) -> None:
        self.inner.close()
