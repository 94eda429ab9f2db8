"""Epoch-segmented write-quorum tracking for reconfig-wired proxies.

The port's counterpart of ``frankenpaxos_tpu/reconfig/tracker.py``, and
the reconfig twin of ``protocols.multipaxos.quorum_tracker``: votes are
recorded by VOTER ADDRESS (the transport's ``src`` -- carried indices
can collide across epochs when a replacement reuses a dead member's
config slot, addresses cannot), and each slot's quorum predicate is its
EPOCH's spec, resolved through the ``EpochStore``. Two backends:

  * ``dict`` -- the oracle: per-(slot, round) voter sets checked with
    ``EpochConfig.has_write_quorum`` (set intersection, the reference
    semantics). Counts only the slot's epoch's members.
  * ``cuda`` -- ``ops.quorum.EpochSegmentedChecker`` scatters each
    event-loop drain's votes (K6, in 256-vote chunks, the whole drain in
    one staged call and one launch) over the store's union
    universe; the epoch plane is selected per slot INSIDE the kernel,
    so a drain spanning the handover boundary needs no split, and a new
    epoch reshapes the board in place (K7). It runs on ``device``
    (``cuda`` when None; ``"cpu"`` for the plain versions). The
    reference's ``"tpu"`` backend name is refused. Non-member votes land in
    columns the epoch's mask zeroes -- they can never complete a
    quorum they do not belong to.

Both report each (slot, round)'s quorum exactly once (the dict's Done
sentinel; the board's chosen bitmap).
"""

from __future__ import annotations

import time

from frankenpaxos_tpu_torch.ops.quorum import (
    EpochSegmentedChecker,
    newly_pairs,
)
from frankenpaxos_tpu_torch.reconfig.epoch import EpochStore
import numpy as np


class EpochQuorumTracker:
    def __init__(self, store: EpochStore, backend: str = "dict",
                 window: int = 4096, device=None):
        if backend not in ("dict", "cuda"):
            raise ValueError(f"unknown epoch tracker backend {backend!r} "
                             f"(the port's backends are 'dict' and "
                             f"'cuda')")
        self.store = store
        self.backend = backend
        self._known = store.known()
        # dict backend: (slot, round) -> set of voter addresses; None
        # once reported (Done).
        self._states: dict = {}
        self._newly: list = []
        # cuda backend: per-drain vote buffer + the segmented checker.
        self._checker = None
        self._slots: list = []
        self._cols: list = []
        self._rounds: list = []
        self._chunk = 256
        #: cuda backend: drains that carried votes, and the host seconds
        #: their staged K6 calls took (transfers and the wait included).
        self.drain_calls = 0
        self.drain_seconds = 0.0
        if backend == "cuda":
            specs, starts = store.specs_and_boundaries()
            self._checker = EpochSegmentedChecker(specs, starts,
                                                  window=window,
                                                  device=device)
            # Prewarm the scatter buckets before client traffic.
            self._checker.record_and_check([0], [0], [-1])
            self._checker.release([0])

    def note_epochs(self) -> None:
        """Refresh after the store committed new epochs. Pure appends
        extend the device checker's plane stack in place (the epoch
        reshape gather keeps mid-flight votes); a round-superseded
        newest epoch (rare: a preempted leader's unactivated
        definition) rebuilds the checker -- in-flight quorums for that
        never-activated epoch are resolved by protocol-level resends."""
        known = self.store.known()
        if known == self._known:
            return
        if self._checker is not None:
            if known[:len(self._known)] == self._known:
                for config in known[len(self._known):]:
                    self._checker.add_epoch(self.store.spec(config),
                                            config.start_slot)
            else:
                specs, starts = self.store.specs_and_boundaries()
                self._checker = EpochSegmentedChecker(
                    specs, starts, window=self._checker.window,
                    device=self._checker.device)
                # A replacement REBUILDS the universe ids: buffered
                # votes' column ids were computed under the old
                # mapping and would credit the wrong acceptor on the
                # new board (a quorum one real vote short). Drop them
                # -- they voted for the superseded definition's
                # proposals, which protocol-level resends re-drive.
                self._slots, self._cols, self._rounds = [], [], []
        self._known = known

    # --- recording (per message, O(1) Python) ------------------------------
    def record(self, slot: int, round: int, voter) -> None:
        if self.backend == "dict":
            self._record_dict(slot, round, voter)
            return
        col = self.store.column_of(voter)
        if col is None:
            return  # never a member of any epoch: nothing to count
        self._slots.append(slot)
        self._cols.append(col)
        self._rounds.append(round)

    def record_range(self, slot_start: int, slot_end: int, round: int,
                     voter) -> None:
        if self.backend == "dict":
            for slot in range(slot_start, slot_end):
                self._record_dict(slot, round, voter)
            return
        col = self.store.column_of(voter)
        if col is None or slot_end <= slot_start:
            return
        width = slot_end - slot_start
        self._slots.extend(range(slot_start, slot_end))
        self._cols.extend([col] * width)
        self._rounds.extend([round] * width)

    def record_votes(self, slots, rounds, voter) -> None:
        """One voter's votes for an arbitrary slot array (a packed
        Phase2bVotes)."""
        if self.backend == "dict":
            for slot, round in zip(np.asarray(slots).tolist(),
                                   np.asarray(rounds).tolist()):
                self._record_dict(int(slot), int(round), voter)
            return
        col = self.store.column_of(voter)
        if col is None:
            return
        slots = np.asarray(slots)
        self._slots.extend(slots.tolist())
        self._cols.extend([col] * slots.size)
        self._rounds.extend(np.asarray(rounds).tolist())

    def _record_dict(self, slot: int, round: int, voter) -> None:
        key = (slot, round)
        votes = self._states.get(key)
        if votes is None and key in self._states:
            return  # Done
        if votes is None:
            votes = set()
            self._states[key] = votes
        votes.add(voter)
        config = self.store.epoch_of_slot(slot)
        if voter not in config.members:
            return  # not this epoch's vote; kept only for debugging
        if config.has_write_quorum(votes):
            self._states[key] = None
            self._newly.append(key)

    # --- drain -------------------------------------------------------------
    def drain(self) -> list:
        if self.backend == "dict":
            newly, self._newly = self._newly, []
            return newly
        if not self._slots:
            return []
        slots = np.asarray(self._slots, dtype=np.int64)
        cols = np.asarray(self._cols, dtype=np.int32)
        rounds = np.asarray(self._rounds, dtype=np.int32)
        self._slots, self._cols, self._rounds = [], [], []
        # One call for the whole drain: K6 over the votes 256 at a time,
        # each chunk one batch of the reference's scatter.
        t0 = time.perf_counter()
        newly = self._checker.record_and_check_run(slots, cols, rounds,
                                                   chunk=self._chunk)
        self.drain_seconds += time.perf_counter() - t0
        self.drain_calls += 1
        return newly_pairs(slots, rounds, newly)

    def release(self, slots) -> None:
        """Watermark GC passthrough (ring wrap for the device board; K5):
        held until the checker's next board call, whose staged call
        (the next drain's) resets the columns ahead of its run."""
        if self._checker is not None and len(slots):
            self._checker.release(np.asarray(slots))
