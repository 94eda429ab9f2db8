"""GeoQuorumTracker: per-object-group vote counting over epoch planes
(the port's copy of ``frankenpaxos_tpu/geo/quorum.py``).

The geo twin of ``reconfig.tracker.EpochQuorumTracker``. Each object
group's slot space is partitioned by its steal epochs, and each epoch's
Phase2 predicate is a ``ZoneGrid.home_write_spec`` -- a majority of the
home zone's row over the full grid universe. Two backends, with equal
outputs (tests/test_torch_geo.py holds both against the reference's):

  * ``dict`` -- the oracle: per-(slot, ballot) voter sets checked
    against the slot's epoch plane (a majority of its home zone's row,
    as ``home_write_spec(zone).check`` judges it).
  * ``cuda`` -- the port's ``ops.quorum.EpochSegmentedChecker``: each
    drain's votes go through K6 (``record_and_check_epochs``) in chunks
    of 256 lanes, the plane selected per slot inside the kernel, so a
    drain spanning a steal handover is still one launch per chunk; the
    leader's watermark advances release chosen columns through K5.
    The reference's ``"tpu"`` is refused by name.

The universe is the fixed grid (a steal moves leadership, not
membership), so ``add_epoch`` never widens it and K7
(``reshape_columns``) never runs here. With a ``mesh`` (a ``mesh.Mesh``
of ``torch.distributed`` ranks) the cuda backend's board is split over
the ranks (``EpochSegmentedChecker(mesh=)``: the steal planes whole on
every rank, the slot columns split); every rank builds the same tracker
and is fed the same calls, ``note_epochs`` appends or rebuilds on every
rank, and every rank reports the same pairs. The dict oracle ignores
``mesh``, as the reference's does.

Both report each (slot, ballot)'s quorum exactly once.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.geo.epochs import ObjectEpochStore
from frankenpaxos_tpu_torch.quorums import ZoneGrid
import numpy as np


class GeoQuorumTracker:
    def __init__(self, store: ObjectEpochStore, group: int,
                 grid: ZoneGrid, backend: str = "dict",
                 window: int = 4096, mesh=None, device=None):
        """``device``: where the ``cuda`` backend's checker lives
        (``cuda`` when None; ``"cpu"`` runs the plain versions; the
        mesh's device with a ``mesh``). Both are ignored by the dict
        oracle."""
        if backend not in ("dict", "cuda"):
            raise ValueError(f"unknown geo tracker backend {backend!r} "
                             f"(the port's backends are 'dict' and "
                             f"'cuda')")
        self.store = store
        self.group = group
        self.grid = grid
        self.backend = backend
        self.window = window
        self.mesh = mesh if backend == "cuda" else None
        self.device = None
        if backend == "cuda":
            from frankenpaxos_tpu_torch.ops.quorum import mesh_device

            self.device = resolve_device(device) if mesh is None \
                else mesh_device(mesh, device)
        self._known = store.known(group)
        # dict backend: each zone's row, so that a vote is judged as
        # ``home_write_spec(zone).check(votes)`` judges it (a majority
        # of the home row) without building the spec per vote.
        self._rows = [frozenset(row) for row in grid.grid]
        # (slot, ballot) -> set of acceptor ids; None once reported
        # (Done).
        self._states: dict = {}
        self._newly: list = []
        # cuda backend: per-drain vote buffer + the segmented checker.
        self._checker = None
        self._slots: list = []
        self._cols: list = []
        self._ballots: list = []
        self._chunk = 256
        if backend == "cuda":
            self._build_checker()

    def _specs_and_starts(self) -> tuple:
        chain = self.store.known(self.group)
        return ([self.grid.home_write_spec(e.home_zone) for e in chain],
                [e.start_slot for e in chain])

    def _build_checker(self) -> None:
        from frankenpaxos_tpu_torch.ops.quorum import EpochSegmentedChecker

        specs, starts = self._specs_and_starts()
        self._checker = EpochSegmentedChecker(specs, starts,
                                              window=self.window,
                                              mesh=self.mesh,
                                              device=self.device)
        # The reference's prewarm before client traffic (one K6 and one
        # K5 launch on the card).
        self._checker.record_and_check([0], [0], [-1])
        self._checker.release([0])

    def note_epochs(self) -> None:
        """Refresh after the store committed a steal. Pure appends
        extend the checker's plane stack in place (the universe is the
        fixed grid, so columns never move); a ballot-superseded newest
        epoch (a lost steal race) rebuilds it, dropping buffered votes
        -- they voted for the superseded owner's proposals, which
        protocol-level resends re-drive."""
        known = self.store.known(self.group)
        if known == self._known:
            return
        if self._checker is not None:
            if known[:len(self._known)] == self._known:
                for entry in known[len(self._known):]:
                    self._checker.add_epoch(
                        self.grid.home_write_spec(entry.home_zone),
                        entry.start_slot)
            else:
                self._build_checker()
                self._slots, self._cols, self._ballots = [], [], []
        self._known = known

    # --- recording (per message, O(1) Python) -------------------------------
    def record(self, slot: int, ballot: int, acceptor: int) -> None:
        if self.backend == "dict":
            self._record_dict(slot, ballot, acceptor)
            return
        self._slots.append(slot)
        self._cols.append(acceptor)
        self._ballots.append(ballot)

    def _record_dict(self, slot: int, ballot: int, acceptor: int) -> None:
        key = (slot, ballot)
        votes = self._states.get(key)
        if votes is None and key in self._states:
            return  # Done
        if votes is None:
            votes = set()
            self._states[key] = votes
        votes.add(acceptor)
        entry = self.store.epoch_of_slot(self.group, slot)
        if len(votes & self._rows[entry.home_zone]) \
                >= self.grid.row_majority:
            self._states[key] = None
            self._newly.append(key)

    # --- drain --------------------------------------------------------------
    def drain(self) -> list:
        """Newly complete ``(slot, ballot)`` quorums since the last
        drain (one K6 launch per 256 votes on the cuda backend; the
        first report of a slot in a drain wins)."""
        if self.backend == "dict":
            newly, self._newly = self._newly, []
            return newly
        if not self._slots:
            return []
        slots = np.asarray(self._slots, dtype=np.int64)
        cols = np.asarray(self._cols, dtype=np.int32)
        ballots = np.asarray(self._ballots, dtype=np.int32)
        self._slots, self._cols, self._ballots = [], [], []
        out: list = []
        seen: set = set()
        for at in range(0, slots.size, self._chunk):
            sl = slots[at:at + self._chunk]
            newly = self._checker.record_and_check(
                sl, cols[at:at + self._chunk],
                ballots[at:at + self._chunk])
            for i in np.flatnonzero(newly).tolist():
                key = (int(sl[i]), int(ballots[at + i]))
                if key[0] not in seen:
                    seen.add(key[0])
                    out.append(key)
        return out

    def release(self, slots) -> None:
        """Watermark GC passthrough (ring wrap for the cuda board; K5)."""
        if self._checker is not None and len(slots):
            self._checker.release(np.asarray(slots))
