"""The matchmaker-backed epoch store: epoch id -> acceptor set + spec.

The port's copy of ``frankenpaxos_tpu/reconfig/epoch.py`` (pure numpy,
same semantics).

An *epoch* is one membership era of an acceptor set. Epochs partition
slot space at ACTIVATION WATERMARKS: epoch ``e`` governs every slot in
``[start_slot_e, start_slot_{e+1})`` -- which acceptors are proposed
to, whose votes count, and under which QuorumSpec the quorum predicate
runs. That watermark bound is the whole handover story: in-flight runs
below the boundary drain in the old epoch while new slots open in the
new one, and one device drain spanning the boundary stays a single fused
kernel call (``ops.quorum.EpochSegmentedChecker``).

Matchmaker pedigree (vldb20, Reconfigurer.scala:98-155): the paper
keeps round -> configuration in a dedicated 2f+1 matchmaker service.
Here the *old epoch's acceptors* ARE the matchmakers: an epoch commit
is durable once a write quorum of them has WAL'd the ``WalEpoch``
record, and any future leader's Phase1 read quorum of the old epoch
intersects that write quorum -- so at least one Phase1b carries the
new epoch and the leader extends Phase1 to cover it (the
Flexible-Paxos intersection condition, arxiv 1608.06696, reduced to
set intersection over the epoch map).

Universe ids are store-local but DETERMINISTIC: members get integer
ids in (epoch, member-order) first-seen order, so every role that saw
the same EpochCommit sequence derives identical column layouts for the
device kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from frankenpaxos_tpu_torch.quorums import SimpleMajority
from frankenpaxos_tpu_torch.quorums.spec import QuorumSpec
import numpy as np


@dataclasses.dataclass(frozen=True)
class EpochConfig:
    """One membership era: ``members`` is the full acceptor set (a
    single 2f+1 majority group), ``start_slot`` its activation
    watermark (first slot it governs)."""

    epoch: int
    start_slot: int
    f: int
    members: tuple  # tuple[Address, ...]

    def __post_init__(self):
        object.__setattr__(self, "members", tuple(self.members))
        if len(self.members) != 2 * self.f + 1:
            raise ValueError(
                f"epoch {self.epoch}: {len(self.members)} members != "
                f"2f+1 = {2 * self.f + 1}")
        if len(set(self.members)) != len(self.members):
            raise ValueError(f"epoch {self.epoch}: duplicate members")

    @property
    def quorum_size(self) -> int:
        return self.f + 1

    def has_write_quorum(self, present: Iterable) -> bool:
        """f+1 of this epoch's members (majority: read and write
        quorums coincide, quorums/SimpleMajority.scala:19-56)."""
        members = set(self.members)
        return len(members.intersection(present)) >= self.f + 1

    has_read_quorum = has_write_quorum


class EpochStore:
    """epoch id -> EpochConfig, with slot -> epoch resolution.

    THE single authority for acceptor-set reads in reconfig-aware
    protocol handlers (paxlint PAX110 forbids bypassing it): fan-out
    targets, vote-counting specs, and Phase1 coverage all resolve
    through ``epoch_of_slot`` / ``config`` so a committed epoch change
    reaches every path at once.
    """

    def __init__(self, initial: EpochConfig):
        if initial.epoch != 0 or initial.start_slot != 0:
            raise ValueError("the initial epoch must be (epoch=0, "
                             f"start_slot=0), got {initial}")
        self._configs: list[EpochConfig] = [initial]
        # Commit round per epoch (round-monotone supersession of an
        # unactivated newest epoch by a higher-round leader).
        self._rounds: list[int] = [-1]
        # Stable universe ids, (epoch, member-order) first-seen.
        self._ids: dict = {a: i for i, a in enumerate(initial.members)}
        #: Bumped on every add/replace; trackers compare it to decide
        #: between appending planes and a full rebuild.
        self.version = 0

    @classmethod
    def from_members(cls, members: Sequence, f: int) -> "EpochStore":
        return cls(EpochConfig(epoch=0, start_slot=0, f=f,
                               members=tuple(members)))

    # --- reads ------------------------------------------------------------
    def current(self) -> EpochConfig:
        return self._configs[-1]

    @property
    def multi_epoch(self) -> bool:
        return len(self._configs) > 1

    def config(self, epoch: int) -> "EpochConfig | None":
        i = epoch - self._configs[0].epoch
        if 0 <= i < len(self._configs):
            return self._configs[i]
        return None

    def epoch_of_slot(self, slot: int) -> EpochConfig:
        """The config governing ``slot`` (last epoch whose activation
        watermark is <= slot)."""
        for config in reversed(self._configs):
            if config.start_slot <= slot:
                return config
        return self._configs[0]

    def epochs_covering(self, min_slot: int) -> list:
        """Every epoch with governed slots >= ``min_slot`` -- the set a
        Phase1 recovering ``[min_slot, inf)`` must hold a read quorum
        in (Phase1-with-both-configs across a handover)."""
        out = []
        for i, config in enumerate(self._configs):
            end = (self._configs[i + 1].start_slot
                   if i + 1 < len(self._configs) else None)
            if end is None or end > min_slot:
                out.append(config)
        return out

    def known(self) -> tuple:
        return tuple(self._configs)

    def round_of(self, epoch: int) -> int:
        i = epoch - self._configs[0].epoch
        return self._rounds[i] if 0 <= i < len(self._rounds) else -1

    def all_members(self) -> tuple:
        """Union of every known epoch's members, universe-id order."""
        return tuple(self._ids)

    def column_of(self, address) -> "int | None":
        """The address's stable universe id (None: never a member)."""
        return self._ids.get(address)

    # --- writes -----------------------------------------------------------
    def offer(self, config: EpochConfig, round: int) -> str:
        """Install a committed epoch entry with round-monotone
        supersession. Returns:

          * ``"new"`` -- appended (the next contiguous epoch);
          * ``"replaced"`` -- the NEWEST epoch's definition was
            superseded by a higher-round commit (a preempted leader's
            unactivated definition losing to its successor's);
          * ``"dup"`` -- already known at >= this round (re-ack it);
          * ``"stale"`` -- a lower-round commit for a known epoch, or
            an epoch too far ahead to validate (non-contiguous: the
            resend protocol will deliver the gap first).
        """
        known = self.config(config.epoch)
        if known is not None:
            i = config.epoch - self._configs[0].epoch
            if round <= self._rounds[i]:
                return "dup" if known == config else "stale"
            if known == config:
                self._rounds[i] = round
                return "dup"
            if i != len(self._configs) - 1:
                # Only the newest epoch can still be in flux: older
                # ones were activated (their successor's commit quorum
                # proves it), and an activated definition is never
                # superseded (docs/RECONFIG.md).
                return "stale"
            self._configs[i] = config
            self._rounds[i] = round
            self._rebuild_ids()
            self.version += 1
            return "replaced"
        newest = self._configs[-1]
        if config.epoch != newest.epoch + 1:
            return "stale"
        if config.start_slot < newest.start_slot:
            raise ValueError(
                f"epoch {config.epoch} start {config.start_slot} below "
                f"epoch {newest.epoch} start {newest.start_slot}")
        self._configs.append(config)
        self._rounds.append(round)
        for a in config.members:
            self._ids.setdefault(a, len(self._ids))
        self.version += 1
        return "new"

    def add(self, config: EpochConfig, round: int = 0) -> bool:
        """offer() narrowed to the append case (tests, WAL replay in
        epoch order): True when newly installed."""
        return self.offer(config, round) in ("new", "replaced")

    def _rebuild_ids(self) -> None:
        ids: dict = {}
        for config in self._configs:
            for a in config.members:
                ids.setdefault(a, len(ids))
        self._ids = ids

    # --- kernel-facing views ----------------------------------------------
    def universe(self) -> tuple:
        """Integer universe (0..n_members_ever-1) for the device kernels."""
        return tuple(range(len(self._ids)))

    def spec(self, config: EpochConfig) -> QuorumSpec:
        """``config``'s write/read QuorumSpec over the store's union
        universe (majority of the epoch's member columns)."""
        return SimpleMajority(
            [self._ids[a] for a in config.members]
        ).write_spec().reindexed(self.universe())

    def specs_and_boundaries(self) -> tuple:
        """``([QuorumSpec, ...], [start_slot, ...])`` for
        ``ops.quorum.EpochSegmentedChecker``."""
        return ([self.spec(c) for c in self._configs],
                [c.start_slot for c in self._configs])

    def boundaries(self) -> np.ndarray:
        return np.asarray([c.start_slot for c in self._configs[1:]],
                          dtype=np.int64)
