"""ObjectEpochStore: one paxepoch-flavored epoch chain PER OBJECT GROUP
(the port's copy of ``frankenpaxos_tpu/geo/epochs.py``).

The paxgeo twin of ``reconfig.epoch.EpochStore``. There, an epoch is a
membership era of ONE acceptor set; here the acceptor grid is fixed
and an epoch is a LEADERSHIP era of one object group -- which zone's
leader owns the group, at which ballot, from which slot. An object
STEAL is an epoch change: the stealing leader's cross-zone Phase1
doubles as the epoch's commit round (promises are WAL-durable before
the Phase1b ack leaves the acceptor, so a row-majority of old-home
durable acks is the commit point -- the f+1-old-epoch-acks rule of
docs/RECONFIG.md, inherited wholesale), and the new epoch's
``start_slot`` is the watermark-bounded handover: slots below it are
provably chosen and stay with the old era's history; everything at or
above transfers to the new home zone's quorum plane.

Entries are BALLOT-monotone per epoch id exactly as EpochStore entries
are round-monotone: two leaders racing to steal the same group
serialize on ballots, and the loser's unactivated definition is
superseded.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class GeoEpoch:
    """One leadership era of one object group: slots >=
    ``start_slot`` (until the next epoch's start) commit through
    ``home_zone``'s row at ballots owned by that zone's leader."""

    group: int
    epoch: int
    start_slot: int
    home_zone: int
    ballot: int


class ObjectEpochStore:
    """group id -> its epoch chain, with slot -> epoch resolution.

    THE single authority for object-placement reads in paxgeo handler
    code: request routing, steal targets, and per-slot quorum planes
    all resolve through ``current`` / ``epoch_of_slot`` so a committed
    steal reaches every path at once (the PAX110 discipline, applied
    to object leadership)."""

    def __init__(self, num_groups: int, initial_home: Sequence[int]):
        if len(initial_home) != num_groups:
            raise ValueError(
                f"{len(initial_home)} initial homes != {num_groups} groups")
        self.num_groups = num_groups
        # Epoch 0 of every group is config-agreed: home zone z at
        # ballot z (each zone's leader owns ballots == its zone index
        # mod num_zones, so epoch 0 needs no Phase1 -- the multipaxos
        # round-0-implicit-Phase1 convention).
        self._chains: list[list[GeoEpoch]] = [
            [GeoEpoch(group=g, epoch=0, start_slot=0,
                      home_zone=home, ballot=home)]
            for g, home in enumerate(initial_home)]
        #: Bumped on every offer that changes state; trackers compare
        #: it to decide between appending planes and a rebuild.
        self.version = 0

    # --- reads ------------------------------------------------------------
    def current(self, group: int) -> GeoEpoch:
        return self._chains[group][-1]

    def known(self, group: int) -> tuple:
        return tuple(self._chains[group])

    def epoch_of_slot(self, group: int, slot: int) -> GeoEpoch:
        for entry in reversed(self._chains[group]):
            if entry.start_slot <= slot:
                return entry
        return self._chains[group][0]

    def config(self, group: int, epoch: int) -> "GeoEpoch | None":
        chain = self._chains[group]
        i = epoch - chain[0].epoch
        if 0 <= i < len(chain):
            return chain[i]
        return None

    def max_ballot(self, group: int) -> int:
        return max(entry.ballot for entry in self._chains[group])

    # --- writes -----------------------------------------------------------
    def offer(self, entry: GeoEpoch) -> str:
        """Install a steal's epoch entry with ballot-monotone
        supersession (the ``EpochStore.offer`` contract):

          * ``"new"`` -- appended (the next contiguous epoch);
          * ``"replaced"`` -- the newest epoch's definition lost to a
            higher-ballot steal of the same epoch id;
          * ``"dup"`` -- already known at >= this ballot;
          * ``"stale"`` -- lower ballot for a known epoch, or an epoch
            id too far ahead to validate (the resend protocol delivers
            the gap first).
        """
        chain = self._chains[entry.group]
        known = self.config(entry.group, entry.epoch)
        if known is not None:
            i = entry.epoch - chain[0].epoch
            if entry.ballot < known.ballot:
                return "stale"
            if known == entry:
                return "dup"
            if entry.ballot == known.ballot:
                # One ballot belongs to one leader, which defines one
                # entry per epoch: an unequal twin is a stale resend
                # variant, never a fork.
                return "stale"
            if i != len(chain) - 1:
                # Activated definitions (their successor's commit
                # proves activation) are never superseded.
                return "stale"
            chain[i] = self._clamped(entry, chain[i - 1]
                                     if i > 0 else None)
            self.version += 1
            return "replaced"
        newest = chain[-1]
        if entry.epoch != newest.epoch + 1:
            return "stale"
        chain.append(self._clamped(entry, newest))
        self.version += 1
        return "new"

    @staticmethod
    def _clamped(entry: GeoEpoch, predecessor: "GeoEpoch | None"
                 ) -> GeoEpoch:
        """Keep start slots nondecreasing along OUR chain. Two
        stealers racing to define one epoch id serialize on ballots,
        but a store that adopted the loser's definition (larger
        start) can then hear a successor built on the winner's
        (smaller start) -- the chains genuinely diverge in their
        boundary bookkeeping. Clamping is safe: the per-epoch plane
        is each OWNER's local vote-counting rule (strictly stricter
        than the ZoneGrid write predicate), and chosen-uniqueness
        rests on ballots + Phase1 adoption, not on stores agreeing
        where one plane ends (docs/GEO.md)."""
        if predecessor is not None \
                and entry.start_slot < predecessor.start_slot:
            return dataclasses.replace(
                entry, start_slot=predecessor.start_slot)
        return entry
