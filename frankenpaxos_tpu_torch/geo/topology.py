"""GeoTopology: named zones/regions + a per-link latency matrix (the
port's copy of ``frankenpaxos_tpu/geo/topology.py``).

The topology is pure POLICY: it owns zone placement, per-link base
latency/jitter parameters, and the chaos controls (partition, degrade,
heal), and it answers "how long does THIS frame take?" via
:meth:`sample_delay`. The mechanism -- buffering frames and delivering
them in virtual-arrival order -- lives in
:class:`~frankenpaxos_tpu_torch.geo.transport.GeoSimTransport`.

DETERMINISM CONTRACT (held by the golden test in
tests/test_torch_geo.py against the committed
tests/golden/geo_delivery_order.json): nothing in the geo simulation layer may read a
wall clock or an unseeded RNG. Per-frame jitter is drawn from a
``random.Random`` seeded with a STRING key ``seed|src|dst|frame_id``
-- CPython hashes string seeds through sha512 (``Random.seed``
version 2), so the same seed produces byte-identical delay sequences
across processes and platforms, unlike ``hash()``-based keys under
PYTHONHASHSEED randomization.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from frankenpaxos_tpu_torch.ops.simwave import UNPLACED_ZONE


@dataclasses.dataclass
class Link:
    """One directed zone pair's state. ``base_s`` is the ONE-WAY
    propagation delay; the RTT over the link is ``2 * base_s`` plus
    jitter. ``degrade`` multiplies the base (brownout chaos); ``up``
    False drops frames at delivery time (partition chaos)."""

    base_s: float
    jitter_s: float
    up: bool = True
    degrade: float = 1.0


class GeoTopology:
    """Zones grouped into regions, with a synthesized all-pairs link
    matrix: intra-zone links are near-free, intra-region links cheap,
    and cross-region links pay the WAN delay -- the three-tier model
    every wide-area Paxos evaluation uses (WPaxos section 6)."""

    def __init__(self, regions: Mapping[str, Sequence[str]],
                 intra_zone_s: float = 0.0005,
                 intra_region_s: float = 0.004,
                 cross_region_s: float = 0.040,
                 jitter: float = 0.05,
                 seed: int = 0):
        if not regions:
            raise ValueError("GeoTopology needs at least one region")
        self.region_of: dict[str, str] = {}
        self.zones: tuple[str, ...] = ()
        zones: list[str] = []
        for region in sorted(regions):
            for zone in regions[region]:
                if zone in self.region_of:
                    raise ValueError(f"zone {zone!r} in two regions")
                self.region_of[zone] = region
                zones.append(zone)
        self.zones = tuple(zones)
        self.intra_zone_s = intra_zone_s
        self.intra_region_s = intra_region_s
        self.cross_region_s = cross_region_s
        self.jitter = jitter
        self.seed = seed
        self._placement: dict = {}      # address -> zone name
        self._links: dict[tuple[str, str], Link] = {}
        # (src address, dst address) -> Link | None (None: at least
        # one endpoint unplaced => free, always-up). Link state
        # mutates IN PLACE (partition/degrade flip fields), so cached
        # entries stay live; only (re)placement invalidates.
        self._address_links: dict = {}
        # paxsim: integer zone ids for the vectorized wave masks.
        # ``_zone_ids`` indexes self.zones; ``_addr_zone_ids`` interns
        # per placed address (UNPLACED_ZONE for everything else).
        # ``up_matrix`` caches against ``_up_gen``, bumped by every
        # partition/heal (degrade does not change reachability).
        self._zone_ids: dict[str, int] = {z: i
                                          for i, z in enumerate(self.zones)}
        self._addr_zone_ids: dict = {}
        self._up_gen = 0
        self._up_cache: tuple = (None, -1)
        # One reusable MT instance for per-frame jitter: ``seed(key)``
        # runs the same version-2 string seeding as ``Random(key)``
        # (sha512, PYTHONHASHSEED-proof), so draws are BIT-IDENTICAL
        # to a fresh instance per key -- the goldens prove it -- at
        # about half the cost (no 2.5KB state allocation per frame).
        self._jitter_rng = random.Random(0)

    # --- placement --------------------------------------------------------
    def place(self, address, zone: str) -> None:
        if zone not in self.region_of:
            raise ValueError(f"unknown zone {zone!r}")
        self._placement[address] = zone
        self._addr_zone_ids[address] = self._zone_ids[zone]
        self._address_links.clear()

    def place_all(self, addresses: Iterable, zone: str) -> None:
        for address in addresses:
            self.place(address, zone)

    def zone_of(self, address) -> Optional[str]:
        """The address's zone; None for unplaced addresses (admin /
        chaos senders), which ride zero-latency always-up links."""
        return self._placement.get(address)

    # --- the link matrix --------------------------------------------------
    def link(self, src_zone: str, dst_zone: str) -> Link:
        key = (src_zone, dst_zone)
        state = self._links.get(key)
        if state is None:
            if src_zone == dst_zone:
                base = self.intra_zone_s
            elif self.region_of[src_zone] == self.region_of[dst_zone]:
                base = self.intra_region_s
            else:
                base = self.cross_region_s
            state = Link(base_s=base, jitter_s=base * self.jitter)
            self._links[key] = state
        return state

    def link_for(self, src, dst) -> Optional[Link]:
        """The (cached) link between two ADDRESSES; None when either
        endpoint is unplaced (free, always-up)."""
        key = (src, dst)
        try:
            return self._address_links[key]
        except KeyError:
            pass
        src_zone = self.zone_of(src)
        dst_zone = self.zone_of(dst)
        link = (None if src_zone is None or dst_zone is None
                else self.link(src_zone, dst_zone))
        self._address_links[key] = link
        return link

    def link_up(self, src, dst) -> bool:
        """Whether the link between two ADDRESSES is currently up
        (unplaced endpoints are always reachable)."""
        link = self.link_for(src, dst)
        return link is None or link.up

    def zone_id_of(self, address) -> int:
        """The address's integer zone id for the vectorized wave masks
        (``simwave.UNPLACED_ZONE`` when unplaced)."""
        return self._addr_zone_ids.get(address, UNPLACED_ZONE)

    def up_matrix(self) -> np.ndarray:
        """``[Z+1, Z+1]`` bool reachability by zone id: entry
        ``[s, d]`` is the directed link's ``up``; the last row/column
        (reached by ``UNPLACED_ZONE`` = -1 via numpy wraparound) is the
        always-up sentinel for unplaced endpoints. Cached against the
        partition/heal generation; links never materialized by
        :meth:`link` default to up, matching ``link_up``."""
        cached, gen = self._up_cache
        if cached is not None and gen == self._up_gen:
            return cached
        z = len(self.zones)
        up = np.ones((z + 1, z + 1), dtype=bool)
        zone_ids = self._zone_ids
        for (src, dst), link in self._links.items():
            if not link.up:
                up[zone_ids[src], zone_ids[dst]] = False
        self._up_cache = (up, self._up_gen)
        return up

    def sample_delay(self, src, dst, frame_id: int) -> float:
        """The one-way delay for frame ``frame_id`` from ``src`` to
        ``dst``, deterministic per (topology seed, zone pair, frame).
        Jitter is one-sided (adds to the base): the base delay is the
        physical floor."""
        link = self.link_for(src, dst)
        if link is None:
            return 0.0
        delay = link.base_s * link.degrade
        if link.jitter_s:
            rng = self._jitter_rng
            rng.seed(f"{self.seed}|{self._placement[src]}"
                     f"|{self._placement[dst]}|{frame_id}")
            delay += link.jitter_s * link.degrade * rng.random()
        return delay

    def rtt(self, zone_a: str, zone_b: str) -> float:
        """Base round-trip time between two zones (no jitter)."""
        return self.link(zone_a, zone_b).base_s \
            + self.link(zone_b, zone_a).base_s

    def wan_rtt(self) -> float:
        """The cross-region round trip -- the unit the steal-latency
        gate is expressed in (bench/geo_lt.py)."""
        return 2 * self.cross_region_s

    # --- chaos controls ---------------------------------------------------
    def partition_link(self, zone_a: str, zone_b: str,
                       both_ways: bool = True) -> None:
        self.link(zone_a, zone_b).up = False
        if both_ways:
            self.link(zone_b, zone_a).up = False
        self._up_gen += 1

    def heal_link(self, zone_a: str, zone_b: str,
                  both_ways: bool = True) -> None:
        self.link(zone_a, zone_b).up = True
        if both_ways:
            self.link(zone_b, zone_a).up = True
        self._up_gen += 1

    def degrade_link(self, zone_a: str, zone_b: str,
                     factor: float, both_ways: bool = True) -> None:
        """Multiply the pair's base delay (brownout; 1.0 restores)."""
        self.link(zone_a, zone_b).degrade = factor
        if both_ways:
            self.link(zone_b, zone_a).degrade = factor

    def partition_zone(self, zone: str) -> None:
        """Cut every link between ``zone`` and the rest of the world
        (intra-zone traffic keeps flowing -- the zone is isolated, not
        dead; process death is the transport's ``crash``)."""
        for other in self.zones:
            if other != zone:
                self.partition_link(zone, other)

    def heal_zone(self, zone: str) -> None:
        for other in self.zones:
            if other != zone:
                self.heal_link(zone, other)

    def partition_regions(self, region_a: str, region_b: str) -> None:
        """Cut every link crossing between two regions (the
        cross-region partition arm of the scenario matrix)."""
        for za in self.zones:
            if self.region_of[za] != region_a:
                continue
            for zb in self.zones:
                if self.region_of[zb] == region_b:
                    self.partition_link(za, zb)

    def heal_regions(self, region_a: str, region_b: str) -> None:
        for za in self.zones:
            if self.region_of[za] != region_a:
                continue
            for zb in self.zones:
                if self.region_of[zb] == region_b:
                    self.heal_link(za, zb)

    def heal_all(self) -> None:
        for link in self._links.values():
            link.up = True
            link.degrade = 1.0
        self._up_gen += 1
