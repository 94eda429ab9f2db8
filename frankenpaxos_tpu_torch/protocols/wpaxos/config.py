"""WPaxos deployment configuration (the port's copy of
``frankenpaxos_tpu/protocols/wpaxos/config.py``).

Zones are the unit of placement: one leader, one replica, and one
acceptor ROW (the ``ZoneGrid`` row, width ``2 * f_n + 1``) per zone.
Acceptors carry GLOBAL integer ids ``zone * row_width + i`` -- the
fixed universe every ``QuorumSpec`` (and the fused checkers) index,
stable across steals because steals move leadership, not membership.
"""

from __future__ import annotations

import dataclasses
import zlib

from frankenpaxos_tpu_torch.quorums import ZoneGrid


@dataclasses.dataclass(frozen=True)
class WPaxosConfig:
    zones: tuple                 # zone names, index = zone id
    leader_addresses: tuple      # [zone]
    acceptor_addresses: tuple    # [zone][i], equal-width rows
    replica_addresses: tuple     # [zone]
    num_groups: int = 4
    initial_home: tuple = ()     # group -> zone id; () = round-robin

    def __post_init__(self):
        object.__setattr__(self, "zones", tuple(self.zones))
        object.__setattr__(self, "leader_addresses",
                           tuple(self.leader_addresses))
        object.__setattr__(
            self, "acceptor_addresses",
            tuple(tuple(row) for row in self.acceptor_addresses))
        object.__setattr__(self, "replica_addresses",
                           tuple(self.replica_addresses))
        if not self.initial_home:
            object.__setattr__(
                self, "initial_home",
                tuple(g % len(self.zones)
                      for g in range(self.num_groups)))
        else:
            object.__setattr__(self, "initial_home",
                               tuple(self.initial_home))

    def check_valid(self) -> None:
        z = len(self.zones)
        if z < 1:
            raise ValueError("need at least one zone")
        if len(self.leader_addresses) != z:
            raise ValueError("need exactly one leader per zone")
        if len(self.replica_addresses) != z:
            raise ValueError("need exactly one replica per zone")
        if len(self.acceptor_addresses) != z:
            raise ValueError("need exactly one acceptor row per zone")
        width = len(self.acceptor_addresses[0])
        if width < 1 or any(len(row) != width
                            for row in self.acceptor_addresses):
            raise ValueError("acceptor rows must be equal-width >= 1")
        if self.num_groups < 1:
            raise ValueError("need at least one object group")
        if len(self.initial_home) != self.num_groups:
            raise ValueError(
                f"{len(self.initial_home)} initial homes != "
                f"{self.num_groups} groups")
        if any(not 0 <= h < z for h in self.initial_home):
            raise ValueError(f"initial home outside 0..{z - 1}")

    # --- derived views -----------------------------------------------------
    @property
    def num_zones(self) -> int:
        return len(self.zones)

    @property
    def row_width(self) -> int:
        return len(self.acceptor_addresses[0])

    def grid(self) -> ZoneGrid:
        """The quorum geometry over GLOBAL acceptor ids: rows are
        zones; Phase2 = home-row majority, Phase1 = every row's
        majority (quorums.ZoneGrid)."""
        width = self.row_width
        return ZoneGrid([[zone * width + i for i in range(width)]
                         for zone in range(self.num_zones)])

    def acceptor_id(self, zone: int, index: int) -> int:
        return zone * self.row_width + index

    def acceptor_address(self, acceptor_id: int):
        zone, index = divmod(acceptor_id, self.row_width)
        return self.acceptor_addresses[zone][index]

    def all_acceptors(self) -> tuple:
        return tuple(a for row in self.acceptor_addresses for a in row)

    def row_addresses(self, zone: int) -> tuple:
        return tuple(self.acceptor_addresses[zone])

    def group_of_key(self, key: bytes) -> int:
        """Object -> group routing: crc32 is stable across processes
        and platforms (unlike ``hash`` under PYTHONHASHSEED)."""
        return zlib.crc32(key) % self.num_groups

    # --- ballots ------------------------------------------------------------
    def ballot_zone(self, ballot: int) -> int:
        """Ballot space is partitioned by zone: ballot b belongs to
        zone ``b % num_zones``'s leader."""
        return ballot % self.num_zones

    def next_ballot(self, zone: int, above: int) -> int:
        """Zone ``zone``'s smallest owned ballot strictly greater than
        ``above``."""
        z = self.num_zones
        k = max(0, (above - zone) // z + 1)
        ballot = k * z + zone
        while ballot <= above:
            ballot += z
        return ballot
