"""MultiPaxos cluster configuration (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/config.py``, on the port's own
``quorums.Grid``).

Reference behavior: multipaxos/Config.scala:16-147 (role address lists,
``f``, ``flexible`` grid mode, distribution scheme, and the validation
rules) and multipaxos/DistributionScheme.scala:151-162 (Hash: roles
spread over machines and picked round-robin/randomly; Colocated: proxy
roles live with their parent role, simulating coupled MultiPaxos).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from frankenpaxos_tpu_torch.quorums import Grid
from frankenpaxos_tpu_torch.runtime.transport import Address


class DistributionScheme(enum.Enum):
    HASH = "hash"
    COLOCATED = "colocated"


@dataclasses.dataclass(frozen=True)
class MultiPaxosConfig:
    f: int
    batcher_addresses: Sequence[Address]
    read_batcher_addresses: Sequence[Address]
    leader_addresses: Sequence[Address]
    leader_election_addresses: Sequence[Address]
    proxy_leader_addresses: Sequence[Address]
    # Non-flexible: acceptor groups of 2f+1 each; slots round-robin over
    # groups. Flexible: a grid -- rows are read quorums, one-per-row sets
    # are write quorums; the log is not partitioned.
    acceptor_addresses: Sequence[Sequence[Address]]
    replica_addresses: Sequence[Address]
    proxy_replica_addresses: Sequence[Address]
    flexible: bool = False
    distribution_scheme: DistributionScheme = DistributionScheme.HASH
    # paxingest (ingest/, docs/TRANSPORT.md): disseminator roles that
    # absorb client fan-in and hand leaders pre-batched IngestRun
    # descriptors. When non-empty, clients route writes here instead of
    # to batchers/leaders. WAL-free by design -- a dead batcher costs
    # client retries (covered by retry budgets + the replica client
    # table's exactly-once), never acked-write loss, so ANY count >= 1
    # is valid (failover is the client's resend to another batcher).
    ingest_batcher_addresses: Sequence[Address] = ()

    @property
    def num_ingest_batchers(self) -> int:
        return len(self.ingest_batcher_addresses)

    @property
    def num_batchers(self) -> int:
        return len(self.batcher_addresses)

    @property
    def num_read_batchers(self) -> int:
        return len(self.read_batcher_addresses)

    @property
    def num_leaders(self) -> int:
        return len(self.leader_addresses)

    @property
    def num_proxy_leaders(self) -> int:
        return len(self.proxy_leader_addresses)

    @property
    def num_acceptor_groups(self) -> int:
        return len(self.acceptor_addresses)

    @property
    def num_replicas(self) -> int:
        return len(self.replica_addresses)

    @property
    def num_proxy_replicas(self) -> int:
        return len(self.proxy_replica_addresses)

    def quorum_grid(self) -> Grid:
        """The (group, index) grid over acceptor coordinates, flattened to
        ints ``group * row_size + index`` (flexible mode)."""
        m = len(self.acceptor_addresses[0])
        return Grid([[g * m + i for i in range(m)]
                     for g in range(self.num_acceptor_groups)])

    def check_valid(self) -> None:
        def require(cond: bool, msg: str) -> None:
            if not cond:
                raise ValueError(msg)

        f = self.f
        require(f >= 1, f"f must be >= 1. It's {f}.")
        if self.distribution_scheme == DistributionScheme.HASH:
            require(self.num_batchers == 0 or self.num_batchers >= f + 1,
                    f"num_batchers must be 0 or >= f+1. It's "
                    f"{self.num_batchers}.")
        else:
            require(self.num_batchers in (0, self.num_leaders),
                    "num_batchers must be 0 or equal num_leaders for "
                    "Colocated.")
        require(self.num_read_batchers == 0
                or self.num_read_batchers >= f + 1,
                "num_read_batchers must be 0 or >= f+1.")
        require(self.num_leaders >= f + 1, "num_leaders must be >= f+1.")
        require(len(self.leader_election_addresses) == self.num_leaders,
                "leader_election_addresses must match leader_addresses.")
        require(self.num_proxy_leaders >= f + 1,
                "num_proxy_leaders must be >= f+1.")
        if self.distribution_scheme == DistributionScheme.COLOCATED:
            require(self.num_proxy_leaders == self.num_leaders,
                    "num_proxy_leaders must equal num_leaders for Colocated.")
        require(self.num_acceptor_groups >= 1,
                "need at least one acceptor group.")
        if not self.flexible:
            for group in self.acceptor_addresses:
                require(len(group) == 2 * f + 1,
                        f"acceptor groups must have 2f+1 = {2*f+1} members; "
                        f"one has {len(group)}.")
        else:
            m = len(self.acceptor_addresses[0])
            for row in self.acceptor_addresses:
                require(len(row) == m, "grid rows must be equal-sized.")
            n = self.num_acceptor_groups
            require(min(n, m) - 1 >= f,
                    f"an {n}x{m} grid tolerates min(n,m)-1 = {min(n,m)-1} "
                    f"failures < f = {f}.")
        require(self.num_replicas >= f + 1, "num_replicas must be >= f+1.")
        require(self.num_proxy_replicas == 0
                or self.num_proxy_replicas >= f + 1,
                "num_proxy_replicas must be 0 or >= f+1.")
        if self.distribution_scheme == DistributionScheme.COLOCATED:
            require(self.num_proxy_replicas in (0, self.num_replicas),
                    "num_proxy_replicas must equal num_replicas for "
                    "Colocated.")
