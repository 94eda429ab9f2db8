"""Wire a whole MultiPaxos deployment over one SimTransport.

The port's counterpart of ``tests/protocols/multipaxos_harness.py`` (it
lives in the package because ``chip_smoke.py`` and
``bench/multipaxos_sim.py`` build clusters with it): every role in one
process, driven by explicit message deliveries and timer firings, with
the same addresses, options and per-role seeds, so that the same writes
give the same message order, logs and replies in both packages. The
reference harness's WAL, ingest batchers, read batchers, admission and
epoch options are not offered: those paths are not ported yet
(ROADMAP.md queue 1 items 4, 8.1, 8.2 and 8.3).

``device`` reaches the roles that hold one (the ProxyLeaders' trackers
with ``quorum_backend="cuda"``, the Leaders with
``phase1_backend="cuda"``); None means ``cuda``.
"""

from __future__ import annotations

import dataclasses

from frankenpaxos_tpu_torch.protocols.multipaxos.acceptor import Acceptor
from frankenpaxos_tpu_torch.protocols.multipaxos.batcher import (
    Batcher,
    BatcherOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.client import (
    Client,
    ClientOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.config import (
    DistributionScheme,
    MultiPaxosConfig,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.leader import (
    Leader,
    LeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.proxy_leader import (
    ProxyLeader,
    ProxyLeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.proxy_replica import (
    ProxyReplica,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.replica import (
    Replica,
    ReplicaOptions,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.statemachine import AppendLog


@dataclasses.dataclass
class MultiPaxosSim:
    transport: SimTransport
    config: MultiPaxosConfig
    batchers: list
    leaders: list
    proxy_leaders: list
    acceptors: list
    replicas: list
    proxy_replicas: list
    clients: list


def make_multipaxos(
    f: int = 1,
    num_clients: int = 1,
    num_acceptor_groups: int = 1,
    num_batchers: int = 0,
    num_proxy_replicas: int = 0,
    flexible: bool = False,
    grid_shape: "tuple[int, int] | None" = None,
    batch_size: int = 1,
    quorum_backend: str = "dict",
    tpu_window: int = 1 << 12,
    tpu_pipelined: bool = False,
    tpu_min_device_slots: int = 0,
    coalesced: "bool | str" = False,
    phase1_backend: str = "host",
    state_machine_factory=AppendLog,
    seed: int = 0,
    log_level: LogLevel = LogLevel.FATAL,
    device=None,
) -> MultiPaxosSim:
    """``coalesced``: False (every client sends per-message
    ClientRequests), True (every client stages its writes into request
    arrays) or "mixed" (even-indexed clients coalesce, odd ones do not).
    ``tpu_window`` is the ProxyLeaders' vote-board window: the
    reference harness's 2^12 by default, the role's own 2^20 for the
    full-width bench."""
    logger = FakeLogger(log_level)
    transport = SimTransport(logger)
    if flexible:
        rows, cols = grid_shape or (f + 1, f + 1)
        acceptor_addresses = [[f"acceptor-{g}-{i}" for i in range(cols)]
                              for g in range(rows)]
    else:
        acceptor_addresses = [
            [f"acceptor-{g}-{i}" for i in range(2 * f + 1)]
            for g in range(num_acceptor_groups)]
    config = MultiPaxosConfig(
        f=f,
        batcher_addresses=[f"batcher-{i}" for i in range(num_batchers)],
        read_batcher_addresses=[],
        leader_addresses=[f"leader-{i}" for i in range(f + 1)],
        leader_election_addresses=[f"election-{i}" for i in range(f + 1)],
        proxy_leader_addresses=[f"proxy-leader-{i}" for i in range(f + 1)],
        acceptor_addresses=acceptor_addresses,
        replica_addresses=[f"replica-{i}" for i in range(f + 1)],
        proxy_replica_addresses=[f"proxy-replica-{i}"
                                 for i in range(num_proxy_replicas)],
        flexible=flexible,
        distribution_scheme=DistributionScheme.HASH,
    )
    config.check_valid()

    batchers = [
        Batcher(a, transport, logger, config,
                BatcherOptions(batch_size=batch_size))
        for a in config.batcher_addresses]
    leaders = [
        Leader(a, transport, logger, config,
               LeaderOptions(resend_phase1as_period_s=5.0,
                             phase1_backend=phase1_backend),
               seed=seed + i, device=device)
        for i, a in enumerate(config.leader_addresses)]
    proxy_leaders = [
        ProxyLeader(a, transport, logger, config,
                    ProxyLeaderOptions(
                        quorum_backend=quorum_backend,
                        tpu_window=tpu_window,
                        tpu_pipelined=tpu_pipelined,
                        tpu_min_device_slots=tpu_min_device_slots),
                    seed=seed + 10 + i, device=device)
        for i, a in enumerate(config.proxy_leader_addresses)]
    acceptors = [Acceptor(a, transport, logger, config)
                 for group in config.acceptor_addresses for a in group]
    replicas = [
        Replica(a, transport, logger, state_machine_factory(), config,
                ReplicaOptions(send_chosen_watermark_every_n_entries=10),
                seed=seed + 20 + i)
        for i, a in enumerate(config.replica_addresses)]
    proxy_replicas = [ProxyReplica(a, transport, logger, config)
                      for a in config.proxy_replica_addresses]
    if coalesced not in (False, True, "mixed"):
        raise ValueError(f"coalesced must be False, True or 'mixed', got "
                         f"{coalesced!r}")
    clients = [
        Client(f"client-{i}", transport, logger, config,
               ClientOptions(coalesce_writes=(
                   coalesced is True
                   or (coalesced == "mixed" and i % 2 == 0))),
               seed=seed + 30 + i)
        for i in range(num_clients)]
    return MultiPaxosSim(transport, config, batchers, leaders,
                         proxy_leaders, acceptors, replicas, proxy_replicas,
                         clients)


def executed_prefix(replica: Replica) -> list:
    """The replica's executed log prefix as a list of values."""
    return [replica.log.get(slot)
            for slot in range(replica.executed_watermark)]


def deliver_until_quiet(transport: SimTransport,
                        max_steps: int = 100000) -> int:
    """``deliver_all_coalesced`` until no message is buffered (one call
    stops after ``max_steps`` deliveries); returns the deliveries."""
    total = 0
    while transport.messages:
        total += transport.deliver_all_coalesced(max_steps)
    return total
