"""Wire a whole MultiPaxos deployment over one SimTransport.

The port's counterpart of ``tests/protocols/multipaxos_harness.py`` (it
lives in the package because ``chip_smoke.py`` and
``bench/multipaxos_sim.py`` build clusters with it): every role in one
process, driven by explicit message deliveries and timer firings, with
the same addresses, options and per-role seeds, so that the same writes
give the same message order, logs and replies in both packages. Its
durability half is the reference's too: ``wal=`` (MemStorage WALs that
survive ``crash_restart_acceptor`` / ``crash_restart_replica``, or
FileStorage WALs with real fsyncs under a directory),
``add_replacement_acceptor`` for a reconfiguration, and the
``epoch_tag_runs`` / ``epoch_quorums`` options. The serving half is the
reference's too: ``num_ingest_batchers`` (WAL-free ``IngestBatcher``s,
``crash_restart_ingest_batcher``), ``ingest_pipeline_window``,
``leader_admission`` (the Leaders' ``admission_*`` options) and the
clients' ``client_retry_budget`` / ``client_backoff``, and
``num_read_batchers`` with their ``read_batching_scheme``.

``device`` reaches the roles that hold one (the ProxyLeaders' trackers
with ``quorum_backend="cuda"``, the Leaders with
``phase1_backend="cuda"``); None means ``cuda``.
"""

from __future__ import annotations

import dataclasses
import os

from frankenpaxos_tpu_torch.ingest import (
    IngestBatcher,
    IngestBatcherOptions,
    MultiPaxosIngestRouter,
)
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
from frankenpaxos_tpu_torch.protocols.multipaxos.read_batcher import (
    ReadBatcher,
    ReadBatchingScheme,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.replica import (
    Replica,
    ReplicaOptions,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.statemachine import AppendLog
from frankenpaxos_tpu_torch.wal import FileStorage, MemStorage, Wal


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
    # paxingest disseminators (ingest/): WAL-free, rebuilt empty on
    # crash_restart_ingest_batcher.
    ingest_batchers: list = dataclasses.field(default_factory=list)
    # wal= extras: address -> storage (survives crash_restart), plus
    # what a restart needs to rebuild the actor.
    wal_storages: dict = dataclasses.field(default_factory=dict)
    state_machine_factory: object = None
    seed: int = 0
    #: The directory of FileStorage WALs, or None (MemStorage).
    wal_root: "str | None" = None
    #: Replacement acceptors' own configs (address -> config).
    acceptor_configs: dict = dataclasses.field(default_factory=dict)
    read_batchers: list = dataclasses.field(default_factory=list)


#: Small segment/compaction thresholds so sim runs exercise rotation
#: and snapshot GC, not just appends (the reference harness's values).
_SIM_WAL_SEGMENT_BYTES = 2048
_SIM_WAL_COMPACT_BYTES = 8192


def _sim_wal(storages: dict, address, root=None) -> Wal:
    """A Wal over the (surviving) MemStorage for ``address`` -- or, with
    ``root`` set, over FileStorage at <root>/<address> with the Wal's
    own thresholds, as the reference harness does."""
    if root is not None:
        storage = storages.setdefault(
            address, FileStorage(os.path.join(root, str(address))))
        return Wal(storage)
    storage = storages.setdefault(address, MemStorage())
    return Wal(storage, segment_bytes=_SIM_WAL_SEGMENT_BYTES,
               compact_every_bytes=_SIM_WAL_COMPACT_BYTES)


def crash_restart_acceptor(sim: MultiPaxosSim, i: int) -> None:
    """kill -9 acceptor ``i`` and restart it from its WAL: volatile
    state (staged acks, the unsynced group-commit buffer) dies; synced
    promises/votes/runs/epochs recover. Replacement acceptors relaunch
    with THEIR recorded config."""
    old = sim.acceptors[i]
    config = sim.acceptor_configs.get(old.address, sim.config)
    sim.transport.crash(old.address)
    sim.acceptors[i] = Acceptor(
        old.address, sim.transport, sim.transport.logger, config,
        old.options, wal=_sim_wal(sim.wal_storages, old.address,
                                  sim.wal_root))


def add_replacement_acceptor(sim: MultiPaxosSim, members: tuple,
                             new_address) -> None:
    """Construct a reconfiguration replacement: a NEW acceptor at
    ``new_address`` whose config lists exactly ``members`` as the
    acceptor group. The caller then sends ``Reconfigure(members)`` to
    the leader."""
    if new_address not in members:
        raise ValueError(f"{new_address!r} is not one of {members!r}")
    config = dataclasses.replace(sim.config,
                                 acceptor_addresses=[list(members)])
    sim.acceptor_configs[new_address] = config
    sim.acceptors.append(Acceptor(
        new_address, sim.transport, sim.transport.logger, config,
        wal=_sim_wal(sim.wal_storages, new_address, sim.wal_root)))


def crash_restart_ingest_batcher(sim: MultiPaxosSim, i: int) -> None:
    """kill -9 ingest batcher ``i`` and restart it EMPTY: batchers are
    WAL-free by design -- staged-but-unshipped commands die with the
    process and the owning clients' resend timers cover them (retries,
    never acked-write loss; the replica client table keeps resends
    exactly-once)."""
    old = sim.ingest_batchers[i]
    sim.transport.crash(old.address)
    sim.ingest_batchers[i] = IngestBatcher(
        old.address, sim.transport, sim.transport.logger,
        MultiPaxosIngestRouter(sim.config), index=i, options=old.options,
        seed=sim.seed + 50 + i)


def crash_restart_replica(sim: MultiPaxosSim, i: int) -> None:
    """kill -9 replica ``i`` and restart it: the SM rebuilds from the
    WAL snapshot + chosen-record replay; unsynced executions (never
    acked, by the group-commit rule) are re-learned or re-requested."""
    old = sim.replicas[i]
    sim.transport.crash(old.address)
    sim.replicas[i] = Replica(
        old.address, sim.transport, sim.transport.logger,
        sim.state_machine_factory(), sim.config, old.options,
        seed=sim.seed + 20 + i,
        wal=_sim_wal(sim.wal_storages, old.address, sim.wal_root))



def make_multipaxos(
    f: int = 1,
    num_clients: int = 1,
    num_acceptor_groups: int = 1,
    num_batchers: int = 0,
    num_ingest_batchers: int = 0,
    num_read_batchers: int = 0,
    read_batching_scheme: ReadBatchingScheme = ReadBatchingScheme(
        kind="size", batch_size=1),
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
    wal: "bool | str" = False,
    epoch_tag_runs: bool = False,
    epoch_quorums: bool = False,
    leader_admission: "dict | None" = None,
    client_retry_budget: int = 0,
    client_backoff=None,
    ingest_pipeline_window: "int | None" = None,
    device=None,
) -> MultiPaxosSim:
    """``coalesced``: False (every client sends per-message
    ClientRequests), True (every client stages its writes into request
    arrays) or "mixed" (even-indexed clients coalesce, odd ones do not).
    ``tpu_window`` is the ProxyLeaders' vote-board window: the
    reference harness's 2^12 by default, the role's own 2^20 for the
    full-width bench (the epoch board takes ``min(tpu_window, 2^14)``).
    ``wal``: False (no WAL), True (MemStorage WALs, the crash-restart
    sims) or a directory path (FileStorage WALs with real fsyncs, one
    subdirectory per role, written nowhere else).
    ``leader_admission``: the Leaders' ``admission_*`` options as a dict
    (e.g. ``{"admission_inflight_limit": 8}``);
    ``ingest_pipeline_window`` the ingest batchers' descriptor window
    (None keeps ``IngestBatcherOptions``' default)."""
    logger = FakeLogger(log_level)
    transport = SimTransport(logger)
    wal_storages: dict = {}
    wal_root = None if isinstance(wal, bool) else wal
    if wal is False:
        def wal_for(address):
            return None
    else:
        def wal_for(address):
            return _sim_wal(wal_storages, address, wal_root)
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
        ingest_batcher_addresses=[f"ingest-batcher-{i}"
                                  for i in range(num_ingest_batchers)],
        read_batcher_addresses=[f"read-batcher-{i}"
                                for i in range(num_read_batchers)],
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
    ingest_options = IngestBatcherOptions()
    if ingest_pipeline_window is not None:
        # Chaos rows pin tight descriptor windows so IngestCredit
        # watermarks are load-bearing under kill/partition, not slack.
        ingest_options = IngestBatcherOptions(
            pipeline_window=ingest_pipeline_window)
    ingest_batchers = [
        IngestBatcher(a, transport, logger,
                      MultiPaxosIngestRouter(config), index=i,
                      options=ingest_options, seed=seed + 50 + i)
        for i, a in enumerate(config.ingest_batcher_addresses)]
    read_batchers = [
        ReadBatcher(a, transport, logger, config, read_batching_scheme,
                    seed=seed + 40 + i)
        for i, a in enumerate(config.read_batcher_addresses)]
    leaders = [
        Leader(a, transport, logger, config,
               LeaderOptions(resend_phase1as_period_s=5.0,
                             phase1_backend=phase1_backend,
                             epoch_tag_runs=epoch_tag_runs,
                             **(leader_admission or {})),
               seed=seed + i, device=device)
        for i, a in enumerate(config.leader_addresses)]
    proxy_leaders = [
        ProxyLeader(a, transport, logger, config,
                    ProxyLeaderOptions(
                        quorum_backend=quorum_backend,
                        tpu_window=tpu_window,
                        tpu_pipelined=tpu_pipelined,
                        tpu_min_device_slots=tpu_min_device_slots,
                        epoch_quorums=epoch_quorums),
                    seed=seed + 10 + i, device=device)
        for i, a in enumerate(config.proxy_leader_addresses)]
    acceptors = [Acceptor(a, transport, logger, config, wal=wal_for(a))
                 for group in config.acceptor_addresses for a in group]
    replicas = [
        Replica(a, transport, logger, state_machine_factory(), config,
                ReplicaOptions(send_chosen_watermark_every_n_entries=10),
                seed=seed + 20 + i, wal=wal_for(a))
        for i, a in enumerate(config.replica_addresses)]
    proxy_replicas = [ProxyReplica(a, transport, logger, config)
                      for a in config.proxy_replica_addresses]
    if coalesced not in (False, True, "mixed"):
        raise ValueError(f"coalesced must be False, True or 'mixed', got "
                         f"{coalesced!r}")
    client_opt_extra: dict = {}
    if client_retry_budget:
        client_opt_extra["retry_budget"] = client_retry_budget
    if client_backoff is not None:
        client_opt_extra["backoff"] = client_backoff
    clients = [
        Client(f"client-{i}", transport, logger, config,
               ClientOptions(coalesce_writes=(
                   coalesced is True
                   or (coalesced == "mixed" and i % 2 == 0)),
                   **client_opt_extra),
               seed=seed + 30 + i)
        for i in range(num_clients)]
    return MultiPaxosSim(transport, config, batchers, leaders,
                         proxy_leaders, acceptors, replicas, proxy_replicas,
                         clients, ingest_batchers=ingest_batchers,
                         wal_storages=wal_storages,
                         state_machine_factory=state_machine_factory,
                         seed=seed, wal_root=wal_root,
                         read_batchers=read_batchers)


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
