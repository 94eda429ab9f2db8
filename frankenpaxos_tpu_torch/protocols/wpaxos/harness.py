"""Wire a whole WPaxos deployment over one transport.

The port's counterpart of ``tests/protocols/wpaxos_harness.py`` (it
lives in the package because ``chip_smoke.py`` and ``bench/geo_lt.py``
build clusters with it), with the same addresses, placements, options
and per-role seeds, so that the same writes give the same message
order, virtual times and logs in both packages. Two substrates: a plain
``SimTransport`` (adversarial sims, the flat bench arm) or a
``GeoSimTransport`` over a ``GeoTopology`` -- pass ``topology=`` to get
the geo substrate with every role placed in its zone and each client
placed in the zone of its index.

``quorum_backend="cuda"`` puts the leaders' vote counting on the card
(``device``, ``cuda`` when None; ``"cpu"`` runs the plain versions).
``wal=True`` gives every acceptor a MemStorage WAL that survives
:func:`crash_restart_acceptor` and :func:`restart_zone`.
"""

from __future__ import annotations

import dataclasses

from frankenpaxos_tpu_torch.geo import GeoSimTransport, GeoTopology
from frankenpaxos_tpu_torch.protocols.wpaxos import (
    WPaxosAcceptor,
    WPaxosClient,
    WPaxosClientOptions,
    WPaxosConfig,
    WPaxosLeader,
    WPaxosLeaderOptions,
    WPaxosReplica,
)
from frankenpaxos_tpu_torch.runtime import FakeLogger, LogLevel, SimTransport
from frankenpaxos_tpu_torch.wal import MemStorage, Wal


@dataclasses.dataclass
class WPaxosSim:
    transport: SimTransport
    config: WPaxosConfig
    leaders: list
    acceptors: list
    replicas: list
    clients: list
    topology: "GeoTopology | None" = None
    wal_storages: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    device: object = None


def _sim_wal(storages: dict, address) -> Wal:
    """A Wal over the (surviving) MemStorage for ``address``, at the
    reference harness's small segment and compaction thresholds."""
    storage = storages.setdefault(address, MemStorage())
    return Wal(storage, segment_bytes=2048, compact_every_bytes=8192)


def make_wpaxos(
    num_zones: int = 3,
    row_width: int = 3,
    num_groups: int = 4,
    num_clients: int = 1,
    topology: "GeoTopology | None" = None,
    wal: bool = False,
    quorum_backend: str = "dict",
    client_options: "WPaxosClientOptions | None" = None,
    leader_options: "WPaxosLeaderOptions | None" = None,
    seed: int = 0,
    log_level: LogLevel = LogLevel.FATAL,
    device=None,
) -> WPaxosSim:
    logger = FakeLogger(log_level)
    if topology is not None:
        if len(topology.zones) != num_zones:
            raise ValueError(
                f"topology has {len(topology.zones)} zones, "
                f"harness asked for {num_zones}")
        transport: SimTransport = GeoSimTransport(topology, logger)
    else:
        transport = SimTransport(logger)

    config = WPaxosConfig(
        zones=tuple(f"zone-{z}" for z in range(num_zones)),
        leader_addresses=tuple(f"leader-{z}" for z in range(num_zones)),
        acceptor_addresses=tuple(
            tuple(f"acceptor-{z}-{i}" for i in range(row_width))
            for z in range(num_zones)),
        replica_addresses=tuple(f"replica-{z}"
                                for z in range(num_zones)),
        num_groups=num_groups,
    )
    config.check_valid()

    if topology is not None:
        for z in range(num_zones):
            zone = topology.zones[z]
            topology.place(config.leader_addresses[z], zone)
            topology.place(config.replica_addresses[z], zone)
            topology.place_all(config.acceptor_addresses[z], zone)

    wal_storages: dict = {}
    leaders = [
        WPaxosLeader(a, transport, logger, config,
                     leader_options or WPaxosLeaderOptions(
                         quorum_backend=quorum_backend),
                     device=device)
        for a in config.leader_addresses]
    acceptors = [
        WPaxosAcceptor(a, transport, logger, config,
                       wal=_sim_wal(wal_storages, a) if wal else None)
        for row in config.acceptor_addresses for a in row]
    replicas = [
        WPaxosReplica(a, transport, logger, config)
        for a in config.replica_addresses]
    clients = []
    for i in range(num_clients):
        address = f"client-{i}"
        options = client_options or WPaxosClientOptions()
        if topology is not None:
            zone = i % num_zones
            topology.place(address, topology.zones[zone])
            if options.zone < 0:
                # Stamp the placed zone on requests (origin_zone): the
                # adaptive-placement EWMA's feed, routing telemetry only.
                options = dataclasses.replace(options, zone=zone)
        clients.append(WPaxosClient(
            address, transport, logger, config, options,
            seed=seed + i))

    return WPaxosSim(transport, config, leaders, acceptors, replicas,
                     clients, topology=topology,
                     wal_storages=wal_storages, seed=seed, device=device)


def crash_restart_acceptor(sim: WPaxosSim, i: int) -> None:
    """kill -9 acceptor ``i`` and restart it from its WAL (volatile
    state dies; synced promises/votes/epochs recover)."""
    old = sim.acceptors[i]
    sim.transport.crash(old.address)
    sim.acceptors[i] = WPaxosAcceptor(
        old.address, sim.transport, sim.transport.logger, sim.config,
        wal=_sim_wal(sim.wal_storages, old.address))


def crash_restart_replica(sim: WPaxosSim, i: int) -> None:
    """kill -9 replica ``i`` and restart it FRESH: it re-learns every
    group's log through WChosen + the recover timer (replicas keep no
    WAL; the acceptor tier is the durable one)."""
    old = sim.replicas[i]
    sim.transport.crash(old.address)
    sim.replicas[i] = WPaxosReplica(
        old.address, sim.transport, sim.transport.logger, sim.config)


def crash_restart_leader(sim: WPaxosSim, zone: int) -> None:
    """kill -9 zone ``zone``'s leader and restart it FRESH: it
    believes the initial placement until WEpochCommit/WNack traffic
    re-teaches it, and re-acquires groups only by stealing."""
    old = sim.leaders[zone]
    sim.transport.crash(old.address)
    sim.leaders[zone] = WPaxosLeader(
        old.address, sim.transport, sim.transport.logger, sim.config,
        old.options, device=sim.device)


def crash_zone(sim: WPaxosSim, zone: int) -> None:
    """Crash EVERY role in a zone (an outage); restart with
    :func:`restart_zone`."""
    sim.transport.crash(sim.leaders[zone].address)
    for acceptor in sim.acceptors:
        if acceptor.zone == zone:
            sim.transport.crash(acceptor.address)
    sim.transport.crash(sim.replicas[zone].address)


def restart_zone(sim: WPaxosSim, zone: int) -> None:
    """Relaunch every role of a crashed zone: acceptors from their
    WALs, leader/replica fresh."""
    for i, acceptor in enumerate(sim.acceptors):
        if acceptor.zone == zone:
            crash_restart_acceptor(sim, i)
    crash_restart_leader(sim, zone)
    crash_restart_replica(sim, zone)


def drive(sim: WPaxosSim, writes: int, pseudonym: int = 0,
          client: int = 0, key_prefix: bytes = b"k",
          max_waves: int = 200) -> list:
    """Issue ``writes`` sequential writes from one client, settling
    the network (and pumping liveness timers when stuck) after each.
    Payloads are GLOBALLY unique across calls/clients (the
    exactly-once oracle counts payload occurrences); the routing key
    stays ``key_prefix`` so one call targets one group. Returns the
    ack results."""
    got: list = []
    c = sim.clients[client]
    counter = getattr(sim, "_drive_counter", 0)
    for _ in range(writes):
        start = len(got)
        c.write(pseudonym, b"%s-%d" % (key_prefix, counter),
                got.append, key=key_prefix)
        counter += 1
        sim._drive_counter = counter
        settle(sim, lambda: len(got) > start, max_waves=max_waves)
    return got


def settle(sim: WPaxosSim, done, max_waves: int = 200) -> None:
    for _ in range(max_waves):
        if isinstance(sim.transport, GeoSimTransport):
            sim.transport.run_until_quiescent(max_steps=5000)
        else:
            sim.transport.deliver_all_coalesced(max_steps=5000)
        if done():
            return
        for timer in list(sim.transport.running_timers()):
            if timer.name.startswith(("resendWrite", "resendPhase1a",
                                      "resendEpochCommit", "recover",
                                      "retrySteal")):
                sim.transport.trigger_timer(timer.id)
    raise AssertionError("wpaxos sim did not settle")
