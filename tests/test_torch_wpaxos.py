"""The port's WPaxos over the geo simulator vs the JAX package's.

(a) Every ``tests/protocols/test_wpaxos.py`` integration case that does
not take ``wal=True``, on the port's harness, on the dict quorum backend
and on ``"cuda"`` at ``device="cpu"`` (K6's and K5's plain versions)
where the reference used ``"tpu"``. The WAL cases (steal durability, the
zone outage, client failover after a zone restart) wait for the WAL
(ROADMAP.md queue 1 item 4).
(b) Cross-package: writes from two zones, a steal and a link partition
on ``geo3()`` (``tests/test_sim_core.py``'s WPaxos scenario) through the
JAX harness and the port's give equal delivery projections ``(id, src,
dst)``, virtual clocks, acks, client latencies and replicas'
``group_sequences()``, on each backend pair, with the port's link mask
on the numpy kernel and on K18's plain version.
(c) The ``WPaxosGeoSimulated`` chaos property on the port's ``Simulator``
for the reference's three parametrisations, and the first again on the
cuda backend, without the acceptor crash-restarts and zone kills, which
restart from the WAL (replica crash-restarts stay: replicas keep no
WAL).
(d) The refusals, and the geo_lt and storm twins small on the CPU.
"""

import functools
import random
from typing import Optional

from frankenpaxos_tpu_torch.bench import geo_lt, sim_core_ab
from frankenpaxos_tpu_torch.geo import GeoTopology
from frankenpaxos_tpu_torch.ops import simwave as tsw
from frankenpaxos_tpu_torch.protocols.wpaxos import (
    WPaxosLeader,
    WPaxosLeaderOptions,
)
from frankenpaxos_tpu_torch.protocols.wpaxos.harness import (
    crash_restart_acceptor,
    crash_restart_leader,
    crash_restart_replica,
    crash_zone,
    drive,
    make_wpaxos,
    restart_zone,
    settle,
)
from frankenpaxos_tpu_torch.protocols.wpaxos.messages import (
    Command,
    CommandId,
    Steal,
    WRequest,
)
from frankenpaxos_tpu_torch.runtime.sim_transport import DeliverMessage
from frankenpaxos_tpu_torch.sim import SimulatedSystem, Simulator
import pytest
import torch

from frankenpaxos_tpu import geo as jgeo
from frankenpaxos_tpu.protocols.wpaxos.messages import Steal as JSteal
from frankenpaxos_tpu.runtime.sim_transport import (
    DeliverMessage as JDeliverMessage,
)
import tests.protocols.wpaxos_harness as jharness

#: The port's quorum backends as the tests run them on the CPU.
BACKENDS = {"dict": {}, "cuda": {"quorum_backend": "cuda",
                                 "device": "cpu"}}


def geo3(seed: int = 0, jitter: float = 0.05, module=None) -> GeoTopology:
    cls = GeoTopology if module is None else module.GeoTopology
    return cls({"r0": ["zone-0"], "r1": ["zone-1"], "r2": ["zone-2"]},
               seed=seed, jitter=jitter)


@pytest.fixture(params=sorted(BACKENDS))
def backend(request):
    return BACKENDS[request.param]


# --- (a) integration ---------------------------------------------------------


def test_writes_ack_and_execute_on_every_replica(backend):
    sim = make_wpaxos(**backend)
    got = drive(sim, 8, key_prefix=b"obj1")
    assert got == [b"obj1-%d" % n for n in range(8)]
    seqs = [r.group_sequences() for r in sim.replicas]
    assert seqs[0] == seqs[1] == seqs[2]
    group = sim.config.group_of_key(b"obj1")
    assert seqs[0][group] == tuple(got)


def test_objects_partition_across_groups_and_zones(backend):
    sim = make_wpaxos(num_groups=4, **backend)
    keys = [b"obj-%d" % i for i in range(8)]
    groups = {key: sim.config.group_of_key(key) for key in keys}
    assert len(set(groups.values())) > 1
    got: list = []
    for n, key in enumerate(keys):
        start = len(got)
        sim.clients[0].write(0, b"%s/w%d" % (key, n), got.append, key=key)
        settle(sim, lambda: len(got) > start)
    assert len(got) == 8
    for key, group in groups.items():
        home = sim.config.initial_home[group]
        assert group in sim.leaders[home].active


def test_home_zone_commits_are_zone_local(backend):
    topo = geo3()
    sim = make_wpaxos(num_clients=3, topology=topo, **backend)
    group = sim.config.group_of_key(b"obj1")
    home = sim.config.initial_home[group]
    drive(sim, 6, client=home, key_prefix=b"obj1")
    steady = sorted(lat for _, _, lat in sim.clients[home].latencies)[:-1]
    assert max(steady) < 0.25 * topo.wan_rtt()


def test_remote_zone_redirect_then_steal_localizes_traffic(backend):
    topo = geo3()
    sim = make_wpaxos(num_clients=3, topology=topo, **backend)
    group = sim.config.group_of_key(b"obj1")
    home = sim.config.initial_home[group]
    remote = (home + 1) % 3
    drive(sim, 3, client=remote, key_prefix=b"obj1")
    assert sim.clients[remote].latencies[-1][2] > topo.wan_rtt()
    sim.leaders[remote].receive("admin", Steal(group))
    settle(sim, lambda: group in sim.leaders[remote].active)
    drive(sim, 3, client=remote, key_prefix=b"obj1")
    assert sim.clients[remote].latencies[-1][2] < 0.25 * topo.wan_rtt()
    event = sim.leaders[remote].steal_events[-1]
    assert event["active_s"] - event["started_s"] <= 3 * topo.wan_rtt()


def test_steal_adopts_in_flight_values(backend):
    sim = make_wpaxos(**backend)
    group = sim.config.group_of_key(b"obj1")
    home = sim.config.initial_home[group]
    drive(sim, 4, key_prefix=b"obj1", client=0)
    before = sim.replicas[0].group_sequences()[group]
    got: list = []
    sim.clients[0].write(0, b"obj1-inflight", got.append, key=b"obj1")
    for _ in range(4):
        if sim.transport.messages:
            sim.transport.deliver_message(sim.transport.messages[0])
    thief = sim.leaders[(home + 1) % 3]
    thief.receive("admin", Steal(group))
    settle(sim, lambda: group in thief.active)
    settle(sim, lambda: len(got) >= 1)
    seqs = [r.group_sequences()[group] for r in sim.replicas]
    assert seqs[0] == seqs[1] == seqs[2]
    assert seqs[0][:len(before)] == before
    assert seqs[0].count(b"obj1-inflight") == 1


def test_cross_region_partition_minority_cannot_steal(backend):
    topo = geo3()
    sim = make_wpaxos(num_clients=3, topology=topo, **backend)
    group = sim.config.group_of_key(b"obj1")
    home = sim.config.initial_home[group]
    drive(sim, 3, client=home, key_prefix=b"obj1")
    isolated = (home + 1) % 3
    topo.partition_zone(f"zone-{isolated}")
    thief = sim.leaders[isolated]
    thief.receive("admin", Steal(group))
    sim.transport.run_for(5.0, max_steps=50000)
    assert group not in thief.active
    drive(sim, 2, client=home, key_prefix=b"obj1")
    topo.heal_zone(f"zone-{isolated}")
    settle(sim, lambda: group in thief.active)
    got = drive(sim, 2, client=isolated, key_prefix=b"obj1")
    assert len(got) == 2
    seqs = [r.group_sequences()[group] for r in sim.replicas]
    n = min(len(s) for s in seqs)
    assert all(s[:n] == seqs[0][:n] for s in seqs)


def test_duplicate_suppression_across_resends(backend):
    sim = make_wpaxos(**backend)
    group = sim.config.group_of_key(b"obj1")
    got = drive(sim, 3, key_prefix=b"obj1")
    client = sim.clients[0]
    client.write(0, b"obj1-dup", got.append, key=b"obj1")
    settle(sim, lambda: len(got) >= 4)
    seq_before = sim.replicas[0].group_sequences()[group]
    home = sim.config.initial_home[group]
    sim.leaders[home].receive(
        client.address,
        WRequest(group=group, command=Command(
            command_id=CommandId(client.address, 0, 3),
            command=b"obj1-dup")))
    sim.transport.deliver_all_coalesced()
    seqs = [r.group_sequences()[group] for r in sim.replicas]
    assert seqs[0] == seq_before
    assert seqs[0].count(b"obj1-dup") == 1


def test_cuda_quorum_backend_matches_dict():
    """The device tracker drives the same protocol outcome as the dict
    oracle, across a steal (the reference's ``"tpu"`` case)."""
    results = {}
    for name, kwargs in BACKENDS.items():
        sim = make_wpaxos(**kwargs)
        group = sim.config.group_of_key(b"obj1")
        drive(sim, 4, key_prefix=b"obj1")
        thief = sim.leaders[(sim.config.initial_home[group] + 1) % 3]
        thief.receive("admin", Steal(group))
        settle(sim, lambda: group in thief.active)
        drive(sim, 4, key_prefix=b"obj1")
        results[name] = sim.replicas[0].group_sequences()
    assert results["dict"] == results["cuda"]


def test_leader_and_replica_restarts_recover(backend):
    """The crash helpers that need no WAL: a fresh replica re-learns the
    log, an amnesiac leader re-acquires its home group by stealing."""
    sim = make_wpaxos(**backend)
    group = sim.config.group_of_key(b"obj1")
    home = sim.config.initial_home[group]
    drive(sim, 3, key_prefix=b"obj1")
    crash_restart_replica(sim, home)
    crash_restart_leader(sim, home)
    got = drive(sim, 3, key_prefix=b"obj1", max_waves=400)
    assert len(got) == 3
    settle(sim, lambda: len(sim.replicas[home].group_sequences()[group])
           == 6, max_waves=400)
    seqs = [r.group_sequences()[group] for r in sim.replicas]
    assert seqs[0] == seqs[1] == seqs[2]


# --- (b) cross-package -------------------------------------------------------


def _projection(transport, cls) -> list:
    return [(c.message.id, str(c.message.src), str(c.message.dst))
            for c in transport.history if isinstance(c, cls)]


def _scenario(h, topo, steal, deliver_cls, **kwargs):
    sim = h.make_wpaxos(num_clients=3, topology=topo, **kwargs)
    group = sim.config.group_of_key(b"obj1")
    home = sim.config.initial_home[group]
    remote = (home + 1) % 3
    acks = h.drive(sim, 4, client=home, key_prefix=b"obj1")
    sim.leaders[remote].receive("admin", steal(group))
    h.settle(sim, lambda: group in sim.leaders[remote].active)
    sim.topology.partition_link(sim.topology.zones[home],
                                sim.topology.zones[remote])
    acks += h.drive(sim, 2, client=remote, key_prefix=b"obj1")
    sim.topology.heal_all()
    acks += h.drive(sim, 2, client=remote, key_prefix=b"obj1")
    return {"projection": _projection(sim.transport, deliver_cls),
            "now": sim.transport.now, "acks": acks,
            "latencies": [c.latencies for c in sim.clients],
            "sequences": [r.group_sequences() for r in sim.replicas],
            "steals": [len(lead.steal_events) for lead in sim.leaders]}


@pytest.mark.parametrize("pair", [("dict", "dict"), ("cuda", "tpu")])
@pytest.mark.parametrize("mask", ["numpy", "k18-plain"])
@pytest.mark.parametrize("jitter", [0.05, 0.0])
def test_geo3_run_matches_the_reference(pair, mask, jitter, monkeypatch):
    ours, ref = pair
    monkeypatch.setattr(tsw, "LINK_KEEP_MASK", {
        "numpy": tsw.link_keep_mask,
        "k18-plain": functools.partial(tsw.link_keep_mask_cuda,
                                       device="cpu")}[mask])
    want = _scenario(jharness, geo3(jitter=jitter, module=jgeo), JSteal,
                     JDeliverMessage, quorum_backend=ref)
    got = _scenario(
        __import__("frankenpaxos_tpu_torch.protocols.wpaxos.harness",
                   fromlist=["make_wpaxos"]),
        geo3(jitter=jitter), Steal, DeliverMessage,
        quorum_backend=ours, device="cpu")
    assert got == want


def test_flat_run_until_matches_the_reference():
    """The flat topology and ``run_until(now)``, the geo_lt flat arm's
    pump: equal projections and logs."""
    out = []
    for h, topo_module, deliver in (
            (jharness, jgeo, JDeliverMessage),
            (__import__("frankenpaxos_tpu_torch.protocols.wpaxos.harness",
                        fromlist=["make_wpaxos"]), None, DeliverMessage)):
        cls = GeoTopology if topo_module is None else topo_module.GeoTopology
        topo = cls({"r0": ["zone-0"], "r1": ["zone-1"], "r2": ["zone-2"]},
                   intra_zone_s=0.0, intra_region_s=0.0,
                   cross_region_s=0.0, jitter=0.0, seed=0)
        sim = h.make_wpaxos(topology=topo)
        got: list = []
        for n in range(40):
            sim.clients[0].write(n % 4, b"w%d" % n, got.append,
                                 key=b"k%d" % (n % 4))
            sim.transport.run_until(sim.transport.now, max_steps=100_000)
        out.append((_projection(sim.transport, deliver), got,
                    [r.group_sequences() for r in sim.replicas]))
    assert out[0] == out[1]


def _port_harness():
    return __import__("frankenpaxos_tpu_torch.protocols.wpaxos.harness",
                      fromlist=["make_wpaxos"])


@pytest.mark.parametrize("pair", [("dict", "dict"), ("cuda", "tpu")])
def test_adaptive_placement_matches_the_reference(pair):
    """The owner's placement policy (armed by its knobs) hands a group to
    the zone its traffic comes from, on the reference's schedule: equal
    projections, hand-offs, owners and acks."""
    from frankenpaxos_tpu.protocols.wpaxos import (
        WPaxosLeaderOptions as JWPaxosLeaderOptions,
    )

    out = []
    for h, topo_module, deliver, opts_cls, backend in (
            (jharness, jgeo, JDeliverMessage, JWPaxosLeaderOptions,
             pair[1]),
            (_port_harness(), None, DeliverMessage, WPaxosLeaderOptions,
             pair[0])):
        opts = opts_cls(placement_check_period_s=0.2,
                        placement_min_dwell_s=0.2, quorum_backend=backend)
        kwargs = {"device": "cpu"} if topo_module is None else {}
        sim = h.make_wpaxos(num_clients=3, leader_options=opts,
                            topology=geo3(module=topo_module), **kwargs)
        group = sim.config.group_of_key(b"obj1")
        remote = (sim.config.initial_home[group] + 1) % 3
        got: list = []
        client = sim.clients[remote]
        for n in range(40):
            for p in range(3):  # enough requests per check to dominate
                if p not in client.pending:
                    client.write(p, b"pl-%d-%d" % (n, p), got.append,
                                 key=b"obj1")
            sim.transport.run_for(0.1)
        out.append((_projection(sim.transport, deliver), got,
                    [lead.placement_handoffs for lead in sim.leaders],
                    [sorted(lead.active) for lead in sim.leaders]))
    assert out[0] == out[1]
    assert any(out[1][2]), "the placement policy never handed off"


def test_retry_budget_exhausts_on_the_reference_schedule():
    """A client cut off from every other zone gives up after its retry
    budget with RETRY_EXHAUSTED, as the reference's does, at the same
    virtual time."""
    from frankenpaxos_tpu.protocols.wpaxos import (
        WPaxosClientOptions as JWPaxosClientOptions,
    )
    from frankenpaxos_tpu_torch.protocols.wpaxos import WPaxosClientOptions
    from frankenpaxos_tpu_torch.serve.backoff import RETRY_EXHAUSTED

    out = []
    for h, topo_module, opts_cls in (
            (jharness, jgeo, JWPaxosClientOptions),
            (_port_harness(), None, WPaxosClientOptions)):
        topo = geo3(module=topo_module)
        sim = h.make_wpaxos(num_clients=3, topology=topo,
                            client_options=opts_cls(retry_budget=3))
        key = next(b"k%d" % i for i in range(100)
                   if sim.config.initial_home[
                       sim.config.group_of_key(b"k%d" % i)] == 1)
        topo.partition_zone("zone-0")
        got: list = []
        sim.clients[0].write(0, b"cut", got.append, key=key)
        sim.transport.run_for(60.0)
        out.append(([repr(r) for r in got], sim.clients[0].giveups,
                    round(sim.transport.now, 9)))
    assert out[0] == out[1]
    assert out[1][1] == 1 and out[1][0] == [repr(RETRY_EXHAUSTED)]


# --- (c) the chaos property --------------------------------------------------


class WriteCmd:
    def __init__(self, client, pseudonym, payload):
        self.client = client
        self.pseudonym = pseudonym
        self.payload = payload

    def __repr__(self):
        return f"Write({self.client}, {self.pseudonym}, {self.payload!r})"


class TransportCmd:
    def __init__(self, command):
        self.command = command

    def __repr__(self):
        return f"Transport({self.command!r})"


class StealCmd:
    def __init__(self, group, zone):
        self.group = group
        self.zone = zone

    def __repr__(self):
        return f"Steal({self.group} -> zone {self.zone})"


class LinkCmd:
    def __init__(self, zone_a, zone_b, heal):
        self.zone_a = zone_a
        self.zone_b = zone_b
        self.heal = heal

    def __repr__(self):
        verb = "HealLink" if self.heal else "CutLink"
        return f"{verb}({self.zone_a}, {self.zone_b})"


class CrashReplicaCmd:
    def __init__(self, index):
        self.index = index

    def __repr__(self):
        return f"CrashReplica({self.index})"


class SettleCmd:
    def __repr__(self):
        return "Settle()"


class WPaxosGeoSimulated(SimulatedSystem):
    """The reference's chaos system (writes + adversarial delivery
    interleaved with object steals, link partitions and replica
    crash-restarts) under its oracle: per-(group, slot) chosen-value
    uniqueness across every leader's and replica's log, per-group
    replica prefix compatibility, exactly-once execution, and per-replica
    growth except across that replica's own crash. Acceptor
    crash-restarts and zone kills restart from the WAL and are left
    out."""

    def __init__(self, num_zones: int = 3, row_width: int = 3,
                 num_groups: int = 3, jitter: float = 1.0,
                 quorum_backend: str = "dict"):
        self.num_zones = num_zones
        self.row_width = row_width
        self.num_groups = num_groups
        self.jitter = jitter
        self.quorum_backend = quorum_backend

    def new_system(self, seed: int):
        regions = {f"r{z}": [f"zone-{z}"] for z in range(self.num_zones)}
        topo = GeoTopology(regions, seed=seed, jitter=self.jitter)
        sim = make_wpaxos(num_zones=self.num_zones,
                          row_width=self.row_width,
                          num_groups=self.num_groups,
                          num_clients=self.num_zones, topology=topo,
                          seed=seed, quorum_backend=self.quorum_backend,
                          device="cpu")
        sim._counter = 0
        sim._crash_epochs = [0] * len(sim.replicas)
        return sim

    def generate_command(self, sim, rng: random.Random):
        choices: list = []
        idle = [(c, p) for c, client in enumerate(sim.clients)
                for p in range(2) if p not in client.pending]
        if idle:
            choices.extend(["write"] * 2)
        transport_cmd = sim.transport.generate_command(rng)
        if transport_cmd is not None:
            choices.extend(["transport"] * 6)
        if rng.random() < 0.12:
            choices.append("steal")
        if rng.random() < 0.12:
            choices.append("link")
        if rng.random() < 0.075:
            choices.append("crash")
        if rng.random() < 0.08:
            choices.append("settle")
        if not choices:
            return None
        kind = rng.choice(choices)
        if kind == "write":
            client, pseudonym = rng.choice(idle)
            sim._counter += 1
            return WriteCmd(client, pseudonym, b"w%d" % sim._counter)
        if kind == "steal":
            return StealCmd(rng.randrange(self.num_groups),
                            rng.randrange(self.num_zones))
        if kind == "link":
            zones = rng.sample(range(self.num_zones), 2)
            partitioned = not sim.topology.link(
                f"zone-{zones[0]}", f"zone-{zones[1]}").up
            return LinkCmd(zones[0], zones[1], heal=partitioned)
        if kind == "crash":
            return CrashReplicaCmd(rng.randrange(len(sim.replicas)))
        if kind == "settle":
            return SettleCmd()
        return TransportCmd(transport_cmd)

    def run_command(self, sim, command):
        if isinstance(command, WriteCmd):
            client = sim.clients[command.client]
            if command.pseudonym not in client.pending:
                client.write(command.pseudonym, command.payload,
                             key=command.payload)
        elif isinstance(command, StealCmd):
            sim.leaders[command.zone].receive("chaos-admin",
                                              Steal(command.group))
        elif isinstance(command, LinkCmd):
            a, b = f"zone-{command.zone_a}", f"zone-{command.zone_b}"
            if command.heal:
                sim.topology.heal_link(a, b)
            else:
                sim.topology.partition_link(a, b)
        elif isinstance(command, CrashReplicaCmd):
            index = command.index % len(sim.replicas)
            crash_restart_replica(sim, index)
            sim._crash_epochs[index] += 1
        elif isinstance(command, SettleCmd):
            sim.transport.deliver_all_coalesced(max_steps=400)
        else:
            sim.transport.run_command(command.command)
        return sim

    def state_invariant(self, sim) -> Optional[str]:
        chosen: dict = {}
        logs = []
        for i, leader in enumerate(sim.leaders):
            for group in range(sim.config.num_groups):
                logs.append((f"leader-{i}", group, leader.chosen[group]))
        for i, replica in enumerate(sim.replicas):
            for group in range(sim.config.num_groups):
                logs.append((f"replica-{i}", group, replica.logs[group]))
        for who, group, log in logs:
            for slot, value in log.items():
                prev = chosen.get((group, slot))
                if prev is not None and prev[1] != value:
                    return (f"group {group} slot {slot} chosen twice: "
                            f"{prev[0]} has {prev[1]!r}, {who} has "
                            f"{value!r}")
                chosen[(group, slot)] = (who, value)
        for group in range(sim.config.num_groups):
            seqs = [r.executed[group] for r in sim.replicas]
            for i in range(len(seqs)):
                for j in range(i + 1, len(seqs)):
                    n = min(len(seqs[i]), len(seqs[j]))
                    if seqs[i][:n] != seqs[j][:n]:
                        return (f"group {group} SM sequences diverge: "
                                f"{seqs[i]!r} vs {seqs[j]!r}")
        for i, replica in enumerate(sim.replicas):
            flat = [p for seq in replica.executed for p in seq]
            if len(set(flat)) != len(flat):
                return f"replica {i} executed a payload twice: {flat!r}"
        return None

    def get_state(self, sim):
        return tuple((sim._crash_epochs[i],
                      tuple(tuple(seq) for seq in r.executed))
                     for i, r in enumerate(sim.replicas))

    def step_invariant(self, old_state, new_state) -> Optional[str]:
        for (old_epoch, old_seqs), (new_epoch, new_seqs) in zip(
                old_state, new_state):
            if new_epoch != old_epoch:
                continue
            for old, new in zip(old_seqs, new_seqs):
                if new[:len(old)] != old:
                    return (f"replica SM sequence shrank/rewrote without "
                            f"a crash: {old} -> {new}")
        return None


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(num_zones=2, row_width=3, num_groups=2),
    dict(jitter=4.0),
    dict(quorum_backend="cuda"),
], ids=["z3", "z2", "high-jitter", "z3-cuda"])
def test_simulation_geo_chaos_no_divergence(kwargs):
    failure = Simulator(WPaxosGeoSimulated(**kwargs), run_length=150,
                        num_runs=10).run(seed=0)
    assert failure is None, str(failure)


# --- (d) refusals and the benches --------------------------------------------


def test_refusals(monkeypatch):
    with pytest.raises(NotImplementedError, match="item 4"):
        make_wpaxos(wal=True)
    sim = make_wpaxos()
    for helper in (crash_restart_acceptor, restart_zone):
        with pytest.raises(NotImplementedError, match="item 4"):
            helper(sim, 0)
    crash_zone(sim, 0)
    assert "leader-0" not in sim.transport.actors
    with pytest.raises(ValueError, match="quorum_backend"):
        make_wpaxos(quorum_backend="tpu")
    with pytest.raises(NotImplementedError, match="item 8.1"):
        WPaxosLeader("leader-0", sim.transport, sim.transport.logger,
                     sim.config, WPaxosLeaderOptions(
                         admission_inflight_limit=4))
    from frankenpaxos_tpu_torch.protocols.wpaxos.acceptor import (
        WPaxosAcceptor,
    )

    with pytest.raises(NotImplementedError, match="item 4"):
        WPaxosAcceptor("acceptor-0-0", sim.transport, sim.transport.logger,
                       sim.config, wal=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_wpaxos(quorum_backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        geo_lt.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_core_ab.run()


def test_geo_lt_twin_small_on_the_cpu(monkeypatch):
    """The bench end to end at a small depth: both backends, the
    exactness gate and the virtual-time gates. The flat arm's host-clock
    ratios are recorded, not judged: at 25 commands they measure noise."""
    monkeypatch.setitem(geo_lt.ENFORCED, "dict",
                        geo_lt.ENFORCED["cuda"])
    out = geo_lt.run("cpu", writes=4, flat_commands=25, flat_reps=1)
    assert out["exact_across_backends"]
    for backend in ("dict", "cuda"):
        run = out["backends"][backend]
        assert run["gates"]["home_p50_below_quarter_wan_rtt"]["passed"]
        assert run["gates"]["steal_latency_within_3_wan_rtt"]["passed"]
        assert set(run["launches"]) == {"release",
                                        "record_and_check_epochs",
                                        "reshape_columns",
                                        "link_keep_mask"}
        # settle() delivers one frame per wave: K18's threshold is
        # never reached on this path.
        assert run["latency_arms_waves"]["waves_at_least_vector_min"] == 0
    assert out["backends"]["dict"]["home_zone"] == \
        out["backends"]["cuda"]["home_zone"]


def test_geo_lt_exactness_gate_fires(monkeypatch):
    """A cuda run whose virtual latencies differ from the dict run's
    fails the bench."""
    monkeypatch.setitem(geo_lt.ENFORCED, "dict", geo_lt.ENFORCED["cuda"])
    real = geo_lt.backend_run

    def skewed(backend, *args):
        result, exact = real(backend, *args)
        if backend == "cuda":
            exact["steal"]["acks"] = exact["steal"]["acks"][:-1]
        return result, exact

    monkeypatch.setattr(geo_lt, "backend_run", skewed)
    with pytest.raises(geo_lt.GateFailure, match="steal"):
        geo_lt.run("cpu", writes=3, flat_commands=5, flat_reps=1)


def test_storm_twin_small_on_the_cpu():
    out = sim_core_ab.run("cpu", zones=100, burst=60, rounds=20,
                          fifo_depth=600, fifo_waves=2)
    arms = out["arms"]
    assert set(arms) == {"storm/jitter=0.05", "storm/jitter=0",
                         "fifo/deep-wave"}
    for arm in arms.values():
        assert set(arm["events_per_s"]) == {"numpy", "k18"}
        assert arm["k18_launches_per_block"] == [0, 0]  # plain on the CPU
    # Jittered waves are single frames; the jitter-free storm and the
    # FIFO backlogs reach the mask.
    assert arms["storm/jitter=0.05"]["waves_at_least_vector_min"] == 0
    assert arms["storm/jitter=0"]["waves_at_least_vector_min"] > 0
    assert arms["fifo/deep-wave"]["wave_size_histogram"] == {"512": 2}
    assert arms["fifo/deep-wave"]["events"] < 1200  # cut links dropped some
