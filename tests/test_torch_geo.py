"""The port's geo layer against the JAX package's.

(a) The ``tests/test_geo.py`` cases for the topology, the transport
(the committed golden delivery order byte for byte), ``ZoneGrid``, the
quorum tracker and the RTT estimator, repeated against the port. The
heartbeat and election cases wait for ``heartbeat.py`` and the adaptive
election (ROADMAP.md queue 1 item 8.4).
(b) Cross-package equivalence of the transports: the geo scenarios of
``tests/test_sim_core.py`` (jittered arrivals, link and address
partitions, timers, ``max_steps`` caps, FIFO drains over the geo
transport, random partition schedules) run on the port's
``GeoSimTransport`` and the JAX package's, with the port's link mask on
the numpy kernel and on K18's plain version, give equal delivery
projections, actor logs, drains, virtual clocks and buffers; on a
jitter-free topology the waves reach the mask.
(c) ``GeoQuorumTracker``: dict against cuda (``device="cpu"``) against
the JAX ``"tpu"`` backend on the same votes across a mid-stream steal,
and the port's refusals.
(d) The wave engine's fall-back and bookkeeping in the port.
(e) ``convert``: an ``ObjectEpochStore`` chain and a tracker's board and
planes carried from the JAX package's state.
"""

import functools
import itertools
import json
import os
import random

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.geo import (
    GeoQuorumTracker,
    GeoSimTransport,
    GeoTopology,
    ObjectEpochStore,
    RttEstimator,
)
from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch
from frankenpaxos_tpu_torch.geo.transport import delivery_schedule
from frankenpaxos_tpu_torch.mesh import Mesh
from frankenpaxos_tpu_torch.ops import simwave as tsw
from frankenpaxos_tpu_torch.quorums import (
    quorum_system_from_dict,
    quorum_system_to_dict,
    ZoneGrid,
)
from frankenpaxos_tpu_torch.runtime import (
    Actor,
    FakeLogger,
    LogLevel,
    SimTransport,
)
from frankenpaxos_tpu_torch.runtime.sim_transport import (
    DeliverMessage,
    TriggerTimer,
)
import jax
import numpy as np
import pytest
import torch

from frankenpaxos_tpu import geo as jgeo
from frankenpaxos_tpu.geo import epochs as jepochs
from frankenpaxos_tpu.quorums import ZoneGrid as JZoneGrid
from frankenpaxos_tpu.runtime import (
    Actor as JActor,
    FakeLogger as JFakeLogger,
    LogLevel as JLogLevel,
)
from frankenpaxos_tpu.runtime.sim_transport import (
    DeliverMessage as JDeliverMessage,
    TriggerTimer as JTriggerTimer,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "geo_delivery_order.json")


def three_regions(seed: int = 0, jitter: float = 0.05) -> GeoTopology:
    return GeoTopology({"us": ["us-a", "us-b"], "eu": ["eu-a"],
                        "ap": ["ap-a"]}, seed=seed, jitter=jitter)


# --- (a) GeoTopology ---------------------------------------------------------


class TestGeoTopology:
    def test_link_tiers(self):
        topo = three_regions()
        assert topo.link("us-a", "us-a").base_s == topo.intra_zone_s
        assert topo.link("us-a", "us-b").base_s == topo.intra_region_s
        assert topo.link("us-a", "eu-a").base_s == topo.cross_region_s
        assert topo.wan_rtt() == 2 * topo.cross_region_s

    def test_delay_deterministic_per_seed_and_frame(self):
        a, b, c = three_regions(seed=7), three_regions(seed=7), \
            three_regions(seed=8)
        for t in (a, b, c):
            t.place("x", "us-a")
            t.place("y", "eu-a")
        assert a.sample_delay("x", "y", 3) == b.sample_delay("x", "y", 3)
        assert a.sample_delay("x", "y", 3) != c.sample_delay("x", "y", 3)
        assert a.sample_delay("x", "y", 3) != a.sample_delay("x", "y", 4)
        assert a.sample_delay("x", "y", 3) >= a.cross_region_s

    def test_delays_equal_the_reference(self):
        for seed, jitter in ((0, 0.05), (7, 0.5), (3, 4.0)):
            ours = three_regions(seed, jitter)
            ref = jgeo.GeoTopology({"us": ["us-a", "us-b"], "eu": ["eu-a"],
                                    "ap": ["ap-a"]}, seed=seed,
                                   jitter=jitter)
            for t in (ours, ref):
                for i, zone in enumerate(t.zones):
                    t.place(f"n{i}", zone)
                t.degrade_link("us-a", "ap-a", 3.0)
            for frame in range(40):
                for i, j in itertools.product(range(4), repeat=2):
                    assert ours.sample_delay(f"n{i}", f"n{j}", frame) == \
                        ref.sample_delay(f"n{i}", f"n{j}", frame)
            assert ours.sample_delay("admin", "n0", 1) == 0.0

    def test_unplaced_addresses_are_free_and_reachable(self):
        topo = three_regions()
        assert topo.sample_delay("admin", "anything", 1) == 0.0
        assert topo.link_up("admin", "anything")

    def test_partition_and_degrade_controls(self):
        topo = three_regions()
        topo.place("x", "us-a")
        topo.place("y", "eu-a")
        topo.place("z", "us-b")
        topo.partition_link("us-a", "eu-a")
        assert not topo.link_up("x", "y") and not topo.link_up("y", "x")
        topo.heal_link("us-a", "eu-a")
        assert topo.link_up("x", "y")
        topo.degrade_link("us-a", "eu-a", 10.0)
        assert topo.sample_delay("x", "y", 1) >= 10 * topo.cross_region_s
        topo.heal_all()
        assert topo.sample_delay("x", "y", 1) < 10 * topo.cross_region_s
        topo.partition_zone("us-a")
        assert not topo.link_up("x", "y") and not topo.link_up("x", "z")
        topo.heal_zone("us-a")
        topo.partition_regions("us", "eu")
        assert not topo.link_up("x", "y")
        assert not topo.link_up("z", "y")
        assert topo.link_up("x", "z")
        topo.heal_regions("us", "eu")
        assert topo.link_up("x", "y")

    def test_up_matrix_agrees_with_link_up_and_the_reference(self):
        ours = geo_topology()
        ref = jgeo.GeoTopology(
            {f"r{r}": [f"z{r}-{z}" for z in range(3)] for r in range(3)},
            seed=7)
        addrs = []
        for t in (ours, ref):
            for i, zone in enumerate(t.zones):
                t.place(f"n{i}", zone)
        addrs = [f"n{i}" for i in range(len(ours.zones))] + ["admin"]
        rng = random.Random("up-matrix")
        for _ in range(30):
            a, b = rng.choice(ours.zones), rng.choice(ours.zones)
            if rng.random() < 0.6:
                both = rng.random() < 0.5
                ours.partition_link(a, b, both_ways=both)
                ref.partition_link(a, b, both_ways=both)
            else:
                ours.heal_link(a, b)
                ref.heal_link(a, b)
            up = ours.up_matrix()
            assert np.array_equal(up, ref.up_matrix())
            assert up is ours.up_matrix()  # cached until the next change
            for x in addrs:
                for y in addrs:
                    assert bool(up[ours.zone_id_of(x), ours.zone_id_of(y)]) \
                        == ours.link_up(x, y), (x, y)

    def test_jitter_rng_reuse_is_bit_identical_to_fresh_instances(self):
        topo = geo_topology(seed=21)
        topo.place("a", topo.zones[0])
        topo.place("b", topo.zones[-1])
        for frame_id in range(50):
            got = topo.sample_delay("a", "b", frame_id)
            link = topo.link_for("a", "b")
            u = random.Random(
                f"{topo.seed}|{topo._placement['a']}"
                f"|{topo._placement['b']}|{frame_id}").random()
            assert got == link.base_s * link.degrade \
                + link.jitter_s * link.degrade * u


# --- (a) GeoSimTransport -----------------------------------------------------


class _Recorder(Actor):
    """Echoes each payload back ``hops`` more times, recording every
    receive against the virtual clock."""

    def __init__(self, address, transport, logger, log):
        super().__init__(address, transport, logger)
        self.log = log

    def receive(self, src, message):
        hops, payload = message
        self.log.append((round(self.transport.now, 9), str(src),
                         str(self.address), payload))
        if hops > 0:
            self.send(src, (hops - 1, payload))


def _run_recorder_scenario(seed: int):
    topo = three_regions(seed=seed, jitter=0.5)
    transport = GeoSimTransport(topo, FakeLogger(LogLevel.FATAL))
    log: list = []
    actors = {}
    for zone in topo.zones:
        address = f"actor-{zone}"
        topo.place(address, zone)
        actors[address] = _Recorder(address, transport, transport.logger,
                                    log)
    addresses = sorted(actors)
    for a in addresses:
        for b in addresses:
            if a != b:
                actors[a].send(b, (3, f"{a}->{b}"))
    transport.run_for(10.0)
    return log


class TestGeoSimTransport:
    def test_delivery_ordered_by_arrival_not_enqueue(self):
        topo = three_regions()
        transport = GeoSimTransport(topo, FakeLogger(LogLevel.FATAL))
        log: list = []
        for zone in ("us-a", "us-b", "eu-a"):
            topo.place(f"actor-{zone}", zone)
            _Recorder(f"actor-{zone}", transport, transport.logger, log)
        ser = Actor.serializer
        transport.send("actor-us-a", "actor-eu-a", ser.to_bytes((0, "wan")))
        transport.send("actor-us-a", "actor-us-b",
                       ser.to_bytes((0, "local")))
        transport.run_for(1.0)
        assert [row[3] for row in log] == ["local", "wan"]

    def test_link_partition_drops_at_delivery(self):
        topo = three_regions()
        transport = GeoSimTransport(topo, FakeLogger(LogLevel.FATAL))
        log: list = []
        topo.place("actor-us-a", "us-a")
        topo.place("actor-eu-a", "eu-a")
        a = _Recorder("actor-us-a", transport, transport.logger, log)
        _Recorder("actor-eu-a", transport, transport.logger, log)
        a.send("actor-eu-a", (0, "x"))
        topo.partition_link("us-a", "eu-a")  # mid-flight
        transport.run_for(1.0)
        assert log == [] and transport.messages == []

    def test_timers_fire_at_virtual_deadlines(self):
        topo = three_regions()
        transport = GeoSimTransport(topo, FakeLogger(LogLevel.FATAL))
        fired = []
        timer = transport.timer("a", "t", 0.25,
                                lambda: fired.append(transport.now))
        timer.start()
        transport.run_for(0.2)
        assert fired == []
        transport.run_for(0.1)
        assert fired == [pytest.approx(0.25)]

    def test_same_seed_identical_event_sequence(self):
        assert _run_recorder_scenario(seed=42) == \
            _run_recorder_scenario(seed=42)
        assert _run_recorder_scenario(seed=42) != \
            _run_recorder_scenario(seed=43)

    def test_golden_delivery_order(self):
        """Byte-identical against the reference's committed schedule."""
        got = json.dumps(_run_recorder_scenario(seed=42), indent=1)
        with open(GOLDEN) as f:
            assert f.read() == got + "\n"

    def test_stall_sender_delays_departures(self):
        topo = three_regions(jitter=0.0)
        transport = GeoSimTransport(topo, FakeLogger(LogLevel.FATAL))
        log: list = []
        for zone in ("us-a", "us-b"):
            topo.place(f"actor-{zone}", zone)
            _Recorder(f"actor-{zone}", transport, transport.logger, log)
        transport.stall_sender("actor-us-a", 0.5)
        transport.stall_sender("actor-us-a", 0.1)  # stalls only extend
        transport.send("actor-us-a", "actor-us-b",
                       Actor.serializer.to_bytes((0, "late")))
        transport.run_for(1.0)
        assert log == [(round(0.5 + topo.intra_region_s, 9), "actor-us-a",
                        "actor-us-b", "late")]


# --- (a) ZoneGrid ------------------------------------------------------------


class TestZoneGrid:
    def test_quorum_geometry(self):
        g = ZoneGrid([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
        assert g.is_write_quorum({0, 1})
        assert g.is_write_quorum({4, 5})
        assert not g.is_write_quorum({0, 4})
        assert g.is_read_quorum({0, 1, 3, 4, 6, 7})
        assert not g.is_read_quorum({0, 1, 3, 4, 6})

    def test_every_read_intersects_every_write(self):
        g = ZoneGrid([[0, 1, 2], [3, 4, 5]])
        rng = random.Random(0)
        for _ in range(200):
            assert g.random_read_quorum(rng) & g.random_write_quorum(rng)
        rows = [list(row) for row in g.grid]
        for row in rows:
            for w in itertools.combinations(row, g.row_majority):
                for parts in itertools.product(
                        *[itertools.combinations(r, g.row_majority)
                          for r in rows]):
                    assert set().union(*map(set, parts)) & set(w)

    def test_specs_match_set_oracle_and_the_reference(self):
        g = ZoneGrid([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
        jg = JZoneGrid([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
        rng = random.Random(1)
        nodes = sorted(g.nodes())
        for _ in range(300):
            xs = {n for n in nodes if rng.random() < 0.5}
            assert g.read_spec().check(xs) == \
                g.is_superset_of_read_quorum(xs) == \
                jg.read_spec().check(xs)
            assert g.write_spec().check(xs) == \
                g.is_superset_of_write_quorum(xs) == \
                jg.write_spec().check(xs)
        for zone in range(3):
            spec, jspec = g.home_write_spec(zone), jg.home_write_spec(zone)
            assert np.array_equal(spec.masks, jspec.masks)
            assert np.array_equal(spec.thresholds, jspec.thresholds)
            row = set(g.grid[zone])
            for _ in range(100):
                xs = {n for n in nodes if rng.random() < 0.5}
                assert spec.check(xs) == (len(xs & row) >= g.row_majority)

    def test_rejects_malformed_grids(self):
        for grid in ([], [[0, 1], [2]], [[0, 1], [1, 2]]):
            with pytest.raises(ValueError):
                ZoneGrid(grid)

    def test_dict_round_trip(self):
        g = ZoneGrid([[0, 1], [2, 3]])
        d = quorum_system_to_dict(g)
        assert d["kind"] == "zone_grid"
        back = quorum_system_from_dict(d)
        assert isinstance(back, ZoneGrid) and back.grid == g.grid


# --- (c) GeoQuorumTracker ----------------------------------------------------


def _store_with_steal(cls=ObjectEpochStore, epoch_cls=GeoEpoch):
    store = cls(2, [0, 1])
    assert store.offer(epoch_cls(group=0, epoch=1, start_slot=8,
                                 home_zone=2, ballot=5)) == "new"
    return store


GRID = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


def _trackers(store):
    grid = ZoneGrid(GRID)
    return [GeoQuorumTracker(store, 0, grid, backend="dict"),
            GeoQuorumTracker(store, 0, grid, backend="cuda", device="cpu")]


class TestGeoQuorumTracker:
    def test_dict_and_cuda_backends_identical(self):
        trackers = _trackers(_store_with_steal())
        rng = random.Random(3)
        votes = []
        for slot in range(16):
            ballot = 0 if slot < 8 else 5
            for acceptor in rng.sample(range(9), rng.randint(1, 9)):
                votes.append((slot, ballot, acceptor))
        rng.shuffle(votes)
        outs = [[], []]
        for i, vote in enumerate(votes):
            for t, out in zip(trackers, outs):
                t.record(*vote)
                if i % 5 == 4:
                    out.extend(t.drain())
        for t, out in zip(trackers, outs):
            out.extend(t.drain())
        assert sorted(outs[0]) == sorted(outs[1])
        chosen = dict(outs[0])
        for slot in chosen:
            assert (slot < 8 and chosen[slot] == 0) or \
                (slot >= 8 and chosen[slot] == 5)

    def test_steal_mid_stream_appends_plane(self):
        store = ObjectEpochStore(1, [0])
        trackers = _trackers(store)
        for t in trackers:
            t.record(0, 0, 0)
            t.record(0, 0, 1)
        store.offer(GeoEpoch(group=0, epoch=1, start_slot=1, home_zone=1,
                             ballot=4))
        for t in trackers:
            t.note_epochs()
            t.record(1, 4, 3)
            t.record(1, 4, 4)
        assert sorted(trackers[0].drain()) == \
            sorted(trackers[1].drain()) == [(0, 0), (1, 4)]

    @pytest.mark.parametrize("seed", range(4))
    def test_backends_match_the_reference_across_a_steal(self, seed):
        """The same votes, drains, steals (one superseded, which rebuilds
        the checker) and releases through the port's trackers and the
        reference's: the port's dict equals the JAX dict oracle, and the
        port's cuda (``device="cpu"``) the JAX ``"tpu"`` tracker, drain
        for drain. The traffic includes votes at a stale ballot and from
        outside the home row, where the board's one-round-per-column
        semantics and the oracle's per-ballot sets part ways."""
        store = ObjectEpochStore(1, [0])
        jstore = jepochs.ObjectEpochStore(1, [0])
        grid, jgrid = ZoneGrid(GRID), JZoneGrid(GRID)
        trackers = [
            GeoQuorumTracker(store, 0, grid, backend="dict"),
            jgeo.GeoQuorumTracker(jstore, 0, jgrid, backend="dict"),
            GeoQuorumTracker(store, 0, grid, backend="cuda", device="cpu",
                             window=64),
            jgeo.GeoQuorumTracker(jstore, 0, jgrid, backend="tpu",
                                  window=64)]
        rng = random.Random(f"geo-tracker|{seed}")
        steals = {40: (1, 30, 1, 4), 80: (2, 70, 2, 8),
                  100: (2, 70, 1, 10)}  # the last supersedes epoch 2
        reported = [set() for _ in trackers]
        for step in range(160):
            if step in steals:
                epoch, start, zone, ballot = steals[step]
                for st, cls in ((store, GeoEpoch),
                                (jstore, jepochs.GeoEpoch)):
                    st.offer(cls(group=0, epoch=epoch, start_slot=start,
                                 home_zone=zone, ballot=ballot))
                for t in trackers:
                    t.note_epochs()
            slot = rng.randrange(0, 120)
            entry = store.epoch_of_slot(0, slot)
            ballot = entry.ballot if rng.random() < 0.85 \
                else rng.randrange(entry.ballot + 3)
            row = GRID[entry.home_zone] if rng.random() < 0.8 \
                else GRID[rng.randrange(3)]
            for acceptor in rng.sample(row, rng.randint(1, 3)):
                for t in trackers:
                    t.record(slot, ballot, acceptor)
            if step % 7 == 6:
                got = [t.drain() for t in trackers]
                assert got[0] == got[1], step
                assert got[2] == got[3], step
                for r, g in zip(reported, got):
                    r.update(g)
            if step % 23 == 22:
                for t in trackers:
                    t.release(list(range(step % 5, step % 5 + 3)))
        assert reported[0] and reported[2]

    def test_refusals(self, monkeypatch):
        store = ObjectEpochStore(1, [0])
        grid = ZoneGrid(GRID)
        with pytest.raises(ValueError, match="tpu"):
            GeoQuorumTracker(store, 0, grid, backend="tpu")
        # A mesh is taken (the sharded board), on the mesh's device; a
        # device of another kind is refused, and the dict oracle ignores
        # the mesh.
        cpu_mesh = Mesh(1, 1, 0, torch.device("cpu"))
        sharded = GeoQuorumTracker(store, 0, grid, backend="cuda",
                                   mesh=cpu_mesh)
        assert sharded.device == torch.device("cpu")
        with pytest.raises(ValueError, match="not the mesh's"):
            GeoQuorumTracker(store, 0, grid, backend="cuda", mesh=cpu_mesh,
                             device="meta")
        assert GeoQuorumTracker(store, 0, grid, mesh=object()).device is None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GeoQuorumTracker(store, 0, grid, backend="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GeoQuorumTracker(store, 0, grid, backend="cuda", mesh=Mesh(
                1, 1, 0, torch.device("cuda")))
        assert GeoQuorumTracker(store, 0, grid).device is None


class TestObjectEpochStore:
    def test_offers_match_the_reference(self):
        rng = random.Random(11)
        ours = ObjectEpochStore(3, [0, 1, 2])
        ref = jepochs.ObjectEpochStore(3, [0, 1, 2])
        for _ in range(300):
            group = rng.randrange(3)
            epoch = ours.current(group).epoch + rng.choice((-1, 0, 1, 1, 2))
            fields = dict(group=group, epoch=max(0, epoch),
                          start_slot=rng.randrange(50),
                          home_zone=rng.randrange(3),
                          ballot=rng.randrange(30))
            assert ours.offer(GeoEpoch(**fields)) == \
                ref.offer(jepochs.GeoEpoch(**fields))
            for g in range(3):
                assert [dataclass_tuple(e) for e in ours.known(g)] == \
                    [dataclass_tuple(e) for e in ref.known(g)]
                assert ours.max_ballot(g) == ref.max_ballot(g)
                slot = rng.randrange(60)
                assert dataclass_tuple(ours.epoch_of_slot(g, slot)) == \
                    dataclass_tuple(ref.epoch_of_slot(g, slot))
        assert ours.version == ref.version


def dataclass_tuple(entry) -> tuple:
    return (entry.group, entry.epoch, entry.start_slot, entry.home_zone,
            entry.ballot)


# --- (a) RttEstimator --------------------------------------------------------


class TestRttEstimator:
    def test_default_until_first_sample(self):
        est = RttEstimator()
        assert est.timeout(2.5) == 2.5
        est.observe(0.1)
        assert est.timeout(2.5) == pytest.approx(0.1 + 4 * 0.05)

    def test_converges_and_bounds_jitter(self):
        est, ref = RttEstimator(), jgeo.RttEstimator()
        for rtt in [0.1, 0.12, 0.09, 0.11, 0.1, 0.13, 0.1] * 10:
            est.observe(rtt)
            ref.observe(rtt)
            assert est.timeout(99.0) == ref.timeout(99.0)
        assert 0.1 < est.timeout(99.0) < 0.35

    def test_clamps(self):
        est = RttEstimator(floor_s=0.05, ceil_s=1.0)
        est.observe(0.0)
        assert est.timeout(9.0) == 0.05
        est2 = RttEstimator(floor_s=0.05, ceil_s=1.0)
        est2.observe(100.0)
        assert est2.timeout(9.0) == 1.0
        with pytest.raises(ValueError):
            RttEstimator(alpha=0.0)


# --- (b) cross-package transport equivalence ---------------------------------


def _echo_class(base):
    class EchoActor(base):
        """Deterministic fanout: a frame ``(ttl, k)`` re-sends ``(ttl-1,
        k)`` to the next ``fanout`` peers; records every receive."""

        def __init__(self, address, transport, logger, peers, fanout=2):
            base.__init__(self, address, transport, logger)
            self.peers = peers
            self.fanout = fanout
            self.log: list = []
            self.drains = 0

        def receive(self, src, message):
            ttl, k = message
            self.log.append((str(src), ttl, k))
            if ttl > 0:
                at = (k + ttl) % len(self.peers)
                for step in range(self.fanout):
                    dst = self.peers[(at + step) % len(self.peers)]
                    if dst != self.address:
                        self.send(dst, (ttl - 1, k))

        def on_drain(self):
            self.drains += 1

    return EchoActor


#: The same actor over the port's runtime and over the reference's.
EchoActor = _echo_class(Actor)
JEchoActor = _echo_class(JActor)


def geo_topology(seed=7, jitter=0.05, module=None) -> GeoTopology:
    cls = GeoTopology if module is None else module.GeoTopology
    return cls({f"r{r}": [f"z{r}-{z}" for z in range(3)] for r in range(3)},
               seed=seed, jitter=jitter)


def build_geo(port: bool, seed=7, jitter=0.05):
    if port:
        topo = geo_topology(seed, jitter)
        t = GeoSimTransport(topo, FakeLogger(LogLevel.FATAL))
        actor_cls = EchoActor
    else:
        topo = geo_topology(seed, jitter, jgeo)
        t = jgeo.GeoSimTransport(topo, JFakeLogger(JLogLevel.FATAL))
        actor_cls = JEchoActor
    peers = [f"actor-{i}" for i in range(9)]
    actors = [actor_cls(p, t, t.logger, peers) for p in peers]
    for i, actor in enumerate(actors):
        topo.place(actor.address, topo.zones[i % len(topo.zones)])
    return topo, t, actors


def projection(transport) -> list:
    rows = []
    for command in transport.history:
        if isinstance(command, (DeliverMessage, JDeliverMessage)):
            m = command.message
            rows.append(("deliver", m.id, str(m.src), str(m.dst)))
        elif isinstance(command, (TriggerTimer, JTriggerTimer)):
            rows.append(("timer", command.timer_id, str(command.address),
                         command.name))
    return rows


def mesh_state(actors) -> list:
    return [(a.log, a.drains) for a in actors]


MASKS = {"numpy": tsw.link_keep_mask,
         "k18-plain": functools.partial(tsw.link_keep_mask_cuda,
                                        device="cpu")}


@pytest.fixture(params=sorted(MASKS))
def port_mask(request, monkeypatch):
    monkeypatch.setattr(tsw, "LINK_KEEP_MASK", MASKS[request.param])
    return request.param


def _both(scenario):
    return [scenario(port) for port in (False, True)]


@pytest.mark.parametrize("jitter", [0.05, 0.0])
def test_run_until_matches_the_reference(port_mask, jitter):
    """Jittered (or jitter-free) arrivals, link partitions, per-address
    partitions and timers: run_until replays the reference's schedule."""
    def scenario(port):
        topo, t, actors = build_geo(port, jitter=jitter)
        fired: list = []
        timer = t.timer("actor-0", "tick", 0.011,
                        lambda: fired.append(round(t.now, 9)))
        timer.start()
        rng = random.Random("geo-equiv")
        for round_ in range(10):
            for k in range(50):
                t.send("driver", f"actor-{rng.randrange(9)}",
                       actors[0].serializer.to_bytes((2, k)))
            if round_ == 2:
                topo.partition_link("z0-0", "z1-1")
            if round_ == 4:
                t.partition("actor-4")
            if round_ == 6:
                topo.heal_link("z0-0", "z1-1")
                t.heal("actor-4")
            if round_ == 7:
                topo.partition_zone("z2-2")
            t.run_for(0.03)
        t.run_until_quiescent()
        return (projection(t), mesh_state(actors), fired,
                round(t.now, 9), len(t.messages))

    ref, ours = _both(scenario)
    assert ours == ref


def test_jitter_free_waves_reach_the_mask(monkeypatch):
    """On the jitter-free topology the run_until scenario forms waves at
    or above WAVE_VECTOR_MIN, so the transport evaluates its link mask
    (here K18's plain version), and the outcome is the reference's."""
    calls = []

    def counting(src, dst, up):
        calls.append(len(src))
        return tsw.link_keep_mask_cuda(src, dst, up, device="cpu")

    monkeypatch.setattr(tsw, "LINK_KEEP_MASK", counting)
    topo, t, actors = build_geo(True, jitter=0.0)
    for k in range(120):
        t.send("driver", f"actor-{k % 9}",
               actors[0].serializer.to_bytes((1, k)))
    topo.partition_link("z0-0", "z1-1")
    t.run_for(1.0)
    assert calls and min(calls) >= tsw.WAVE_VECTOR_MIN


def test_quiescent_matches_the_reference(port_mask):
    def scenario(port):
        topo, t, actors = build_geo(port)
        for k in range(120):
            t.send("driver", f"actor-{k % 9}",
                   actors[0].serializer.to_bytes((1, k)))
        steps = t.run_until_quiescent()
        return steps, projection(t), mesh_state(actors)

    ref, ours = _both(scenario)
    assert ours == ref


@pytest.mark.parametrize("max_steps", [1, 2, 5, 50])
def test_run_until_max_steps_matches_the_reference(max_steps):
    """The cap may be overshot by a same-timestamp wave, as in the
    reference: truncating it would fire timers due at t first."""
    def scenario(port):
        topo, t, actors = build_geo(port, seed=3)
        fired: list = []
        timer = t.timer("actor-0", "tick", 0.0005,
                        lambda: fired.append(round(t.now, 9)))
        timer.start()
        topo.jitter = 0.0
        for k in range(12):
            t.send("actor-1", "actor-2",
                   actors[0].serializer.to_bytes((0, k)))
        steps = t.run_for(1.0, max_steps=max_steps)
        return steps, projection(t), fired, len(t.messages)

    ref, ours = _both(scenario)
    assert ours == ref


@pytest.mark.parametrize("coalesce", [True, False])
def test_fifo_drain_consumes_arrival_stamps(port_mask, coalesce):
    """A FIFO drain on the geo transport kills the drained frames'
    stamps: a later run_until never delivers a frame twice."""
    def scenario(port):
        topo, t, actors = build_geo(port)
        topo.partition_link("z0-0", "z2-1")
        for k in range(80):
            t.send("driver", f"actor-{k % 9}",
                   actors[0].serializer.to_bytes((1, k)))
        if coalesce:
            t.deliver_all_coalesced()
        else:
            t.deliver_all()
        t.run_for(10.0)
        t.run_until_quiescent()
        return (projection(t), mesh_state(actors), len(t.arrivals),
                len(t.messages))

    ref, ours = _both(scenario)
    assert ours == ref
    assert ours[2] == 0 and ours[3] == 0


@pytest.mark.parametrize("seed", range(6))
def test_random_mask_schedules_match_the_reference(port_mask, seed):
    def scenario(port):
        topo, t, actors = build_geo(port, seed=seed,
                                    jitter=0.0 if seed % 2 else 0.05)
        zones = topo.zones
        rng = random.Random(f"geo-mask-prop|{seed}")
        for _ in range(12):
            for _ in range(rng.randrange(1, 80)):
                t.send("driver", f"actor-{rng.randrange(9)}",
                       actors[0].serializer.to_bytes(
                           (rng.randrange(2), rng.randrange(100))))
            roll = rng.random()
            if roll < 0.25:
                topo.partition_link(rng.choice(zones), rng.choice(zones))
            elif roll < 0.4:
                topo.heal_all()
            elif roll < 0.5:
                t.partition(f"actor-{rng.randrange(9)}")
            elif roll < 0.6:
                for a in list(t.partitioned):
                    t.heal(a)
            elif roll < 0.7:
                topo.degrade_link(rng.choice(zones), rng.choice(zones),
                                  rng.choice((1.0, 4.0)))
            if rng.random() < 0.2:
                t.deliver_all_coalesced()
            t.run_for(rng.choice((0.002, 0.02, 0.2)))
        t.run_until_quiescent()
        return (projection(t), mesh_state(actors), round(t.now, 9),
                len(t.messages))

    ref, ours = _both(scenario)
    assert ours == ref


def test_delivery_schedule_and_crash_match_the_reference():
    def scenario(port):
        topo, t, actors = build_geo(port, seed=5)
        for k in range(60):
            t.send("driver", f"actor-{k % 9}",
                   actors[0].serializer.to_bytes((1, k)))
        t.run_for(0.01)
        timer = t.timer("actor-3", "tick", 0.5, lambda: None)
        timer.start()
        t.crash("actor-3")
        schedule = [row[:4] for row in
                    (delivery_schedule(t) if port
                     else jgeo.transport.delivery_schedule(t))]
        return schedule, len(t._deadlines), t.next_event_time()

    ref, ours = _both(scenario)
    assert ours == ref


# --- (d) the wave engine in the port -----------------------------------------


def test_instance_wrapped_deliver_message_sees_every_delivery():
    t = SimTransport(FakeLogger(LogLevel.FATAL))
    peers = [f"actor-{i}" for i in range(3)]
    actors = [EchoActor(p, t, t.logger, peers) for p in peers]
    seen = []
    original = t.deliver_message

    def recording(message):
        seen.append(message.id)
        original(message)

    t.deliver_message = recording
    assert not t._wave_fast_path_ok()
    for k in range(10):
        t.send("driver", f"actor-{k % 3}",
               actors[0].serializer.to_bytes((0, k)))
    t.deliver_all()
    assert len(seen) == 10


@pytest.mark.parametrize("coalesce", [True, False])
def test_class_patched_deliver_falls_back_with_the_same_outcome(coalesce):
    class Patched(SimTransport):
        def _deliver(self, message):
            return super()._deliver(message)

    assert SimTransport(FakeLogger(LogLevel.FATAL))._wave_fast_path_ok()
    assert GeoSimTransport(geo_topology(),
                           FakeLogger(LogLevel.FATAL))._wave_fast_path_ok()
    results = []
    for cls in (SimTransport, Patched):
        t = cls(FakeLogger(LogLevel.FATAL))
        assert t._wave_fast_path_ok() == (cls is SimTransport)
        peers = [f"actor-{i}" for i in range(5)]
        actors = [EchoActor(p, t, t.logger, peers) for p in peers]
        for k in range(40):
            t.send("driver", f"actor-{k % 5}",
                   actors[0].serializer.to_bytes((2, k)))
        t.partition("actor-2")
        steps = (t.deliver_all_coalesced(max_steps=7) if coalesce
                 else t.deliver_all(max_steps=7))
        steps += (t.deliver_all_coalesced() if coalesce
                  else t.deliver_all())
        results.append((steps, projection(t), mesh_state(actors)))
    assert results[0] == results[1]


def test_tombstones_compact_before_the_adversarial_api():
    topo, t, actors = build_geo(True, seed=2)
    for k in range(3000):
        t.send("actor-0", f"actor-{k % 9}",
               actors[0].serializer.to_bytes((0, k)))
    t.run_for(0.0006)  # delivers the zone-local frames only
    assert not t._consumed
    remaining = [m.id for m in t.messages]
    assert len(remaining) < 3000
    assert all(m.id in t.arrivals for m in t.messages)
    command = t.generate_command(random.Random(0))
    assert command.message.id in remaining


# --- (e) convert -------------------------------------------------------------


def test_convert_carries_an_epoch_store_and_a_tracker():
    jstore = jepochs.ObjectEpochStore(2, [0, 1])
    jstore.offer(jepochs.GeoEpoch(group=0, epoch=1, start_slot=8,
                                  home_zone=2, ballot=5))
    jtracker = jgeo.GeoQuorumTracker(jstore, 0, JZoneGrid(GRID),
                                     backend="tpu", window=64)
    rng = random.Random(4)
    votes = [(slot, 0 if slot < 8 else 5, a)
             for slot in range(16) for a in rng.sample(range(9), 2)]
    for vote in votes[:20]:
        jtracker.record(*vote)
    jtracker.drain()
    for vote in votes[20:26]:  # buffered, not yet drained
        jtracker.record(*vote)
    store = convert.epoch_store_from_chains(
        [jstore.known(g) for g in range(2)], jstore.version)
    assert [dataclass_tuple(e) for g in range(2) for e in store.known(g)] \
        == [dataclass_tuple(e) for g in range(2) for e in jstore.known(g)]
    assert store.version == jstore.version
    tracker = convert.geo_tracker_from_numpy(
        store, 0, ZoneGrid(GRID), jax.device_get(jtracker._checker.board),
        window=64, pending=(jtracker._slots, jtracker._cols,
                            jtracker._ballots), device="cpu")
    for vote in votes[26:]:
        jtracker.record(*vote)
        tracker.record(*vote)
    assert sorted(tracker.drain()) == sorted(jtracker.drain())
    board = convert.vote_board_to_numpy(tracker._checker.board)
    jboard = jax.device_get(jtracker._checker.board)
    for name in board._fields:
        assert np.array_equal(getattr(board, name),
                              np.asarray(getattr(jboard, name))), name
    with pytest.raises(ValueError):
        convert.epoch_store_from_chains([jstore.known(1)])
