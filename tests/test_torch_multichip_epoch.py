"""The port's ``EpochSegmentedChecker`` and ``GeoQuorumTracker`` with a
sharded board, against the JAX package's, on the CPU.

Every case of ``tests/test_multichip_epoch.py`` again, over the port's
unsharded checker (``None``), a 1x1 and a 2x4 mesh of spawned gloo ranks
(``bench/multichip_board.py``'s ``checker_ops`` and ``geo_ops``): the
same random vote streams must give, call for call, the JAX checkers'
answers (unsharded and on the conftest's forced 8-device mesh) and the
two-config ``quorums/systems.py`` oracle's -- across a reconfiguration
landing mid-window that grows or shrinks the universe (the epoch planes
whole on every rank, the board's columns split) -- and the geo trackers'
drains must equal the dict oracle's. One world of 8 ranks serves the
module.
"""

from __future__ import annotations

import random

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import multichip, multichip_board as mb
from frankenpaxos_tpu_torch.geo import GeoQuorumTracker as TGeo
from frankenpaxos_tpu_torch.mesh import Mesh as TorchMesh
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.quorums import ZoneGrid as TZoneGrid
import jax
from jax.sharding import Mesh
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.geo.epochs import GeoEpoch, ObjectEpochStore
from frankenpaxos_tpu.geo.quorum import GeoQuorumTracker
from frankenpaxos_tpu.ops.quorum import EpochSegmentedChecker
from frankenpaxos_tpu.quorums import SimpleMajority, ZoneGrid
from tests.test_reconfig import _random_system, TwoConfigOracle

WINDOW = 128  # divides every mesh size here
MESH_SHAPES = [None, (1, 1), (2, 4)]
GRID = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(8, device_type="cpu") as w:
        yield w


@pytest.fixture(autouse=True)
def _devices(need_8_devices):
    """The JAX side needs the shared 8-device mesh (conftest.py)."""


def _jax_mesh(group, slot):
    devices = np.asarray(jax.devices()[:group * slot])
    return Mesh(devices.reshape(group, slot), ("group", "slot"))


def _port_runs(world, specs, boundaries, ops, window=WINDOW) -> list:
    """``ops`` (JAX specs in ``add_epoch`` carried across) on the port's
    checker on every shape of MESH_SHAPES: each shape's ``(results,
    universe)``."""
    specs = [convert.quorum_spec_from(s) for s in specs]
    ops = [(name, convert.quorum_spec_from(args[0]), *args[1:])
           if name == "add_epoch" else (name, *args) for name, *args in ops]
    runs = []
    for shape in MESH_SHAPES:
        if shape is None:
            checker = tq.EpochSegmentedChecker(specs, boundaries,
                                               window=window, device="cpu")
            runs.append((mb._run_ops(checker, ops), checker.universe))
        else:
            runs.append(mb.same_on_every_rank(world.call(
                "checker_ops", group=shape[0], slot=shape[1], kind="epoch",
                specs=specs, boundaries=list(boundaries), window=window,
                ops=ops)))
    return runs


@pytest.mark.parametrize("seed", range(6))
def test_sharded_check_batch_matches_two_config_oracle(world, seed):
    """Random two-config universes (grids and majorities over random,
    permuted member orderings): batch chosen-ness on every mesh shape
    matches the JAX checkers and the host oracle exactly."""
    rng = random.Random(seed)
    pool = list(range(40))
    old = _random_system(rng, pool)
    new = _random_system(rng, pool)
    boundary = rng.randrange(1, 64)
    oracle = TwoConfigOracle(old, new, boundary)

    seen: dict = {}
    union = list(old.nodes()) + list(new.nodes())
    rng.shuffle(union)
    for node in union:
        seen.setdefault(node, len(seen))
    universe = tuple(seen)
    specs = [old.write_spec().reindexed(universe),
             new.write_spec().reindexed(universe)]

    slots = np.asarray([rng.randrange(0, WINDOW) for _ in range(50)])
    present = np.zeros((50, len(universe)), dtype=np.uint8)
    voters = []
    for i in range(50):
        vs = rng.sample(universe, rng.randrange(0, len(universe) + 1))
        voters.append(vs)
        for v in vs:
            present[i, seen[v]] = 1
    want = [oracle.chosen(int(s), vs) for s, vs in zip(slots, voters)]
    for shape in MESH_SHAPES:
        ref = EpochSegmentedChecker(
            specs, [0, boundary], window=WINDOW,
            mesh=None if shape is None else _jax_mesh(*shape))
        assert ref.check_batch(present, slots).tolist() == want
    for results, got_universe in _port_runs(
            world, specs, [0, boundary], [("check_batch", present, slots)]):
        assert got_universe == universe
        assert results[0].tolist() == want


@pytest.mark.parametrize("seed", range(2))
def test_sharded_run_equals_the_chunk_loop(world, seed):
    """``record_and_check_run`` with a mesh (one sharded run: one launch
    and one all-reduce a drain) equals, on every mesh shape, the JAX
    checker's ``record_and_check`` over the same chunks in turn: a
    boundary inside the votes, the ring's wrap, duplicates inside a
    chunk and across chunks, newer rounds, a ragged last chunk."""
    rng = np.random.default_rng(seed)
    specs = [SimpleMajority([0, 1, 2]).write_spec(),
             SimpleMajority([0, 1, 3]).write_spec()]
    boundary, chunk, b = 150, 16, 200
    slots = rng.integers(100, 200, size=b)
    slots[::7] += WINDOW  # a newer slot reclaims its column
    nodes = rng.integers(0, 4, size=b).astype(np.int32)
    rounds = rng.integers(0, 3, size=b).astype(np.int32)
    ref = EpochSegmentedChecker(specs, [0, boundary], window=WINDOW)
    want = np.concatenate([
        ref.record_and_check(slots[at:at + chunk], nodes[at:at + chunk],
                             rounds[at:at + chunk])
        for at in range(0, b, chunk)])
    assert want.any() and not want.all()
    ops = [("record_and_check_run", slots, nodes, rounds, chunk)]
    for results, _ in _port_runs(world, specs, [0, boundary], ops):
        assert results[0].tolist() == want.tolist()


def _mid_window_stream(rng, boundary, old_universe, new_universe) -> tuple:
    """The reference test's two feeds: 100 ``(slot, voter)`` votes below
    the boundary from the old universe, then 100 up to ``boundary + 30``
    from the union."""
    first = [(rng.randrange(0, boundary), rng.choice(old_universe))
             for _ in range(100)]
    second = [(rng.randrange(0, min(boundary + 30, WINDOW)),
               rng.choice(new_universe)) for _ in range(100)]
    return first, second


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("direction", ["grow", "shrink"])
def test_sharded_reconfig_mid_window_matches_oracle(world, seed, direction):
    """A reconfiguration lands mid-window through ``add_epoch`` (K7 on
    each rank's columns) while votes are in flight: every mesh shape
    reports the same newly-chosen stream as the JAX checkers, and every
    report agrees with the oracle on the voters accumulated then."""
    rng = random.Random(300 + seed)
    if direction == "grow":
        old = SimpleMajority(range(5))
        new = SimpleMajority(range(2, 10))
    else:
        old = SimpleMajority(range(7))
        new = SimpleMajority(range(2, 5))
    boundary = rng.randrange(6, 24)
    oracle = TwoConfigOracle(old, new, boundary)
    old_universe = tuple(sorted(old.nodes()))
    specs = [old.write_spec().reindexed(old_universe)]
    refs = [EpochSegmentedChecker(
        specs, [0], window=WINDOW,
        mesh=None if shape is None else _jax_mesh(*shape))
        for shape in MESH_SHAPES]
    first, second = _mid_window_stream(
        rng, boundary, list(refs[0].universe),
        list(dict.fromkeys(old_universe + tuple(sorted(new.nodes())))))

    ops, want = [], []
    for votes in (first, None, second):
        if votes is None:
            for ref in refs:
                ref.add_epoch(new.write_spec(), boundary)
            ops.append(("add_epoch", new.write_spec(), boundary))
            continue
        for slot, voter in votes:
            col = refs[0].column_of(voter)
            newlies = {bool(ref.record_and_check([slot], [col], [0])[0])
                       for ref in refs}
            assert len(newlies) == 1
            want.append(newlies.pop())
            ops.append(("record_and_check", [slot], [col], [0]))
    assert refs[0].universe == refs[2].universe

    voters_by_slot: dict = {}
    chosen_at: dict = {}
    for (slot, voter), newly in zip(first + second, want):
        voters_by_slot.setdefault(slot, set()).add(voter)
        if newly:
            chosen_at.setdefault(slot, set(voters_by_slot[slot]))
    assert chosen_at, "stream never completed a quorum"
    for slot, voters in voters_by_slot.items():
        if slot in chosen_at:
            assert oracle.chosen(slot, chosen_at[slot])
        else:
            assert not oracle.chosen(slot, voters)

    for results, universe in _port_runs(world, specs, [0], ops):
        assert universe == refs[0].universe
        got = [bool(r[0]) for r in results if r is not None]
        assert got == want


def test_window_must_divide_mesh_size():
    spec = convert.quorum_spec_from(SimpleMajority(range(3)).write_spec())
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tq.EpochSegmentedChecker([spec], [0], window=100,
                                 mesh=TorchMesh(2, 4, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        EpochSegmentedChecker([SimpleMajority(range(3)).write_spec()], [0],
                              window=100, mesh=_jax_mesh(2, 4))


def _geo_ops_run(world, shape, jstore, ops) -> list:
    """``ops`` on the port's dict and unsharded cuda trackers over a copy
    of ``jstore``, and on the sharded one over ``shape``: each one's
    drains, sorted."""
    grid = TZoneGrid(GRID)
    runs = []
    for kind in ("dict", "cuda"):
        store = convert.epoch_store_from_chains(
            [jstore.known(g) for g in range(len(jstore._chains))])
        tracker = TGeo(store, 0, grid, backend=kind, window=WINDOW,
                       device="cpu")
        runs.append(mb.run_geo(tracker, store, ops))
    store = convert.epoch_store_from_chains(
        [jstore.known(g) for g in range(len(jstore._chains))])
    drains = mb.same_on_every_rank(world.call(
        "geo_ops", group=shape[0], slot=shape[1], store=store, geo_group=0,
        grid=grid, window=WINDOW, ops=ops))
    runs.append(drains)
    return runs


def test_geo_tracker_sharded_matches_dict_oracle(world):
    """``GeoQuorumTracker(backend="cuda", mesh=)`` over 2x4: the ZoneGrid
    steal planes whole on every rank, the board split; every drain
    equals the port's dict oracle's and unsharded tracker's, and the JAX
    trackers' (dict, tpu, tpu on the 2x4 mesh)."""
    jstore = ObjectEpochStore(2, [0, 1])
    assert jstore.offer(GeoEpoch(group=0, epoch=1, start_slot=8,
                                 home_zone=2, ballot=5)) == "new"
    jgrid = ZoneGrid(GRID)
    chains = [jstore.known(g) for g in range(2)]
    jtrackers = [
        GeoQuorumTracker(jstore, 0, jgrid, backend="dict"),
        GeoQuorumTracker(jstore, 0, jgrid, backend="tpu", window=WINDOW),
        GeoQuorumTracker(jstore, 0, jgrid, backend="tpu", window=WINDOW,
                         mesh=_jax_mesh(2, 4)),
    ]
    rng = random.Random(11)
    votes = []
    for slot in range(16):
        ballot = 0 if slot < 8 else 5
        for acceptor in rng.sample(range(9), rng.randint(1, 9)):
            votes.append((slot, ballot, acceptor))
    rng.shuffle(votes)
    ops, jouts = [], [[], [], []]
    for i, (slot, ballot, acceptor) in enumerate(votes):
        ops.append(("record", slot, ballot, acceptor))
        if i % 5 == 4:
            ops.append(("drain",))
        for t, out in zip(jtrackers, jouts):
            t.record(slot, ballot, acceptor)
            if i % 5 == 4:
                out.append(sorted(t.drain()))
    ops.append(("drain",))
    for t, out in zip(jtrackers, jouts):
        out.append(sorted(t.drain()))
    assert jouts[0] == jouts[1] == jouts[2]
    assert any(jouts[0]), "no quorums completed"
    assert [c[-1] for c in chains] == [jstore.known(g)[-1] for g in range(2)]
    for drains in _geo_ops_run(world, (2, 4), jstore, ops):
        assert drains == jouts[0]


def test_geo_tracker_sharded_steal_mid_stream(world):
    """A steal handover lands between drains: the sharded tracker's
    appended plane (whole on every rank, ``note_epochs`` on each) keeps
    parity with the oracle (1x8)."""
    jstore = ObjectEpochStore(1, [0])
    grid = ZoneGrid(GRID)
    jtrackers = [
        GeoQuorumTracker(jstore, 0, grid, backend="dict"),
        GeoQuorumTracker(jstore, 0, grid, backend="tpu", window=WINDOW,
                         mesh=_jax_mesh(1, 8)),
    ]
    store0 = ObjectEpochStore(1, [0])
    steal = dict(group=0, epoch=1, start_slot=1, home_zone=1, ballot=4)
    for t in jtrackers:
        t.record(0, 0, 0)
        t.record(0, 0, 1)
    jstore.offer(GeoEpoch(**steal))
    for t in jtrackers:
        t.note_epochs()
        t.record(1, 4, 3)
        t.record(1, 4, 4)
    want = [sorted(t.drain()) for t in jtrackers]
    assert want[0] == want[1] == [(0, 0), (1, 4)]
    ops = [("record", 0, 0, 0), ("record", 0, 0, 1), ("offer", steal),
           ("note_epochs",), ("record", 1, 4, 3), ("record", 1, 4, 4),
           ("drain",)]
    for drains in _geo_ops_run(world, (1, 8), store0, ops):
        assert drains == [want[0]]
