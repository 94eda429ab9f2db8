"""The port's sharded vote board against the JAX package's, on the CPU.

Every case of ``tests/test_multichip_checker.py`` again: the
ProxyLeader's ``TpuQuorumTracker`` with its board split over a
``(group, slot)`` mesh of spawned gloo ranks (``bench/multichip.py``'s
world, ``bench/multichip_board.py``'s cases) must report, drain for
drain, what the JAX tracker sharded over the conftest's forced 8-device
mesh, the unsharded trackers and the dict oracle report. Then the board
functions themselves (K2, K4, K5 through ``record_block_sharded``,
``record_and_check_sharded``, ``release_sharded``) against JAX's jitted
``_record_block`` / ``_record_and_check`` / ``_release`` on a sharded
board, leaf for leaf, with blocks across shard edges, duplicate slots and
lanes outside the window; a resume from a JAX sharded checker through
``convert``; and the column map pinned against JAX's shard placement.
One world of 8 ranks serves the module.
"""

import random

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import multichip, multichip_board as mb
from frankenpaxos_tpu_torch.mesh import Mesh as TorchMesh
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols.multipaxos import quorum_tracker as qt
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import quorum as jq
from frankenpaxos_tpu.protocols.multipaxos.quorum_tracker import (
    DictQuorumTracker as JDict,
    TpuQuorumTracker as JTracker,
)
from frankenpaxos_tpu.quorums import Grid, SimpleMajority
from tests.test_multichip_checker import record_real_vote_stream, replay

BOARD_FIELDS = ("votes", "rounds", "chosen", "owner")


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(8, device_type="cpu") as w:
        yield w


@pytest.fixture(autouse=True)
def _devices(need_8_devices):
    """The JAX side needs the shared 8-device mesh (conftest.py)."""


@pytest.fixture(scope="module")
def real_stream():
    """The real vote stream, recorded once from the JAX harness."""
    return record_real_vote_stream()


def _jax_mesh(group, slot):
    devices = np.asarray(jax.devices()[:group * slot])
    return Mesh(devices.reshape(group, slot), ("group", "slot"))


def _events(drains, row=3) -> list:
    """The recorded ``(slot, round, group, acceptor)`` drains as
    ``replay_by_drain`` events."""
    return [[("vote", s, r, g * row + a) for s, r, g, a in drain]
            for drain in drains]


def _port_config():
    return make_multipaxos(f=1).config


def _sharded(world, shape, config, window, pipelined, drains, **kw):
    return mb.same_on_every_rank(world.call(
        "tracker_replay", group=shape[0], slot=shape[1], config=config,
        window=window, pipelined=pipelined, drains=drains, **kw))


def _assert_board(port, ref) -> None:
    for name in BOARD_FIELDS:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("pipelined", [False, True])
def test_sharded_checker_matches_unsharded_on_real_stream(world, real_stream,
                                                          pipelined):
    """2x4 mesh: the vote board's slot window split 8 ways; per-drain
    reports equal the JAX tracker's (sharded and not), the port's
    unsharded tracker's and the dict oracle's."""
    jconfig, drains = real_stream
    oracle = replay(JDict(jconfig), drains)
    assert sum(len(d) for d in oracle) > 0
    assert replay(JTracker(jconfig, window=1 << 10), drains) == oracle
    assert replay(JTracker(jconfig, window=1 << 10,
                           mesh=_jax_mesh(2, 4)), drains) == oracle
    config, events = _port_config(), _events(drains)
    unsharded = mb.replay_by_drain(qt.TpuQuorumTracker(
        config, window=1 << 10, pipelined=pipelined, device="cpu"),
        events, 3)
    assert unsharded == oracle
    got = _sharded(world, (2, 4), config, 1 << 10, pipelined, events)
    assert got == oracle


def test_port_harness_stream_through_the_sharded_tracker(world, real_stream):
    """The same deployment run on the port's own MultiPaxos harness
    records the same vote stream; replayed through the sharded tracker
    it reports what the dict oracle does, drain for drain."""
    recorded, pending = [], []

    class Recording(qt.DictQuorumTracker):
        def record(self, slot, round, group_index, acceptor_index):
            pending.append((slot, round, group_index, acceptor_index))
            super().record(slot, round, group_index, acceptor_index)

        def drain(self):
            if pending:
                recorded.append(list(pending))
                pending.clear()
            return super().drain()

    sim = make_multipaxos(f=1)
    for proxy in sim.proxy_leaders:
        proxy.tracker = Recording(sim.config)
    got = []
    for batch in range(12):
        for p in range(16):
            sim.clients[0].write(p, b"b%d.%d" % (batch, p), got.append)
        sim.transport.deliver_all_coalesced()
    assert len(got) == 12 * 16
    assert recorded == real_stream[1]
    events = _events(recorded)
    oracle = mb.replay_by_drain(qt.DictQuorumTracker(sim.config), events, 3)
    for shape in ((1, 8), (2, 4)):
        assert _sharded(world, shape, sim.config, 1 << 10, True,
                        events) == oracle


def test_sharded_checker_ring_wrap_on_mesh(world, real_stream):
    """Ring wrap under sharding: slots pass several multiples of the
    window, so column reclaim happens on every shard (1x8)."""
    jconfig = real_stream[0]
    window = 256
    oracle = JDict(jconfig)
    jsharded = JTracker(jconfig, window=window, mesh=_jax_mesh(1, 8))
    rng = random.Random(7)
    drains, want = [], []
    for base in range(0, 4 * window, 64):
        votes = []
        for slot in range(base, base + 64):
            for acc in rng.sample(range(3), 2):
                votes.append((slot, acc))
        rng.shuffle(votes)
        for slot, acc in votes:
            oracle.record(slot, 0, 0, acc)
            jsharded.record(slot, 0, 0, acc)
        want.append(sorted(oracle.drain()))
        assert sorted(jsharded.drain()) == want[-1], base
        drains.append([("vote", slot, 0, acc) for slot, acc in votes])
    config = _port_config()
    for pipelined in (False, True):
        assert _sharded(world, (1, 8), config, window, pipelined,
                        drains) == want


def _random_ops(rng: np.random.Generator, n: int, window: int,
                count: int) -> list:
    """Board calls whose dense blocks start anywhere (crossing the
    32-column shard edges of a 256-column window on 8 ranks) and whose
    sparse batches carry duplicate slots, negative slots and slots
    outside ``[-window, window)``, as ``board_ops`` takes them."""
    ops, frontier = [], 0
    for _ in range(count):
        kind = rng.choice(["block", "block", "sparse", "sparse", "release"])
        if kind == "block":
            # A few widths, so the reference compiles few programs.
            b = int(rng.choice([9, 40, 64, 99]))
            start = int(rng.integers(0, window - b + 1))
            block = (rng.random((n, b)) < 0.55).astype(np.uint8)
            true_start = frontier - frontier % window + start \
                + window * int(rng.integers(-1, 2))
            ops.append(("record_block", start, true_start, block,
                        int(rng.integers(0, 3))))
            frontier = max(frontier, true_start + b)
        elif kind == "sparse":
            b = int(rng.integers(1, 80))
            true = frontier + rng.integers(-2 * window, 40, size=b)
            slots = true % window
            odd = rng.random(b)
            slots = np.where(odd < 0.1, slots - window, slots)
            slots = np.where((odd >= 0.1) & (odd < 0.17),
                             rng.integers(window, 3 * window, size=b), slots)
            slots = np.where((odd >= 0.17) & (odd < 0.24),
                             -rng.integers(window + 1, 3 * window, size=b),
                             slots)
            if b >= 4:
                dup = rng.integers(0, b, size=b // 4)
                slots[dup] = slots[dup[0]]
            lanes = tq.pack_lanes(
                slots, true, rng.integers(-1, n + 1, size=b),
                rng.integers(0, 3, size=b), rng.random(b) < 0.9,
                size=64 if b <= 64 else 128)
            ops.append(("record_and_check", lanes))
            frontier = max(frontier, int(true.max()) + 1)
        else:
            b = 24
            slots = rng.integers(-2 * window, 2 * window, size=b).astype(
                np.int32)
            ops.append(("release", slots, np.ones(b, dtype=bool)))
    return ops


def _jax_board_ops(spec, window, ops, board):
    """Each call's result and the board after it, on the reference."""
    masks_t, meta = jq._spec_statics(spec)
    results = []
    for name, *args in ops:
        if name == "record_block":
            start, true_start, block, rnd = args
            b = block.shape[1]
            board, newly = jq._record_block(
                board, jnp.int32(start), jnp.int32(true_start),
                jnp.asarray(block), jnp.int32(rnd), b, masks_t, meta)
        elif name == "record_and_check":
            lanes = args[0]
            board, newly = jq._record_and_check(
                board, *(jnp.asarray(lanes[k]) for k in range(4)),
                jnp.asarray(lanes[4] != 0), masks_t, meta)
        else:
            slots, valid = args
            board = jq._release(board, jnp.asarray(slots),
                                jnp.asarray(valid))
            newly = None
        results.append((None if newly is None else np.asarray(newly),
                        jax.device_get(board)))
    return results


def _init_board(rng, n, window):
    """A mid-flight whole board, with owners at int32's least value (a
    true slot wrapped through 2^31) that a stray owner max would
    reclaim."""
    owner = rng.integers(-1, 3 * window, size=window).astype(np.int32)
    owner[rng.random(window) < 0.1] = np.iinfo(np.int32).min
    owner[::16] = np.iinfo(np.int32).min  # every shard's first column
    return jq.VoteBoard(
        votes=(rng.random((n, window)) < 0.3).astype(np.uint8),
        rounds=rng.integers(-1, 3, size=window).astype(np.int32),
        chosen=rng.random(window) < 0.2, owner=owner)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (1, 3)])
@pytest.mark.parametrize("seed", range(3))
def test_board_functions_match_the_sharded_reference(world, shape, seed):
    """K2, K4 and K5 through the sharded board functions against JAX's
    jitted board functions on its sharded board, call for call and leaf
    for leaf after every call, from a fresh board and from a carried-in
    mid-flight one."""
    rng = np.random.default_rng(100 + seed)
    window = 256 if shape != (1, 3) else 192
    spec = (SimpleMajority(range(3)).write_spec() if seed != 1 else
            Grid([[0, 1, 2], [3, 4, 5]]).write_spec())
    n = spec.num_nodes
    ops = _random_ops(rng, n, window, 30)
    for init in (None, _init_board(rng, n, window)):
        start = jq.make_vote_board(window, n) if init is None \
            else jq.VoteBoard(*(jnp.asarray(x) for x in init))
        board = jq._shard_board(start, _jax_mesh(*shape), window)
        want = _jax_board_ops(spec, window, ops, board)
        got = mb.same_on_every_rank(world.call(
            "board_ops", group=shape[0], slot=shape[1],
            spec=tuple(np.asarray(a) for a in spec.as_arrays()),
            window=window, ops=ops, init=init))
        assert len(got) == len(want)
        for k, ((g, g_board), (w, w_board)) in enumerate(zip(got, want)):
            if w is None:
                assert g is None
            else:
                assert g.dtype == np.bool_ and g.shape == w.shape, k
                np.testing.assert_array_equal(g, w, err_msg=str(ops[k][0]))
            _assert_board(g_board, w_board)


def test_resumes_from_a_jax_sharded_checker(world):
    """A JAX ``TpuQuorumChecker`` sharded over 2x4, carried into the
    port mid-stream (its board through ``convert``, each rank taking its
    columns), continues call for call as the JAX checker does."""
    rng = np.random.default_rng(9)
    window, n = 512, 3
    jspec = SimpleMajority(range(3)).write_spec()
    spec = convert.quorum_spec_from(jspec)
    calls = []
    for k in range(24):
        if k % 3 == 0:
            b = int(rng.integers(1, 200))
            start = int(rng.integers(0, 3 * window))
            start -= max(0, start % window + b - window)
            calls.append(("record_block", start,
                          (rng.random((n, b)) < 0.5).astype(np.uint8),
                          int(rng.integers(0, 2))))
        elif k % 3 == 1:
            b = int(rng.integers(1, 100))
            calls.append(("record_and_check",
                          rng.integers(0, 3 * window, size=b),
                          rng.integers(0, n, size=b),
                          rng.integers(0, 2, size=b)))
        else:
            calls.append(("release", rng.integers(0, window, size=20)))
    ref = jq.TpuQuorumChecker(jspec, window=window, mesh=_jax_mesh(2, 4))
    for name, *args in calls[:12]:
        getattr(ref, name)(*args)
    mid = jax.device_get(ref.board)
    want = [None if r is None else np.asarray(r)
            for r in (getattr(ref, name)(*args) for name, *args in
                      calls[12:])]
    out = world.call("checker_ops", group=2, slot=4, kind="quorum",
                     specs=spec, window=window, ops=calls[12:], init=mid)
    results, _ = mb.same_on_every_rank(out)
    for g, w in zip(results, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    _assert_board(out[0]["board"], jax.device_get(ref.board))


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (4, 2), (1, 3)])
def test_column_map_is_the_reference_shard_order(shape):
    """Rank ``r`` holds the columns JAX's ``_shard_board`` puts on the
    mesh's ``r``-th device (row-major ``(group, slot)``), and
    ``shard_board`` / ``make_vote_board(mesh=)`` cut that piece."""
    window = 96 if shape == (1, 3) else 64
    mesh = _jax_mesh(*shape)
    jboard = jq._shard_board(jq.make_vote_board(window, 3), mesh, window)
    rank_of = {d.id: r for r, d in enumerate(mesh.devices.reshape(-1))}
    placed = {rank_of[s.device.id]: s.index[0] for s in
              jboard.owner.addressable_shards}
    cols = torch.arange(window, dtype=torch.int32)
    whole = tq.VoteBoard(
        (torch.arange(3 * window) % 251).to(torch.uint8).reshape(3, window),
        cols - 1, cols % 3 == 0, cols * 7)
    for rank in range(shape[0] * shape[1]):
        tmesh = TorchMesh(*shape, rank, torch.device("cpu"))
        lo, hi = tmesh.columns(window)
        assert placed[rank] == slice(lo, hi, None)
        piece = tq.shard_board(whole, tmesh, window)
        assert torch.equal(piece.owner, whole.owner[lo:hi])
        assert torch.equal(piece.votes, whole.votes[:, lo:hi])
        local = tq.make_vote_board(window, 3, mesh=tmesh)
        assert local.votes.shape == (3, hi - lo)


def test_lanes_follow_the_global_index_rules():
    """``localize_lanes`` on a 256-column window over 8 ranks: each lane
    is owned by exactly one rank, slots in ``[-W, -1]`` count from the
    end, slots past the window belong to the last rank out of range,
    slots below ``-W`` to rank 0 out of range, and the lanes a rank does
    not own are invalid and out of range (not pad lanes at slot 0)."""
    window = 256
    slots = np.array([0, 31, 32, 255, -1, -256, 256, 1000, -257, -5000],
                     dtype=np.int32)
    lanes = tq.pack_lanes(slots, slots, np.zeros(10), np.zeros(10),
                          np.ones(10, bool))
    owners = np.full(10, -1)
    for rank in range(8):
        local, owned = tq.localize_lanes(lanes, TorchMesh(
            2, 4, rank, torch.device("cpu")), window)
        assert (owners[owned] == -1).all()
        owners[owned] = rank
        np.testing.assert_array_equal(local[1:4], lanes[1:4])
        assert (local[0, ~owned] == 32).all() and (local[4, ~owned] == 0).all()
        want = {0: 0, 31: 31, 32: 0, 255: 31, -1: 31, -256: 0, 256: 32,
                1000: 32, -257: -33, -5000: -33}
        for k in np.flatnonzero(owned):
            assert local[0, k] == want[int(slots[k])]
    np.testing.assert_array_equal(owners, [0, 0, 1, 7, 7, 0, 7, 7, 0, 0])


def test_checker_and_tracker_need_a_dividing_window():
    mesh = TorchMesh(2, 4, 0, torch.device("cpu"))
    spec = convert.quorum_spec_from(SimpleMajority(range(3)).write_spec())
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tq.TpuQuorumChecker(spec, window=100, mesh=mesh)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tq.make_vote_board(100, 3, mesh=mesh)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        qt.TpuQuorumTracker(_port_config(), window=1 << 10,
                            mesh=TorchMesh(1, 3, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="not the mesh's"):
        tq.TpuQuorumChecker(spec, window=64, mesh=mesh, device="meta")


def test_check_board_refuses_a_run_without_the_kernels(world):
    """The on-card check (``chip_smoke.py``'s sharded board phase) run on
    CPU ranks, where the plain versions run: every comparison (kernel vs
    plain on each shard, the sharded trackers' drains and boards against
    the unsharded tracker's and the dict oracle's, the epoch checker, the
    geo tracker, the sharded union, the pinned mesh form against the
    pinned drain) comes out clean, and the launch gate alone refuses."""
    arms = {"pipelined majority3 1x4": ((1, 4), False, 1 << 12, True),
            "pipelined grid2x3 2x2": ((2, 2), True, 1 << 12, True),
            "sync majority3 1x4": ((1, 4), False, 1 << 12, False)}
    with pytest.raises(multichip.WorldFailure) as failure:
        mb.check_board(world, device="cpu", arms=arms, compare_calls=2,
                       time_iters=2)
    message = str(failure.value)
    assert message.startswith("kernels of the path never launched"), message
    assert "differs" not in message


@pytest.mark.parametrize("shape", [(2, 4), (1, 3)])
def test_out_of_window_lanes_read_the_clamped_edge_columns(world, shape):
    """JAX reads the clamped column for a slot outside ``[-W, W)`` and
    drops its writes, so such a lane still reports through column
    ``W - 1`` (or 0) when its true slot owns that column and the column
    holds an unchosen quorum: the last rank (or rank 0) must answer for
    it, at an out-of-range local slot."""
    window = 192 if shape == (1, 3) else 256
    owner = (np.arange(window) + 1000).astype(np.int32)
    init = jq.VoteBoard(votes=np.ones((3, window), np.uint8),
                        rounds=np.zeros(window, np.int32),
                        chosen=np.zeros(window, bool), owner=owner)
    last, first = int(owner[-1]), int(owner[0])
    lanes = tq.pack_lanes(
        [window + 5, -window - 3, 2 * window, -1, window, -2 * window],
        [last, first, last + 1, last, first, first],
        [0, 1, 2, 0, 1, 2], [0, 0, 0, 0, 0, 0], [True] * 6)
    ops = [("record_and_check", lanes), ("record_and_check", lanes)]
    spec = SimpleMajority(range(3)).write_spec()
    board = jq._shard_board(jq.VoteBoard(*(jnp.asarray(x) for x in init)),
                            _jax_mesh(*shape), window)
    want = _jax_board_ops(spec, window, ops, board)
    assert want[0][0].tolist() == [True, True, False, True, False, True]
    got = mb.same_on_every_rank(world.call(
        "board_ops", group=shape[0], slot=shape[1],
        spec=tuple(np.asarray(a) for a in spec.as_arrays()), window=window,
        ops=ops, init=init))
    for (g, g_board), (w, w_board) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        _assert_board(g_board, w_board)
