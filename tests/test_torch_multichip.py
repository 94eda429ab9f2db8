"""The port's sharded drain against the JAX package's, on the CPU.

Every case of ``tests/test_multichip.py`` again: the port's sharded
drain (``bench/pipeline.py``'s plain phases over a gloo world of spawned
CPU ranks, ``bench/multichip.py``) must equal the JAX sharded step on
the conftest's forced 8-device mesh on EVERY leaf of the gathered state,
bit for bit, and -- through ``gathered_layout`` -- the unsharded drain.
One world of 8 ranks serves the module's cases; each case has a
deadline.
"""

from frankenpaxos_tpu_torch.bench import multichip, pipeline as tp
from frankenpaxos_tpu_torch.mesh import Mesh as TorchMesh
from frankenpaxos_tpu_torch.ops.quorum import make_predicate
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.bench import pipeline as jp
from frankenpaxos_tpu.quorums import Grid, SimpleMajority

FIELDS = ("votes", "chosen", "commands", "results", "sm_state",
          "committed", "exec_wm")


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(8, device_type="cpu") as w:
        yield w


def _spec(n_acc, grid_shape=None):
    if grid_shape is None:
        spec = SimpleMajority(range(n_acc)).write_spec()
    else:
        spec = Grid(np.arange(n_acc).reshape(*grid_shape).tolist()
                    ).write_spec()
    return spec.as_arrays()


def _plain(spec) -> tuple:
    masks, thresholds, combine_any = spec
    return (np.asarray(masks).tolist(), np.asarray(thresholds).tolist(),
            bool(combine_any))


def _jax_mesh(group_dim, slot_dim):
    devices = np.asarray(jax.devices()[:group_dim * slot_dim])
    return Mesh(devices.reshape(group_dim, slot_dim), ("group", "slot"))


def _jax_sharded(group_dim, slot_dim, n_acc, window, block, iters, spec,
                 telemetry=False, start=0, state=None):
    mesh = _jax_mesh(group_dim, slot_dim)
    masks, thresholds, combine_any = spec
    step, sharding = jp.make_sharded_step(
        mesh, block_size=block, masks=masks, thresholds=thresholds,
        combine_any=combine_any, telemetry=telemetry)
    if state is None:
        state, _, _ = jp.make_sharded_state(mesh, window, block, n_acc,
                                            telemetry=telemetry)
    else:
        state = jax.device_put(state, sharding)
    for t in range(start, start + iters):
        state = step(state, jnp.int32(t))
    return jax.device_get(state)


def _jax_unsharded(n_acc, window, block, iters, spec):
    masks, thresholds, combine_any = spec
    step = jax.jit(lambda s, i: jp.steady_state_step(
        s, i, block_size=block, masks=masks, thresholds=thresholds,
        combine_any=combine_any))
    state = jp.make_state(window, n_acc)
    for t in range(iters):
        state = step(state, jnp.int32(t))
    return jax.device_get(state)


def _port(world, group_dim, slot_dim, window, block, iters, spec, **kw):
    return world.call("drain", deadline_s=120, group=group_dim,
                      slot=slot_dim, window=window, block=block,
                      spec=_plain(spec), iters=iters, **kw)[0]


def assert_same_leaves(port: dict, ref) -> None:
    """Every leaf of the port's gathered state equals the JAX gathered
    state's: shape, dtype and every element (no tolerance)."""
    for name in FIELDS:
        got, want = port[name], np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if ref.telemetry is None:
        assert port["telemetry"] is None
        return
    for name, want in zip(ref.telemetry._fields, ref.telemetry):
        got, want = port["telemetry"][name], np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_gathered_equivalent(port: dict, host, slot_dim, window, block,
                               w_padded):
    """The reference's pad-aware check: through ``gathered_layout`` the
    gathered window equals the unsharded oracle's, pad columns zero."""
    b_local, pad = tp.local_block(block, slot_dim)
    logical, valid = tp.gathered_layout(slot_dim, w_padded // slot_dim,
                                        b_local, block)

    def gathered(x):
        out = np.zeros(x.shape[:-1] + (window,), x.dtype)
        out[..., logical[valid]] = x[..., valid]
        return out

    for name in ("committed", "sm_state", "exec_wm"):
        assert int(port[name]) == int(getattr(host, name)), name
    for name in ("chosen", "commands", "results", "votes"):
        np.testing.assert_array_equal(
            gathered(port[name]), np.asarray(getattr(host, name)),
            err_msg=name)
    if pad:
        assert not port["votes"][:, ~valid].any()
        assert not port["commands"][~valid].any()
        assert not port["results"][~valid].any()
        assert not port["chosen"][~valid].any()


def _case(world, group_dim, slot_dim, n_acc, window, block, iters,
          grid_shape=None):
    spec = _spec(n_acc, grid_shape)
    port = _port(world, group_dim, slot_dim, window, block, iters, spec)
    assert_same_leaves(port, _jax_sharded(group_dim, slot_dim, n_acc,
                                          window, block, iters, spec))
    host = _jax_unsharded(n_acc, window, block, iters, spec)
    assert int(host.committed) > 0
    assert_gathered_equivalent(port, host, slot_dim, window, block,
                               tp.padded_window(window, block, slot_dim))
    return port, host


@pytest.fixture(autouse=True)
def _devices(need_8_devices):
    """The JAX side needs the shared 8-device mesh (conftest.py)."""


def test_slot_sharded_equivalence(world):
    """1x8: the slot window shards 8 ways; acceptors replicated."""
    _case(world, 1, 8, 3, 1 << 10, 1 << 7, 5)


def test_grid_mesh_equivalence(world):
    """2x4: acceptor rows AND the slot window shard; counts cross the
    group all-reduce."""
    _case(world, 2, 4, 6, 1 << 10, 1 << 7, 6)


def test_group_sharded_equivalence(world):
    """8x1: every quorum count is a cross-rank sum of acceptor rows."""
    _case(world, 8, 1, 24, 1 << 9, 1 << 6, 4)


def test_ring_wraparound_equivalence(world):
    """More drains than ring blocks (4): GC wrap and re-proposal agree."""
    _case(world, 2, 4, 6, 1 << 9, 1 << 7, 11)


def test_grid_spec_sharded_equivalence(world):
    """The 2x3 grid write spec on a 2x4 mesh: each group shard holds one
    whole row, so the fused row path runs; the spec is really exercised
    (its commits differ from 4-of-6 majority's)."""
    _, host = _case(world, 2, 4, 6, 1 << 10, 1 << 7, 6, grid_shape=(2, 3))
    maj = _jax_unsharded(6, 1 << 10, 1 << 7, 6, _spec(6))
    assert int(host.committed) != int(maj.committed)


@pytest.mark.parametrize("group_dim,slot_dim", [(1, 3), (2, 3)])
def test_non_divisible_slot_split(world, group_dim, slot_dim):
    """A block that does not divide over the slot shards (100 % 3): the
    local block rounds up, the pad lanes are masked, and every leaf
    still matches."""
    n_acc, window, block, iters = 2 * group_dim, 400, 100, 9
    assert tp.padded_window(window, block, slot_dim) > window
    port, _ = _case(world, group_dim, slot_dim, n_acc, window, block, iters)
    assert port["votes"].shape == (n_acc, tp.padded_window(
        window, block, slot_dim))


def test_sharded_runner_matches_run_steps(world):
    """``make_sharded_runner`` in chunks of 4 (resuming at drain 4)
    equals the unsharded ``run_steps`` of 8 drains, on a non-divisible
    split."""
    n_acc, window, block = 3, 400, 100
    spec = _spec(n_acc)
    masks_t = tuple(tuple(int(x) for x in row) for row in spec[0])
    thresholds_t = tuple(int(t) for t in spec[1])
    host = jax.device_get(jp.run_steps(jp.make_state(window, n_acc), 8,
                                       block, masks_t, thresholds_t,
                                       spec[2]))
    port = _port(world, 1, 3, window, block, 8, spec, chunk=4)
    assert_gathered_equivalent(port, host, 3, window, block,
                               tp.padded_window(window, block, 3))
    assert_same_leaves(port, _jax_sharded(1, 3, n_acc, window, block, 8,
                                          spec))


@pytest.mark.parametrize("shape", [(2, 4), (1, 3)])
def test_resumes_from_a_jax_state(world, shape):
    """A mid-flight JAX sharded state, gathered and carried into the port
    (``convert.sharded_state_from_numpy`` per rank), continues to the
    same state as the JAX step does."""
    g, s = shape
    n_acc, window, block = 3 * g, 400 if s == 3 else 1 << 9, 100 if s == 3 \
        else 1 << 7
    spec = _spec(n_acc)
    mid = _jax_sharded(g, s, n_acc, window, block, 5, spec, telemetry=True)
    init = {name: np.asarray(getattr(mid, name)) for name in FIELDS}
    init["telemetry"] = {name: np.asarray(v) for name, v in
                         zip(mid.telemetry._fields, mid.telemetry)}
    port = _port(world, g, s, window, block, 4, spec, start=5,
                 telemetry=True, init=init)
    assert_same_leaves(port, _jax_sharded(g, s, n_acc, window, block, 4,
                                          spec, telemetry=True, start=5,
                                          state=mid))


def test_dryrun_multichip_entry(world, capsys):
    """The port's twin of ``__graft_entry__.dryrun_multichip`` runs
    clean on 8 ranks, its third part included: the pipelined tracker
    with its board sharded over the 2x4 mesh chooses exactly three ring
    wraps of slots, each drain equal to the dict oracle."""
    out = multichip.dryrun(8, world=world)
    assert out["mesh"] == "2x4"
    assert out["committed"] > 0 and out["grid_committed"] > 0
    assert out["chosen"] == 3 << 10
    assert ("vote board sharded over the mesh chose 3072 slots across 3 "
            "ring wraps, bit-identical to the host oracle"
            in capsys.readouterr().out)


def test_worker_loads_no_jax(world):
    """The spawned ranks import the port and never JAX or the JAX
    package."""
    for modules in world.call("modules"):
        assert not {"jax", "jaxlib", "frankenpaxos_tpu"} & set(modules)
        assert "frankenpaxos_tpu_torch" in modules


@pytest.mark.parametrize("block,slots", [(128, 4), (100, 3), (96, 3),
                                         (1 << 15, 3), (7, 8)])
def test_layout_helpers_match_reference(block, slots):
    assert tp.local_block(block, slots) == jp.local_block(block, slots)
    window = block * 4
    w_padded = tp.padded_window(window, block, slots)
    assert w_padded == jp.padded_window(window, block, slots)
    b_local, _ = tp.local_block(block, slots)
    for got, want in zip(
            tp.gathered_layout(slots, w_padded // slots, b_local, block),
            jp.gathered_layout(slots, w_padded // slots, b_local, block)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="whole"):
        tp.padded_window(window + 1, block, slots)


def test_partition_table_matches_reference():
    table = tp.state_sharding(telemetry=True)
    for name in FIELDS:
        assert getattr(table, name) == getattr(jp.PIPELINE_PARTITION, name)
    # Every counter is replicated here: the slot all-reduce fills every
    # shard's entry of shard_committed on every rank.
    assert all(axes == () for axes in table.telemetry)
    assert tp.state_sharding().telemetry is None


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("window,block", [(1 << 9, 1 << 6), (64, 64),
                                          (128, 64)])
def test_one_shard_is_the_unsharded_drain(telemetry, window, block):
    """A 1x1 mesh needs no collective: the three phases on one rank (no
    process group) give the unsharded drain's state exactly, also where
    window / block is 1 or 2 and the ring's blocks alias."""
    spec = SimpleMajority(range(3)).write_spec()
    pred = make_predicate(*spec.as_arrays(), device="cpu")
    mesh = TorchMesh(1, 1, 0, torch.device("cpu"))
    plan = tp.make_shard_plan(mesh, block, pred, telemetry=telemetry)
    sharded, _ = tp.make_sharded_state(mesh, window, block, 3,
                                       telemetry=telemetry)
    host = tp.make_state(window, 3, telemetry=telemetry, device="cpu")
    for i in range(9):
        tp.sharded_step(mesh, sharded, i, plan)
        tp.steady_state_step_plain(host, i, block, pred)
        for name in FIELDS:
            assert torch.equal(getattr(sharded, name), getattr(host, name))
        if telemetry:
            assert torch.equal(sharded.telemetry.buffer,
                               host.telemetry.buffer)
    assert not plan.slot.any()


def test_plan_picks_the_reference_branch():
    """The fused row path only where every group shard holds whole rows
    of a row-major grid; the psum'd matmul otherwise."""
    grid = Grid([[0, 1, 2], [3, 4, 5]]).write_spec()
    perm = Grid([[0, 2, 4], [1, 3, 5]]).write_spec()
    read = Grid([[0, 1, 2], [3, 4, 5]]).read_spec()
    cases = [((2, 2), grid, tp.GRID_WRITE), ((3, 1), grid, tp.MATMUL),
             ((1, 4), grid, tp.GRID_WRITE), ((2, 2), perm, tp.MATMUL),
             ((2, 1), read, tp.GRID_READ),
             ((2, 1), SimpleMajority(range(6)).write_spec(), tp.MATMUL)]
    for (g, s), spec, kind in cases:
        pred = make_predicate(*spec.as_arrays(), device="cpu")
        mesh = TorchMesh(g, s, 0, torch.device("cpu"))
        plan = tp.make_shard_plan(mesh, 100, pred)
        assert plan.kind == kind, (g, s, spec)
        assert plan.n_local == 6 // g
        rows = pred.masks.shape[0] if kind == tp.MATMUL else 1
        assert plan.parts.shape == (2, rows, -(-100 // s))
    mesh = TorchMesh(4, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="split"):
        tp.make_shard_plan(mesh, 100, make_predicate(
            *grid.as_arrays(), device="cpu"))
    with pytest.raises(ValueError, match="split"):
        tp.make_sharded_state(mesh, 400, 100, 6)


def test_check_refuses_a_run_without_the_kernels(world):
    """The on-card check (``chip_smoke.py`` phase 25, ``python -m
    frankenpaxos_tpu_torch.bench.multichip``) fails a run in which the
    kernels did not launch: on CPU ranks the phases are the plain
    versions, so the launch gate must refuse, after the kernel-vs-plain
    and unsharded comparisons have run clean."""
    ranks = world.call("check_drain", deadline_s=120, group=2, slot=2,
                       spec="grid2x3", window=512, block=128, drains=6,
                       compare_drains=2, time_drains=2, telemetry=True)
    lead = ranks[0]
    assert lead["unsharded_mismatch"] == []
    assert not any(lead["errors"].values())
    assert lead["launches"] == dict.fromkeys(multichip.SHARDED_KERNELS, 0)
    assert ranks[4:] == [None] * 4
    with pytest.raises(multichip.WorldFailure, match="launched"):
        multichip.check(world, 1, 2, "majority3", False, window=512,
                        block=128, drains=4, compare_drains=1,
                        time_drains=1)
