"""The pinned drain's mesh form against the JAX package's, on the CPU.

The reference's pinned pre-telemetry drain
(``frankenpaxos_tpu/bench/pipeline_baseline.py::steady_state_step``)
takes ``group_axis`` / ``slot_axis``; under ``shard_map`` over the
conftest's forced mesh it is the baseline's sharded drain. The port's
pinned mesh form (``bench/pipeline_baseline.py``'s ``make_sharded_step``
over its own copies of the telemetry-off K19-K21, the plain versions on
gloo ranks here) must equal it on every leaf of the gathered state, bit
for bit, on (1, 4), (2, 2) and (1, 3) (a block that does not divide over
the slot shards), and equal the live sharded drain with telemetry off.
One world of 4 ranks serves the module.
"""

import functools
import inspect

from frankenpaxos_tpu_torch.bench import (
    multichip,
    multichip_board as mb,
    pipeline_baseline as tpin,
)
from frankenpaxos_tpu_torch.mesh import Mesh as TorchMesh
from frankenpaxos_tpu_torch.ops.quorum import make_predicate
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.bench import pipeline as jp, pipeline_baseline as jpin
from frankenpaxos_tpu.quorums import Grid, SimpleMajority

FIELDS = jpin.PipelineState._fields


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(4, device_type="cpu") as w:
        yield w


@pytest.fixture(autouse=True)
def _devices(need_8_devices):
    """The JAX side needs the shared 8-device mesh (conftest.py)."""


def _spec(n_acc, grid_shape=None):
    spec = (SimpleMajority(range(n_acc)).write_spec() if grid_shape is None
            else Grid(np.arange(n_acc).reshape(*grid_shape).tolist())
            .write_spec())
    masks, thresholds, combine_any = spec.as_arrays()
    return (np.asarray(masks).tolist(), np.asarray(thresholds).tolist(),
            bool(combine_any))


def _jax_pinned(group, slot, n_acc, window, block, iters, spec):
    """The reference's pinned drain with its axes under shard_map."""
    devices = np.asarray(jax.devices()[:group * slot])
    mesh = Mesh(devices.reshape(group, slot), ("group", "slot"))
    masks, thresholds, combine_any = spec
    step = functools.partial(
        jpin.steady_state_step, block_size=block,
        masks=np.asarray(masks, np.int32), thresholds=thresholds,
        combine_any=combine_any, group_axis="group", slot_axis="slot",
        group_shards=group, slot_shards=slot)
    specs = jpin.PipelineState(*(P(*axes) for axes in
                                 jp.PIPELINE_PARTITION[:7]))
    shard_map = jp._shard_map_fn()
    params = inspect.signature(shard_map).parameters
    kwargs = {"check_vma": False} if "check_vma" in params else (
        {"check_rep": False} if "check_rep" in params else {})
    run = jax.jit(shard_map(step, mesh=mesh, in_specs=(specs, P()),
                            out_specs=specs, **kwargs))
    state = jax.device_put(
        jpin.make_state(jp.padded_window(window, block, slot), n_acc),
        jax.tree.map(lambda s: NamedSharding(mesh, s), specs))
    for t in range(iters):
        state = run(state, jnp.int32(t))
    return jax.device_get(state)


@pytest.mark.parametrize("shape,n_acc,grid,window,block,iters", [
    ((1, 4), 3, None, 1 << 9, 1 << 7, 9),
    ((2, 2), 6, (2, 3), 1 << 9, 1 << 7, 9),
    ((1, 3), 3, None, 400, 100, 9),
])
def test_pinned_mesh_form_matches_the_reference(world, shape, n_acc, grid,
                                                window, block, iters):
    spec = _spec(n_acc, grid)
    got = mb.same_on_every_rank(world.call(
        "pinned_drain", group=shape[0], slot=shape[1], window=window,
        block=block, spec=spec, iters=iters))
    want = _jax_pinned(*shape, n_acc, window, block, iters, spec)
    assert int(want.committed) > 0
    for name in FIELDS:
        ref = np.asarray(getattr(want, name))
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape
        np.testing.assert_array_equal(got[name], ref, err_msg=name)
    live = world.call("drain", group=shape[0], slot=shape[1], window=window,
                      block=block, spec=spec, iters=iters)[0]
    for name in FIELDS:
        np.testing.assert_array_equal(got[name], live[name], err_msg=name)


@pytest.mark.parametrize("window,block", [(1 << 9, 1 << 6), (64, 64),
                                          (128, 64)])
def test_one_shard_is_the_pinned_drain(window, block):
    """On a 1x1 mesh (no collective) the pinned mesh form is the pinned
    unsharded drain, also where window / block is 1 or 2."""
    spec = SimpleMajority(range(3)).write_spec()
    pred = make_predicate(*spec.as_arrays(), device="cpu")
    mesh = TorchMesh(1, 1, 0, torch.device("cpu"))
    plan = tpin.make_shard_plan(mesh, block, pred)
    sharded, _ = tpin.make_sharded_state(mesh, window, block, 3)
    host = tpin.make_state(window, 3, device="cpu")
    for i in range(9):
        tpin.sharded_step(mesh, sharded, i, plan)
        tpin.steady_state_step_plain(host, i, block, pred)
        for a, b in zip(sharded, host):
            assert torch.equal(a, b)
    assert not plan.slot.any()
