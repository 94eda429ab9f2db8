"""The port's steady-state drain vs the JAX reference, drain by drain.

Every field of ``PipelineState`` is an integer or a bool, so parity is
bit-identity (tolerance 0), compared after every drain. The port runs
its plain PyTorch version here (``device="cpu"``); ``chip_smoke.py``
holds the CUDA kernel against that plain version on the GPU.
"""

import functools

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import pipeline as tp
from frankenpaxos_tpu_torch.ops.quorum import make_predicate
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.bench import pipeline as jp
from frankenpaxos_tpu.quorums import (
    Grid as JGrid,
    SimpleMajority as JSimpleMajority,
)

SPECS = {
    "majority3": JSimpleMajority(range(3)).write_spec(),
    "majority5": JSimpleMajority(range(5)).write_spec(),
    "grid2x3": JGrid([[0, 1, 2], [3, 4, 5]]).write_spec(),
    "grid3x3": JGrid([[0, 1, 2], [3, 4, 5], [6, 7, 8]]).write_spec(),
}


def _statics(spec):
    masks, thresholds, combine_any = spec.as_arrays()
    return (tuple(tuple(int(x) for x in row) for row in masks),
            tuple(int(t) for t in thresholds), combine_any)


@functools.cache
def _jax_step(name: str, block_size: int):
    masks, thresholds, combine_any = SPECS[name].as_arrays()
    return jax.jit(functools.partial(
        jp.steady_state_step, block_size=block_size, masks=masks,
        thresholds=thresholds, combine_any=combine_any))


def _assert_same(port_state, ref_state, where=""):
    got = convert.pipeline_state_to_numpy(port_state)
    want = jax.device_get(ref_state)
    assert got.telemetry is None and want.telemetry is None
    for name in tp.PipelineState._fields[:7]:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {where}")


def _run_both(name, window, block_size, drains, first=0):
    spec = SPECS[name]
    n = spec.num_nodes
    ref_state = jp.make_state(window, n)
    state = tp.make_state(window, n, device="cpu")
    pred = make_predicate(*spec.as_arrays(), device="cpu")
    step = _jax_step(name, block_size)
    for i in range(first, first + drains):
        ref_state = step(ref_state, jnp.int32(i))
        out = tp.steady_state_step(state, i, block_size=block_size,
                                   predicate=pred)
        assert out is state  # updated in place
        _assert_same(state, ref_state, f"after drain {i}")
    return state


@pytest.mark.parametrize("name", list(SPECS))
def test_drains_match_reference_every_field(name):
    state = _run_both(name, window=4096, block_size=256, drains=12)
    assert int(state.committed) > 0


@pytest.mark.parametrize("ratio", [1, 2])
@pytest.mark.parametrize("name", ["majority3", "grid2x3"])
def test_aliasing_blocks_match_reference(name, ratio):
    """window / block in {1, 2}: the new, old and GC blocks alias."""
    _run_both(name, window=256 * ratio, block_size=256, drains=8)


@pytest.mark.parametrize("start", [70_000, (1 << 24) + 3, 2**31 - 40])
def test_run_steps_from_int32_wraps_match_reference(start):
    """Drains far from 0: the arrival hash, the proposed ids, sm_state
    and exec_wm (i * block >= 2^31) all wrap as int32."""
    spec = SPECS["grid2x3"]
    statics = _statics(spec)
    ref_state = jp.run_steps_from(jp.make_state(1024, 6), jnp.int32(start),
                                  12, 256, *statics)
    state = tp.run_steps_from(tp.make_state(1024, 6, device="cpu"), start,
                              12, 256, *statics)
    _assert_same(state, ref_state)
    if start * 256 >= 2**31:
        assert int(state.exec_wm) != (start + 11) * 256


def test_run_steps_from_near_wrap_per_drain():
    _run_both("majority3", window=1024, block_size=256, drains=6,
              first=2**31 - 6)


def test_run_steps_matches_reference():
    statics = _statics(SPECS["majority3"])
    ref_state = jp.run_steps(jp.make_state(2048, 3), 10, 256, *statics)
    state = tp.run_steps(tp.make_state(2048, 3, device="cpu"), 10, 256,
                         *statics)
    _assert_same(state, ref_state)


def test_carry_state_across_from_jax():
    """5 drains in JAX, the state moved into the port, 5 more drains on
    each side: identical."""
    name, window, block_size = "grid2x3", 2048, 256
    step = _jax_step(name, block_size)
    ref_state = jp.make_state(window, 6)
    for i in range(5):
        ref_state = step(ref_state, jnp.int32(i))
    state = convert.pipeline_state_from_numpy(jax.device_get(ref_state),
                                              device="cpu")
    assert [t.dtype for t in state[:7]] == [
        torch.uint8, torch.bool, torch.int32, torch.int32, torch.int32,
        torch.int32, torch.int32]
    _assert_same(state, ref_state)
    pred = make_predicate(*SPECS[name].as_arrays(), device="cpu")
    for i in range(5, 10):
        ref_state = step(ref_state, jnp.int32(i))
        tp.steady_state_step(state, i, block_size=block_size,
                             predicate=pred)
    _assert_same(state, ref_state)


def test_conversion_rejects_mismatched_state():
    ref = jax.device_get(jp.make_state(512, 3))
    with pytest.raises(ValueError, match="committed"):
        convert.pipeline_state_from_numpy(
            ref._replace(committed=np.int64(0)), device="cpu")
    # Telemetry crosses too (counters into the port's flat buffer); a
    # counter of the wrong dtype is refused like any other field.
    on = jax.device_get(jp.make_state(512, 3, telemetry=True))
    carried = convert.pipeline_state_from_numpy(on, device="cpu")
    assert carried.telemetry.buffer.dtype == torch.int32
    assert carried.telemetry.occupancy.shape == (4,)
    with pytest.raises(ValueError, match="telemetry"):
        convert.pipeline_state_from_numpy(
            on._replace(telemetry=on.telemetry._replace(
                lag_hist=np.zeros(16, np.int64))), device="cpu")
    fields = ref._asdict()
    del fields["exec_wm"]
    with pytest.raises(ValueError, match="fields"):
        convert.pipeline_state_from_numpy(fields, device="cpu")


def test_step_rejects_bad_shapes_and_telemetry():
    pred = make_predicate(*SPECS["majority3"].as_arrays(), device="cpu")
    # Telemetry on is a state with zeroed counters for one slot shard;
    # counters over more shards are the sharded drain's, which the
    # unsharded drain refuses.
    on = tp.make_state(512, 3, telemetry=True, device="cpu")
    assert on.telemetry.shard_committed.shape == (1,)
    assert not on.telemetry.buffer.any()
    four = tp.make_state(512, 3, telemetry=True, slot_shards=4, device="cpu")
    assert four.telemetry.shard_committed.shape == (4,)
    with pytest.raises(ValueError, match="make_sharded_step"):
        tp.steady_state_step(four, 0, block_size=256, predicate=pred)
    with pytest.raises(ValueError, match="whole"):
        tp.steady_state_step(tp.make_state(500, 3, device="cpu"), 0,
                             block_size=256, predicate=pred)
    with pytest.raises(ValueError, match="acceptors"):
        tp.steady_state_step(tp.make_state(512, 5, device="cpu"), 0,
                             block_size=256, predicate=pred)
    with pytest.raises(OverflowError):
        tp.steady_state_step(tp.make_state(512, 3, device="cpu"), 2**31,
                             block_size=256, predicate=pred)
    state = tp.make_state(512, 3, device="cpu")
    with pytest.raises(ValueError, match="make_state"):
        tp.steady_state_step(
            state._replace(commands=state.commands.to(torch.int64)), 0,
            block_size=256, predicate=pred)
    with pytest.raises(ValueError, match="make_state"):
        tp.steady_state_step(state._replace(committed=state.commands[:1]),
                             0, block_size=256, predicate=pred)


# --- runs of drains: what one launch of the chunked drain kernel does ------

CHUNKS = (1, 2, 3, 17)
RATIOS = (1, 2, 3, 8)
STARTS = (0, 2**31 - 5)


def _jax_run(ref_state, name, start, iters, block_size):
    """JAX's ``run_steps_from`` where the run stays inside int32; a run
    that crosses the wrap runs JAX's jitted step drain by drain at the
    wrapped index (``run_steps_from``'s loop bound would wrap)."""
    if start + iters - 1 < 2**31:
        return jp.run_steps_from(ref_state, jnp.int32(start), iters,
                                 block_size, *_statics(SPECS[name]))
    step = _jax_step(name, block_size)
    for k in range(iters):
        ref_state = step(ref_state, jnp.int32(tp._wrap32(start + k)))
    return ref_state


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_run_steps_from_chunks_match_reference(chunk, ratio, start):
    """``run_steps_from`` on CPU tensors (the plain version of one
    launch) against JAX's, every field bit for bit, after a chunk and
    after a second chunk that resumes it: chunks of 1, 2, 3 and 17
    drains, window / block 1, 2, 3 and 8 (1 and 2 alias the new, old and
    GC blocks; 3 makes the next drain's new block this drain's GC
    block), from 0 and from 2^31 - 5 (17 drains wrap int32)."""
    name = "grid2x3" if ratio % 2 else "majority3"
    block = 128
    n = SPECS[name].num_nodes
    statics = _statics(SPECS[name])
    ref_state = jp.make_state(block * ratio, n)
    state = tp.make_state(block * ratio, n, device="cpu")
    at = start
    for _ in range(2):
        ref_state = _jax_run(ref_state, name, at, chunk, block)
        out = tp.run_steps_from(state, at, chunk, block, *statics)
        assert out is state
        _assert_same(state, ref_state, f"after the chunk from {at}")
        at = tp._wrap32(at + chunk)
    assert int(state.committed) > 0


@pytest.mark.parametrize("start", STARTS)
def test_two_chunks_equal_one_long_chunk(start):
    """7 drains then 10 from where they stopped equal 17 in one run,
    and JAX's 17."""
    name, block = "majority3", 256
    statics = _statics(SPECS[name])
    ref_state = _jax_run(jp.make_state(1024, 3), name, start, 17, block)
    one = tp.run_steps_from(tp.make_state(1024, 3, device="cpu"), start, 17,
                            block, *statics)
    two = tp.make_state(1024, 3, device="cpu")
    tp.run_steps_from(two, start, 7, block, *statics)
    tp.run_steps_from(two, tp._wrap32(start + 7), 10, block, *statics)
    _assert_same(one, ref_state)
    _assert_same(two, ref_state)


def test_run_steps_plain_is_the_per_drain_reference():
    """The plain version of one launch equals the per-drain plain step
    looped, and a run of 0 drains leaves the state alone."""
    pred = make_predicate(*SPECS["grid3x3"].as_arrays(), device="cpu")
    run = tp.run_steps_plain(tp.make_state(1536, 9, device="cpu"),
                             2**31 - 3, 6, 512, pred)
    loop = tp.make_state(1536, 9, device="cpu")
    for k in range(6):
        tp.steady_state_step_plain(loop, tp._wrap32(2**31 - 3 + k), 512,
                                   pred)
    for name in tp.PipelineState._fields[:7]:
        assert torch.equal(getattr(run, name), getattr(loop, name)), name
    before = [t.clone() for t in run[:7]]
    tp.run_steps_from(run, 0, 0, 512, *_statics(SPECS["grid3x3"]))
    assert all(torch.equal(a, b) for a, b in zip(before, run[:7]))
    with pytest.raises(ValueError, match="iters"):
        tp.run_steps_from(run, 0, -1, 512, *_statics(SPECS["grid3x3"]))
