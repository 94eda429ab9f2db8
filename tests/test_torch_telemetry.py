"""The port's telemetry plane (``ops/telemetry.py``, the telemetry-on
drain of ``bench/pipeline.py``, ``obs/telemetry.py``) and its benches
(``bench/pipeline_baseline.py``, ``bench/telemetry_overhead.py``,
``bench/libbench.py``) against the JAX package.

Every counter is int32, so every comparison is exact (tolerance 0). The
port runs its plain PyTorch versions here (``device="cpu"``);
``chip_smoke.py`` holds K14, the pinned K3 copy, and the kernels the
libbench twin launches against those plain versions on the GPU.

(a) The single-device cases of ``tests/test_telemetry.py`` on the port.
Two change form: "one batched fetch" is counted through
``obs.telemetry.fetch``, and "off traces to the pinned program" becomes
"the off arm and the pinned twin make the same packed C call with the
same scalars, one per run (a stand-in library), and end in
bit-identical state". The mesh cases run over gloo ranks in
``tests/test_torch_multichip_telemetry.py``; the SIGKILL post-mortem
waits for ``obs/flight.py`` (ROADMAP.md queue 1 item 8).
(b) Parity with JAX: the counters after every drain, ``lag_bucket``,
the update functions, the reporter. (c) The benches at tiny sizes.
"""

import functools
import json
import struct

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import (
    libbench as tlib,
    pipeline as tp,
    pipeline_baseline as tpin,
    telemetry_overhead as tover,
)
from frankenpaxos_tpu_torch.obs import telemetry as tobs
from frankenpaxos_tpu_torch.ops import _build, telemetry as ttel
from frankenpaxos_tpu_torch.ops.quorum import make_predicate
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.bench import pipeline as jp
from frankenpaxos_tpu.obs import telemetry as jobs
from frankenpaxos_tpu.ops import telemetry as jtel
from frankenpaxos_tpu.quorums import (
    Grid as JGrid,
    SimpleMajority as JSimpleMajority,
)

SPECS = {
    "majority3": JSimpleMajority(range(3)).write_spec(),
    "grid2x3": JGrid([[0, 1, 2], [3, 4, 5]]).write_spec(),
}


def _statics(spec):
    masks, thresholds, combine_any = spec.as_arrays()
    return (tuple(tuple(int(x) for x in row) for row in masks),
            tuple(int(t) for t in thresholds), combine_any)


def _pred(spec):
    return make_predicate(*spec.as_arrays(), device="cpu")


def _run_1x1(window, block, iters, n_acc=3, telemetry=True):
    spec = JSimpleMajority(range(n_acc)).write_spec()
    state = tp.make_state(window, n_acc, telemetry=telemetry, device="cpu")
    pred = _pred(spec)
    for t in range(iters):
        tp.steady_state_step(state, t, block_size=block, predicate=pred)
    return state


def _assert_recount(state, *, block, iters):
    """The host oracle: every counter re-derives from committed/drains
    (``tests/test_telemetry.py::_assert_recount`` on one GPU)."""
    tel = state.telemetry
    committed = int(state.committed)
    assert committed == iters * block
    assert int(tel.drains) == iters
    assert int(tel.occupancy.sum()) == committed
    assert tuple(tel.shard_committed.shape) == (1,)
    assert int(tel.shard_committed.sum()) == committed
    assert int(tel.proposed) == iters * block
    assert int(tel.pad_lanes) == 0
    assert tuple(tel.lag_hist.shape) == (ttel.LAG_BUCKETS,)
    assert int(tel.lag_hist.sum()) == iters


# --- (a) the single-device cases of tests/test_telemetry.py ----------------


def test_recount_1x1():
    state = _run_1x1(window=1 << 10, block=1 << 7, iters=6)
    _assert_recount(state, block=1 << 7, iters=6)


@pytest.mark.parametrize("pad_per_drain,block,slots",
                         [(0, 128, 4), (2, 100, 3), (0, 96, 3)])
def test_pad_lane_arithmetic_property(pad_per_drain, block, slots):
    # The padding rule itself: pad lanes per drain = ceil-split excess,
    # the rule of the JAX package's local_block.
    b_local = -(-block // slots)
    assert b_local * slots - block == pad_per_drain
    assert jp.local_block(block, slots) == (b_local, pad_per_drain)


def _assert_bit_identical(a, b):
    for name in tp.PipelineState._fields[:7]:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_on_off_bit_identity_1x1():
    off = _run_1x1(window=1 << 9, block=1 << 6, iters=5, telemetry=False)
    on = _run_1x1(window=1 << 9, block=1 << 6, iters=5, telemetry=True)
    assert off.telemetry is None
    assert on.telemetry is not None
    assert int(off.committed) > 0
    _assert_bit_identical(off, on)


def test_collect_is_one_batched_fetch(monkeypatch):
    """Stepping makes zero fetches; one collect() makes exactly one
    device-to-host copy, of the whole flat buffer."""
    calls = []
    real_fetch = tobs.fetch

    def counting_fetch(buffer):
        calls.append(buffer)
        return real_fetch(buffer)

    monkeypatch.setattr(tobs, "fetch", counting_fetch)
    block = 1 << 6
    state = _run_1x1(window=1 << 9, block=block, iters=5)
    assert calls == []
    snap = tobs.collect(state)
    assert len(calls) == 1
    assert calls[0] is state.telemetry.buffer
    assert calls[0].numel() == ttel.buffer_words(3)
    assert isinstance(snap, tobs.TelemetrySnapshot)
    assert snap.drains == 5
    assert snap.committed == 5 * block
    assert sum(snap.occupancy) == snap.committed


class _Recorder:
    """Stands in for the kernel libraries: records each entry point's
    arguments (a packed block of int64 unpacked), launches nothing,
    returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            if len(args) == 1 and isinstance(args[0], bytes):
                args = struct.unpack(f"={len(args[0]) // 8}q", args[0])
            self.calls.append((entry, args))
            return 0

        return call


def _force_kernel_path(monkeypatch):
    """The kernel path on CPU tensors: every ``_build.Entry`` call of the
    live drain and the pinned copy goes to a recorder."""
    recorder = _Recorder()
    for module in (tp, tpin):
        monkeypatch.setattr(module, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda name: recorder)
    monkeypatch.setattr(_build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(_build, "stream_handle", lambda index: 0)
    for entry in (tp._K3, tp._K14, tpin._K3):
        monkeypatch.setattr(entry, "fn", None)
    for wrapper in (tp.steady_state_step, tp.telemetry_drain,
                    tpin.steady_state_step):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "drains", 0)
    return recorder


#: Slots of the drain's packed block that hold pointers: the seven state
#: tensors and the predicate's three arrays (``pipeline.cu``'s layout).
_POINTER_SLOTS = frozenset(range(7)) | {11, 12, 13}


def _scalars(args):
    """The non-pointer slots of a recorded drain call: window, block,
    start, iters, the predicate's six ints, the telemetry and scratch
    slots, device and stream."""
    return [a for k, a in enumerate(args) if k not in _POINTER_SLOTS]


def test_off_traces_to_pinned_baseline_program(monkeypatch):
    """Telemetry off makes the pinned program's calls: the live off arm
    and the pinned twin make ONE packed call per run, through entries of
    the same signature, with the same scalar slots (pointers at the same
    positions) and no telemetry or scratch; a run longer than a launch's
    cap splits alike; the launch and drain counters count; and on the
    CPU they end in bit-identical state."""
    statics = _statics(SPECS["majority3"])
    recorder = _force_kernel_path(monkeypatch)
    tp.run_steps_from(tp.make_state(1 << 10, 3, device="cpu"), 5, 8, 128,
                      *statics)
    live_calls = list(recorder.calls)
    recorder.calls.clear()
    tpin.run_steps_from(tpin.make_state(1 << 10, 3, device="cpu"), 5, 8,
                        128, *statics)
    pinned_calls = list(recorder.calls)
    assert [e for e, _ in live_calls] == ["fpx_run_steps"]
    assert [e for e, _ in pinned_calls] == ["fpx_run_steps_baseline"]
    assert _build.SIGNATURES["pipeline"]["fpx_run_steps"] is _build._B
    assert _build.SIGNATURES["pipeline_baseline"][
        "fpx_run_steps_baseline"] is _build._B
    (_, la), (_, pa) = live_calls[0], pinned_calls[0]
    assert len(la) == len(pa) == 24
    assert _scalars(la) == _scalars(pa) == \
        [1 << 10, 128, 5, 8, 3, 1, 1, 0, 0, 0, 0, 0, -1, 0]
    assert all(la[k] and pa[k] for k in _POINTER_SLOTS)
    assert tp.steady_state_step.launches == 1
    assert tp.steady_state_step.drains == 8
    assert tpin.steady_state_step.launches == 1
    assert tpin.steady_state_step.drains == 8
    assert tp.telemetry_drain.launches == tp.telemetry_drain.drains == 0
    # A run over the cap: launches of at most MAX_DRAINS drains, the
    # index wrapping as int32 between them, in both modules alike.
    for module in (tp, tpin):
        monkeypatch.setattr(module, "MAX_DRAINS", 3)
    recorder.calls.clear()
    tp.run_steps_from(tp.make_state(1 << 10, 3, device="cpu"),
                      2**31 - 4, 8, 128, *statics)
    live_calls = list(recorder.calls)
    recorder.calls.clear()
    tpin.run_steps_from(tpin.make_state(1 << 10, 3, device="cpu"),
                        2**31 - 4, 8, 128, *statics)
    runs = [(a[9], a[10]) for _, a in live_calls]
    assert runs == [(2**31 - 4, 3), (2**31 - 1, 3), (-2**31 + 2, 2)]
    assert runs == [(a[9], a[10]) for _, a in recorder.calls]
    assert tp.steady_state_step.launches == 4
    assert tp.steady_state_step.drains == 16
    assert tpin.steady_state_step.launches == 4
    monkeypatch.undo()

    live = tp.run_steps_from(tp.make_state(1 << 10, 3, device="cpu"), 5, 8,
                             128, *statics)
    pinned = tpin.run_steps_from(tpin.make_state(1 << 10, 3, device="cpu"),
                                 5, 8, 128, *statics)
    assert int(live.committed) > 0
    _assert_bit_identical(live, pinned)


def test_telemetry_kernel_path_arguments(monkeypatch):
    """K14's wrapper passes K3's block plus the flat buffer and a scratch
    array of at least ``iters`` zeroed int32, in ONE call per run;
    counts one launch of 3 drains and none on K3's counts; a single
    drain is a run of one."""
    recorder = _force_kernel_path(monkeypatch)
    state = tp.make_state(1 << 10, 3, telemetry=True, device="cpu")
    tp.run_steps_from(state, 0, 3, 128, *_statics(SPECS["majority3"]))
    entries = [e for e, _ in recorder.calls]
    assert entries == ["fpx_run_steps_telemetry"]
    assert _build.SIGNATURES["pipeline"]["fpx_run_steps_telemetry"] is \
        _build._B
    args = recorder.calls[-1][1]
    assert len(args) == 24
    assert args[20] == state.telemetry.buffer.data_ptr()
    scratch = next(t for t in tp._SCRATCH.values()
                   if t.data_ptr() == args[21])
    assert scratch.dtype == torch.int32 and scratch.numel() >= 3
    assert not scratch.any()
    assert _scalars(args)[:4] == [1 << 10, 128, 0, 3]
    assert tp.telemetry_drain.launches == 1
    assert tp.telemetry_drain.drains == 3
    assert tp.steady_state_step.launches == tp.steady_state_step.drains == 0
    tp.steady_state_step(state, 9, block_size=128,
                         predicate=_pred(SPECS["majority3"]))
    assert recorder.calls[-1][1][9:11] == (9, 1)
    assert tp.telemetry_drain.launches == 2
    assert tp.telemetry_drain.drains == 4


def test_collect_off_state_returns_none():
    state = tp.make_state(1 << 8, 3, telemetry=False, device="cpu")
    assert tobs.collect(state) is None


def test_snapshot_delta_and_skew():
    a = tobs.TelemetrySnapshot(drains=4, proposed=400,
                               shard_committed=(100, 98),
                               occupancy=(0, 198),
                               lag_hist=(4,) + (0,) * 15, pad_lanes=8)
    b = tobs.TelemetrySnapshot(drains=6, proposed=600,
                               shard_committed=(151, 147),
                               occupancy=(0, 298),
                               lag_hist=(6,) + (0,) * 15, pad_lanes=12)
    d = b.delta(a)
    assert d.drains == 2 and d.proposed == 200
    assert d.shard_committed == (51, 49)
    assert b.committed == 298
    assert b.shard_skew() == pytest.approx(151 / 149)
    assert b.batch_fill(100) == pytest.approx(1.0)
    assert tobs.TelemetrySnapshot.from_json(b.to_json()) == b


def test_lag_bucket_bounds_shape():
    bounds = ttel.lag_bucket_bounds()
    assert bounds.shape == (ttel.LAG_BUCKETS,)
    assert bounds[0] == 0 and bounds[1] == 1
    assert all(int(b) == 2 ** (i - 1) for i, b in enumerate(bounds[1:], 1))
    np.testing.assert_array_equal(bounds, jtel.lag_bucket_bounds())


def test_make_telemetry_zeroed():
    tel = ttel.make_telemetry(num_acceptors=5, slot_shards=3, device="cpu")
    assert tel.shard_committed.shape == (3,)
    assert int(sum(np.asarray(leaf).sum() for leaf in tel)) == 0
    # One flat int32 buffer: the six counters and the scratch word.
    assert tel.buffer.numel() == 3 + 1 + 6 + 16 + 1 + 1 + 1
    assert ttel.flat_buffer(tel) is tel.buffer
    tel.lag_hist[3] += 1
    assert int(tel.buffer[3 + 1 + 6 + 3]) == 1


# --- (b) parity with the JAX package ---------------------------------------


@functools.cache
def _jax_step(name: str, block_size: int):
    masks, thresholds, combine_any = SPECS[name].as_arrays()
    return jax.jit(functools.partial(
        jp.steady_state_step, block_size=block_size, masks=masks,
        thresholds=thresholds, combine_any=combine_any))


def _assert_same_state(port_state, ref_state, where=""):
    """Every field, the six counters included, bit for bit."""
    got = convert.pipeline_state_to_numpy(port_state)
    want = jax.device_get(ref_state)
    for name in tp.PipelineState._fields[:7]:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{name} {where}")
    for name in ttel.FIELDS:
        a = getattr(got.telemetry, name)
        b = np.asarray(getattr(want.telemetry, name))
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {where}")


@pytest.mark.parametrize("ratio", [1, 2, 8])
@pytest.mark.parametrize("name", list(SPECS))
def test_counters_match_reference_every_drain(name, ratio):
    """window / block in {1, 2, 8}: at 1 and 2 the new, old and GC
    blocks alias; the counters equal JAX's telemetry-on drain after
    every drain."""
    spec = SPECS[name]
    block, n = 128, spec.num_nodes
    ref_state = jp.make_state(block * ratio, n, telemetry=True)
    state = tp.make_state(block * ratio, n, telemetry=True, device="cpu")
    step, pred = _jax_step(name, block), _pred(spec)
    for i in range(10):
        ref_state = step(ref_state, jnp.int32(i))
        tp.steady_state_step(state, i, block_size=block, predicate=pred)
        _assert_same_state(state, ref_state, f"after drain {i}")
    assert int(state.telemetry.drains) == 10
    assert int(state.telemetry.occupancy.sum()) == int(state.committed)


@pytest.mark.parametrize("start", [2**31 - 40, 2**23 - 6])
@pytest.mark.parametrize("name", list(SPECS))
def test_counters_match_reference_near_int32_wrap(name, start):
    """12 drains (``run_steps_from`` on both sides) from 2^31 - 40, where
    ``(i + 1) * block`` has wrapped to a small negative number (every lag
    negative: bucket 0), and from 2^23 - 6, where it crosses 2^31
    mid-run (lags near 2^31 before, and after the wrap -2^31 minus
    ``committed``, which wraps back positive: the last bucket)."""
    spec = SPECS[name]
    statics = _statics(spec)
    ref_state = jp.run_steps_from(
        jp.make_state(1024, spec.num_nodes, telemetry=True),
        jnp.int32(start), 12, 256, *statics)
    state = tp.run_steps_from(
        tp.make_state(1024, spec.num_nodes, telemetry=True, device="cpu"),
        start, 12, 256, *statics)
    _assert_same_state(state, ref_state)
    assert int(state.telemetry.drains) == 12
    assert state.telemetry.lag_hist[15 if start < 2**23 else 0] == 12


@pytest.mark.parametrize("name", list(SPECS))
def test_counters_match_reference_up_to_int32_max(name):
    """Drain by drain up to i = INT32_MAX, where ``i + 1`` wraps (JAX's
    ``run_steps_from`` cannot end there: its loop bound would wrap)."""
    spec = SPECS[name]
    ref_state = jp.make_state(1024, spec.num_nodes, telemetry=True)
    state = tp.make_state(1024, spec.num_nodes, telemetry=True,
                          device="cpu")
    step, pred = _jax_step(name, 256), _pred(spec)
    for i in range(2**31 - 6, 2**31):
        ref_state = step(ref_state, jnp.int32(i))
        tp.steady_state_step(state, i, block_size=256, predicate=pred)
        _assert_same_state(state, ref_state, f"after drain {i}")


LAGS = [-2**31, -1, 0, 1, 2, 3, 4, 5, 2**14 - 1, 2**14, 2**14 + 1,
        2**31 - 1]


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


@pytest.mark.parametrize("start", [0, 2**31 - 5])
@pytest.mark.parametrize("ratio", [1, 2, 3, 8])
@pytest.mark.parametrize("chunk", [1, 2, 3, 17])
def test_run_chunks_counters_match_reference(chunk, ratio, start):
    """Telemetry on, ``run_steps_from`` on CPU tensors (the plain version
    of one K14 launch, its lags folded at the end of the run by
    ``fold_lag_plain``) against JAX's, every field and counter bit for
    bit, after a chunk and after a second that resumes it: chunks of 1,
    2, 3 and 17 drains, window / block 1, 2, 3 and 8, from 0 and from
    2^31 - 5 (17 drains wrap int32)."""
    name = "majority3" if ratio % 2 else "grid2x3"
    block, n = 128, SPECS[name].num_nodes
    ref_state = jp.make_state(block * ratio, n, telemetry=True)
    state = tp.make_state(block * ratio, n, telemetry=True, device="cpu")
    at = start
    for _ in range(2):
        ref_state = _jax_run(ref_state, name, at, chunk, block)
        tp.run_steps_from(state, at, chunk, block, *_statics(SPECS[name]))
        _assert_same_state(state, ref_state, f"after the chunk from {at}")
        at = tp._wrap32(at + chunk)
    assert int(state.telemetry.drains) == 2 * chunk


@pytest.mark.parametrize("start", [0, 2**31 - 5])
def test_telemetry_two_chunks_equal_one_long_chunk(start):
    """With the counters: 7 drains then 10 equal 17 in one run, and
    JAX's 17."""
    name, block = "grid2x3", 256
    statics = _statics(SPECS[name])
    ref_state = _jax_run(jp.make_state(1024, 6, telemetry=True), name,
                         start, 17, block)
    one = tp.run_steps_from(
        tp.make_state(1024, 6, telemetry=True, device="cpu"), start, 17,
        block, *statics)
    two = tp.make_state(1024, 6, telemetry=True, device="cpu")
    tp.run_steps_from(two, start, 7, block, *statics)
    tp.run_steps_from(two, tp._wrap32(start + 7), 10, block, *statics)
    _assert_same_state(one, ref_state)
    _assert_same_state(two, ref_state)


def test_run_with_committed_crossing_int32_matches_reference():
    """A JAX state whose committed is 2^31 - 2000 carried into the port:
    17 telemetry-on drains in one run from 2^24 - 8, where both the
    end-of-drain committed and ``(i + 1) * block`` cross 2^31 mid-run
    (the fold recovers the run's start mod 2^32 and its prefix sums
    wrap): the lags equal JAX's drain-by-drain ones, about 1000 each
    (bucket 10 or 11), not the bucket 0 a lag off by 2^32 would give."""
    name, block = "majority3", 128
    ref_state = jp.make_state(512, 3, telemetry=True)
    ref_state = ref_state._replace(committed=jnp.int32(2**31 - 2000))
    state = convert.pipeline_state_from_numpy(jax.device_get(ref_state),
                                              device="cpu")
    start = 2**24 - 8
    ref_state = _jax_run(ref_state, name, start, 17, block)
    tp.run_steps_from(state, start, 17, block, *_statics(SPECS[name]))
    _assert_same_state(state, ref_state)
    assert int(state.committed) < 0  # wrapped
    assert int(state.telemetry.lag_hist[10:12].sum()) == 17


@pytest.mark.parametrize("seed", range(2))
def test_fold_lag_matches_reference_drain_by_drain(seed):
    """``fold_lag_plain`` (one fold of a run's per-drain newly counts)
    against JAX's ``drain_update`` applied drain by drain with the
    end-of-drain lag: the run's start near 2^31 (the index wraps), the
    committed count crossing 2^31, counts from 0 to 2^20."""
    rng = np.random.default_rng(seed)
    iters, block = 40, 1 << 12
    start = 2**31 - 17
    newly = rng.integers(0, 1 << 20, size=iters).astype(np.int32)
    first = np.int64(2**31 - 3 * (1 << 19))
    committed = first
    jax_tel = jtel.make_telemetry(3)
    zeros = jnp.zeros(4, jnp.int32)
    for k in range(iters):
        committed = committed + np.int64(newly[k])
        i = tp._wrap32(start + k)
        lag = tp._wrap32((i + 1) * block - tp._wrap32(int(committed)))
        jax_tel = jtel.drain_update(jax_tel, proposed_block=zeros,
                                    lane_valid=None, lag=jnp.int32(lag),
                                    slot_axis=None)
    tel = ttel.make_telemetry(3, device="cpu")
    final = torch.tensor(tp._wrap32(int(committed)), dtype=torch.int32)
    tp.fold_lag_plain(tel, final, torch.from_numpy(newly), start, block)
    _assert_tel_equal(tel, jax_tel)
    assert int(tel.drains) == iters


def test_lag_bucket_matches_reference():
    for lag in LAGS:
        got = ttel.lag_bucket(torch.tensor(lag, dtype=torch.int32))
        want = jtel.lag_bucket(jnp.int32(lag))
        assert got.dtype == torch.int32
        assert int(got) == int(want), lag
    assert int(ttel.lag_bucket(torch.tensor(-1, dtype=torch.int32))) == 0
    assert int(ttel.lag_bucket(torch.tensor(2**31 - 1,
                                            dtype=torch.int32))) == 15


def _both_tel(n, slot_shards=1):
    return (ttel.make_telemetry(n, slot_shards, device="cpu"),
            jtel.make_telemetry(n, slot_shards))


def _assert_tel_equal(port_tel, jax_tel):
    for name in ttel.FIELDS:
        np.testing.assert_array_equal(
            getattr(port_tel, name).numpy(),
            np.asarray(getattr(jax_tel, name)), err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_update_functions_match_reference(seed):
    """Vote counts outside [0, N] (negative, and above N as bytes other
    than 0/1 give) clip into the end bins; proposals with zeros; lags
    across every bucket."""
    rng = np.random.default_rng(seed)
    n, b = 3, 257
    tel, jtel_state = _both_tel(n)
    for _ in range(4):
        counts = rng.integers(-5, 3 * 255, size=b).astype(np.int32)
        newly = rng.random(b) < 0.6
        ttel.quorum_pass_update(tel, votes_count=torch.from_numpy(counts),
                                newly=torch.from_numpy(newly),
                                slot_axis=None)
        jtel_state = jtel.quorum_pass_update(
            jtel_state, votes_count=jnp.asarray(counts),
            newly=jnp.asarray(newly), slot_axis=None)
        proposed = rng.integers(-2, 3, size=b).astype(np.int32)
        lag = np.int32(rng.choice(LAGS))
        valid = None if seed == 0 else rng.random(b) < 0.9
        ttel.drain_update(tel, proposed_block=torch.from_numpy(proposed),
                          lane_valid=(None if valid is None
                                      else torch.from_numpy(valid)),
                          lag=torch.tensor(lag), slot_axis=None)
        jtel_state = jtel.drain_update(
            jtel_state, proposed_block=jnp.asarray(proposed),
            lane_valid=None if valid is None else jnp.asarray(valid),
            lag=jnp.int32(lag), slot_axis=None)
        _assert_tel_equal(tel, jtel_state)
    assert ttel.quorum_pass_update(None, votes_count=None, newly=None,
                                   slot_axis=None) is None
    assert ttel.drain_update(None, proposed_block=None, lane_valid=None,
                             lag=None, slot_axis=None) is None


def test_sharded_telemetry_is_refused():
    """The slot axis is the mesh's ``SlotAxis`` (the sharded updates run
    in ``tests/test_torch_multichip_telemetry.py``): the reference's axis
    NAME is refused here, and the unsharded drain refuses counters over
    several slot shards, which are the sharded drain's."""
    tel = ttel.make_telemetry(3, device="cpu")
    with pytest.raises(TypeError, match="SlotAxis"):
        ttel.quorum_pass_update(
            tel, votes_count=torch.zeros(4, dtype=torch.int32),
            newly=torch.zeros(4, dtype=torch.bool), slot_axis="slot")
    with pytest.raises(TypeError, match="SlotAxis"):
        ttel.drain_update(tel, proposed_block=torch.zeros(4),
                          lane_valid=None, lag=torch.tensor(0),
                          slot_axis="slot")
    two = tp.make_state(512, 3, telemetry=True, slot_shards=2, device="cpu")
    assert two.telemetry.shard_committed.shape == (2,)
    # A carried-in state over two shards is refused by the drain.
    state = tp.make_state(512, 3, device="cpu")._replace(
        telemetry=ttel.make_telemetry(3, 2, device="cpu"))
    with pytest.raises(ValueError, match="make_sharded_step"):
        tp.steady_state_step(state, 0, block_size=256,
                             predicate=_pred(SPECS["majority3"]))
    # Counters for another acceptor count are refused by the drain.
    state = tp.make_state(512, 3, device="cpu")._replace(
        telemetry=ttel.make_telemetry(5, device="cpu"))
    with pytest.raises(ValueError, match="3 acceptors"):
        tp.steady_state_step(state, 0, block_size=256,
                             predicate=_pred(SPECS["majority3"]))
    # Counters that are not views of one flat buffer are refused.
    loose = ttel.TelemetryState(*(t.clone() for t in
                                  ttel.make_telemetry(3, device="cpu")))
    with pytest.raises(ValueError, match="buffer"):
        tobs.collect(loose)


def test_carry_telemetry_state_across_from_jax():
    """5 telemetry-on drains in JAX, the state (counters included) moved
    into the port, 5 more on each side: identical; and back to numpy."""
    name, window, block = "grid2x3", 2048, 256
    step = _jax_step(name, block)
    ref_state = jp.make_state(window, 6, telemetry=True)
    for i in range(5):
        ref_state = step(ref_state, jnp.int32(i))
    state = convert.pipeline_state_from_numpy(jax.device_get(ref_state),
                                              device="cpu")
    assert ttel.flat_buffer(state.telemetry) is state.telemetry.buffer
    _assert_same_state(state, ref_state)
    pred = _pred(SPECS[name])
    for i in range(5, 10):
        ref_state = step(ref_state, jnp.int32(i))
        tp.steady_state_step(state, i, block_size=block, predicate=pred)
    _assert_same_state(state, ref_state)
    bad = jax.device_get(ref_state)
    with pytest.raises(ValueError, match="int32"):
        convert.pipeline_state_from_numpy(bad._replace(
            telemetry=bad.telemetry._replace(
                drains=np.int64(0))), device="cpu")


# --- the reporter -----------------------------------------------------------


def _snapshot_pairs():
    """The same three cumulative snapshots in both packages."""
    port, ref = [], []
    for k in range(1, 4):
        fields = dict(drains=2 * k, proposed=200 * k,
                      shard_committed=(100 * k - k,),
                      occupancy=(0, k, 2 * k, 100 * k - 4 * k),
                      lag_hist=(2 * k,) + (0,) * 15, pad_lanes=0)
        port.append(tobs.TelemetrySnapshot(**fields))
        ref.append(jobs.TelemetrySnapshot(**fields))
    return port, ref


class _Metrics:
    """A stand-in metrics sink recording each interval."""

    def __init__(self):
        self.intervals = []

    def pipeline_interval(self, **kwargs):
        self.intervals.append(kwargs)


def test_reporter_summary_and_counter_events_match_reference():
    port, ref = _snapshot_pairs()
    events_t = tobs.counter_events(list(zip((0.5, 1.0, 1.5), port)), "p0")
    events_j = jobs.counter_events(list(zip((0.5, 1.0, 1.5), ref)), "p0")
    assert events_t == events_j
    rep_t = tobs.TelemetryReporter("p0", block_size=100)
    rep_j = jobs.TelemetryReporter("p0", block_size=100)
    assert rep_t.summary() == rep_j.summary()
    for snap_t, snap_j in zip(port, ref):
        rep_t._prev, rep_j._prev = snap_t, snap_j
        assert rep_t.summary() == rep_j.summary()
    metrics_t, metrics_j = _Metrics(), _Metrics()
    tobs.publish(metrics_t, port[2], port[1], 100)
    jobs.publish(metrics_j, ref[2], ref[1], 100)
    assert metrics_t.intervals == metrics_j.intervals


def test_reporter_collects_publishes_and_dumps(tmp_path):
    metrics = _Metrics()
    reporter = tobs.TelemetryReporter("pipeline_0", metrics=metrics,
                                      block_size=64)
    state = tp.make_state(512, 3, telemetry=True, device="cpu")
    pred = _pred(SPECS["majority3"])
    for i in range(6):
        tp.steady_state_step(state, i, block_size=64, predicate=pred)
        if i % 3 == 2:
            reporter.collect(state, t=float(i))
    assert [m["drains"] for m in metrics.intervals] == [3, 3]
    assert sum(m["committed"] for m in metrics.intervals) == 6 * 64
    assert reporter.summary()["batch_fill"] == 1.0
    assert len(reporter.counter_events()) == 4
    path = tmp_path / "p.counters.jsonl"
    reporter.dump(str(path))
    loaded = tobs.load_counters(str(path))
    assert loaded == [(t, "pipeline_0", s) for t, s in reporter.samples]
    # A torn final line is dropped, the rest survives; the JAX loader
    # reads the port's dump the same way.
    with open(path, "a") as f:
        f.write('{"t": 9.0, "role": "pipeline_0", "snaps')
    assert tobs.load_counters(str(path)) == loaded
    assert [(t, r, s.to_json()) for t, r, s in
            jobs.load_counters(str(path))] == \
        [(t, r, s.to_json()) for t, r, s in loaded]
    off = tobs.TelemetryReporter("x")
    assert off.collect(tp.make_state(256, 3, device="cpu"), 0.0) is None
    assert off.summary() == {"role": "x", "collected": False}


# --- (c) the benches ---------------------------------------------------------

#: The keys of the reference's artifact (bench/telemetry_overhead.py).
OVERHEAD_KEYS = {"benchmark", "host_cpus", "smoke", "pairs",
                 "off_overhead_pct_worst_width",
                 "on_overhead_pct_worst_width", "gate", "gate_passed",
                 "methodology"}
PAIR_KEYS = {"window", "block", "blocks", "drains_per_chunk", "arms_agree",
             "baseline_cmds_per_sec_med", "off_cmds_per_sec_med",
             "on_cmds_per_sec_med", "off_over_baseline_ratio",
             "off_over_baseline_ratio_range", "on_over_off_ratio",
             "on_over_off_ratio_range"}


def test_overhead_twin_runs_small_on_cpu():
    knobs = {"warmup": 1, "chunks": 2, "iters": 4, "blocks": 2}
    result = tover.run("cpu", widths=((512, 64), (512, 128)), knobs=knobs)
    assert OVERHEAD_KEYS <= set(result)
    assert set(result["pairs"]) == {"64", "128"}
    for row in result["pairs"].values():
        assert PAIR_KEYS <= set(row)
        assert row["arms_agree"] is True
    block = tover.measure_ab_block(512, 64, warmup=0, chunks=1, iters=3,
                                   device="cpu")
    assert block["arms_agree"] and block["committed"] > 5 * 64
    json.dumps(result)


def test_overhead_twin_main_writes_the_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(tover, "SMOKE_KNOBS",
                        {"warmup": 0, "chunks": 1, "iters": 2, "blocks": 1})
    monkeypatch.setattr(tover, "WIDTHS", ((256, 64), (512, 64)))
    out = tmp_path / "overhead.json"
    assert tover.main(["--smoke", "--device", "cpu", "--out",
                       str(out)]) == 0
    result = json.loads(out.read_text())
    assert result["smoke"] is True and set(result["pairs"]) == {"64"}


def test_libbench_twin_runs_small_on_cpu():
    """The artifact has the reference's keys, down to each row's; the
    reference's rows come from its own functions at tiny sizes."""
    from frankenpaxos_tpu.bench import libbench as jlib

    result = tlib.run("cpu", map_ops=500, set_ops=500, graph_ops=200,
                      batch=64, iters=2, serializer_ops=200)
    assert {"benchmark", "buffer_map", "int_prefix_set", "depgraph",
            "device_ops", "serializer"} <= set(result)
    assert set(result["buffer_map"]) == set(jlib.bench_buffer_map(50))
    assert set(result["int_prefix_set"]) == \
        set(jlib.bench_int_prefix_set(50))
    assert set(result["depgraph"]) == set(jlib.bench_depgraphs(40))
    assert set(jlib.bench_device_ops(batch=64, iters=1)) <= \
        set(result["device_ops"])
    assert result["device_ops"]["device"] == "cpu"
    assert set(result["serializer"]) == set(jlib.bench_serializer(50))
    assert all(rate > 0 for rate in result["serializer"].values())


def test_benches_refuse_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tover.run(smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tover.measure_width(256, 64, tover.SMOKE_KNOBS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlib.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlib.bench_device_ops()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttel.make_telemetry(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpin.make_state(256, 3)
