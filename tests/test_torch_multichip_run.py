"""The port's sharded RUN against the JAX package's, on the CPU.

``make_sharded_runner`` does, for each drain of a run, K19, the group
all-reduce and K20 into the drain's row of the plan's slot table, then
ONE slot all-reduce of the used rows and ONE K21 fold a run (a table of
``RUN_ROWS`` drains). Its plain phases run here over a gloo world of
spawned CPU ranks (``bench/multichip.py``) and must equal the JAX
package's ``make_sharded_runner`` (its per-drain psums inside one
``fori_loop``; drain by drain through ``make_sharded_step`` where a run
crosses the int32 wrap of the drain index, as the reference's loop bound
would wrap) on EVERY leaf of the gathered state, bit for bit: the
telemetry buffer's lag histogram and drain count included. The inputs
are the reference's arrival hash and, for the fold's own checks, tables
made by numpy from a seed.
"""

from frankenpaxos_tpu_torch.bench import multichip, pipeline as tp
from frankenpaxos_tpu_torch.mesh import Mesh as TorchMesh
from frankenpaxos_tpu_torch.ops.quorum import make_predicate
from frankenpaxos_tpu_torch.ops.telemetry import make_telemetry
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
SEED = 20261018
WRAP = 2**31


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(8, device_type="cpu") as w:
        yield w


@pytest.fixture(autouse=True)
def _devices(need_8_devices):
    """The JAX side needs the shared 8-device mesh (conftest.py)."""


def _spec(name: str, n: int) -> tuple:
    if name == "grid":
        spec = Grid(np.arange(n).reshape(2, n // 2).tolist()).write_spec()
    else:
        spec = SimpleMajority(range(n)).write_spec()
    return spec.as_arrays()


def _plain(spec) -> tuple:
    masks, thresholds, combine_any = spec
    return (np.asarray(masks).tolist(), np.asarray(thresholds).tolist(),
            bool(combine_any))


def _jax_mesh(group, slot):
    devices = np.asarray(jax.devices()[:group * slot])
    return Mesh(devices.reshape(group, slot), ("group", "slot"))


def _jax_drains(group, slot, n, window, block, spec, start, drains,
                telemetry, state=None, per_run=None):
    """The reference's sharded state after ``drains`` drains from
    ``start``: its runner in runs of ``per_run`` (a run that would cross
    the int32 wrap drain by drain through its step), or its step alone
    when ``per_run`` is None."""
    mesh = _jax_mesh(group, slot)
    masks, thresholds, combine_any = spec
    kw = dict(block_size=block, masks=masks, thresholds=thresholds,
              combine_any=combine_any, telemetry=telemetry)
    step, sharding = jp.make_sharded_step(mesh, **kw)
    if state is None:
        state, _, _ = jp.make_sharded_state(mesh, window, block, n,
                                            telemetry=telemetry)
    else:
        state = jax.device_put(state, sharding)
    runner = None if per_run is None else jp.make_sharded_runner(
        mesh, iters=per_run, **kw)[0]
    at, left = start, drains
    while left > 0:
        if runner is not None and left >= per_run \
                and at + per_run - 1 < WRAP:
            state = runner(state, jnp.int32(at))
            at, left = tp._wrap32(at + per_run), left - per_run
        else:
            state = step(state, jnp.int32(at))
            at, left = tp._wrap32(at + 1), left - 1
    return jax.device_get(state)


def _gathered(ref) -> dict:
    out = {name: np.asarray(getattr(ref, name)) for name in FIELDS}
    out["telemetry"] = None if ref.telemetry is None else {
        name: np.asarray(v) for name, v in
        zip(ref.telemetry._fields, ref.telemetry)}
    return out


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


#: (mesh, spec, acceptors, window, block, first drain, runs, drains a
#: run, telemetry, drains the reference runs before the port resumes).
RUN_CASES = {
    "1x2 majority, one run of 8, ring of 16": (
        (1, 2), "majority", 3, 1024, 64, 0, 1, 8, True, 0),
    "2x2 grid rows, three runs of 3, ring of 16": (
        (2, 2), "grid", 6, 1024, 64, 0, 3, 3, True, 0),
    "2x1 grid rows, runs of 1, ring of 1": (
        (2, 1), "grid", 6, 64, 64, 0, 5, 1, True, 0),
    "1x3 non-divisible, runs of 8, ring of 2": (
        (1, 3), "majority", 3, 200, 100, 0, 2, 8, True, 0),
    "1x3 non-divisible, runs of 3 across the int32 wrap": (
        (1, 3), "majority", 3, 400, 100, WRAP - 5, 3, 3, True, 0),
    "2x2 majority of 4, runs of 8 across the wrap, ring of 2": (
        (2, 2), "majority", 4, 128, 64, WRAP - 6, 2, 8, False, 0),
    "1x2 majority, one run past the table's cap": (
        (1, 2), "majority", 3, 256, 16, 0, 1, tp.RUN_ROWS + 5, True, 0),
    "2x2 grid rows, resumed mid-ring from a JAX state": (
        (2, 2), "grid", 6, 1024, 64, 5, 2, 4, True, 5),
    "2x1 majority of 4, resumed mid-ring, ring of 2": (
        (2, 1), "majority", 4, 128, 64, 3, 2, 8, False, 3),
    "1x2 whole grid, runs of 3, ring of 1": (
        (1, 2), "grid", 6, 64, 64, 0, 2, 3, False, 0),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_sharded_runner_matches_reference(world, case):
    """The port's runner (plain phases, gloo ranks) in ``runs`` runs of
    ``per_run`` drains equals the reference's runner leaf for leaf,
    telemetry counters included; a resumed case starts from the
    reference's state after its first drains, mid-ring."""
    ((group, slot), name, n, window, block, start, runs, per_run,
     telemetry, before) = RUN_CASES[case]
    spec = _spec(name, n)
    drains = runs * per_run
    init = mid = None
    if before:
        mid = _jax_drains(group, slot, n, window, block, spec, 0, before,
                          telemetry)
        init = _gathered(mid)
    port = world.call("drain", deadline_s=300, group=group, slot=slot,
                      window=window, block=block, spec=_plain(spec),
                      iters=drains, start=start, telemetry=telemetry,
                      chunk=per_run, init=init)[0]
    ref = _jax_drains(group, slot, n, window, block, spec, start, drains,
                      telemetry, state=mid, per_run=per_run)
    assert int(ref.committed) != 0 or start
    assert_same_leaves(port, ref)
    if telemetry:
        assert int(port["telemetry"]["drains"]) == before + drains
        assert int(port["telemetry"]["lag_hist"].sum()) == before + drains


def _random_plan(rng, telemetry: bool, slot: int = 3, n: int = 5):
    """A plan of slot shard 1 of a (1, ``slot``) mesh over ``n``
    acceptors with a table of random words (near the int32 wrap too)."""
    spec = SimpleMajority(range(n)).write_spec()
    pred = make_predicate(*spec.as_arrays(), device="cpu")
    mesh = TorchMesh(1, slot, 1, torch.device("cpu"))
    plan = tp.make_shard_plan(mesh, 100, pred, telemetry=telemetry)
    words = plan.slot.shape[1]
    table = rng.integers(-2**31, 2**31, size=(tp.RUN_ROWS, words),
                         dtype=np.int64)
    small = rng.integers(0, 40, size=(tp.RUN_ROWS, words))
    table = np.where(rng.random((tp.RUN_ROWS, words)) < 0.5, table, small)
    plan.slot.copy_(torch.from_numpy(table.astype(np.int32)))
    state, _ = tp.make_sharded_state(mesh, 600, 100, n, telemetry=telemetry,
                                     device="cpu")
    state.committed.fill_(2**31 - 7)
    state.sm_state.fill_(-5)
    if telemetry:
        state.telemetry.buffer.copy_(torch.from_numpy(rng.integers(
            0, 1000, size=state.telemetry.buffer.numel()).astype(np.int32)))
    return mesh, plan, state


def _clone(state, plan):
    tel = state.telemetry
    copy = state._replace(**{name: getattr(state, name).clone()
                             for name in FIELDS})
    if tel is not None:
        copy = copy._replace(telemetry=make_telemetry(
            tel.occupancy.numel() - 1, tel.shard_committed.numel(),
            device="cpu"))
        copy.telemetry.buffer.copy_(tel.buffer)
    return copy, plan._replace(slot=plan.slot.clone())


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("k", [1, 8, 64, tp.RUN_ROWS])
@pytest.mark.parametrize("start", [0, WRAP - 20])
def test_run_fold_equals_one_drain_folds(telemetry, k, start):
    """The plain K21 over ``k`` rows of a run equals ``k`` one-drain
    folds, each of its row moved to row 0 in drain order: the scalars,
    exec_wm (the last drain's), every telemetry counter (each drain's lag
    bucket from its end-of-drain committed, ``drains`` + k) and the
    zeroed rows; tables of random words, committed and the drain index
    across the int32 wrap."""
    rng = np.random.default_rng(SEED + k + (start > 0))
    _, plan, state = _random_plan(rng, telemetry)
    run_state, run_plan = _clone(state, plan)
    tp.shard_fold_plain(run_state, start, run_plan, k)
    for d in range(k):
        plan.slot[0].copy_(plan.slot[d])
        if d:
            plan.slot[d].zero_()
        tp.shard_fold_plain(state, tp._wrap32(start + d), plan)
    for name in FIELDS:
        assert torch.equal(getattr(run_state, name), getattr(state, name)), \
            name
    if telemetry:
        assert torch.equal(run_state.telemetry.buffer,
                           state.telemetry.buffer)
    assert not run_plan.slot[:k].any()
    assert torch.equal(run_plan.slot[k:], plan.slot[k:])
    last = tp._wrap32(start + k - 1)
    assert int(state.exec_wm) == (tp._wrap32(last * 100) if last >= 1
                                  else 0)


class _CountingMesh(TorchMesh):
    """A mesh of no process groups whose all-reduces only count and
    record the rows they carry (in ``calls``)."""

    def psum_group(self, tensor):
        self.calls.append(("group", tuple(tensor.shape)))
        return tensor

    def psum_slot(self, tensor):
        self.calls.append(("slot", tuple(tensor.shape)))
        return tensor


class _NullLibrary:
    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)
        return lambda block: 0


@pytest.mark.parametrize("drains", [1, 8, tp.RUN_ROWS, tp.RUN_ROWS + 44])
def test_runner_reduces_the_slot_table_once_a_run(monkeypatch, drains):
    """With the kernel path forced on CPU state, a run of ``drains``
    drains launches K19 and K20 once a drain (K20 into rows 0, 1, ...),
    and does ONE slot all-reduce of the used rows and ONE K21 per full
    table and at its end; the group all-reduce stays one a drain. A
    single drain (``sharded_step``) is the run of one."""
    monkeypatch.setattr(tp, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tp._build, "packed_library",
                        lambda name, keep_gil: _NullLibrary())
    monkeypatch.setattr(tp._build, "stream_handle", lambda index: 0)
    rows = []
    for entry in (tp._K19, tp._K20, tp._K21):
        monkeypatch.setattr(entry, "fn", None)
    for wrapper in (tp.shard_vote_count, tp.shard_commit, tp.shard_fold):
        monkeypatch.setattr(wrapper, "launches", 0)
    commit = tp.shard_commit

    def recording_commit(state, i, plan, row=0):
        rows.append(row)
        return commit(state, i, plan, row)

    monkeypatch.setattr(tp, "_KERNELS", (tp.shard_vote_count,
                                         recording_commit, tp.shard_fold))
    grid = Grid([[0, 1, 2], [3, 4, 5]]).write_spec()
    pred = make_predicate(*grid.as_arrays(), device="cpu")
    mesh = _CountingMesh(2, 2, 3, torch.device("cpu"))
    mesh.calls = []
    state, _ = tp.make_sharded_state(mesh, 512, 128, 6, telemetry=True)
    plan = tp.make_shard_plan(mesh, 128, pred, telemetry=True)
    assert tp.sharded_run(mesh, state, WRAP - 3, drains, plan) is state
    full, rest = divmod(drains, tp.RUN_ROWS)
    tables = [tp.RUN_ROWS] * full + ([rest] if rest else [])
    words = plan.slot.shape[1]
    want = []
    for k in tables:
        want += [("group", tuple(plan.parts.shape))] * k
        want.append(("slot", (k, words)))
    assert mesh.calls == want
    assert rows == [r for k in tables for r in range(k)]
    assert (tp.shard_vote_count.launches, tp.shard_commit.launches,
            tp.shard_fold.launches) == (drains, drains, len(tables))
    mesh.calls.clear()
    tp.sharded_step(mesh, state, 7, plan)
    assert mesh.calls == [("group", tuple(plan.parts.shape)),
                          ("slot", (1, words))]
    assert tp.shard_fold.launches == len(tables) + 1


def test_fold_and_row_bounds():
    """A fold takes 1 to ``RUN_ROWS`` rows and K20 a row of the table;
    anything else raises before a launch."""
    rng = np.random.default_rng(SEED)
    mesh, plan, state = _random_plan(rng, False)
    for k in (0, tp.RUN_ROWS + 1):
        with pytest.raises(ValueError, match="rows"):
            tp.shard_fold_plain(state, 0, plan, k)
    with pytest.raises(ValueError, match="row"):
        tp.shard_commit_plain(state, 0, plan, tp.RUN_ROWS)
    with pytest.raises(ValueError, match="iters"):
        tp.sharded_run(mesh, state, 0, -1, plan)
