"""The K8 and K7 call paths of the port on the CPU: the Leader's staged
recovery call (``ops/value.py::recovery_matrices`` /
``safe_values_staged``), K8's lean tensor entry, and K7's packed entry
that carries its map, against the JAX package.

The C entries run only on the card (``chip_smoke.py`` phases 9 and 10
hold them against the plain versions). Here each packed call is taken
with a stand-in for its ``ctypes`` function that reads the packed block
as the C entry does (the slot count of its ``long long a[N]`` read from
the source), computes the kernel's function with numpy at the pointers
the block names, and writes the result where the kernel would; so the
block's layout, offsets, prefill and launch counts are checked, and the
results are held bit-identical to the JAX package's.
"""

import ctypes
import os
import random
import re
import struct

from frankenpaxos_tpu_torch.ops import _build, quorum as tq, value as tv
from frankenpaxos_tpu_torch.protocols.multipaxos import messages as tm
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
from frankenpaxos_tpu_torch.protocols.multipaxos.leader import _Phase1
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import quorum as jq, value as jv
from frankenpaxos_tpu.protocols.multipaxos import messages as jm
from frankenpaxos_tpu.protocols.multipaxos.leader import _Phase1 as _JPhase1
from tests.protocols import multipaxos_harness as jh

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _c_slots(source: str, entry: str) -> int:
    """The int64 slots the C entry ``entry`` of ``csrc/<source>.cu``
    copies out of its packed block (``long long a[N]``)."""
    with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
        text = f.read()
    body = text[text.index(f'extern "C" int {entry}('):]
    return int(re.search(r"long long a\[(\d+)\]", body).group(1))


def _map_max() -> int:
    """``kMapMax`` of ``csrc/epoch.cu``: the longest map K7's packed block
    carries, which ``fpx_reshape_columns_map_max`` reports."""
    with open(os.path.join(_build.CSRC, "epoch.cu")) as f:
        text = f.read()
    assert "fpx_reshape_columns_map_max() { return kMapMax; }" in text
    return int(re.search(r"constexpr int kMapMax = (\d+);", text).group(1))


MAP_MAX = _map_max()


def _int32_at(ptr: int, count: int) -> np.ndarray:
    """A numpy view of ``count`` int32 at ``ptr`` (memory the test owns
    for the duration of the call)."""
    if count == 0:
        return np.zeros(0, np.int32)
    return np.ctypeslib.as_array((ctypes.c_int32 * count).from_address(ptr))


class _FakeStaging:
    """Stands in for ``_build.Staging`` on the CPU: the same named pairs,
    grown to a power of two, a CPU tensor in place of each device buffer
    (none, and a device pointer of 0, where ``on_card`` is False)."""

    index, stream_handle = 0, 4242

    def __init__(self):
        self.pairs: dict = {}

    def pair(self, name, n, dtype, on_card=True):
        got = self.pairs.get(name)
        if got is None or got.cap < n:
            cap = 1 << max(5, (n - 1).bit_length())
            host = torch.empty(cap, dtype=dtype)
            dev = torch.empty(cap, dtype=dtype) if on_card else None
            got = self.pairs[name] = _build.Pair(
                cap, host.numpy(), host.data_ptr(),
                0 if dev is None else dev.data_ptr(), (host, dev))
        return got


class _K8Stand:
    """``fpx_safe_values_staged`` as the C entry computes it: the block's
    slots checked against the staging's pinned block (no device copy
    exists), K8 (the plain version) on the block's two matrices read in
    place, value_id then has_vote written after them."""

    def __init__(self, staging: _FakeStaging):
        self.staging, self.calls = staging, []

    def __call__(self, block: bytes) -> int:
        slots = _c_slots("value", "fpx_safe_values_staged")
        assert len(block) == 8 * slots
        a = struct.unpack(f"={slots}q", block)
        self.calls.append(a)
        rows, n = a[1], a[2]
        cells = self.staging.pairs["recovery"]
        assert a[0] == cells.host_ptr and cells.device_ptr == 0
        assert (a[3], a[4]) == (_FakeStaging.index,
                                _FakeStaging.stream_handle)
        assert 4 * cells.cap >= 4 * (2 * rows * n + rows) + rows
        rounds = _int32_at(a[0], rows * n).reshape(rows, n)
        ids = _int32_at(a[0] + 4 * rows * n, rows * n).reshape(rows, n)
        has_vote, value_id = jv.safe_values(rounds.copy(), ids.copy())
        at = 2 * rows * n
        cells.host[at:at + rows] = np.asarray(value_id)
        cells.host.view(np.uint8)[4 * (at + rows):4 * (at + rows) + rows] \
            = np.asarray(has_vote)
        return 0


@pytest.fixture
def staged(monkeypatch):
    """K8's staged path forced on the CPU: a fake staging, the stand-in
    entry, a fresh launch count."""
    staging = _FakeStaging()
    stand = _K8Stand(staging)
    monkeypatch.setattr(_build, "staging", lambda table, device: staging)
    monkeypatch.setattr(tv._K8_STAGED, "fn", stand)
    monkeypatch.setattr(tv.safe_values, "launches", 0)
    return staging, stand


def _matrices(seed: int, rows: int, n: int):
    """Rounds in [-1, 3] with ties, all-NO_VOTE rows, INT32_MIN /
    INT32_MAX rounds, and ids."""
    rng = np.random.default_rng(seed)
    rounds = rng.integers(-1, 4, size=(rows, n)).astype(np.int32)
    rounds[rng.random(rows) < 0.125] = tv.NO_VOTE
    extreme = rng.random((rows, n)) < 1 / 16
    rounds[extreme] = np.where(rng.random(int(extreme.sum())) < 0.5,
                               INT32_MIN, INT32_MAX)
    ids = rng.integers(0, 1 << 20, size=(rows, n)).astype(np.int32)
    return rounds, ids


@pytest.mark.parametrize("inputs", ["views", "arrays"])
@pytest.mark.parametrize("rows,n", [(1, 3), (8, 3), (300, 3), (1024, 6),
                                    (77, 1), (64, 2), (129, 5), (33, 9),
                                    (20, 17)])
def test_staged_entry_block_layout(staged, rows, n, inputs):
    """The staged call's packed block: as many slots as the C entry
    reads; the matrices side by side in the pinned block, handed out
    prefilled with NO_VOTE and 0; no device buffer; one launch counted a
    call; the result JAX's, whether the Leader wrote into the views or
    the call was handed other arrays (copied into the block)."""
    staging, stand = staged
    assert _build.SIGNATURES["value"]["fpx_safe_values_staged"] is _build._B
    assert len(tv._K8_STAGED.pack(*range(5))) == 40 and \
        _c_slots("value", "fpx_safe_values_staged") == 5
    rounds_v, ids_v = tv.recovery_matrices(rows, n, device="cuda")
    cells = staging.pairs["recovery"]
    assert rounds_v.shape == ids_v.shape == (rows, n)
    assert rounds_v.ctypes.data == cells.host_ptr
    assert ids_v.ctypes.data == cells.host_ptr + 4 * rows * n
    assert (rounds_v == tv.NO_VOTE).all() and (ids_v == 0).all()
    rounds, ids = _matrices(rows * 10 + n, rows, n)
    if inputs == "views":
        rounds_v[...], ids_v[...] = rounds, ids
        has_vote, value_id = tv.safe_values_staged(rounds_v, ids_v,
                                                   device="cuda")
    else:
        has_vote, value_id = tv.safe_values_staged(rounds, ids,
                                                   device="cuda")
        np.testing.assert_array_equal(rounds_v, rounds)
        np.testing.assert_array_equal(ids_v, ids)
    assert len(stand.calls) == 1 and tv.safe_values.launches == 1
    a = stand.calls[0]
    assert (a[1], a[2]) == (rows, n)
    jh_, jc = jv.safe_values(rounds, ids)
    assert has_vote.dtype == np.bool_ and value_id.dtype == np.int32
    np.testing.assert_array_equal(has_vote, np.asarray(jh_))
    np.testing.assert_array_equal(value_id, np.asarray(jc))
    # Fresh arrays: the next call does not change them.
    before = value_id.copy()
    tv.recovery_matrices(rows, n, device="cuda")
    assert (rounds_v == tv.NO_VOTE).all(), "the views were not prefilled"
    tv.safe_values_staged(rounds_v, ids_v, device="cuda")
    np.testing.assert_array_equal(value_id, before)
    assert tv.safe_values.launches == 2


def test_staged_entry_copies_other_matrices(staged):
    """Matrices that are not the pinned block's views (or are swapped
    views of it) are copied in first; an empty window launches
    nothing."""
    staging, stand = staged
    rounds, ids = _matrices(5, 100, 3)
    want = jv.safe_values(rounds, ids)
    got = tv.safe_values_staged(rounds, ids, device="cuda")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    rounds_v, ids_v = tv.recovery_matrices(100, 3, device="cuda")
    rounds_v[...], ids_v[...] = ids, rounds
    got = tv.safe_values_staged(ids_v, rounds_v, device="cuda")
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    empty = tv.safe_values_staged(np.zeros((0, 3), np.int32),
                                  np.zeros((0, 3), np.int32), device="cuda")
    assert empty[0].shape == empty[1].shape == (0,)
    assert len(stand.calls) == 2 and tv.safe_values.launches == 2
    with pytest.raises(ValueError, match="int32"):
        tv.safe_values_staged(rounds.astype(np.int64), ids, device="cuda")
    with pytest.raises(ValueError, match="acceptor column"):
        tv.safe_values_staged(np.zeros((4, 0), np.int32),
                              np.zeros((4, 0), np.int32), device="cuda")


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 9, 17])
def test_staged_on_the_cpu_is_jax(n):
    """``device="cpu"``: fresh prefilled matrices, and the plain version
    bit-identical to the JAX program (INT32 extremes included)."""
    rounds_v, ids_v = tv.recovery_matrices(512, n, device="cpu")
    assert (rounds_v == tv.NO_VOTE).all() and (ids_v == 0).all()
    rounds, ids = _matrices(n, 512, n)
    rounds_v[:500], ids_v[:500] = rounds[:500], ids[:500]
    launches = tv.safe_values.launches
    got = tv.safe_values_staged(rounds_v, ids_v, device="cpu")
    want = jv.safe_values(rounds_v, ids_v)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert not got[0][500:].any()
    assert tv.safe_values.launches == launches


def _phase1bs(package, seed: int, num_groups: int, max_slot: int):
    """The failover Phase1bs of the recovery tests: per group, three
    acceptors in a shuffled arrival order, each voting (round -1..2, a
    command batch or Noop) on about 70% of its group's slots."""
    rng = random.Random(seed)
    phase1bs = [{} for _ in range(num_groups)]
    for group_index in range(num_groups):
        order = list(range(3))
        rng.shuffle(order)
        for acceptor_index in order:
            infos = []
            for slot in range(max_slot + 1):
                if slot % num_groups != group_index or rng.random() < 0.3:
                    continue
                value = (package.NOOP if rng.random() < 0.1 else
                         package.CommandBatch((package.Command(
                             package.CommandId("c", rng.randrange(3), 0),
                             b"v%d" % rng.randrange(4)),)))
                infos.append(package.Phase1bSlotInfo(
                    slot=slot, vote_round=rng.randrange(-1, 3),
                    vote_value=value))
            phase1bs[group_index][acceptor_index] = package.Phase1b(
                group_index=group_index, acceptor_index=acceptor_index,
                round=5, info=tuple(infos))
    return phase1bs


def _norm(value):
    """A recovered value of either package as plain tuples."""
    if type(value).__name__ == "Noop":
        return None
    return tuple((c.command_id.client_address, c.command_id.client_pseudonym,
                  c.command_id.client_id, c.command)
                 for c in value.commands)


def _parent_matrices(leader, phase1, max_slot: int):
    """The recovery matrices as the Leader built them before its staged
    call: ``np.full`` / ``np.zeros`` at the window's power of two, then
    every vote written in the same order."""
    num_slots = max_slot + 1 - leader.chosen_watermark
    num_groups = leader.config.num_acceptor_groups
    row_size = len(leader.config.acceptor_addresses[0])
    padded = 1
    while padded < num_slots:
        padded *= 2
    rounds = np.full((padded, num_groups * row_size), tv.NO_VOTE, np.int32)
    ids = np.zeros_like(rounds)
    id_by_value: dict = {}
    for group_index, group in enumerate(phase1.phase1bs):
        for acceptor_index, phase1b in group.items():
            col = group_index * row_size + acceptor_index
            for info in phase1b.info:
                if not (leader.chosen_watermark <= info.slot <= max_slot):
                    continue
                if info.slot % num_groups != group_index:
                    continue
                vid = id_by_value.setdefault(info.vote_value,
                                             len(id_by_value))
                rounds[info.slot - leader.chosen_watermark, col] = \
                    info.vote_round
                ids[info.slot - leader.chosen_watermark, col] = vid
    return rounds, ids


@pytest.mark.parametrize("max_slot,watermark", [(12, 2), (300, 3),
                                                (1100, 40)])
@pytest.mark.parametrize("num_groups", [1, 2])
def test_leader_writes_the_parent_and_jax_matrices(staged, monkeypatch,
                                                   num_groups, max_slot,
                                                   watermark):
    """The matrices the Leader writes into the pinned block's views equal
    the ``np.full`` build it made before, and the JAX Leader's; its
    recovery equals the JAX Leader's, through one staged call."""
    staging, stand = staged
    seen = {}
    real_staged = tv.safe_values_staged

    def spy_port(rounds, ids, device=None):
        seen["port"] = (rounds.copy(), ids.copy())
        return real_staged(rounds, ids, device)

    real_jax = jv.safe_values

    def spy_jax(rounds, ids):
        seen["jax"] = (np.array(rounds), np.array(ids))
        return real_jax(rounds, ids)

    monkeypatch.setattr(tv, "safe_values_staged", spy_port)
    monkeypatch.setattr(jv, "safe_values", spy_jax)
    leader = make_multipaxos(f=1, num_acceptor_groups=num_groups,
                             phase1_backend="cuda",
                             device="cpu").leaders[0]
    jax_leader = jh.make_multipaxos(f=1, num_acceptor_groups=num_groups,
                                    phase1_backend="tpu").leaders[0]
    leader.chosen_watermark = jax_leader.chosen_watermark = watermark
    for seed in range(2):
        phase1 = _Phase1(phase1bs=_phase1bs(tm, seed, num_groups, max_slot),
                         phase1b_acceptors=set(), pending_batches=[],
                         resend_phase1as=None)
        got = leader._recover_values(phase1, max_slot)
        want = jax_leader._recover_values(_JPhase1(
            phase1bs=_phase1bs(jm, seed, num_groups, max_slot),
            phase1b_acceptors=set(), pending_batches=[],
            resend_phase1as=None), max_slot)
        parent = _parent_matrices(leader, phase1, max_slot)
        for a, b, c in zip(seen["port"], parent, seen["jax"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert leader.last_recovery["shape"] == list(parent[0].shape)
        assert len(got) == len(want) == max_slot + 1 - watermark
        assert [_norm(v) for v in got] == [_norm(w) for w in want]
    assert len(stand.calls) == 2 and tv.safe_values.launches == 2


class _K8Lean:
    """``fpx_safe_values`` on CPU tensors: the block read as the C entry
    reads it, K8 computed with JAX at the named pointers."""

    def __init__(self):
        self.calls = []

    def __call__(self, block: bytes) -> int:
        slots = _c_slots("value", "fpx_safe_values")
        assert len(block) == 8 * slots
        a = struct.unpack(f"={slots}q", block)
        self.calls.append(a)
        s, n = a[2], a[3]
        rounds = _int32_at(a[0], s * n).reshape(s, n).copy()
        ids = _int32_at(a[1], s * n).reshape(s, n).copy()
        has_vote, value_id = jv.safe_values(rounds, ids)
        np.ctypeslib.as_array((ctypes.c_uint8 * s).from_address(a[4]))[:] \
            = np.asarray(has_vote)
        _int32_at(a[5], s)[:] = np.asarray(value_id)
        return 0


def test_lean_wrapper_kernel_path(monkeypatch):
    """The tensor wrapper's kernel path forced on CPU tensors: one packed
    block of the C entry's slots, the pointers of the inputs and of
    ``out=``, one launch counted a call, none for an empty batch, and
    the result JAX's."""
    stand = _K8Lean()
    monkeypatch.setattr(tv, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tv._K8, "fn", stand)
    monkeypatch.setattr(tv._build, "stream_handle", lambda index: 0)
    monkeypatch.setattr(tv.safe_values, "launches", 0)
    rounds, ids = _matrices(3, 700, 3)
    rt, it = torch.from_numpy(rounds), torch.from_numpy(ids)
    has_vote, value_id = tv.safe_values(rt, it)
    jh_, jc = jv.safe_values(rounds, ids)
    np.testing.assert_array_equal(has_vote.numpy(), np.asarray(jh_))
    np.testing.assert_array_equal(value_id.numpy(), np.asarray(jc))
    out = (torch.ones(700, dtype=torch.bool),
           torch.zeros(700, dtype=torch.int32))
    got = tv.safe_values(rt, it, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert stand.calls[1][4] == out[0].data_ptr()
    assert stand.calls[1][5] == out[1].data_ptr()
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jc))
    tv.safe_values(rt[:0], it[:0])
    assert len(stand.calls) == 2 and tv.safe_values.launches == 2
    with pytest.raises(ValueError, match="contiguous"):
        tv.safe_values(rt.t().contiguous().t(), it)
    with pytest.raises(ValueError, match="out"):
        tv.safe_values(rt, it, out=(out[0][:5], out[1]))


def test_wrapper_out_on_the_cpu():
    rounds, ids = _matrices(4, 300, 6)
    out = (torch.ones(300, dtype=torch.bool),
           torch.full((300,), 9, dtype=torch.int32))
    got = tv.safe_values(torch.from_numpy(rounds), torch.from_numpy(ids),
                         out=out)
    jh_, jc = jv.safe_values(rounds, ids)
    assert got[0] is out[0] and got[1] is out[1]
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jh_))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jc))


class _K7Stand:
    """``fpx_reshape_columns`` on CPU tensors: the block read as the C
    entry reads it (the map after the slots when no device map is
    named), the gather computed with numpy (the kernel's clamp and zero
    rows), written at the out pointer."""

    def __init__(self):
        self.calls = []

    def __call__(self, packed: bytes) -> int:
        slots = _c_slots("epoch", "fpx_reshape_columns")
        head = struct.unpack(f"={slots}q", packed[:8 * slots])
        block_ptr, n_old, b, n_new, out_ptr, dmap = head[:6]
        if dmap:
            assert len(packed) == 8 * slots
            cmap = _int32_at(dmap, n_new).copy()
        else:
            assert n_new <= MAP_MAX
            assert len(packed) == 8 * slots + 4 * n_new
            cmap = np.frombuffer(packed[8 * slots:], dtype="<i4").copy()
        self.calls.append((head, cmap))
        block = np.ctypeslib.as_array(
            (ctypes.c_uint8 * (n_old * b)).from_address(block_ptr)
        ).reshape(n_old, b)
        out = np.ctypeslib.as_array(
            (ctypes.c_uint8 * (n_new * b)).from_address(out_ptr)
        ).reshape(n_new, b)
        out[...] = np.where((cmap >= 0)[:, None],
                            block[np.clip(cmap, 0, n_old - 1)], 0)
        return 0


@pytest.fixture
def k7(monkeypatch):
    stand = _K7Stand()
    monkeypatch.setattr(tq, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tq._K7, "fn", stand)
    monkeypatch.setattr(tq, "reshape_map_max", lambda: MAP_MAX)
    monkeypatch.setattr(tq._build, "stream_handle", lambda index: 0)
    monkeypatch.setattr(tq.reshape_columns, "launches", 0)
    return stand


@pytest.mark.parametrize("length", [1, 2, 3, 4, 5, 17, 63, 64, 65, 200])
def test_reshape_block_carries_the_map(k7, length):
    """Maps of 1 to 64 rows cross in the packed block (no device map);
    a longer one is staged and named by its pointer; under the clamp
    (rows past N_old, below -1) and zero-row rules the result is
    ``jq._reshape_columns``'s."""
    rng = np.random.default_rng(length)
    n_old, b = 3, 40
    block = rng.integers(0, 256, size=(n_old, b), dtype=np.uint8)
    cmap = rng.integers(-3, n_old + 3, size=length).astype(np.int32)
    for form in (cmap, torch.from_numpy(cmap)):
        got = tq.reshape_columns(torch.from_numpy(block), form)
        want = jq._reshape_columns(jnp.asarray(block), jnp.asarray(cmap))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        head, carried = k7.calls[-1]
        np.testing.assert_array_equal(carried, cmap)
        assert (head[5] == 0) == (length <= MAP_MAX)
        assert head[1:4] == (n_old, b, length)
    assert tq.reshape_columns.launches == 2
    assert _build.SIGNATURES["epoch"]["fpx_reshape_columns"] is _build._B
    assert _c_slots("epoch", "fpx_reshape_columns") == 8
    assert MAP_MAX == 64


def test_reshape_out_and_refusals(k7):
    block = torch.from_numpy(np.arange(3 * 48, dtype=np.uint8)
                             .reshape(3, 48))
    cmap = np.asarray([2, -1, 0, 5], np.int32)
    out = torch.full((4, 48), 7, dtype=torch.uint8)
    assert tq.reshape_columns(block, cmap, out=out) is out
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jq._reshape_columns(jnp.asarray(block.numpy()), jnp.asarray(cmap))))
    assert k7.calls[-1][0][4] == out.data_ptr()
    # Nothing to move: no launch.
    tq.reshape_columns(block, np.zeros(0, np.int32))
    tq.reshape_columns(block[:, :0].contiguous(), cmap)
    assert tq.reshape_columns.launches == 1
    with pytest.raises(ValueError, match="overlaps"):
        tq.reshape_columns(block, np.asarray([0, 1, 2], np.int32),
                           out=block)
    with pytest.raises(ValueError, match="out must be"):
        tq.reshape_columns(block, cmap, out=out[:3])
    with pytest.raises(ValueError, match="int32"):
        tq.reshape_columns(block, cmap.astype(np.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tq.reshape_columns(block.t().contiguous().t(), cmap)


def test_reshape_board_stages_no_short_map(k7, monkeypatch):
    """``_reshape_board`` hands the numpy map to K7 directly: no map is
    staged for a universe of up to 64 rows, one is for a longer one."""
    staged = []
    real_stage = tq.stage

    def spy(array, device):
        staged.append(np.asarray(array).shape)
        return real_stage(array, device)

    monkeypatch.setattr(tq, "stage", spy)
    for old, new in (((0, 1, 2), (0, 1, 2, 3)), ((5, 9, 2), (2, 9)),
                     (tuple(range(3)), tuple(range(64)))):
        board = tq.make_vote_board(32, len(old), device="cpu")
        board.votes.copy_(torch.from_numpy(np.random.default_rng(1).integers(
            0, 2, size=(len(old), 32), dtype=np.uint8)))
        got = tq._reshape_board(board, old, new)
        want = jq._reshape_columns(
            jnp.asarray(board.votes.numpy()),
            jnp.asarray(tq.epoch_column_map(old, new)))
        np.testing.assert_array_equal(got.votes.numpy(), np.asarray(want))
    assert staged == []
    board = tq.make_vote_board(32, 3, device="cpu")
    tq._reshape_board(board, (0, 1, 2), tuple(range(70)))
    assert staged == [(70,)]
    assert tq.reshape_columns.launches == 4


def test_reshape_host_map_on_the_cpu_is_jax():
    """A numpy map with a CPU block takes the plain version, equal to
    JAX's under the clamp and zero-row rules; no launch counted."""
    rng = random.Random(3)
    launches = tq.reshape_columns.launches
    for n_old, length in ((1, 3), (3, 4), (5, 70)):
        block = np.random.default_rng(n_old).integers(
            0, 256, size=(n_old, 33), dtype=np.uint8)
        cmap = np.asarray([rng.randrange(-2, n_old + 2)
                           for _ in range(length)], np.int32)
        got = tq.reshape_columns(torch.from_numpy(block), cmap)
        want = jq._reshape_columns(jnp.asarray(block), jnp.asarray(cmap))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tq.reshape_columns.launches == launches
