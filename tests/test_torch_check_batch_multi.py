"""K6's stateless ``check_batch_multi`` against the JAX package (JAX on the
CPU), exactly, and its staged entry's packing.

(a) ``check_batch_multi_plain`` (and the tensor wrapper on CPU tensors)
against the JAX package's ``_check_batch_multi``: weighted rows, sums past
2^31 that wrap in int32, config indices below, inside and past ``[0, K)``,
ANY and ALL planes, weighted masks, several groups, strided rows.
(b) :class:`MultiCheck`'s staged call, with the C entry stood in for by a
Python model of its packed block (18 int64: the rows, indices and answer
bytes read from and written to their addresses in the pinned block, the
planes from their host cells): a batch's rows as int32 whatever their
type (bools, unsigned and signed integers, int64 values that wrap to
int32, a strided view), the block layout (rows at a 16-byte boundary
after the one-row cells, then the indices, then the answers, none
overlapping), the host cells of both plane forms, ``check_word``'s
prebuilt call on a 0/1 row packed into one 32-bit word (little-endian
bits), one launch counted a call and none for an empty batch; every
answer equal to the JAX package's. (c) The tensor wrapper's packed block
on the forced kernel path.

The CUDA kernel and the entry itself are held against the plain version
on the H100 by ``chip_smoke.py`` (phases 8 and 32).
"""

import ctypes
import struct

from frankenpaxos_tpu_torch.ops import _build, quorum as tq
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority
from frankenpaxos_tpu_torch.quorums.spec import pad_specs
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import quorum as jq


def reference(present, idx, masks, thresholds, combine_any) -> np.ndarray:
    return np.asarray(jq._check_batch_multi(
        jnp.asarray(present), jnp.asarray(idx, dtype=jnp.int32),
        jnp.asarray(masks), jnp.asarray(thresholds),
        jnp.asarray(combine_any)))


def random_planes(rng, k: int, g: int, n: int, weighted: bool):
    masks = (rng.random((k, g, n)) < 0.6).astype(np.int32)
    if weighted:
        masks *= rng.integers(1, 4, size=(k, g, n), dtype=np.int32)
    thresholds = rng.integers(0, n + 2, size=(k, g)).astype(np.int32)
    combine_any = rng.random(k) < 0.5
    return masks, thresholds, combine_any


# --- (a) the plain version against JAX --------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k, g, n = int(rng.integers(1, 5)), int(rng.integers(1, 4)), \
        int(rng.integers(1, 13))
    planes_np = random_planes(rng, k, g, n, weighted=seed % 2 == 1)
    planes = tq.make_multi_predicate(*planes_np, device="cpu")
    b = 257
    present = (rng.random((b, n)) < 0.5).astype(np.int32)
    present[:64] = rng.integers(-3, 5, size=(64, n))
    present[64:96] = rng.integers(-2**31, 2**31 - 1, size=(32, n))
    idx = rng.integers(-k - 3, k + 4, size=b).astype(np.int32)
    want = reference(present, idx, *planes_np)
    got = tq.check_batch_multi_plain(torch.from_numpy(present),
                                     torch.from_numpy(idx), planes)
    np.testing.assert_array_equal(got.numpy(), want)
    wrapped = tq.check_batch_multi(
        torch.from_numpy(np.ascontiguousarray(present.T)).t(),
        torch.from_numpy(idx), planes)
    np.testing.assert_array_equal(wrapped.numpy(), want)


def test_plain_int32_wrap():
    """A count past 2^31 - 1 wraps, as XLA's int32 does: two 2^30 votes
    under weight 2 count 2^32 = 0 and one counts 2^31 = -2^31, both below
    a threshold of 1; a -1 vote under a weight of -1 counts 1 and hits."""
    masks = np.array([[[2, 2, 0]], [[-1, 0, 0]]], np.int32)
    thresholds = np.array([[1], [1]], np.int32)
    combine_any = np.array([True, False])
    present = np.array([[2**30, 2**30, 0], [-1, 5, 5], [2**30, 0, 0]],
                       np.int32)
    idx = np.array([0, 1, 0], np.int32)
    planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                     device="cpu")
    got = tq.check_batch_multi_plain(torch.from_numpy(present),
                                     torch.from_numpy(idx), planes).numpy()
    np.testing.assert_array_equal(
        got, reference(present, idx, masks, thresholds, combine_any))
    assert got.tolist() == [False, True, False]


def test_plain_any_and_all_planes():
    """A grid's write spec (ALL over rows, threshold 1) and read spec (ANY,
    threshold the row size) side by side with a majority, by index."""
    universe = tuple(range(6))
    specs = [Grid([[0, 1, 2], [3, 4, 5]]).write_spec().reindexed(universe),
             Grid([[0, 1, 2], [3, 4, 5]]).read_spec().reindexed(universe),
             SimpleMajority([0, 1, 2, 3, 4]).write_spec().reindexed(universe)]
    masks, thresholds, combine_any = pad_specs(specs)
    assert combine_any.tolist() == [False, True, True]
    rows = np.array([[1, 0, 0, 1, 0, 0], [1, 1, 1, 0, 0, 0],
                     [1, 1, 1, 0, 0, 0], [0, 1, 1, 1, 0, 0],
                     [1, 0, 0, 0, 0, 0]], np.int32)
    idx = np.array([0, 1, 0, 2, -1], np.int32)
    planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                     device="cpu")
    got = tq.check_batch_multi_plain(torch.from_numpy(rows),
                                     torch.from_numpy(idx), planes).numpy()
    np.testing.assert_array_equal(
        got, reference(rows, idx, masks, thresholds, combine_any))
    assert got.tolist() == [True, True, False, True, False]


# --- (b) the staged entry, modelled -------------------------------------------


def _at(address: int, count: int, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    raw = (ctypes.c_uint8 * (count * dtype.itemsize)).from_address(address)
    return np.frombuffer(raw, dtype=dtype)


class FakeStaging:
    index, stream_handle = 0, 0


class Model:
    """``fpx_check_batch_multi_staged`` in Python: checks the packed
    block's layout and computes the answers with the JAX package."""

    def __init__(self, mc: tq.MultiCheck):
        self.mc, self.calls = mc, []

    def __call__(self, block) -> int:
        a = struct.unpack("=18q", block)
        self.calls.append(a)
        mc = self.mc
        rows, rs, cs, b, n, cfg, out, flags = a[:8]
        bits = bool(flags & tq._MULTI_BITS)
        base = a[15]
        assert flags & tq._MULTI_MAPPED and base == mc._block.data_ptr()
        assert n == mc.n and (a[13], a[14]) == (mc.k, mc.g)
        assert (a[16], a[17]) == (0, 0)
        width = 1 if bits else n
        assert cs == 1 and rs == width
        # The planes' host cells in the form of the rows.
        cells = _at(a[8], a[9], np.int32)
        np.testing.assert_array_equal(
            cells, mc.cells_bits if bits else mc.cells_int)
        end = base + 4 * mc._cap
        regions = [(rows, 4 * b * width), (out, b)]
        if mc.k > 1:
            assert cfg != 0
            regions.append((cfg, 4 * b))
        else:
            assert cfg == 0
        for start, size in regions:
            assert base <= start and start + size <= end
        regions.sort()
        for (s0, z0), (s1, _) in zip(regions, regions[1:]):
            assert s0 + z0 <= s1, "regions overlap"
        if b > 1:
            assert (rows - base) % 16 == 0 and rows - base >= 4 * mc.ONE_CELLS
        if bits:
            words = _at(rows, b, np.uint32)
            present = ((words[:, None] >> np.arange(n, dtype=np.uint32))
                       & 1).astype(np.int32)
            assert (words >> np.uint32(n) == 0).all() if n < 32 else True
        else:
            present = _at(rows, b * n, np.int32).reshape(b, n).copy()
        idx = _at(cfg, b, np.int32).copy() if cfg else np.zeros(b, np.int32)
        want = reference(present, idx, mc.planes.masks.numpy(),
                         mc.planes.thresholds.numpy(),
                         mc.planes.combine_any.numpy())
        _at(out, b, np.uint8)[:] = want
        self.last = (present, idx, bits)
        return 0


@pytest.fixture
def staged(monkeypatch):
    """A factory of :class:`MultiCheck` objects on the staged path over a
    fake pinned block and the model entry."""
    monkeypatch.setattr(tq, "_pinned_cells",
                        lambda cells: torch.zeros(cells, dtype=torch.int32))
    monkeypatch.setattr(tq.check_batch_multi, "launches", 0)
    made = []

    def make(masks, thresholds, combine_any):
        mc = tq.MultiCheck(masks, thresholds, combine_any, device="cpu")
        mc._staging = FakeStaging()
        mc._bits_card = torch.from_numpy(mc.cells_bits.copy()) \
            if mc.bits else None
        mc._cap = 0
        mc._grow(64)
        model = Model(mc)
        monkeypatch.setattr(tq._K6_MULTI, "fn", model)
        made.append(model)
        return mc, model

    return make


@pytest.mark.parametrize("seed", range(4))
def test_staged_batches_match_reference(staged, seed):
    rng = np.random.default_rng(seed)
    n = [3, 5, 12, 32][seed]
    k = [1, 2, 3, 4][seed]
    planes_np = random_planes(rng, k, 2, n, weighted=False)
    mc, model = staged(*planes_np)
    assert mc.bits
    launches = 0
    for b in (1, 3, 40, 700):
        idx = rng.integers(-k - 2, k + 3, size=b)
        cases = {
            "uint8 0/1": ((rng.random((b, n)) < 0.5).astype(np.uint8), True),
            "bool": (rng.random((b, n)) < 0.5, True),
            "int64 0/1": ((rng.random((b, n)) < 0.5).astype(np.int64), True),
            "uint8 2": (np.full((b, n), 2, np.uint8), False),
            "int32 -1": (-(rng.random((b, n)) < 0.5).astype(np.int32)
                         if b > 1 else np.full((1, n), -1, np.int32),
                         False),
            "int64 wrap": (rng.integers(-2**40, 2**40, size=(b, n)), False),
            "strided": (np.asfortranarray(
                (rng.random((b, n)) < 0.5).astype(np.int32)), True),
        }
        for name, (present, _) in cases.items():
            got = mc.check(present, idx)
            launches += 1
            want = reference(present.astype(np.int32), idx, *planes_np)
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert not model.last[2], name  # batches ride as int32
            np.testing.assert_array_equal(model.last[0],
                                          present.astype(np.int32))
            if k > 1:
                np.testing.assert_array_equal(model.last[1],
                                              idx.astype(np.int32))
    assert tq.check_batch_multi.launches == launches
    assert mc.check(np.zeros((0, n), np.uint8)).shape == (0,)
    assert tq.check_batch_multi.launches == launches


def test_staged_weighted_planes_take_int_rows(staged):
    """Masks outside {0, 1} (or N > 32) have no word form: every batch
    rides as int32 rows, and ``check_word`` is refused."""
    rng = np.random.default_rng(9)
    for n, weighted in ((4, True), (40, False)):
        planes_np = random_planes(rng, 2, 3, n, weighted=weighted)
        mc, model = staged(*planes_np)
        assert not mc.bits and mc.cells_bits is None
        present = (rng.random((50, n)) < 0.5).astype(np.uint8)
        idx = rng.integers(0, 2, size=50)
        np.testing.assert_array_equal(
            mc.check(present, idx),
            reference(present, idx, *planes_np))
        assert not model.last[2]
        with pytest.raises(ValueError):
            mc.check_word(1)


@pytest.mark.parametrize("k", [1, 3])
def test_check_word(staged, k):
    """``check_word``: the word at cell 0, its index at ``ONE_CFG`` (k > 1
    only), its answer byte at ``ONE_OUT``; one prebuilt packed call."""
    rng = np.random.default_rng(k)
    n = 5
    planes_np = random_planes(rng, k, 1, n, weighted=False)
    mc, model = staged(*planes_np)
    base = mc._block.data_ptr()
    for word in range(1 << n):
        cfg = int(rng.integers(-k - 1, k + 1)) if k > 1 else 0
        row = np.array([[(word >> i) & 1 for i in range(n)]], np.int32)
        want = reference(row, np.array([cfg]), *planes_np)[0]
        assert mc.check_word(word, cfg) == want
        a = model.calls[-1]
        assert a[0] == base and a[3] == 1 and a[6] == base + 4 * mc.ONE_OUT
        assert a[5] == (base + 4 * mc.ONE_CFG if k > 1 else 0)
    assert tq.check_batch_multi.launches == 1 << n
    # The same call on the CPU (plain) agrees.
    cpu = tq.MultiCheck(*planes_np, device="cpu")
    assert all(cpu.check_word(w, 0) == mc.check_word(w, 0)
               for w in range(1 << n))


def test_block_grows_and_keeps_the_one_row_cells(staged):
    rng = np.random.default_rng(5)
    planes_np = random_planes(rng, 2, 2, 7, weighted=False)
    mc, model = staged(*planes_np)
    small = mc._cap
    present = (rng.random((5000, 7)) < 0.5).astype(np.uint8)
    idx = rng.integers(0, 2, size=5000)
    np.testing.assert_array_equal(mc.check(present, idx),
                                  reference(present, idx, *planes_np))
    assert mc._cap > small and mc._block.numel() == mc._cap
    assert model.calls[-1][15] == mc._block.data_ptr()
    assert mc.check_word(0b1111111, 1) == reference(
        np.ones((1, 7), np.int32), np.array([1]), *planes_np)[0]
    assert model.calls[-1][0] == mc._block.data_ptr()


def test_host_cells():
    """The planes' host cells: masks (or one word a group), thresholds,
    then the any bytes padded to whole cells."""
    masks = np.array([[[1, 0, 1]], [[1, 1, 1]], [[0, 1, 0]]], np.uint8)
    thresholds = np.array([[2], [3], [1]], np.int32)
    combine_any = np.array([True, False, True])
    mc = tq.MultiCheck(masks, thresholds, combine_any, device="cpu")
    assert mc.bits
    assert mc.cells_bits[:3].tolist() == [0b101, 0b111, 0b010]
    assert mc.cells_bits[3:6].tolist() == [2, 3, 1]
    assert mc.cells_bits[6:].view(np.uint8).tolist() == [1, 0, 1, 0]
    assert mc.cells_int[:9].tolist() == masks.ravel().tolist()
    assert mc.cells_int[9:12].tolist() == [2, 3, 1]


# --- (c) the tensor wrapper's packed block -------------------------------------


def test_tensor_wrapper_packed_block(monkeypatch):
    calls = []
    monkeypatch.setattr(tq, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tq._K6_MULTI, "fn",
                        lambda block: calls.append(
                            struct.unpack("=18q", block)) or 0)
    monkeypatch.setattr(_build, "stream_handle", lambda index: 77)
    monkeypatch.setattr(tq.check_batch_multi, "launches", 0)
    planes = tq.make_multi_predicate(np.ones((2, 1, 4)), np.ones((2, 1)),
                                     np.ones(2, bool), device="cpu")
    present = torch.zeros((4, 6), dtype=torch.int32).t()
    idx = torch.zeros(6, dtype=torch.int32)
    tq.check_batch_multi(present, idx, planes)
    a = calls[-1]
    assert a[0] == present.data_ptr() and a[1:5] == (1, 6, 6, 4)
    assert a[5] == idx.data_ptr() and a[7] == 0 and a[8:10] == (0, 0)
    assert a[10:13] == (planes.masks.data_ptr(),
                        planes.thresholds.data_ptr(),
                        planes.combine_any.data_ptr())
    assert a[13:] == (2, 1, 0, present.get_device(), 77)
    assert tq.check_batch_multi.launches == 1
    tq.check_batch_multi(present[:0], idx[:0], planes)
    assert len(calls) == 1 and tq.check_batch_multi.launches == 1
