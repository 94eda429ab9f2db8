"""The port's dependency-set algebra (``ops/depset.py``, K9-K11, K16 and
K17) and ``runs/depruns.py`` against the JAX package.

(a) Every function of ``frankenpaxos_tpu/ops/depset.py`` against its
port on the same seeded numpy inputs, bit for bit, including the
hazards the kernels must reproduce: bytes other than 0/1, max (not OR)
in the quorum union, int32 wrap near 2^31 - 1, negative watermarks,
equality after normalization, empty batches and any width.
(b) The cases of ``tests/test_ops_depset.py`` repeated on the port.
(c) The cases of ``tests/test_depruns.py`` that need no wire codec
(``sets_to_columns``, ``split_columns``, ``columns_to_batch``,
``drain_union``) repeated on the port.
(d) The wrappers' routing: CPU tensors take the plain versions (and
launch nothing), other devices raise; with the kernel path forced on
CPU tensors and a stand-in library, K16 and K17 pass the arguments of
their C signatures (modes, broadcast strides) and count their launches.

The CUDA kernels themselves are held against these plain versions on
the H100 by ``chip_smoke.py``.
"""

import random
import struct

from frankenpaxos_tpu_torch.compact import IntPrefixSet
from frankenpaxos_tpu_torch.convert import depset_from_jax, depset_to_numpy
from frankenpaxos_tpu_torch.ops import depset
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance,
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.runs import depruns
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import depset as jdepset

CPU = torch.device("cpu")


# --- helpers -------------------------------------------------------------------


#: ``[B, L, W]`` shapes of the randomized cases: a few, so that the JAX
#: functions compile each once; widths of 1, a prime and powers of two.
SHAPES = ((1, 1, 1), (3, 5, 8), (4, 3, 37), (5, 5, 64), (2, 4, 256))


def random_batch(rng: np.random.Generator, b=None, l=None, w=None,
                 base=None, kind=None) -> tuple:
    """``(watermarks, tails, base)`` numpy inputs: watermarks around the
    window, tail bytes 0/1, small, or arbitrary."""
    if b is None:
        b, l, w = SHAPES[int(rng.integers(len(SHAPES)))]
    if base is None:
        base = int(rng.choice([0, 5, -6, 1000, 2**31 - 4, 2**31 - 40,
                               2**31 - 1, -2**31, -2**31 + 3]))
    wm = np.clip(base + rng.integers(-12, w + 12, size=(b, l)),
                 -2**31, 2**31 - 1).astype(np.int32)
    kind = int(rng.integers(0, 3)) if kind is None else kind
    if kind == 0:
        tails = (rng.random((b, l, w)) < 0.8).astype(np.uint8)
    elif kind == 1:
        tails = rng.integers(0, 3, size=(b, l, w)).astype(np.uint8)
    else:
        tails = rng.integers(0, 256, size=(b, l, w)).astype(np.uint8)
    return wm, tails, np.int32(base)


def both(wm, tails, base) -> tuple:
    """The same batch as a JAX ``DepSetBatch`` and a port one (CPU)."""
    return (jdepset.DepSetBatch(jnp.asarray(wm), jnp.asarray(tails),
                                jnp.int32(base)),
            depset_from_jax(wm, tails, base, CPU))


def assert_same(jax_out, port_out) -> None:
    """Bit-identical outputs: a batch, a tuple, or one array."""
    if isinstance(port_out, depset.DepSetBatch):
        got = depset_to_numpy(port_out)
        for name, want, have in zip(port_out._fields, jax_out, got):
            want = np.asarray(want)
            assert have.dtype == want.dtype, name
            assert np.array_equal(have, want), name
    elif isinstance(port_out, tuple):
        for a, b in zip(jax_out, port_out):
            assert_same(a, b)
    else:
        want = np.asarray(jax_out)
        have = port_out.numpy()
        assert have.dtype == want.dtype
        assert np.array_equal(have, want)


def same_base_pair(rng) -> tuple:
    """Two batches of one shape and one tail base."""
    wm, tails, base = random_batch(rng)
    b, l, w = tails.shape
    wm2, tails2, _ = random_batch(rng, b, l, w, int(base))
    return (wm, tails, base), (wm2, tails2, base)


def random_instance_set(rng: random.Random, num_replicas: int,
                        max_id: int = 40) -> InstancePrefixSet:
    columns = []
    for _ in range(num_replicas):
        watermark = rng.randrange(max_id // 2)
        values = {rng.randrange(max_id) for _ in range(rng.randrange(5))}
        columns.append(IntPrefixSet(watermark, values))
    return InstancePrefixSet(num_replicas, columns)


def row(batch: depset.DepSetBatch, b: int = 0) -> InstancePrefixSet:
    return device_deps.from_row(batch.watermarks[b].numpy(),
                                batch.tails[b].numpy(),
                                int(batch.tail_base))


# --- (a) every function against JAX ----------------------------------------


UNARY = {
    "normalized": (jdepset.normalized, depset.normalized),
    "normalized_plain": (jdepset.normalized, depset.normalized_plain),
    "union_reduce": (jdepset.union_reduce, depset.union_reduce),
    "union_reduce_plain": (jdepset.union_reduce, depset.union_reduce_plain),
    "all_equal": (jdepset.all_equal, depset.all_equal),
    "all_equal_plain": (jdepset.all_equal, depset.all_equal_plain),
    "size": (jdepset.size, depset.size),
    "size_plain": (jdepset.size, depset.size_plain),
}
BINARY = {
    "union": (jdepset.union, depset.union),
    "union_checked": (jdepset.union_checked, depset.union_checked),
    "equal": (jdepset.equal, depset.equal),
    "intersect": (jdepset.intersect, depset.intersect),
    "intersect_checked": (jdepset.intersect_checked,
                          depset.intersect_checked),
    "union_plain": (jdepset.union, depset.union_plain),
    "intersect_plain": (jdepset.intersect, depset.intersect_plain),
    "equal_plain": (jdepset.equal, depset.equal_plain),
}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_functions_match_jax(name, seed):
    jax_fn, port_fn = UNARY[name]
    rng = np.random.default_rng(1000 * seed + len(name))
    for _ in range(16):
        j, t = both(*random_batch(rng))
        assert_same(jax_fn(j), port_fn(t))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_functions_match_jax(name, seed):
    jax_fn, port_fn = BINARY[name]
    rng = np.random.default_rng(2000 * seed + len(name))
    for _ in range(16):
        a, b = same_base_pair(rng)
        (ja, ta), (jb, tb) = both(*a), both(*b)
        assert_same(jax_fn(ja, jb), port_fn(ta, tb))
        # Equality on normalized rows, the way callers use it.
        if name == "equal":
            assert_same(jax_fn(jdepset.normalized(ja), jdepset.normalized(ja)),
                        port_fn(depset.normalized(ta), depset.normalized(ta)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("plain", [False, True])
def test_conflict_max_matches_jax(plain, seed):
    fn = depset.conflict_max_plain if plain else depset.conflict_max
    rng = np.random.default_rng(3000 + seed)
    for _ in range(16):
        wm, tails, base = random_batch(rng)
        seqs = rng.integers(-2**31, 2**31, size=int(rng.choice([1, 5])),
                            dtype=np.int64).astype(np.int32)
        j, t = both(wm, tails, base)
        assert_same(jdepset.conflict_max(jnp.asarray(seqs), j),
                    fn(torch.from_numpy(seqs), t))


@pytest.mark.parametrize("seed", range(4))
def test_contains_matches_jax(seed):
    """Leaders out of range (negative ones count from the end, then
    clamp, as JAX's gather) and ids around and outside the window."""
    rng = np.random.default_rng(4000 + seed)
    for _ in range(16):
        wm, tails, base = random_batch(rng)
        b, l, w = tails.shape
        leader = rng.integers(-l - 2, l + 2, size=b).astype(np.int32)
        vid = np.clip(int(base) + rng.integers(-20, w + 20, size=b),
                      -2**31, 2**31 - 1).astype(np.int32)
        j, t = both(wm, tails, base)
        assert_same(jdepset.contains(j, jnp.asarray(leader),
                                     jnp.asarray(vid)),
                    depset.contains(t, leader, vid))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rows", [False, True])
def test_compact_matches_jax(rows, seed):
    """Executed watermarks per column (``[L]``) and per row (``[B, L]``)."""
    rng = np.random.default_rng(5000 + seed)
    for _ in range(16):
        wm, tails, base = random_batch(rng)
        b, l, w = tails.shape
        shape = (b, l) if rows else (l,)
        executed = np.clip(int(base) + rng.integers(-8, w + 8, size=shape),
                           -2**31, 2**31 - 1).astype(np.int32)
        j, t = both(wm, tails, base)
        assert_same(jdepset.compact(j, jnp.asarray(executed)),
                    depset.compact(t, executed))


def test_pow2_matches_jax():
    for n in [0, 1, 2, 3, 7, 8, 9, 1000, 4096, 4097]:
        assert depset._pow2(n) == jdepset._pow2(n)


# --- (a) the hazards, one by one -------------------------------------------


def _normalized_pair(wm, tails, base):
    wm = np.asarray(wm, dtype=np.int32)
    tails = np.asarray(tails, dtype=np.uint8)
    j, t = both(wm, tails, np.int32(base))
    want, got = jdepset.normalized(j), depset.normalized(t)
    assert_same(want, got)
    return depset_to_numpy(got)


def test_bytes_other_than_one_enter_the_cumprod():
    """[2, 3, 1, 0] at wm = base = 5: run = 2 + 6 + 6 = 14, so the
    watermark jumps to 19, past the window."""
    out = _normalized_pair([[5]], [[[2, 3, 1, 0, 0, 0, 0, 0]]], 5)
    assert out.watermarks.tolist() == [[19]]
    assert not out.tails.any()
    # 16 * 16 wraps to 0 mod 256: the product stops there.
    out = _normalized_pair([[0]], [[[16, 16, 1, 1]]], 0)
    assert out.watermarks.tolist() == [[16]]


def test_union_reduce_takes_max_not_or():
    j, t = both(np.array([[1], [1]], np.int32),
                np.array([[[1, 0]], [[2, 0]]], np.uint8), np.int32(10))
    want, got = jdepset.union_reduce(j), depset.union_reduce(t)
    assert_same(want, got)
    assert got.tails.tolist() == [[[2, 0]]]  # max(1, 2), not 1 | 2 = 3


def test_int32_wrap_near_the_top():
    """wm = base = 2^31 - 4 with eight 1-bytes: the ids past 2^31 - 1
    wrap negative and are cleared; the watermark stays."""
    top = 2**31 - 4
    out = _normalized_pair([[top]], [[[1] * 8]], top)
    assert out.watermarks.tolist() == [[2147483644]]
    assert out.tails.tolist() == [[[1, 1, 1, 1, 0, 0, 0, 0]]]


def test_negative_watermarks():
    out = _normalized_pair([[-5]], [[[1, 1, 1, 1, 0, 0, 0, 0]]], -6)
    assert out.watermarks.tolist() == [[-2]]
    # A watermark below the window absorbs nothing.
    out = _normalized_pair([[-9]], [[[1, 1, 0]]], -6)
    assert out.watermarks.tolist() == [[-9]]


def test_all_equal_compares_normalized_rows():
    """The same set as tail bytes in one row and as a watermark in
    another compares equal; one byte more does not."""
    wm = np.array([[3, 0], [5, 0]], np.int32)
    tails = np.array([[[1, 1, 0, 0], [0, 0, 0, 0]],
                      [[0, 0, 0, 0], [0, 0, 0, 0]]], np.uint8)
    j, t = both(wm, tails, np.int32(3))
    assert bool(jdepset.all_equal(j)) and bool(depset.all_equal(t))
    tails[1, 1, 2] = 1
    j, t = both(wm, tails, np.int32(3))
    assert not bool(jdepset.all_equal(j))
    assert not bool(depset.all_equal(t))


@pytest.mark.parametrize("fn", ["union_reduce", "all_equal",
                                "conflict_max", "union_reduce_plain",
                                "all_equal_plain", "conflict_max_plain"])
def test_empty_batches_raise(fn):
    wm, tails = np.zeros((0, 2), np.int32), np.zeros((0, 2, 8), np.uint8)
    j, t = both(wm, tails, np.int32(0))
    with pytest.raises((ValueError, IndexError)):
        name = fn.replace("_plain", "")
        if name == "conflict_max":
            getattr(jdepset, name)(jnp.zeros(1, jnp.int32), j)
        else:
            getattr(jdepset, name)(j)
    with pytest.raises(ValueError, match="empty batch"):
        if fn.startswith("conflict_max"):
            getattr(depset, fn)(torch.zeros(1, dtype=torch.int32), t)
        else:
            getattr(depset, fn)(t)


@pytest.mark.parametrize("w", [1, 5, 37, 100, 2048])
def test_any_width(w):
    rng = np.random.default_rng(w)
    for _ in range(5):
        j, t = both(*random_batch(rng, 3, 2, w))
        for fn in ("normalized", "union_reduce", "all_equal"):
            assert_same(getattr(jdepset, fn)(j), getattr(depset, fn)(t))


def test_bad_batches_are_refused():
    wm = torch.zeros((2, 3), dtype=torch.int32)
    tails = torch.zeros((2, 3, 8), dtype=torch.uint8)
    base = torch.tensor(0, dtype=torch.int32)
    for bad in (depset.DepSetBatch(wm.long(), tails, base),
                depset.DepSetBatch(wm, tails.int(), base),
                depset.DepSetBatch(wm, tails[:1], base),
                depset.DepSetBatch(wm, tails, base[None])):
        with pytest.raises(ValueError):
            depset.normalized(bad)
    with pytest.raises(ValueError):
        depset.conflict_max(torch.zeros(0, dtype=torch.int32),
                            depset.DepSetBatch(wm, tails, base))


# --- (b) the cases of tests/test_ops_depset.py -----------------------------


def test_to_batch_round_trips():
    rng = random.Random(1)
    for _ in range(25):
        original = random_instance_set(rng, 3)
        batch = device_deps.to_batch([original], 3, "cpu")
        assert batch is not None
        assert row(batch).materialize() == original.materialize()


def test_union_reduce_matches_host_union():
    rng = random.Random(2)
    for trial in range(25):
        num_sets = rng.randrange(2, 6)
        sets = [random_instance_set(rng, 3) for _ in range(num_sets)]
        device = device_deps.union_many(sets, 3, "cpu")
        host = InstancePrefixSet(3)
        for s in sets:
            host.add_all(s)
        assert device.materialize() == host.materialize(), trial
        # The reduced form must also be canonical (watermark absorbed).
        assert device == host, trial


def test_union_many_falls_back_on_wide_tails():
    wide = InstancePrefixSet(
        3, [IntPrefixSet(0, {0, device_deps.MAX_TAIL_WINDOW * 3}),
            IntPrefixSet(), IntPrefixSet()])
    other = InstancePrefixSet(3, [IntPrefixSet(2, set()),
                                  IntPrefixSet(0, {5}), IntPrefixSet()])
    assert device_deps.to_batch([wide, other], 3, "cpu") is None
    union = device_deps.union_many([wide, other], 3, "cpu")
    host = InstancePrefixSet(3)
    host.add_all(wide)
    host.add_all(other)
    assert union.materialize() == host.materialize()


def test_all_equal_matches_set_equality():
    rng = random.Random(3)
    for _ in range(25):
        base = random_instance_set(rng, 3)
        # Same set, different representation: watermark run as tail bits.
        alias = InstancePrefixSet(3, [
            IntPrefixSet(max(c.watermark - 1, 0),
                         set(c.values)
                         | ({c.watermark - 1} if c.watermark > 0 else set()))
            for c in base.columns])
        assert alias.materialize() == base.materialize()
        batch = device_deps.to_batch([base, alias, base.copy()], 3, "cpu")
        assert bool(depset.all_equal(batch))

        different = base.copy()
        different.add(Instance(1, 61))
        batch = device_deps.to_batch([base, different], 3, "cpu")
        assert not bool(depset.all_equal(batch))


def test_all_identical_respects_sequence_numbers():
    rng = random.Random(4)
    deps = random_instance_set(rng, 3)
    assert device_deps.all_identical([(0, deps), (0, deps.copy())], 3, "cpu")
    assert not device_deps.all_identical([(0, deps), (1, deps.copy())], 3,
                                         "cpu")
    assert device_deps.all_identical([(7, deps)], 3, "cpu")
    assert device_deps.all_identical([], 3, "cpu")


def test_union_reduce_invariant_under_permuted_deps():
    rng = random.Random(11)
    for _ in range(10):
        sets = [random_instance_set(rng, 3) for _ in range(5)]
        base = device_deps.union_many(sets, 3, "cpu")
        for _ in range(4):
            rng.shuffle(sets)
            assert device_deps.union_many(sets, 3, "cpu") == base


def test_conflict_max_matches_host():
    rng = random.Random(12)
    for _ in range(15):
        num = rng.randrange(2, 6)
        sets = [random_instance_set(rng, 3) for _ in range(num)]
        seqs = [rng.randrange(100) for _ in range(num)]
        batch = device_deps.to_batch(sets, 3, "cpu")
        seq, reduced = depset.conflict_max(
            torch.tensor(seqs, dtype=torch.int32), batch)
        host = InstancePrefixSet(3)
        for s in sets:
            host.add_all(s)
        assert int(seq) == max(seqs)
        assert row(reduced) == host
        # The replica's entry point gives the same pair.
        assert device_deps.conflict_max_many(
            list(zip(seqs, sets)), 3, "cpu") == (max(seqs), host)


def test_intersect_matches_host_sparse_and_dense():
    rng = random.Random(13)
    for trial in range(30):
        dense = trial % 2 == 1
        max_id = 20 if dense else 60
        a_sets = [random_instance_set(rng, 3, max_id) for _ in range(4)]
        b_sets = [random_instance_set(rng, 3, max_id) for _ in range(4)]
        # A shared tail base: pack both sides in ONE batch, then split.
        both_sets = device_deps.to_batch(a_sets + b_sets, 3, "cpu")
        a = depset.DepSetBatch(both_sets.watermarks[:4], both_sets.tails[:4],
                               both_sets.tail_base)
        b = depset.DepSetBatch(both_sets.watermarks[4:], both_sets.tails[4:],
                               both_sets.tail_base)
        out = depset.intersect_checked(a, b)
        for r in range(4):
            expect = a_sets[r].materialize() & b_sets[r].materialize()
            assert row(out, r).materialize() == expect, (trial, r)


def test_intersect_checked_rejects_mismatched_bases():
    a = device_deps.to_batch([random_instance_set(random.Random(0), 3)], 3,
                             "cpu")
    b = depset.DepSetBatch(a.watermarks, a.tails, a.tail_base + 1)
    with pytest.raises(ValueError):
        depset.intersect_checked(a, b)
    with pytest.raises(ValueError):
        depset.union_checked(a, b)


def test_compact_matches_host_at_boundaries():
    rng = random.Random(14)
    for trial in range(25):
        sets = [random_instance_set(rng, 3) for _ in range(3)]
        batch = device_deps.to_batch(sets, 3, "cpu")
        base = int(batch.tail_base)
        width = batch.tails.shape[-1]
        boundary_choices = [0, max(base - 1, 0), base, base + width // 2,
                            base + width, base + width + 7]
        executed = [rng.choice(boundary_choices
                               + [int(batch.watermarks[0, c])])
                    for c in range(3)]
        out = depset.compact(batch, np.asarray(executed, dtype=np.int32))
        for r, instance_set in enumerate(sets):
            host = instance_set.copy()
            host.add_all(InstancePrefixSet.from_watermarks(executed))
            assert row(out, r) == host, (trial, r, executed)


def test_contains_index_plane_is_cached_and_int32():
    depset._index_plane.cache_clear()
    plane = depset._index_plane(8, CPU)
    assert plane.dtype == torch.int32
    assert depset._index_plane(8, CPU) is plane
    assert depset._pow2(1) == 1
    assert depset._pow2(8) == 8
    assert depset._pow2(9) == 16

    rng = random.Random(15)
    for num_rows in (7, 8, 9):
        sets = [random_instance_set(rng, 3) for _ in range(num_rows)]
        batch = depset.normalized(device_deps.to_batch(sets, 3, "cpu"))
        leaders = np.asarray([rng.randrange(3) for _ in range(num_rows)],
                             dtype=np.int32)
        vids = np.asarray([rng.randrange(45) for _ in range(num_rows)],
                          dtype=np.int32)
        got = depset.contains(batch, leaders, vids).numpy()
        for r, instance_set in enumerate(sets):
            assert got[r] == instance_set.contains(
                Instance(int(leaders[r]), int(vids[r])))
    # 7 and 8 rows share the bucket-8 plane; 9 rows adds bucket 16.
    assert depset._index_plane.cache_info().currsize == 2


def test_contains_and_size_match_host():
    rng = random.Random(5)
    sets = [random_instance_set(rng, 3) for _ in range(8)]
    batch = device_deps.to_batch(sets, 3, "cpu")
    normalized = depset.normalized(batch)
    sizes = depset.size(normalized).numpy()
    for b, instance_set in enumerate(sets):
        assert int(sizes[b]) == len(instance_set.materialize())
        for _ in range(10):
            leader = rng.randrange(3)
            vid = rng.randrange(45)
            got = bool(depset.contains(
                normalized, np.full(len(sets), leader, dtype=np.int32),
                np.full(len(sets), vid, dtype=np.int32))[b])
            assert got == instance_set.contains(Instance(leader, vid))


# --- (c) the column cases of tests/test_depruns.py -------------------------

NUM_LEADERS = 3


def random_set(rng: random.Random,
               num_leaders: int = NUM_LEADERS) -> InstancePrefixSet:
    columns = []
    for _ in range(num_leaders):
        watermark = rng.randrange(0, 50)
        tail = {watermark + rng.randrange(0, 30)
                for _ in range(rng.randrange(0, 5))}
        columns.append(IntPrefixSet(watermark, tail))
    return InstancePrefixSet(num_leaders, columns)


def materialize(s: InstancePrefixSet) -> set:
    out = set()
    for leader, column in enumerate(s.columns):
        for i in range(column.watermark):
            out.add((leader, i))
        for v in column.values:
            out.add((leader, v))
    return out


class TestColumns:
    def test_roundtrip_vs_oracle(self):
        rng = random.Random(3)
        for _ in range(20):
            sets = [random_set(rng) for _ in range(rng.randrange(1, 9))]
            columns = depruns.sets_to_columns(sets)
            assert columns is not None
            num_leaders, watermarks, counts, values = columns
            assert num_leaders == NUM_LEADERS
            rebuilt = []
            for wm, ct, vals in depruns.split_columns(*columns):
                cols = []
                offset = 0
                for watermark, count in zip(wm, ct):
                    cols.append(IntPrefixSet(
                        watermark, set(vals[offset:offset + count])))
                    offset += count
                rebuilt.append(InstancePrefixSet(num_leaders, cols))
            assert [materialize(s) for s in rebuilt] == \
                [materialize(s) for s in sets]

    def test_ragged_columns_decline(self):
        assert depruns.sets_to_columns([InstancePrefixSet(2),
                                        InstancePrefixSet(3)]) is None
        assert depruns.sets_to_columns([]) is None

    def test_split_columns_rejects_ragged_input(self):
        with pytest.raises(ValueError):
            list(depruns.split_columns(2, (1, 2, 3), (0, 0, 0), ()))
        with pytest.raises(ValueError):
            list(depruns.split_columns(2, (1, 2), (1, 2), (5,)))

    def test_columns_to_batch_matches_oracle(self):
        rng = random.Random(11)
        sets = [random_set(rng) for _ in range(6)]
        batch = depruns.columns_to_batch(*depruns.sets_to_columns(sets),
                                         device="cpu")
        assert batch is not None
        for b, original in enumerate(sets):
            assert materialize(row(batch, b)) == materialize(original)

    def test_columns_to_batch_window_overflow_declines(self):
        wide = InstancePrefixSet(1, [IntPrefixSet(
            0, {5, depruns.MAX_TAIL_WINDOW + 700})])
        assert depruns.columns_to_batch(*depruns.sets_to_columns([wide]),
                                        device="cpu") is None
        narrow = InstancePrefixSet(1, [IntPrefixSet(
            0, {depruns.MAX_TAIL_WINDOW + 700})])
        assert depruns.columns_to_batch(
            *depruns.sets_to_columns([narrow]), device="cpu") is not None

    def test_drain_union_matches_host_union(self):
        rng = random.Random(29)
        for _ in range(10):
            sets = [random_set(rng) for _ in range(rng.randrange(1, 7))]
            batch = depruns.columns_to_batch(
                *depruns.sets_to_columns(sets), device="cpu")
            watermarks, tails, tail_base = depruns.drain_union(batch)
            device = device_deps.from_row(watermarks, tails, tail_base)
            host = InstancePrefixSet(NUM_LEADERS)
            for s in sets:
                host.add_all(s)
            assert materialize(device) == materialize(host)


@pytest.mark.parametrize("seed", range(3))
def test_columns_to_batch_matches_jax(seed):
    """The scatter gives the JAX package's arrays, byte for byte."""
    from frankenpaxos_tpu.runs import depruns as jdepruns

    rng = random.Random(seed)
    sets = [random_set(rng) for _ in range(rng.randrange(1, 12))]
    columns = depruns.sets_to_columns(sets)
    assert_same(jdepruns.columns_to_batch(*columns),
                depruns.columns_to_batch(*columns, device="cpu"))


# --- (d) routing --------------------------------------------------------------


def test_cpu_tensors_launch_nothing():
    rng = np.random.default_rng(9)
    _, t = both(*random_batch(rng))
    wrappers = (depset.normalized, depset.union_reduce, depset.conflict_max,
                depset.all_equal)
    before = [w.launches for w in wrappers]
    depset.normalized(t)
    depset.union_reduce(t)
    depset.conflict_max(torch.zeros(2, dtype=torch.int32), t)
    depset.all_equal(t)
    assert [w.launches for w in wrappers] == before


def test_other_devices_raise():
    """A ``meta`` batch reaches no plain version: every wrapper raises."""
    meta = depset.DepSetBatch(
        torch.zeros((2, 3), dtype=torch.int32, device="meta"),
        torch.zeros((2, 3, 8), dtype=torch.uint8, device="meta"),
        torch.zeros((), dtype=torch.int32, device="meta"))
    for fn in (depset.normalized, depset.union_reduce, depset.all_equal):
        with pytest.raises(ValueError, match="meta"):
            fn(meta)
    with pytest.raises(ValueError, match="meta"):
        depset.conflict_max(torch.zeros(2, dtype=torch.int32,
                                        device="meta"), meta)
    with pytest.raises(ValueError):  # a CPU seqs beside a meta batch
        depset.conflict_max(torch.zeros(2, dtype=torch.int32), meta)
    for fn in (depset.size,):
        with pytest.raises(ValueError, match="meta"):
            fn(meta)
    for fn in (depset.union, depset.equal, depset.intersect):
        with pytest.raises(ValueError, match="meta"):
            fn(meta, meta)
    with pytest.raises(ValueError, match="meta"):
        depset.compact(meta, np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="meta"):
        depset.contains(meta, np.zeros(2, np.int32), np.zeros(2, np.int32))
    _, cpu = both(*random_batch(np.random.default_rng(0), 2, 3, 8))
    with pytest.raises(ValueError):  # a CPU batch beside a meta one
        depset.union(cpu, meta)


def test_new_wrappers_launch_nothing_on_the_cpu():
    rng = np.random.default_rng(10)
    _, t = both(*random_batch(rng, 3, 5, 8))
    wrappers = (depset.union, depset.intersect, depset.compact,
                depset.equal, depset.size, depset.contains)
    before = [w.launches for w in wrappers]
    depset.union(t, t)
    depset.intersect(t, t)
    depset.compact(t, np.zeros(5, np.int32))
    depset.equal(t, t)
    depset.size(t)
    depset.contains(t, 0, 3)
    assert [w.launches for w in wrappers] == before


# --- K16 / K17: plain versions, hazards, and the kernel path ------------------


@pytest.mark.parametrize("seed", range(2))
def test_contains_plain_matches_jax(seed):
    rng = np.random.default_rng(4500 + seed)
    for _ in range(16):
        wm, tails, base = random_batch(rng)
        b, l, w = tails.shape
        leader = rng.integers(-l - 2, l + 2, size=b).astype(np.int32)
        vid = np.clip(int(base) + rng.integers(-20, w + 20, size=b),
                      -2**31, 2**31 - 1).astype(np.int32)
        j, t = both(wm, tails, base)
        assert_same(jdepset.contains(j, jnp.asarray(leader),
                                     jnp.asarray(vid)),
                    depset.contains_plain(t, leader, vid))


#: ``executed`` shapes that broadcast against ``[B, L]`` watermarks.
EXECUTED_SHAPES = ("scalar", "row", "one_by_l", "full")


def _executed_of(rng, kind, b, l, base, w):
    shape = {"scalar": (), "row": (l,), "one_by_l": (1, l),
             "full": (b, l)}[kind]
    return np.clip(int(base) + rng.integers(-8, w + 8, size=shape),
                   -2**31, 2**31 - 1).astype(np.int32)


@pytest.mark.parametrize("kind", EXECUTED_SHAPES)
@pytest.mark.parametrize("plain", [False, True])
def test_compact_broadcasts_like_jax(plain, kind):
    fn = depset.compact_plain if plain else depset.compact
    rng = np.random.default_rng(6000 + len(kind))
    for _ in range(12):
        wm, tails, base = random_batch(rng)
        b, l, w = tails.shape
        executed = _executed_of(rng, kind, b, l, base, w)
        j, t = both(wm, tails, base)
        assert_same(jdepset.compact(j, jnp.asarray(executed)),
                    fn(t, executed))


@pytest.mark.parametrize("base", [2**31 - 1, 2**31 - 5, -2**31])
def test_pair_and_query_near_int32_wrap(base):
    """Tail bases at the int32 edges: ids ``base + w`` wrap negative and
    every compare is signed; bytes other than 0/1."""
    rng = np.random.default_rng(base % 1000)
    for kind in range(3):
        a = random_batch(rng, 4, 3, 37, base, kind)
        b = random_batch(rng, 4, 3, 37, base, kind)
        (ja, ta), (jb, tb) = both(*a), both(*b)
        for name in ("union", "intersect", "equal"):
            assert_same(getattr(jdepset, name)(ja, jb),
                        getattr(depset, name)(ta, tb))
        assert_same(jdepset.size(ja), depset.size(ta))
        executed = np.full(3, base, np.int32)
        assert_same(jdepset.compact(ja, jnp.asarray(executed)),
                    depset.compact(ta, executed))
        vid = np.int32(base)
        for leader in (-1, 0, 2, 3, 7):
            assert_same(jdepset.contains(ja, jnp.int32(leader),
                                         jnp.asarray(vid)),
                        depset.contains(ta, leader, vid))


def test_aliased_inputs_and_scalar_queries():
    """``union(deps, deps)`` as libbench calls it, the same batch on both
    sides of intersect and equal, and scalar leader / vid on both sides
    of the window, leaders -1 and >= L."""
    rng = np.random.default_rng(77)
    wm, tails, base = random_batch(rng, 5, 3, 64, 1 << 16, 0)
    j, t = both(wm, tails, base)
    for name in ("union", "intersect", "equal"):
        assert_same(getattr(jdepset, name)(j, j),
                    getattr(depset, name)(t, t))
    assert bool(depset.equal(t, t).all())
    for leader in (-1, -3, -4, 0, 2, 3, 9):
        for vid in (int(base) - 1, int(base), int(base) + 63,
                    int(base) + 64, int(base) + 1000, -2**31, 2**31 - 1):
            assert_same(jdepset.contains(j, jnp.int32(leader),
                                         jnp.int32(vid)),
                        depset.contains(t, leader, vid))


def test_pair_and_query_refuse_mismatched_shapes():
    rng = np.random.default_rng(5)
    _, a = both(*random_batch(rng, 3, 2, 8))
    _, b = both(*random_batch(rng, 3, 2, 16))
    for fn in (depset.union, depset.intersect, depset.equal,
               depset.union_plain, depset.intersect_plain,
               depset.equal_plain):
        with pytest.raises(ValueError, match="shape"):
            fn(a, b)
    empty = depset.DepSetBatch(torch.zeros((2, 0), dtype=torch.int32),
                               torch.zeros((2, 0, 8), dtype=torch.uint8),
                               torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="leader column"):
        depset.contains(empty, 0, 0)


def test_empty_batches_give_empty_results():
    rng = np.random.default_rng(6)
    wm, tails, base = random_batch(rng, 0, 3, 8)
    j, t = both(wm, tails, base)
    for name in ("union", "intersect", "equal"):
        assert_same(getattr(jdepset, name)(j, j),
                    getattr(depset, name)(t, t))
    assert_same(jdepset.size(j), depset.size(t))
    assert depset.contains(t, 0, 0).shape == (0,)


class _Recorder:
    """Stands in for the kernel library: records each entry point's
    arguments, launches nothing, returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 0

        return call


def test_pair_and_query_kernel_path_arguments(monkeypatch):
    """With the kernel path forced on CPU tensors: K16 and K17 pass as
    many arguments as their C signatures (union's packed block of 13
    int64: the six tensors, a's base and out's base when out= has its
    own, rows, width, the aliased flag, device, stream), the mode, the
    broadcast strides of ``executed`` / ``leader`` / ``vid`` (0 on a
    broadcast axis), no ``b`` batch for compact, size and contains; one
    launch counts once; an empty batch launches and counts nothing."""
    from frankenpaxos_tpu_torch.ops import _build

    recorder = _Recorder()
    monkeypatch.setattr(depset, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda name: recorder)
    monkeypatch.setattr(_build, "stream_args", lambda device: (0, None))
    monkeypatch.setattr(_build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(_build, "stream_handle", lambda index: 0)
    monkeypatch.setattr(depset._K16_UNION, "fn", None)
    wrappers = (depset.union, depset.intersect, depset.compact,
                depset.equal, depset.size, depset.contains)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
    sig = _build.SIGNATURES["depset"]
    _, t = both(*random_batch(np.random.default_rng(1), 4, 3, 8))

    def last(entry, mode):
        got, args = recorder.calls[-1]
        assert got == entry and len(args) == len(sig[entry])
        assert args[0] == mode
        return args

    got = depset.union(t, t)
    entry, args = recorder.calls[-1]
    args = struct.unpack("=13q", args[0])
    assert entry == "fpx_depset_union" and sig[entry] is _build._B
    assert args[2] == args[0] and args[3] == args[1]
    assert args[4:6] == (got.watermarks.data_ptr(), got.tails.data_ptr())
    assert args[6:11] == (0, 0, 12, 8, 1) and got.tail_base is t.tail_base
    _, u = both(*random_batch(np.random.default_rng(3), 4, 3, 8))
    out = depset.DepSetBatch(torch.empty_like(t.watermarks),
                             torch.empty_like(t.tails),
                             torch.zeros((), dtype=torch.int32))
    assert depset.union(t, u, out=out) is out
    args = struct.unpack("=13q", recorder.calls[-1][1][0])
    assert args[2:4] == (u.watermarks.data_ptr(), u.tails.data_ptr())
    assert args[6:8] == (t.tail_base.data_ptr(), out.tail_base.data_ptr())
    assert args[8:11] == (12, 8, 0)
    depset.intersect(t, t)
    last("fpx_depset_pair", 1)
    for executed, strides in ((np.int32(3), (0, 0)),
                              (np.zeros(3, np.int32), (0, 1)),
                              (np.zeros((1, 3), np.int32), (0, 1)),
                              (np.zeros((4, 3), np.int32), (3, 1))):
        depset.compact(t, executed)
        args = last("fpx_depset_pair", 2)
        assert args[3] is None and args[5] is not None
        assert args[6:8] == strides
    depset.equal(t, t)
    args = last("fpx_depset_query", 0)
    assert args[3] is not None and args[10:13] == (4, 3, 8)
    depset.size(t)
    args = last("fpx_depset_query", 1)
    assert args[3] is None and args[5] is None
    depset.contains(t, 1, np.arange(4, dtype=np.int32))
    args = last("fpx_depset_query", 2)
    assert args[6] == 0 and args[8] == 1
    assert [w.launches for w in wrappers] == [2, 1, 4, 1, 1, 1]
    calls = len(recorder.calls)
    _, empty = both(*random_batch(np.random.default_rng(2), 0, 3, 8))
    depset.union(empty, empty)
    depset.size(empty)
    depset.contains(empty, 0, 0)
    assert len(recorder.calls) == calls
    assert [w.launches for w in wrappers] == [2, 1, 4, 1, 1, 1]
