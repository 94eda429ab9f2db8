"""K10 and K11 on a packed host block: one staged call per EPaxos /
BPaxos decision, against the JAX package.

(a) The port's ``device_deps.union_many``, ``conflict_max_many`` and
``all_identical`` (``pack`` into a block, the plain versions over that
block on the CPU, ``from_row`` back) against the JAX package's
``frankenpaxos_tpu/protocols/epaxos/device_deps.py`` (JAX on the CPU),
exactly, on seeded sets: 1-5 replies, 2-5 columns, tail widths 8-2048,
a span just over ``MAX_TAIL_WINDOW`` (the host algebra, counted by
``_count``), empty sets, watermarks near 2^31 - 1 and below 0, and
unequal sequence numbers.
(b) The packer's arrays against ``to_batch``'s, and
``depruns.columns_to_batch(out=)`` against the JAX package's
``columns_to_batch``.
(c) The staged call path with the C entry points stood in for by a
Python model of their packed blocks (offsets, the copy up, the plain
versions, the copy down): the wrappers' offsets, the results read back,
the launch counts; and the tensor wrappers' packed argument blocks.

The CUDA kernels and the staged entries themselves are held against the
plain versions on the H100 by ``chip_smoke.py`` (phase 13).
"""

import functools
import random
import struct
import zlib

from frankenpaxos_tpu_torch.compact import IntPrefixSet
from frankenpaxos_tpu_torch.ops import _build, depset
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.runs import depruns
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.compact import IntPrefixSet as JIntPrefixSet
from frankenpaxos_tpu.protocols.epaxos import device_deps as jdevice_deps
from frankenpaxos_tpu.protocols.epaxos.instance_prefix_set import (
    InstancePrefixSet as JInstancePrefixSet,
)

TOP = 2**31 - 1


# --- helpers -------------------------------------------------------------------


def spec_sets(rng: random.Random, replies: int, columns: int, width: int,
              low: int) -> list:
    """``replies`` sets of ``columns`` ``(watermark, values)`` columns,
    the values within ``width`` ids above ``low`` (watermarks a little
    below or inside the window), so that their tails span at most
    ``width`` ids; about one column in eight is empty. Ids stay below
    2^31 - 1, so that a watermark that absorbs its run stays int32 (the
    reference's ``jnp.int32`` refuses others)."""
    out = []
    for _ in range(replies):
        cols = []
        for _ in range(columns):
            watermark = min(TOP - 1,
                            low + rng.randrange(-3, max(4, width // 4)))
            if rng.random() < 0.125:
                cols.append((watermark, set()))
                continue
            values = {v for v in (low + rng.randrange(width)
                                  for _ in range(rng.randrange(1, 6)))
                      if v < TOP}
            cols.append((watermark, values))
        out.append(cols)
    return out


def port_set(cols) -> InstancePrefixSet:
    return InstancePrefixSet(len(cols), [IntPrefixSet(w, v) for w, v in cols])


def jax_set(cols) -> JInstancePrefixSet:
    return JInstancePrefixSet(len(cols),
                              [JIntPrefixSet(w, v) for w, v in cols])


def columns_of(instance_set) -> list:
    """A set of either package as ``[(watermark, sorted values)]``."""
    return [(c.watermark, sorted(c.values)) for c in instance_set.columns]


class Metrics:
    """The two runtime counters ``_count`` feeds."""

    def __init__(self):
        self.batches, self.fallbacks = [], 0

    def depset_batch(self, n: int) -> None:
        self.batches.append(n)

    def depset_span_fallback(self) -> None:
        self.fallbacks += 1


#: (replies, columns, tail width, window low end): every reply count
#: 1-5, 2-5 columns, widths 8-2048, and lows at 0, in the negatives and
#: next to 2^31 - 1 (where the int32 ids of the window wrap).
CASES = [(b, l, w, low)
         for b, l, w, low in (
             (1, 2, 8, 0), (2, 2, 8, 100), (2, 2, 64, 4000),
             (2, 2, 2048, 1000), (3, 5, 8, 37), (4, 5, 8, 12),
             (5, 5, 16, -40), (3, 3, 512, -2**31 + 5), (4, 4, 128, 7),
             (5, 5, 2048, 0), (2, 2, 8, TOP - 5), (3, 5, 32, TOP - 20),
             (4, 3, 8, -9), (5, 2, 256, TOP - 300))]


def _seed(*key) -> int:
    """A seed from a case, the same in every process."""
    return zlib.crc32(repr(key).encode())


def _both(sets_cols):
    return ([port_set(c) for c in sets_cols],
            [jax_set(c) for c in sets_cols])


# --- (a) the three decisions against the JAX package ----------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_union_many_matches_jax(case, seed):
    b, l, w, low = case
    rng = random.Random(_seed((case, seed)))
    ports, jaxes = _both(spec_sets(rng, b, l, w, low))
    metrics = Metrics()
    got = device_deps.union_many(ports, l, "cpu", metrics=metrics)
    want = jdevice_deps.union_many(jaxes, l)
    assert columns_of(got) == columns_of(want)
    assert metrics.batches == [b] and metrics.fallbacks == 0


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_conflict_max_many_matches_jax(case, seed):
    b, l, w, low = case
    rng = random.Random(_seed((case, seed, "seq")))
    ports, jaxes = _both(spec_sets(rng, b, l, w, low))
    seqs = [rng.choice([rng.randrange(-50, 50), rng.randrange(2**31),
                        -2**31 + rng.randrange(10)]) for _ in range(b)]
    got_seq, got = device_deps.conflict_max_many(list(zip(seqs, ports)), l,
                                                  "cpu")
    want_seq, want = jdevice_deps.conflict_max_many(list(zip(seqs, jaxes)),
                                                    l)
    assert got_seq == want_seq == max(seqs)
    assert columns_of(got) == columns_of(want)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_all_identical_matches_jax(case, seed):
    """Equal, unequal, and equal-only-as-sets replies (one written with
    ids below its watermark as tail values), and unequal sequence
    numbers."""
    b, l, w, low = case
    rng = random.Random(_seed((case, seed, "eq")))
    first = spec_sets(rng, 1, l, w, low)[0]
    replies = [first] * b
    variants = {"equal": replies}
    if b > 1:
        other = spec_sets(rng, 1, l, w, low)[0]
        variants["unequal"] = replies[:-1] + [other]
        # The same sets, one column's prefix end spelled as a tail value.
        wm0, vals0 = first[0]
        variants["respelled"] = replies[:-1] + [
            [(wm0 - 1, vals0 | {wm0 - 1})] + first[1:]]
    for name, sets_cols in variants.items():
        ports, jaxes = _both(sets_cols)
        for seqs in ([7] * b, [7] * (b - 1) + [8]):
            got = device_deps.all_identical(list(zip(seqs, ports)), l,
                                            "cpu")
            want = jdevice_deps.all_identical(list(zip(seqs, jaxes)), l)
            assert got == want, (name, seqs)
    if b > 1:
        assert device_deps.all_identical(
            list(zip([7] * b, _both(variants["respelled"])[0])), l, "cpu")


def test_span_over_the_window_takes_the_host_algebra():
    """Tails spanning MAX_TAIL_WINDOW + 1 ids: every decision takes the
    reference's host algebra, equal to the JAX package's, and ``_count``
    records the fallback; a span of exactly the window stays packed."""
    limit = device_deps.MAX_TAIL_WINDOW
    wide = [[(0, {5}), (3, {9})], [(2, {5 + limit}), (0, set())]]
    ports, jaxes = _both(wide)
    metrics = Metrics()
    got = device_deps.union_many(ports, 2, "cpu", metrics=metrics)
    assert columns_of(got) == columns_of(jdevice_deps.union_many(jaxes, 2))
    assert metrics.batches == [2] and metrics.fallbacks == 1
    seq, got = device_deps.conflict_max_many(list(zip((3, 9), ports)), 2,
                                             "cpu", metrics=metrics)
    want_seq, want = jdevice_deps.conflict_max_many(
        list(zip((3, 9), jaxes)), 2)
    assert seq == want_seq == 9 and columns_of(got) == columns_of(want)
    assert device_deps.all_identical(
        list(zip((1, 1), ports)), 2, "cpu", metrics=metrics) \
        == jdevice_deps.all_identical(list(zip((1, 1), jaxes)), 2)
    assert metrics.fallbacks == 3
    assert device_deps.pack(ports, 2, "cpu") is None
    edge = [[(0, {5}), (0, set())], [(0, {4 + limit}), (0, set())]]
    p = device_deps.pack(_both(edge)[0], 2, "cpu")
    assert p is not None and p.tails.shape == (2, 2, limit)


def test_empty_sets_match_jax():
    for b, l in ((1, 2), (3, 5), (2, 3)):
        ports = [InstancePrefixSet(l) for _ in range(b)]
        jaxes = [JInstancePrefixSet(l) for _ in range(b)]
        assert columns_of(device_deps.union_many(ports, l, "cpu")) \
            == columns_of(jdevice_deps.union_many(jaxes, l))
        seqs = list(range(b))
        got = device_deps.conflict_max_many(list(zip(seqs, ports)), l, "cpu")
        want = jdevice_deps.conflict_max_many(list(zip(seqs, jaxes)), l)
        assert got[0] == want[0] and columns_of(got[1]) == columns_of(
            want[1])
        assert device_deps.all_identical(list(zip([0] * b, ports)), l,
                                         "cpu") \
            == jdevice_deps.all_identical(list(zip([0] * b, jaxes)), l)


# --- (b) the packer's arrays ---------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=str)
def test_pack_equals_to_batch(case):
    """The packed block holds to_batch's arrays, and seqs wrapped to
    int32; a set with fewer columns than replicas leaves zero rows."""
    b, l, w, low = case
    rng = random.Random(_seed(case))
    sets = [port_set(c) for c in spec_sets(rng, b, l, w, low)]
    seqs = [rng.randrange(-2**31, 2**31) for _ in range(b)]
    want = device_deps.to_batch(sets, l, "cpu")
    for packed_seqs in (None, seqs):
        p = device_deps.pack(sets, l, "cpu", seqs=packed_seqs)
        assert np.array_equal(p.watermarks, want.watermarks.numpy())
        assert np.array_equal(p.tails, want.tails.numpy())
        assert int(p.tail_base) == int(want.tail_base)
        assert p.seqs.tolist() == ([] if packed_seqs is None else seqs)
    short = sets[:1] + [InstancePrefixSet(1, [IntPrefixSet(low, {low})])]
    p = device_deps.pack(short, l, "cpu")
    want = device_deps.to_batch(short, l, "cpu")
    assert np.array_equal(p.watermarks, want.watermarks.numpy())
    assert np.array_equal(p.tails, want.tails.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_columns_to_batch_out_matches_jax(seed):
    """``columns_to_batch(out=)`` writes the JAX package's arrays into
    the packed block, seqs beside them; ``drain_union`` of the block
    equals the JAX package's ``drain_union``."""
    from frankenpaxos_tpu.runs import depruns as jdepruns

    rng = random.Random(seed)
    cases = spec_sets(rng, rng.randrange(1, 12), 3, rng.choice([8, 64, 500]),
                      rng.choice([0, 1000, -50]))
    columns = depruns.sets_to_columns([port_set(c) for c in cases])
    seqs = np.asarray([rng.randrange(1 << 20) for _ in cases], np.int32)
    want = jdepruns.columns_to_batch(*columns)
    block = depruns.columns_to_batch(
        *columns, out=functools.partial(depset.packed, device="cpu"),
        seqs=seqs)
    assert np.array_equal(block.watermarks, np.asarray(want.watermarks))
    assert np.array_equal(block.tails, np.asarray(want.tails))
    assert int(block.tail_base) == int(want.tail_base)
    assert np.array_equal(block.seqs, seqs)
    got = depruns.drain_union(block)
    expect = jdepruns.drain_union(want)
    assert np.array_equal(got[0], expect[0])
    assert np.array_equal(got[1], expect[1]) and got[2] == expect[2]
    seq, _, _ = depset.union_packed(block)
    assert seq == int(seqs.max())


# --- (c) the staged call path, with a model of the C entries ------------------


class FakeStaging:
    """A staging whose "pinned" and "device" buffers are numpy arrays,
    found again by address."""

    index, stream_handle = 0, 0

    def __init__(self):
        self.pairs, self.by_ptr = {}, {}

    def pair(self, name, n, dtype):
        got = self.pairs.get(name)
        if got is None or got.cap < n:
            cap = 1 << max(5, (n - 1).bit_length())
            host = np.zeros(cap, np.uint8)
            device = np.zeros(cap, np.uint8)
            got = self.pairs[name] = _build.Pair(
                cap, host, host.ctypes.data, device.ctypes.data, ())
            self.by_ptr[got.host_ptr] = host
            self.by_ptr[got.device_ptr] = device
        return got


def _ints(block: bytes, n: int) -> tuple:
    return struct.unpack(f"={n}q", block)


def _read(buf: np.ndarray, at: int, n: int, dtype) -> np.ndarray:
    size = np.dtype(dtype).itemsize * n
    return buf[at:at + size].view(dtype)


def _model_union(staging: FakeStaging, calls: list):
    """fpx_depset_union_staged's packed block, modelled: copy up, K10's
    plain version on the device copy, copy down."""
    def fn(block):
        (host_in, dev_in, in_bytes, host_out, dev_out, out_bytes, b, l, w, s,
         seqs_at, wm_at, base_at, tails_at, oseq_at, owm_at, otails_at,
         _, _) = _ints(block, 19)
        calls.append(("union", b, l, w, s))
        src, dev = staging.by_ptr[host_in], staging.by_ptr[dev_in]
        dev[:in_bytes] = src[:in_bytes]
        batch = depset.DepSetBatch(
            torch.from_numpy(_read(dev, wm_at, b * l, np.int32)
                             .reshape(b, l).copy()),
            torch.from_numpy(dev[tails_at:tails_at + b * l * w]
                             .reshape(b, l, w).copy()),
            torch.tensor(int(_read(dev, base_at, 1, np.int32)[0]),
                         dtype=torch.int32))
        out = staging.by_ptr[dev_out]
        if s:
            seq, row = depset.conflict_max_plain(
                torch.from_numpy(_read(dev, seqs_at, s, np.int32).copy()),
                batch)
            _read(out, oseq_at, 1, np.int32)[0] = int(seq)
        else:
            row = depset.union_reduce_plain(batch)
        _read(out, owm_at, l, np.int32)[:] = row.watermarks[0].numpy()
        out[otails_at:otails_at + l * w] = row.tails[0].numpy().reshape(-1)
        staging.by_ptr[host_out][:out_bytes] = out[:out_bytes]
        return 0

    return fn


def _model_equal(staging: FakeStaging, calls: list):
    def fn(block):
        (host_in, dev_in, in_bytes, host_out, dev_out, b, l, w, wm_at,
         base_at, tails_at, _, _) = _ints(block, 13)
        calls.append(("equal", b, l, w))
        src, dev = staging.by_ptr[host_in], staging.by_ptr[dev_in]
        dev[:in_bytes] = src[:in_bytes]
        batch = depset.DepSetBatch(
            torch.from_numpy(_read(dev, wm_at, b * l, np.int32)
                             .reshape(b, l).copy()),
            torch.from_numpy(dev[tails_at:tails_at + b * l * w]
                             .reshape(b, l, w).copy()),
            torch.tensor(int(_read(dev, base_at, 1, np.int32)[0]),
                         dtype=torch.int32))
        staging.by_ptr[dev_out][0] = bool(depset.all_equal_plain(batch))
        staging.by_ptr[host_out][0] = staging.by_ptr[dev_out][0]
        return 0

    return fn


@pytest.fixture
def modelled(monkeypatch):
    """The staged path on a FakeStaging, its two entries modelled."""
    staging, calls = FakeStaging(), []
    monkeypatch.setattr(_build, "staging", lambda table, device: staging)
    monkeypatch.setattr(depset._K10_STAGED, "fn",
                        _model_union(staging, calls))
    monkeypatch.setattr(depset._K11_STAGED, "fn",
                        _model_equal(staging, calls))
    for wrapper in (depset.union_reduce, depset.conflict_max,
                    depset.all_equal):
        monkeypatch.setattr(wrapper, "launches", 0)
    return calls


@pytest.mark.parametrize("case", CASES, ids=str)
def test_staged_path_reads_back_what_the_entries_write(modelled, case):
    """Each decision is ONE staged call with the block's offsets; its
    result, read back from the output block, equals the JAX package's;
    each call counts one launch of its kernel; the reused staging holds
    no state from the call before (sets of shrinking width)."""
    b, l, w, low = case
    rng = random.Random(_seed((case, "staged")))
    for width in (w, 8):
        ports, jaxes = _both(spec_sets(rng, b, l, width, low))
        seqs = [rng.randrange(1 << 20) for _ in range(b)]
        got = device_deps.union_many(ports, l)
        assert columns_of(got) == columns_of(
            jdevice_deps.union_many(jaxes, l))
        seq, got = device_deps.conflict_max_many(list(zip(seqs, ports)), l)
        want_seq, want = jdevice_deps.conflict_max_many(
            list(zip(seqs, jaxes)), l)
        assert seq == want_seq and columns_of(got) == columns_of(want)
        same = [ports[0]] * b
        assert device_deps.all_identical(list(zip([1] * b, same)), l)
        assert device_deps.all_identical(list(zip([1] * b, ports)), l) \
            == jdevice_deps.all_identical(list(zip([1] * b, jaxes)), l)
    kinds = [c[0] for c in modelled]
    assert kinds.count("union") == 4
    assert depset.union_reduce.launches == 2
    assert depset.conflict_max.launches == 2
    # One reply is identical to itself without a call.
    assert depset.all_equal.launches == kinds.count("equal") \
        == (0 if b == 1 else 4)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(block):
            self.calls.append((entry, block))
            return 0

        return call


def test_tensor_wrappers_pass_one_packed_block(monkeypatch):
    """With the kernel path forced on CPU tensors: K10's wrapper passes
    its 13 int64 slots (no seqs and no seq pointer in the union mode, S
    in the seq mode), K11's its 9; each launch counts once."""
    recorder = _Recorder()
    monkeypatch.setattr(depset, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(_build, "stream_handle", lambda index: 0)
    for entry in (depset._K10, depset._K11):
        monkeypatch.setattr(entry, "fn", None)
    for wrapper in (depset.union_reduce, depset.conflict_max,
                    depset.all_equal):
        monkeypatch.setattr(wrapper, "launches", 0)
    batch = depset.DepSetBatch(torch.zeros((4, 3), dtype=torch.int32),
                               torch.zeros((4, 3, 16), dtype=torch.uint8),
                               torch.tensor(5, dtype=torch.int32))
    depset.union_reduce(batch)
    entry, block = recorder.calls[-1]
    args = _ints(block, 13)
    assert entry == "fpx_depset_union_reduce"
    assert args[3:6] == (4, 3, 16) and args[6:8] == (0, 0) and args[10] == 0
    depset.conflict_max(torch.zeros(4, dtype=torch.int32), batch)
    args = _ints(recorder.calls[-1][1], 13)
    assert args[6] != 0 and args[7] == 4 and args[10] != 0
    depset.all_equal(batch)
    entry, block = recorder.calls[-1]
    args = _ints(block, 9)
    assert entry == "fpx_depset_all_equal" and args[3:6] == (4, 3, 16)
    assert [w.launches for w in (depset.union_reduce, depset.conflict_max,
                                 depset.all_equal)] == [1, 1, 1]


def test_packed_refuses_what_the_entries_do_not_take():
    p = depset.packed(0, 3, 8, 0, "cpu")
    with pytest.raises(ValueError, match="empty"):
        depset.union_packed(p)
    with pytest.raises(ValueError, match="empty"):
        depset.all_equal_packed(p)
    with pytest.raises(ValueError, match="seqs"):
        depset.all_equal_packed(depset.packed(2, 3, 8, 2, "cpu"))
    with pytest.raises(ValueError, match="columns"):
        device_deps.pack([port_set([(0, {1})] * 4)], 3, "cpu")
