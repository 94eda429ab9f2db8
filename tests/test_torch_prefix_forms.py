"""K13's forms and split, and the ``out=`` paths of K13 and K16's union.

(a) A numpy model of K13's CTA form (``csrc/watermark.cu::
prefix_cta_kernel``): tile by tile, the first zero and the first element
outside {0, 1} of the tile; the answer is the first zero's index (or L)
unless the second comes first, and only then the ordered (product, sum)
scan from that tile on, a sub-tile at a time, stopping once the product
is 0; in the vector form a row that starts off the 16-byte grid shifts
every tile by its head. The model is held against the JAX
``contiguous_prefix_length`` on bool rows, 0/1 and arbitrary uint8,
int8, int16, int32 and int64 with high bits, zeros at each side of a
tile boundary and inside a 16-byte word, and empty axes; so is the
port's wrapper.
(b) ``prefix_form``: the form the C entry picks from the row length and
the element stride, on shapes and views of every form.
(c) The ``out=`` paths of ``contiguous_prefix_length`` and ``union`` on
the CPU, and the union's aliased case against the JAX ``union``.

Integer outputs, so every comparison is exact.
"""

from frankenpaxos_tpu_torch.convert import depset_from_jax, depset_to_numpy
from frankenpaxos_tpu_torch.ops import depset, watermark as tw
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import depset as jdepset, watermark as jw

#: ``csrc/watermark.cu``'s CTA form: threads, and the chunks a thread
#: loads a tile (16-byte words in the vector form, elements in the
#: scalar one).
CTA_THREADS, VECTOR_CHUNKS, SCALAR_CHUNKS = 512, 4, 8
M32 = 0xFFFFFFFF


def _as_u32(x: np.ndarray) -> np.ndarray:
    """``astype(int32)`` read as uint32: sign- or zero-extended, the low
    32 bits kept."""
    return (x.astype(np.int64) & M32).astype(np.uint64)


def _fold(values, p: int, s: int) -> tuple:
    for v in values:
        p = (p * int(v)) & M32
        s = (s + p) & M32
    return p, s


def model_row(row: np.ndarray, vector: bool, head: int = 0) -> int:
    """K13's CTA form on one row, as the kernel splits it: in the vector
    form the row starts ``head`` elements past a 16-byte boundary, so
    its tiles start at element ``-head`` (strided rows: 0)."""
    v = _as_u32(row)
    length = len(v)
    per = 16 // row.dtype.itemsize if vector else 1
    sub = CTA_THREADS * per  # chunk j of every thread, in thread order
    tile = sub * (VECTOR_CHUNKS if vector else SCALAR_CHUNKS)
    lo = -head if vector else 0
    while True:
        t = v[max(lo, 0):lo + tile]
        zeros = np.flatnonzero(t == 0)
        others = np.flatnonzero(t > 1)
        zero = max(lo, 0) + zeros[0] if len(zeros) else None
        other = max(lo, 0) + others[0] if len(others) else None
        if other is not None and (zero is None or other < zero):
            p, s = 1, max(lo, 0) & M32  # the ones before this tile
            for at in range(lo, length, sub):
                p, s = _fold(v[max(at, 0):at + sub], p, s)
                if p == 0:
                    break
            return s
        if zero is not None:
            return int(zero) & M32
        if lo + tile >= length:
            return length & M32
        lo += tile


def model(x: np.ndarray, vector: bool = True, head: int = 0) -> np.ndarray:
    """The model over the leading axes, as int32."""
    rows = x.reshape(-1, x.shape[-1]) if x.shape[-1] else \
        np.zeros((int(np.prod(x.shape[:-1])), 0), x.dtype)
    got = np.array([model_row(r, vector, head) for r in rows], np.uint32)
    return got.view(np.int32).reshape(x.shape[:-1])


def _ref(x: np.ndarray) -> np.ndarray:
    return np.asarray(jw.contiguous_prefix_length(jnp.asarray(x)))


def _tile(dtype, vector: bool) -> int:
    per = 16 // np.dtype(dtype).itemsize if vector else 1
    return CTA_THREADS * per * (VECTOR_CHUNKS if vector else SCALAR_CHUNKS)


def _cases(rng, dtype, vector: bool) -> np.ndarray:
    """``[R, L]`` rows of one dtype across two tiles and a ragged third:
    all-ones rows with a zero at each side of each tile boundary and at
    each byte of a 16-byte word, values outside {0, 1} before and after
    the first zero, products that wrap to 0, and random rows."""
    tile = _tile(dtype, vector)
    length = 2 * tile + 37
    info = np.iinfo(dtype) if dtype != bool else None
    rows = []
    for at in (0, 1, 15, 16, 17, tile - 1, tile, tile + 1, 2 * tile - 1,
               2 * tile, length - 1):
        r = np.ones(length, dtype)
        r[at] = 0
        rows.append(r)
    rows.append(np.ones(length, dtype))  # no zero: L
    if dtype != bool:
        big = min(int(info.max), 3)
        for other, zero in ((5, 40), (tile + 3, tile + 9), (50, 7),
                            (tile - 1, tile + 2), (2 * tile + 1, None)):
            r = np.ones(length, dtype)
            r[other] = big
            if zero is not None:
                r[zero] = 0
            rows.append(r)
        if info.min < 0:  # -1 sign-extends to 0xffffffff
            r = np.ones(length, dtype)
            r[tile + 5] = -1
            r[tile + 700] = 0
            rows.append(r)
        if np.dtype(dtype).itemsize >= 4:  # products that wrap to 0
            r = np.ones(length, dtype)
            r[3] = r[tile + 4] = 1 << 16
            rows.append(r)
        if dtype == np.int64:  # the high bits dropped: 2^32 is a zero
            r = np.full(length, (1 << 32) + 1, dtype)
            r[tile + 11] = 1 << 32
            rows.append(r)
        lo = 0 if info.min == 0 else -2
        rows.append(rng.integers(lo, 3, size=length).astype(dtype))
        r = rng.integers(1, 3, size=length).astype(dtype)
        r[: tile + 20] = 1
        r[tile + 20] = 2
        rows.append(r)
    else:
        rows.append(rng.random(length) < 0.9999)
    return np.stack(rows)


DTYPES = (bool, np.uint8, np.int8, np.int16, np.int32, np.int64)


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_model_of_the_split_matches_jax(dtype, vector):
    x = _cases(np.random.default_rng(17), dtype, vector)
    want = _ref(x)
    per = 16 // np.dtype(dtype).itemsize
    # Rows on the 16-byte grid, and (vector form) one and per - 1
    # elements past it: the head word read element by element.
    for head in ((0, 1, per - 1) if vector and per > 1 else (0,)):
        np.testing.assert_array_equal(model(x, vector, head), want)
    np.testing.assert_array_equal(
        tw.contiguous_prefix_length(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_model_on_short_and_empty_rows(dtype):
    """Rows shorter than a tile (libbench's [4096] with its first False
    at 2048), one element, and empty last and leading axes."""
    rng = np.random.default_rng(5)
    present = np.ones(4096, dtype)
    present[2048] = 0
    assert int(model(present)) == int(_ref(present)) == 2048
    lo = 0 if dtype in (bool, np.uint8) else -3
    hi = 2 if dtype == bool else 4
    for shape in ((3, 1), (5, 600), (2, 3, 530), (3, 0), (0, 4)):
        x = rng.integers(lo, hi, size=shape).astype(dtype)
        if x.size and x.shape[-1] > 1:
            x[..., : x.shape[-1] // 2] = 1
        head = min(3, 16 // np.dtype(dtype).itemsize - 1)
        for vector, h in ((True, 0), (True, head), (False, 0)):
            np.testing.assert_array_equal(model(x, vector, h), _ref(x))


# --- (b) prefix_form -----------------------------------------------------------


def test_prefix_form_follows_length_and_stride():
    flat = torch.ones(4096 + 64, dtype=torch.bool)
    for off in range(16):  # views 0-15 bytes off the 16-byte grid
        assert tw.prefix_form(flat[off:off + 4096]) == "cta_vector"
    assert tw.prefix_form(flat[::2]) == "cta_scalar"  # strided
    assert tw.prefix_form(torch.ones((4096, 3), dtype=torch.bool)) \
        == "thread"
    assert tw.prefix_form(torch.ones((1024, 40), dtype=torch.int8)) \
        == "warp"
    for length, form in ((16, "thread"), (17, "warp"), (512, "warp"),
                         (513, "cta_vector")):
        assert tw.prefix_form(torch.ones((4, length), dtype=torch.bool)) == form
        assert tw.prefix_form(torch.ones((length, 4), dtype=torch.int32).t()) \
            == ("cta_scalar" if form == "cta_vector" else form)
    assert tw.prefix_form(torch.ones((64, 100003), dtype=torch.bool)) \
        == "cta_vector"
    assert tw.prefix_form(torch.ones((2, 3, 520), dtype=torch.int64)) \
        == "cta_vector"
    assert tw.prefix_form(torch.ones((2, 3, 1040), dtype=torch.int16)
                          [..., ::2]) == "cta_scalar"
    with pytest.raises(ValueError):
        tw.prefix_form(torch.ones(600, dtype=torch.float32))


# --- (c) out= and the union's aliased case -------------------------------------


def test_contiguous_prefix_length_out_on_the_cpu():
    x = np.ones((6, 50), bool)
    x[np.arange(6), np.arange(6) * 7] = False
    out = torch.full((6,), 9, dtype=torch.int32)
    got = tw.contiguous_prefix_length(torch.from_numpy(x), out=out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), _ref(x))
    scalar = torch.zeros((), dtype=torch.int32)
    assert tw.contiguous_prefix_length(torch.ones(9, dtype=torch.bool),
                                       out=scalar) is scalar
    assert int(scalar) == 9
    for bad in (torch.zeros(5, dtype=torch.int32),
                torch.zeros(6, dtype=torch.int64),
                torch.zeros((6, 2), dtype=torch.int32)[:, 0]):
        with pytest.raises(ValueError, match="out"):
            tw.contiguous_prefix_length(torch.from_numpy(x), out=bad)
    assert tw.contiguous_prefix_length.launches == 0


def _batch(rng, b, l, w, base):
    wm = np.clip(base + rng.integers(-8, w + 8, size=(b, l)),
                 -2**31, 2**31 - 1).astype(np.int32)
    tails = rng.integers(0, 256, size=(b, l, w)).astype(np.uint8)
    tails[rng.random((b, l, w)) < 0.5] = 0
    return wm, tails, np.int32(base)


@pytest.mark.parametrize("w", [1, 15, 16, 17, 37, 64])
def test_union_aliased_and_out_match_jax(w):
    rng = np.random.default_rng(40 + w)
    for base in (1 << 16, 2**31 - 3, -2**31):
        a_np, b_np = _batch(rng, 5, 3, w, base), _batch(rng, 5, 3, w, base)
        a_np[0][0, 0], b_np[0][0, 1] = 2**31 - 1, -2**31
        ja, jb = (jdepset.DepSetBatch(jnp.asarray(x[0]), jnp.asarray(x[1]),
                                      jnp.int32(x[2])) for x in (a_np, b_np))
        a, b = (depset_from_jax(*x, torch.device("cpu"))
                for x in (a_np, b_np))
        for jx, jy, x, y in ((ja, ja, a, a), (ja, jb, a, b)):
            want = jdepset.union(jx, jy)
            out = depset.DepSetBatch(
                torch.full_like(x.watermarks, 7),
                torch.full_like(x.tails, 7),
                torch.tensor(11, dtype=torch.int32))
            for got in (depset.union(x, y), depset.union(x, y, out=out)):
                for have, exp in zip(depset_to_numpy(got), want):
                    assert np.array_equal(have, np.asarray(exp))
            assert int(out.tail_base) == base
        # In place into a itself, and into b.
        want = jdepset.union(ja, jb)
        a2, b2 = (depset.DepSetBatch(*(t.clone() for t in x)) for x in (a, b))
        assert depset.union(a2, b2, out=a2) is a2
        assert depset.union(a, b2, out=b2) is b2
        for got in (a2, b2):
            for have, exp in zip(depset_to_numpy(got), want):
                assert np.array_equal(have, np.asarray(exp))
    bad = depset.DepSetBatch(torch.zeros((5, 3), dtype=torch.int32),
                             torch.zeros((5, 3, w + 1), dtype=torch.uint8),
                             torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="out"):
        depset.union(a, a, out=bad)
