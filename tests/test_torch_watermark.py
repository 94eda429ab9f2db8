"""The port's watermark reductions vs the JAX package's.

(a) K12 ``quorum_watermark``, its vector form and K13
``contiguous_prefix_length``: the plain versions bit-identical to the
JAX functions (on JAX's CPU backend) on random inputs from a numpy seed
and on every hazard: int64 input that wraps to int32, quorum sizes
outside ``[1, n]`` (JAX's index rules), per-row quorum sizes, values
near +-2^31, ties, empty axes; non-bool and wrapping K13 input.
(b) The watermark cases of ``tests/test_utils.py`` and the backend half
of ``test_gc_watermark_tpu_backend_matches_host``, repeated on the
port's ``utils/watermark.py`` with ``backend="cuda"`` on the CPU.
(c) ``convert.watermark_vector_from_numpy`` / ``_to_numpy``.
(d) The wrappers: launch counts, refusals, the ``out=`` contract, and
the kernel path's arguments against the C signatures (a stand-in
library, no card). K12 is also held at the warp kernel's widths (31-33,
64-65) on strided rows, and its vector form across changing shapes.

Integer outputs, so every comparison is exact.
"""

import random
import struct

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.ops import _build, watermark as tw
from frankenpaxos_tpu_torch.utils import QuorumWatermark, QuorumWatermarkVector
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import watermark as jw
from frankenpaxos_tpu.utils import watermark as jutils

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _ref_qw(w: np.ndarray, q) -> np.ndarray:
    q = jnp.asarray(q, dtype=jnp.int32)
    return np.asarray(jw.quorum_watermark(jnp.asarray(w), q))


def _port_qw(w: np.ndarray, q) -> np.ndarray:
    if isinstance(q, np.ndarray):
        q = torch.from_numpy(q.astype(np.int32))
    return tw.quorum_watermark(torch.from_numpy(w), q).numpy()


def _assert_same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- (a) K12 -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 9, 33, 64])
def test_quorum_watermark_every_quorum_size(n):
    """Random rows with ties, every q in [1, n] and the out-of-range
    sizes 0, -1, n + 1, 2n, 2n + 1 and the int32 extremes."""
    rng = np.random.default_rng(n)
    w = rng.integers(-50, 50, size=(17, n)).astype(np.int32)
    w[:4] = rng.integers(0, 3, size=(4, n))  # many ties
    for q in [*range(-1, n + 2), 2 * n, 2 * n + 1, INT32_MIN, INT32_MAX]:
        _assert_same(_port_qw(w, q), _ref_qw(w, q))


def test_quorum_watermark_pins_the_reference_index_rules():
    """For [5, 1, 9]: q = 0 and q = -1 give the int32 fill; q = n + 1
    counts from the end and gives the row's largest value."""
    w = np.array([5, 1, 9], dtype=np.int32)
    want = {0: INT32_MIN, -1: INT32_MIN, 1: 9, 2: 5, 3: 1, 4: 9, 5: 5,
            6: 1, 7: INT32_MIN}
    for q, value in want.items():
        assert int(_ref_qw(w, q)) == value
        assert int(_port_qw(w, q)) == value


@pytest.mark.parametrize("seed", range(3))
def test_quorum_watermark_extremes_and_leading_axes(seed):
    """Values near +-2^31, three axes, per-row quorum sizes (full and
    broadcast), B = 0 and n = 0."""
    rng = np.random.default_rng(100 + seed)
    w = rng.choice(np.array([INT32_MIN, INT32_MIN + 1, -1, 0, 1,
                             INT32_MAX - 1, INT32_MAX], dtype=np.int32),
                   size=(3, 4, 6))
    for q in (1, 3, 6):
        _assert_same(_port_qw(w, q), _ref_qw(w, q))
    per_row = rng.integers(-2, 9, size=(3, 4)).astype(np.int32)
    _assert_same(_port_qw(w, per_row), _ref_qw(w, per_row))
    column = rng.integers(0, 7, size=(3, 1)).astype(np.int32)
    _assert_same(_port_qw(w, column), _ref_qw(w, column))
    for empty in (np.zeros((0, 5), np.int32), np.zeros((4, 0), np.int32),
                  np.zeros((0,), np.int32)):
        for q in (0, 1, 2):
            _assert_same(_port_qw(empty, q), _ref_qw(empty, q))


def test_quorum_watermark_reads_strided_rows():
    """The vector form passes a transposed view: the same answers as a
    contiguous copy."""
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.integers(0, 99, size=(5, 7)).astype(np.int32))
    for q in range(1, 6):
        assert torch.equal(tw.quorum_watermark(m.t(), q),
                           tw.quorum_watermark(m.t().contiguous(), q))


@pytest.mark.parametrize("seed", range(4))
def test_quorum_watermark_vector_matches_reference(seed):
    """int64 host matrices, a quarter of whose entries lie outside int32:
    the port's ``"cpu"`` vector form wraps them as JAX's ``jnp.asarray``
    does, so it equals the reference's device answer, not the host
    oracle's."""
    rng = np.random.default_rng(200 + seed)
    for _ in range(10):
        n, depth = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        m = rng.integers(0, 1 << 34, size=(n, depth), dtype=np.int64)
        m[rng.random((n, depth)) < 0.75] %= 1 << 20
        for q in range(1, n + 1):
            got = tw.quorum_watermark_vector(m, q, device="cpu")
            want = np.asarray(jw.quorum_watermark_vector(m, q))
            _assert_same(got, want)


def test_quorum_watermark_vector_wraps_int64():
    w = np.array([[2**31 + 5, 1], [3, 2**32 + 7], [2**33, 4]], dtype=np.int64)
    got = tw.quorum_watermark_vector(w, 2, device="cpu")
    _assert_same(got, np.asarray(jw.quorum_watermark_vector(w, 2)))
    assert got.tolist() == [0, 4]
    # The host oracle keeps int64 and answers otherwise.
    host = QuorumWatermarkVector(3, 2)
    for i, row in enumerate(w):
        host.update(i, row)
    assert host.watermark(2) != got.tolist()


@pytest.mark.parametrize("n", [31, 32, 33, 64, 65, 1025, 2500])
def test_quorum_watermark_warp_widths_strided_per_row(n):
    """The warp kernel's widths (one element a lane up to 32, several
    above, tiles of 1024 above 1024), on strided rows (columns of a [n, B] matrix, as the vector
    form reads them) with ties, the int32 extremes and a per-row quorum
    size that wanders out of range, against JAX."""
    rng = np.random.default_rng(300 + n)
    b = 40
    w = rng.integers(-40, 40, size=(b, n)).astype(np.int32)
    w[:8] = rng.integers(0, 3, size=(8, n))  # many ties
    w[8:16] = rng.choice(np.array([INT32_MIN, INT32_MIN + 1, -1, 0, 1,
                                   INT32_MAX - 1, INT32_MAX], np.int32),
                         size=(8, n))
    strided = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    assert strided.stride() == (1, b)
    per_row = rng.integers(-2, n + 3, size=b).astype(np.int32)
    got = tw.quorum_watermark(strided, torch.from_numpy(per_row)).numpy()
    _assert_same(got, _ref_qw(w, per_row))
    for q in (1, n // 2, n - 1, n, n + 1, 0):
        _assert_same(tw.quorum_watermark(strided, q).numpy(),
                     _ref_qw(w, q))


def test_quorum_watermark_out_on_the_cpu_path():
    """``out=`` on the CPU path: written and returned itself; a buffer of
    another shape, type or layout raises, and so does one on another
    device (meta stands in for a CUDA buffer here)."""
    rng = np.random.default_rng(17)
    w = torch.from_numpy(rng.integers(0, 50, size=(4, 3, 5))
                         .astype(np.int32))
    out = torch.full((4, 3), 7, dtype=torch.int32)
    assert tw.quorum_watermark(w, 2, out=out) is out
    np.testing.assert_array_equal(out.numpy(), _ref_qw(w.numpy(), 2))
    for bad in (torch.zeros(12, dtype=torch.int32),
                torch.zeros((4, 3), dtype=torch.int64),
                torch.zeros((3, 4), dtype=torch.int32).t()):
        with pytest.raises(ValueError, match="out must be"):
            tw.quorum_watermark(w, 2, out=bad)
    with pytest.raises(ValueError, match="never a mix"):
        tw.quorum_watermark(w, 2, out=torch.empty((4, 3), dtype=torch.int32,
                                                  device="meta"))
    assert tw.quorum_watermark.launches == 0


def test_quorum_watermark_vector_on_the_cpu_across_changing_shapes():
    """The GC roles' entry (``device="cpu"``) over matrices that grow
    and shrink, int64 values that wrap: each answer equals the
    reference's and is a fresh array that no later call touches."""
    rng = np.random.default_rng(18)
    answers = []
    for shape in ((3, 2), (1001, 3), (5, 40), (3, 1), (33, 7), (2, 2)):
        m = rng.integers(-(1 << 34), 1 << 34, size=shape, dtype=np.int64)
        q = int(rng.integers(1, shape[0] + 1))
        got = tw.quorum_watermark_vector(m, q, device="cpu")
        _assert_same(got, np.asarray(jw.quorum_watermark_vector(m, q)))
        assert got.flags.writeable
        answers.append((got, got.copy()))
    for got, kept in answers:
        np.testing.assert_array_equal(got, kept)
    for (a, _), (b, _) in zip(answers, answers[1:]):
        assert not np.shares_memory(a, b)


# --- (a) K13 -----------------------------------------------------------------


def _ref_cpl(x: np.ndarray) -> np.ndarray:
    return np.asarray(jw.contiguous_prefix_length(jnp.asarray(x)))


def _port_cpl(x: np.ndarray) -> np.ndarray:
    return tw.contiguous_prefix_length(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("seed", range(3))
def test_contiguous_prefix_length_bool_rows(seed):
    rng = np.random.default_rng(300 + seed)
    x = rng.random((64, 3, 50)) < 0.97
    x[:8] = True
    _assert_same(_port_cpl(x), _ref_cpl(x))
    # libbench's [4096] with one False in the middle, and [4096, 3] rows.
    present = np.ones(4096, dtype=bool)
    present[2048 + seed] = False
    _assert_same(_port_cpl(present), _ref_cpl(present))
    assert int(_port_cpl(present)) == 2048 + seed
    rows = np.ones((4096, 3), dtype=bool)
    rows[rng.integers(0, 4096, size=500), rng.integers(0, 3, size=500)] = 0
    _assert_same(_port_cpl(rows), _ref_cpl(rows))


def test_contiguous_prefix_length_counts_products():
    """Bytes other than 0/1 count their products ([2, 3, 1, 0] gives
    14); signed inputs sign-extend; int32 products wrap; int64 keeps its
    low 32 bits; an empty last axis gives 0."""
    cases = [
        np.array([2, 3, 1, 0], np.uint8),
        np.array([-1, -2, 3], np.int8),
        np.array([300, -7, 2], np.int16),
        np.array([65535, 65535, 3], np.int32),
        np.array([1 << 16, 1 << 16, 5], np.int32),
        np.array([(1 << 33) + 1, 2, -3], np.int64),
        np.zeros((3, 0), bool),
        np.zeros((0, 4), np.uint8),
    ]
    rng = np.random.default_rng(9)
    for dtype in (np.uint8, np.int8, np.int32):
        x = rng.integers(-3 if dtype != np.uint8 else 0, 4,
                         size=(32, 40)).astype(dtype)
        x[:, :5] = np.maximum(x[:, :5], 1)
        cases.append(x)
    for x in cases:
        _assert_same(_port_cpl(x), _ref_cpl(x))
    assert int(_port_cpl(cases[0])) == 14


# --- (b) the reference's utils cases on the port -----------------------------


class TestQuorumWatermark:
    def test_doc_example(self):
        qw = QuorumWatermark(num_watermarks=4)
        for i, w in enumerate([6, 2, 4, 3]):
            qw.update(i, w)
        assert qw.watermark(quorum_size=4) == 2
        assert qw.watermark(quorum_size=3) == 3
        assert qw.watermark(quorum_size=2) == 4
        assert qw.watermark(quorum_size=1) == 6

    def test_monotone_updates(self):
        qw = QuorumWatermark(num_watermarks=2)
        qw.update(0, 5)
        qw.update(0, 3)  # ignored: watermarks only increase
        assert qw.watermark(1) == 5

    def test_bounds(self):
        qw = QuorumWatermark(num_watermarks=2)
        with pytest.raises(ValueError):
            qw.watermark(0)
        with pytest.raises(ValueError):
            qw.watermark(3)


class TestQuorumWatermarkVector:
    @pytest.mark.parametrize("backend", ["host", "cuda"])
    def test_doc_example(self, backend):
        qwv = QuorumWatermarkVector(n=4, depth=3)
        for i, w in enumerate([[1, 2, 3], [3, 2, 1], [2, 4, 6],
                               [7, 5, 3]]):
            qwv.update(i, w)
        kw = dict(backend=backend, device="cpu")
        assert qwv.watermark(quorum_size=1, **kw) == [7, 5, 6]
        assert qwv.watermark(quorum_size=2, **kw) == [3, 4, 3]
        assert qwv.watermark(quorum_size=4, **kw) == [1, 2, 1]

    @pytest.mark.parametrize("backend", ["host", "cuda"])
    def test_bounds(self, backend):
        qwv = QuorumWatermarkVector(n=3, depth=2)
        for q in (0, 4):
            with pytest.raises(ValueError):
                qwv.watermark(q, backend=backend, device="cpu")

    def test_tpu_backend_is_refused(self):
        qwv = QuorumWatermarkVector(n=3, depth=2)
        for backend in ("tpu", "gpu"):
            with pytest.raises(ValueError, match="cuda"):
                qwv.watermark(2, backend=backend)

    def test_cuda_backend_needs_a_gpu_or_a_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        qwv = QuorumWatermarkVector(n=3, depth=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qwv.watermark(2, backend="cuda")
        assert qwv.watermark(2, backend="cuda", device="cpu") == [0, 0]


def test_device_quorum_watermark_matches_host():
    rng = np.random.default_rng(7)
    for _ in range(20):
        n = int(rng.integers(1, 8))
        ws = rng.integers(0, 100, size=n)
        qw = QuorumWatermark(n)
        for i, w in enumerate(ws):
            qw.update(i, int(w))
        for k in range(1, n + 1):
            got = int(tw.quorum_watermark(
                torch.from_numpy(ws.astype(np.int32)), k))
            assert got == qw.watermark(k)


def test_device_quorum_watermark_vector():
    mat = np.array([[1, 2, 3], [3, 2, 1], [2, 4, 6], [7, 5, 3]])
    np.testing.assert_array_equal(
        tw.quorum_watermark_vector(mat, 2, device="cpu"), [3, 4, 3])


def test_contiguous_prefix_length():
    def cpl(values):
        return int(tw.contiguous_prefix_length(torch.tensor(values)))

    assert cpl([True, True, False, True]) == 2
    assert cpl([False, True]) == 0
    assert cpl([True] * 5) == 5


def test_cuda_backend_matches_host_and_reference():
    """The backend half of ``test_gc_watermark_tpu_backend_matches_host``:
    the port's ``"cuda"`` vector (on the CPU), its host oracle and the
    reference's ``"tpu"`` backend agree on random frontiers."""
    rng = random.Random(3)
    for _ in range(20):
        n, depth = rng.randint(1, 5), rng.randint(1, 4)
        port = QuorumWatermarkVector(n=n, depth=depth)
        ref = jutils.QuorumWatermarkVector(n=n, depth=depth)
        mat = np.array([[rng.randint(0, 50) for _ in range(depth)]
                        for _ in range(n)])
        for i in range(n):
            port.update(i, mat[i])
            ref.update(i, mat[i])
        q = rng.randint(1, n)
        want = ref.watermark(q, backend="tpu")
        assert port.watermark(q) == want
        assert port.watermark(q, backend="cuda", device="cpu") == want


# --- (c) carrying a vector across --------------------------------------------


def test_watermark_vector_crosses_and_comes_back():
    rng = np.random.default_rng(11)
    ref = jutils.QuorumWatermarkVector(n=3, depth=2)
    for _ in range(10):
        ref.update(int(rng.integers(0, 3)),
                   rng.integers(0, 1000, size=2).tolist())
    port = convert.watermark_vector_from_numpy(ref._watermarks)
    np.testing.assert_array_equal(convert.watermark_vector_to_numpy(port),
                                  ref._watermarks)
    # Both continue from the carried state alike.
    for _ in range(10):
        index, w = int(rng.integers(0, 3)), rng.integers(0, 2000, size=2)
        port.update(index, w)
        ref.update(index, w)
        for q in (1, 2, 3):
            assert (port.watermark(q, backend="cuda", device="cpu")
                    == ref.watermark(q, backend="tpu") == ref.watermark(q))
    # The carried matrix is a copy, both ways.
    out = convert.watermark_vector_to_numpy(port)
    out[...] = -1
    assert port.watermark(1) != [-1, -1]
    with pytest.raises(ValueError, match="int64"):
        convert.watermark_vector_from_numpy(np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="int64"):
        convert.watermark_vector_from_numpy(np.zeros(3, np.int64))


# --- (d) the wrappers --------------------------------------------------------


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="int32"):
        tw.quorum_watermark(torch.zeros((2, 3), dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="int32"):
        tw.quorum_watermark(torch.zeros((2, 3), dtype=torch.int32),
                            torch.ones(2, dtype=torch.int64))
    with pytest.raises(OverflowError):
        tw.quorum_watermark(torch.zeros((2, 3), dtype=torch.int32), 1 << 31)
    with pytest.raises(ValueError):
        tw.contiguous_prefix_length(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        tw.contiguous_prefix_length(torch.tensor(True))
    with pytest.raises(ValueError, match="matrix"):
        tw.quorum_watermark_vector(np.zeros(3, np.int64), 1, device="cpu")
    meta = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tw.quorum_watermark(meta, 2)
    with pytest.raises(ValueError, match="meta"):
        tw.contiguous_prefix_length(meta)
    assert tw.quorum_watermark.launches == 0
    assert tw.contiguous_prefix_length.launches == 0


class _Recorder:
    """Stands in for the kernel library: records each entry point's
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
    recorder = _Recorder()
    monkeypatch.setattr(tw, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda name: recorder)
    monkeypatch.setattr(_build, "stream_args", lambda device: (0, None))
    monkeypatch.setattr(_build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(_build, "stream_handle", lambda index: 0)
    for entry in (tw._K12, tw._K12_STAGED, tw._K13, tw._K13_FORM):
        monkeypatch.setattr(entry, "fn", None)
    for wrapper in (tw.quorum_watermark, tw.contiguous_prefix_length):
        monkeypatch.setattr(wrapper, "launches", 0)
    return recorder


def test_kernel_path_arguments_and_launch_counts(monkeypatch):
    """With the kernel path forced on CPU tensors: each wrapper passes
    as many arguments as its C entry reads (K12's packed block of 10
    int64: watermarks, rows, n, the two strides, per-row sizes, scalar,
    out, device, stream; K13's of 9: present, element kind, rows,
    length, the two strides, out, device, stream), the strides of the
    rows it was given, the per-row quorum sizes or the scalar, and the
    element kind; an empty batch launches and counts nothing."""
    recorder = _force_kernel_path(monkeypatch)
    sig = _build.SIGNATURES["watermark"]
    m = torch.zeros((3, 5), dtype=torch.int32)
    tw.quorum_watermark(m.t(), 2)
    entry, args = recorder.calls[-1]
    assert entry == "fpx_quorum_watermark" and len(args) == 10
    assert args[1:5] == (5, 3, 1, 5) and args[5] == 0 and args[6] == 2
    tw.quorum_watermark(torch.zeros((2, 4, 3), dtype=torch.int32),
                        torch.ones((2, 1), dtype=torch.int32))
    entry, args = recorder.calls[-1]
    assert args[1:5] == (8, 3, 3, 1) and args[5] != 0
    got = tw.contiguous_prefix_length(torch.zeros((6, 7), dtype=torch.int8))
    entry, args = recorder.calls[-1]
    assert entry == "fpx_contiguous_prefix_length"
    assert sig[entry] is _build._B and len(args) == 9
    assert args[1:6] == (1, 6, 7, 7, 1) and args[6] == got.data_ptr()
    assert tw.quorum_watermark.launches == 2
    assert tw.contiguous_prefix_length.launches == 1
    tw.quorum_watermark(torch.zeros((0, 3), dtype=torch.int32), 1)
    tw.contiguous_prefix_length(torch.zeros((0, 4), dtype=torch.bool))
    assert len(recorder.calls) == 3
    assert tw.quorum_watermark.launches == 2
    assert tw.contiguous_prefix_length.launches == 1
