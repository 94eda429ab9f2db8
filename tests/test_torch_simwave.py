"""K18, the geo transport's link mask: the port's plain version against
the JAX package's jitted twin (``link_keep_mask_jit``, run by JAX on the
CPU), bit for bit, at random waves and at every index edge of JAX's
gather rule, on offset views and at ragged lengths (the kernel's
unaligned head and tail); the ``out=`` contract; the transport-facing
``link_keep_mask_cuda`` on the CPU across waves of changing size; the
kernel path's packed C block (a stand-in library, no card); the
``FPX_SIMWAVE_JIT`` switch; and the port's copies of the numpy masks
against the reference's."""

import functools
import os
import struct
import subprocess
import sys
import types

from frankenpaxos_tpu_torch.ops import simwave as tsw
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import simwave as jsw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _up(rng, z: int, down: float = 0.2) -> np.ndarray:
    """A ``[Z+1, Z+1]`` up-matrix with about ``down`` of its links down
    and the always-up sentinel row and column, as the topology makes."""
    up = rng.random((z + 1, z + 1)) >= down
    up[z, :] = True
    up[:, z] = True
    return up


def _plain(src, dst, up) -> np.ndarray:
    return tsw.link_keep_mask_plain(
        torch.from_numpy(np.asarray(src, np.int32)),
        torch.from_numpy(np.asarray(dst, np.int32)),
        torch.from_numpy(up)).numpy()


@pytest.mark.parametrize("z,n", [(3, 1), (12, 31), (12, 32), (12, 700),
                                 (50, 4096), (1000, 500)])
def test_plain_matches_jax_twin_on_topology_ids(z, n):
    """Ids in [-1, Z-1], the range the topology hands out."""
    rng = np.random.default_rng(z * 7919 + n)
    up = _up(rng, z)
    src = rng.integers(-1, z, n).astype(np.int32)
    dst = rng.integers(-1, z, n).astype(np.int32)
    want = jsw.link_keep_mask_jit(src, dst, up)
    got = _plain(src, dst, up)
    assert got.dtype == np.bool_ and got.shape == (n,)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jsw.link_keep_mask(src, dst, up))


@pytest.mark.parametrize("pair,expected", [
    ((5, 0), (2, 0)), ((-4, 0), (0, 0)), ((0, 9), (0, 2)),
    ((-1, -1), (2, 2)), ((-3, 1), (0, 1)), ((3, -3), (2, 0)),
    ((-2**31, 2**31 - 1), (0, 2)),
])
def test_index_edges_follow_jax(pair, expected):
    """JAX wraps a negative id once, then clamps; on a 3x3 matrix with
    one True entry the mask says which entry each pair read."""
    for row in range(3):
        for col in range(3):
            up = np.zeros((3, 3), bool)
            up[row, col] = True
            src = np.array([pair[0]], np.int32)
            dst = np.array([pair[1]], np.int32)
            want = jsw.link_keep_mask_jit(src, dst, up)
            got = _plain(src, dst, up)
            assert np.array_equal(got, want), (pair, row, col)
            assert bool(got[0]) == ((row, col) == expected), (pair, row,
                                                              col)


def test_every_edge_at_full_width():
    """At 1000 zones, ids at every JAX edge (-1, -Z-1, <= -Z-2, Z, > Z)
    mixed with in-range ids, against the JAX twin."""
    z = 1000
    rng = np.random.default_rng(18)
    up = _up(rng, z)
    edges = np.array([-1, -z - 1, -z - 2, -5 * z, z, z + 1, 7 * z,
                      -2**31, 2**31 - 1, 0, z - 1], np.int32)
    for n in (32, 33, 500, 4096):
        src = rng.integers(-1, z, n).astype(np.int32)
        dst = rng.integers(-1, z, n).astype(np.int32)
        src[:len(edges)] = edges
        dst[-len(edges):] = edges[::-1]
        assert np.array_equal(_plain(src, dst, up),
                              jsw.link_keep_mask_jit(src, dst, up)), n


def test_cuda_entry_on_the_cpu_is_writable_and_fresh():
    rng = np.random.default_rng(5)
    up = _up(rng, 20)
    mask = functools.partial(tsw.link_keep_mask_cuda, device="cpu")
    src = rng.integers(-1, 20, 64)
    dst = rng.integers(-1, 20, 64)
    a = mask(src, dst, up)
    assert a.flags.writeable and a.dtype == np.bool_
    assert np.array_equal(a, jsw.link_keep_mask_jit(src, dst, up))
    b = mask(src, dst, up)
    a &= False  # what the transport does in place with a partition mask
    assert np.array_equal(b, jsw.link_keep_mask_jit(src, dst, up))
    assert len(mask(src[:0], dst[:0], up)) == 0
    with pytest.raises(ValueError):
        mask(src, dst, up.astype(np.uint8))


def test_cuda_entry_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    up = np.ones((3, 3), bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsw.link_keep_mask_cuda(np.zeros(40, np.int32),
                                np.zeros(40, np.int32), up)


def test_plain_rejects_bad_shapes():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tsw.link_keep_mask_plain(ids.long(), ids, torch.ones(3, 3,
                                                             dtype=bool))
    with pytest.raises(ValueError):
        tsw.link_keep_mask_plain(ids, ids[:3], torch.ones(3, 3,
                                                          dtype=bool))
    with pytest.raises(ValueError):
        tsw.link_keep_mask_plain(ids, ids, torch.ones(3, 3))
    with pytest.raises(ValueError):
        tsw.link_keep_mask_plain(ids, ids, torch.ones(0, 3, dtype=bool))
    empty = torch.zeros(0, dtype=torch.int32)
    assert tsw.link_keep_mask_plain(empty, empty, torch.ones(
        0, 0, dtype=bool)).shape == (0,)


@pytest.mark.parametrize("env,expected", [(None, "link_keep_mask"),
                                          ("0", "link_keep_mask"),
                                          ("1", "link_keep_mask_cuda")])
def test_link_keep_mask_follows_the_switch(env, expected):
    """``FPX_SIMWAVE_JIT=1`` points the transport's mask at K18, as it
    points the reference's at its jitted twin."""
    environ = {k: v for k, v in os.environ.items()
               if k != "FPX_SIMWAVE_JIT"}
    if env is not None:
        environ["FPX_SIMWAVE_JIT"] = env
    out = subprocess.run(
        [sys.executable, "-c",
         "from frankenpaxos_tpu_torch.ops import simwave; "
         "print(simwave.LINK_KEEP_MASK.__name__)"],
        cwd=REPO, env=environ, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == expected


def test_numpy_masks_match_the_reference():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 50, 500).astype(np.int64)
    dst = rng.integers(0, 50, 500).astype(np.int64)
    for blocked in (np.unique(rng.integers(0, 50, 7)).astype(np.int64),
                    np.empty(0, np.int64)):
        assert np.array_equal(tsw.keep_mask(src, dst, blocked),
                              jsw.keep_mask(src, dst, blocked))
    up = _up(rng, 12)
    s = rng.integers(-1, 12, 100)
    d = rng.integers(-1, 12, 100)
    assert np.array_equal(tsw.link_keep_mask(s, d, up),
                          jsw.link_keep_mask(s, d, up))
    assert tsw.WAVE_VECTOR_MIN == jsw.WAVE_VECTOR_MIN
    assert tsw.UNPLACED_ZONE == jsw.UNPLACED_ZONE


def test_tensor_wrapper_counts_only_kernel_launches():
    rng = np.random.default_rng(9)
    up = torch.from_numpy(_up(rng, 8))
    ids = torch.from_numpy(rng.integers(-1, 8, 40).astype(np.int32))
    before = tsw.link_keep_mask_tensor.launches
    got = tsw.link_keep_mask_tensor(ids, ids.flip(0), up)
    assert torch.equal(got, tsw.link_keep_mask_plain(ids, ids.flip(0), up))
    assert tsw.link_keep_mask_tensor.launches == before


@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 33])
@pytest.mark.parametrize("offset", [0, 1, 7, 15])
def test_offset_views_and_ragged_lengths_match_jax(n, offset):
    """The wrapper and the plain version on views that start ``offset``
    elements into their buffers (the kernel's unaligned head) at ragged
    lengths (its tail), with ids past every edge of JAX's rule and an
    ``out=`` view offset as well, against JAX's jitted gather."""
    rng = np.random.default_rng(100 * n + offset)
    z = 12
    up = _up(rng, z)
    src = rng.integers(-2 * z, 2 * z, n + 16).astype(np.int32)
    dst = rng.integers(-2 * z, 2 * z, n + 16).astype(np.int32)
    want = np.asarray(jsw._link_keep_jax(src[offset:offset + n],
                                         dst[offset:offset + n], up))
    src_t = torch.from_numpy(src)[offset:offset + n]
    dst_t = torch.from_numpy(dst)[offset:offset + n]
    up_t = torch.from_numpy(up)
    assert src_t.storage_offset() == offset
    assert np.array_equal(tsw.link_keep_mask_plain(src_t, dst_t,
                                                   up_t).numpy(), want)
    assert np.array_equal(tsw.link_keep_mask_tensor(src_t, dst_t,
                                                    up_t).numpy(), want)
    out = torch.zeros(n + 16, dtype=torch.bool)
    into = tsw.link_keep_mask_tensor(src_t, dst_t, up_t, out=out[offset:])
    assert into.data_ptr() == out[offset:].data_ptr() and len(into) == n
    assert np.array_equal(out[offset:offset + n].numpy(), want)
    assert not out[:offset].any() and not out[offset + n:].any()


def test_out_contract_on_the_cpu_path():
    """``out=`` on the CPU path: an ``n``-long buffer is returned itself,
    a longer one as its first ``n`` elements; a short, non-bool, strided
    or non-CPU buffer raises, and so does a mix of devices."""
    rng = np.random.default_rng(11)
    up = torch.from_numpy(_up(rng, 9))
    src = torch.from_numpy(rng.integers(-1, 9, 40).astype(np.int32))
    dst = torch.from_numpy(rng.integers(-1, 9, 40).astype(np.int32))
    want = tsw.link_keep_mask_plain(src, dst, up)
    exact = torch.zeros(40, dtype=torch.bool)
    assert tsw.link_keep_mask_tensor(src, dst, up, out=exact) is exact
    assert torch.equal(exact, want)
    longer = torch.zeros(64, dtype=torch.bool)
    got = tsw.link_keep_mask_tensor(src, dst, up, out=longer)
    assert got.data_ptr() == longer.data_ptr() and torch.equal(got, want)
    for bad in (torch.zeros(39, dtype=torch.bool),
                torch.zeros(40, dtype=torch.uint8),
                torch.zeros(80, dtype=torch.bool)[::2]):
        with pytest.raises(ValueError, match="out must be"):
            tsw.link_keep_mask_tensor(src, dst, up, out=bad)
    # A buffer on another device (meta stands in for a CUDA one here).
    with pytest.raises(ValueError, match="never a mix"):
        tsw.link_keep_mask_tensor(src, dst, up,
                                  out=torch.empty(40, dtype=torch.bool,
                                                  device="meta"))
    with pytest.raises(ValueError, match="never a mix"):
        tsw.link_keep_mask_tensor(src, dst, up.to("meta"))
    assert tsw.link_keep_mask_tensor.launches == 0


def test_cuda_entry_on_the_cpu_across_changing_shapes():
    """The transport-facing entry (``device="cpu"``) over waves that
    grow and shrink, with int64 ids: each answer equals the JAX twin's
    and is a fresh, writable array that no later call touches."""
    rng = np.random.default_rng(12)
    up = _up(rng, 30)
    answers = []
    for n in (64, 5, 1000, 33, 1, 0, 4096, 17):
        src = rng.integers(-1, 30, n)
        dst = rng.integers(-1, 30, n)
        got = tsw.link_keep_mask_cuda(src, dst, up, device="cpu")
        assert got.dtype == np.bool_ and got.shape == (n,)
        assert got.flags.writeable
        want = (jsw.link_keep_mask_jit(src, dst, up) if n
                else np.zeros(0, bool))
        assert np.array_equal(got, want)
        answers.append((got, got.copy()))
    for got, kept in answers:
        assert np.array_equal(got, kept)
    for (a, _), (b, _) in zip(answers, answers[1:]):
        assert not np.shares_memory(a, b)


class _Recorder:
    """Stands in for the kernel library: records each packed block's
    int64 slots, launches nothing, returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(block):
            self.calls.append((entry, struct.unpack(
                f"={len(block) // 8}q", block)))
            return 0

        return call


def test_kernel_path_packs_the_c_block(monkeypatch):
    """With the kernel path forced on CPU tensors: the wrapper hands the
    C entry its 9-slot block (src, dst, n, up, rows, cols, out, device,
    stream) with the views' own pointers (no copy of a contiguous
    offset view), returns ``out`` itself, and counts one launch; a
    strided input is made contiguous first, and an empty wave launches
    nothing."""
    recorder = _Recorder()
    monkeypatch.setattr(tsw, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tsw._build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(tsw._build, "stream_handle", lambda index: 0)
    monkeypatch.setattr(tsw._K18, "fn", None)
    monkeypatch.setattr(tsw.link_keep_mask_tensor, "launches", 0)
    ids = torch.arange(-1, 20, dtype=torch.int32)
    up = torch.ones((5, 7), dtype=torch.bool)
    out = torch.zeros(13, dtype=torch.bool)
    src, dst = ids[3:16], ids[5:18]
    assert tsw.link_keep_mask_tensor(src, dst, up, out=out) is out
    entry, slots = recorder.calls[-1]
    assert entry == "fpx_link_keep_mask" and len(slots) == 9
    assert slots == (src.data_ptr(), dst.data_ptr(), 13, up.data_ptr(), 5,
                     7, out.data_ptr(), -1, 0)
    strided = ids[::2][:7]
    tsw.link_keep_mask_tensor(strided, strided, up)
    entry, slots = recorder.calls[-1]
    assert slots[0] != strided.data_ptr() and slots[2] == 7
    empty = ids[:0]
    assert tsw.link_keep_mask_tensor(empty, empty, up).shape == (0,)
    assert len(recorder.calls) == 2
    assert tsw.link_keep_mask_tensor.launches == 2


def test_staged_entries_release_the_gil(monkeypatch):
    """The launch-only entries resolve through a handle whose calls keep
    the GIL; the staged ones, which wait on the card, through one whose
    calls release it."""
    from frankenpaxos_tpu_torch.ops import watermark as tw

    seen = []

    def library(name, keep_gil):
        seen.append((name, keep_gil))
        return _Recorder()

    monkeypatch.setattr(tsw._build, "packed_library", library)
    for entry in (tsw._K18, tsw._K18_STAGED, tw._K12, tw._K12_STAGED):
        monkeypatch.setattr(entry, "fn", None)
        entry.resolve()
    assert seen == [("simwave", True), ("simwave", False),
                    ("watermark", True), ("watermark", False)]


def test_staging_follows_the_current_card(monkeypatch):
    """``device=None`` finds the staging of the card current at each
    call, not of the card current at the first call; a named device is
    resolved at its first call; a CPU device has no staging."""
    current = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    made = []

    def make(dev):
        index = current[0] if dev.index is None else dev.index
        made.append(types.SimpleNamespace(index=index))
        return made[-1]

    table = {}
    first = tsw._build.staging(table, None, make)
    assert first.index == 0
    assert tsw._build.staging(table, None, make) is first
    current[0] = 1
    second = tsw._build.staging(table, None, make)
    assert second is not first and second.index == 1
    current[0] = 0
    assert tsw._build.staging(table, None, make) is first
    named = tsw._build.staging(table, "cuda:1", make)
    assert named.index == 1
    current[0] = 1
    assert tsw._build.staging(table, "cuda:1", make) is named
    assert tsw._build.staging(table, "cpu", make) is None
    assert len(made) == 3
