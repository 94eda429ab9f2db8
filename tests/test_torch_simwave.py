"""K18, the geo transport's link mask: the port's plain version against
the JAX package's jitted twin (``link_keep_mask_jit``, run by JAX on the
CPU), bit for bit, at random waves and at every index edge of JAX's
gather rule; the transport-facing ``link_keep_mask_cuda`` on the CPU;
the ``FPX_SIMWAVE_JIT`` switch; and the port's copies of the numpy
masks against the reference's."""

import functools
import os
import subprocess
import sys

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
