"""The port's batch-sharded dependency-set algebra against the JAX
package's, on the CPU.

The case of ``tests/test_multichip_depset.py`` again: dependency batches
built through the REAL conversion path (JAX ``InstancePrefixSet`` ->
``DepSetBatch``) split by rows over a mesh of spawned gloo ranks
(``bench/multichip_board.py``'s ``depset`` case): the rowwise ``union``,
``equal`` and ``size`` on each rank's rows, and ``union_reduce_sharded``
(K10 on the local rows, an all-reduce MAX, K9 on the union row), must
equal the JAX functions on the unsharded and the sharded batch, bit for
bit. Then the normalization edges where a per-rank union could differ
from the whole batch's: watermarks below the tail base, a run that
reaches the end of the tail window only across ranks, and rows whose
only members are tail bits. One world of 8 ranks serves the module.
"""

from frankenpaxos_tpu_torch.bench import multichip, multichip_board as mb
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec
import numpy as np
import pytest

from frankenpaxos_tpu.ops import depset
from tests.test_multichip_depset import _real_batches


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(8, device_type="cpu") as w:
        yield w


@pytest.fixture(autouse=True)
def _devices(need_8_devices):
    """The JAX side needs the shared 8-device mesh (conftest.py)."""


def _jax_mesh(group, slot):
    devices = np.asarray(jax.devices()[:group * slot])
    return Mesh(devices.reshape(group, slot), ("group", "slot"))


def _arrays(d) -> tuple:
    return tuple(np.asarray(x) for x in d)


def _port(world, shape, a, b) -> dict:
    return mb.same_on_every_rank(world.call(
        "depset", group=shape[0], slot=shape[1], a=_arrays(a), b=_arrays(b)))


def _assert_matches_reference(got: dict, a, b) -> None:
    union = depset.union(a, b)
    reduced = depset.union_reduce(a)
    for key, want in (("union_watermarks", union.watermarks),
                      ("union_tails", union.tails),
                      ("equal", depset.equal(a, b)),
                      ("equal_self", depset.equal(a, a)),
                      ("size", depset.size(a)),
                      ("reduce_watermarks", reduced.watermarks),
                      ("reduce_tails", reduced.tails)):
        want = np.asarray(want)
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_sharded_depset_algebra_bit_identical(world, shape):
    """Real batches of 64 rows: the port split over the mesh equals the
    JAX functions on the unsharded batch and on the batch sharded over
    the same mesh."""
    a, b = _real_batches(64, seed=5)
    mesh = _jax_mesh(*shape)
    axes = ("group", "slot")

    def shard(d):
        return depset.DepSetBatch(
            jax.device_put(d.watermarks,
                           NamedSharding(mesh, PartitionSpec(axes))),
            jax.device_put(d.tails, NamedSharding(mesh, PartitionSpec(axes))),
            jax.device_put(d.tail_base, NamedSharding(mesh, PartitionSpec())))

    got = _port(world, shape, a, b)
    _assert_matches_reference(got, a, b)
    sharded = depset.union_reduce(shard(a))
    np.testing.assert_array_equal(got["reduce_watermarks"],
                                  np.asarray(sharded.watermarks))
    np.testing.assert_array_equal(got["reduce_tails"],
                                  np.asarray(sharded.tails))
    assert got["equal_self"].all()


def _edge_batch(kind: str, rng, rows=64, leaders=3, width=32, base=1000):
    """Batches whose union normalizes across ranks (8 rows per rank)."""
    wm = np.full((rows, leaders), base - 40, dtype=np.int32)
    tails = np.zeros((rows, leaders, width), dtype=np.uint8)
    if kind == "below_base":
        # Every watermark below the window: nothing may absorb, though
        # the tails hold a run from the window's start.
        wm = rng.integers(base - 60, base, size=(rows, leaders)).astype(
            np.int32)
        tails[:, :, :5] = rng.random((rows, leaders, 5)) < 0.7
    elif kind == "run_to_the_end":
        # Rank r's rows hold tail ids [4r, 4r + 4) only; one row of the
        # last rank reaches the window's start. Only the whole batch
        # holds the run through the window's end.
        for r in range(rows):
            rank = r // 8
            tails[r, :, 4 * rank:4 * rank + 4] = 1
        wm[-1] = base
    elif kind == "tail_bits_only":
        # Rows whose only members are tail bits (watermark far below),
        # and one rank whose rows reach the window's start.
        tails[...] = rng.random((rows, leaders, width)) < 0.4
        wm[8:16] = base
        tails[8:16, :, :3] = 1
    elif kind == "mixed":
        wm = rng.integers(base - 8, base + 40, size=(rows, leaders)).astype(
            np.int32)
        tails[...] = rng.random((rows, leaders, width)) < 0.5
    return depset.DepSetBatch(wm, tails, np.int32(base))


@pytest.mark.parametrize("kind", ["below_base", "run_to_the_end",
                                  "tail_bits_only", "mixed"])
@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (1, 1)])
def test_sharded_union_reduce_at_the_normalize_edges(world, kind, shape):
    rng = np.random.default_rng(len(kind))
    a = _edge_batch(kind, rng)
    b = _edge_batch("mixed", rng)
    got = _port(world, shape, a, b)
    _assert_matches_reference(got, a, b)
    if kind == "run_to_the_end":
        # The whole batch's union absorbs the run to the window's end.
        assert (got["reduce_watermarks"] == 1000 + 32).all()
        assert not got["reduce_tails"].any()
    if kind == "below_base":
        assert (got["reduce_watermarks"] < 1000).all()
