"""The telemetry plane over slot shards, on the CPU.

The mesh cases of ``tests/test_telemetry.py`` again, on the port's
sharded drain over a gloo world of spawned CPU ranks: the host-oracle
recount on 2x4 and on 2x3 with pad lanes, and on/off bit-identity on
the mesh. Every case also holds the port's gathered counters equal to
the JAX sharded step's on the forced 8-device mesh, bit for bit, and
each rank's one-copy ``collect`` to the per-shard ``shard_committed``.
The update functions over the slot axis (``slot_axis=mesh.slot_axis``)
are held to the reference's semantics directly. Every counter is int32:
tolerance 0.
"""

from frankenpaxos_tpu_torch.bench import multichip
from frankenpaxos_tpu_torch.obs.telemetry import TelemetrySnapshot
from frankenpaxos_tpu_torch.ops import telemetry as ttel
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_multichip import (
    _jax_sharded,
    _plain,
    assert_same_leaves,
    FIELDS,
)

from frankenpaxos_tpu.ops import telemetry as jtel
from frankenpaxos_tpu.quorums import SimpleMajority


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(8, device_type="cpu") as w:
        yield w


@pytest.fixture(autouse=True)
def _devices(need_8_devices):
    """The JAX side needs the shared 8-device mesh (conftest.py)."""


def _spec(n_acc):
    return SimpleMajority(range(n_acc)).write_spec().as_arrays()


def _run_mesh(world, group_dim, slot_dim, window, block, iters, n_acc=6,
              telemetry=True):
    spec = _spec(n_acc)
    port = world.call("drain", deadline_s=120, group=group_dim,
                      slot=slot_dim, window=window, block=block,
                      spec=_plain(spec), iters=iters,
                      telemetry=telemetry)[0]
    assert_same_leaves(port, _jax_sharded(group_dim, slot_dim, n_acc,
                                          window, block, iters, spec,
                                          telemetry=telemetry))
    return port


def _assert_recount(port, *, block, iters, pad_per_drain, shards):
    """The reference's host oracle: every counter re-derives from
    committed and drains."""
    tel = port["telemetry"]
    committed = int(port["committed"])
    assert committed == iters * block
    assert int(tel["drains"]) == iters
    assert int(tel["occupancy"].sum()) == committed
    assert tel["shard_committed"].shape == (shards,)
    assert int(tel["shard_committed"].sum()) == committed
    assert int(tel["proposed"]) == iters * block
    assert int(tel["pad_lanes"]) == pad_per_drain * iters
    assert tel["lag_hist"].shape == (ttel.LAG_BUCKETS,)
    assert int(tel["lag_hist"].sum()) == iters
    # Every rank's one collect reads the same per-shard counters.
    for snap in port["snapshots"]:
        snap = TelemetrySnapshot.from_json(snap)
        assert snap.shard_committed == tuple(
            int(x) for x in tel["shard_committed"])
        assert snap.committed == committed
        assert snap.pad_lanes == pad_per_drain * iters


def test_recount_2x4_divisible(world):
    port = _run_mesh(world, 2, 4, window=1 << 10, block=1 << 7, iters=6)
    _assert_recount(port, block=1 << 7, iters=6, pad_per_drain=0,
                    shards=4)


def test_recount_2x3_pad_lanes(world):
    # block=100 over 3 slot shards -> b_local=34, padded block 102:
    # exactly 2 pad lanes per drain, never counted as commits.
    port = _run_mesh(world, 2, 3, window=1000, block=100, iters=10)
    _assert_recount(port, block=100, iters=10, pad_per_drain=2, shards=3)


@pytest.mark.parametrize("shape,window,block",
                         [((2, 4), 1 << 10, 1 << 7),
                          ((2, 3), 1000, 100)])
def test_on_off_bit_identity_mesh(world, shape, window, block):
    g, s = shape
    off = _run_mesh(world, g, s, window, block, iters=6, telemetry=False)
    on = _run_mesh(world, g, s, window, block, iters=6, telemetry=True)
    assert off["telemetry"] is None and on["telemetry"] is not None
    assert int(off["committed"]) > 0
    for name in FIELDS:
        np.testing.assert_array_equal(off[name], on[name], err_msg=name)


@pytest.mark.parametrize("slots", [1, 3, 4])
def test_slot_axis_updates_match_reference(world, slots):
    """``quorum_pass_update`` and ``drain_update`` with the mesh's slot
    axis: occupancy, proposals and pad lanes summed over the shards, and
    each shard's newly count in its own entry of ``shard_committed`` --
    the reference's counters over the shards' lanes taken together."""
    rng = np.random.default_rng(slots)
    n, b = 5, 37
    counts = rng.integers(-3, n + 3, size=(slots, b)).astype(np.int32)
    newly = rng.random((slots, b)) < 0.6
    proposed = rng.integers(-1, 3, size=(slots, b)).astype(np.int32)
    valid = rng.random((slots, b)) < 0.9
    lag = 77
    got = world.call("telemetry_updates", deadline_s=60, group=1,
                     slot=slots, num_acceptors=n, counts=counts,
                     newly=newly, proposed=proposed, valid=valid,
                     lag=lag)[0]
    want = jtel.make_telemetry(n, slots)
    want = jtel.quorum_pass_update(
        want, votes_count=jnp.asarray(counts.reshape(-1)),
        newly=jnp.asarray(newly.reshape(-1)), slot_axis=None)
    want = jtel.drain_update(
        want, proposed_block=jnp.asarray(proposed.reshape(-1)),
        lane_valid=jnp.asarray(valid.reshape(-1)), lag=jnp.int32(lag),
        slot_axis=None)
    for name in ("occupancy", "proposed", "pad_lanes", "lag_hist",
                 "drains"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got["shard_committed"],
                                  newly.sum(1).astype(np.int32))
