"""The ingest lane router of the sharded drain, on the CPU.

The cases of ``tests/test_multichip_ingest.py`` again on the port's
``ingest/shard.py``: ``route_block`` equals the reference's (and the
pipeline's gathered layout) on divisible and non-divisible splits, and
``place_block`` lands each slot shard's segment on its own rank with one
copy, over a gloo world of spawned CPU ranks. The ids are made with
numpy: ``command_ids`` reads a parsed paxwire batch, whose column scan
is not ported yet (ROADMAP.md queue 1 item 8.2), so the reference's
``test_command_ids_off_real_wire_batch`` waits for it.
"""

from frankenpaxos_tpu_torch.bench import multichip
from frankenpaxos_tpu_torch.bench.pipeline import gathered_layout, local_block
from frankenpaxos_tpu_torch.ingest import command_ids, route_block
import numpy as np
import pytest

from frankenpaxos_tpu.ingest.shard import route_block as jax_route_block


@pytest.fixture(scope="module")
def world():
    with multichip.RankWorld(8, device_type="cpu") as w:
        yield w


def _ids(k: int) -> np.ndarray:
    """``k`` distinct nonzero int32 ids (the reference's shape:
    pseudonym * 1_000_003 + client id)."""
    return (np.int64(3) * 1_000_003 + np.arange(k)).astype(np.int32)


@pytest.mark.parametrize("block,slot_shards", [(128, 4), (100, 3)])
def test_route_block_matches_lane_ownership(block, slot_shards):
    """Lane ``l`` lands at ``[l // b_local, l % b_local]``, the pad tail
    and unrouted lanes zero, and the whole equals the reference's."""
    b_local, pad = local_block(block, slot_shards)
    assert (pad > 0) == (block % slot_shards != 0)
    k = block - 7
    ids = np.arange(1, k + 1, dtype=np.int32)
    routed = route_block(ids, block, slot_shards)
    assert routed.shape == (slot_shards, b_local)
    assert routed.dtype == np.int32
    for lane in range(k):
        assert routed[lane // b_local, lane % b_local] == ids[lane]
    flat = routed.reshape(-1)
    owned = np.zeros(slot_shards * b_local, dtype=bool)
    owned[:k] = True
    assert not flat[~owned].any()
    np.testing.assert_array_equal(routed,
                                  jax_route_block(ids, block, slot_shards))
    # The same ownership rule as the drain's gathered layout.
    logical, valid = gathered_layout(slot_shards, b_local, b_local, block)
    np.testing.assert_array_equal(logical[valid][:k] + 1, flat[valid][:k])


def test_route_block_rejects_oversized_drain():
    with pytest.raises(ValueError, match="exceed"):
        route_block(np.arange(101, dtype=np.int32), 100, 3)


def test_command_ids_waits_for_the_column_scan():
    with pytest.raises(NotImplementedError, match="item 8.2"):
        command_ids(None)


@pytest.mark.parametrize("group_dim,slot_dim,block",
                         [(1, 8, 64), (2, 4, 64), (2, 3, 100)])
def test_place_block_round_trip(world, group_dim, slot_dim, block):
    """The placed segments, in rank order over the slot shards,
    round-trip to the routed layout on several mesh shapes, including
    the non-divisible split."""
    ids = _ids(block - 5)
    rows = world.call("place_block", deadline_s=60, group=group_dim,
                      slot=slot_dim, ids=ids, block=block)[0]["rows"]
    routed = route_block(ids, block, slot_dim)
    placed = np.concatenate([rows[s][1] for s in range(slot_dim)])
    np.testing.assert_array_equal(placed, routed.reshape(-1))


def test_place_block_one_copy_per_slice(world):
    """Every rank already holds exactly its own routed segment, on its
    own device; group replicas of a slot shard hold the same one."""
    block = 64
    ids = np.arange(1, block + 1, dtype=np.int32)
    rows = world.call("place_block", deadline_s=60, group=2, slot=4,
                      ids=ids, block=block)[0]["rows"]
    routed = route_block(ids, block, 4)
    assert len(rows) == 8
    for rank, (device, row) in enumerate(rows):
        assert device == "cpu"
        assert row.dtype == np.int32
        np.testing.assert_array_equal(row, routed[rank % 4])
