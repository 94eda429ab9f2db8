"""Per-shard ingest routing: a drain block's command ids to the slot
shards that own their lanes, one copy each.

Counterpart of ``frankenpaxos_tpu/ingest/shard.py``. On a ``(group,
slot)`` mesh the block's lanes are OWNED by slot shards (lane ``l`` of a
``block_size`` block lives on shard ``l // b_local``, the rule of
``bench/pipeline.local_block``), so the host routes the ids per shard
(:func:`route_block`, a reshape) and each rank lands its own shard's
segment on its device with ONE copy (:func:`place_block`): every byte
lands on the rank that owns it and no shuffle follows.

:func:`command_ids` reads the ids straight off a parsed paxwire batch's
columns (``ingest/columns.py``), with no value decode.
"""

from __future__ import annotations

import numpy as np
import torch

from frankenpaxos_tpu_torch.ingest.columns import (
    COL_ID,
    COL_PSEUDONYM,
    ColumnRun,
)


def command_ids(colrun: ColumnRun) -> np.ndarray:
    """``[k]`` int32 pipeline command ids straight off a ColumnRun's
    descriptor columns (no value decode): the same
    (pseudonym, client-id) identity ``CommandId`` carries, folded to
    the int32 id the drain pipeline's command window holds."""
    cols = colrun.cols
    return (cols[:, COL_PSEUDONYM].astype(np.int64) * 1_000_003
            + cols[:, COL_ID].astype(np.int64)).astype(np.int32)


def route_block(ids: np.ndarray, block_size: int,
                slot_shards: int) -> np.ndarray:
    """Route a drain block's command ids to their owning slot shards.

    ``ids`` covers global lanes ``[0, len(ids))`` of a ``block_size``
    block (a partial drain routes a short prefix; the tail pads with
    zero, the pipeline's "no proposal" id). Returns ``[slot_shards,
    b_local]`` int32 where row ``s`` is shard ``s``'s segment: lane ``l``
    lands at ``[l // b_local, l % b_local]``, matching
    ``bench/pipeline.gathered_layout``. A copy of the reference's."""
    if len(ids) > block_size:
        raise ValueError(f"{len(ids)} ids exceed the {block_size}-slot "
                         f"block")
    # The round-up split rule (bench/pipeline.local_block's), kept here
    # so that ingest does not import the pipeline.
    b_local = -(-block_size // slot_shards)
    routed = np.zeros(slot_shards * b_local, dtype=np.int32)
    routed[:len(ids)] = np.asarray(ids, dtype=np.int32)
    return routed.reshape(slot_shards, b_local)


def place_block(mesh, ids: np.ndarray, block_size: int) -> torch.Tensor:
    """This rank's segment of the routed block on its device: ``[b_local]``
    int32, row ``mesh.slot_idx`` of :func:`route_block`, landed with one
    host-to-device copy. Every rank of a slot shard's group replicas
    lands the same segment (the ``commands`` window is replicated over
    ``group``), so together the ranks hold the reference's placed array
    with one copy per mesh slice. The sharded drain makes its own
    proposals inside K19, so this serves ingest (and the bench's ingest
    gate), not the drain."""
    routed = route_block(ids, block_size, mesh.slot_shards)
    return torch.from_numpy(routed[mesh.slot_idx].copy()).to(mesh.device)
