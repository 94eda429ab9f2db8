"""Per-shard ingest routing: a drain block's command ids to the slot
shards that own their lanes, one copy each.

Counterpart of ``frankenpaxos_tpu/ingest/shard.py``. On a ``(group,
slot)`` mesh the block's lanes are OWNED by slot shards (lane ``l`` of a
``block_size`` block lives on shard ``l // b_local``, the rule of
``bench/pipeline.local_block``), so the host routes the ids per shard
(:func:`route_block`, a reshape) and each rank lands its own shard's
segment on its device with ONE copy (:func:`place_block`): every byte
lands on the rank that owns it and no shuffle follows.

:func:`command_ids` reads ids off a parsed paxwire batch's columns,
which are not ported yet (ROADMAP.md queue 1 item 8.2): it raises.
"""

from __future__ import annotations

import numpy as np
import torch


def command_ids(colrun) -> np.ndarray:
    """The reference's ids off a ``ColumnRun``'s descriptor columns; the
    column scan is not ported yet, so this raises."""
    raise NotImplementedError(
        "command_ids reads a parsed paxwire batch (ingest/columns.py), "
        "which is not ported yet (ROADMAP.md queue 1 item 8.2)")


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
