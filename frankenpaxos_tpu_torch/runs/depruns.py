"""Batched dependency-column engine for DepRun wire messages.

The port's copy of ``frankenpaxos_tpu/runs/depruns.py``: the columns
scatter into a ``DepSetBatch`` of the port's ``ops/depset.py`` on an
explicit device (or into a packed staging block, ``out=``), and
:func:`drain_union` reduces it with K10. The DepRun codecs
(``runs/wire.py``, tags 208/209) are not ported yet (ROADMAP.md item 3).

A drain's dependency-carrying replies (EPaxos PreAcceptOk, BPaxos
DependencyReply) coalesce on the wire into ONE run message whose
dependency sets travel as flat columns (``runs/wire.py``):

  * ``watermarks``: ``B*L`` int64, row-major ``[entry][leader]``;
  * ``counts``:     ``B*L`` int32, sparse-tail lengths per column;
  * ``values``:     ``sum(counts)`` int64 sparse ids, concatenated in
    column order.

This module turns those columns into the ``[B, L, W]`` ``DepSetBatch``
of ``ops/depset.py`` with vectorized NumPy scatters -- no per-entry
``InstancePrefixSet`` objects on the decode path -- so a receiver can
union or compare a whole drain in one device reduction
(``drain_union``). The inverse (``sets_to_columns``) feeds the
coalescer. Layout-only; protocol message types never appear here.

Sets whose sparse ids span more than ``MAX_TAIL_WINDOW`` fall back to
host algebra (mirroring ``protocols/epaxos/device_deps.py`` -- tails
hug the per-column watermarks in steady state, so the dense window is
the common case).
"""

from __future__ import annotations

from typing import Optional

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops import depset
from frankenpaxos_tpu_torch.ops.quorum import int32, stage
import numpy as np
import torch

MAX_TAIL_WINDOW = 2048


def sets_to_columns(dep_sets) -> Optional[tuple[int, tuple, tuple, tuple]]:
    """Flatten InstancePrefixSet-shaped objects (anything with
    ``columns`` of ``(watermark, values)``) into flat column tuples.

    Returns ``(num_leaders, watermarks, counts, values)`` with values
    per column in ascending order, or None when the sets disagree on
    column count (a malformed mix -- callers decline to coalesce).
    """
    if not dep_sets:
        return None
    num_leaders = len(dep_sets[0].columns)
    watermarks: list[int] = []
    counts: list[int] = []
    values: list[int] = []
    for dep_set in dep_sets:
        if len(dep_set.columns) != num_leaders:
            return None
        for column in dep_set.columns:
            ordered = sorted(column.values)
            watermarks.append(column.watermark)
            counts.append(len(ordered))
            values.extend(ordered)
    return num_leaders, tuple(watermarks), tuple(counts), tuple(values)


def split_columns(num_leaders: int, watermarks, counts, values):
    """Per-entry views of flat columns: yields ``(watermarks [L],
    counts [L], values tuple)`` for each of the B entries."""
    if num_leaders <= 0:
        raise ValueError(f"num_leaders must be positive: {num_leaders}")
    if len(watermarks) % num_leaders or len(watermarks) != len(counts):
        raise ValueError(
            f"ragged columns: {len(watermarks)} watermarks, "
            f"{len(counts)} counts, L={num_leaders}")
    if sum(counts) != len(values):
        raise ValueError(
            f"ragged columns: counts sum to {sum(counts)} but "
            f"{len(values)} values present")
    offset = 0
    for entry in range(len(watermarks) // num_leaders):
        lo, hi = entry * num_leaders, (entry + 1) * num_leaders
        taken = sum(counts[lo:hi])
        yield (watermarks[lo:hi], counts[lo:hi],
               values[offset:offset + taken])
        offset += taken


def columns_to_batch(num_leaders: int, watermarks, counts, values,
                     device=None, out=None, seqs=None):
    """Flat columns -> one ``[B, L, W]`` DepSetBatch on ``device``
    (``cuda`` when None), scattered on the host without per-entry Python
    objects, then one copy per array. None when the sparse ids span a
    window wider than ``MAX_TAIL_WINDOW`` (callers fall back to host
    sets).

    With ``out``, a function of ``(b, l, w, s)`` that returns a
    ``depset.Packed`` block (``functools.partial(depset.packed,
    device=...)``: on a card, the staging's reused pinned memory), the
    same arrays land in that block instead, with ``seqs`` (``[B]``
    int32 sequence numbers, for K10's seq mode) beside them, and the
    block is returned for ``drain_union`` / ``depset.union_packed``.
    """
    if num_leaders <= 0 or len(watermarks) % num_leaders:
        return None
    num_entries = len(watermarks) // num_leaders
    vals = np.fromiter(values, dtype=np.int64, count=len(values))
    counts_arr = np.fromiter(counts, dtype=np.int64, count=len(counts))
    if counts_arr.sum() != vals.shape[0]:
        return None
    base = int(vals.min()) if vals.size else 0
    spread = (int(vals.max()) - base + 1) if vals.size else 1
    width = 8
    while width < spread:
        width *= 2
    if width > MAX_TAIL_WINDOW:
        return None
    rows = np.repeat(np.arange(num_entries * num_leaders), counts_arr)
    if out is not None:
        packed = out(num_entries, num_leaders, width,
                     0 if seqs is None else len(seqs))
        packed.watermarks.reshape(-1)[:] = np.fromiter(
            watermarks, dtype=np.int32, count=len(watermarks))
        packed.tails.reshape(-1, width)[rows, vals - base] = 1
        packed.tail_base[...] = int32(base)
        if seqs is not None:
            packed.seqs[:] = seqs
        return packed
    device = resolve_device(device)
    wm = np.asarray(watermarks, dtype=np.int32).reshape(num_entries,
                                                        num_leaders)
    tails = np.zeros((num_entries * num_leaders, width), dtype=np.uint8)
    tails[rows, vals - base] = 1
    return depset.DepSetBatch(
        stage(wm, device),
        stage(tails.reshape(num_entries, num_leaders, width), device),
        torch.tensor(int32(base), dtype=torch.int32).to(device))


def drain_union(batch) -> tuple[np.ndarray, np.ndarray, int]:
    """Union every dependency set of a decoded drain in one reduction:
    ``(watermarks [L], tails [L, W], tail_base)`` on host. A
    ``DepSetBatch`` goes through K10's tensor wrapper (on a CUDA batch);
    a ``depset.Packed`` block (``columns_to_batch(out=...)``) through ONE
    staged K10 call, its result copied out of the reused staging.
    """
    if isinstance(batch, depset.Packed):
        _, watermarks, tails = depset.union_packed(batch)
        return watermarks.copy(), tails.copy(), int(batch.tail_base)
    reduced = depset.union_reduce(batch)
    return (reduced.watermarks[0].cpu().numpy(),
            reduced.tails[0].cpu().numpy(), int(reduced.tail_base))
