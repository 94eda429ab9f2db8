"""Device-backed dependency-set algebra for the EPaxos replica.

The port's copy of ``frankenpaxos_tpu/protocols/epaxos/device_deps.py``.
It bridges host ``InstancePrefixSet``s (one IntPrefixSet per replica
column, epaxos/InstancePrefixSet.scala:12-60) to the batched
``DepSetBatch`` of ``ops/depset.py``, so the replica's two hottest set
computations run as single device reductions per call instead of
per-reply host loops:

  * slow-path dependency union across a quorum of PreAcceptOks
    (epaxos/Replica.scala:795-813) -> :func:`conflict_max_many` (K10);
  * fast-path "all replies carry identical deps" test
    (epaxos/Replica.scala:1291-1420) -> :func:`all_identical` (K11).

Every function takes the ``device`` the batch goes to (``cuda`` when
None; ``"cpu"`` runs the plain versions). Sets whose sparse tails span
more than ``MAX_TAIL_WINDOW`` ids take the host algebra: that is the
reference's protocol rule (the device layout is a dense window, and
EPaxos tails hug the per-column watermarks in steady state), not a
fall-back from a failed kernel; ``_count`` records each such call.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.compact import IntPrefixSet
from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops import depset
from frankenpaxos_tpu_torch.ops.quorum import int32, stage
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    InstancePrefixSet,
)
import numpy as np
import torch

MAX_TAIL_WINDOW = 2048


def to_batch(sets: list[InstancePrefixSet], num_replicas: int,
             device=None) -> depset.DepSetBatch | None:
    """Pack host sets into one [B, L, W] batch on ``device``: numpy
    arrays built on the host, then one copy per array.

    Returns None when the sparse tails span a window wider than
    ``MAX_TAIL_WINDOW`` (callers take the host algebra).
    """
    device = resolve_device(device)
    values = [v for s in sets for c in s.columns for v in c.values]
    base = min(values) if values else 0
    spread = (max(values) - base + 1) if values else 1
    width = 8
    while width < spread:
        width *= 2
    if width > MAX_TAIL_WINDOW:
        return None
    watermarks = np.zeros((len(sets), num_replicas), dtype=np.int32)
    tails = np.zeros((len(sets), num_replicas, width), dtype=np.uint8)
    for b, instance_set in enumerate(sets):
        for column_index, column in enumerate(instance_set.columns):
            watermarks[b, column_index] = column.watermark
            for v in column.values:
                tails[b, column_index, v - base] = 1
    return depset.DepSetBatch(
        stage(watermarks, device), stage(tails, device),
        torch.tensor(int32(base), dtype=torch.int32).to(device))


def from_row(watermarks: np.ndarray, tails: np.ndarray,
             tail_base: int) -> InstancePrefixSet:
    """Unpack one row ([L], [L, W]) back into an InstancePrefixSet."""
    columns = []
    for column_index in range(watermarks.shape[0]):
        present = np.nonzero(tails[column_index])[0]
        columns.append(IntPrefixSet(
            int(watermarks[column_index]),
            {tail_base + int(i) for i in present}))
    return InstancePrefixSet(len(columns), columns)


def _row(reduced: depset.DepSetBatch) -> InstancePrefixSet:
    """Row 0 of a device batch as a host set: one ``[L]`` and one
    ``[L, W]`` fetch."""
    return from_row(reduced.watermarks[0].cpu().numpy(),
                    reduced.tails[0].cpu().numpy(),
                    int(reduced.tail_base))


def _count(metrics, nsets: int, fell_back: bool) -> None:
    """paxruns runtime metrics: dep columns routed through the batched
    engine, and sparse-span host fallbacks."""
    if metrics is None:
        return
    metrics.depset_batch(nsets)
    if fell_back:
        metrics.depset_span_fallback()


def union_many(sets: list[InstancePrefixSet], num_replicas: int,
               device=None, metrics=None) -> InstancePrefixSet:
    """Union of all sets, reduced on ``device`` by K10 (host algebra on
    a span wider than ``MAX_TAIL_WINDOW``)."""
    batch = to_batch(sets, num_replicas, device)
    _count(metrics, len(sets), batch is None)
    if batch is None:
        union = InstancePrefixSet(num_replicas)
        for instance_set in sets:
            union.add_all(instance_set)
        return union
    return _row(depset.union_reduce(batch))


def conflict_max_many(seq_deps: list[tuple[int, InstancePrefixSet]],
                      num_replicas: int, device=None,
                      metrics=None) -> tuple[int, InstancePrefixSet]:
    """Quorum (max sequence number, union deps) as ONE K10 launch on
    ``device`` (host algebra on a span wider than ``MAX_TAIL_WINDOW``)."""
    batch = to_batch([deps for _, deps in seq_deps], num_replicas, device)
    _count(metrics, len(seq_deps), batch is None)
    if batch is None:
        union = InstancePrefixSet(num_replicas)
        for _, deps in seq_deps:
            union.add_all(deps)
        return max(seq for seq, _ in seq_deps), union
    seqs = stage(np.asarray([int32(seq) for seq, _ in seq_deps],
                            dtype=np.int32), batch.tails.device)
    seq, reduced = depset.conflict_max(seqs, batch)
    return int(seq), _row(reduced)


def all_identical(seq_deps: list[tuple[int, InstancePrefixSet]],
                  num_replicas: int, device=None, metrics=None) -> bool:
    """Do all (sequence number, deps) pairs denote the same set? The
    deps compare on ``device`` by K11; the protocol branches on the
    answer, so this reads it back."""
    if len(seq_deps) <= 1:
        return True
    if len({seq for seq, _ in seq_deps}) > 1:
        return False
    batch = to_batch([deps for _, deps in seq_deps], num_replicas, device)
    _count(metrics, len(seq_deps), batch is None)
    if batch is None:
        first = seq_deps[0][1]
        return all(deps == first for _, deps in seq_deps[1:])
    return bool(depset.all_equal(batch))
