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

Each decision on a card is ONE staged call: :func:`pack` writes the sets
straight into the staging's reused pinned block (``ops/depset.py::
packed``: numpy scatters, no per-value Python loop), one ``ctypes`` call
copies it up, launches K10 or K11, copies the packed result down and
waits, and :func:`from_row` turns the result into a set. :func:`to_batch`
(a ``DepSetBatch`` of tensors) stays for the tests and benches.
"""

from __future__ import annotations

from itertools import chain

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
    """Unpack one row ([L], [L, W]) back into an InstancePrefixSet: one
    ``np.nonzero`` over the row's tails, ids ``tail_base + offset``."""
    values = [set() for _ in range(watermarks.shape[0])]
    columns, offsets = np.nonzero(tails)
    for column, value in zip(columns.tolist(),
                             (offsets + tail_base).tolist()):
        values[column].add(value)
    return InstancePrefixSet(len(values), [
        IntPrefixSet(watermark, column)
        for watermark, column in zip(watermarks.tolist(), values)])


def pack(sets: list[InstancePrefixSet], num_replicas: int, device=None,
         seqs=None) -> depset.Packed | None:
    """The sets (and ``seqs``, their sequence numbers, which must fit in
    int32, for K10's seq mode) written into one packed input block on
    ``device``
    (``ops/depset.py::packed``), the same arrays as :func:`to_batch`'s:
    the watermarks and the tail ids cross through ``np.fromiter`` and one
    fancy-index assignment (``runs/depruns.py::columns_to_batch``'s
    scatter). None when the tails span more than ``MAX_TAIL_WINDOW``."""
    columns = [c for s in sets for c in s.columns]
    counts = np.fromiter((len(c.values) for c in columns), np.int64,
                         len(columns))
    values = np.fromiter(chain.from_iterable(c.values for c in columns),
                         np.int64)
    base = int(values.min()) if values.size else 0
    spread = int(values.max()) - base + 1 if values.size else 1
    width = 8 if spread <= 8 else 1 << (spread - 1).bit_length()
    if width > MAX_TAIL_WINDOW:
        return None
    b = len(sets)
    p = depset.packed(b, num_replicas, width,
                      0 if seqs is None else len(seqs), device)
    # Row b * L + c of each set's c-th column, as to_batch places it.
    if all(len(s.columns) == num_replicas for s in sets):
        rows = np.arange(len(columns))
    else:
        per_set = np.fromiter((len(s.columns) for s in sets), np.int64, b)
        if (per_set > num_replicas).any():
            raise ValueError(f"a set has more than {num_replicas} columns")
        starts = np.repeat(np.cumsum(per_set) - per_set, per_set)
        rows = (np.repeat(np.arange(b) * num_replicas, per_set)
                + np.arange(len(columns)) - starts)
        p.watermarks[...] = 0
    p.watermarks.reshape(-1)[rows] = np.fromiter(
        (c.watermark for c in columns), np.int32, len(columns))
    p.tails.reshape(-1, width)[np.repeat(rows, counts), values - base] = 1
    p.tail_base[...] = int32(base)
    if seqs is not None:
        p.seqs[:] = seqs
    return p


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
    """Union of all sets, reduced on ``device`` by K10 in ONE staged call
    (host algebra on a span wider than ``MAX_TAIL_WINDOW``)."""
    p = pack(sets, num_replicas, device)
    _count(metrics, len(sets), p is None)
    if p is None:
        union = InstancePrefixSet(num_replicas)
        for instance_set in sets:
            union.add_all(instance_set)
        return union
    _, watermarks, tails = depset.union_packed(p)
    return from_row(watermarks, tails, int(p.tail_base))


def conflict_max_many(seq_deps: list[tuple[int, InstancePrefixSet]],
                      num_replicas: int, device=None,
                      metrics=None) -> tuple[int, InstancePrefixSet]:
    """Quorum (max sequence number, union deps) as ONE staged K10 call
    on ``device``, in its seq mode (host algebra on a span wider than
    ``MAX_TAIL_WINDOW``)."""
    p = pack([deps for _, deps in seq_deps], num_replicas, device,
             seqs=[seq for seq, _ in seq_deps])
    _count(metrics, len(seq_deps), p is None)
    if p is None:
        union = InstancePrefixSet(num_replicas)
        for _, deps in seq_deps:
            union.add_all(deps)
        return max(seq for seq, _ in seq_deps), union
    seq, watermarks, tails = depset.union_packed(p)
    return seq, from_row(watermarks, tails, int(p.tail_base))


def all_identical(seq_deps: list[tuple[int, InstancePrefixSet]],
                  num_replicas: int, device=None, metrics=None) -> bool:
    """Do all (sequence number, deps) pairs denote the same set? The
    deps compare on ``device`` by K11 in ONE staged call, which returns
    the answer on the host."""
    if len(seq_deps) <= 1:
        return True
    if len({seq for seq, _ in seq_deps}) > 1:
        return False
    p = pack([deps for _, deps in seq_deps], num_replicas, device)
    _count(metrics, len(seq_deps), p is None)
    if p is None:
        first = seq_deps[0][1]
        return all(deps == first for _, deps in seq_deps[1:])
    return depset.all_equal_packed(p)
