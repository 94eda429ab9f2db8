"""Batched dependency-set algebra for EPaxos/BPaxos on one GPU: K9-K11.

Counterpart of ``frankenpaxos_tpu/ops/depset.py``. Reference behavior:
epaxos/InstancePrefixSet.scala:12-60 -- a dependency set over vertex ids
``(leader, id)`` stored as one IntPrefixSet per leader column. A batch of
dependency sets is:

  * ``watermarks [B, L] int32``: per-leader prefix ("ids < w all present"),
  * ``tails [B, L, W] uint8``: sparse window of ids in
    ``[base, base + W)`` (absolute offsets from a shared GC base),
  * ``tail_base [] int32``: the id of tail column 0.

Every function is a hand-written CUDA kernel (``csrc/depset.cu``, the
row normalization shared in ``csrc/depset.cuh``) with its plain PyTorch
version beside it:

  * K9 :func:`normalized` (:func:`normalized_plain`);
  * K10 :func:`union_reduce` and :func:`conflict_max`, one kernel with
    two entry modes (:func:`union_reduce_plain`,
    :func:`conflict_max_plain`): the EPaxos slow path;
  * K11 :func:`all_equal` (:func:`all_equal_plain`): the fast path;
  * K16, a row-pair transform with three modes: :func:`union` (max and
    OR, NOT normalized), :func:`intersect` and :func:`compact` (both
    normalized), with :func:`union_plain`, :func:`intersect_plain` and
    :func:`compact_plain`;
  * K17, a row query with three modes: :func:`equal`, :func:`size` and
    :func:`contains`, with :func:`equal_plain`, :func:`size_plain` and
    :func:`contains_plain`.

A batch may also be split by rows over a ``mesh.Mesh`` of ranks
(:func:`shard_rows`): the rowwise functions (``union``, ``equal``,
``size``, ...) then run on each rank's rows as they stand, and
:func:`union_reduce_sharded` reduces across the ranks.

A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; anything else raises, and nothing falls back.
The ``_checked`` forms read both tail bases on the host (a sync), as the
reference does; every other function never syncs.

Arithmetic follows the reference's dtypes exactly: ids are int32
``tail_base + arange(W)`` and wrap; the run at a watermark is the uint32
sum of a uint8 cumulative product (wrapping mod 256, so bytes other than
0/1 count as the reference counts them); the raised watermark wraps as
int32; every comparison is signed int32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops.quorum import use_kernel
import torch


def _pow2(n: int) -> int:
    """Smallest power of two >= n (bucket size for cached planes)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _index_plane(cap: int, device: torch.device) -> torch.Tensor:
    """Cached ``[cap] int32`` row-index plane at pow2 capacity, one per
    device (built at first use, never at import)."""
    return torch.arange(cap, dtype=torch.int32, device=device)


class DepSetBatch(NamedTuple):
    watermarks: torch.Tensor  # [B, L] int32
    tails: torch.Tensor       # [B, L, W] uint8, absolute base `tail_base`
    tail_base: torch.Tensor   # [] int32: id of tail column 0


def _check(d: DepSetBatch) -> None:
    wm, tails, base = d
    if (wm.dtype != torch.int32 or tails.dtype != torch.uint8
            or base.dtype != torch.int32 or wm.dim() != 2
            or tails.dim() != 3 or base.dim() != 0
            or tuple(tails.shape[:2]) != tuple(wm.shape)):
        raise ValueError(
            f"a DepSetBatch is [B, L] int32 watermarks, [B, L, W] uint8 "
            f"tails and a 0-d int32 tail_base; got {wm.dtype} "
            f"{tuple(wm.shape)}, {tails.dtype} {tuple(tails.shape)}, "
            f"{base.dtype} {tuple(base.shape)}")


def _check_nonempty(d: DepSetBatch, fn: str) -> None:
    _check(d)
    if d.watermarks.shape[0] == 0:
        raise ValueError(f"{fn} of an empty batch (B = 0)")


def _check_seqs(seqs: torch.Tensor) -> None:
    if seqs.dtype != torch.int32 or seqs.dim() != 1 or seqs.shape[0] == 0:
        raise ValueError(f"seqs must be a non-empty [S] int32 tensor, got "
                         f"{seqs.dtype} {tuple(seqs.shape)}")


def _contiguous(d: DepSetBatch) -> None:
    if not all(t.is_contiguous() for t in d):
        raise ValueError("the depset kernels need contiguous tensors")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 ``x`` wrapped to int32, as int32 arithmetic wraps."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _ids(d: DepSetBatch) -> torch.Tensor:
    """``[W]`` int32 ids of the tail columns, wrapping like the
    reference's int32 ``tail_base + arange(W)``."""
    w = d.tails.shape[-1]
    return _wrap32(d.tail_base.to(torch.int64)
                   + torch.arange(w, dtype=torch.int64,
                                  device=d.tails.device))


# --- K9: normalization --------------------------------------------------


def normalized_plain(d: DepSetBatch) -> DepSetBatch:
    """Plain PyTorch version of K9: clear tail bytes covered by the
    watermark, absorb the contiguous run at it (the uint32 sum of the
    uint8 cumprod, as the reference computes it), clear again."""
    _check(d)
    ids = _ids(d)[None, None, :]
    wm = d.watermarks
    covered = ids < wm[:, :, None]
    zero = torch.zeros((), dtype=torch.uint8, device=d.tails.device)
    tails = torch.where(covered, zero, d.tails)
    present_from = torch.where(covered, zero + 1, tails)
    run = torch.cumprod(present_from, dim=-1, dtype=torch.uint8).sum(
        dim=-1, dtype=torch.int64)
    raised = _wrap32(d.tail_base.to(torch.int64) + run)
    # The run from the window start is contiguous with the watermark only
    # when the watermark has reached the window (wm >= tail_base).
    new_wm = torch.where(wm >= d.tail_base, torch.maximum(wm, raised), wm)
    covered2 = ids < new_wm[:, :, None]
    return DepSetBatch(new_wm, torch.where(covered2, zero, tails),
                       d.tail_base)


def normalized(d: DepSetBatch) -> DepSetBatch:
    """K9: the batch with every ``(b, l)`` row in IntPrefixSet canonical
    form, in new tensors. CUDA tensors launch
    ``csrc/depset.cu::depset_normalized_kernel`` (one warp per row); CPU
    tensors take :func:`normalized_plain`."""
    _check(d)
    if not use_kernel(*d):
        return normalized_plain(d)
    _contiguous(d)
    b, l, w = d.tails.shape
    wm = torch.empty_like(d.watermarks)
    tails = torch.empty_like(d.tails)
    if b * l == 0:
        return DepSetBatch(wm, tails, d.tail_base)
    lib = _build.library("depset")
    rc = lib.fpx_depset_normalized(
        d.watermarks.data_ptr(), d.tails.data_ptr(), d.tail_base.data_ptr(),
        b * l, w, wm.data_ptr(), tails.data_ptr(),
        *_build.stream_args(d.tails.device))
    _build.check("depset", "fpx_depset_normalized", rc)
    normalized.launches += 1
    return DepSetBatch(wm, tails, d.tail_base)


normalized.launches = 0


# --- K10: the quorum union, with the max sequence number ----------------


def union_reduce_plain(d: DepSetBatch) -> DepSetBatch:
    """Plain PyTorch version of K10's union: max over B of watermarks
    and of tail bytes (max, not OR, as the reference), then K9's
    normalization; a ``[1, L]``, ``[1, L, W]`` batch."""
    _check_nonempty(d, "union_reduce")
    return normalized_plain(DepSetBatch(
        d.watermarks.amax(dim=0, keepdim=True),
        d.tails.amax(dim=0, keepdim=True), d.tail_base))


def conflict_max_plain(seqs: torch.Tensor, d: DepSetBatch
                       ) -> tuple[torch.Tensor, DepSetBatch]:
    """Plain PyTorch version of K10 in its seq mode: ``(max(seqs)`` as a
    0-d int32, :func:`union_reduce_plain` ``(d))``."""
    _check_seqs(seqs)
    return seqs.amax(), union_reduce_plain(d)


def _union_launch(d: DepSetBatch, seqs):
    """One launch of ``csrc/depset.cu::depset_union_reduce_kernel``:
    the union row, and the max of ``seqs`` when it is given."""
    _contiguous(d)
    b, l, w = d.tails.shape
    dev = d.tails.device
    wm = torch.empty((1, l), dtype=torch.int32, device=dev)
    tails = torch.empty((1, l, w), dtype=torch.uint8, device=dev)
    seq = None if seqs is None \
        else torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.library("depset")
    rc = lib.fpx_depset_union_reduce(
        d.watermarks.data_ptr(), d.tails.data_ptr(), d.tail_base.data_ptr(),
        b, l, w, None if seqs is None else seqs.data_ptr(),
        0 if seqs is None else seqs.shape[0], wm.data_ptr(),
        tails.data_ptr(), None if seq is None else seq.data_ptr(),
        *_build.stream_args(dev))
    _build.check("depset", "fpx_depset_union_reduce", rc)
    return seq, DepSetBatch(wm, tails, d.tail_base)


def union_reduce(d: DepSetBatch) -> DepSetBatch:
    """K10: the union of ALL rows as a normalized one-row batch (the
    EPaxos slow path unions the dependency sets of every PreAcceptOk in
    a quorum, epaxos/Replica.scala:795-813). ``B = 0`` raises. CUDA
    tensors launch the kernel (one block per leader column); CPU tensors
    take :func:`union_reduce_plain`."""
    _check_nonempty(d, "union_reduce")
    if not use_kernel(*d):
        return union_reduce_plain(d)
    _, out = _union_launch(d, None)
    union_reduce.launches += 1
    return out


union_reduce.launches = 0


def shard_rows(d: DepSetBatch, mesh) -> DepSetBatch:
    """This rank's rows of a batch whose B axis is split over every rank
    of ``mesh`` in rank order (the reference's batch sharding over
    ``PartitionSpec(("group", "slot"))``), ``tail_base`` whole, moved to
    the mesh's device. Raises unless the mesh size divides B."""
    _check(d)
    lo, hi = mesh.columns(d.watermarks.shape[0])
    dev = mesh.device
    return DepSetBatch(d.watermarks[lo:hi].contiguous().to(dev),
                       d.tails[lo:hi].contiguous().to(dev),
                       d.tail_base.to(dev))


def union_reduce_sharded(d: DepSetBatch, mesh) -> DepSetBatch:
    """:func:`union_reduce` of a batch whose rows are split over
    ``mesh`` (``d`` is this rank's rows, at the one ``tail_base`` every
    rank holds): K10 on the local rows, an all-reduce MAX of the union
    row's watermarks and tails over the mesh, then K9 on that row. Every
    rank gets the whole batch's union row. It equals the unsharded
    reduction because a normalized row is canonical for its set at a
    fixed ``tail_base`` (the watermark is the least absent id from the
    window on, or the row is left as it stands when the watermark is
    below the window), normalization keeps the set, and MAX over rows of
    0/1 tails is their union: so normalizing the max of the local union
    rows gives the canonical row of the union of all rows, as
    normalizing the max of all rows does. Tails must hold 0/1 bytes
    (sets), as every batch built from prefix sets does."""
    local = union_reduce(d)
    mesh.pmax_mesh(local.watermarks)
    mesh.pmax_mesh(local.tails)
    return normalized(local)


def conflict_max(seqs: torch.Tensor, d: DepSetBatch
                 ) -> tuple[torch.Tensor, DepSetBatch]:
    """K10 in its seq mode: the EPaxos seq/deps conflict aggregation
    over a quorum of replies, ``(max(seqs [S] int32)`` as a 0-d int32,
    :func:`union_reduce` ``(d))``, in ONE launch."""
    _check_nonempty(d, "conflict_max")
    _check_seqs(seqs)
    if not use_kernel(seqs, *d):
        return conflict_max_plain(seqs, d)
    if not seqs.is_contiguous():
        raise ValueError("conflict_max needs contiguous seqs")
    seq, out = _union_launch(d, seqs)
    conflict_max.launches += 1
    return seq, out


conflict_max.launches = 0


# --- K11: the fast path's all-equal test --------------------------------


def all_equal_plain(d: DepSetBatch) -> torch.Tensor:
    """Plain PyTorch version of K11: normalize, then compare every row's
    watermarks and tail bytes with row 0's."""
    _check_nonempty(d, "all_equal")
    n = normalized_plain(d)
    return ((n.watermarks == n.watermarks[0]).all()
            & (n.tails == n.tails[0]).all())


def all_equal(d: DepSetBatch) -> torch.Tensor:
    """K11: ``[]`` bool, do all B rows denote the same set? Rows are
    compared in normalized form, so a set written as tail bytes in one
    row and as a watermark in another compares equal. ``B = 0`` raises.

    CUDA tensors launch ``csrc/depset.cu::depset_all_equal_kernel`` (one
    warp per row ``(b >= 1, l)`` against row ``(0, l)``) and return the
    0-d bool on the device WITHOUT a sync: the caller reads it. CPU
    tensors take :func:`all_equal_plain`."""
    _check_nonempty(d, "all_equal")
    if not use_kernel(*d):
        return all_equal_plain(d)
    _contiguous(d)
    b, l, w = d.tails.shape
    out = torch.empty((), dtype=torch.bool, device=d.tails.device)
    lib = _build.library("depset")
    rc = lib.fpx_depset_all_equal(
        d.watermarks.data_ptr(), d.tails.data_ptr(), d.tail_base.data_ptr(),
        b, l, w, out.data_ptr(), *_build.stream_args(d.tails.device))
    _build.check("depset", "fpx_depset_all_equal", rc)
    all_equal.launches += 1
    return out


all_equal.launches = 0


# --- K16: union, intersect and compact ----------------------------------


def _check_pair(a: DepSetBatch, b: DepSetBatch, fn: str) -> None:
    _check(a)
    _check(b)
    if a.tails.shape != b.tails.shape:
        raise ValueError(f"{fn} takes two batches of one [B, L, W] shape, "
                         f"got {tuple(a.tails.shape)} and "
                         f"{tuple(b.tails.shape)}")


def union_plain(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Plain PyTorch version of K16's union: max of watermarks, OR of
    tail bytes, not normalized; ``a``'s tail base."""
    _check_pair(a, b, "union")
    return DepSetBatch(torch.maximum(a.watermarks, b.watermarks),
                       a.tails | b.tails, a.tail_base)


def intersect_plain(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Plain PyTorch version of K16's intersect: ids below both
    watermarks stay prefix (``min``); the rest lands as 0/1 tail bytes,
    then :func:`normalized_plain`."""
    _check_pair(a, b, "intersect")
    ids = _ids(a)[None, None, :]
    in_a = (ids < a.watermarks[:, :, None]) | (a.tails > 0)
    in_b = (ids < b.watermarks[:, :, None]) | (b.tails > 0)
    new_wm = torch.minimum(a.watermarks, b.watermarks)
    tails = (in_a & in_b & (ids >= new_wm[:, :, None])).to(torch.uint8)
    return normalized_plain(DepSetBatch(new_wm, tails, a.tail_base))


def _executed(d: DepSetBatch, executed) -> torch.Tensor:
    """``executed`` as int32 on the batch's device, broadcast to the
    ``[B, L]`` watermarks (a view with stride 0 on a broadcast axis)."""
    executed = torch.as_tensor(executed, dtype=torch.int32,
                               device=d.tails.device)
    return torch.broadcast_to(executed, tuple(d.watermarks.shape))


def compact_plain(d: DepSetBatch, executed) -> DepSetBatch:
    """Plain PyTorch version of K16's compact: raise each watermark to at
    least ``executed`` (``[]``, ``[L]``, ``[1, L]`` or ``[B, L]``, as
    ``jnp.maximum`` broadcasts), then :func:`normalized_plain`."""
    _check(d)
    wm = torch.maximum(d.watermarks, _executed(d, executed))
    return normalized_plain(DepSetBatch(wm, d.tails, d.tail_base))


def _pair_launch(mode: int, a: DepSetBatch, b, executed) -> tuple:
    """One launch of ``csrc/depset.cu::depset_pair_kernel`` into new
    tensors; returns ``(launched, out)`` (an empty batch launches
    nothing)."""
    _contiguous(a)
    if b is not None:
        _contiguous(b)
    bb, l, w = a.tails.shape
    wm = torch.empty_like(a.watermarks)
    tails = torch.empty_like(a.tails)
    if bb * l == 0:
        return False, DepSetBatch(wm, tails, a.tail_base)
    lib = _build.library("depset")
    rc = lib.fpx_depset_pair(
        mode, a.watermarks.data_ptr(), a.tails.data_ptr(),
        None if b is None else b.watermarks.data_ptr(),
        None if b is None else b.tails.data_ptr(),
        None if executed is None else executed.data_ptr(),
        0 if executed is None else executed.stride(0),
        0 if executed is None else executed.stride(1),
        a.tail_base.data_ptr(), bb, l, w, wm.data_ptr(), tails.data_ptr(),
        *_build.stream_args(a.tails.device))
    _build.check("depset", "fpx_depset_pair", rc)
    return True, DepSetBatch(wm, tails, a.tail_base)


def union(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """K16 union: rowwise max of watermarks and OR of tail bytes, NOT
    normalized (the reference's ``union``), into new tensors.

    PRECONDITION: ``a.tail_base == b.tail_base`` (use
    :func:`union_checked` from host code to enforce it). The batches may
    be the same. CUDA tensors launch the kernel (one warp per row); CPU
    tensors take :func:`union_plain`."""
    _check_pair(a, b, "union")
    if not use_kernel(*a, *b):
        return union_plain(a, b)
    launched, out = _pair_launch(0, a, b, None)
    union.launches += launched
    return out


union.launches = 0


def union_checked(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Host-side union that enforces the shared-tail-base precondition."""
    if int(a.tail_base) != int(b.tail_base):
        raise ValueError(
            f"dep-set unions need a shared tail base: "
            f"{int(a.tail_base)} != {int(b.tail_base)}")
    return union(a, b)


def intersect(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """K16 intersect: rowwise set intersection, the interference-closure
    step, normalized.

    PRECONDITION: shared ``tail_base`` (use :func:`intersect_checked`
    from host code). Ids below both watermarks stay prefix (``min`` of
    watermarks); everything else lands as tail bytes and renormalizes.
    CUDA tensors launch the kernel; CPU tensors take
    :func:`intersect_plain`."""
    _check_pair(a, b, "intersect")
    if not use_kernel(*a, *b):
        return intersect_plain(a, b)
    launched, out = _pair_launch(1, a, b, None)
    intersect.launches += launched
    return out


intersect.launches = 0


def intersect_checked(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Host-side intersection enforcing the shared-tail-base precondition."""
    if int(a.tail_base) != int(b.tail_base):
        raise ValueError(
            f"dep-set intersections need a shared tail base: "
            f"{int(a.tail_base)} != {int(b.tail_base)}")
    return intersect(a, b)


def compact(d: DepSetBatch, executed) -> DepSetBatch:
    """K16 compact: prefix-compaction against the executed watermark.
    ``executed`` is ``[]``, ``[L]``, ``[1, L]`` or ``[B, L]`` int32 (any
    shape that broadcasts to the watermarks); each column's watermark
    rises to at least it, then the rows renormalize. CUDA tensors launch
    the kernel; CPU tensors take :func:`compact_plain`."""
    _check(d)
    executed = _executed(d, executed)
    if not use_kernel(*d, executed):
        return compact_plain(d, executed)
    launched, out = _pair_launch(2, d, None, executed)
    compact.launches += launched
    return out


compact.launches = 0


# --- K17: equal, size and contains ----------------------------------------


def equal_plain(a: DepSetBatch, b: DepSetBatch) -> torch.Tensor:
    """Plain PyTorch version of K17's equal: every watermark and every
    tail byte of the row equal."""
    _check_pair(a, b, "equal")
    return ((a.watermarks == b.watermarks).all(dim=-1)
            & (a.tails == b.tails).flatten(1).all(dim=-1))


def size_plain(d: DepSetBatch) -> torch.Tensor:
    """Plain PyTorch version of K17's size: the sum of the watermarks
    plus the sum of the tail byte values, wrapping as int32."""
    _check(d)
    return _wrap32(d.watermarks.sum(dim=-1, dtype=torch.int64)
                   + d.tails.flatten(1).sum(dim=-1, dtype=torch.int64))


def _contains_args(d: DepSetBatch, leader, vid) -> tuple:
    """``leader`` and ``vid`` as int32 ``[B]`` broadcast views."""
    _check(d)
    b, l, w = d.tails.shape
    if b and (l == 0 or w == 0):
        raise ValueError(f"contains needs a leader column and a tail "
                         f"window, got [B, L, W] = {[b, l, w]}")
    dev = d.tails.device
    leader, vid = (torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.int32, device=dev), (b,))
        for x in (leader, vid))
    return leader, vid


def contains_plain(d: DepSetBatch, leader, vid) -> torch.Tensor:
    """Plain PyTorch version of K17's contains, the reference's gather:
    negative leaders count from the end, then clamp; the row-index plane
    is the cached pow2 :func:`_index_plane`."""
    leader, vid = _contains_args(d, leader, vid)
    b, l, w = d.tails.shape
    dev = d.tails.device
    rows = _index_plane(_pow2(b), dev)[:b].long()
    col = leader.long()
    col = torch.where(col < 0, col + l, col).clamp(0, l - 1)
    in_prefix = vid < d.watermarks[rows, col]
    off = _wrap32(vid.to(torch.int64) - d.tail_base.to(torch.int64))
    off_c = off.long().clamp(0, w - 1)
    in_tail = (d.tails[rows, col, off_c] > 0) & (off >= 0) & (off < w)
    return in_prefix | in_tail


def _query_launch(mode: int, a: DepSetBatch, b, leader, vid,
                  dtype: torch.dtype) -> tuple:
    """One launch of ``csrc/depset.cu::depset_query_kernel`` into a new
    ``[B]`` tensor of ``dtype``; returns ``(launched, out)``."""
    _contiguous(a)
    if b is not None:
        _contiguous(b)
    bb, l, w = a.tails.shape
    out = torch.empty((bb,), dtype=dtype, device=a.tails.device)
    if bb == 0:
        return False, out
    lib = _build.library("depset")
    rc = lib.fpx_depset_query(
        mode, a.watermarks.data_ptr(), a.tails.data_ptr(),
        None if b is None else b.watermarks.data_ptr(),
        None if b is None else b.tails.data_ptr(),
        None if leader is None else leader.data_ptr(),
        0 if leader is None else leader.stride(0),
        None if vid is None else vid.data_ptr(),
        0 if vid is None else vid.stride(0),
        a.tail_base.data_ptr(), bb, l, w, out.data_ptr(),
        *_build.stream_args(a.tails.device))
    _build.check("depset", "fpx_depset_query", rc)
    return True, out


def equal(a: DepSetBatch, b: DepSetBatch) -> torch.Tensor:
    """K17 equal: ``[B]`` bool rowwise equality of watermarks and tail
    bytes (set equality when both batches are normalized, as callers
    pass them). CUDA tensors launch the kernel (one warp per row); CPU
    tensors take :func:`equal_plain`."""
    _check_pair(a, b, "equal")
    if not use_kernel(*a, *b):
        return equal_plain(a, b)
    launched, out = _query_launch(0, a, b, None, None, torch.bool)
    equal.launches += launched
    return out


equal.launches = 0


def size(d: DepSetBatch) -> torch.Tensor:
    """K17 size: ``[B]`` int32 cardinality of normalized rows -- the sum
    of the watermarks plus the sum of the tail byte values, wrapping as
    the reference's int32 sums. CUDA tensors launch the kernel (one warp
    per row); CPU tensors take :func:`size_plain`."""
    _check(d)
    if not use_kernel(*d):
        return size_plain(d)
    launched, out = _query_launch(1, d, None, None, None, torch.int32)
    size.launches += launched
    return out


size.launches = 0


def contains(d: DepSetBatch, leader, vid) -> torch.Tensor:
    """K17 contains: ``[B]`` bool, does each row contain vertex
    ``(leader[b], vid[b])``? ``leader`` and ``vid`` are ``[B]`` or
    scalars. Leader indices follow the reference's gather: negative ones
    count from the end, then clamp to ``[0, L-1]``; the tail offset
    ``vid - tail_base`` wraps as int32. CUDA tensors launch the kernel
    (one thread per row); CPU tensors take :func:`contains_plain`."""
    leader, vid = _contains_args(d, leader, vid)
    if not use_kernel(*d, leader, vid):
        return contains_plain(d, leader, vid)
    launched, out = _query_launch(2, d, None, leader, vid, torch.bool)
    contains.launches += launched
    return out


contains.launches = 0
