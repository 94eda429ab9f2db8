"""Batched dependency-set algebra for EPaxos/BPaxos on one GPU: K9-K11.

Counterpart of ``frankenpaxos_tpu/ops/depset.py``. Reference behavior:
epaxos/InstancePrefixSet.scala:12-60 -- a dependency set over vertex ids
``(leader, id)`` stored as one IntPrefixSet per leader column. A batch of
dependency sets is:

  * ``watermarks [B, L] int32``: per-leader prefix ("ids < w all present"),
  * ``tails [B, L, W] uint8``: sparse window of ids in
    ``[base, base + W)`` (absolute offsets from a shared GC base),
  * ``tail_base [] int32``: the id of tail column 0.

Three functions are hand-written CUDA kernels (``csrc/depset.cu``, the
row normalization shared in ``csrc/depset.cuh``), each with its plain
PyTorch version beside it:

  * K9 :func:`normalized` (:func:`normalized_plain`);
  * K10 :func:`union_reduce` and :func:`conflict_max`, one kernel with
    two entry modes (:func:`union_reduce_plain`,
    :func:`conflict_max_plain`): the EPaxos slow path;
  * K11 :func:`all_equal` (:func:`all_equal_plain`): the fast path.

A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; anything else raises, and nothing falls back.
The other functions (:func:`union`, :func:`equal`, :func:`contains`,
:func:`size`, :func:`intersect`, :func:`compact` and the ``_checked``
forms) have no protocol caller and no kernel yet (PERF.md row 12d): they
take CPU tensors only and raise on any other device.

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


def _plain_only(fn: str, *tensors: torch.Tensor) -> None:
    kinds = {t.device.type for t in tensors}
    if kinds != {"cpu"}:
        raise NotImplementedError(
            f"depset.{fn} has no CUDA kernel yet (PERF.md row 12d) and "
            f"takes CPU tensors only, got {sorted(kinds)}")


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


# --- the rest of the algebra: plain versions only (PERF.md row 12d) ------


def union(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Rowwise union: max of watermarks, OR of tail bytes.

    PRECONDITION: ``a.tail_base == b.tail_base`` (use
    :func:`union_checked` from host code to enforce it)."""
    _check(a)
    _check(b)
    _plain_only("union", *a, *b)
    return DepSetBatch(torch.maximum(a.watermarks, b.watermarks),
                       a.tails | b.tails, a.tail_base)


def union_checked(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Host-side union that enforces the shared-tail-base precondition."""
    if int(a.tail_base) != int(b.tail_base):
        raise ValueError(
            f"dep-set unions need a shared tail base: "
            f"{int(a.tail_base)} != {int(b.tail_base)}")
    return union(a, b)


def equal(a: DepSetBatch, b: DepSetBatch) -> torch.Tensor:
    """[B] bool rowwise set equality; callers pass normalized batches."""
    _check(a)
    _check(b)
    _plain_only("equal", *a, *b)
    return ((a.watermarks == b.watermarks).all(dim=-1)
            & (a.tails == b.tails).flatten(1).all(dim=-1))


def contains(d: DepSetBatch, leader, vid) -> torch.Tensor:
    """[B] bool: does each row contain vertex ``(leader[b], vid[b])``?
    Leader indices follow the reference's gather: negative ones count
    from the end, then clamp. The row-index plane is the cached pow2
    :func:`_index_plane`."""
    _check(d)
    dev = d.tails.device
    leader = torch.as_tensor(leader, dtype=torch.int32, device=dev)
    vid = torch.as_tensor(vid, dtype=torch.int32, device=dev)
    _plain_only("contains", *d, leader, vid)
    b, l, w = d.tails.shape
    rows = _index_plane(_pow2(b), dev)[:b].long()
    col = leader.long()
    col = torch.where(col < 0, col + l, col).clamp(0, l - 1)
    in_prefix = vid < d.watermarks[rows, col]
    off = _wrap32(vid.to(torch.int64) - d.tail_base.to(torch.int64))
    off_c = off.long().clamp(0, w - 1)
    in_tail = (d.tails[rows, col, off_c] > 0) & (off >= 0) & (off < w)
    return in_prefix | in_tail


def size(d: DepSetBatch) -> torch.Tensor:
    """[B] int32 cardinality (assumes normalized rows), wrapping as the
    reference's int32 sums do."""
    _check(d)
    _plain_only("size", *d)
    return _wrap32(d.watermarks.sum(dim=-1, dtype=torch.int64)
                   + d.tails.flatten(1).sum(dim=-1, dtype=torch.int64))


def intersect(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Rowwise set intersection, the interference-closure step.

    PRECONDITION: shared ``tail_base`` (use :func:`intersect_checked`
    from host code). Ids below both watermarks stay prefix (``min`` of
    watermarks); everything else lands as tail bytes and renormalizes."""
    _check(a)
    _check(b)
    _plain_only("intersect", *a, *b)
    ids = _ids(a)[None, None, :]
    in_a = (ids < a.watermarks[:, :, None]) | (a.tails > 0)
    in_b = (ids < b.watermarks[:, :, None]) | (b.tails > 0)
    new_wm = torch.minimum(a.watermarks, b.watermarks)
    tails = (in_a & in_b & (ids >= new_wm[:, :, None])).to(torch.uint8)
    return normalized_plain(DepSetBatch(new_wm, tails, a.tail_base))


def intersect_checked(a: DepSetBatch, b: DepSetBatch) -> DepSetBatch:
    """Host-side intersection enforcing the shared-tail-base precondition."""
    if int(a.tail_base) != int(b.tail_base):
        raise ValueError(
            f"dep-set intersections need a shared tail base: "
            f"{int(a.tail_base)} != {int(b.tail_base)}")
    return intersect(a, b)


def compact(d: DepSetBatch, executed) -> DepSetBatch:
    """Prefix-compaction against the executed watermark: ``executed`` is
    ``[L]`` or ``[B, L]`` int32; raise each column's watermark to at
    least it and renormalize."""
    _check(d)
    executed = torch.as_tensor(executed, dtype=torch.int32,
                               device=d.tails.device)
    _plain_only("compact", *d, executed)
    wm = torch.maximum(d.watermarks, executed)
    return normalized_plain(DepSetBatch(wm, d.tails, d.tail_base))
