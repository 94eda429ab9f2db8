"""Watermark reductions on one GPU: K12 and K13.

Counterpart of ``frankenpaxos_tpu/ops/watermark.py``. Reference behavior:
util/QuorumWatermark.scala:42-49 (the largest watermark a quorum of
nodes has reached: sort, take element ``n - quorum_size``) and
multipaxos/Replica.scala:394-453 (the end of a contiguous chosen prefix).

  * K12 :func:`quorum_watermark` (:func:`quorum_watermark_plain`): per
    row of ``[..., n]`` int32 watermarks, element ``n - quorum_size`` of
    the row sorted ascending; :func:`quorum_watermark_vector` is its
    columnwise form over a ``[n, depth]`` host matrix, the caller of
    SimpleGcBPaxos's ``gc_backend="cuda"``;
  * K13 :func:`contiguous_prefix_length`
    (:func:`contiguous_prefix_length_plain`): ``sum(cumprod(present))``
    along the last axis, as int32.

Both kernels are in ``csrc/watermark.cu``. A wrapper launches its kernel
for CUDA tensors and runs the plain version for CPU tensors; anything
else raises, and nothing falls back.

Arithmetic follows the reference's jitted functions exactly:
``n - quorum_size`` is int32 and wraps, a negative index counts from the
end once, an index still outside ``[0, n)`` gives ``INT32_MIN`` (JAX's
fill value for int32), and ``n = 0`` gives 0; K13 converts its input as
``astype(int32)`` does (bytes other than 0/1 count as they are, int64
keeps its low 32 bits) and its products and sum wrap as int32.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops.quorum import int32, stage, use_kernel
import numpy as np
import torch

INT32_MIN = -(1 << 31)

#: K13's input types and their ``elem_kind`` code in ``watermark.cu``.
_PREFIX_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int8: 1,
                 torch.int16: 2, torch.int32: 3, torch.int64: 4}


def _rows(x: torch.Tensor, fn: str) -> tuple[int, int, int]:
    """``(rows, row stride, element stride)`` of ``x`` read as ``[rows,
    last]`` (a 1-D ``x`` is one row), never a copy."""
    if x.dim() == 0:
        raise ValueError(f"{fn} needs at least one axis")
    if x.dim() == 1:
        return 1, 0, x.stride(0)
    if x.numel() == 0:  # nothing is read
        return int(np.prod(x.shape[:-1])), 0, 1
    try:
        view = x if x.dim() == 2 else x.view(-1, x.shape[-1])
    except RuntimeError as exc:
        raise ValueError(f"{fn}: the leading axes of a "
                         f"{tuple(x.shape)} tensor with strides "
                         f"{x.stride()} do not flatten without a copy"
                         ) from exc
    return view.shape[0], view.stride(0), view.stride(1)


def _quorum_sizes(quorum_size, lead: tuple, device: torch.device):
    """``(None, scalar)`` for a scalar quorum size, else ``(per-row
    [rows] int32 tensor, 0)`` broadcast over the leading axes."""
    if isinstance(quorum_size, torch.Tensor):
        if quorum_size.dtype != torch.int32:
            raise ValueError(f"quorum_size is {quorum_size.dtype}, "
                             f"expected int32")
        if quorum_size.dim() == 0:
            return None, int(quorum_size)
        if quorum_size.device != device:
            raise ValueError(f"quorum_size on {quorum_size.device}, "
                             f"watermarks on {device}")
        per_row = torch.broadcast_to(quorum_size, lead).reshape(-1)
        return per_row.contiguous(), 0
    return None, int32(int(quorum_size))


def _check_watermarks(watermarks: torch.Tensor) -> None:
    if watermarks.dtype != torch.int32 or watermarks.dim() == 0:
        raise ValueError(
            f"quorum_watermark takes [..., n] int32 watermarks, got "
            f"{watermarks.dtype} {tuple(watermarks.shape)}")


def quorum_watermark_plain(watermarks: torch.Tensor, quorum_size
                           ) -> torch.Tensor:
    """Plain PyTorch version of K12: ``torch.sort`` along the last axis,
    then a gather at ``n - quorum_size`` with JAX's index rules."""
    _check_watermarks(watermarks)
    lead, n = tuple(watermarks.shape[:-1]), watermarks.shape[-1]
    per_row, scalar = _quorum_sizes(quorum_size, lead, watermarks.device)
    dev = watermarks.device
    q = (per_row.view(lead) if per_row is not None
         else torch.full(lead, scalar, dtype=torch.int32, device=dev))
    if n == 0:
        return torch.zeros(lead, dtype=torch.int32, device=dev)
    # int32 arithmetic, as the reference's: n - q wraps.
    idx = (n - q.to(torch.int64) + (1 << 31)) % (1 << 32) - (1 << 31)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    ordered = torch.sort(watermarks, dim=-1).values
    picked = torch.gather(ordered, -1,
                          torch.where(inside, idx, 0).unsqueeze(-1))[..., 0]
    return torch.where(inside, picked,
                       torch.tensor(INT32_MIN, dtype=torch.int32, device=dev))


def quorum_watermark(watermarks: torch.Tensor, quorum_size) -> torch.Tensor:
    """K12: per row of ``[..., n]`` int32 ``watermarks``, the largest w
    that at least ``quorum_size`` of the row reach (element ``n -
    quorum_size`` of the row sorted ascending); ``[...]`` int32.
    ``quorum_size`` is an int or an int32 tensor that broadcasts over the
    leading axes. The row may be strided (the vector form passes a
    transposed view)."""
    _check_watermarks(watermarks)
    if not use_kernel(watermarks):
        return quorum_watermark_plain(watermarks, quorum_size)
    lead, n = tuple(watermarks.shape[:-1]), watermarks.shape[-1]
    per_row, scalar = _quorum_sizes(quorum_size, lead, watermarks.device)
    rows, row_stride, elem_stride = _rows(watermarks, "quorum_watermark")
    out = torch.empty(lead, dtype=torch.int32, device=watermarks.device)
    if rows == 0:
        return out
    lib = _build.library("watermark")
    rc = lib.fpx_quorum_watermark(
        watermarks.data_ptr(), rows, n, row_stride, elem_stride,
        None if per_row is None else per_row.data_ptr(), scalar,
        out.data_ptr(), *_build.stream_args(watermarks.device))
    _build.check("watermark", "fpx_quorum_watermark", rc)
    quorum_watermark.launches += 1
    return out


quorum_watermark.launches = 0


def quorum_watermark_vector(watermarks: np.ndarray, quorum_size: int,
                            device=None) -> np.ndarray:
    """Columnwise quorum watermark of a ``[n, depth]`` host matrix
    (QuorumWatermarkVector.scala:20+): one K12 launch on ``device``
    (``cuda`` when None; ``"cpu"`` runs the plain version) over the
    matrix's columns, read in place through a transposed view. The
    matrix crosses as int32, wrapped as the reference's ``jnp.asarray``
    wraps int64; returns ``[depth]`` int32."""
    device = resolve_device(device)
    matrix = np.asarray(watermarks)
    if matrix.ndim != 2:
        raise ValueError(f"quorum_watermark_vector takes a [n, depth] "
                         f"matrix, got shape {matrix.shape}")
    on_device = stage(matrix.astype(np.int32), device)
    return quorum_watermark(on_device.t(), int32(quorum_size)).cpu().numpy()


def _check_present(present: torch.Tensor) -> None:
    if present.dtype not in _PREFIX_KINDS or present.dim() == 0:
        raise ValueError(
            f"contiguous_prefix_length takes a [..., L] bool or integer "
            f"tensor, got {present.dtype} {tuple(present.shape)}")


def contiguous_prefix_length_plain(present: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K13: ``torch.cumprod`` in int32 (it wraps),
    then an int32 sum."""
    _check_present(present)
    # As astype(int32): sign- or zero-extends, and int64 keeps its low
    # 32 bits.
    products = torch.cumprod(present.to(torch.int32), dim=-1,
                             dtype=torch.int32)
    return products.sum(dim=-1, dtype=torch.int32)


def contiguous_prefix_length(present: torch.Tensor) -> torch.Tensor:
    """K13: the length of the all-true prefix along the last axis of a
    ``[..., L]`` bool tensor, i.e. ``sum(cumprod(present))`` as int32
    (integer inputs count their products, as the reference's do);
    ``[...]`` int32."""
    _check_present(present)
    if not use_kernel(present):
        return contiguous_prefix_length_plain(present)
    lead, length = tuple(present.shape[:-1]), present.shape[-1]
    rows, row_stride, elem_stride = _rows(present,
                                          "contiguous_prefix_length")
    out = torch.empty(lead, dtype=torch.int32, device=present.device)
    if rows == 0:
        return out
    lib = _build.library("watermark")
    rc = lib.fpx_contiguous_prefix_length(
        present.data_ptr(), _PREFIX_KINDS[present.dtype], rows, length,
        row_stride, elem_stride, out.data_ptr(),
        *_build.stream_args(present.device))
    _build.check("watermark", "fpx_contiguous_prefix_length", rc)
    contiguous_prefix_length.launches += 1
    return out


contiguous_prefix_length.launches = 0
