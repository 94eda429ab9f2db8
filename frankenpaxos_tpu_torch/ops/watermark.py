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


_K12 = _build.Entry("watermark", "fpx_quorum_watermark", 10)
_K12_STAGED = _build.Entry("watermark", "fpx_quorum_watermark_staged", 9,
                             keep_gil=False)


def _check_out(out: torch.Tensor, lead: tuple) -> None:
    if out.dtype is not torch.int32 or tuple(out.shape) != lead \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {list(lead)} int32 "
                         f"tensor, got {out.dtype} {tuple(out.shape)}")


def quorum_watermark(watermarks: torch.Tensor, quorum_size,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """K12: per row of ``[..., n]`` int32 ``watermarks``, the largest w
    that at least ``quorum_size`` of the row reach (element ``n -
    quorum_size`` of the row sorted ascending); ``[...]`` int32.
    ``quorum_size`` is an int or an int32 tensor that broadcasts over the
    leading axes. The row may be strided (the vector form passes a
    transposed view). ``out``, a contiguous ``[...]`` int32 tensor on the
    watermarks' device, receives the result and is returned.

    The call path is lean: a 2-D input (the GC roles') is read by its
    shape and strides, never viewed, and an int quorum size is range-
    checked in place."""
    index = watermarks.get_device()
    if index < 0 or (out is not None and out.get_device() != index):
        _check_watermarks(watermarks)
        if not use_kernel(watermarks, *(() if out is None else (out,))):
            got = quorum_watermark_plain(watermarks, quorum_size)
            if out is None:
                return got
            _check_out(out, tuple(watermarks.shape[:-1]))
            return out.copy_(got)
    if watermarks.dtype is not torch.int32 or watermarks.dim() != 2:
        _check_watermarks(watermarks)
        lead, n = tuple(watermarks.shape[:-1]), watermarks.shape[-1]
        rows, row_stride, elem_stride = _rows(watermarks,
                                              "quorum_watermark")
    else:
        rows, n = watermarks.shape
        row_stride, elem_stride = watermarks.stride()
        lead = (rows,)
    if type(quorum_size) is int and -(1 << 31) <= quorum_size < (1 << 31):
        per_row, scalar = None, quorum_size
    else:
        per_row, scalar = _quorum_sizes(quorum_size, lead,
                                        watermarks.device)
    if out is None:
        out = watermarks.new_empty(lead)
    else:
        _check_out(out, lead)
    if rows == 0:
        return out
    q_ptr = 0 if per_row is None else per_row.data_ptr()
    fn = _K12.fn or _K12.resolve()
    rc = fn(_K12.pack(watermarks.data_ptr(), rows, n, row_stride,
                      elem_stride, q_ptr, scalar, out.data_ptr(), index,
                      _build.stream_handle(index)))
    if rc:
        _K12.check(rc)
    quorum_watermark.launches += 1
    return out


quorum_watermark.launches = 0


#: ``{card index, or the device named: _build.Staging}``
#: (``_build.staging``).
_STAGING: dict = {}


def quorum_watermark_vector(watermarks: np.ndarray, quorum_size: int,
                            device=None) -> np.ndarray:
    """Columnwise quorum watermark of a ``[n, depth]`` host matrix
    (QuorumWatermarkVector.scala:20+): one K12 launch on ``device`` (the
    current card when None, and a named device resolved at its first
    call; ``"cpu"`` runs the plain version) over the matrix's columns,
    read in place. The matrix crosses as int32, wrapped as the
    reference's ``jnp.asarray`` wraps int64; returns a fresh ``[depth]``
    int32 array. On the card a call costs one numpy write into reused
    pinned memory, ONE ``ctypes`` call (the matrix up, the launch, the
    result down, a wait on the staging's own stream, with the GIL
    released) and a numpy copy out."""
    matrix = np.asarray(watermarks)
    if matrix.ndim != 2:
        raise ValueError(f"quorum_watermark_vector takes a [n, depth] "
                         f"matrix, got shape {matrix.shape}")
    q = int32(quorum_size)
    staging = _build.staging(_STAGING, device)
    if staging is None:
        on_device = stage(matrix.astype(np.int32), resolve_device(device))
        return quorum_watermark(on_device.t(), q).cpu().numpy()
    n, depth = matrix.shape
    if depth == 0:
        return np.zeros(0, dtype=np.int32)
    cells = staging.pair("watermarks", n * depth, torch.int32)
    out = staging.pair("out", depth, torch.int32)
    # An unsafe cast, as astype: int64 watermarks wrap to int32.
    cells.host[:n * depth].reshape(n, depth)[...] = matrix
    fn = _K12_STAGED.fn or _K12_STAGED.resolve()
    rc = fn(_K12_STAGED.pack(cells.host_ptr, cells.device_ptr, n, depth, q,
                             out.device_ptr, out.host_ptr, staging.index,
                             staging.stream_handle))
    if rc:
        _K12_STAGED.check(rc)
    quorum_watermark.launches += 1
    return out.host[:depth].copy()


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


#: K13's packed entry (9 int64: present, element kind, rows, length,
#: row stride, element stride, out, device, stream) and its form query.
_K13 = _build.Entry("watermark", "fpx_contiguous_prefix_length", 9)
_K13_FORM = _build.Entry("watermark", "fpx_contiguous_prefix_form", 9)
#: K13's forms (``csrc/watermark.cu::PrefixForm``, in code order) and
#: the row lengths up to which the thread and warp forms run.
PREFIX_FORMS = ("thread", "warp", "cta_scalar", "cta_vector")
PREFIX_THREAD_MAX, PREFIX_WARP_MAX = 16, 512


def _prefix_rows(present: torch.Tensor) -> tuple:
    """``(lead, rows, length, row stride, element stride)`` of K13's
    input read as ``[rows, length]``; a 1-D or 2-D input by its shape
    and strides alone."""
    dim = present.dim()
    if dim == 1:
        return (), 1, present.shape[0], 0, present.stride(0)
    if dim == 2:
        rows, length = present.shape
        return (rows,), rows, length, *present.stride()
    _check_present(present)
    rows, row_stride, elem_stride = _rows(present,
                                          "contiguous_prefix_length")
    return (tuple(present.shape[:-1]), rows, present.shape[-1], row_stride,
            elem_stride)


def prefix_form(present: torch.Tensor) -> str:
    """The form K13 runs for ``present`` (``csrc/watermark.cu::
    prefix_form`` chooses it from the row length and the element stride;
    this is its rule in Python): ``"thread"`` (a thread a row, L <= 16),
    ``"warp"`` (a warp a row, L <= 512), else a CTA a row with 16-byte
    loads (``"cta_vector"``: element stride 1, any alignment) or scalar
    loads (``"cta_scalar"``: strided rows)."""
    _check_present(present)
    _, _, length, _, elem_stride = _prefix_rows(present)
    if length <= PREFIX_THREAD_MAX:
        return "thread"
    if length <= PREFIX_WARP_MAX:
        return "warp"
    return "cta_vector" if elem_stride == 1 else "cta_scalar"


def prefix_form_launched(present: torch.Tensor) -> str:
    """The form K13's C entry would launch for ``present`` on its card
    (``fpx_contiguous_prefix_form``, which launches nothing), to hold
    :func:`prefix_form` against."""
    _check_present(present)
    _, rows, length, row_stride, elem_stride = _prefix_rows(present)
    index = present.get_device()
    fn = _K13_FORM.fn or _K13_FORM.resolve()
    code = fn(_K13_FORM.pack(present.data_ptr(),
                             _PREFIX_KINDS[present.dtype], rows, length,
                             row_stride, elem_stride, 0, index,
                             _build.stream_handle(index)))
    if not 0 <= code < len(PREFIX_FORMS):
        raise ValueError(f"fpx_contiguous_prefix_form returned {code}")
    return PREFIX_FORMS[code]


def contiguous_prefix_length(present: torch.Tensor,
                             out: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """K13: the length of the all-true prefix along the last axis of a
    ``[..., L]`` bool tensor, i.e. ``sum(cumprod(present))`` as int32
    (integer inputs count their products, as the reference's do);
    ``[...]`` int32. ``out``, a contiguous ``[...]`` int32 tensor on the
    input's device, receives the result and is returned.

    On a card the call path is lean (one packed ``ctypes`` call, the
    element kind from one dict lookup, the form chosen in C:
    :func:`prefix_form`); CPU tensors take
    :func:`contiguous_prefix_length_plain`."""
    index = present.get_device()
    if index < 0 or (out is not None and out.get_device() != index):
        _check_present(present)
        if not use_kernel(present, *(() if out is None else (out,))):
            got = contiguous_prefix_length_plain(present)
            if out is None:
                return got
            _check_out(out, tuple(present.shape[:-1]))
            return out.copy_(got)
    kind = _PREFIX_KINDS.get(present.dtype)
    if kind is None:
        _check_present(present)
    lead, rows, length, row_stride, elem_stride = _prefix_rows(present)
    if out is None:
        out = present.new_empty(lead, dtype=torch.int32)
    else:
        _check_out(out, lead)
    if rows == 0:
        return out
    fn = _K13.fn or _K13.resolve()
    rc = fn(_K13.pack(present.data_ptr(), kind, rows, length, row_stride,
                      elem_stride, out.data_ptr(), index,
                      _build.stream_handle(index)))
    if rc:
        _K13.check(rc)
    contiguous_prefix_length.launches += 1
    return out


contiguous_prefix_length.launches = 0
