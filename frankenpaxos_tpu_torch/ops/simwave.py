"""Vectorized delivery-wave masks for the simulator core, and K18.

The port's copy of ``frankenpaxos_tpu/ops/simwave.py``. A delivery WAVE
is the batch of buffered frames the simulator consumes in one step:
everything currently buffered (``SimTransport`` FIFO waves) or
everything sharing the next virtual arrival time (``GeoSimTransport``).
The per-message drop decisions -- is either endpoint partitioned? is
the zone link up? -- become one mask over the wave's columns instead of
per-message set/dict probes.

  * :func:`keep_mask` and :func:`link_keep_mask` are the reference's
    numpy kernels (host-side; the default).
  * K18, the link mask on the card, replaces the reference's jitted
    twin ``link_keep_mask_jit`` / ``_link_keep_jax``:
    :func:`link_keep_mask_tensor` launches ``csrc/simwave.cu`` for CUDA
    tensors and runs :func:`link_keep_mask_plain` for CPU tensors;
    :func:`link_keep_mask_cuda` is the transport-facing form (numpy in,
    a writable numpy bool array out). ``FPX_SIMWAVE_JIT=1`` points
    :data:`LINK_KEEP_MASK` at it, as the reference's switch points at
    its jitted twin.

K18 follows JAX's gather index rules, not numpy's: an index below 0 is
wrapped once by adding the axis length, then clamped to the axis, so
``(5, 0)`` on a 3x3 matrix reads ``[2, 0]``, ``(-4, 0)`` reads
``[0, 0]`` and ``(0, 9)`` reads ``[0, 2]`` (the numpy kernel raises on
those). The topology only ever hands out ids in ``[-1, Z-1]``.

The transports only call the masks at or above ``WAVE_VECTOR_MIN``
frames; below it, per-message Python checks beat array staging.
"""

from __future__ import annotations

import os

from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops.quorum import use_kernel
import numpy as np
import torch

#: Wave size below which the transports keep per-message Python checks
#: (array staging costs more than a few dict probes on a small wave).
WAVE_VECTOR_MIN = 32

#: Zone id for unplaced addresses: their links are always up, modeled
#: as a sentinel row/column of True in the up-matrix.
UNPLACED_ZONE = -1


def keep_mask(src_ids: np.ndarray, dst_ids: np.ndarray,
              blocked_ids: np.ndarray) -> np.ndarray:
    """Partition mask: keep[i] is False when either endpoint of frame
    ``i`` is in ``blocked_ids`` (the transport's ``partitioned`` set,
    interned to address ids)."""
    if blocked_ids.size == 0:
        return np.ones(src_ids.shape, dtype=bool)
    dropped = np.isin(src_ids, blocked_ids) \
        | np.isin(dst_ids, blocked_ids)
    return ~dropped


def link_keep_mask(src_zones: np.ndarray, dst_zones: np.ndarray,
                   up: np.ndarray) -> np.ndarray:
    """Geo link mask: keep[i] = up[src_zone, dst_zone], with
    ``UNPLACED_ZONE`` (-1) endpoints always up. ``up`` is a
    ``[Z+1, Z+1]`` bool matrix whose LAST row/column (the -1 index, by
    numpy wraparound) is the all-True sentinel for unplaced
    addresses."""
    return up[src_zones, dst_zones]


# --- K18: the link mask on the card ------------------------------------------


_INT32, _BOOL = torch.int32, torch.bool


def _check_k18(src: torch.Tensor, dst: torch.Tensor,
               up: torch.Tensor) -> tuple[int, int, int]:
    """Raise unless ``src``/``dst`` are ``[n]`` int32 and ``up`` a 2-D
    bool matrix with a link to read when ``n > 0``; returns ``(n, rows,
    cols)``."""
    shape = src.shape
    if src.dtype is not _INT32 or dst.dtype is not _INT32 \
            or len(shape) != 1 or dst.shape != shape:
        raise ValueError(
            f"link_keep_mask takes two [n] int32 zone-id vectors, got "
            f"{src.dtype} {tuple(src.shape)} and {dst.dtype} "
            f"{tuple(dst.shape)}")
    try:
        if up.dtype is not _BOOL:
            raise ValueError
        rows, cols = up.shape
    except ValueError:
        raise ValueError(f"link_keep_mask takes a [Z+1, Z+1] bool "
                         f"up-matrix, got {up.dtype} {tuple(up.shape)}"
                         ) from None
    n = shape[0]
    if n and not rows * cols:
        raise ValueError("link_keep_mask: an empty up-matrix has no link "
                         "to read")
    return n, rows, cols


def _check_out(out: torch.Tensor, n: int) -> None:
    if out.dtype is not _BOOL or out.dim() != 1 or out.shape[0] < n \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous [>= {n}] bool buffer, "
                         f"got {out.dtype} {tuple(out.shape)}")


def _jax_index(ids: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather index rule: a negative id wraps once, then clamps."""
    ids = ids.to(torch.int64)
    return torch.where(ids < 0, ids + size, ids).clamp(0, size - 1)


def link_keep_mask_plain(src_zones: torch.Tensor, dst_zones: torch.Tensor,
                         up: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K18: ``up[src, dst]`` for ``[n]`` int32
    zone ids over a ``[Z+1, Z+1]`` bool matrix, with JAX's wrap-then-
    clamp index rule; ``[n]`` bool."""
    _check_k18(src_zones, dst_zones, up)
    if src_zones.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=up.device)
    return up[_jax_index(src_zones, up.shape[0]),
              _jax_index(dst_zones, up.shape[1])]


_K18 = _build.Entry("simwave", "fpx_link_keep_mask", 9)
_K18_STAGED = _build.Entry("simwave", "fpx_link_keep_mask_staged", 11,
                             keep_gil=False)


def link_keep_mask_tensor(src_zones: torch.Tensor, dst_zones: torch.Tensor,
                          up: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """K18: ``up[src, dst]`` per frame of a wave (JAX's index rules),
    ``[n]`` bool. Tensors on one CUDA device launch
    ``link_keep_mask_kernel`` on the current stream; CPU tensors run the
    plain version; anything else raises. ``out``, a contiguous ``[>= n]``
    bool buffer on the inputs' device, receives the mask: it is returned
    itself when it is ``n`` long, else its first ``n`` elements, so that
    a caller can reuse one buffer.

    The call path is lean: the device test is three ``get_device``
    reads, ``.contiguous()`` runs only on a strided input (the kernel
    takes any 1-D offset and length), and a fresh output is allocated
    exactly ``n`` long."""
    index = up.get_device()
    if index < 0 or src_zones.get_device() != index \
            or dst_zones.get_device() != index \
            or (out is not None and out.get_device() != index):
        n = _check_k18(src_zones, dst_zones, up)[0]
        tensors = (src_zones, dst_zones, up) + ((out,) if out is not None
                                                else ())
        if not use_kernel(*tensors):
            mask = link_keep_mask_plain(src_zones, dst_zones, up)
            if out is None:
                return mask
            _check_out(out, n)
            return out[:n].copy_(mask) if out.shape[0] != n \
                else out.copy_(mask)
    n, rows, cols = _check_k18(src_zones, dst_zones, up)
    fresh = out is None
    if fresh:
        out = up.new_empty(n)
    else:
        _check_out(out, n)
    if n == 0:
        return out if fresh or out.shape[0] == 0 else out[:0]
    if not src_zones.is_contiguous():
        src_zones = src_zones.contiguous()
    if not dst_zones.is_contiguous():
        dst_zones = dst_zones.contiguous()
    if not up.is_contiguous():
        up = up.contiguous()
    fn = _K18.fn or _K18.resolve()
    rc = fn(_K18.pack(src_zones.data_ptr(), dst_zones.data_ptr(), n,
                      up.data_ptr(), rows, cols, out.data_ptr(), index,
                      _build.stream_handle(index)))
    if rc:
        _K18.check(rc)
    link_keep_mask_tensor.launches += 1
    return out if fresh or out.shape[0] == n else out[:n]


link_keep_mask_tensor.launches = 0


class _Staging(_build.Staging):
    """One device's staging for the transport-facing call: the wave's ids
    (``src`` at ``[0, n)``, ``dst`` from the next multiple of 4, so both
    sit on 16 bytes and one copy moves both) and its mask, and the device
    copy of the last up-matrix with a reference to its numpy source, so
    that the source's ``id`` cannot be reused while the copy is kept."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.up_source = None
        self.up_device = None

    def up(self, up: np.ndarray) -> torch.Tensor:
        if up is not self.up_source:
            if up.dtype != np.bool_ or up.ndim != 2:
                raise ValueError(f"link_keep_mask_cuda takes a 2-D bool "
                                 f"up-matrix, got {up.dtype} {up.shape}")
            # A synchronous copy: the up-matrix is on the card before the
            # staged call's stream reads it.
            self.up_device = torch.from_numpy(
                np.ascontiguousarray(up)).to(self.device)
            self.up_source = up
        return self.up_device


#: ``{card index, or the device named: _Staging}`` (``_build.staging``).
_STAGING: dict = {}


def link_keep_mask_cuda(src_zones: np.ndarray, dst_zones: np.ndarray,
                        up: np.ndarray, device=None) -> np.ndarray:
    """K18 for the geo transport (the JAX twin ``link_keep_mask_jit``'s
    contract): numpy zone ids ``[n]`` (taken as int32, wrapped as
    ``astype`` wraps) and the topology's ``[Z+1, Z+1]`` bool up-matrix
    in, a WRITABLE numpy bool ``[n]`` out, never a view of a buffer the
    next call reuses (the transport ANDs the partition mask into it in
    place).

    ``device`` is the current card when None (and raises without a GPU:
    there is no numpy fall-back; a named device is resolved at its first
    call); ``"cpu"`` runs the plain version. The device copy of ``up``
    is kept per device and re-uploaded only when a different array
    arrives: ``GeoTopology.up_matrix`` returns one cached array until a
    partition or heal, then a new one, and never edits an array it
    handed out. A wave costs two numpy writes into reused pinned memory,
    ONE ``ctypes`` call (the ids up in one copy, the launch, the mask
    down, a wait on the staging's own stream, with the GIL released)
    and a numpy copy out."""
    staging = _build.staging(_STAGING, device, _Staging)
    if staging is None:
        src = np.asarray(src_zones).astype(np.int32, copy=False)
        dst = np.asarray(dst_zones).astype(np.int32, copy=False)
        up = np.asarray(up)
        if up.dtype != np.bool_:
            raise ValueError(f"link_keep_mask_cuda takes a bool "
                             f"up-matrix, got {up.dtype}")
        return link_keep_mask_tensor(
            torch.from_numpy(src.copy()), torch.from_numpy(dst.copy()),
            torch.from_numpy(up.copy()).to(device)).cpu().numpy()
    src = np.asarray(src_zones)
    dst = np.asarray(dst_zones)
    n = src.shape[0]
    if src.ndim != 1 or dst.shape != (n,):
        raise ValueError(f"link_keep_mask_cuda takes two [n] zone-id "
                         f"vectors, got {src.shape} and {dst.shape}")
    up_device = staging.up(up if isinstance(up, np.ndarray)
                           else np.asarray(up))
    if n == 0:
        return np.zeros(0, dtype=bool)
    rows, cols = up_device.shape
    if not rows * cols:
        raise ValueError("link_keep_mask: an empty up-matrix has no link "
                         "to read")
    offset = (n + 3) & ~3
    ids = staging.pair("ids", offset + n, torch.int32)
    mask = staging.pair("mask", n, torch.bool)
    ids.host[:n] = src  # an unsafe cast, as astype: int64 ids wrap
    ids.host[offset:offset + n] = dst
    fn = _K18_STAGED.fn or _K18_STAGED.resolve()
    rc = fn(_K18_STAGED.pack(ids.host_ptr, ids.device_ptr, n, offset,
                             up_device.data_ptr(), rows, cols,
                             mask.device_ptr, mask.host_ptr, staging.index,
                             staging.stream_handle))
    if rc:
        _K18_STAGED.check(rc)
    link_keep_mask_tensor.launches += 1
    return mask.host[:n].copy()


#: The link-mask kernel the geo transport dispatches through (looked up
#: on every wave): ``FPX_SIMWAVE_JIT=1`` swaps in K18; the numpy kernel
#: is the default, as in the reference.
LINK_KEEP_MASK = link_keep_mask

if os.environ.get("FPX_SIMWAVE_JIT") == "1":
    LINK_KEEP_MASK = link_keep_mask_cuda
