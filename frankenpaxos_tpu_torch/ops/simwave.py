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

from frankenpaxos_tpu_torch.device import resolve_device
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


def _check_k18(src: torch.Tensor, dst: torch.Tensor,
               up: torch.Tensor) -> None:
    if src.dtype != torch.int32 or dst.dtype != torch.int32 \
            or src.dim() != 1 or src.shape != dst.shape:
        raise ValueError(
            f"link_keep_mask takes two [n] int32 zone-id vectors, got "
            f"{src.dtype} {tuple(src.shape)} and {dst.dtype} "
            f"{tuple(dst.shape)}")
    if up.dtype != torch.bool or up.dim() != 2:
        raise ValueError(f"link_keep_mask takes a [Z+1, Z+1] bool "
                         f"up-matrix, got {up.dtype} {tuple(up.shape)}")
    if src.shape[0] and (up.shape[0] == 0 or up.shape[1] == 0):
        raise ValueError("link_keep_mask: an empty up-matrix has no link "
                         "to read")


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


def link_keep_mask_tensor(src_zones: torch.Tensor, dst_zones: torch.Tensor,
                          up: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """K18: ``up[src, dst]`` per frame of a wave (JAX's index rules),
    ``[n]`` bool. CUDA tensors launch ``link_keep_mask_kernel``; CPU
    tensors run the plain version; anything else raises. ``out``, a
    CUDA ``[>= n]`` bool buffer, receives the mask (its first ``n``
    elements are returned) so a caller can reuse one buffer."""
    _check_k18(src_zones, dst_zones, up)
    tensors = (src_zones, dst_zones, up) + ((out,) if out is not None
                                            else ())
    if not use_kernel(*tensors):
        return link_keep_mask_plain(src_zones, dst_zones, up)
    n = src_zones.shape[0]
    if out is None:
        out = torch.empty(n, dtype=torch.bool, device=up.device)
    elif out.dtype != torch.bool or out.dim() != 1 or out.shape[0] < n:
        raise ValueError(f"out must be a [>= {n}] bool buffer, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if n == 0:
        return out[:0]
    src_zones, dst_zones = src_zones.contiguous(), dst_zones.contiguous()
    up = up.contiguous()
    lib = _build.library("simwave")
    rc = lib.fpx_link_keep_mask(
        src_zones.data_ptr(), dst_zones.data_ptr(), n, up.data_ptr(),
        up.shape[0], up.shape[1], out.data_ptr(),
        *_build.stream_args(up.device))
    _build.check("simwave", "fpx_link_keep_mask", rc)
    link_keep_mask_tensor.launches += 1
    return out[:n]


link_keep_mask_tensor.launches = 0


class _Staging:
    """One device's staging for the transport-facing call: a pinned host
    buffer and a device buffer for the wave's ``[2, cap]`` zone ids, a
    device and a pinned host buffer for the ``[cap]`` mask (``cap`` a
    power of two, grown on demand), and the device copy of the last
    up-matrix with a reference to its numpy source, so that the source's
    ``id`` cannot be reused while the copy is kept."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cap = 0
        self.up_source = None
        self.up_device = None

    def grow(self, n: int) -> None:
        if n <= self.cap:
            return
        cap = 1 << max(5, (n - 1).bit_length())
        self.ids_host = torch.empty((2, cap), dtype=torch.int32,
                                    pin_memory=True)
        self.ids_device = torch.empty((2, cap), dtype=torch.int32,
                                      device=self.device)
        self.mask_device = torch.empty(cap, dtype=torch.bool,
                                       device=self.device)
        self.mask_host = torch.empty(cap, dtype=torch.bool,
                                     pin_memory=True)
        self.cap = cap

    def up(self, up: np.ndarray) -> torch.Tensor:
        if up is not self.up_source:
            self.up_device = torch.from_numpy(
                np.ascontiguousarray(up)).to(self.device)
            self.up_source = up
        return self.up_device


_STAGING: dict = {}


def link_keep_mask_cuda(src_zones: np.ndarray, dst_zones: np.ndarray,
                        up: np.ndarray, device=None) -> np.ndarray:
    """K18 for the geo transport (the JAX twin ``link_keep_mask_jit``'s
    contract): numpy zone ids ``[n]`` (taken as int32) and the
    topology's ``[Z+1, Z+1]`` bool up-matrix in, a WRITABLE numpy bool
    ``[n]`` out, never a view of a buffer the next call reuses (the
    transport ANDs the partition mask into it in place).

    ``device`` is ``cuda`` when None (and raises without a GPU: there is
    no numpy fall-back); ``"cpu"`` runs the plain version. The device
    copy of ``up`` is kept per device and re-uploaded only when a
    different array arrives: ``GeoTopology.up_matrix`` returns one
    cached array until a partition or heal, then a new one, and never
    edits an array it handed out. The ids cross through reused
    power-of-two pinned buffers with one upload, and the mask comes back
    with one download and a synchronise."""
    device = resolve_device(device)
    src = np.asarray(src_zones).astype(np.int32, copy=False)
    dst = np.asarray(dst_zones).astype(np.int32, copy=False)
    up = np.asarray(up)
    if up.dtype != np.bool_:
        raise ValueError(f"link_keep_mask_cuda takes a bool up-matrix, "
                         f"got {up.dtype}")
    n = src.shape[0]
    if device.type != "cuda":
        return link_keep_mask_tensor(
            torch.from_numpy(src.copy()), torch.from_numpy(dst.copy()),
            torch.from_numpy(up.copy()).to(device)).cpu().numpy()
    staging = _STAGING.get(device)
    if staging is None:
        staging = _STAGING[device] = _Staging(device)
    staging.grow(n)
    ids = staging.ids_host.numpy()
    ids[0, :n] = src
    ids[1, :n] = dst
    # The copy is ordered on the stream before the launch, and the call
    # synchronises on its result, so the pinned buffer is free again
    # when the next call overwrites it.
    staging.ids_device[:, :n].copy_(staging.ids_host[:, :n],
                                    non_blocking=True)
    mask = link_keep_mask_tensor(staging.ids_device[0, :n],
                                 staging.ids_device[1, :n],
                                 staging.up(up), out=staging.mask_device)
    staging.mask_host[:n].copy_(mask, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return staging.mask_host[:n].numpy().copy()


#: The link-mask kernel the geo transport dispatches through (looked up
#: on every wave): ``FPX_SIMWAVE_JIT=1`` swaps in K18; the numpy kernel
#: is the default, as in the reference.
LINK_KEEP_MASK = link_keep_mask

if os.environ.get("FPX_SIMWAVE_JIT") == "1":
    LINK_KEEP_MASK = link_keep_mask_cuda
