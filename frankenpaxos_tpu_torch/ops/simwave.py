"""Vectorized delivery-wave masks for the simulator core.

The port's copy of the numpy kernels of
``frankenpaxos_tpu/ops/simwave.py``. A delivery WAVE is the batch of
buffered frames ``SimTransport`` consumes in one step; its per-message
drop decision (is either endpoint partitioned?) becomes one mask over
the wave's columns of interned address ids instead of per-message set
probes. Host-side numpy: waves are tens to tens of thousands of frames
and feed straight into Python handler dispatch. The reference's jitted
link mask (``link_keep_mask_jit``) is not ported (ROADMAP.md, queue 2).
"""

from __future__ import annotations

import numpy as np

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
