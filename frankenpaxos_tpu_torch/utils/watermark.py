"""Quorum watermarks: "largest k such that >= quorum_size watermarks >= k".

The port's copy of ``frankenpaxos_tpu/utils/watermark.py``. Reference
behavior: util/QuorumWatermark.scala:31-50 and
util/QuorumWatermarkVector.scala:20+. Watermarks only increase. Sorted
descending, the answer is the quorum_size'th entry -- itself a batched
reduction, so the vector form has a device twin: K12 in
``ops/watermark.py``, selected by ``backend="cuda"`` where the reference
says ``"tpu"``.
"""

from __future__ import annotations

from typing import Sequence

from frankenpaxos_tpu_torch.ops.watermark import quorum_watermark_vector
import numpy as np

BACKENDS = ("host", "cuda")


class QuorumWatermark:
    """n monotonically-increasing integer watermarks with quorum queries."""

    def __init__(self, num_watermarks: int):
        self._watermarks = np.zeros(num_watermarks, dtype=np.int64)

    def __repr__(self):
        return f"QuorumWatermark({self._watermarks.tolist()})"

    @property
    def num_watermarks(self) -> int:
        return self._watermarks.shape[0]

    def update(self, index: int, watermark: int) -> None:
        self._watermarks[index] = max(self._watermarks[index], watermark)

    def watermark(self, quorum_size: int) -> int:
        if not 1 <= quorum_size <= self.num_watermarks:
            raise ValueError(
                f"quorum_size {quorum_size} out of [1, {self.num_watermarks}]")
        return int(np.sort(self._watermarks)[self.num_watermarks - quorum_size])


def check_backend(backend: str, what: str = "backend") -> None:
    """Refuse a backend other than ``"host"`` or ``"cuda"`` (the
    reference's ``"tpu"`` included)."""
    if backend not in BACKENDS:
        raise ValueError(f"{what} must be 'host' or 'cuda', got {backend!r}")


class QuorumWatermarkVector:
    """n vector-valued watermarks; every depth column is an independent
    QuorumWatermark (QuorumWatermarkVector.scala:20+)."""

    def __init__(self, n: int, depth: int):
        self._watermarks = np.zeros((n, depth), dtype=np.int64)

    def __repr__(self):
        return f"QuorumWatermarkVector({self._watermarks.tolist()})"

    def update(self, index: int, watermark: Sequence[int]) -> None:
        w = np.asarray(watermark, dtype=np.int64)
        self._watermarks[index, :w.shape[0]] = np.maximum(
            self._watermarks[index, :w.shape[0]], w)

    def watermark(self, quorum_size: int, backend: str = "host",
                  device=None) -> list[int]:
        """``backend="cuda"`` evaluates the reduction by K12 on
        ``device`` (``cuda`` when None; ``"cpu"`` runs its plain
        version), with the reference device path's int32 results;
        ``"host"`` is the numpy oracle."""
        check_backend(backend)
        n = self._watermarks.shape[0]
        if not 1 <= quorum_size <= n:
            raise ValueError(f"quorum_size {quorum_size} out of [1, {n}]")
        if backend == "cuda":
            return quorum_watermark_vector(
                self._watermarks, quorum_size, device=device).tolist()
        return np.sort(self._watermarks, axis=0)[n - quorum_size].tolist()
