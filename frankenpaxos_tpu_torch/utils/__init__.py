"""Host-side log-storage utilities (the port's copy of part of
``frankenpaxos_tpu/utils/``): BufferMap, the quorum watermarks (whose
vector form has a ``"cuda"`` backend on K12) and TopOne/TopK."""

from frankenpaxos_tpu_torch.utils.buffer_map import BufferMap
from frankenpaxos_tpu_torch.utils.topk import TopK, TopOne, VertexIdLike
from frankenpaxos_tpu_torch.utils.watermark import (
    QuorumWatermark,
    QuorumWatermarkVector,
)

__all__ = ["BufferMap", "QuorumWatermark", "QuorumWatermarkVector", "TopK",
           "TopOne", "VertexIdLike"]
