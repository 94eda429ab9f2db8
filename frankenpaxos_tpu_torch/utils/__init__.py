"""Host-side log-storage utilities (the port's copy of part of
``frankenpaxos_tpu/utils/``; the quorum watermarks of
``utils/watermark.py`` belong to the BPaxos slice)."""

from frankenpaxos_tpu_torch.utils.buffer_map import BufferMap
from frankenpaxos_tpu_torch.utils.topk import TopK, TopOne, VertexIdLike

__all__ = ["BufferMap", "TopK", "TopOne", "VertexIdLike"]
