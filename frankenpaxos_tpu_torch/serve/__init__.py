"""The serving tier's ported pieces, copied from ``frankenpaxos_tpu/serve/``:
the client-side retry discipline (``backoff``), the ``Rejected`` reply
(``messages``) and its codec (``wire``, tag 132 on the extended page),
and the frame-layer priority lanes (``lanes``). Admission control itself
is not ported yet (ROADMAP.md queue 1 item 8.1)."""

# Codec registration (tag 132 on the extended page) is an import side
# effect, like every other wire module.
from frankenpaxos_tpu_torch.serve import wire  # noqa: F401
from frankenpaxos_tpu_torch.serve.backoff import Backoff, RETRY_EXHAUSTED
from frankenpaxos_tpu_torch.serve.lanes import (
    frame_lane,
    LANE_CLIENT,
    LANE_CONTROL,
)
from frankenpaxos_tpu_torch.serve.messages import Rejected

__all__ = [
    "Backoff",
    "LANE_CLIENT",
    "LANE_CONTROL",
    "RETRY_EXHAUSTED",
    "Rejected",
    "frame_lane",
]
