"""The serving tier, the port's copy of ``frankenpaxos_tpu/serve/``:
the ``Rejected`` reply (``messages``) and its codec (``wire``, tag 132 on
the extended page), the frame-layer priority lanes (``lanes``), the
server-side admission control (``admission``: a token bucket, an
in-flight slot budget tied to the leader's chosen watermark, CoDel-style
drain-delay shedding, bounded client-lane inboxes) and the client-side
retry discipline (``backoff``). The reference's vectorized load tier
(``serve/loadgen.py``) is not ported yet (ROADMAP.md queue 1 item
8.6)."""

# Codec registration (tag 132 on the extended page) is an import side
# effect, like every other wire module.
from frankenpaxos_tpu_torch.serve import wire  # noqa: F401
from frankenpaxos_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionOptions,
    reject_replies_for,
)
from frankenpaxos_tpu_torch.serve.backoff import Backoff, RETRY_EXHAUSTED
from frankenpaxos_tpu_torch.serve.lanes import (
    frame_lane,
    LANE_CLIENT,
    LANE_CONTROL,
)
from frankenpaxos_tpu_torch.serve.messages import Rejected

__all__ = [
    "AdmissionController",
    "AdmissionOptions",
    "Backoff",
    "LANE_CLIENT",
    "LANE_CONTROL",
    "RETRY_EXHAUSTED",
    "Rejected",
    "frame_lane",
    "reject_replies_for",
]
