"""paxload messages.

``Rejected`` is the explicit admission-control reply: a role that
cannot admit a client request says so IMMEDIATELY instead of letting
the request age out in a queue and present as a timeout. Clients treat
the two signals differently (backoff.py): Rejected -> the leader is
alive but saturated, back off with jitter and retry the SAME leader;
timeout -> the leader may be gone, fail over (the existing resend /
leader-discovery path).

One Rejected can cover a whole coalesced ``ClientRequestArray`` -- the
entries tuple mirrors ClientReplyArray's shape (the client address
rides the wire header; per-entry addresses would be dead bytes).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Admission refused for these commands of ONE client.

    ``entries`` are (client_pseudonym, client_id) pairs;
    ``retry_after_ms`` is the server's backoff hint (0 = client
    default). ``reason`` is a small enum: 1 tokens, 2 inflight,
    3 queue, 4 codel."""

    entries: tuple  # tuple[(int, int), ...]
    retry_after_ms: int = 0
    reason: int = 0


#: Rejection reason codes (wire-stable; string names for metrics).
REASON_TOKENS = 1
REASON_INFLIGHT = 2
REASON_QUEUE = 3
REASON_CODEL = 4

REASON_NAMES = {
    0: "unspecified",
    REASON_TOKENS: "tokens",
    REASON_INFLIGHT: "inflight",
    REASON_QUEUE: "queue",
    REASON_CODEL: "codel",
}
