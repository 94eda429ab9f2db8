"""Frame-layer priority lanes (paxload).

Shedding decisions must be CHEAP (they run on every frame when a
bounded inbox is attached) and must NEVER touch the control plane --
Phase1/epoch/heartbeat/vote traffic starving behind client writes is
how an overloaded cluster loses its leader and turns congestion into
an outage. So lane classification reads exactly one or two bytes: the
frame's leading wire tag (runtime/serializer.py -- primary page tags
1..127 as the first byte, extended page 0x00 + tag byte, pickle
streams lead with 0x80+).

The CLIENT lane is the closed set of client-REQUEST message types
below, resolved to tags through the codec registry at first use.
Everything else -- votes, phase messages, epoch commits, heartbeats,
replies, and every pickled long-tail message -- is CONTROL and is
never shed (conservative by construction: an unclassifiable frame is
control).
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.runtime import serializer

LANE_CONTROL = 0
LANE_CLIENT = 1

#: Client-request message TYPE names (the shedable lane). Names, not
#: tags: the mapping survives tag reshuffles and covers every protocol
#: that registers a codec for one of these shapes (multipaxos and
#: mencius share ClientRequest/ClientRequestArray/ClientRequestBatch).
CLIENT_LANE_TYPE_NAMES = frozenset({
    "ClientRequest",
    "ClientRequestArray",
    "ClientRequestBatch",
    "MaxSlotRequest",
    "BatchMaxSlotRequest",
    "ReadRequest",
    "ReadRequestBatch",
    "SequentialReadRequest",
    "SequentialReadRequestBatch",
    "EventualReadRequest",
    "EventualReadRequestBatch",
    # Client-edge request shapes surfaced by paxflow FLOW405: every
    # protocol's client-originated traffic must be shedable, not just
    # multipaxos/mencius's. Leader-discovery requests are client-edge
    # too -- the post-failover LeaderInfo thundering herd is exactly
    # what admission should bound (replies from leaders stay control).
    "EchoRequest",
    "ProposeRequest",
    "LeaderInfoRequestClient",
    "LeaderInfoRequestBatcher",
    # paxgeo: the WPaxos client write (protocols/wpaxos). Steal-mode
    # resends ride the same type -- shedding them under overload is
    # correct (the client keeps its failover budget); the steal
    # CONTROL flow (WPhase1a/WEpochCommit) is leader-originated and
    # stays control lane.
    "WRequest",
    # paxwire: a batch frame of client requests must shed like the
    # requests themselves -- the transport's flush planner wraps runs
    # of client-lane payloads in this envelope (runtime/paxwire.py),
    # and both the tag-level and type-level classifiers need to see it.
    "ClientFrameBatch",
    # paxingest: a disseminator's pre-batched run descriptor is
    # aggregated CLIENT load -- an overloaded leader must be able to
    # shed it (one frame, whole run) exactly like the requests it
    # carries; the batcher's own Rejected replies keep clients backing
    # off. NotLeaderIngest (leader -> batcher bounce) stays control.
    "IngestRun",
})

#: Client-lane membership by EXPLICIT wire tag, for client-edge
#: shapes whose names are too generic to claim globally (paxworld:
#: CRAQ's bare Write/201 and Read/202 -- adding "Write"/"Read" to the
#: name set would silently make ANY future protocol's same-named
#: replication message sheddable). The chain's own hops (WriteBatch,
#: Ack, TailRead) stay control lane: a shed mid-chain hop would wedge
#: the chain, and it is not client-originated load anyway.
CLIENT_LANE_EXTRA_TAGS = frozenset({201, 202})

_cache: tuple[int, frozenset, frozenset] | None = None


def _lane_cache() -> tuple:
    """(registered client-lane tags, extra-tag message TYPES) --
    cached against the registry size (codecs register at protocol
    import and never unregister). Both classifiers read this one
    cache so the frame-level and message-level verdicts can never
    disagree."""
    global _cache
    registry = serializer._CODECS_BY_TAG
    if _cache is None or _cache[0] != len(registry):
        tags = frozenset(
            tag for tag, codec in registry.items()
            if codec.message_type.__name__ in CLIENT_LANE_TYPE_NAMES) \
            | (CLIENT_LANE_EXTRA_TAGS & frozenset(registry))
        extra_types = frozenset(
            registry[tag].message_type
            for tag in CLIENT_LANE_EXTRA_TAGS if tag in registry)
        _cache = (len(registry), tags, extra_types)
    return _cache


def client_lane_tags() -> frozenset:
    """Wire tags currently registered for client-lane types (names
    plus the explicit-tag members)."""
    return _lane_cache()[1]


def frame_lane(data: bytes) -> int:
    """The lane of an ENCODED frame payload, from its leading tag
    byte(s). Pickle frames (0x80+) and unknown tags are CONTROL."""
    if not data:
        return LANE_CONTROL
    tag = data[0]
    if tag == 0:  # extended page escape
        if len(data) < 2:
            return LANE_CONTROL
        tag = 128 + data[1]
    elif tag >= 128:  # pickle stream
        return LANE_CONTROL
    return LANE_CLIENT if tag in client_lane_tags() else LANE_CONTROL


def message_lane(message) -> int:
    """The lane of a DECODED message (role-level admission sites);
    agrees with :func:`frame_lane` by construction (one cache)."""
    if type(message).__name__ in CLIENT_LANE_TYPE_NAMES:
        return LANE_CLIENT
    return (LANE_CLIENT if type(message) in _lane_cache()[2]
            else LANE_CONTROL)
