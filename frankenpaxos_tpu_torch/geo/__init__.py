"""Wide-area simulation and per-object multi-leader machinery (the
port's copy of ``frankenpaxos_tpu/geo/``).

Two halves:

  * a SIMULATION substrate -- :class:`GeoTopology` (named zones grouped
    into regions, a per-link latency/jitter matrix sampled
    deterministically per seed, link-level partition/degrade controls)
    and :class:`GeoSimTransport` (a ``SimTransport`` whose deliveries
    are ordered by VIRTUAL ARRIVAL TIME, with a virtual-clock event
    loop; its link mask runs K18 on the card under
    ``FPX_SIMWAVE_JIT=1``); and

  * PROTOCOL machinery for WPaxos-style per-object leadership --
    :class:`ObjectEpochStore` (one epoch chain per object group; an
    object steal is an epoch change), :class:`GeoQuorumTracker` (dict
    oracle / ``EpochSegmentedChecker`` vote counting over per-epoch
    ``ZoneGrid`` planes, K6 and K5 on the card), and
    :class:`RttEstimator` (the EWMA + deviation timeout bound clients
    derive their resend timers from).
"""

from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch, ObjectEpochStore
from frankenpaxos_tpu_torch.geo.quorum import GeoQuorumTracker
from frankenpaxos_tpu_torch.geo.rtt import RttEstimator
from frankenpaxos_tpu_torch.geo.topology import GeoTopology, Link
from frankenpaxos_tpu_torch.geo.transport import GeoSimTimer, GeoSimTransport

__all__ = [
    "GeoEpoch",
    "GeoQuorumTracker",
    "GeoSimTimer",
    "GeoSimTransport",
    "GeoTopology",
    "Link",
    "ObjectEpochStore",
    "RttEstimator",
]
