"""WPaxos messages (the port's copy of
``frankenpaxos_tpu/protocols/wpaxos/messages.py``).

The command space is partitioned by OBJECT into ``num_groups`` object
groups; each group has its own log (slot space), its own leadership
epoch chain (``geo.ObjectEpochStore``), and a home zone whose leader
commits through that zone's ``ZoneGrid`` row -- so steady-state
commits never cross a zone boundary. An object STEAL is an epoch
change driven by a cross-zone Phase1 (WPhase1a/WPhase1b), committed at
a row-majority of WAL-durable old-home promises, and activated with a
watermark-bounded handover (``GeoEpoch.start_slot``).

Ballot space is partitioned by ZONE: zone ``z``'s leader owns ballots
``b`` with ``b % num_zones == z``, so competing stealers can never
collide on a ballot. ``Command``/``CommandId``/value shapes are shared
with multipaxos (one value codec family serves both).

Every message here has a fixed-layout codec (``wire.py``, extended tags
160-172), the reference's bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (  # noqa: F401
    Command,
    CommandBatch,
    CommandBatchOrNoop,
    CommandId,
    NOOP,
    Noop,
)


@dataclasses.dataclass(frozen=True)
class WRequest:
    """Client write for one object group. ``steal`` marks a failover
    resend: the receiving leader should STEAL the group (cross-zone
    Phase1) instead of redirecting, because the client has given up on
    the home zone answering. ``origin_zone`` is the issuing client's
    zone (-1 = unknown): the feed for the leader's adaptive-placement
    EWMA (paxchaos) -- a routing HINT only, never consulted for
    safety."""

    group: int
    command: Command
    steal: bool = False
    origin_zone: int = -1


@dataclasses.dataclass(frozen=True)
class WReply:
    command_id: CommandId
    group: int
    slot: int
    result: bytes


@dataclasses.dataclass(frozen=True)
class WNotOwner:
    """Routing redirect: the receiver does not own ``group``; retry at
    ``home_zone``'s leader (hint as of ``ballot`` -- clients keep the
    highest-ballot hint)."""

    group: int
    command_id: CommandId
    home_zone: int
    ballot: int


@dataclasses.dataclass(frozen=True)
class Steal:
    """Admin/chaos/placement trigger: steal ``group`` to the receiving
    leader's zone (bench/geo_lt.py's migration arm, the zone-outage
    repair path)."""

    group: int


@dataclasses.dataclass(frozen=True)
class WPhase1a:
    """The steal's cross-zone Phase1: promise ``ballot`` for ``group``
    and report votes + known epochs. ``epoch`` is the epoch id the
    stealer will commit on quorum."""

    group: int
    ballot: int
    epoch: int


@dataclasses.dataclass(frozen=True)
class WVote:
    slot: int
    ballot: int
    value: CommandBatchOrNoop


@dataclasses.dataclass(frozen=True)
class WPhase1b:
    """The acceptor's DURABLE steal ack (the WalGeoPromise is fsynced
    before this leaves -- DurableRole): every vote it holds for the
    group plus its known epoch chain, so the stealer adopts in-flight
    values and discovers committed steals it missed (the
    Flexible-Paxos intersection condition over the epoch map)."""

    group: int
    ballot: int
    epoch: int
    acceptor: int
    votes: Tuple[WVote, ...]
    epochs: Tuple[GeoEpoch, ...]


@dataclasses.dataclass(frozen=True)
class WPhase2a:
    group: int
    slot: int
    ballot: int
    value: CommandBatchOrNoop


@dataclasses.dataclass(frozen=True)
class WPhase2b:
    group: int
    slot: int
    ballot: int
    acceptor: int


@dataclasses.dataclass(frozen=True)
class WNack:
    """Promise refused: ``ballot`` is the higher promised ballot, and
    ``home_zone`` the refuser's current owner hint for the group."""

    group: int
    ballot: int
    home_zone: int


@dataclasses.dataclass(frozen=True)
class WChosen:
    group: int
    slot: int
    value: CommandBatchOrNoop


@dataclasses.dataclass(frozen=True)
class WEpochCommit:
    """The committed steal's epoch entry, broadcast by the new owner
    to acceptors and peer leaders (resent until a read quorum of
    acceptor acks -- discovery is then guaranteed for any future
    Phase1, docs/GEO.md)."""

    entry: GeoEpoch


@dataclasses.dataclass(frozen=True)
class WEpochAck:
    """Durability receipt for one WEpochCommit (the WalGeoEpoch record
    is group-committed before this leaves an acceptor)."""

    group: int
    epoch: int


@dataclasses.dataclass(frozen=True)
class WRecover:
    """Replica hole recovery: send me WChosen for ``group`` slots >=
    ``slot`` (the receiver answers from its chosen log; bounded per
    reply burst)."""

    group: int
    slot: int


#: Handy alias for handlers.
OptionalCommand = Optional[Command]
