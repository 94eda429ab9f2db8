"""Reconfiguration messages (the port's copy of
``frankenpaxos_tpu/reconfig/messages.py``), with their codecs on the
wire's extended tag page (``reconfig/wire.py``, tags 128-131).

The config-change command flow (leader-driven, docs/RECONFIG.md):

  admin --Reconfigure--> leader
  leader --EpochCommit--> old members + new members + proxy leaders
                          + peer leaders        (resent until acked)
  acceptor: WAL the epoch, THEN --EpochAck--> leader (group commit)
  leader: write quorum of OLD-epoch acks => epoch ACTIVE; buffered
          proposals open the new epoch's slots as EpochPhase2aRun

Only the proposal direction carries an epoch tag: acks are
slot-addressed and epochs partition slot space, so a vote's epoch is
derivable; but a proposal must not be fanned out by a proxy whose
store has not seen the epoch yet -- the tag lets the proxy stash the
run until the (resent) EpochCommit arrives instead of mis-routing it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Reconfigure:
    """Admin request: replace the acceptor set with ``members``
    (2f+1 addresses; any overlap with the current set is fine --
    single-member swaps are the repair path)."""

    members: tuple  # tuple[Address, ...]


@dataclasses.dataclass(frozen=True)
class EpochCommit:
    """The epoch map entry, broadcast by the proposing leader until
    acked: slots >= ``start_slot`` are governed by ``members``.

    ``round`` is the committing leader's Paxos round: epoch entries are
    ROUND-MONOTONE per epoch id (a higher-round commit for the same
    epoch supersedes a lower-round one), which serializes concurrent
    leaders racing to define epoch e+1 exactly as Phase2a rounds
    serialize value proposals -- an ACTIVATED definition (f+1 old-epoch
    durable acks) is visible to any later leader's Phase1 read quorum,
    so it is adopted rather than replaced (docs/RECONFIG.md)."""

    epoch: int
    start_slot: int
    f: int
    round: int
    members: tuple  # tuple[Address, ...]


@dataclasses.dataclass(frozen=True)
class EpochAck:
    """Durability receipt for one EpochCommit. From acceptors it is
    released only after the WalEpoch record's group-commit fsync
    (DurableRole), which is what makes an old-epoch write quorum of
    acks a matchmaker-grade commit. Echoes the commit's round so a
    preempted leader's stale acks are not mistaken for the new
    round's."""

    epoch: int
    round: int


@dataclasses.dataclass(frozen=True)
class EpochPhase2aRun:
    """A Phase2aRun whose slots belong to epoch ``epoch``: the proxy
    leader fans it to that epoch's members (f+1 thrifty sample) and
    counts the acks under that epoch's spec. A proxy that does not
    know the epoch yet stashes the run until the EpochCommit resend
    lands -- never mis-routes it to the old set."""

    epoch: int
    start_slot: int
    round: int
    values: tuple  # tuple[CommandBatchOrNoop, ...], one per slot
