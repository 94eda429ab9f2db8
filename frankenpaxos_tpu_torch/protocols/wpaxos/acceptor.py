"""WPaxos Acceptor: one grid cell, serving every object group (the
port's copy of ``frankenpaxos_tpu/protocols/wpaxos/acceptor.py``).

Per-group state only -- a promised ballot, per-slot votes, and the
group's known epoch chain. The acceptor never evaluates quorums; it
enforces the two Paxos vote rules (promise monotonicity, vote-at-
promised-ballot) per group and reports its state to stealers.

The reference logs promises, votes and epoch entries to a WAL and holds
every ack that depends on one until the drain's group-commit fsync. The
WAL is not ported yet (ROADMAP.md queue 1 item 4): ``wal=`` is refused,
and acks leave as they are handled, as the reference's do with no WAL.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch, ObjectEpochStore
from frankenpaxos_tpu_torch.protocols.wpaxos.config import WPaxosConfig
from frankenpaxos_tpu_torch.protocols.wpaxos.messages import (
    WEpochAck,
    WEpochCommit,
    WNack,
    WPhase1a,
    WPhase1b,
    WPhase2a,
    WPhase2b,
    WVote,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


class WPaxosAcceptor(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: WPaxosConfig, wal=None):
        if wal is not None:
            raise NotImplementedError(
                "the WAL is not ported yet (ROADMAP.md queue 1 item 4)")
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.zone = next(
            z for z, row in enumerate(config.acceptor_addresses)
            if address in row)
        self.index = config.acceptor_addresses[self.zone].index(address)
        self.acceptor_id = config.acceptor_id(self.zone, self.index)
        # Per-group promised ballot (-1: anything goes).
        self.promised: dict[int, int] = {}
        # Per-group votes: group -> {slot: (ballot, value)}.
        self.votes: dict[int, dict] = {}
        self.epochs = ObjectEpochStore(config.num_groups,
                                       config.initial_home)

    # --- handlers -----------------------------------------------------------
    def receive(self, src: Address, message) -> None:
        if isinstance(message, WPhase2a):
            self._handle_phase2a(src, message)
        elif isinstance(message, WPhase1a):
            self._handle_phase1a(src, message)
        elif isinstance(message, WEpochCommit):
            self._handle_epoch_commit(src, message)
        else:
            self.logger.fatal(f"unexpected acceptor message {message!r}")

    def _handle_phase1a(self, src: Address, m: WPhase1a) -> None:
        promised = self.promised.get(m.group, -1)
        if m.ballot <= promised:
            self.send(src, WNack(
                group=m.group, ballot=promised,
                home_zone=self.epochs.current(m.group).home_zone))
            return
        self.promised[m.group] = m.ballot
        votes = tuple(
            WVote(slot=slot, ballot=ballot, value=value)
            for slot, (ballot, value)
            in sorted(self.votes.get(m.group, {}).items()))
        self.send(src, WPhase1b(
            group=m.group, ballot=m.ballot, epoch=m.epoch,
            acceptor=self.acceptor_id, votes=votes,
            epochs=self.epochs.known(m.group)))

    def _handle_phase2a(self, src: Address, m: WPhase2a) -> None:
        promised = self.promised.get(m.group, -1)
        if m.ballot < promised:
            self.send(src, WNack(
                group=m.group, ballot=promised,
                home_zone=self.epochs.current(m.group).home_zone))
            return
        existing = self.votes.get(m.group, {}).get(m.slot)
        if existing is not None and existing[0] > m.ballot:
            return  # stale duplicate below an already-voted ballot
        if existing is not None and existing[0] == m.ballot \
                and existing[1] != m.value:
            # Votes are WRITE-ONCE per (slot, ballot): one ballot has
            # one proposer, so a conflicting twin is a protocol-error
            # frame (or an amnesiac proposer) -- re-acking it would
            # let a second value ride the first value's quorum.
            return
        if m.ballot > promised:
            # Voting at b implicitly promises b.
            self.promised[m.group] = m.ballot
        if existing is None or existing[0] != m.ballot:
            self.votes.setdefault(m.group, {})[m.slot] = (m.ballot,
                                                          m.value)
        self.send(src, WPhase2b(group=m.group, slot=m.slot,
                                ballot=m.ballot,
                                acceptor=self.acceptor_id))

    def _handle_epoch_commit(self, src: Address, m: WEpochCommit) -> None:
        entry: GeoEpoch = m.entry
        verdict = self.epochs.offer(entry)
        if verdict in ("new", "replaced", "dup"):
            self.send(src, WEpochAck(group=entry.group,
                                     epoch=entry.epoch))
