"""WPaxos Acceptor: one grid cell, serving every object group (the
port's copy of ``frankenpaxos_tpu/protocols/wpaxos/acceptor.py``).

Per-group state only -- a promised ballot, per-slot votes, and the
group's known epoch chain. The acceptor never evaluates quorums; it
enforces the two Paxos vote rules (promise monotonicity, vote-at-
promised-ballot) per group and reports durable state to stealers.

Durability follows the paxlog group-commit discipline (wal/role.py):
promises, votes, and epoch entries append to the WAL as they are
handled, and every ack that depends on one (WPhase1b, WPhase2b,
WEpochAck) is held in ``_wal_sends`` until ``on_drain``'s single fsync
releases it. That ordering is what makes a row-majority of WPhase1b
acks a real steal commit: a crashed old-home acceptor can never have
acked a promise it will not recover.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch, ObjectEpochStore
from frankenpaxos_tpu_torch.protocols.multipaxos.wire import (
    decode_value,
    encode_value,
)
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
from frankenpaxos_tpu_torch.protocols.wpaxos.wire import (
    decode_geo_epoch,
    encode_geo_epoch,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport
from frankenpaxos_tpu_torch.wal import (
    DurableRole,
    WalGeoEpoch,
    WalGeoPromise,
    WalGeoVote,
    WalSnapshot,
)


class WPaxosAcceptor(Actor, DurableRole):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: WPaxosConfig, wal=None):
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
        self._wal_init(wal)
        if wal is not None:
            self._recover_from_wal()

    # --- durability ---------------------------------------------------------
    def _recover_from_wal(self) -> None:
        for record in self.wal.recover(self.logger):
            if isinstance(record, WalSnapshot):
                self.promised.clear()
                self.votes.clear()
                self.epochs = ObjectEpochStore(
                    self.config.num_groups, self.config.initial_home)
            elif isinstance(record, WalGeoPromise):
                self.promised[record.group] = max(
                    self.promised.get(record.group, -1), record.ballot)
            elif isinstance(record, WalGeoVote):
                self.promised[record.group] = max(
                    self.promised.get(record.group, -1), record.ballot)
                self.votes.setdefault(record.group, {})[record.slot] = (
                    record.ballot, decode_value(record.value))
            elif isinstance(record, WalGeoEpoch):
                self.epochs.offer(decode_geo_epoch(record.payload))
            else:
                self.logger.fatal(
                    f"unexpected wpaxos acceptor WAL record {record!r}")

    def _wal_compact(self) -> None:
        records: list = []
        for group in sorted(self.promised):
            records.append(WalGeoPromise(group=group,
                                         ballot=self.promised[group]))
        for group in range(self.config.num_groups):
            for entry in self.epochs.known(group):
                if entry.epoch > 0:
                    records.append(WalGeoEpoch(
                        payload=encode_geo_epoch(entry)))
        for group in sorted(self.votes):
            for slot in sorted(self.votes[group]):
                ballot, value = self.votes[group][slot]
                records.append(WalGeoVote(
                    group=group, slot=slot, ballot=ballot,
                    value=encode_value(value)))
        self.wal.compact(WalSnapshot(payload=b""), records)

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
        if self.wal is not None:
            self.wal.append(WalGeoPromise(group=m.group,
                                          ballot=m.ballot))
        votes = tuple(
            WVote(slot=slot, ballot=ballot, value=value)
            for slot, (ballot, value)
            in sorted(self.votes.get(m.group, {}).items()))
        # The durable steal ack: released only after the promise's
        # group-commit fsync (DurableRole).
        self._wal_send(src, WPhase1b(
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
            if self.wal is not None:
                self.wal.append(WalGeoPromise(group=m.group,
                                              ballot=m.ballot))
        if existing is None or existing[0] != m.ballot:
            self.votes.setdefault(m.group, {})[m.slot] = (m.ballot,
                                                          m.value)
            if self.wal is not None:
                self.wal.append(WalGeoVote(
                    group=m.group, slot=m.slot, ballot=m.ballot,
                    value=encode_value(m.value)))
        self._wal_send(src, WPhase2b(group=m.group, slot=m.slot,
                                     ballot=m.ballot,
                                     acceptor=self.acceptor_id))

    def _handle_epoch_commit(self, src: Address, m: WEpochCommit) -> None:
        entry: GeoEpoch = m.entry
        verdict = self.epochs.offer(entry)
        if verdict in ("new", "replaced"):
            if self.wal is not None:
                self.wal.append(WalGeoEpoch(
                    payload=encode_geo_epoch(entry)))
            self._wal_send(src, WEpochAck(group=entry.group,
                                          epoch=entry.epoch))
        elif verdict == "dup":
            # Already durable from the drain that first logged it; the
            # re-ack still rides the group-commit release path so the
            # ordering invariant holds uniformly.
            self._wal_send(src, WEpochAck(group=entry.group,
                                          epoch=entry.epoch))

    def on_drain(self) -> None:
        self._wal_drain()
