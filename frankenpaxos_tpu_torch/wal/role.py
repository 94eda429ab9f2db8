"""DurableRole: the ONE implementation of the group-commit ordering (the
port's copy of ``frankenpaxos_tpu/wal/role.py``).

Every durable actor (MultiPaxos acceptors and replicas, WPaxos acceptors) shares
the same release discipline -- records staged during a drain are
fsynced ONCE, and only then do the acks that depend on them leave the
actor. That ordering is the WAL's entire safety argument (a crash can
never lose acked state), so it lives here exactly once instead of
drifting across the role classes; only ``_wal_compact`` (what live
state a compaction re-logs) and recovery genuinely differ per role.
"""

from __future__ import annotations


class DurableRole:
    """Mixin over Actor: wal staging, deferred sends, and the drain's
    sync -> compact -> release sequence."""

    def _wal_init(self, wal) -> None:
        self.wal = wal
        self._wal_sends: list = []

    def _wal_send(self, dst, message) -> None:
        """Send, or -- when durable -- hold until the drain's group
        commit (the group-commit rule, wal/log.py): an ack that
        depends on a staged record must never precede its fsync."""
        if self.wal is None:
            self.send(dst, message)
        else:
            self._wal_sends.append((dst, message))

    def _wal_drain(self) -> None:
        """The on_drain tail for durable roles: ONE fsync covers every
        record this drain appended, compaction runs on the same
        boundary, and only then do the held acks go out. The two
        drain stages here -- wal-fsync and send-release -- are exactly
        the latency a command spends waiting on the group commit."""
        if self.wal is None:
            return
        with self.trace_stage("wal-fsync"):
            self.wal.sync()
        if self.wal.wants_compaction():
            self._wal_compact()
        if self._wal_sends:
            sends, self._wal_sends = self._wal_sends, []
            with self.trace_stage("send-release"):
                for dst, message in sends:
                    self.send(dst, message)

    def _wal_compact(self) -> None:  # pragma: no cover - roles override
        raise NotImplementedError
