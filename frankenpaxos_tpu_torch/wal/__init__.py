"""Drain-granular durability for protocol roles (the port's copy of
``frankenpaxos_tpu/wal/``; the same records, frames and bytes on disk).

An append-only, CRC-framed, segment-rotating write-ahead log with GROUP
COMMIT at the actor runtime's ``on_drain`` boundary: every record
appended while a drain's messages are being handled is made durable by
ONE ``fsync`` when the drain ends, so the per-message durability cost
amortizes across the drain. Acceptors recover promises, votes, runs and
epochs, and replicas an SM snapshot plus the executed watermark, after
``kill -9``, then rejoin the cluster.

  * ``wal.records`` -- the typed record set + fixed-layout codecs in a
    closed record tag space (no pickle fallback).
  * ``wal.log`` -- ``Wal`` (framing, group commit, segment rotation,
    snapshot/compaction, torn-tail recovery) over ``FileStorage``
    (real files + fsync, under the root its caller gives) or
    ``MemStorage`` (the sim's crash-surviving stand-in: synced bytes
    survive ``crash_restart``, the unsynced group-commit buffer dies
    with the actor).
  * ``wal.faults`` -- deterministic fsync-stall fault injection (a
    wrapping storage: off by default, zero cost when unwrapped).
  * ``wal.role`` -- ``DurableRole``, the group-commit release order.
"""

from frankenpaxos_tpu_torch.wal.faults import FsyncStallStorage
from frankenpaxos_tpu_torch.wal.log import FileStorage, MemStorage, Wal, WalMetrics
from frankenpaxos_tpu_torch.wal.records import (
    WalChosenRun,
    WalEpoch,
    WalGeoEpoch,
    WalGeoPromise,
    WalGeoVote,
    WalNoopRange,
    WalPromise,
    WalSnapshot,
    WalVote,
    WalVoteRun,
)
from frankenpaxos_tpu_torch.wal.role import DurableRole

__all__ = ["DurableRole", "FileStorage", "FsyncStallStorage", "MemStorage",
           "Wal", "WalChosenRun", "WalEpoch", "WalGeoEpoch", "WalGeoPromise",
           "WalGeoVote", "WalMetrics", "WalNoopRange", "WalPromise",
           "WalSnapshot", "WalVote", "WalVoteRun"]
