"""The port's WAL (``frankenpaxos_tpu_torch/wal/``) against the JAX
package's.

(a) The cases of ``tests/test_wal.py`` repeated against the port: the
record codecs, group commit, rotation, compaction, torn-tail recovery
and the fsync-stall storage. (b) Parity: the same records through both
packages' ``Wal`` (MemStorage, and FileStorage under ``tmp_path``) give
byte-equal segments, segment names and metrics, through rotation,
compaction and a torn-tail recovery. Bytes are compared exactly; the
only tolerance is the stall test's lower bound on wall time.
"""

import os
import struct

from frankenpaxos_tpu_torch.wal import (
    FileStorage,
    MemStorage,
    Wal,
    WalChosenRun,
    WalNoopRange,
    WalPromise,
    WalSnapshot,
    WalVote,
    WalVoteRun,
)
from frankenpaxos_tpu_torch.wal.records import WAL_SERIALIZER
import pytest

from frankenpaxos_tpu import wal as jwal

RECORDS = [
    WalPromise(round=3),
    WalVote(slot=7, round=1, value=b"\x00"),
    WalVoteRun(start_slot=10, stride=2, round=4, values=b"\x01\x02\x03"),
    WalNoopRange(slot_start_inclusive=5, slot_end_exclusive=95, round=2),
    WalChosenRun(start_slot=0, stride=1, values=b""),
    WalSnapshot(payload=b"snap-bytes"),
]


@pytest.mark.parametrize("record", RECORDS,
                         ids=lambda r: type(r).__name__)
def test_record_codecs_round_trip(record):
    data = WAL_SERIALIZER.to_bytes(record)
    assert WAL_SERIALIZER.from_bytes(data) == record


def test_record_codec_rejects_hostile_length():
    data = bytearray(WAL_SERIALIZER.to_bytes(
        WalVote(slot=1, round=0, value=b"xyzw")))
    # Layout: tag(1) + slot(8) + round(8) + len(4) + bytes.
    struct.pack_into("<i", data, 17, 1 << 30)
    with pytest.raises(ValueError):
        WAL_SERIALIZER.from_bytes(bytes(data))
    struct.pack_into("<i", data, 17, -5)
    with pytest.raises(ValueError):
        WAL_SERIALIZER.from_bytes(bytes(data))


def test_record_serializer_is_closed():
    """No pickle fallback in the record space: unknown tags and
    unregistered types refuse outright (recovery never executes
    code)."""
    with pytest.raises(ValueError):
        WAL_SERIALIZER.from_bytes(b"\x7f\x00\x00")
    with pytest.raises(ValueError):
        WAL_SERIALIZER.from_bytes(b"\x80\x04x")  # a pickle frame
    with pytest.raises(ValueError):
        WAL_SERIALIZER.to_bytes(object())


@pytest.mark.parametrize("kind", ["mem", "file"])
def test_append_sync_recover_round_trip(kind, tmp_path):
    root = str(tmp_path / "wal")
    storage = MemStorage() if kind == "mem" else FileStorage(root)
    wal = Wal(storage)
    for record in RECORDS:
        wal.append(record)
    wal.sync()
    assert wal.metrics.syncs == 1
    assert wal.metrics.records_synced == len(RECORDS)
    wal.close()

    wal2 = Wal(storage if kind == "mem" else FileStorage(root))
    assert wal2.recover() == RECORDS


def test_unsynced_records_die_with_the_actor():
    """The group-commit rule's crash contract: appended-but-unsynced
    records are NOT durable -- discarding the Wal object (the sim's
    crash) loses exactly them."""
    storage = MemStorage()
    wal = Wal(storage)
    wal.append(WalPromise(round=1))
    wal.sync()
    wal.append(WalPromise(round=2))  # staged, never synced
    # Crash: new Wal over the surviving storage.
    wal2 = Wal(storage)
    assert wal2.recover() == [WalPromise(round=1)]


def test_group_commit_amortizes_fsyncs():
    storage = MemStorage()
    wal = Wal(storage)
    for drain in range(5):
        for i in range(40):
            wal.append(WalVote(slot=drain * 40 + i, round=0, value=b"v"))
        wal.sync()
    assert wal.metrics.syncs == 5  # one fsync per drain, not per record
    assert storage.fsyncs == 5
    assert wal.metrics.records_synced == 200
    assert wal.metrics.bytes_per_sync() > 0


def test_torn_tail_truncated_and_idempotent(tmp_path):
    """A partial group commit at the tail (the crash shape) is
    truncated on recovery; records synced AFTER that recovery survive
    a second restart (recovery is idempotent)."""
    root = str(tmp_path / "wal")
    storage = FileStorage(root)
    wal = Wal(storage)
    wal.append(WalPromise(round=1))
    wal.append(WalVote(slot=0, round=1, value=b"a"))
    wal.sync()
    wal.close()
    # Tear: chop the last 3 bytes off the live segment.
    storage = FileStorage(root)
    name = storage.segments()[-1]
    data = storage.read(name)
    storage.truncate(name, len(data) - 3)
    storage.close()

    storage = FileStorage(root)
    wal2 = Wal(storage)
    assert wal2.recover() == [WalPromise(round=1)]
    assert wal2.metrics.truncated_tail_bytes > 0
    wal2.append(WalVote(slot=9, round=2, value=b"b"))
    wal2.sync()
    wal2.close()

    wal3 = Wal(FileStorage(root))
    assert wal3.recover() == [WalPromise(round=1),
                              WalVote(slot=9, round=2, value=b"b")]


def test_zero_filled_tail_truncates_cleanly():
    """Review-found: a zero-filled (extended-but-unwritten) tail
    parses as a 'valid' frame (len=0, crc=0, crc32(b'')==0); recovery
    must truncate it as torn, not crash the restarting role with an
    IndexError."""
    storage = MemStorage()
    wal = Wal(storage)
    wal.append(WalPromise(round=1))
    wal.sync()
    name = storage.segments()[0]
    storage.files[name].extend(b"\x00" * 64)
    wal2 = Wal(storage)
    assert wal2.recover() == [WalPromise(round=1)]
    assert wal2.metrics.truncated_tail_bytes == 64
    # Idempotent: a third restart sees a clean log.
    wal3 = Wal(storage)
    assert wal3.recover() == [WalPromise(round=1)]


def test_corrupt_crc_stops_replay():
    storage = MemStorage()
    wal = Wal(storage)
    wal.append(WalPromise(round=1))
    wal.append(WalPromise(round=2))
    wal.sync()
    name = storage.segments()[0]
    storage.files[name][10] ^= 0xFF  # flip a byte inside frame 1
    wal2 = Wal(storage)
    assert wal2.recover() == []  # replay stops at the corrupt frame


def test_segment_rotation_and_compaction():
    storage = MemStorage()
    wal = Wal(storage, segment_bytes=256)
    for i in range(50):
        wal.append(WalVote(slot=i, round=0, value=b"x" * 16))
        wal.sync()
    assert len(storage.segments()) > 1  # rotated past 256 bytes

    # Compaction: snapshot + re-logged live state replaces history.
    live = [WalVote(slot=49, round=0, value=b"x" * 16)]
    wal.compact(WalSnapshot(payload=b"S"), live)
    assert len(storage.segments()) == 1
    assert wal.metrics.compactions == 1
    assert wal.metrics.segments_deleted >= 1

    wal2 = Wal(storage)
    assert wal2.recover() == [WalSnapshot(payload=b"S")] + live


def test_compaction_crash_before_delete_is_safe():
    """A crash after writing the snapshot segment but before deleting
    old segments replays history THEN the snapshot: roles treat
    WalSnapshot as a reset point, so the prefix is harmless."""
    storage = MemStorage()
    wal = Wal(storage)
    wal.append(WalPromise(round=1))
    wal.sync()
    # Simulate the crash window: write the compact segment by hand.
    snap_wal = Wal(storage)
    snap_wal._seg_index = wal._seg_index + 1
    snap_wal._segment = f"seg-{snap_wal._seg_index:08d}.wal"
    snap_wal.append(WalSnapshot(payload=b"S"))
    snap_wal.append(WalPromise(round=5))
    snap_wal.sync()
    wal2 = Wal(storage)
    records = wal2.recover()
    # The snapshot marker appears AFTER the stale prefix; replay-side
    # reset-at-snapshot discards everything before it.
    assert records[-2:] == [WalSnapshot(payload=b"S"),
                            WalPromise(round=5)]


def test_wants_compaction_threshold():
    wal = Wal(MemStorage(), compact_every_bytes=128)
    assert not wal.wants_compaction()
    for i in range(20):
        wal.append(WalVote(slot=i, round=0, value=b"y" * 8))
    wal.sync()
    assert wal.wants_compaction()
    wal.compact(WalSnapshot(payload=b""), [])
    assert not wal.wants_compaction()


# --- paxchaos: FsyncStallStorage over REAL FileStorage on disk ---------------


def test_fsync_stall_over_file_storage_blocking(tmp_path):
    """The deployed fault arm (satellite of paxchaos): a BLOCKING
    FsyncStallStorage over a real FileStorage actually sleeps through
    its count-cadence stalls, and every synced record is durable on
    disk afterwards."""
    import time

    from frankenpaxos_tpu_torch.wal import FsyncStallStorage

    root = str(tmp_path / "wal")
    storage = FsyncStallStorage(
        FileStorage(root), seed=7, label="a0", stall_every=2,
        stall_s=0.02, jitter=0.0, blocking=True)
    wal = Wal(storage)
    t0 = time.perf_counter()
    for i in range(4):
        wal.append(WalVote(slot=i, round=1, value=b"v%d" % i))
        wal.sync()
    elapsed = time.perf_counter() - t0
    assert len(storage.stalls) == 2
    assert elapsed >= sum(storage.stalls)  # the sleeps were real
    wal.close()
    recovered = Wal(FileStorage(root)).recover()
    assert recovered == [WalVote(slot=i, round=1, value=b"v%d" % i)
                         for i in range(4)]


def test_fsync_stall_periodic_windows_align_on_shared_clock(tmp_path):
    """Periodic-window mode: two storages sharing one clock stall in
    the SAME windows (the property that makes deployed overlap faults
    reproducible), and outside a window no stall fires."""
    from frankenpaxos_tpu_torch.wal import FsyncStallStorage

    now = {"t": 0.0}
    clock = lambda: now["t"]  # noqa: E731
    storages = [
        FsyncStallStorage(FileStorage(str(tmp_path / f"w{i}")),
                          label=f"a{i}", stall_period_s=1.0,
                          stall_window_s=0.1, clock=clock)
        for i in range(2)]
    for t, expect_stall in ((0.05, True), (0.5, False),
                            (1.02, True), (1.9, False)):
        now["t"] = t
        for storage in storages:
            before = len(storage.stalls)
            storage.append("seg-00000000.wal", b"x")
            storage.sync("seg-00000000.wal")
            assert (len(storage.stalls) > before) == expect_stall, t
    # Both stalled at exactly the same instants, to the window end.
    assert storages[0].stalls == storages[1].stalls
    assert storages[0].stalls[0] == pytest.approx(0.05)


def test_torn_tail_recovery_with_stall_in_flight(tmp_path):
    """Crash DURING a stall (satellite 3's torn-tail case): the stall
    fires after the real fsync, so records of the stalled group
    commit are durable -- a crash mid-stall loses nothing synced, and
    a torn tail appended by the dying process truncates away on
    recovery over the SAME wrapped storage."""
    from frankenpaxos_tpu_torch.wal import FsyncStallStorage

    root = str(tmp_path / "wal")
    crashed = {}

    def crash_mid_stall(stall_s):
        # The "crash": capture the on-disk state AT the stall (fsync
        # done, ack held, process about to die).
        crashed["segments"] = FileStorage(root).segments()

    storage = FsyncStallStorage(
        FileStorage(root), seed=1, label="a0", stall_every=2,
        stall_s=0.001, on_stall=crash_mid_stall)
    wal = Wal(storage)
    wal.append(WalPromise(round=1))
    wal.sync()            # sync 1: no stall
    wal.append(WalVote(slot=1, round=1, value=b"durable"))
    wal.sync()            # sync 2: stall fires -- the "crash" point
    assert crashed["segments"]  # the record was already on disk
    # The dying process had staged (unsynced) records AND a torn
    # half-frame reached the file (the kill landed mid-write).
    wal.append(WalVote(slot=2, round=1, value=b"lost-with-buffer"))
    name = storage.segments()[-1]
    storage.append(name, b"\xff\xff\xff")  # torn garbage, no sync
    storage.close()

    # Recovery over a FRESH wrapped FileStorage (the relaunch keeps
    # its fault arming, as the deployed launch spec does).
    storage2 = FsyncStallStorage(
        FileStorage(root), seed=1, label="a0", stall_every=2,
        stall_s=0.001)
    wal2 = Wal(storage2)
    records = wal2.recover()
    assert records == [WalPromise(round=1),
                       WalVote(slot=1, round=1, value=b"durable")]
    assert wal2.metrics.truncated_tail_bytes == 3
    # Post-recovery appends survive another restart (idempotent), and
    # the wrapper keeps injecting on the recovered log.
    wal2.append(WalVote(slot=3, round=2, value=b"after"))
    wal2.sync()
    wal2.sync_count_before = storage2.syncs
    wal2.close()
    final = Wal(FileStorage(root)).recover()
    assert final == [WalPromise(round=1),
                     WalVote(slot=1, round=1, value=b"durable"),
                     WalVote(slot=3, round=2, value=b"after")]


# --- (b) parity with the JAX package -----------------------------------------


def _records(ns, n: int) -> list:
    """Every record kind, ``n`` rounds of them, from ``ns``'s classes."""
    out = []
    for i in range(n):
        out += [
            ns.WalPromise(round=i),
            ns.WalVote(slot=i, round=i, value=b"v%d" % i),
            ns.WalVoteRun(start_slot=10 * i, stride=1 + i % 3, round=i,
                          values=bytes(range(i % 7)) * 5),
            ns.WalNoopRange(slot_start_inclusive=i, slot_end_exclusive=i + 9,
                            round=i),
            ns.WalChosenRun(start_slot=i, stride=1, values=b"c" * (i % 40)),
            ns.WalEpoch(payload=b"e%d" % i),
            ns.WalGeoPromise(group=i % 4, ballot=i),
            ns.WalGeoVote(group=i % 4, slot=i, ballot=i, value=b"g" * i),
            ns.WalGeoEpoch(payload=b"ge%d" % i),
        ]
    return out


def _drive(ns, storage) -> tuple:
    """Drains of records with group commits, a compaction, and then a
    torn tail recovered by a fresh Wal; returns what recovery read and
    both Wals' metrics."""
    wal = ns.Wal(storage, segment_bytes=512, compact_every_bytes=2048)
    records = _records(ns, 24)
    for at in range(0, len(records), 7):
        for record in records[at:at + 7]:
            wal.append(record)
        wal.sync()
        if wal.wants_compaction():
            wal.compact(ns.WalSnapshot(payload=b"snap%d" % at),
                        records[at:at + 3])
    name = storage.segments()[-1]
    # A torn frame the dying process got onto the disk.
    storage.append(name, b"\x05\x00\x00")
    storage.sync(name)
    recovered = ns.Wal(storage)
    got = recovered.recover()
    recovered.append(ns.WalPromise(round=99))
    recovered.sync()
    return got, wal.metrics, recovered.metrics


def _files(storage) -> dict:
    return {name: storage.read(name) for name in storage.segments()}


@pytest.mark.parametrize("kind", ["mem", "file"])
def test_wal_bytes_equal_the_references(kind, tmp_path):
    storages = []
    results = []
    for tag, ns in (("port", __import__("frankenpaxos_tpu_torch.wal",
                                        fromlist=["x"])), ("jax", jwal)):
        if kind == "mem":
            storage = ns.MemStorage()
        else:
            storage = ns.FileStorage(str(tmp_path / tag))
        results.append(_drive(ns, storage))
        storages.append(storage)
    (got, metrics, rmetrics), (jgot, jmetrics, jrmetrics) = results
    assert [type(r).__name__ for r in got] == \
        [type(r).__name__ for r in jgot]
    assert [r.__dict__ for r in got] == [r.__dict__ for r in jgot]
    assert metrics.__dict__ == jmetrics.__dict__
    assert rmetrics.__dict__ == jrmetrics.__dict__
    assert metrics.compactions >= 1 and rmetrics.truncated_tail_bytes == 3
    files, jfiles = _files(storages[0]), _files(storages[1])
    assert files == jfiles and len(files) >= 2
    if kind == "file":
        assert sorted(os.listdir(tmp_path / "port")) == sorted(files)


@pytest.mark.parametrize("i", range(9))
def test_record_frames_equal_the_references(i):
    """Each record kind encodes to the JAX package's record frame, and
    each package decodes the other's frame."""
    from frankenpaxos_tpu_torch import wal as twal
    from frankenpaxos_tpu.wal.records import WAL_SERIALIZER as JSER

    record, jrecord = _records(twal, 3)[9 + i], _records(jwal, 3)[9 + i]
    data, jdata = WAL_SERIALIZER.to_bytes(record), JSER.to_bytes(jrecord)
    assert data == jdata
    assert WAL_SERIALIZER.from_bytes(jdata) == record
    assert JSER.from_bytes(data) == jrecord
