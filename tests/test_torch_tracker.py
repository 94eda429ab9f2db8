"""The port's Phase2b trackers vs their JAX twins and the dict oracles.

``TpuQuorumTracker`` (both modes) and ``EpochQuorumTracker`` run on the
plain PyTorch versions (``device="cpu"``) and must report exactly the
``(slot, round)`` pairs the dict oracle reports, each once, and what the
JAX package's trackers report on the same votes; in the pipelined mode
the port's vote board must equal the JAX tracker's after every drain.
The tracker cases of ``tests/protocols/test_multipaxos.py`` and the
epoch cases of ``tests/test_reconfig.py`` are repeated against the port,
and ``bench/tracker_lt.py`` runs end to end at a small size.
"""

import json
import os
import random
import subprocess
import sys
import threading

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import tracker_lt
from frankenpaxos_tpu_torch.protocols.multipaxos import quorum_tracker as qt
from frankenpaxos_tpu_torch.reconfig import (
    EpochConfig,
    EpochQuorumTracker,
    EpochStore,
)
import numpy as np
import pytest

from frankenpaxos_tpu.protocols.multipaxos import quorum_tracker as jqt
from frankenpaxos_tpu.protocols.multipaxos.config import (
    DistributionScheme as JDistributionScheme,
    MultiPaxosConfig as JMultiPaxosConfig,
)
from frankenpaxos_tpu.reconfig import (
    EpochConfig as JEpochConfig,
    EpochQuorumTracker as JEpochQuorumTracker,
    EpochStore as JEpochStore,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = tracker_lt.make_config()


def _jax_config(flexible=False):
    port = tracker_lt.make_config(flexible)
    fields = {f: getattr(port, f) for f in (
        "f", "batcher_addresses", "read_batcher_addresses",
        "leader_addresses", "leader_election_addresses",
        "proxy_leader_addresses", "acceptor_addresses",
        "replica_addresses", "proxy_replica_addresses", "flexible")}
    return JMultiPaxosConfig(**fields,
                             distribution_scheme=JDistributionScheme.HASH)


def _tracker(**kwargs):
    return qt.TpuQuorumTracker(CONFIG, device="cpu", **kwargs)


def _collect_all(tracker):
    got = []
    while (d := tracker.take_dispatch()) is not None:
        got.extend(tracker.collect(d))
    return got


def _random_drain(rng, cursor):
    """A contiguous frontier run (the dense shape) or scattered
    stragglers, as (slot, acceptor) votes in arrival order."""
    votes = []
    if rng.random() < 0.6 or cursor == 0:
        run_len = rng.randrange(1, 40)
        for slot in range(cursor, cursor + run_len):
            for acc in rng.sample(range(3), rng.randrange(1, 4)):
                votes.append((slot, acc))
        cursor += run_len
    else:
        for _ in range(rng.randrange(1, 16)):
            votes.append((rng.randrange(cursor), rng.randrange(3)))
    rng.shuffle(votes)
    return votes, cursor


@pytest.mark.parametrize("min_dev", [1, 1024])
def test_dense_and_sparse_paths_match_dict_and_reference(min_dev):
    """Sync mode over random dense and straggler drains: equal to the
    dict oracle and to the JAX tracker, drain by drain."""
    jconfig = _jax_config()
    for seed in range(3):
        rng = random.Random(100 + seed)
        trackers = [qt.DictQuorumTracker(CONFIG),
                    _tracker(window=1 << 12, min_device_slots=min_dev),
                    jqt.TpuQuorumTracker(jconfig, window=1 << 12,
                                         min_device_slots=min_dev)]
        cursor = 0
        for _ in range(15):
            votes, cursor = _random_drain(rng, cursor)
            for slot, acc in votes:
                for t in trackers:
                    t.record(slot, 0, 0, acc)
            got = [sorted(t.drain()) for t in trackers]
            assert got[0] == got[1] == got[2], (min_dev, seed, cursor)


@pytest.mark.filterwarnings("ignore:TpuQuorumChecker:RuntimeWarning")
def test_pipelined_matches_reference_board_by_board():
    """Pipelined mode over mixed-round drains with ranged, packed and
    per-slot votes, stragglers and widths past the window (ring wrap
    and window violations, where neither tracker matches the dict
    oracle any more): each drain's collected pairs and the whole vote
    board equal the JAX tracker's."""
    rng = np.random.default_rng(3)
    window = 256
    port = _tracker(window=window, pipelined=True)
    ref = jqt.TpuQuorumTracker(_jax_config(), window=window, pipelined=True)
    cursor = 0
    collected = {"port": [], "ref": []}
    for step in range(30):
        width = int(rng.integers(1, 300))
        rnd = int(rng.integers(0, 2)) if step % 4 == 3 else 0
        calls = []
        for acc in range(3):
            if rng.random() < 0.8:
                calls.append(("range", cursor, cursor + width, rnd, acc))
        for _ in range(int(rng.integers(0, 20))):
            lag = int(rng.integers(1, max(2, min(cursor, window // 2))))
            calls.append(("vote", max(0, cursor - lag),
                          int(rng.integers(0, 3)), int(rng.integers(0, 3))))
        if step % 5 == 2:
            slots = np.sort(rng.choice(np.arange(cursor, cursor + width),
                                       size=min(width, 20), replace=False))
            calls.append(("votes", slots, int(rng.integers(0, 3))))
        cursor += width
        for t in (port, ref):
            for call in calls:
                if call[0] == "range":
                    t.record_range(call[1], call[2], call[3], 0, call[4])
                elif call[0] == "vote":
                    t.record(call[1], call[2], 0, call[3])
                else:
                    t.record_votes(call[1], np.zeros(call[1].size, np.int32),
                                   0, call[2])
        assert port.drain() == [] and ref.drain() == []
        collected["port"] += _collect_all(port)
        collected["ref"] += _collect_all(ref)
        assert sorted(collected["port"]) == sorted(collected["ref"]), step
        board = convert.vote_board_to_numpy(port.checker.board)
        for name, want in zip(board._fields, ref.checker.board):
            np.testing.assert_array_equal(getattr(board, name),
                                          np.asarray(want), err_msg=name)
    assert port.checker.window_violations == ref.checker.window_violations


def test_collect_from_a_worker_thread():
    """Dispatches collected on another thread, as the ProxyLeader's
    collector does, report what the dict oracle reports."""
    stream = tracker_lt.make_stream(1 << 13, 3, drain=512, seed=5)
    oracle = tracker_lt.replay(qt.DictQuorumTracker(CONFIG), stream, 3)
    tracker = _tracker(window=1 << 12, pipelined=True)
    got = tracker_lt.replay_pipelined(tracker, stream, 3)
    tracker_lt.check_against_oracle("pipelined", got, oracle)
    assert not any(t.name == "tracker-collect" for t in threading.enumerate())


# --- the tracker cases of tests/protocols/test_multipaxos.py ------------------


def test_ring_wrap_self_reclaims():
    window = 256
    dict_tracker = qt.DictQuorumTracker(CONFIG)
    tracker = _tracker(window=window, pipelined=True)

    def tpu_drain():
        assert tracker.drain() == []
        return _collect_all(tracker)

    for base in range(0, 8 * window, 32):
        for slot in range(base, base + 32):
            for t in (dict_tracker, tracker):
                t.record(slot, 0, 0, 0)
                t.record(slot, 0, 0, 1)
        assert sorted(dict_tracker.drain()) == sorted(tpu_drain())
    tracker.record(window // 2, 0, 0, 0)  # ancient slot, wrapped 7 times
    assert tpu_drain() == []
    live = 8 * window + 5
    for t in (dict_tracker, tracker):
        t.record(live, 0, 0, 0)
        t.record(live, 0, 0, 2)
    assert sorted(dict_tracker.drain()) == sorted(tpu_drain()) \
        == [(live, 0)]


@pytest.mark.parametrize("kind", ["dict", "sync", "pipelined"])
def test_mixed_round_drain_reports_old_quorum(kind):
    t = {"dict": lambda: qt.DictQuorumTracker(CONFIG),
         "sync": lambda: _tracker(window=1 << 10),
         "pipelined": lambda: _tracker(window=1 << 10,
                                       pipelined=True)}[kind]()

    def drain():
        return t.drain() + (_collect_all(t) if kind == "pipelined" else [])

    t.record(5, 0, 0, 0)
    assert drain() == []
    t.record(5, 0, 0, 1)
    for slot in range(4, 8):
        t.record(slot, 1, 0, 0)
    assert (5, 0) in drain()


def test_duplicate_slot_two_rounds_one_drain():
    t = _tracker(window=1 << 10, min_device_slots=1)
    t.record(5, 0, 0, 0)
    t.record(5, 0, 0, 1)
    t.record(5, 1, 0, 0)
    t.record(5, 1, 0, 1)
    for slot in range(10, 20):
        t.record(slot, 0, 0, 0)
        t.record(slot, 0, 0, 1)
    out = t.drain()
    assert [s for s, _ in out].count(5) == 1 and (5, 0) in out, out
    for slot in range(0, 200):
        t.record(slot, 0, 0, 0)
        t.record(slot, 0, 0, 2)
    reported = {s for s, _ in t.drain()}
    assert 5 not in reported and reported.isdisjoint(range(10, 20))
    assert set(range(0, 5)).issubset(reported)


def test_empty_range_ignored():
    t = _tracker(window=1 << 10)
    t.record_range(7, 7, 0, 0, 0)
    assert t.drain() == []
    t.record_range(7, 3, 5, 0, 0)
    t.record_range(3, 5, 0, 0, 0)
    t.record_range(3, 5, 0, 0, 1)
    assert sorted(t.drain()) == [(3, 0), (4, 0)]


@pytest.mark.parametrize("pipelined", [False, True])
def test_ranged_votes_match_dict(pipelined):
    for seed in range(3):
        rng = random.Random(500 + seed)
        trackers = [qt.DictQuorumTracker(CONFIG),
                    _tracker(window=1 << 12, pipelined=pipelined)]
        cursor = 0
        for _ in range(12):
            kind = rng.random()
            if kind < 0.6 or cursor == 0:
                width = rng.randrange(2, 64)
                for acc in range(3):
                    if rng.random() < 0.9:
                        for t in trackers:
                            t.record_range(cursor, cursor + width, 0, 0, acc)
                cursor += width
            elif kind < 0.8:
                acc = rng.randrange(3)
                for t in trackers:
                    t.record(cursor, 0, 0, acc)
                cursor += 1
            else:
                for _ in range(rng.randrange(1, 8)):
                    slot, acc = rng.randrange(cursor), rng.randrange(3)
                    for t in trackers:
                        t.record(slot, 0, 0, acc)
            got = [sorted(t.drain() + (_collect_all(t) if pipelined
                                       and t is trackers[1] else []))
                   for t in trackers]
            assert got[0] == got[1], (seed, cursor)


@pytest.mark.parametrize("pipelined", [False, True])
def test_gap_slot_keeps_old_round_votes(pipelined):
    trackers = [qt.DictQuorumTracker(CONFIG),
                _tracker(window=1 << 12, pipelined=pipelined)]

    def drains():
        return [t.drain() + (_collect_all(t) if t is trackers[1]
                             and pipelined else []) for t in trackers]

    for t in trackers:
        t.record(10, 0, 0, 0)
    assert drains() == [[], []]
    for t in trackers:
        t.record(8, 1, 0, 0)
        t.record(12, 1, 0, 1)
    assert drains() == [[], []]
    for t in trackers:
        t.record(10, 0, 0, 1)
    assert drains() == [[(10, 0)], [(10, 0)]]


def test_pipelined_tracker_matches_dict_across_drains():
    for seed in range(3):
        rng = random.Random(200 + seed)
        dict_tracker = qt.DictQuorumTracker(CONFIG)
        tracker = _tracker(window=1 << 12, pipelined=True)
        dict_out, tpu_out = [], []
        cursor = 0
        for _ in range(12):
            run_len = rng.randrange(1, 16)
            for slot in range(cursor, cursor + run_len):
                for acc in rng.sample(range(3), rng.randrange(1, 4)):
                    dict_tracker.record(slot, 0, 0, acc)
                    tracker.record(slot, 0, 0, acc)
            cursor += run_len
            dict_out += dict_tracker.drain()
            assert tracker.drain() == []
        assert tracker.has_pending()
        tpu_out = _collect_all(tracker)
        assert sorted(dict_out) == sorted(tpu_out), seed


def test_host_spill_is_bounded():
    tracker = _tracker(window=256)
    tracker._host_gc_cap = 512
    for base in range(0, 4096, 16):
        for slot in range(base, base + 16):
            tracker.record(slot, 0, 0, 0)
        assert tracker.drain() == []
    assert len(tracker._host.states) <= 512 + 256


def test_straddling_board_split_uses_bucket_widths():
    window = 256
    dict_tracker = qt.DictQuorumTracker(CONFIG)
    tracker = _tracker(window=window, pipelined=True)
    start = window - 30
    for t in (dict_tracker, tracker):
        for slot in range(start, start + 100):
            t.record(slot, 0, 0, 0)
            t.record(slot, 0, 0, 1)
    assert tracker.drain() == []
    assert sorted(_collect_all(tracker)) == sorted(dict_tracker.drain())


@pytest.mark.parametrize("min_dev", [1, 1024])
def test_record_votes_matches_dict(min_dev):
    rng = random.Random(7)
    dict_tracker = qt.DictQuorumTracker(CONFIG)
    tracker = _tracker(window=1 << 12, min_device_slots=min_dev)
    cursor = 0
    for _ in range(10):
        run_len = rng.randrange(8, 60)
        for acc in range(3):
            picked = sorted(s for s in range(cursor, cursor + run_len)
                            if rng.random() < 0.7)
            slots = np.asarray(picked, dtype=np.int32)
            rounds = np.zeros(len(picked), dtype=np.int32)
            dict_tracker.record_votes(slots, rounds, 0, acc)
            tracker.record_votes(slots, rounds, 0, acc)
        cursor += run_len
        assert sorted(dict_tracker.drain()) == sorted(tracker.drain())


def test_routing_threshold_of_the_device():
    assert _tracker(window=1 << 10).min_device_slots \
        == qt.CPU_MIN_DEVICE_SLOTS == 1024
    assert _tracker(window=1 << 10, min_device_slots=7).min_device_slots == 7


# --- the epoch store and tracker (tests/test_reconfig.py) ------------------------


def test_epoch_store_slot_partition_and_offer():
    store = EpochStore.from_members(("a0", "a1", "a2"), f=1)
    store.add(EpochConfig(epoch=1, start_slot=10, f=1,
                          members=("a0", "a1", "a3")))
    store.add(EpochConfig(epoch=2, start_slot=25, f=1,
                          members=("a1", "a3", "a4")))
    assert [store.epoch_of_slot(s).epoch for s in (0, 9, 10, 24, 10**9)] \
        == [0, 0, 1, 1, 2]
    assert [c.epoch for c in store.epochs_covering(11)] == [1, 2]
    assert store.all_members() == ("a0", "a1", "a2", "a3", "a4")
    assert store.column_of("a3") == 3 and store.column_of("x") is None
    store = EpochStore.from_members(("a0", "a1", "a2"), f=1)
    c1a = EpochConfig(epoch=1, start_slot=10, f=1, members=("a0", "a1", "a3"))
    c1b = EpochConfig(epoch=1, start_slot=12, f=1, members=("a0", "a2", "a4"))
    assert [store.offer(c1a, 3), store.offer(c1a, 3), store.offer(c1b, 2),
            store.offer(c1b, 5)] == ["new", "dup", "stale", "replaced"]
    with pytest.raises(ValueError):
        EpochConfig(epoch=1, start_slot=0, f=1, members=("a", "a", "b"))


@pytest.mark.parametrize("seed", range(4))
def test_epoch_tracker_backends_agree(seed):
    """dict, the port's cuda backend (plain versions) and the JAX tpu
    backend report the same pairs, each once, across a membership
    change; then a superseded newest epoch rebuilds the checker."""
    rng = random.Random(300 + seed)
    members0, members1 = ("a0", "a1", "a2"), ("a0", "a1", "a3")
    boundary = rng.randrange(4, 30)
    stores = {"dict": EpochStore.from_members(members0, f=1),
              "cuda": EpochStore.from_members(members0, f=1),
              "ref": JEpochStore.from_members(members0, f=1)}
    trackers = {
        "dict": EpochQuorumTracker(stores["dict"], backend="dict",
                                   window=128),
        "cuda": EpochQuorumTracker(stores["cuda"], backend="cuda",
                                   window=128, device="cpu"),
        "ref": JEpochQuorumTracker(stores["ref"], backend="tpu",
                                   window=128)}
    reported = {b: [] for b in trackers}

    def drain_all():
        for b, t in trackers.items():
            reported[b].extend(t.drain())

    for i in range(120):
        if i == 60:
            for b in trackers:
                cls = JEpochConfig if b == "ref" else EpochConfig
                stores[b].add(cls(epoch=1, start_slot=boundary, f=1,
                                  members=members1))
                trackers[b].note_epochs()
        slot = rng.randrange(0, 60 if i >= 60 else boundary)
        voter = rng.choice(("a0", "a1", "a2", "a3", "stranger"))
        for t in trackers.values():
            t.record(slot, 0, voter)
        if rng.random() < 0.3:
            drain_all()
    drain_all()
    for b, got in reported.items():
        assert len(got) == len(set(got)), (b, got)
    assert set(reported["dict"]) == set(reported["cuda"]) \
        == set(reported["ref"])
    board = convert.vote_board_to_numpy(trackers["cuda"]._checker.board)
    for name, want in zip(board._fields, trackers["ref"]._checker.board):
        np.testing.assert_array_equal(getattr(board, name), np.asarray(want))
    # A higher-round commit supersedes the newest epoch: a rebuild.
    for b in ("cuda", "ref"):
        cls = JEpochConfig if b == "ref" else EpochConfig
        stores[b].offer(cls(epoch=1, start_slot=boundary, f=1,
                            members=("a0", "a2", "a4")), round=5)
        trackers[b].note_epochs()
    np.testing.assert_array_equal(
        trackers["cuda"]._checker.board.votes.numpy(),
        np.asarray(trackers["ref"]._checker.board.votes))


def _count_calls(monkeypatch, obj, name: str) -> list:
    """Wrap ``obj.name`` so that each call is noted in the returned list."""
    calls = []
    real = getattr(obj, name)

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(obj, name, counted)
    return calls


@pytest.mark.parametrize("seed", range(3))
def test_sync_drain_is_one_staged_call(seed, monkeypatch):
    """Wide single-round drains whose span holds several active 4096-slot
    segments (with gaps between them and a narrow last one), fed ranged,
    per-slot and packed votes, some slots below quorum: every drain makes
    ONE staged K1 call (``check_staged``) and reports what the dict
    oracle and the JAX tracker report."""
    rng = np.random.default_rng(700 + seed)
    port = _tracker(window=1 << 17, min_device_slots=1)
    calls = _count_calls(monkeypatch, port.checker, "check_staged")
    trackers = [qt.DictQuorumTracker(CONFIG), port,
                jqt.TpuQuorumTracker(_jax_config(), window=1 << 17,
                                     min_device_slots=1)]
    cursor = 0
    for d in range(6):
        span = int(rng.integers(4097, 3 * 4096 + 700))
        events = []
        for seg_start in range(cursor, cursor + span, 4096):
            if seg_start != cursor and rng.random() < 0.3:
                continue  # an inactive segment: a gap
            width = int(rng.integers(1, min(4096, cursor + span - seg_start)
                                     + 1))
            for acc in range(3):
                if rng.random() < 0.9:
                    events.append(("range", seg_start, seg_start + width,
                                   acc))
        for _ in range(int(rng.integers(0, 40))):
            events.append(("vote", cursor + int(rng.integers(0, span)),
                           int(rng.integers(0, 3))))
        packed = np.sort(rng.choice(span, size=30, replace=False)) + cursor
        events.append(("votes", packed, int(rng.integers(0, 3))))
        events.append(("vote", cursor + span - 1, 0))
        for t in trackers:
            for event in events:
                if event[0] == "range":
                    t.record_range(event[1], event[2], 0, 0, event[3])
                elif event[0] == "vote":
                    t.record(event[1], 0, 0, event[2])
                else:
                    t.record_votes(event[1], np.zeros(event[1].size,
                                                      np.int32), 0, event[2])
        got = [sorted(t.drain()) for t in trackers]
        assert got[0] == got[1] == got[2], (seed, d)
        assert len(calls) == d + 1
        cursor += span


def _epoch_drain_events(rng, drain: int, handover: int, members) -> list:
    """One drain of the epoch tracker's traffic: ranged runs of 40-200
    slots from three voters (a stranger among them now and then), and
    per-slot duplicates and stragglers, several 256-vote chunks a drain;
    slots on both sides of ``handover`` after drain 2."""
    events = []
    base = drain * 150
    for _ in range(int(rng.integers(1, 4))):
        start = base + int(rng.integers(0, 100))
        end = start + int(rng.integers(40, 200))
        for acc in range(3):
            voter = members[start >= handover][acc] \
                if rng.random() < 0.95 else "stranger"
            events.append(("range", start, end, int(rng.integers(0, 2)),
                           voter))
    for _ in range(int(rng.integers(0, 120))):
        slot = base + int(rng.integers(-100, 200))
        events.append(("vote", max(slot, 0), int(rng.integers(0, 2)),
                       members[slot >= handover][int(rng.integers(0, 3))]))
    return events


@pytest.mark.parametrize("seed", range(3))
def test_epoch_tracker_drain_is_one_staged_call(seed, monkeypatch):
    """Drains of several 256-vote chunks (duplicates across chunks, a
    handover inside a drain, strangers): the port's cuda backend (plain
    versions) makes ONE ``record_and_check_run`` call a drain and reports,
    drain for drain and in order, what the JAX tpu tracker reports; the
    boards equal."""
    rng = np.random.default_rng(800 + seed)
    members = (("a0", "a1", "a2"), ("a0", "a1", "a3"))
    handover = 450
    port_store = EpochStore.from_members(members[0], f=1)
    ref_store = JEpochStore.from_members(members[0], f=1)
    port = EpochQuorumTracker(port_store, backend="cuda", window=1024,
                              device="cpu")
    ref = JEpochQuorumTracker(ref_store, backend="tpu", window=1024)
    calls = _count_calls(monkeypatch, port._checker, "record_and_check_run")
    busy = 0
    for drain in range(8):
        if drain == 3:
            port_store.add(EpochConfig(epoch=1, start_slot=handover, f=1,
                                       members=members[1]))
            ref_store.add(JEpochConfig(epoch=1, start_slot=handover, f=1,
                                       members=members[1]))
            port.note_epochs()
            ref.note_epochs()
        for kind, *args in _epoch_drain_events(rng, drain, handover,
                                               members):
            for t in (port, ref):
                (t.record_range if kind == "range" else t.record)(*args)
        votes = len(port._slots)
        got, want = port.drain(), ref.drain()
        assert got == want, (seed, drain)
        busy += votes > 256
        assert len(calls) == drain + 1
    assert busy >= 4
    board = convert.vote_board_to_numpy(port._checker.board)
    for name, ref_arr in zip(board._fields, ref._checker.board):
        np.testing.assert_array_equal(getattr(board, name),
                                      np.asarray(ref_arr))


@pytest.mark.parametrize("seed", range(2))
def test_geo_tracker_drain_is_one_staged_call(seed, monkeypatch):
    """The geo tracker on drains of several 256-vote chunks across a
    steal: ONE ``record_and_check_run`` call a drain on the port's cuda
    backend (plain versions), and the JAX tpu tracker's reports, drain
    for drain and in order."""
    from frankenpaxos_tpu_torch.geo import GeoQuorumTracker, ObjectEpochStore
    from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch
    from frankenpaxos_tpu_torch.quorums import ZoneGrid

    from frankenpaxos_tpu import geo as jgeo
    from frankenpaxos_tpu.geo import epochs as jepochs
    from frankenpaxos_tpu.quorums import ZoneGrid as JZoneGrid

    grid_rows = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    store, jstore = ObjectEpochStore(1, [0]), jepochs.ObjectEpochStore(1, [0])
    port = GeoQuorumTracker(store, 0, ZoneGrid(grid_rows), backend="cuda",
                            window=1024, device="cpu")
    ref = jgeo.GeoQuorumTracker(jstore, 0, JZoneGrid(grid_rows),
                                backend="tpu", window=1024)
    calls = _count_calls(monkeypatch, port._checker, "record_and_check_run")
    rng = np.random.default_rng(900 + seed)
    for drain in range(6):
        if drain == 2:
            for st, cls in ((store, GeoEpoch), (jstore, jepochs.GeoEpoch)):
                st.offer(cls(group=0, epoch=1, start_slot=330, home_zone=1,
                             ballot=4))
            port.note_epochs()
            ref.note_epochs()
        for _ in range(int(rng.integers(300, 900))):
            slot = drain * 110 + int(rng.integers(0, 160))
            entry = store.epoch_of_slot(0, slot)
            ballot = entry.ballot if rng.random() < 0.9 else 0
            row = grid_rows[entry.home_zone] if rng.random() < 0.85 \
                else grid_rows[int(rng.integers(0, 3))]
            acceptor = row[int(rng.integers(0, 3))]
            for t in (port, ref):
                t.record(slot, ballot, acceptor)
        assert port.drain() == ref.drain(), (seed, drain)
        assert len(calls) == drain + 1


def test_epoch_tracker_refuses_the_tpu_backend():
    store = EpochStore.from_members(("a0", "a1", "a2"), f=1)
    with pytest.raises(ValueError, match="'dict' and 'cuda'"):
        EpochQuorumTracker(store, backend="tpu")


# --- bench/tracker_lt.py -----------------------------------------------------------


def test_tracker_lt_every_arm_matches_its_oracle():
    """The bench end to end at a small size on the plain versions (the
    same ratios of window, drain and lag as its full width): every arm
    agrees with its dict oracle (``run`` raises otherwise)."""
    out = tracker_lt.run("cpu", slots=1 << 14, grid_slots=1 << 13,
                         window=1 << 12, drain=1024, handover=1 << 13,
                         widths=(1, 64))
    for arm in ("sync", "pipelined", "epoch", "dict", "epoch_dict"):
        assert out["arms"][arm]["chosen"] == 1 << 14, arm
    assert out["arms"]["grid"]["chosen"] == 1 << 13
    assert [row["width"] for row in out["crossover"]] == [1, 64]
    stream = tracker_lt.make_stream(1 << 14, 3, drain=1024)
    assert stream == tracker_lt.make_stream(1 << 14, 3, drain=1024)
    late = [e for events in stream for e in events if e[0] == "vote"]
    share = len(late) / tracker_lt.count_votes(stream)
    assert 0.08 < share < 0.14
    assert out["per_slot_share"] == tracker_lt.per_slot_share(stream) \
        == share


def test_tracker_lt_oracle_check_catches_a_fault():
    oracle = [(1, 0), (2, 0)]
    tracker_lt.check_against_oracle("ok", [(2, 0), (1, 0)], oracle)
    for bad in ([(1, 0)], [(1, 0), (2, 0), (2, 0)], [(1, 0), (2, 1)]):
        with pytest.raises(RuntimeError):
            tracker_lt.check_against_oracle("bad", bad, oracle)


def test_tracker_lt_refuses_off_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "frankenpaxos_tpu_torch.bench.tracker_lt"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["degraded"] is True and "arms" not in out
