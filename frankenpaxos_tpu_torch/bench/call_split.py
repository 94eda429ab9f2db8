"""Host time of the K18, K12, K10, K11, K5, K6, K8 and K7 call paths,
split by function, on one GPU.

Each path is the real wrapper or entry, called ``CALLS`` times:

  * ``whole_ns``: host ns per call, one synchronise at the end;
  * ``split_ns``: the same calls under ``cProfile``, each function's own
    time (the time in its body, not in what it calls) in ns per call,
    the largest ``TOP`` by name and the rest summed; ``profiled_ns`` is
    their sum. A C call that ``cProfile`` does not see as a function (a
    ``ctypes`` call, a numpy slice assignment) counts in its caller's
    own time. The profiler adds its own cost to every function it
    times, so the split says where the time goes and ``whole_ns`` what
    a call costs.

Paths (at the main paths' shapes): ``link_keep_mask_tensor`` at n =
32768 over a [1001, 1001] up-matrix (the FIFO arm's wave), and
``quorum_watermark`` on the [2, 3] strided rows of a GC role's [3, 2]
frontier matrix, q = 2; their transport-facing entries
``link_keep_mask_cuda`` at n = 256 (a jitter-free storm wave) and n =
32768, and ``quorum_watermark_vector`` on a [3, 2] int64 matrix, q = 2.
Beside them, host ns per call of the one PyTorch call computing each
function (``up[src, dst]``, ``torch.kthvalue``), of the public forms of
the current stream's handle, and of the wait after a download (the
stream's synchronise against an event's).

The dependency-set paths (``depset``), each a decision of a protocol:
``device_deps.union_many`` (the SimpleBPaxos Leader's quorum union,
K10), ``device_deps.conflict_max_many`` (the EPaxos slow path, K10 in
its seq mode) and ``device_deps.all_identical`` (the EPaxos fast path,
K11), replayed in turn over the first ``CAPTURE`` calls that a short run
of each sim's cuda backend made (``bench/bpaxos_sim.py``'s
simple-conflict25 and ``bench/epaxos_sim.py``'s conflict25 workloads of
``CAPTURE_COMMANDS`` commands: the sims' own sets), with the histogram of
their ``[B, L, W]`` shapes; the staged entries alone
(``depset.union_packed``, ``all_equal_packed``) on one packed block of
each path, where the tree has them; and ``bench/depset_lt.py``'s
``coalesced_aggregate`` on one drain at each in-flight width (256, 1024,
4096: K10 on ``[width, 3, 32]``).

The vote-board paths (``board``): ``GeoQuorumTracker.release`` (K5)
and ``GeoQuorumTracker.drain`` (K6, with the releases held before it
where the tree holds them), replayed from the first ``CAPTURE`` drain
and release calls that a ``bench/geo_lt.py`` cuda run made (every arm,
the reference's deployment), each leader's tracker replayed onto a
fresh tracker of its own with the votes recorded between its calls
(recording untimed); host ns per call of each kind, whole and split,
and the histogram of the release calls' widths. Beside them the
pipelined ``TpuQuorumTracker``'s ``drain()`` and ``collect()`` on
``bench/tracker_lt.py``'s stream (``bench/launch_shapes.py``'s
``board_drains``: whole and split, each dispatch collected right after
its drain), and the parts its drains carry: dense blocks, scatter
chunks, segments (runs of one kind, in order) and checker calls a
drain, whatever form the tree dispatches them in.

The recovery and handover paths (``recovery``): the MultiPaxos
Leader's ``_recover_values`` with ``phase1_backend="cuda"`` on the
failover arm's recovery window (``bench/multipaxos_sim.py``: f = 1, one
group; the two Phase1bs of a quorum, each reporting a round-0 vote of
its own command batch for every slot of ``[0, rows)``) at 2^13 rows (the
smoke's window) and 2^16 (the bench's), ``RECOVERY_ROWS`` times
each on one Leader: the host seconds of its parts (``last_recovery``:
building the matrices, the K8 call, mapping ids back), medians and
minima, and the values checked against the host path's; and
``EpochSegmentedChecker.add_epoch`` (K7's reshape of the live board and
the host work around it) on tracker_lt's epoch checker (window 2^14, the
universe widened from three acceptors to four), host ns per call over
``HANDOVERS`` fresh checkers, each synchronised before the next.

It times the calls, not copies of them, so it splits any checkout's
wrappers alike: ``--tree ROOT`` imports ``frankenpaxos_tpu_torch`` from
``ROOT`` (another commit, for an A/B in one call), else from this
checkout. Run from the root of a checkout::

    python frankenpaxos_tpu_torch/bench/call_split.py [--tree ROOT] \\
        [--paths k12_k18,depset,board,recovery]

``--first-recovery ROWS`` instead times the FIRST recovery of a
process (:func:`first_recovery`; run it in a fresh one), which pays
what later ones reuse: the staging, the pinned blocks, the device
buffers. Run it in turns, a fresh process each, to compare two trees.

It prints ONE JSON line; ``chip_smoke.py``'s phase 28 calls
:func:`split` on its own tree. It raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import cProfile
import itertools
import json
import os
import pstats
import random
import sys
import time

import numpy as np
import torch

CALLS = 2000
TOP = 12
ZONES = 1000
WAVES = (256, 32768)
SEED = 20261017
#: Calls of each dependency-set path kept from a sim's run, and the
#: commands of that run.
CAPTURE = 512
CAPTURE_COMMANDS = 2048
#: depset_lt's in-flight widths; its drains cost ~1 ms of host each, so
#: they are timed over fewer calls.
COALESCED_WIDTHS = (256, 1024, 4096)
COALESCED_CALLS = 200
PARTS = ("k12_k18", "depset", "board", "recovery")
#: The failover arm's recovery windows, and the replays of each.
RECOVERY_ROWS = {1 << 13: 40, 1 << 16: 12}
HANDOVERS = 400


def _whole(fn, calls: int = CALLS) -> float:
    """Host ns per call of ``fn()`` over ``calls`` calls, unsplit, with
    one synchronise at the end."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls


def _label(path: str, name: str) -> str:
    """``name`` with the module it is defined in, from the package or
    library directory down (a C function has no file)."""
    if path == "~":
        return name
    parts = path.replace(os.sep, "/").split("/")
    for root in ("frankenpaxos_tpu_torch", "torch", "numpy"):
        if root in parts:
            cut = len(parts) - 1 - parts[::-1].index(root)
            return "/".join(parts[cut:]) + ":" + name
    return os.path.basename(path) + ":" + name


def _split(fn, calls: int = CALLS) -> dict:
    """``fn()`` ``calls`` times under ``cProfile``: each function's own
    ns per call, the largest ``TOP`` and the rest."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    profile = cProfile.Profile()
    profile.enable()
    for _ in range(calls):
        fn()
    profile.disable()
    torch.cuda.synchronize()
    here = os.path.abspath(__file__)
    own: dict = {}
    for (path, _, name), (_, _, tottime, _, _) in \
            pstats.Stats(profile).stats.items():
        if os.path.abspath(path) == here or "_lsprof.Profiler" in name:
            continue
        label = _label(path, name)
        own[label] = own.get(label, 0.0) + tottime * 1e9 / calls
    ranked = sorted(own.items(), key=lambda kv: -kv[1])
    split_ns = dict(ranked[:TOP])
    split_ns["(the rest)"] = sum(v for _, v in ranked[TOP:])
    return {"profiled_ns": sum(own.values()), "split_ns": split_ns}


def _inputs():
    rng = np.random.default_rng(SEED)
    up = rng.random((ZONES + 1, ZONES + 1)) >= 0.2
    up[ZONES, :] = True
    up[:, ZONES] = True
    ids = {n: tuple(rng.integers(-1, ZONES, n).astype(np.int32)
                    for _ in range(2)) for n in WAVES}
    frontiers = rng.integers(0, 1 << 14, size=(3, 2))
    return up, ids, frontiers


def _paths(dev, up_np, ids, frontiers) -> dict:
    """``{path: fn}``: each wrapper and entry called as the main paths
    call it."""
    from frankenpaxos_tpu_torch.ops import simwave as tsw, watermark as tw

    src, dst = (torch.from_numpy(a).to(dev) for a in ids[max(WAVES)])
    up = torch.from_numpy(up_np).to(dev)
    w = torch.from_numpy(frontiers.astype(np.int32)).to(dev).t()
    return {
        "link_keep_mask_tensor": lambda: tsw.link_keep_mask_tensor(
            src, dst, up),
        "quorum_watermark": lambda: tw.quorum_watermark(w, 2),
        **{f"link_keep_mask_cuda/n={n}":
           (lambda n=n: tsw.link_keep_mask_cuda(*ids[n], up_np))
           for n in WAVES},
        "quorum_watermark_vector": lambda: tw.quorum_watermark_vector(
            frontiers, 2),
    }


def _library_calls(dev, up_np, ids, frontiers) -> dict:
    """Host ns per call of the one PyTorch call that computes each
    kernel's function at the same shapes (``up[src, dst]`` with in-range
    int64 ids; ``torch.kthvalue``)."""
    up = torch.from_numpy(up_np).to(dev)
    src, dst = (torch.from_numpy(a.astype(np.int64) % (ZONES + 1)).to(dev)
                for a in ids[max(WAVES)])
    w = torch.from_numpy(frontiers.astype(np.int32)).to(dev).t()
    k = w.shape[-1] - 2 + 1
    return {"up[src, dst]": _whole(lambda: up[src, dst]),
            "torch.kthvalue": _whole(
                lambda: torch.kthvalue(w, k, dim=-1))}


def _stream_and_wait(dev) -> dict:
    """Host ns per call of each public stream-handle form, and of the
    wait after a 32 KB download: the stream's synchronise against an
    event recorded after the copy."""
    index = dev.index if dev.index is not None else 0
    forms = {
        "current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(index).cuda_stream,
        "current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "current_device()": torch.cuda.current_device,
    }
    if hasattr(getattr(torch, "accelerator", None), "current_stream") \
            and hasattr(torch.Stream, "native_handle"):
        forms["accelerator.current_stream(index).native_handle"] = \
            lambda: torch.accelerator.current_stream(index).native_handle
    out = {name: _whole(fn) for name, fn in forms.items()}
    src = torch.zeros(32768, dtype=torch.bool, device=dev)
    host = torch.empty(32768, dtype=torch.bool, pin_memory=True)
    event = torch.cuda.Event()
    stream = torch.cuda.current_stream(dev)

    def by_stream():
        host.copy_(src, non_blocking=True)
        stream.synchronize()

    def by_event():
        host.copy_(src, non_blocking=True)
        event.record(stream)
        event.synchronize()

    out["download + stream.synchronize()"] = _whole(by_stream)
    out["download + event.record(); event.synchronize()"] = _whole(by_event)
    return out


def _dep_shape(sets: list, columns: int) -> str:
    """The ``[B, L, W]`` that ``device_deps`` gives ``sets`` (W 0 past
    ``MAX_TAIL_WINDOW``: the host algebra)."""
    values = [v for s in sets for c in s.columns for v in c.values]
    spread = max(values) - min(values) + 1 if values else 1
    width = max(8, 1 << (spread - 1).bit_length())
    return str([len(sets), columns, width if width <= 2048 else 0])


def capture(dev, commands: int = CAPTURE_COMMANDS,
            keep: int = CAPTURE) -> dict:
    """``{path: [(args, kwargs)]}``: the first ``keep`` calls of each
    ``device_deps`` path that the sims' cuda runs make (SimpleBPaxos's
    Leader: ``union_many``; EPaxos: ``conflict_max_many`` and
    ``all_identical``) on workloads of ``commands`` commands with 25%
    conflicts, deep-copied, without the runtime metrics."""
    from frankenpaxos_tpu_torch.bench import bpaxos_sim, epaxos_sim
    from frankenpaxos_tpu_torch.protocols.epaxos import device_deps

    store: dict = {name: [] for name in ("union_many", "conflict_max_many",
                                         "all_identical")}
    originals = {name: getattr(device_deps, name) for name in store}

    def spy(name):
        def call(*args, **kwargs):
            if len(store[name]) < keep:
                store[name].append((copy.deepcopy(args), {
                    k: v for k, v in kwargs.items() if k != "metrics"}))
            return originals[name](*args, **kwargs)

        return call

    try:
        for name in store:
            setattr(device_deps, name, spy(name))
        bpaxos_sim.drive_simple(dev, "cuda", bpaxos_sim.workload(
            0.25, commands, 0), 0)
        epaxos_sim.drive(dev, "cuda", epaxos_sim.workload(
            0.25, commands, 0), 0)
    finally:
        for name, fn in originals.items():
            setattr(device_deps, name, fn)
    return store


def _replay(fn, calls: list):
    """A function that makes the next of ``calls`` (in a cycle) to
    ``fn``."""
    replay = itertools.cycle(calls)

    def call():
        args, kwargs = next(replay)
        return fn(*args, **kwargs)

    return call


def _staged_entries(calls_by_path: dict) -> dict:
    """``{path: fn}``: the staged entries alone (where the tree has
    them), each on the block of its path's first captured call, packed
    at the first call of ``fn`` (the block lives in the card's reused
    staging, so a path is timed whole before the next one packs)."""
    from frankenpaxos_tpu_torch.ops import depset
    from frankenpaxos_tpu_torch.protocols.epaxos import device_deps

    if not hasattr(device_deps, "pack"):
        return {}
    out = {}
    for name, entry in (("union_many", depset.union_packed),
                        ("conflict_max_many", depset.union_packed),
                        ("all_identical", depset.all_equal_packed)):
        args, kwargs = calls_by_path[name][0]
        if name == "union_many":
            sets, seqs = args[0], None
        else:
            sets = [deps for _, deps in args[0]]
            seqs = [seq for seq, _ in args[0]] if name != "all_identical" \
                else None
        block = []

        def call(sets=sets, seqs=seqs, args=args, kwargs=kwargs,
                 entry=entry, block=block):
            if not block:
                block.append(device_deps.pack(
                    sets, args[1], kwargs["device"] if "device" in kwargs
                    else args[2], seqs=seqs))
            return entry(block[0])

        label = "union_packed" if entry is depset.union_packed \
            else "all_equal_packed"
        out[f"{label}/{_dep_shape(sets, args[1])}"] = call
    return out


def _depset_paths(dev) -> tuple[dict, dict]:
    """``({path: (fn, calls)}, {path: shape histogram})``: each
    dependency-set path as a replay of its captured calls, one call of
    ``fn`` a decision, and depset_lt's coalesced arm per width."""
    from frankenpaxos_tpu_torch.bench import depset_lt
    from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
    from frankenpaxos_tpu_torch.runs import depruns

    paths, shapes = {}, {}
    calls_by_path = capture(dev)
    for name, calls in calls_by_path.items():
        if not calls:
            raise RuntimeError(f"the sims never called device_deps.{name}")
        paths[name] = (_replay(getattr(device_deps, name), calls), CALLS)
        hist: dict = {}
        for args, _ in calls:
            sets = args[0] if name == "union_many" \
                else [deps for _, deps in args[0]]
            key = _dep_shape(sets, args[1])
            hist[key] = hist.get(key, 0) + 1
        shapes[name] = hist
    staged = _staged_entries(calls_by_path)
    paths.update({name: (fn, CALLS) for name, fn in staged.items()})
    rng = random.Random(SEED)
    for width in COALESCED_WIDTHS:
        messages = depset_lt.make_drain(width, rng)
        columns = depruns.sets_to_columns([m.dependencies
                                           for m in messages])
        seqs = np.asarray([m.sequence_number for m in messages],
                          dtype=np.int32)
        paths[f"coalesced_aggregate/width={width}"] = (
            lambda columns=columns, seqs=seqs:
            depset_lt.coalesced_aggregate(columns, seqs, dev),
            COALESCED_CALLS)
    return paths, shapes


def capture_geo(dev, keep: int = CAPTURE) -> list:
    """``[(tracker, kind, args)]``: the calls that a ``geo_lt`` cuda run
    makes on its leaders' ``GeoQuorumTracker`` s (``record``, and the
    first ``keep`` of ``drain`` and ``release`` together), ``tracker``
    the index of the tracker in order of its first call."""
    from frankenpaxos_tpu_torch.bench import geo_lt
    from frankenpaxos_tpu_torch.geo import GeoQuorumTracker

    calls: list = []
    ids: dict = {}
    kept = [0]
    originals = {name: getattr(GeoQuorumTracker, name)
                 for name in ("record", "drain", "release")}

    def spy(name):
        def call(self, *args):
            if self.backend == "cuda" and kept[0] < keep:
                key = ids.setdefault(id(self), len(ids))
                if name != "record":
                    kept[0] += 1
                calls.append((key, name, copy.deepcopy(args)))
            return originals[name](self, *args)

        return call

    try:
        for name in originals:
            setattr(GeoQuorumTracker, name, spy(name))
        geo_lt.backend_run("cuda", dev, geo_lt.WRITES, geo_lt.FLAT_COMMANDS,
                           geo_lt.FLAT_REPS, 0)
    finally:
        for name, fn in originals.items():
            setattr(GeoQuorumTracker, name, fn)
    return calls


def _geo_replay(dev, calls: list, profiled: bool) -> dict:
    """Replay ``calls`` onto fresh trackers (one per captured tracker,
    group 0 of a one-epoch store on the 3x3 grid), timing (or profiling)
    only ``drain`` and ``release``: host ns per call of each."""
    from frankenpaxos_tpu_torch.geo import GeoQuorumTracker, ObjectEpochStore
    from frankenpaxos_tpu_torch.quorums import ZoneGrid

    grid = ZoneGrid([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    trackers: dict = {}
    ns = {"drain": 0, "release": 0}
    count = {"drain": 0, "release": 0}
    profile = cProfile.Profile() if profiled else None
    torch.cuda.synchronize()
    for key, name, args in calls:
        tracker = trackers.get(key)
        if tracker is None:
            tracker = trackers[key] = GeoQuorumTracker(
                ObjectEpochStore(1, [0]), 0, grid, backend="cuda",
                device=dev)
            torch.cuda.synchronize()
        fn = getattr(tracker, name)
        if name == "record":
            fn(*args)
            continue
        if profile is not None:
            profile.enable()
            fn(*args)
            profile.disable()
        else:
            t0 = time.perf_counter_ns()
            fn(*args)
            ns[name] += time.perf_counter_ns() - t0
        count[name] += 1
    torch.cuda.synchronize()
    return {"ns": ns, "count": count, "profile": profile}


def _geo_paths(dev) -> dict:
    """The board paths' figures (see the module docstring)."""
    calls = capture_geo(dev)
    widths: dict = {}
    between, pending = [], 0
    for _, name, args in calls:
        if name == "release":
            width = len(args[0])
            widths[width] = widths.get(width, 0) + 1
            pending += 1
        elif name == "drain":
            between.append(pending)
            pending = 0
    _geo_replay(dev, calls, False)  # warm: builds, first calls
    whole = _geo_replay(dev, calls, False)
    profiled = _geo_replay(dev, calls, True)
    here = os.path.abspath(__file__)
    own: dict = {}
    calls_made = sum(profiled["count"].values())
    for (path, _, name), (_, _, tottime, _, _) in \
            pstats.Stats(profiled["profile"]).stats.items():
        if os.path.abspath(path) == here or "_lsprof.Profiler" in name:
            continue
        label = _label(path, name)
        own[label] = own.get(label, 0.0) + tottime * 1e9 / calls_made
    ranked = sorted(own.items(), key=lambda kv: -kv[1])
    split_ns = dict(ranked[:TOP])
    split_ns["(the rest)"] = sum(v for _, v in ranked[TOP:])
    return {
        "calls": whole["count"],
        "whole_ns_per_call": {k: whole["ns"][k] / max(whole["count"][k], 1)
                              for k in whole["ns"]},
        "profiled_ns_per_call": sum(own.values()),
        "split_ns_per_call": split_ns,
        "release_width_histogram": {str(k): widths[k]
                                    for k in sorted(widths)},
        "releases_before_each_drain_histogram": {
            str(k): between.count(k) for k in sorted(set(between))},
    }


def _drain_parts(dev) -> dict:
    """Per drain of the pipelined tracker on tracker_lt's stream: its
    dense blocks, scatter chunks and segments, and the checker calls
    that dispatch them (a board run, where the tree has it, is one; a
    dense run and each chunk are one each otherwise); means and the
    histogram of chunks a drain."""
    from frankenpaxos_tpu_torch.bench import tracker_lt as lt
    from frankenpaxos_tpu_torch.bench.launch_shapes import _feed
    from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
        TpuQuorumTracker,
    )

    tracker = TpuQuorumTracker(lt.make_config(), window=lt.WINDOW,
                               pipelined=True, device=dev)
    rows = []
    for events in lt.make_stream(lt.SLOTS, 3, lt.DRAIN):
        _feed(tracker, events, 3)
        tracker.drain()
        while (dispatch := tracker.take_dispatch()) is not None:
            kinds, calls = [], 0
            for part in dispatch:
                if part[0] == "board":  # one board run: its items
                    calls += 1
                    kinds += [(item[0], len(item[1]) if item[0] == "run"
                               else 1) for item in part[1]]
                else:  # a dense run or a chunk, each a call
                    calls += 1
                    kinds.append((part[0], len(part[1]) if part[0] == "run"
                                  else 1))
            segments = sum(1 for k, (kind, _) in enumerate(kinds)
                           if k == 0 or kinds[k - 1][0] != kind)
            rows.append((sum(c for kind, c in kinds if kind == "run"),
                         sum(c for kind, c in kinds if kind == "votes"),
                         segments, calls))
            tracker.collect(dispatch)
    torch.cuda.synchronize()
    arr = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
    chunks = arr[:, 1].tolist()
    return {"drains": len(rows),
            "mean_per_drain": dict(zip(
                ("dense_blocks", "sparse_chunks", "segments",
                 "checker_calls"), arr.mean(0).tolist())),
            "drains_with_chunks": int((arr[:, 1] > 0).sum()),
            "chunks_histogram": {str(k): chunks.count(k)
                                 for k in sorted(set(chunks))}}


def _failover_phase1(rows: int):
    """The Phase1 a new Leader of the failover arm gathers: the Phase1bs
    of acceptors 0 and 1 (a quorum of f = 1), each a round-0 vote of
    its own command batch for every slot of ``[0, rows)``."""
    from frankenpaxos_tpu_torch.protocols.multipaxos import messages as tm
    from frankenpaxos_tpu_torch.protocols.multipaxos.leader import _Phase1

    values = [tm.CommandBatch((tm.Command(tm.CommandId("c", 0, slot),
                                          b"f%d" % slot),))
              for slot in range(rows)]
    phase1bs = [{
        acceptor: tm.Phase1b(group_index=0, acceptor_index=acceptor,
                             round=1, info=tuple(
                                 tm.Phase1bSlotInfo(slot=slot, vote_round=0,
                                                    vote_value=values[slot])
                                 for slot in range(rows)))
        for acceptor in (0, 1)}]
    return _Phase1(phase1bs=phase1bs, phase1b_acceptors=set(),
                   pending_batches=[], resend_phase1as=None)


def _recovery_paths(dev) -> dict:
    """The Leader's recovery at each window and the epoch handover (the
    module docstring)."""
    import statistics

    from frankenpaxos_tpu_torch.ops import quorum as tq
    from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
        make_multipaxos,
    )
    from frankenpaxos_tpu_torch.quorums import SimpleMajority

    out: dict = {}
    host = make_multipaxos(f=1, phase1_backend="host").leaders[0]
    leader = make_multipaxos(f=1, phase1_backend="cuda",
                             device=dev).leaders[0]
    host.chosen_watermark = leader.chosen_watermark = 0
    for rows, replays in RECOVERY_ROWS.items():
        phase1 = _failover_phase1(rows)
        want = host._recover_values(phase1, rows - 1)
        parts = {"build_s": [], "call_s": [], "map_s": []}
        for _ in range(replays):
            if leader._recover_values(phase1, rows - 1) != want:
                raise RuntimeError(f"the recovery of {rows} rows differs "
                                   f"from the host path's")
            for key, v in parts.items():
                v.append(leader.last_recovery[key])
        out[f"recovery/rows={rows}"] = {
            "shape": leader.last_recovery["shape"], "replays": replays,
            **{f"{key}_median": statistics.median(v)
               for key, v in parts.items()},
            **{f"{key}_min": min(v) for key, v in parts.items()}}
    members = ((0, 1, 2), (0, 1, 3))
    times = []
    for _ in range(HANDOVERS):
        checker = tq.EpochSegmentedChecker(
            [SimpleMajority(members[0]).write_spec()], [0],
            window=1 << 14, device=dev)
        checker.board  # the board made and flushed, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        checker.add_epoch(SimpleMajority(members[1]).write_spec(), 1 << 13)
        times.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
    out["handover/add_epoch"] = {
        "calls": HANDOVERS, "host_ns_median": statistics.median(times),
        "host_ns_min": min(times), "universe": list(checker.universe)}
    return out


def first_recovery(rows: int, device=None) -> dict:
    """The first and the second recovery of a cuda Leader in this
    process on the failover arm's window of ``rows`` rows, each checked
    against the host path: ``last_recovery``'s host seconds and their
    sum, and the seconds the cuda cluster took to build (what a Leader
    prepares for K8 at construction falls there). Before the Leader is
    made, the CUDA context exists and K8's
    library is loaded (a cluster's card has both by its first failover,
    the library's load aside); nothing else of K8 is."""
    from frankenpaxos_tpu_torch.device import nvidia_smi_line, \
        resolve_device
    from frankenpaxos_tpu_torch.ops import _build
    from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
        make_multipaxos,
    )

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the first recovery is timed on a card; got "
                           f"device {dev}")
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    _build.library("value")
    host = make_multipaxos(f=1, phase1_backend="host").leaders[0]
    t0 = time.perf_counter()
    leader = make_multipaxos(f=1, phase1_backend="cuda",
                             device=dev).leaders[0]
    cluster_s = time.perf_counter() - t0
    host.chosen_watermark = leader.chosen_watermark = 0
    phase1 = _failover_phase1(rows)
    want = host._recover_values(phase1, rows - 1)
    out = {"rows": rows, "device": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi_line(), "cluster_build_s": cluster_s}
    for which in ("first", "second"):
        if leader._recover_values(phase1, rows - 1) != want:
            raise RuntimeError(f"the {which} recovery of {rows} rows "
                               f"differs from the host path's")
        got = dict(leader.last_recovery)
        got["build_plus_call_s"] = got["build_s"] + got["call_s"]
        out[which] = got
    return out


def split(device=None, parts=PARTS) -> dict:
    """Every path's whole time and split on ``device`` (``cuda`` when
    None): the K12 / K18 paths (``k12_k18``) and the dependency-set
    paths (``depset``) of ``parts``."""
    from frankenpaxos_tpu_torch.device import nvidia_smi_line, \
        resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the call split times the CUDA call paths; "
                           f"got device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    import frankenpaxos_tpu_torch

    out = {
        "benchmark": "call_split",
        "package": os.path.dirname(os.path.abspath(
            frankenpaxos_tpu_torch.__file__)),
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": nvidia_smi_line(),
        "calls": CALLS,
        "paths": {},
    }
    if "k12_k18" in parts:
        up, ids, frontiers = _inputs()
        out["paths"].update(
            {name: {"whole_ns": _whole(fn), **_split(fn)}
             for name, fn in _paths(dev, up, ids, frontiers).items()})
        out["library_ns"] = _library_calls(dev, up, ids, frontiers)
        out["stream_and_wait_ns"] = _stream_and_wait(dev)
    if "board" in parts:
        from frankenpaxos_tpu_torch.bench.launch_shapes import board_drains

        out["board"] = _geo_paths(dev)
        out["pipelined"] = {**board_drains(dev),
                            "parts": _drain_parts(dev)}
    if "recovery" in parts:
        out["recovery"] = _recovery_paths(dev)
    if "depset" in parts:
        paths, out["depset_shapes"] = _depset_paths(dev)
        out["paths"].update(
            {name: {"calls": calls, "whole_ns": _whole(fn, calls),
                    **_split(fn, calls)}
             for name, (fn, calls) in paths.items()})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="import frankenpaxos_tpu_torch from this "
                             "checkout (default: this one)")
    parser.add_argument("--paths", default=",".join(PARTS),
                        help="comma-separated, of " + ",".join(PARTS))
    parser.add_argument("--first-recovery", type=int, default=None,
                        metavar="ROWS",
                        help="time this process's first recovery of ROWS "
                             "rows instead (first_recovery)")
    args = parser.parse_args(argv)
    root = args.tree or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(root))
    if args.first_recovery is not None:
        print(json.dumps(first_recovery(args.first_recovery)), flush=True)
        return 0
    print(json.dumps(split(parts=args.paths.split(","))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
