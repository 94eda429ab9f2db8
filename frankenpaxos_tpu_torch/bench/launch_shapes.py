"""K1, K2, K4-K8, K10, K13, K16's union and K19-K21 at the shapes the
paths launch them, and the host split of the tracker drains that call
them, on one GPU.

Parts, each against whichever checkout ``--tree`` names (this one by
default), so that one call can measure a parent and its change alike:

  * ``drains``: the host ns per ``drain()`` and each function's own ns
    per drain under ``cProfile`` (``bench/call_split.py``'s method: the
    whole call unprofiled, then the same calls profiled), with each
    function's calls per drain, for
      - ``TpuQuorumTracker``'s synchronous drain (K1) on
        ``bench/tracker_lt.py``'s stream at window 2^20 (the sync arm),
        and on contiguous ranged drains of 64, 256, 1024 and 4096 slots
        forced onto the device (the crossover's shape);
      - ``EpochQuorumTracker.drain`` (K6) on the epoch arm: the same
        stream with its handover at slot 2^19, window 2^14.
    Only ``drain()`` is timed and profiled; feeding the votes is not.
  * ``kernels``: CUDA-event ms per call and the profiler's device ms of
      - K1 ``quorum_hit`` at N = 3 (majority) and B = 64, 256, 1024, 4096
        (the synchronous tracker's buckets), 32768, 2^18 and 2^20 (where
        the block's bytes, not the launch, set the time), with the host
        ns per ``TpuQuorumChecker.check_block`` call at the same widths;
      - K6 ``record_and_check_epochs`` on one 256-lane chunk (N = 4,
        K = 2, window 2^14: the epoch arm after its handover; and over 16,
        64, 128 and 256 distinct columns; and at the sharded epoch
        board's shape: the rank of four that holds the chunk's first
        slot, a 2^12-column local board and the chunk's lanes localized
        by ``localize_lanes``) and on a drain of 48 chunks (12,288
        lanes): one run launch where the tree
        has ``record_and_check_epochs_run``, else 48 chunk calls; the
        host ns of ``EpochSegmentedChecker`` over the same 48 chunks
        (``record_and_check_run`` where the tree has it, else 48
        ``record_and_check`` calls);
      - K10 ``union_reduce`` at the BPaxos Leader's ``[2, 2, W]``, W in
        8, 64 and 2048 (its tail widths: the least, a middle one, the
        cap ``MAX_TAIL_WINDOW``) and at depset_lt's ``[4096, 3, 32]``;
        K10 in its seq mode at the EPaxos slow path's ``[4, 5, 8]``; K11
        at the fast path's ``[3, 5, 8]`` (``--parts depset`` measures
        these alone).
    Each with its bound: bytes (each input read once, each output
    written once) over 3.35 TB/s; K6's from the chunk's distinct
    columns.
  * ``board`` (the vote board's dense update and release):
      - K2 ``record_block`` by CUDA events and by the profiler's device
        time at N = 3 and B = 64, 256, 1024, 4096 (the pipelined
        tracker's buckets, each block starting at an unaligned column as
        a member slot does) and 32768, on the 2x3 grid at 4096, and at
        the sharded rank's shape (B = 4096 on a 2^18-column local
        board); a drain's dense blocks (three 4096-column blocks at
        unaligned starts): one launch of ``record_block_run`` where the
        tree has it, else three ``record_block`` calls;
      - K5 ``release`` at 1, 4, 16 and 256 lanes (the leaders' widths)
        and 4096 (the prewarm), and ``release_all`` (the all-valid form)
        where the tree has it;
      - K4 ``record_and_check`` on one 256-lane scatter chunk of the
        pipelined tracker (128 straggler slots, two votes each) and on
        runs of 1, 4 and 48 such chunks: one launch of
        ``record_and_check_run`` where the tree has it, else a call a
        chunk;
      - a pipelined drain's board updates whole, the tracker's calls on
        its checker: a chunk of older-round votes, three 4096-column
        dense blocks, three more chunks (leftovers and a newer round),
        then the results on the host: ONE ``board_run`` dispatch where
        the tree has it, else a ``dense_run`` dispatch between four
        ``record_and_check_async`` calls and their fetches; host ns per
        drain and the K2 / K4 launches and calls it makes;
      - the card's floor (PyTorch's fill of one element);
      - the host ns per pipelined ``drain()`` and per ``collect()`` on
        ``bench/tracker_lt.py``'s stream (window 2^20), whole and split
        by function under ``cProfile``, each dispatch collected on the
        caller's thread right after its drain.

Run from the root of a checkout::

    python frankenpaxos_tpu_torch/bench/launch_shapes.py [--tree ROOT] \\
        [--parts drains,kernels|depset|board|sharded|libbench|recovery|fast
         |matchmaker]

  * ``sharded`` (the sharded drain's kernels on one process, no ranks
    spawned): K19 ``shard_vote_count`` and K20 ``shard_commit`` at rank
    0's shape of each of ``chip_smoke.py`` phase 25's meshes ((1, 4) and
    (1, 3) majority-3, (2, 2) and (3, 1) 2x3 grid; window 2^20, block
    2^15), telemetry off and on, by CUDA events and the profiler, with
    the form each runs; K21 ``shard_fold`` on one drain and on runs of
    1, 8, 64 and 256 drains (one launch a run where the tree's K21 folds
    a run, else a launch a drain).

  * ``libbench`` (the libbench path's kernels): K13
    ``contiguous_prefix_length`` at ``[4096]`` (first False at 2048),
    ``[4096, 3]`` and the all-true ``[64, 100003]``; K16 ``union`` at
    ``[4096, 3, 64]`` aliased (libbench's ``union(deps, deps)``) and
    distinct, and at the sharded board's rank shape ``[1024, 3, 64]``;
    each by CUDA events, the profiler and the host clock, with the form
    it runs (None where the tree names none) and its bound, and the union
    beside the two-call PyTorch composite (``torch.maximum`` and ``|``).

  * ``recovery`` (the Leader's recovery and the epoch handover): K8
    ``safe_values`` through its tensor wrapper at ``[2^13, 3]`` (the
    smoke's failover window), ``[2^16, 3]`` (the bench's) and
    ``[2^16, 6]``, beside the PyTorch composite ``torch.max(dim=1)``,
    ``>`` and ``torch.gather``; the Leader's K8 call whole at 2^13 and
    2^16 rows, host ns: the tree's ``safe_values_staged`` on the matrices
    of ``recovery_matrices`` where the tree has it, else the parent's
    sequence (two pageable copies up, the wrapper, two ``.cpu()``
    reads), back to back and one call at a time after 20 ms of host
    sleep (the card idle, as while the Leader builds the matrices); K7
    ``reshape_columns`` at
    ``[3, 2^14] -> [4, 2^14]`` (tracker_lt's handover) and ``[3, 2^20]
    -> [4, 2^20]``, with the map on the card and (where the tree takes
    one) the numpy map in the call, beside ``index_select`` on a
    zero-padded block (the padding made once, outside the timing).

  * ``fast`` (K6's stateless ``check_batch_multi`` on the Fast Paxos
    path): one quorum check of a Fast MultiPaxos leader at f = 1 and
    f = 2 (``[1, 3]`` and ``[1, 5]``, K = 1, the classic spec), host ns a
    call: the tree's ``runs.quorums.SpecChecker("cuda").check`` where the
    tree has it, else the reference's ``"tpu"`` check body on the tree's
    ``MultiConfigQuorumChecker`` (``present_vector``, then
    ``check_batch`` of one row); host batches through
    ``MultiConfigQuorumChecker.check_batch`` at ``[256, 4]`` (K = 2) and
    ``[2^16, 5]`` (K = 3), host ns; the tensor wrapper on the card at
    the same two shapes, CUDA-event ms; each with the profiler's device
    ms and launches a call, its bound ((4N + 5) bytes a row over
    3.35 TB/s) and the card's floor (a one-element fill).

  * ``matchmaker`` (K6's stateless check on the Matchmaker MultiPaxos
    leader's phase 1): at ``[K, N]`` = ``[1, 6]``, ``[3, 6]``, ``[2, 10]``
    and ``[4, 10]`` (``MATCHMAKER_SHAPES``: K prior configurations over
    the vldb20 pools, ``matchmaker_specs``' read specs), one Phase1b's
    check, host ns a call measured in turns (A, B, B, A, three times,
    2000 calls each): the reference's ``"tpu"`` body (a ``[K, N]`` uint8
    batch of equal rows, then ``check_batch`` under ``arange(K)``) and,
    where the tree has it, ``MultiConfigQuorumChecker.check_all`` (one
    word under every plane); each with the profiler's device ms and
    launches a call and its bound; and the host ns of building a phase
    1's checker, with its parts (the planes' uploads, a pinned block, a
    ``torch.cuda.synchronize``).

It prints ONE JSON line, with the seconds the tree's kernels took to
build (0 when they were built before). It raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time
from types import SimpleNamespace

import numpy as np

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12
CALLS = 2000
TOP = 12
K1_WIDTHS = (64, 256, 1024, 4096, 32768, 1 << 18, 1 << 20)
TRACKER_WIDTHS = (64, 256, 1024, 4096)
TRACKER_DRAINS = 200
CHUNK = 256
RUN_CHUNKS = 48
EPOCH_WINDOW = 1 << 14
K10_WIDTHS = (8, 64, 2048)
#: depset_lt's coalesced drain at 4096 in flight; the EPaxos slow path's
#: quorum of four replies and fast path's three, over five columns.
K10_MANY_ROWS = (4096, 3, 32)
K10_SEQ_SHAPE = (4, 5, 8)
K11_SHAPE = (3, 5, 8)
K6_DISTINCT = (16, 64, 128, 256)
#: K2 at the pipelined tracker's buckets and the 2^20 board's 32768, and
#: K5 at the leaders' release widths and the prewarm's 4096.
K2_WIDTHS = (64, 256, 1024, 4096, 32768)
K5_WIDTHS = (1, 4, 16, 256, 4096)
BOARD_WINDOW = 1 << 20
SHARD_WINDOW = 1 << 18
#: A block's first column: a member slot, off the 16-byte grid.
K2_START = 4099
#: K4's runs of the tracker's 256-lane chunks.
K4_RUNS = (1, 4, 48)
#: The sharded drain's meshes at rank 0 (chip_smoke.py phase 25's), and
#: the block.
SHARD_MESHES = ((1, 4, "majority3"), (1, 3, "majority3"),
                (2, 2, "grid2x3"), (3, 1, "grid2x3"))
SHARD_BLOCK = 1 << 15
#: The runs K21 folds: a drain, multichip_lt's and phase 25's runs of 8,
#: and 64 and 256 (the slot table's rows).
FOLD_ROWS = (1, 8, 64, 256)


class DrainClock:
    """Times (or profiles) only the ``drain()`` calls it is handed."""

    def __init__(self, profiled: bool):
        self.profile = cProfile.Profile() if profiled else None
        self.ns = 0
        self.drains = 0

    def drain(self, tracker) -> list:
        if self.profile is not None:
            self.profile.enable()
            out = tracker.drain()
            self.profile.disable()
        else:
            t0 = time.perf_counter_ns()
            out = tracker.drain()
            self.ns += time.perf_counter_ns() - t0
        self.drains += 1
        self.last = out
        return out

    def split(self) -> dict:
        from frankenpaxos_tpu_torch.bench.call_split import _label

        here = os.path.abspath(__file__)
        own: dict = {}
        calls: dict = {}
        for (path, _, name), (_, ncalls, tottime, _, _) in \
                pstats.Stats(self.profile).stats.items():
            if os.path.abspath(path) == here or "_lsprof.Profiler" in name:
                continue
            label = _label(path, name)
            own[label] = own.get(label, 0.0) + tottime * 1e9 / self.drains
            calls[label] = calls.get(label, 0) + ncalls / self.drains
        ranked = sorted(own.items(), key=lambda kv: -kv[1])
        split_ns = dict(ranked[:TOP])
        split_ns["(the rest)"] = sum(v for _, v in ranked[TOP:])
        return {"profiled_ns_per_drain": sum(own.values()),
                "split_ns_per_drain": split_ns,
                "calls_per_drain": {k: calls[k] for k, _ in ranked[:TOP]}}


def _feed(tracker, events, row: int) -> None:
    for event in events:
        if event[0] == "range":
            _, start, end, rnd, acc = event
            tracker.record_range(start, end, rnd, acc // row, acc % row)
        else:
            _, slot, rnd, acc = event
            tracker.record(slot, rnd, acc // row, acc % row)


def _measure(make, replay) -> dict:
    """``replay(tracker, clock)`` on a fresh tracker unprofiled, then on
    another profiled: host ns per drain and the split."""
    import torch

    whole = DrainClock(False)
    replay(make(), whole)
    torch.cuda.synchronize()
    profiled = DrainClock(True)
    replay(make(), profiled)
    torch.cuda.synchronize()
    return {"drains": whole.drains, "whole_ns_per_drain":
            whole.ns / whole.drains, **profiled.split()}


def drains(device) -> dict:
    from frankenpaxos_tpu_torch.bench import tracker_lt as lt
    from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
        TpuQuorumTracker,
    )
    from frankenpaxos_tpu_torch.reconfig import (
        EpochConfig,
        EpochQuorumTracker,
        EpochStore,
    )

    config = lt.make_config()
    stream = lt.make_stream(lt.SLOTS, 3, lt.DRAIN)
    out = {}

    def sync_replay(tracker, clock):
        for events in stream:
            _feed(tracker, events, 3)
            clock.drain(tracker)

    out["sync_arm"] = _measure(
        lambda: TpuQuorumTracker(config, window=lt.WINDOW, device=device),
        sync_replay)
    for width in TRACKER_WIDTHS:
        def ranged(tracker, clock, width=width):
            for d in range(TRACKER_DRAINS):
                base = d * width
                for acc in range(3):
                    tracker.record_range(base, base + width, 0, 0, acc)
                if len(clock.drain(tracker)) != width:
                    raise RuntimeError(f"width {width}: a slot was missed")
        out[f"sync_ranged/width={width}"] = _measure(
            lambda: TpuQuorumTracker(config, window=1 << 14, device=device,
                                     min_device_slots=1), ranged)

    members = (("a0", "a1", "a2"), ("a0", "a1", "a3"))

    def epoch_replay(pair, clock):
        tracker, store = pair
        switched = False
        for d, events in enumerate(stream):
            if not switched and d * lt.DRAIN >= lt.HANDOVER:
                store.add(EpochConfig(epoch=1, start_slot=lt.HANDOVER, f=1,
                                      members=members[1]))
                tracker.note_epochs()
                switched = True
            for event in events:
                if event[0] == "range":
                    _, start, end, rnd, acc = event
                    tracker.record_range(start, end, rnd,
                                         members[start >= lt.HANDOVER][acc])
                else:
                    _, slot, rnd, acc = event
                    tracker.record(slot, rnd,
                                   members[slot >= lt.HANDOVER][acc])
            clock.drain(tracker)

    def make_epoch():
        store = EpochStore.from_members(members[0], f=1)
        return (EpochQuorumTracker(store, backend="cuda",
                                   window=EPOCH_WINDOW, device=device),
                store)

    whole = DrainClock(False)
    epoch_replay(make_epoch(), whole)
    profiled = DrainClock(True)
    epoch_replay(make_epoch(), profiled)
    out["epoch_arm"] = {"drains": whole.drains,
                        "whole_ns_per_drain": whole.ns / whole.drains,
                        **profiled.split()}
    out["votes_per_epoch_drain"] = lt.count_votes(stream) / len(stream)
    return out


def _cuda_ms(fn, calls: int = CALLS, warm: int = 20) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _host_ns(fn, calls: int = CALLS, warm: int = 20) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls


def _device_ms(fn, kernel, iters: int = 200):
    """Mean device ms per launch of kernels whose name holds ``kernel``
    (a string, or a tuple of them: any) in the profiler's CUDA trace, and
    the launches per call of ``fn``; None when the trace shows no device
    time."""
    import torch
    from torch.profiler import profile, ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    names = (kernel,) if isinstance(kernel, str) else kernel
    for evt in prof.key_averages():
        if any(k in evt.key for k in names) and evt.count:
            total += getattr(evt, "device_time_total", 0) or 0
            count += evt.count
    if not count or not total:
        return None, None
    return total / count / 1e3, count / iters


def kernels(device) -> dict:
    import torch
    from frankenpaxos_tpu_torch.ops import quorum as tq
    from frankenpaxos_tpu_torch.quorums import SimpleMajority
    from frankenpaxos_tpu_torch.quorums.spec import pad_specs

    rng = np.random.default_rng(SEED)
    out: dict = {"k1": {}, "k6": {}, "k10": {}}
    spec = SimpleMajority(range(3)).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device=device)
    checker = tq.TpuQuorumChecker(spec, window=1 << 14, device=device)
    for b in K1_WIDTHS:
        block = (rng.random((3, b)) < 0.6).astype(np.uint8)
        votes = torch.from_numpy(block).to(device)
        dev_ms, per_call = _device_ms(lambda: tq.quorum_hit(votes, pred),
                                      "quorum_hit")
        out["k1"][f"B={b}"] = {
            "call_ms": _cuda_ms(lambda: tq.quorum_hit(votes, pred)),
            "device_ms": dev_ms,
            "bound_ms": 4 * b / HBM_BYTES_PER_S * 1e3,
            "check_block_host_ns": _host_ns(
                lambda: checker.check_block(block), calls=500),
        }

    universe = tuple(range(4))
    planes = tq.make_multi_predicate(*pad_specs(
        [SimpleMajority(m).write_spec().reindexed(universe)
         for m in ((0, 1, 2), (0, 1, 3))]), device=device)
    bounds = torch.tensor([EPOCH_WINDOW // 2], dtype=torch.int32,
                          device=device)
    board = tq.make_vote_board(EPOCH_WINDOW, 4, device=device)
    kk, kg, kn = planes.masks.shape
    plane_bytes = 4 * kk * kg * kn + 4 * kk * kg + kk + 4 * (kk - 1)
    lanes_np = _epoch_lanes(rng, CHUNK * RUN_CHUNKS)
    lanes = torch.from_numpy(lanes_np).to(device)
    chunk = lanes[:, :CHUNK].contiguous()
    cols = len(np.unique(lanes_np[0, :CHUNK]))
    chunk_bytes = 21 * CHUNK + 2 * (9 + kn) * cols + plane_bytes
    dev_ms, per_call = _device_ms(
        lambda: tq.record_and_check_epochs(board, chunk, bounds, planes),
        "record_and_check_epochs")
    out["k6"]["chunk"] = {
        "lanes": CHUNK, "call_ms": _cuda_ms(
            lambda: tq.record_and_check_epochs(board, chunk, bounds,
                                               planes)),
        "device_ms": dev_ms, "bound_ms": chunk_bytes / HBM_BYTES_PER_S * 1e3,
        "distinct_columns": cols}
    # One chunk's device time against its distinct columns (each read
    # from the board and written back once): 256 lanes over 16 ... 256
    # columns.
    by_columns = {}
    for distinct in K6_DISTINCT:
        pick = rng.choice(EPOCH_WINDOW, size=distinct, replace=False)
        true = pick[rng.integers(0, distinct, size=CHUNK)]
        true[:distinct] = pick
        spread = torch.from_numpy(tq.pack_lanes(
            true, true, rng.integers(0, kn, size=CHUNK),
            np.zeros(CHUNK, np.int32), np.ones(CHUNK, bool))).to(device)
        by_columns[str(distinct)] = _device_ms(
            lambda: tq.record_and_check_epochs(board, spread, bounds,
                                               planes),
            "record_and_check_epochs")[0]
    out["k6"]["chunk"]["device_ms_by_distinct_columns"] = by_columns
    # The sharded epoch board's K6 launch: of four ranks, the one that
    # holds the chunk's first slot.
    ranks = 4
    w_local = EPOCH_WINDOW // ranks
    rank = int(lanes_np[0, 0]) // w_local
    shard = SimpleNamespace(size=ranks, rank=rank, columns=lambda window: (
        rank * (window // ranks), (rank + 1) * (window // ranks)))
    local, owned = tq.localize_lanes(lanes_np[:, :CHUNK], shard,
                                     EPOCH_WINDOW)
    local_board = tq.make_vote_board(w_local, 4, device=device)
    local_t = torch.from_numpy(np.ascontiguousarray(local)).to(device)
    out["k6"]["sharded_chunk"] = {
        "w_local": w_local, "ranks": ranks, "rank": rank,
        "owned_lanes": int(owned.sum()),
        "device_ms": _device_ms(
            lambda: tq.record_and_check_epochs(local_board, local_t, bounds,
                                               planes),
            "record_and_check_epochs")[0]}
    run_fn = getattr(tq, "record_and_check_epochs_run", None)
    if run_fn is not None:
        def run():
            run_fn(board, lanes, bounds, planes, CHUNK)
    else:
        chunks = [lanes[:, c * CHUNK:(c + 1) * CHUNK].contiguous()
                  for c in range(RUN_CHUNKS)]

        def run():
            for c in chunks:
                tq.record_and_check_epochs(board, c, bounds, planes)
    run_cols = sum(len(np.unique(lanes_np[0, c * CHUNK:(c + 1) * CHUNK]))
                   for c in range(RUN_CHUNKS))
    dev_ms, per_call = _device_ms(run, "record_and_check_epochs", iters=50)
    out["k6"]["run"] = {
        "chunks": RUN_CHUNKS, "form": "run" if run_fn else "chunk calls",
        "call_ms": _cuda_ms(run, calls=200),
        "device_ms_per_launch": dev_ms, "launches_per_run": per_call,
        "device_ms": None if dev_ms is None else dev_ms * per_call,
        "bound_ms": (21 * CHUNK * RUN_CHUNKS + 2 * (9 + kn) * run_cols
                     + plane_bytes) / HBM_BYTES_PER_S * 1e3}
    seg = tq.EpochSegmentedChecker(
        [SimpleMajority(m).write_spec() for m in (("a0", "a1", "a2"),
                                                  ("a0", "a1", "a3"))],
        [0, EPOCH_WINDOW // 2], window=EPOCH_WINDOW, device=device)
    slots = lanes_np[1].astype(np.int64)
    nodes, rounds = lanes_np[2], lanes_np[3]
    if hasattr(seg, "record_and_check_run"):
        def checker_run():
            seg.record_and_check_run(slots, nodes, rounds, chunk=CHUNK)
    else:
        def checker_run():
            for at in range(0, slots.size, CHUNK):
                seg.record_and_check(slots[at:at + CHUNK],
                                     nodes[at:at + CHUNK],
                                     rounds[at:at + CHUNK])
    out["k6"]["checker_run_host_ns"] = _host_ns(checker_run, calls=100)

    out.update(depset_kernels(device, rng))
    return out


def _bits_batch(rng, shape, device):
    """A ``[B, L, W]`` batch as the bridge packs the sims' sets: 0/1
    tail bytes (30% set) above watermarks near the window's base."""
    import torch
    from frankenpaxos_tpu_torch.ops import depset as td

    b, l, w = shape
    base = 1 << 12
    wm = base + rng.integers(-4, 4, size=(b, l)).astype(np.int32)
    tails = (rng.random((b, l, w)) < 0.3).astype(np.uint8)
    return td.DepSetBatch(torch.from_numpy(wm).to(device),
                          torch.from_numpy(tails).to(device),
                          torch.tensor(base, dtype=torch.int32).to(device))


#: K6's stateless kernels, by the names of each tree's forms.
K6_STATELESS_KERNELS = ("check_batch_multi_kernel", "multi_row_kernel",
                        "multi_tile_kernel")
#: The host batches of the ``fast`` part: ``(rows, nodes, planes)``.
FAST_BATCHES = ((256, 4, 2), (1 << 16, 5, 3))


def fast_planes(n: int, k: int) -> list:
    """``k`` specs over ``n`` nodes, each a majority of a different
    ``n - 1`` of them (plane 0 of ``n = 4, k = 2``: nodes 0-2)."""
    from frankenpaxos_tpu_torch.quorums.spec import ANY, QuorumSpec

    specs = []
    for i in range(k):
        masks = np.ones((1, n), dtype=np.uint8)
        masks[0, (n - 1 - i) % n] = 0
        specs.append(QuorumSpec(masks=masks,
                                thresholds=np.asarray([(n - 1) // 2 + 1],
                                                      np.int32),
                                combine=ANY, universe=tuple(range(n))))
    return specs


def fast_kernels(device, rng=None) -> dict:
    """The ``fast`` part (see the module's docstring)."""
    import torch
    from frankenpaxos_tpu_torch.ops import quorum as tq
    from frankenpaxos_tpu_torch.quorums.spec import ANY, QuorumSpec

    try:
        from frankenpaxos_tpu_torch.runs.quorums import SpecChecker
    except ImportError:
        SpecChecker = None
    rng = np.random.default_rng(SEED) if rng is None else rng
    out: dict = {"checks": {}, "batches": {}, "tensor": {}}

    def device_figures(fn):
        dev_ms, per_call = _device_ms(fn, K6_STATELESS_KERNELS)
        return {"device_ms": dev_ms, "launches_per_call": per_call}

    for f in (1, 2):
        n = 2 * f + 1
        spec = QuorumSpec(masks=np.ones((1, n), dtype=np.uint8),
                          thresholds=np.asarray([f + 1], np.int32),
                          combine=ANY, universe=tuple(range(n)))
        sets = [sorted(rng.choice(n, size=int(rng.integers(0, n + 1)),
                                  replace=False).tolist())
                for _ in range(64)]
        at = [0]

        def nodes():
            at[0] = (at[0] + 1) % len(sets)
            return sets[at[0]]

        if SpecChecker is not None:
            checker = SpecChecker(spec, "cuda", device=device)
            call, form = (lambda: checker.check(nodes()),
                          "SpecChecker.check")
        else:
            multi = tq.MultiConfigQuorumChecker([spec], device=device)
            zeros = np.zeros(1, dtype=np.int32)

            def call():
                present = spec.present_vector(nodes())
                return bool(multi.check_batch(present[None, :], zeros)[0])

            form = "the reference's tpu check on MultiConfigQuorumChecker"
        out["checks"][f"[1, {n}]"] = {
            "form": form, "host_ns": _host_ns(call), **device_figures(call),
            "bound_ms": (4 * n + 5) / HBM_BYTES_PER_S * 1e3}
    for b, n, k in FAST_BATCHES:
        multi = tq.MultiConfigQuorumChecker(fast_planes(n, k), device=device)
        rows = (rng.random((b, n)) < 0.6).astype(np.int32)
        idx = rng.integers(0, k, size=b).astype(np.int32)
        key = f"[{b}, {n}] K={k}"
        host = (lambda multi=multi, rows=rows, idx=idx:
                multi.check_batch(rows, idx))
        out["batches"][key] = {
            "host_ns": _host_ns(host, calls=200), **device_figures(host),
            "bound_ms": (4 * n + 5) * b / HBM_BYTES_PER_S * 1e3}
        p, i = (torch.from_numpy(x).to(device) for x in (rows, idx))
        tensor = (lambda multi=multi, p=p, i=i:
                  tq.check_batch_multi(p, i, multi.planes))
        out["tensor"][key] = {
            "call_ms": _cuda_ms(tensor), **device_figures(tensor),
            "bound_ms": (4 * n + 5) * b / HBM_BYTES_PER_S * 1e3}
    one = torch.zeros(1, dtype=torch.int32, device=device)
    dev_ms, _ = _device_ms(lambda: one.fill_(1), "FillFunctor")
    out["floor"] = {"fill_[1]": {"device_ms": dev_ms}}
    return out


#: The ``matchmaker`` part's shapes: ``(K prior configurations, N
#: acceptors)``, the vldb20 widths' pools (6 and 10 acceptors).
MATCHMAKER_SHAPES = ((1, 6), (3, 6), (2, 10), (4, 10))


def matchmaker_systems(k: int, n: int) -> list:
    """``k`` configurations over ``n`` acceptors, cycling through
    ``SimpleMajority`` and ``UnanimousWrites`` of ``n // 2`` acceptors and
    a ``Grid`` of 2 rows of ``n // 3`` (each over a shifted window of the
    pool): the kinds ``bench/matchmaker_sim.py`` draws."""
    from frankenpaxos_tpu_torch.quorums import (
        Grid,
        SimpleMajority,
        UnanimousWrites,
    )

    size, row = n // 2, n // 3
    systems = []
    for i in range(k):
        nodes = [(i + j) % n for j in range(n)]
        systems.append(
            SimpleMajority(nodes[:size]) if i % 3 == 0 else
            Grid([nodes[:row], nodes[row:2 * row]]) if i % 3 == 1 else
            UnanimousWrites(nodes[:size]))
    return systems


def matchmaker_specs(k: int, n: int) -> list:
    """The read specs of :func:`matchmaker_systems`, reindexed over the
    pool (a phase 1's planes)."""
    return [qs.read_spec().reindexed(tuple(range(n)))
            for qs in matchmaker_systems(k, n)]


def matchmaker_kernels(device, rng=None, turns: int = 3) -> dict:
    """The ``matchmaker`` part (see the module's docstring)."""
    import torch
    from frankenpaxos_tpu_torch.ops import quorum as tq

    rng = np.random.default_rng(SEED) if rng is None else rng
    out: dict = {"checks": {}, "builds": {}}
    for k, n in MATCHMAKER_SHAPES:
        specs = matchmaker_specs(k, n)
        checker = tq.MultiConfigQuorumChecker(specs, device=device)
        sets = [sorted(rng.choice(n, size=int(rng.integers(0, n + 1)),
                                  replace=False).tolist())
                for _ in range(64)]
        at = [0]

        def nodes():
            at[0] = (at[0] + 1) % len(sets)
            return sets[at[0]]

        def reference(checker=checker, k=k, n=n):
            # The reference leader's "tpu" body (matchmakermultipaxos.py
            # :538-543) on the checker's check_batch.
            present = np.zeros((k, n), dtype=np.uint8)
            present[:, nodes()] = 1
            return checker.check_batch(present,
                                       np.arange(k, dtype=np.int32))

        forms = {"reference_check_batch": reference}
        if hasattr(checker, "check_all"):
            forms["check_all"] = lambda checker=checker: \
                checker.check_all(nodes())
        # In turns (A, B, B, A, ...) so a drift of the host hits both.
        host = {name: [] for name in forms}
        order = list(forms) + list(forms)[::-1]
        for _ in range(turns):
            for name in order:
                host[name].append(_host_ns(forms[name], calls=2000))
        shape = f"[{k}, {n}]"
        out["checks"][shape] = {}
        for name, fn in forms.items():
            dev_ms, per_call = _device_ms(fn, K6_STATELESS_KERNELS)
            word = name == "check_all" and checker.multi.bits
            out["checks"][shape][name] = {
                "host_ns": host[name], "host_ns_median":
                float(np.median(host[name])), "device_ms": dev_ms,
                "launches_per_call": per_call,
                # The word (or the K rows) and K indices read, K answers
                # written.
                "bound_ms": ((4 if word else 4 * n * k) + 5 * k)
                / HBM_BYTES_PER_S * 1e3}
        # A phase 1's checker built from its specs, and its parts: the
        # planes' uploads, the wait, the pinned block (the checkers made
        # are kept alive, as a leader's cache keeps them).
        kept: list = []

        def build(specs=specs):
            kept.append(tq.MultiConfigQuorumChecker(specs, device=device))

        masks, thresholds, anys = tq.pad_specs(specs)

        def uploads(masks=masks, thresholds=thresholds, anys=anys):
            kept.append(tq.make_multi_predicate(masks, thresholds, anys,
                                                device=device))

        def pinned():
            kept.append(torch.empty(64, dtype=torch.int32,
                                    pin_memory=True))

        out["builds"][shape] = {
            "build_ns": _host_ns(build, calls=200),
            "planes_upload_ns": _host_ns(uploads, calls=200),
            "pinned_block_ns": _host_ns(pinned, calls=200),
            "synchronize_ns": _host_ns(torch.cuda.synchronize, calls=200)}
        kept.clear()
    return out


def depset_kernels(device, rng=None) -> dict:
    """K10 and K11 through their tensor wrappers at the paths' launch
    shapes: K10 ``union_reduce`` at the BPaxos Leader's ``[2, 2, W]``
    (``K10_WIDTHS``) and depset_lt's ``[4096, 3, 32]``, in its seq mode
    (``conflict_max``) at the EPaxos slow path's ``[4, 5, 8]``, K11
    ``all_equal`` at the fast path's ``[3, 5, 8]``: CUDA-event ms per
    call, the profiler's device ms per launch, and the bound (bytes:
    each input read once, each output written once); beside them the
    card's floor, PyTorch's fill of a one-element tensor."""
    import torch
    from frankenpaxos_tpu_torch.ops import depset as td

    rng = np.random.default_rng(SEED) if rng is None else rng
    out: dict = {"k10": {}, "k10_seq": {}, "k11": {}}

    def figures(fn, kernel, read, written):
        dev_ms, _ = _device_ms(fn, kernel)
        return {"call_ms": _cuda_ms(fn), "device_ms": dev_ms,
                "bound_ms": (read + written) / HBM_BYTES_PER_S * 1e3}

    for shape in [(2, 2, w) for w in K10_WIDTHS] + [K10_MANY_ROWS]:
        b, l, w = shape
        batch = _bits_batch(rng, shape, device)
        out["k10"][str(list(shape))] = figures(
            lambda: td.union_reduce(batch), "union_reduce",
            b * l * (4 + w) + 4, l * (4 + w))
    b, l, w = K10_SEQ_SHAPE
    batch = _bits_batch(rng, K10_SEQ_SHAPE, device)
    seqs = torch.from_numpy(rng.integers(0, 1 << 20, size=b).astype(
        np.int32)).to(device)
    out["k10_seq"][str(list(K10_SEQ_SHAPE))] = figures(
        lambda: td.conflict_max(seqs, batch), "union_reduce",
        4 * b + b * l * (4 + w) + 4, 4 + l * (4 + w))
    # This card's floor for a launch that reads and writes a few bytes:
    # PyTorch's fill of a one-element tensor (one CTA).
    one = torch.zeros(1, dtype=torch.int32, device=device)
    out["floor"] = {"fill_[1]": figures(lambda: one.fill_(1), "FillFunctor",
                                        0, 4)}
    b, l, w = K11_SHAPE
    # Equal rows: the fast path's common answer, and every row read.
    batch = _bits_batch(rng, (1, l, w), device)
    batch = td.DepSetBatch(batch.watermarks.expand(b, l).contiguous(),
                           batch.tails.expand(b, l, w).contiguous(),
                           batch.tail_base)
    out["k11"][str(list(K11_SHAPE))] = figures(
        lambda: td.all_equal(batch), "all_equal", b * l * (4 + w) + 4, 1)
    return out


def libbench_kernels(device, rng=None) -> dict:
    """K13 and K16's union through their wrappers at the libbench path's
    launch shapes (the module docstring): per shape the CUDA-event ms per
    call, the profiler's device ms per launch, the host ns per call (2000
    calls chained, one synchronize), the form the tree runs (None where
    it names none) and the bound (bytes: K13 each row through its first
    zero and an int32 out; the union B·L·(4+W) read per distinct input
    and written once); beside the union, the two-call PyTorch composite
    ``torch.maximum`` and ``|`` (not a one-call library equivalent)."""
    import torch
    from frankenpaxos_tpu_torch.bench import multichip_board
    from frankenpaxos_tpu_torch.ops import depset as td
    from frankenpaxos_tpu_torch.ops import watermark as tw

    rng = np.random.default_rng(SEED) if rng is None else rng
    prefix_form = getattr(tw, "prefix_form", None)
    out: dict = {"k13": {}, "union": {}}

    def figures(fn, kernel, nbytes):
        dev_ms, per_call = _device_ms(fn, kernel)
        return {"call_ms": _cuda_ms(fn), "device_ms": dev_ms,
                "launches_per_call": per_call, "host_ns": _host_ns(fn),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    present = np.ones(4096, dtype=bool)
    present[2048] = False
    rows = np.ones((4096, 3), dtype=bool)
    rows[rng.integers(0, 4096, size=600), rng.integers(0, 3, size=600)] = 0
    for what, x in (("[4096] first False at 2048", present),
                    ("[4096, 3]", rows),
                    ("[64, 100003] all true",
                     np.ones((64, 100003), dtype=bool))):
        xt = torch.from_numpy(x).to(device)
        flat = x.reshape(-1, x.shape[-1])
        zero = np.where(flat.all(axis=1), flat.shape[1],
                        np.argmin(flat, axis=1) + 1)
        out["k13"][what] = {
            "form": None if prefix_form is None else prefix_form(xt),
            **figures(lambda xt=xt: tw.contiguous_prefix_length(xt),
                      "prefix", int(zero.sum()) + 4 * flat.shape[0])}
    lib_shape = (4096, 3, 64)
    b, l, w = multichip_board.DEPSET_SHAPE
    rank_shape = (b // 4, l, w)  # rank 0 of phase 26's (1, 4) mesh
    kernels = ("depset_union_kernel", "depset_pair_kernel")
    for what, shape, aliased in (
            ("[4096, 3, 64] aliased (libbench's)", lib_shape, True),
            ("[4096, 3, 64] distinct", lib_shape, False),
            (f"{list(rank_shape)} distinct (the sharded board's rank)",
             rank_shape, False)):
        x = _bits_batch(rng, shape, device)
        y = x if aliased else _bits_batch(rng, shape, device)
        cells = x.tails.numel() + 4 * x.watermarks.numel()
        out["union"][what] = {
            # The tree's own union kernel reads 16-byte words (its
            # tensors are fresh allocations) and an aliased batch once.
            "form": (("aliased: read once" if aliased else "distinct")
                     + ", 16-byte words"
                     if hasattr(td, "_K16_UNION") else None),
            **figures(lambda x=x, y=y: td.union(x, y), kernels,
                      (2 if aliased else 3) * cells)}
        out["union"][what]["composite"] = {
            "note": "torch.maximum of the watermarks and | of the tails: "
                    "two PyTorch calls, not a one-call equivalent",
            **figures(lambda x=x, y=y: (torch.maximum(x.watermarks,
                                                      y.watermarks),
                                        x.tails | y.tails),
                      "elementwise_kernel",
                      (2 if aliased else 3) * cells)}
    torch.cuda.synchronize()
    return out


#: K8's recovery windows (rows, acceptor columns) and K7's boards.
K8_SHAPES = ((1 << 13, 3), (1 << 16, 3), (1 << 16, 6))
K8_STAGED_ROWS = (1 << 13, 1 << 16)
K7_WIDTHS = (1 << 14, 1 << 20)
#: Rounds of the Leader's K8 call, and of single calls after
#: ``K8_IDLE_S`` of host sleep.
K8_TURNS = 3
K8_IDLE_CALLS = 8
K8_IDLE_S = 0.02


def _recovery_inputs(rng, rows: int, n: int) -> tuple:
    """``[rows, n]`` rounds in [-1, 3] (ties, 1/8 all-NO_VOTE rows) and
    ids, as numpy int32."""
    rounds = rng.integers(-1, 4, size=(rows, n)).astype(np.int32)
    rounds[rng.random(rows) < 0.125] = -1
    ids = rng.integers(0, 1 << 20, size=(rows, n)).astype(np.int32)
    return rounds, ids


def recovery_kernels(device, rng=None) -> dict:
    """K8 and K7 at the recovery's and the handover's launch shapes, the
    Leader's K8 call whole, and the PyTorch composites (the module
    docstring): CUDA-event ms per call, the profiler's device ms per
    launch, host ns per call and the bound (bytes: K8 (8N + 5) a row,
    K7 N_old + N_new a column)."""
    import torch
    from frankenpaxos_tpu_torch.ops import quorum as tq
    from frankenpaxos_tpu_torch.ops import value as tv

    rng = np.random.default_rng(SEED) if rng is None else rng
    out: dict = {"k8": {}, "k8_call": {}, "k7": {}}

    def figures(fn, kernel, nbytes):
        dev_ms, per_call = _device_ms(fn, kernel)
        return {"call_ms": _cuda_ms(fn), "device_ms": dev_ms,
                "launches_per_call": per_call, "host_ns": _host_ns(fn),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    for rows, n in K8_SHAPES:
        r_np, i_np = _recovery_inputs(rng, rows, n)
        r, i = (torch.from_numpy(a).to(device) for a in (r_np, i_np))
        what = f"[{rows}, {n}]"
        out["k8"][what] = figures(lambda r=r, i=i: tv.safe_values(r, i),
                                  "safe_values_kernel",
                                  (8 * n + 5) * rows)

        def composite(r=r, i=i):
            best, col = torch.max(r, dim=1)
            return best > -1, torch.gather(i, 1, col[:, None])[:, 0]
        out["k8"][what]["composite"] = {
            "note": "torch.max(dim=1), > and torch.gather: three PyTorch "
                    "calls, not a one-call equivalent",
            **figures(composite, ("reduce_kernel", "elementwise_kernel"),
                      (8 * n + 5) * rows)}
    staged = getattr(tv, "safe_values_staged", None)
    for rows in K8_STAGED_ROWS:
        r_np, i_np = _recovery_inputs(rng, rows, 3)
        if staged is None:
            def call(r_np=r_np, i_np=i_np):
                has_vote, chosen = tv.safe_values(
                    torch.from_numpy(r_np).to(device),
                    torch.from_numpy(i_np).to(device))
                return has_vote.cpu().numpy(), chosen.cpu().numpy()
            forms = {"parent_sequence": call}
        else:
            rounds, ids = tv.recovery_matrices(rows, 3, device)
            rounds[...], ids[...] = r_np, i_np
            forms = {"staged": lambda rounds=rounds, ids=ids: staged(
                rounds, ids, device)}
        want = tv.safe_values_plain(torch.from_numpy(r_np),
                                    torch.from_numpy(i_np))
        figs = {name: {"host_ns": []} for name in forms}
        order = list(forms) + list(forms)[::-1]
        for _ in range(K8_TURNS):
            for name in order:
                got = forms[name]()
                if not (np.array_equal(got[0], want[0].numpy())
                        and np.array_equal(got[1], want[1].numpy())):
                    raise RuntimeError(f"K8 {name} at {rows} rows differs "
                                       f"from the plain version")
                figs[name]["host_ns"].append(_host_ns(forms[name], 200))
        for name, fn in forms.items():
            dev_ms, per_call = _device_ms(fn, "safe_values_kernel", 50)
            figs[name].update(device_ms=dev_ms, launches_per_call=per_call)
        # One call after the host has left the card idle for as long as
        # the Leader's build of the matrices takes (tens of ms).
        for _ in range(K8_IDLE_CALLS):
            for name in order:
                time.sleep(K8_IDLE_S)
                t0 = time.perf_counter_ns()
                forms[name]()
                figs[name].setdefault("after_idle_host_ns", []).append(
                    time.perf_counter_ns() - t0)
        out["k8_call"][f"[{rows}, 3]"] = figs
    block_maps = ((0, 1, 2, -1),)
    has_host_map = hasattr(tq, "_K7")
    for width in K7_WIDTHS:
        block = torch.from_numpy(rng.integers(0, 256, size=(3, width),
                                              dtype=np.uint8)).to(device)
        padded = torch.cat([block, torch.zeros_like(block[:1])])
        for cmap in block_maps:
            cmap_np = np.asarray(cmap, dtype=np.int32)
            cmap_t = torch.from_numpy(cmap_np).to(device)
            index = torch.from_numpy(np.where(cmap_np < 0, 3, np.minimum(
                cmap_np, 2)).astype(np.int64)).to(device)
            what = f"[3, {width}] -> [{len(cmap)}, {width}]"
            nbytes = (3 + len(cmap)) * width
            fig = {"device_map": figures(
                lambda b=block, m=cmap_t: tq.reshape_columns(b, m),
                "reshape_columns_kernel", nbytes)}
            if has_host_map:
                fig["host_map"] = figures(
                    lambda b=block, m=cmap_np: tq.reshape_columns(b, m),
                    "reshape_columns_kernel", nbytes)
            fig["composite"] = {
                "note": "index_select on the block padded with a zero row "
                        "(made once): one PyTorch call",
                **figures(lambda p=padded, x=index: p.index_select(0, x),
                          "indexSelect", nbytes)}
            out["k7"][what] = fig
    torch.cuda.synchronize()
    return out


def _epoch_lanes(rng, b: int) -> np.ndarray:
    """``b`` votes of the epoch arm's shape: 4096-slot runs of three
    acceptors (each slot voted by three of four nodes), with 10% of the
    votes straggling a drain behind and the handover inside, packed as
    the checker packs them (slot % window, true slot, node, round 0)."""
    from frankenpaxos_tpu_torch.ops import quorum as tq

    slot = EPOCH_WINDOW // 2 - b // 6 + np.arange(b) // 3
    late = rng.random(b) < 0.1
    slot = np.where(late, slot - 4096, slot)
    node = np.where(slot >= EPOCH_WINDOW // 2, [0, 1, 3] * (b // 3),
                    [0, 1, 2] * (b // 3)).astype(np.int32)
    return tq.pack_lanes(slot % EPOCH_WINDOW, slot, node,
                         np.zeros(b, np.int32), np.ones(b, bool))


def board_kernels(device, rng=None) -> dict:
    """K2, K5 and K4 through their wrappers at the paths' launch shapes,
    and a drain's board updates whole (see the module docstring):
    CUDA-event ms per call, the profiler's device ms per launch and the
    launches per call, and the bound (bytes: K2 moves (3N + 19) bytes a
    column, K5 4 bytes a lane read and N + 9 a reset column written)."""
    import torch
    from frankenpaxos_tpu_torch.ops import quorum as tq
    from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority

    rng = np.random.default_rng(SEED) if rng is None else rng
    out: dict = {"k2": {}, "k5": {}}

    def figures(fn, kernel, nbytes):
        dev_ms, per_call = _device_ms(fn, kernel)
        return {"call_ms": _cuda_ms(fn), "device_ms": dev_ms,
                "launches_per_call": per_call,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    run_fn = getattr(tq, "record_block_run", None)
    majority = SimpleMajority(range(3)).write_spec()
    grid = Grid([[0, 1, 2], [3, 4, 5]]).write_spec()
    shapes = [("N=3", majority, BOARD_WINDOW, b) for b in K2_WIDTHS]
    shapes += [("grid2x3", grid, BOARD_WINDOW, 4096),
               ("sharded_rank", majority, SHARD_WINDOW, 4096)]
    for label, spec, window, b in shapes:
        n = spec.num_nodes
        pred = tq.make_predicate(*spec.as_arrays(), device=device)
        board = tq.make_vote_board(window, n, device=device)
        block = torch.from_numpy(
            (rng.random((n, b)) < 0.6).astype(np.uint8)).to(device)
        out["k2"][f"{label}/B={b}"] = figures(
            lambda: tq.record_block(board, K2_START, K2_START, block, 0,
                                    pred),
            "record_block", (3 * n + 19) * b)
    # A drain's dense blocks: three 4096-column blocks from member slots.
    pred = tq.make_predicate(*majority.as_arrays(), device=device)
    board = tq.make_vote_board(BOARD_WINDOW, 3, device=device)
    starts = [K2_START, K2_START + 4096 + 5, K2_START + 2 * 4096 + 11]
    blocks = [torch.from_numpy((rng.random((3, 4096)) < 0.6).astype(
        np.uint8)).to(device) for _ in starts]
    if run_fn is not None:
        table, stride = tq.run_table(starts, [4096] * 3, [0] * 3,
                                     BOARD_WINDOW)
        joined = torch.zeros((3, stride), dtype=torch.uint8, device=device)
        for (col, _, width, at, _, _), blk in zip(table.tolist(), blocks):
            joined[:, at:at + width] = blk

        def drain_blocks():
            run_fn(board, table, joined, pred)
    else:
        def drain_blocks():
            for start, blk in zip(starts, blocks):
                tq.record_block(board, start, start, blk, 0, pred)
    fig = figures(drain_blocks, "record_block", (3 * 3 + 19) * 3 * 4096)
    fig["form"] = "run" if run_fn is not None else "three calls"
    if fig["device_ms"] is not None:
        fig["device_ms_per_drain"] = fig["device_ms"] * fig[
            "launches_per_call"]
    out["k2"]["drain_run/3x4096"] = fig

    all_fn = getattr(tq, "release_all", None)
    board = tq.make_vote_board(BOARD_WINDOW, 3, device=device)
    for r in K5_WIDTHS:
        slots = torch.from_numpy(rng.choice(BOARD_WINDOW, size=r,
                                            replace=False).astype(
            np.int32)).to(device)
        valid = torch.ones(r, dtype=torch.bool, device=device)
        out["k5"][f"release/B={r}"] = figures(
            lambda: tq.release(board, slots, valid), "release",
            5 * r + (3 + 9) * r)
        if all_fn is not None:
            out["k5"][f"release_all/B={r}"] = figures(
                lambda: all_fn(board, slots), "release",
                4 * r + (3 + 9) * r)
    out["k4"] = _k4_runs(device, figures)
    out["drain"] = _staged_drain(device, rng)
    one = torch.zeros(1, dtype=torch.int32, device=device)
    out["floor"] = {"fill_[1]": figures(lambda: one.fill_(1), "FillFunctor",
                                        4)}
    return out


def _straggler_lanes(first: int, b: int, window: int) -> np.ndarray:
    """``b`` straggler votes as the tracker scatters them: slots from
    ``first``, two acceptors' votes a slot, round 0, packed."""
    from frankenpaxos_tpu_torch.ops import quorum as tq

    slot = first + np.repeat(np.arange(b // 2), 2)
    return tq.pack_lanes(slot % window, slot, np.tile([0, 1], b // 2),
                         np.zeros(b, np.int32), np.ones(b, bool))


def _k4_runs(device, figures) -> dict:
    """K4 on one tracker chunk and on runs of chunks (the module
    docstring); bytes: 21 a lane and (N + 9) read and written per
    distinct column."""
    import torch
    from frankenpaxos_tpu_torch.ops import quorum as tq
    from frankenpaxos_tpu_torch.quorums import SimpleMajority

    pred = tq.make_predicate(*SimpleMajority(range(3)).write_spec()
                             .as_arrays(), device=device)
    board = tq.make_vote_board(BOARD_WINDOW, 3, device=device)
    lanes = torch.from_numpy(_straggler_lanes(
        K2_START, max(K4_RUNS) * CHUNK, BOARD_WINDOW)).to(device)
    run_fn = getattr(tq, "record_and_check_run", None)
    out = {}
    one = lanes[:, :CHUNK].contiguous()
    out[f"chunk/B={CHUNK}"] = figures(
        lambda: tq.record_and_check(board, one, pred), "record_and_check",
        21 * CHUNK + 2 * 12 * (CHUNK // 2))
    for chunks in K4_RUNS:
        b = chunks * CHUNK
        sub = lanes[:, :b].contiguous()
        if run_fn is not None:
            bounds = tq.chunk_bounds([CHUNK] * chunks)

            def call(sub=sub, bounds=bounds):
                run_fn(board, sub, bounds, pred)
        else:
            views = [sub[:, k * CHUNK:(k + 1) * CHUNK].contiguous()
                     for k in range(chunks)]

            def call(views=views):
                for view in views:
                    tq.record_and_check(board, view, pred)
        fig = figures(call, "record_and_check", 21 * b + 2 * 12 * (b // 2))
        fig["form"] = "run" if run_fn is not None else "a call a chunk"
        if fig["device_ms"] is not None:
            fig["device_ms_per_call"] = fig["device_ms"] * fig[
                "launches_per_call"]
        out[f"run/{chunks}x{CHUNK}"] = fig
    return out


def _staged_drain(device, rng) -> dict:
    """A pipelined drain's board updates through its checker, results on
    the host (the module docstring): host ns per drain, and the K2 and
    K4 launches and the checker calls a drain makes."""
    import torch
    from frankenpaxos_tpu_torch.ops import quorum as tq
    from frankenpaxos_tpu_torch.quorums import SimpleMajority

    checker = tq.TpuQuorumChecker(SimpleMajority(range(3)).write_spec(),
                                  window=BOARD_WINDOW, device=device)
    starts = [K2_START + 8192, K2_START + 8192 + 4096 + 5,
              K2_START + 8192 + 2 * 4096 + 11]
    spans = [(start, 4096, 1) for start in starts]
    fills = [(rng.random((3, 4096)) < 0.6).astype(np.uint8) for _ in starts]

    def chunk(first, rnd):
        lanes = _straggler_lanes(first, CHUNK, BOARD_WINDOW)
        return (lanes[1].astype(np.int64), lanes[2],
                np.full(CHUNK, rnd, np.int32))

    pre = [chunk(K2_START, 0)]
    rest = [chunk(K2_START + 2048, 1), chunk(K2_START + 2048 + 128, 1),
            chunk(K2_START + 8192 + 3 * 4096 + 64, 2)]
    if hasattr(checker, "board_run"):
        segments = [("sparse", [(*c, CHUNK) for c in pre]),
                    ("dense", spans),
                    ("sparse", [(*c, CHUNK) for c in rest])]

        def drain():
            run = checker.board_run(segments)
            for off, fill in zip(run.offsets.tolist(), fills):
                run.block[:, off:off + 4096] = fill
            res = run.dispatch()
            res.wait()
            res.lanes()
            res.free()
        form = "one board_run dispatch"
    else:
        def drain():
            masks = [checker.record_and_check_async(*c, pad_to=CHUNK)
                     for c in pre]
            run = checker.dense_run(spans)
            for off, fill in zip(run.offsets.tolist(), fills):
                run.block[:, off:off + 4096] = fill
            res = run.dispatch()
            masks += [checker.record_and_check_async(*c, pad_to=CHUNK)
                      for c in rest]
            res.wait()
            for mask in masks:
                mask.cpu()
            res.free()
        form = "dense_run between four record_and_check_async calls"
    drain()
    torch.cuda.synchronize()
    before = (tq.record_block.launches, tq.record_and_check.launches)
    drain()
    torch.cuda.synchronize()
    launches = {"record_block": tq.record_block.launches - before[0],
                "record_and_check": tq.record_and_check.launches
                - before[1]}
    dev_ms, per_call = _device_ms(drain, "record_")
    return {"form": form, "host_ns_per_drain": _host_ns(drain, calls=500),
            "launches_per_drain": launches,
            "device_ms_per_drain": (None if dev_ms is None
                                    else dev_ms * per_call),
            "votes": {"dense_blocks": len(spans),
                      "sparse_chunks": len(pre) + len(rest),
                      "lanes": CHUNK * (len(pre) + len(rest))}}


def sharded_kernels(device) -> dict:
    """K19, K20 and K21 at rank 0's shape of each phase-25 mesh,
    telemetry off and on (the module docstring), with the form each of
    K19 and K20 runs; and K21 folding a run of each of ``FOLD_ROWS``
    drains: ONE launch over the run's rows where the tree's K21 takes a
    row count, else a launch a drain (the fold the tree makes for such a
    run). Bytes: K19 (4N + 4 + 8R) a lane, K20 (8R + 13 + N) a lane and
    the slot words, K21 the run's slot words read and zeroed, three
    scalars, and the telemetry buffer read and written."""
    import inspect

    import torch
    from frankenpaxos_tpu_torch.bench import pipeline as tp
    from frankenpaxos_tpu_torch.mesh import Mesh
    from frankenpaxos_tpu_torch.ops.quorum import make_predicate
    from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority

    specs = {"majority3": SimpleMajority(range(3)).write_spec(),
             "grid2x3": Grid([[0, 1, 2], [3, 4, 5]]).write_spec()}
    run_fold = "k" in inspect.signature(tp.shard_fold).parameters
    out = {}
    for group, slot, name in SHARD_MESHES:
        spec = specs[name]
        n = spec.num_nodes
        pred = make_predicate(*spec.as_arrays(), device=device)
        mesh = Mesh(group, slot, 0, device)
        for telemetry in (False, True):
            state, _ = tp.make_sharded_state(mesh, BOARD_WINDOW, SHARD_BLOCK,
                                             n, telemetry=telemetry,
                                             device=device)
            plan = tp.make_shard_plan(mesh, SHARD_BLOCK, pred,
                                      telemetry=telemetry)
            at = [0]

            def phase(fn):
                def call():
                    fn(state, at[0], plan)
                    at[0] += 1
                return call

            b, r = plan.b_local, plan.parts.shape[1]
            words = plan.slot.shape[-1]
            tel_bytes = 8 * state.telemetry.buffer.numel() if telemetry \
                else 0
            rows = {"shard_vote_count": (4 * plan.n_local + 4 + 8 * r) * b,
                    "shard_commit": (8 * r + 13 + plan.n_local) * b
                    + 8 * words,
                    "shard_fold": 8 * words + 24 + tel_bytes}
            fig = {"b_local": b, "n_local": plan.n_local,
                   "w_local": state.votes.shape[1],
                   "form": (list(tp.shard_form(plan))
                            if hasattr(tp, "shard_form") else None),
                   "commit_form": (list(tp.commit_form(plan))
                                   if hasattr(tp, "commit_form") else None)}
            for kernel in ("shard_vote_count", "shard_commit", "shard_fold"):
                call = phase(getattr(tp, kernel))
                dev_ms, _ = _device_ms(call, kernel + "_kernel")
                fig[kernel] = {"call_ms": _cuda_ms(call), "device_ms": dev_ms,
                               "bound_ms": rows[kernel] / HBM_BYTES_PER_S
                               * 1e3}
            fig["shard_fold_run"] = {}
            for k in FOLD_ROWS:
                if run_fold:
                    def call(k=k):
                        tp.shard_fold(state, at[0], plan, k)
                        at[0] += k
                else:
                    def call(k=k):
                        for d in range(k):
                            tp.shard_fold(state, at[0] + d, plan)
                        at[0] += k
                dev_ms, per_call = _device_ms(call, "shard_fold_kernel",
                                              iters=max(4, 200 // k))
                fig["shard_fold_run"][str(k)] = {
                    "call_ms": _cuda_ms(call, calls=max(20, CALLS // k)),
                    "device_ms": dev_ms, "launches_per_call": per_call,
                    "device_ms_per_run": (None if dev_ms is None
                                          else dev_ms * per_call),
                    "bound_ms": (8 * words * k + 24 + tel_bytes)
                    / HBM_BYTES_PER_S * 1e3}
            torch.cuda.synchronize()
            out[f"{group}x{slot} {name} telemetry "
                f"{'on' if telemetry else 'off'}"] = fig
    return out


def board_drains(device) -> dict:
    """The pipelined tracker's host cost on tracker_lt's stream: ns per
    ``drain()`` and per ``collect()`` (each dispatch collected right
    after its drain, on this thread), whole and split."""
    import torch
    from frankenpaxos_tpu_torch.bench import tracker_lt as lt
    from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
        TpuQuorumTracker,
    )

    config = lt.make_config()
    stream = lt.make_stream(lt.SLOTS, 3, lt.DRAIN)

    def replay(drain_clock, collect_clock):
        tracker = TpuQuorumTracker(config, window=lt.WINDOW,
                                   pipelined=True, device=device)
        torch.cuda.synchronize()
        got = []
        for events in stream:
            _feed(tracker, events, 3)
            drain_clock.drain(tracker)
            collect_clock.drain(_Collector(tracker))
            got.extend(collect_clock.last)
        torch.cuda.synchronize()
        return got

    whole = (DrainClock(False), DrainClock(False))
    got = replay(*whole)
    oracle = lt.replay(lt.DictQuorumTracker(config), stream, 3)
    lt.check_against_oracle("pipelined", got, oracle)
    profiled = (DrainClock(True), DrainClock(True))
    replay(*profiled)
    return {"pipelined_drain": {
                "drains": whole[0].drains,
                "whole_ns_per_drain": whole[0].ns / whole[0].drains,
                **profiled[0].split()},
            "pipelined_collect": {
                "drains": whole[1].drains,
                "whole_ns_per_drain": whole[1].ns / whole[1].drains,
                **profiled[1].split()},
            "votes_per_drain": lt.count_votes(stream) / len(stream)}


class _Collector:
    """A tracker's pending dispatches as one ``drain()``, for the clock:
    every dispatch taken and collected; ``DrainClock.last`` keeps what
    they reported."""

    def __init__(self, tracker):
        self.tracker = tracker

    def drain(self) -> list:
        out = []
        while (d := self.tracker.take_dispatch()) is not None:
            out.extend(self.tracker.collect(d))
        return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None)
    parser.add_argument("--parts", default="drains,kernels")
    args = parser.parse_args(argv)
    root = args.tree or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import frankenpaxos_tpu_torch
    from frankenpaxos_tpu_torch.device import nvidia_smi_line

    if not torch.cuda.is_available():
        raise RuntimeError("launch_shapes times CUDA calls: no CUDA device")
    from frankenpaxos_tpu_torch.ops import _build

    device = torch.device("cuda", torch.cuda.current_device())
    result = {"benchmark": "launch_shapes",
              "package": os.path.dirname(os.path.abspath(
                  frankenpaxos_tpu_torch.__file__)),
              "device": torch.cuda.get_device_name(device),
              "nvidia_smi": nvidia_smi_line(),
              # Wall seconds of this tree's kernel build (0 when built).
              "build_s": _build.build()}
    parts = args.parts.split(",")
    if "kernels" in parts:
        result["kernels"] = kernels(device)
    elif "depset" in parts:
        result["kernels"] = depset_kernels(device)
    if "board" in parts:
        result["board"] = {"kernels": board_kernels(device),
                           "drains": board_drains(device)}
    if "sharded" in parts:
        result["sharded"] = sharded_kernels(device)
    if "libbench" in parts:
        result["libbench"] = libbench_kernels(device)
    if "recovery" in parts:
        result["recovery"] = recovery_kernels(device)
    if "fast" in parts:
        result["fast"] = fast_kernels(device)
    if "matchmaker" in parts:
        result["matchmaker"] = matchmaker_kernels(device)
    if "drains" in parts:
        result["drains"] = drains(device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
