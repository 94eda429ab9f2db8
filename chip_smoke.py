#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result):

  1. device: the card's name, and ``nvidia-smi``'s name and power limit;
  2. build: compiles every kernel of ``frankenpaxos_tpu_torch/ops/csrc``
     (one ``nvcc`` per source, in parallel) and prints the seconds;
  3. K1 ``quorum_hit`` against its plain version at B = 32768 for five
     specs, on 0/1 blocks and on arbitrary bytes, both layouts: exact;
  4. K2 ``record_block`` against its plain version: a
     ``TpuQuorumChecker`` at window 2^20 through 64 record_block calls of
     width 32768 with ring wrap, round preemption and stale owners; the
     newly masks and the whole board must be equal after every call;
  5. the chunked drain kernel, one launch a run: K3 (telemetry off), K14
     (telemetry on) and the re-pinned copy, at window 2^20, block 2^15,
     one run after another (each resuming the one before): majority-3
     runs of 1, 2, 3, 64 and 4096 drains from drain 0 and of 1, 2, 3,
     128, 4096 and 32768 from 2^31 - 70, the 2x3 grid 1, 2, 3, 64 and
     4096 from 0 and 1, 2, 3 and 4096 from 2^31 - 70 (the 128- and
     4096-drain runs from 2^31 - 70 cross the int32 wrap inside one
     launch), against the plain drain loop: every field of K3 and K14
     and every counter of K14 equal to the plain version's after every
     run, and K3 equal to the pinned copy bit for bit;
  6. K4 ``record_and_check`` against its plain version: 64 calls of
     64-4096 lanes at window 2^20 per spec (majority-3, 2x3 grid) on a
     mid-flight board, with duplicate slots, stale owners, ring wrap,
     round preemption and padding lanes; newly masks and boards equal
     after every call;
  7. K5 ``release`` against its plain version at window 2^20;
  8. K6 ``check_batch_multi`` alone and ``record_and_check_epochs``
     against their plain versions: three epochs over a 5-node union,
     window 2^14 (the epoch tracker's);
  9. K7 ``reshape_columns`` against its plain version: a [3, 2^20]
     board to [4, 2^20] and to [2, 2^20];
  10. K8 ``safe_values`` against its plain version: [2^16, 3] and
     [2^16, 6] rounds with forced ties, all-NO_VOTE rows and the
     Leader's pow2 padding rows: exact;
  11. the main path, with every kernel's launch count set to 0 first:
     the headline (``frankenpaxos_tpu_torch.bench.headline``) at full
     size for both arms (2^30 commits each, commit count checked; each
     run of 32768 drains is ONE launch of K3, each latency sample one
     launch), a
     ``TpuQuorumChecker`` drain loop at window 2^20 (check_block,
     check_batch, record_block) checked against the host oracle, and
     ``bench/tracker_lt.py`` at full width (window 2^20, 2^20 slots per
     arm: sync, pipelined, 2x3 grid, epoch handover), every arm checked
     against its dict oracle; K1-K7 must each have launched;
  12. the MultiPaxos cluster path, with every count set to 0 again
     first: ``bench/multipaxos_sim.py`` at full width and cut depth
     (2^13 steady writes on the synchronous tracker, a failover of 2^13
     writes whose recovery runs K8 on [2^13, 3], both cut from the
     bench's 2^16 to hold the smoke's time; 2^14 writes on the
     pipelined tracker whose last
     wave has one acceptor's votes straggle across a failover), every
     write answered with its state machine result, both replicas'
     logs equal, K8's recovery equal to the host path's; K1, K2, K4
     and K8 must each have launched on the arms' traffic (K4 on the
     pipelined arm's straggling votes; K5 runs only in the pipelined
     trackers' construction prewarm, as no role releases the board);
  13. K9 ``normalized``, K10 ``union_reduce`` / ``conflict_max`` and
     K11 ``all_equal`` against their plain versions: exact, at
     [4096, 5, 2048] (arbitrary bytes), [4096, 3, 32] (depset_lt's),
     [3, 5, 8], [5, 5, 2048] and [1, 1, 37], with window bases near
     2^31 - 1 and negative watermarks, and ``all_equal`` cases that are
     equal only after normalization;
  14. the EPaxos path, with every count set to 0 again first:
     ``bench/epaxos_sim.py`` (f = 2, five replicas, 64 closed-loop
     pairs, arms conflict2 and conflict25, each on the host and the
     cuda backend; every command answered once with its KeyValueStore
     result, the replicas' logs and states equal, the cuda run's log
     and replies equal the host run's) and ``bench/depset_lt.py``
     (widths 256, 1024, 4096, aggregates equal on every drain; the
     host runs go to two worker processes beside the cuda runs); K10
     ``conflict_max`` and K11 ``all_equal`` must each have launched on
     the cluster's traffic;
  15. K12 ``quorum_watermark`` and K13 ``contiguous_prefix_length``
     against their plain versions: exact. K12 at n in {1, 2, 3, 5, 7,
     9, 31, 32, 33, 64, 65, 128, 1001} and B in {1, 4096, 2^16}, and at
     n in {1025, 2500} (rows taken in tiles) and B in {1, 4096}, every
     quorum size in [1, n] (a spread of them above 65), per-row sizes
     and the out-of-range 0, -1 and n + 1, values near +-2^31 and ties,
     strided rows, an ``out=`` buffer written and returned; a launch
     inside a side stream's context ordered on that stream; its vector
     form on int64 matrices that wrap to int32, in shapes that grow and
     shrink between calls. K13
     on libbench's [4096] (one False in the middle), [4096, 3] rows,
     arbitrary bytes and signed types, all-true rows long enough for
     many passes, and an empty last axis;
  16. the BPaxos path, with every count set to 0 again first:
     ``bench/bpaxos_sim.py`` at full width (f = 1, 64 pairs; arms
     simple-conflict2, simple-conflict25 and gc, each on the host and
     the cuda backends, 2^13 commands each, cut from the bench's 2^14 to
     hold the smoke's time; the gc arm's replica 2 partitioned for the
     first half and caught up through a peer's CommitSnapshot); every
     gate of the bench passes, and K10 ``union_reduce`` and K12
     ``quorum_watermark`` must each have launched on the cluster's
     traffic;
  17. the same three kernels in their other forms, against the plain
     loop: at the full width, runs of 1, 3 and 64 drains from 2^31 - 40
     for majority-5, the 2x3 read grid, a permuted 2x3 write grid, a 3x3
     grid, a 3x1 grid, WPaxos's 3x3 zone grid (three groups), two
     overlapping groups and 17 acceptors (the memory path); at
     window/block 1 to 6 (1 and 2: the blocks alias, the memory path; 3
     and 4: the register carry's GC-zeroed next and ahead columns; 3, 5
     and 6: rings that jump at the int32 wrap): runs of 1, 2, 3 and 40
     drains from drain 0 and from 2^31 - 20 (the 40-drain run crosses
     the wrap), both specs; the counters re-adding to the committed
     count; telemetry-on runs of 1, 64 and 4096 drains under
     ``torch.cuda.set_sync_debug_mode("error")`` (any hidden sync
     raises) and one ``collect``; and a K3 and a K14 run launched inside
     a side stream's context, behind work that copies the state it
     resumes, ordered on that stream;
  18. the telemetry path, with every count set to 0 first: the
     telemetry-overhead twin (``bench/telemetry_overhead.py``) at the
     reference's widths 2^12/2^8 and 2^13/2^9 and the headline width
     2^20/2^15, the reference's ``--smoke`` knobs, through
     ``measure_width``; the arms must agree (the 3% gate is printed as
     measured, not enforced); every arm advances one launch a chunk; K3,
     K14 and the pinned copy must each have launched;
  19. K15 ``count_matching_replies`` against its plain version: exact, S
     in {1, 4096, 2^16} x N in {1, 2, 3, 5, 7, 16}, with ties, rows with
     no valid reply, ids near +-2^31, and an empty S;
  20. K16 (``union``, ``intersect``, ``compact``) and K17 (``equal``,
     ``size``, ``contains``) against their plain versions: exact, on
     libbench's [4096, 3, 64] and the shapes of phase 13, window bases
     near 2^31 - 1 and below 0, 0/1 and arbitrary bytes, aliased
     inputs, every broadcast shape of ``executed``, leaders -1 and >= L
     and ids on both sides of the window;
  21. the libbench path, with every count set to 0 first: the libbench
     twin (``bench/libbench.py``) at the reference's sizes; K10, K12,
     K13 and K16's ``union`` must each have launched;
  22. K18 ``link_keep_mask`` against its plain version: exact, at 1000
     zones (a [1001, 1001] up-matrix with about 20% of its links down)
     for n in {1, 15, 16, 17, 31, 32, 33, 500, 4096, 65536}, ids at
     every edge of JAX's index rule (-1, -Z-1, <= -Z-2, Z, > Z); on
     views whose start is 1-15 elements off a 16-byte boundary at ragged
     lengths, src, dst and an ``out=`` buffer offset alike and apart;
     a launch inside a side stream's context ordered on that stream;
     the transport-facing ``link_keep_mask_cuda`` equal to it (also at
     ragged lengths after a longer wave), its result writable and not
     aliased by the next call, and a partition between two calls (a new
     ``up_matrix``) changing exactly the cut link's frames;
  23. the geo path, with every count set to 0 first: the geo_lt twin
     (``bench/geo_lt.py``: WPaxos, 3 regions x 3-acceptor rows, 6
     groups, 3 clients, the arms home_zone, static_single_leader, steal,
     hot_objects and flat at the reference's sizes) on the dict and the
     cuda quorum backends, the cuda run's link mask on K18; the
     reference's gates on the dict run, the virtual-time gates on the
     cuda run, and the cuda run's acks, virtual latencies and replicas'
     group sequences EQUAL to the dict run's; K5 and K6 must have
     launched on its traffic, and K7 never (the grid universe is fixed);
  24. the storm twin (``bench/sim_core_ab.py``), on the same count: the
     reference's 1000-zone GeoStorm (bursts of 500, 60 rounds) on the
     jittered and the jitter-free topology, and a 32,768-frame FIFO
     backlog over the geo transport, each with the numpy mask and K18 in
     alternating blocks; delivery projections and sink counts identical
     across masks; the wave-size histograms; K18 must have launched on
     the geo path (phases 23-24);
  25. the sharded path, with every count set to 0 in each rank first:
     four ranks spawned on the card (built first; gloo, as they share
     one card -- NCCL refuses two ranks on one GPU), at the headline's
     full width (window 2^20, block 2^15) on the meshes (1, 4)
     majority-3, (1, 3) majority-3 (b_local 10923, one pad lane per
     block), (2, 2) 2x3 grid (whole rows per group shard: the fused row
     path) and (3, 1) 2x3 grid (rows straddle the shards: the psum'd
     matmul), each telemetry off and on: K19 ``shard_vote_count``, K20
     ``shard_commit`` and K21 ``shard_fold`` against their plain versions
     phase by phase for 3 drains and ``sharded_step`` against
     ``sharded_step_plain`` for 2 more (error 0); then 40 drains through
     ``make_sharded_step`` (the 32-block ring wraps), the launch counts
     read, and the gathered state equal bit for bit to the unsharded
     drain's (K3, K14 with telemetry) after the same 40 drains; then the
     per-drain split (K19, K20, K21 device time, the two all-reduces'
     host time); with two or more cards, the same on one rank per card
     over NCCL;
  26. the sharded vote board's path (``bench/multichip_board.py``'s
     ``check_board``), on four ranks that share the card over gloo (and,
     with two or more cards, one rank per card over NCCL): first each
     kernel on every rank's shard against its plain version (K1; K2 on
     4096-wide blocks across the shard edges of the 2^20 window; K4 on
     256 straggler lanes, some outside the window; K5; K6 and K7 on the
     epoch board; the pinned K19-K21 copies phase by phase: error 0);
     then, with every count set to 0 in each rank, the ProxyLeader's
     tracker at its default window 2^20 with its board split over the
     mesh (``TpuQuorumTracker(mesh=)``), fed ``bench/tracker_lt.py``'s
     stream made on every rank: pipelined majority-3 over 2^20 slots on
     (1, 4), pipelined majority-3 and 2x3 grid over 2^18 slots on (2, 2),
     the synchronous tracker over 2^16 slots on (1, 4) -- every drain's
     reports equal to the unsharded port tracker's and the dict oracle's,
     and the gathered board equal to the unsharded board; then on (1, 4)
     ``EpochSegmentedChecker(mesh=)`` across a mid-window handover that
     grows the universe (window 2^14), ``GeoQuorumTracker(mesh=)`` on the
     ZoneGrid stream, ``union_reduce_sharded`` at [4096, 3, 64] and the
     pinned drain's mesh form (40 drains at 2^20 / 2^15, equal to the
     unsharded pinned K3 copy); K1, K2, K4-K7 and the pinned copies must
     each have launched; the per-drain host ms split into the
     all-reduces' and the kernels' time;
  27. the block sweep (``bench/block_sweep.py``): blocks 2^12-2^17 at
     window 2^20, one timed run each after a warm run (the reference's
     three cut to one), a short per-drain latency distribution, and the
     best block under the 50 us target;
  28. the host time of K18's and K12's wrappers and transport-facing
     entries, whole and split by function under ``cProfile``
     (``bench/call_split.py``);
     per-kernel figures at the main paths' shapes: CUDA-event time per
     call over many calls (K12 and K18 in turns with their library call:
     kernel, library, library, kernel, six blocks of 400 calls each, the
     medians), the device time (the profiler's; for K3, K14 and the
     pinned copy, whose call is one launch of a run of 1024 drains, CUDA
     events around single launches, the median of 21), the plain
     version's time, the time of one PyTorch call that computes the same
     function where there is one (``torch.kthvalue`` for K12,
     ``up[src, dst]`` for K18), the two entries' host ms per call, the
     bound (bytes / 3.35 TB/s vs integer operations / 67 T/s, the
     larger; each input read once and each output written once, so a
     drain run's bytes are its state's, read and written once, with the
     reference's (5N+17)·B bytes a drain beside it as
     ``reference_bytes``) and the launches of phases 11, 12, 14, 16, 18,
     21, 23-24, 25 and 26 (K3, K14 and the pinned copy with their drains
     beside their launches, each figure per drain too, and the device µs
     a drain of every form of phases 5 and 17), printed as one
     ``{"kernels": [...]}`` line; before it, each headline arm's timed
     run split into host and device time (CUDA events around the same
     run) and the share of it the device sat idle.

The last line is ``{"ok": true, "device": {...}}``.
"""

import itertools
import json
import os
import re
import statistics
import sys
import time
import warnings

import frankenpaxos_tpu_torch
from frankenpaxos_tpu_torch.bench import (
    block_sweep,
    bpaxos_sim,
    call_split,
    depset_lt,
    epaxos_sim,
    geo_lt,
    headline,
    libbench,
    multichip,
    multichip_board,
    multipaxos_sim,
    pipeline as tp,
    pipeline_baseline as tpin,
    sim_core_ab,
    telemetry_overhead,
    tracker_lt,
)
from frankenpaxos_tpu_torch.device import nvidia_smi_line
from frankenpaxos_tpu_torch.geo import GeoTopology
from frankenpaxos_tpu_torch.mesh import Mesh
from frankenpaxos_tpu_torch.obs import telemetry as tobs
from frankenpaxos_tpu_torch.ops import (
    _build,
    depset as td,
    quorum as tq,
    simwave as tsw,
    value as tv,
    watermark as tw,
)
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority, ZoneGrid
from frankenpaxos_tpu_torch.quorums.spec import ALL, pad_specs, QuorumSpec
import numpy as np
import torch

WINDOW = 1 << 20
BLOCK = 1 << 15
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT_OPS_PER_S = 67e12       # H100 non-tensor float32 peak, used for int ops
SEED = 20261017
#: Slice 3's steady and failover arms, cut from the bench's 2^16 writes
#: so that the whole smoke stays near its earlier time with the EPaxos
#: path added (depth only: the cluster's width is the bench's).
CLUSTER_WRITES = 1 << 13
#: The BPaxos arms' commands, cut from the bench's 2^14 (depth only).
BPAXOS_COMMANDS = 1 << 13
#: When the smoke started (``phase``'s clock).
T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(n: int, msg: str) -> None:
    """Phase ``n``'s line, with the seconds since the smoke started."""
    log(f"[{n}/28] {msg} (at {time.perf_counter() - T0:.1f} s)")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def specs() -> dict:
    return {
        "majority3": SimpleMajority(range(3)).write_spec(),
        "majority5": SimpleMajority(range(5)).write_spec(),
        "grid2x3_write": Grid([[0, 1, 2], [3, 4, 5]]).write_spec(),
        "grid_perm_write": Grid([[0, 2, 4], [1, 3, 5]]).write_spec(),
        "grid2x3_read": Grid([[0, 1, 2], [3, 4, 5]]).read_spec(),
    }


def predicate(spec, dev):
    return tq.make_predicate(*spec.as_arrays(), device=dev)


def phase_k1(dev, rng) -> int:
    worst = 0
    for name, spec in specs().items():
        pred = predicate(spec, dev)
        n = spec.num_nodes
        blocks = [(rng.random((n, BLOCK)) < p).astype(np.uint8)
                  for p in (0.3, 0.7)]
        blocks.append(rng.integers(0, 256, (n, BLOCK), dtype=np.uint8))
        for blk in blocks:
            votes = torch.from_numpy(blk).to(dev)
            present = votes.t().contiguous()  # check_batch's [B, N] layout
            for view in (votes, present.t()):
                got = tq.quorum_hit(view, pred)
                want = tq.quorum_hit_plain(view, pred)
                err = max_abs_err(got, want)
                worst = max(worst, err)
                require(err == 0, f"K1 differs from plain on {name}")
    torch.cuda.synchronize(dev)
    return worst


def _boards_equal(a: tq.VoteBoard, b: tq.VoteBoard) -> int:
    return max(max_abs_err(x, y) for x, y in zip(a, b))


def phase_k2(dev, rng) -> int:
    worst = 0
    for name in ("majority3", "grid2x3_write"):
        spec = specs()[name]
        n = spec.num_nodes
        checker = tq.TpuQuorumChecker(spec, window=WINDOW, device=dev)
        plain = tq.make_vote_board(WINDOW, n, device=dev)
        pred = predicate(spec, dev)
        frontier = 0
        kinds = {"wrap": 0, "preempt": 0, "stale": 0}
        for step in range(32):
            vote_round = 1
            if step % 4 == 1:          # same range, a newer round
                start_slot = frontier
                vote_round = 2 + step
                kinds["preempt"] += 1
            elif step % 4 == 3 and frontier >= WINDOW:
                start_slot = frontier - WINDOW  # the column moved past it
                kinds["stale"] += 1
            else:
                frontier += int(rng.integers(1, 9)) * BLOCK \
                    + int(rng.integers(0, BLOCK))
                frontier -= max(0, frontier % WINDOW + BLOCK - WINDOW)
                start_slot = frontier
                kinds["wrap"] += frontier >= WINDOW
            if step % 5 == 4:
                blk = rng.integers(0, 256, (n, BLOCK), dtype=np.uint8)
            else:
                blk = (rng.random((n, BLOCK)) < 0.6).astype(np.uint8)
            with warnings.catch_warnings():  # the stale calls warn
                warnings.simplefilter("ignore", RuntimeWarning)
                newly = checker.record_block_async(start_slot, blk,
                                                   vote_round)
            want = tq.record_block_plain(
                plain, start_slot % WINDOW, start_slot,
                torch.from_numpy(blk).to(dev), vote_round, pred)
            err = max(max_abs_err(newly, want),
                      _boards_equal(checker.board, plain))
            worst = max(worst, err)
            require(err == 0, f"K2 differs from plain on {name} at call "
                              f"{step}")
        require(all(kinds.values()), f"K2 sequence lacks a case: {kinds}")
    torch.cuda.synchronize(dev)
    return worst


#: Phase 5's runs of the chunked drain kernel at the full width, per spec
#: and first drain, each sequence run one chunk after another (each
#: resumes the one before): from 2^31 - 70 the 128- and the 4096-drain
#: runs cross the int32 wrap inside one launch, and majority-3's
#: 32768-drain run resumes past it. The plain loop takes about 1.4 ms a
#: drain on the card, so the longest run is held on one spec.
DRAIN_CHUNKS = {
    "majority3": {0: (1, 2, 3, 64, 4096),
                  2**31 - 70: (1, 2, 3, 128, 4096, 32768)},
    "grid2x3_write": {0: (1, 2, 3, 64, 4096), 2**31 - 70: (1, 2, 3, 4096)},
}
#: The three drain kernels, by the name of their row in the kernels line.
DRAIN_KERNELS = ("steady_state_step", "steady_state_step_telemetry",
                 "steady_state_step_baseline")


def _fields_err(a, b) -> int:
    """Largest difference over the seven drain fields of two states."""
    return max(max_abs_err(x, y) for x, y in zip(a[:7], b[:7]))


def _drain_states(window: int, n: int, dev) -> tuple:
    """Fresh states for K3, K14, the pinned copy and the plain drain (the
    plain one carries the counters, so that one plain loop holds all
    three kernels)."""
    return (tp.make_state(window, n, device=dev),
            tp.make_state(window, n, telemetry=True, device=dev),
            tpin.make_state(window, n, device=dev),
            tp.make_state(window, n, telemetry=True, device=dev))


def _run_chunks(states, arrays, pred, first: int, chunks, where: str,
                worst: dict) -> int:
    """Runs ``chunks`` one after another from drain ``first`` through K3,
    K14 and the pinned copy (one launch a chunk each) and drain by drain
    through the plain version; after every chunk every field of K3 and
    K14 and every counter of K14 must equal the plain version's, and the
    pinned copy must equal K3 bit for bit. Returns the drains run."""
    k3, k14, pinned, plain = states
    at = first
    for chunk in chunks:
        tp.run_steps_from(k3, at, chunk, BLOCK, *arrays)
        tp.run_steps_from(k14, at, chunk, BLOCK, *arrays)
        tpin.run_steps_from(pinned, at, chunk, BLOCK, *arrays)
        for k in range(chunk):
            tp.steady_state_step_plain(plain, tp._wrap32(at + k), BLOCK, pred)
        errs = {"steady_state_step": _fields_err(k3, plain),
                "steady_state_step_telemetry": max(
                    _fields_err(k14, plain),
                    max_abs_err(k14.telemetry.buffer,
                                plain.telemetry.buffer)),
                "steady_state_step_baseline": _fields_err(pinned, k3)}
        for kernel, err in errs.items():
            worst[kernel] = max(worst[kernel], err)
            require(err == 0, f"{kernel} differs on {where}, the "
                              f"{chunk}-drain run from drain {at}: error "
                              f"{err}")
        at = tp._wrap32(at + chunk)
    return sum(chunks)


def phase_k3(dev) -> dict:
    """K3, K14 and the pinned copy, one launch a run, against the plain
    drain loop at the full width: the runs of ``DRAIN_CHUNKS``,
    majority-3 and the 2x3 grid."""
    worst = dict.fromkeys(DRAIN_KERNELS, 0)
    for name, runs in DRAIN_CHUNKS.items():
        spec = specs()[name]
        arrays = headline.spec_arrays(spec)
        for first, chunks in runs.items():
            states = _drain_states(WINDOW, spec.num_nodes, dev)
            drains = _run_chunks(states, arrays,
                                 tp.predicate_for(*arrays, dev), first,
                                 chunks, f"{name} W={WINDOW}", worst)
            committed = int(states[0].committed)
            require(committed > (drains - 4) * BLOCK,
                    f"K3 {name} committed only {committed} in {drains} "
                    f"drains")
    torch.cuda.synchronize(dev)
    return worst


def _random_board(rng, n: int, window: int, dev) -> tuple:
    """Two equal mid-flight boards (kernel's, plain version's) with
    arbitrary vote bytes, rounds, chosen bits and owners."""
    arrays = (rng.integers(0, 3, size=(n, window), dtype=np.uint8),
              rng.integers(-1, 4, size=window).astype(np.int32),
              rng.random(window) < 0.2,
              rng.integers(-1, 2 * window, size=window).astype(np.int32))
    return tuple(tq.VoteBoard(*(torch.from_numpy(a.copy()).to(dev)
                                for a in arrays)) for _ in range(2))


def _sparse_lanes(rng, window: int, n: int, frontier: int, b: int,
                  kinds: dict) -> np.ndarray:
    """One batch of ``b`` lanes: duplicate slots, stragglers a window or
    more behind the frontier (stale owners), newer slots a window ahead
    (ring wrap, reclaim), rounds 0-3 (preemption), a few nodes outside
    ``[0, n)``, a few slots outside ``[0, window)`` (JAX's index rules)
    and padding lanes (slot 0, not valid) at the end."""
    true = frontier - rng.integers(0, 4 * b, size=b)
    jump = rng.choice([0, 0, 0, 0, window, -window], size=b)
    true = np.maximum(true + jump, 0)
    true[rng.integers(0, b, size=b // 4)] = true[0]
    nodes = rng.integers(0, n, size=b)
    odd = rng.random(b) < 0.02
    nodes[odd] = rng.integers(-n - 1, n + 1, size=int(odd.sum()))
    rounds = rng.integers(0, 4, size=b)
    valid = np.ones(b, dtype=bool)
    pad = int(rng.integers(0, b // 8 + 1))
    if pad:
        valid[-pad:] = False
        true[-pad:] = 0
    slots = true % window
    far = (rng.random(b) < 0.01) & valid
    slots[far] += rng.choice([-2, -1, 1], size=int(far.sum())) * window
    kinds["dup"] += int(len(np.unique(true[valid])) < int(valid.sum()))
    kinds["stale"] += int((jump < 0).any())
    kinds["wrap"] += int((true >= window).any())
    kinds["pad"] += int(pad > 0)
    kinds["preempt"] += int((rounds > 0).any())
    kinds["range"] += int(far.any())
    return tq.pack_lanes(slots, true, nodes, rounds, valid)


def phase_k4(dev, rng) -> int:
    """K4 against its plain version: window 2^20, 64 calls of 64-4096
    lanes per spec; newly masks and boards equal after every call."""
    worst = 0
    for name in ("majority3", "grid2x3_write"):
        spec = specs()[name]
        n = spec.num_nodes
        pred = predicate(spec, dev)
        board_k, board_p = _random_board(rng, n, WINDOW, dev)
        kinds = dict.fromkeys(("dup", "stale", "wrap", "pad", "preempt",
                               "range"), 0)
        frontier = WINDOW // 2
        for step in range(64):
            b = int(rng.integers(64, 4097))
            frontier += int(rng.integers(0, 2 * b))
            lanes = torch.from_numpy(_sparse_lanes(
                rng, WINDOW, n, frontier, b, kinds)).to(dev)
            got = tq.record_and_check(board_k, lanes, pred)
            want = tq.record_and_check_plain(board_p, lanes, pred)
            err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
            worst = max(worst, err)
            require(err == 0, f"K4 differs from plain on {name} at call "
                              f"{step}")
        require(all(kinds.values()), f"K4 sequence lacks a case: {kinds}")
    torch.cuda.synchronize(dev)
    return worst


def phase_k5(dev, rng) -> int:
    """K5 against its plain version: window 2^20, all-valid batches with
    duplicate, negative and out-of-range slots, and mixed valid flags on
    distinct slots."""
    worst = 0
    board_k, board_p = _random_board(rng, 3, WINDOW, dev)
    for step in range(16):
        b = 4096
        if step % 2:
            slots = rng.permutation(WINDOW)[:b].astype(np.int32)
            valid = rng.random(b) < 0.5
        else:
            slots = rng.integers(-WINDOW - 8, WINDOW + 8,
                                 size=b).astype(np.int32)
            slots[: b // 4] = slots[0]
            valid = np.ones(b, dtype=bool)
        s, v = (torch.from_numpy(x).to(dev) for x in (slots, valid))
        tq.release(board_k, s, v)
        tq.release_plain(board_p, s, v)
        err = _boards_equal(board_k, board_p)
        worst = max(worst, err)
        require(err == 0, f"K5 differs from plain at call {step}")
    torch.cuda.synchronize(dev)
    return worst


EPOCH_WINDOW = 1 << 14   # the ProxyLeader's epoch tracker window


def epoch_planes(dev):
    """Three epochs over a 5-node union (majorities of (0,1,2), (0,1,3),
    (1,3,4)) starting at slots 0, 3000 and 9000."""
    universe = tuple(range(5))
    epoch_specs = [SimpleMajority(m).write_spec().reindexed(universe)
                   for m in ((0, 1, 2), (0, 1, 3), (1, 3, 4))]
    planes = tq.make_multi_predicate(*pad_specs(epoch_specs), device=dev)
    boundaries = torch.tensor([3000, 9000], dtype=torch.int32, device=dev)
    return planes, boundaries


def phase_k6(dev, rng) -> dict:
    """K6 against its plain version: ``check_batch_multi`` alone (0/1 and
    arbitrary int32 rows, config indices in and out of range), then 64
    epoch-segmented scatters at window 2^14 across both boundaries."""
    planes, boundaries = epoch_planes(dev)
    k = planes.masks.shape[0]
    worst_multi = 0
    for b in (1, 256, 4096, 65536):
        present = (rng.random((b, 5)) < 0.5).astype(np.int32)
        present[: b // 8] = rng.integers(-2**31, 2**31 - 1,
                                         size=(b // 8, 5))
        idx = rng.integers(-k - 1, k + 2, size=b).astype(np.int32)
        p, i = (torch.from_numpy(x).to(dev) for x in (present, idx))
        for view in (p, p.t().contiguous().t()):
            err = max_abs_err(tq.check_batch_multi(view, i, planes),
                              tq.check_batch_multi_plain(view, i, planes))
            worst_multi = max(worst_multi, err)
            require(err == 0, f"K6 check_batch_multi differs at B={b}")
    worst = 0
    board_k, board_p = _random_board(rng, 5, EPOCH_WINDOW, dev)
    kinds = dict.fromkeys(("dup", "stale", "wrap", "pad", "preempt",
                           "range"), 0)
    frontier = 2000
    for step in range(64):
        b = int(rng.integers(64, 1025))
        frontier += int(rng.integers(0, 800))
        lanes = torch.from_numpy(_sparse_lanes(
            rng, EPOCH_WINDOW, 5, frontier, b, kinds)).to(dev)
        got = tq.record_and_check_epochs(board_k, lanes, boundaries, planes)
        want = tq.record_and_check_epochs_plain(board_p, lanes, boundaries,
                                                planes)
        err = max(max_abs_err(got, want), _boards_equal(board_k, board_p))
        worst = max(worst, err)
        require(err == 0, f"K6 differs from plain at call {step}")
    require(frontier > 9000 and all(kinds.values()),
            f"K6 sequence lacks a case: frontier {frontier}, {kinds}")
    torch.cuda.synchronize(dev)
    return {"record_and_check_epochs": worst,
            "check_batch_multi": worst_multi}


def phase_k7(dev, rng) -> int:
    """K7 against its plain version on a [3, 2^20] board, to [4, 2^20]
    (a member added, rows permuted) and to [2, 2^20] (one dropped)."""
    worst = 0
    block = torch.from_numpy(rng.integers(0, 256, size=(3, WINDOW),
                                          dtype=np.uint8)).to(dev)
    for old, new in (((0, 1, 2), (2, 0, 3, 1)), ((0, 1, 2), (1, 2)),
                     ((5, 9, 2), (2, 9, 7, 5))):
        cmap = torch.from_numpy(tq.epoch_column_map(old, new)).to(dev)
        err = max_abs_err(tq.reshape_columns(block, cmap),
                          tq.reshape_columns_plain(block, cmap))
        worst = max(worst, err)
        require(err == 0, f"K7 differs from plain for {old} -> {new}")
    torch.cuda.synchronize(dev)
    return worst


RECOVERY_ROWS = 1 << 16  # the cluster bench's recovery window


def _k8_inputs(rng, n: int, dev, pad: int = 4096):
    """[2^16, n] rounds in [-1, 3] (ties everywhere, 1/8 all-NO_VOTE
    rows, 1/8 rows at one round) and ids, with the last ``pad`` rows
    the Leader's padding (NO_VOTE, id 0)."""
    s = RECOVERY_ROWS
    rounds = rng.integers(-1, 4, size=(s, n)).astype(np.int32)
    ids = rng.integers(0, 1 << 20, size=(s, n)).astype(np.int32)
    rounds[rng.random(s) < 0.125] = tv.NO_VOTE
    same = rng.random(s) < 0.125
    rounds[same] = rng.integers(0, 4, size=(int(same.sum()), 1))
    rounds[-pad:] = tv.NO_VOTE
    ids[-pad:] = 0
    return (torch.from_numpy(rounds).to(dev),
            torch.from_numpy(ids).to(dev))


def phase_k8(dev, rng) -> int:
    """K8 against its plain version on [2^16, 3] and [2^16, 6]."""
    worst = 0
    for n in (3, 6):
        rounds, ids = _k8_inputs(rng, n, dev)
        got = tv.safe_values(rounds, ids)
        want = tv.safe_values_plain(rounds, ids)
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        worst = max(worst, err)
        require(err == 0, f"K8 differs from plain at N={n}")
        require(not got[0][-4096:].any(), "K8 voted on a padding row")
    torch.cuda.synchronize(dev)
    return worst


#: [B, L, W] shapes of K9-K11's comparison: the cluster's fast and slow
#: path ([3, 5, 8], [5, 5, 2048] at the span limit), depset_lt's
#: [4096, 3, 32], a wide arbitrary batch and an odd width.
DEPSET_SHAPES = ((4096, 5, 2048), (4096, 3, 32), (3, 5, 8), (5, 5, 2048),
                 (1, 1, 37))


def _depset_batch(rng, shape, base: int, kind: str, dev) -> td.DepSetBatch:
    """Watermarks around the window at ``base``; tail bytes 0/1 at 90%
    (long runs), or arbitrary."""
    b, l, w = shape
    wm = np.clip(base + rng.integers(-16, w + 16, size=(b, l)),
                 -2**31, 2**31 - 1).astype(np.int32)
    if kind == "bits":
        tails = (rng.random((b, l, w)) < 0.9).astype(np.uint8)
    else:
        tails = rng.integers(0, 256, size=(b, l, w), dtype=np.uint8)
    return td.DepSetBatch(torch.from_numpy(wm).to(dev),
                          torch.from_numpy(tails).to(dev),
                          torch.tensor(base, dtype=torch.int32).to(dev))


def _aliased(batch: td.DepSetBatch, rng) -> td.DepSetBatch:
    """Every row written as row 0's normalized set: rows b >= 1 move up
    to 8 ids below the watermark into tail bytes, so the rows are equal
    only after normalization (exactly so for 0/1 bytes)."""
    n = td.normalized_plain(td.DepSetBatch(*(t.cpu() for t in batch)))
    b, l, w = n.tails.shape
    base = int(n.tail_base)
    top = np.repeat(n.watermarks[:1].numpy().astype(np.int64), b, axis=0)
    tails = np.repeat(n.tails[:1].numpy(), b, axis=0)
    low = np.maximum(top - rng.integers(0, 9, size=(b, l)), base)
    move = (low < top) & (top - base <= w)
    move[0] = False
    pos = np.arange(w)[None, None, :]
    tails[move[:, :, None] & (pos >= (low - base)[:, :, None])
          & (pos < (top - base)[:, :, None])] = 1
    wm = np.where(move, low, top).astype(np.int32)
    dev = batch.tails.device
    return td.DepSetBatch(torch.from_numpy(wm).to(dev),
                          torch.from_numpy(tails).to(dev),
                          n.tail_base.to(dev))


def phase_depset(dev, rng) -> dict:
    """K9, K10 (both modes) and K11 against their plain versions, exact,
    at every shape of ``DEPSET_SHAPES`` for window bases in the middle,
    near 2^31 - 1 and below 0 (negative watermarks), bits and arbitrary
    bytes; K11 also on batches equal only after normalization, and with
    one byte changed."""
    worst = dict.fromkeys(("normalized", "union_reduce", "conflict_max",
                           "all_equal"), 0)
    seen = {"equal": 0, "unequal": 0}

    def check(name, got, want):
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        worst[name] = max(worst[name], err)
        require(err == 0, f"{name} differs from plain at {shape} base "
                          f"{base} ({kind})")

    for shape in DEPSET_SHAPES:
        w = shape[2]
        for base in (1000, 2**31 - 1 - w // 2, -w // 2 - 5):
            for kind in ("bits", "bytes"):
                batch = _depset_batch(rng, shape, base, kind, dev)
                check("normalized", td.normalized(batch),
                      td.normalized_plain(batch))
                check("union_reduce", td.union_reduce(batch),
                      td.union_reduce_plain(batch))
                seqs = torch.from_numpy(rng.integers(
                    -2**31, 2**31, size=shape[0], dtype=np.int64)
                    .astype(np.int32)).to(dev)
                got_seq, got = td.conflict_max(seqs, batch)
                want_seq, want = td.conflict_max_plain(seqs, batch)
                check("conflict_max", (got_seq, *got),
                      (want_seq, *want))
                cases = [batch, _aliased(batch, rng)]
                changed = _aliased(batch, rng)
                if shape[0] > 1:
                    changed.tails[-1, -1, -1] ^= 1
                    cases.append(changed)
                for case in cases:
                    got, want = td.all_equal(case), td.all_equal_plain(case)
                    check("all_equal", (got,), (want,))
                    seen["equal" if bool(want) else "unequal"] += 1
    require(all(seen.values()), f"K11 cases lack an outcome: {seen}")
    torch.cuda.synchronize(dev)
    return worst


#: K12's row widths and batch sizes (n 3 and B 1..2^16 cover the GC
#: roles' [leaders, replicas] = [2, 3] and wider deployments; 31-33,
#: 64-65, 128 and 1001 the warp kernel's edges: one lane per element,
#: several per lane, up to 1024 in one tile of registers).
WATERMARK_WIDTHS = (1, 2, 3, 5, 7, 9, 31, 32, 33, 64, 65, 128, 1001)
WATERMARK_ROWS = (1, 4096, 1 << 16)
#: Widths above 1024, which the warp kernel takes in tiles of 1024
#: against the row read again by chunks of 32, at these batch sizes.
WATERMARK_TILED_WIDTHS = (1025, 2500)
WATERMARK_TILED_ROWS = (1, 4096)
#: Widths above this are held at a spread of quorum sizes, not at every
#: size in [1, n].
WATERMARK_EVERY_Q = 65
INT32_EXTREMES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2,
                           2**31 - 1], dtype=np.int32)


def _quorum_sizes(n: int) -> list:
    """Every size in [1, n] up to ``WATERMARK_EVERY_Q``, else a spread;
    and the out-of-range 0, -1 and n + 1."""
    inside = range(1, n + 1) if n <= WATERMARK_EVERY_Q else sorted(
        {1, 2, 3, n // 3, n // 2, n // 2 + 1, n - 2, n - 1, n})
    return [*inside, 0, -1, n + 1]


def _busy(dev) -> None:
    """Enqueue some milliseconds of matrix products on the current
    stream, so that work queued behind them waits."""
    a = torch.ones((4096, 4096), device=dev)
    for _ in range(8):
        a @ a


def side_stream_check(dev, name: str, stale, fresh, launch, want) -> None:
    """A launch inside ``with torch.cuda.stream(s):`` must be ordered on
    ``s``: ``fresh`` is copied into the input ``stale`` on ``s`` behind
    some milliseconds of work, and the launch that follows on ``s`` must
    read it (a launch on another stream would read the stale input)."""
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    with torch.cuda.stream(side):
        require(_build.stream_handle(dev.index) == side.cuda_stream,
                f"{name}: the stream handle does not follow "
                f"torch.cuda.stream")
        _busy(dev)
        stale.copy_(fresh)
        got = launch()
    side.synchronize()
    require(torch.equal(got, want),
            f"{name} launched inside a side stream's context was not "
            f"ordered on that stream")
    torch.cuda.synchronize(dev)


def phase_watermark(dev, rng) -> dict:
    """K12 and K13 against their plain versions, exact: K12 at every
    width of ``WATERMARK_WIDTHS`` and batch of ``WATERMARK_ROWS``, and
    of ``WATERMARK_TILED_WIDTHS`` and ``WATERMARK_TILED_ROWS``, for
    every quorum size in [1, n], per-row sizes, and 0, -1, n + 1, with a
    quarter of the rows near +-2^31; its vector form on int64 matrices
    that wrap; K13 on bool, byte and signed rows of every kind the
    reference's tests and libbench use."""
    worst = {"quorum_watermark": 0, "contiguous_prefix_length": 0}

    def check(name, got, want, what):
        err = max_abs_err(got, want)
        worst[name] = max(worst[name], err)
        require(got.shape == want.shape and err == 0,
                f"{name} differs from plain at {what}")

    cases = [(n, b) for n in WATERMARK_WIDTHS for b in WATERMARK_ROWS]
    cases += [(n, b) for n in WATERMARK_TILED_WIDTHS
              for b in WATERMARK_TILED_ROWS]
    for n, b in cases:
        w = rng.integers(-1000, 1000, size=(b, n)).astype(np.int32)
        w[: b // 4] = rng.choice(INT32_EXTREMES, size=(b // 4, n))
        w[b // 4: b // 2] = rng.integers(0, 3, size=(b // 2 - b // 4, n))
        wt = torch.from_numpy(w).to(dev)
        for q in _quorum_sizes(n):
            check("quorum_watermark", tw.quorum_watermark(wt, q),
                  tw.quorum_watermark_plain(wt, q), f"n={n} B={b} q={q}")
        per_row = torch.from_numpy(rng.integers(
            -1, n + 2, size=b).astype(np.int32)).to(dev)
        check("quorum_watermark", tw.quorum_watermark(wt, per_row),
              tw.quorum_watermark_plain(wt, per_row),
              f"n={n} B={b} per-row q")
        # The vector form's strided read: columns of a [n, B] matrix.
        cols = wt.t().contiguous()
        check("quorum_watermark", tw.quorum_watermark(cols.t(), 1),
              tw.quorum_watermark_plain(wt, 1), f"n={n} B={b} strided")
        # The out= buffer: written and returned itself.
        out = torch.full((b,), 7, dtype=torch.int32, device=dev)
        got = tw.quorum_watermark(cols.t(), (n + 1) // 2, out=out)
        require(got is out, "quorum_watermark(out=) returned another "
                "tensor")
        check("quorum_watermark", out,
              tw.quorum_watermark_plain(wt, (n + 1) // 2),
              f"n={n} B={b} strided, out=")
    # The transport of a GC fold: 4096 rows of 5, the input rewritten on
    # a side stream just before the launch.
    stale = torch.zeros((4096, 5), dtype=torch.int32, device=dev)
    fresh = torch.from_numpy(rng.integers(-1000, 1000, size=(4096, 5))
                             .astype(np.int32)).to(dev)
    side_stream_check(dev, "quorum_watermark", stale, fresh,
                      lambda: tw.quorum_watermark(stale, 3),
                      tw.quorum_watermark_plain(fresh, 3))
    for shape in ((3, 2), (5, 3), (64, 7), (33, 5), (1001, 3), (1025, 2),
                  (3, 1), (2, 40), (0, 3), (5, 3)):
        m = rng.integers(0, 1 << 34, size=shape, dtype=np.int64)
        for q in range(1, max(shape[0], 1) + 1):
            got = tw.quorum_watermark_vector(m, q, device=dev)
            want = tw.quorum_watermark_vector(m, q, device="cpu")
            require(np.array_equal(got, want),
                    f"quorum_watermark_vector differs from plain at "
                    f"{shape} q={q}")
    w = np.array([[2**31 + 5, 1], [3, 2**32 + 7], [2**33, 4]], np.int64)
    require(tw.quorum_watermark_vector(w, 2, device=dev).tolist() == [0, 4],
            "quorum_watermark_vector does not wrap int64 as the reference")

    present = np.ones(4096, dtype=bool)
    present[2048] = False
    rows = np.ones((4096, 3), dtype=bool)
    rows[rng.integers(0, 4096, size=600), rng.integers(0, 3, size=600)] = 0
    cases = [present, rows,
             np.array([2, 3, 1, 0], np.uint8),
             rng.integers(0, 4, size=(4096, 64)).astype(np.uint8),
             rng.integers(-3, 4, size=(1024, 40)).astype(np.int8),
             rng.integers(-3, 4, size=(1024, 40)).astype(np.int16),
             rng.integers(1, 70000, size=(1024, 40)).astype(np.int32),
             rng.integers(-2**40, 2**40, size=(1024, 5)),
             np.ones((64, 100003), dtype=bool),
             np.ones((3, 0), dtype=bool), np.zeros((0, 5), dtype=bool)]
    for x in cases:
        xt = torch.from_numpy(x).to(dev)
        check("contiguous_prefix_length", tw.contiguous_prefix_length(xt),
              tw.contiguous_prefix_length_plain(xt),
              f"{x.dtype} {tuple(x.shape)}")
    require(int(tw.contiguous_prefix_length(
        torch.from_numpy(present).to(dev))) == 2048,
        "K13 misses libbench's prefix of 2048")
    torch.cuda.synchronize(dev)
    return worst


#: Every kernel wrapper, by the name of its row in the kernels line.
WRAPPERS = {
    "quorum_hit": tq.quorum_hit,
    "record_block": tq.record_block,
    "steady_state_step": tp.steady_state_step,
    "record_and_check": tq.record_and_check,
    "release": tq.release,
    "record_and_check_epochs": tq.record_and_check_epochs,
    "check_batch_multi": tq.check_batch_multi,
    "reshape_columns": tq.reshape_columns,
    "safe_values": tv.safe_values,
    "normalized": td.normalized,
    "union_reduce": td.union_reduce,
    "conflict_max": td.conflict_max,
    "all_equal": td.all_equal,
    "quorum_watermark": tw.quorum_watermark,
    "contiguous_prefix_length": tw.contiguous_prefix_length,
    "steady_state_step_telemetry": tp.telemetry_drain,
    "steady_state_step_baseline": tpin.steady_state_step,
    "count_matching_replies": tv.count_matching_replies,
    "union": td.union,
    "intersect": td.intersect,
    "compact": td.compact,
    "equal": td.equal,
    "size": td.size,
    "contains": td.contains,
    "link_keep_mask": tsw.link_keep_mask_tensor,
    "shard_vote_count": tp.shard_vote_count,
    "shard_commit": tp.shard_commit,
    "shard_fold": tp.shard_fold,
    **multichip_board.PINNED_KERNELS,
}
#: The kernels of the main path, K1-K7 (check_batch_multi, K6's
#: stateless predicate, is not on it).
MAIN_PATH = ("quorum_hit", "record_block", "steady_state_step",
             "record_and_check", "release", "record_and_check_epochs",
             "reshape_columns")


#: The runs whose launches the kernels line counts: phases 11, 12, 14,
#: 16, 18, 21, 23-24, 25 and 26 (``*_traffic`` entries of
#: ``launches_by_path`` are subsets of these).
MAIN_PATHS = ("headline_and_tracker", "cluster", "epaxos", "bpaxos",
              "telemetry", "libbench", "geo", "sharded", "sharded_board")
#: The kernels of the telemetry path (phase 18) and of the libbench path
#: (phase 21).
TELEMETRY_PATH = ("steady_state_step", "steady_state_step_telemetry",
                  "steady_state_step_baseline")
LIBBENCH_PATH = ("quorum_watermark", "contiguous_prefix_length", "union",
                 "union_reduce")
#: The kernels of the geo path (phases 23-24): K5 and K6 from the WPaxos
#: leaders' trackers, K18 from the geo transport's waves.
GEO_PATH = ("release", "record_and_check_epochs", "link_keep_mask")
#: The kernels of the sharded path (phase 25): K19-K21.
SHARDED_PATH = multichip.SHARDED_KERNELS
#: Phase 25's meshes, ``(group, slot, spec)``, at the full width.
SHARDED_MESHES = multichip.CHECK_MESHES
#: Drains per mesh: the 32-block ring wraps.
SHARDED_DRAINS = 40


def _rows(batch: td.DepSetBatch) -> int:
    """Bytes of a batch's watermarks and tails."""
    return 4 * batch.watermarks.numel() + batch.tails.numel()


def _shape(batch: td.DepSetBatch) -> str:
    return "[B, L, W] = " + str(list(batch.tails.shape))


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "drains"):
            wrapper.drains = 0


#: ``{path: {drain kernel: drains}}``: the drains K3, K14 and the pinned
#: copy ran on the paths that drive them from this process (phases 11 and
#: 18), beside their launches.
DRAINS_BY_PATH: dict = {}


def record_drains(path: str) -> None:
    DRAINS_BY_PATH[path] = {name: WRAPPERS[name].drains
                            for name in DRAIN_KERNELS}


def phase_cluster(dev) -> tuple[dict, dict]:
    """The MultiPaxos cluster path at full width; its gates raise inside
    ``multipaxos_sim.run``. The counts read after it include the
    pipelined trackers' construction prewarm; the launch gate reads the
    arms' traffic alone."""
    reset_launches()
    try:
        result = multipaxos_sim.run(dev, writes=CLUSTER_WRITES,
                                    burst=CLUSTER_WRITES)
    except multipaxos_sim.GateFailure as exc:
        raise SmokeFailure(f"cluster: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    traffic = result["launches"]
    require(all(traffic[name] > 0
                for name in multipaxos_sim.CLUSTER_KERNELS),
            f"a kernel of the cluster path never launched on its "
            f"traffic: {traffic}")
    return result, launches


def phase_epaxos(dev) -> tuple[dict, dict, dict]:
    """The EPaxos path: the cluster bench and the depset_lt twin; their
    gates raise inside ``run``. K10 and K11 must have launched on the
    cluster's traffic."""
    reset_launches()
    try:
        cluster = epaxos_sim.run(dev)
        pairs = depset_lt.run(dev)
    except (epaxos_sim.GateFailure, depset_lt.GateFailure) as exc:
        raise SmokeFailure(f"epaxos: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    traffic = cluster["launches"]
    require(all(traffic[name] > 0 for name in epaxos_sim.CLUSTER_KERNELS),
            f"a kernel of the EPaxos path never launched on its traffic: "
            f"{traffic}")
    return cluster, pairs, launches


def phase_bpaxos(dev) -> tuple[dict, dict]:
    """The BPaxos path: the cluster bench's three arms; its gates raise
    inside ``run``. K10 and K12 must have launched on the cluster's
    traffic."""
    reset_launches()
    try:
        result = bpaxos_sim.run(dev, commands=BPAXOS_COMMANDS)
    except bpaxos_sim.GateFailure as exc:
        raise SmokeFailure(f"bpaxos: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    traffic = result["launches"]
    require(all(traffic[name] > 0 for name in bpaxos_sim.CLUSTER_KERNELS),
            f"a kernel of the BPaxos path never launched on its traffic: "
            f"{traffic}")
    return result, launches


def phase_main_path(dev, rng) -> tuple[dict, dict, dict]:
    reset_launches()
    result = headline.measure(dev, latency_budget_s=10.0)
    spec = specs()["majority3"]
    checker = tq.TpuQuorumChecker(spec, window=WINDOW, device=dev)
    chosen = 0
    for d in range(64):
        arrivals = (rng.random((3, BLOCK)) < 0.6).astype(np.uint8)
        hits = checker.check_block(arrivals)
        require(np.array_equal(hits, spec.evaluate(arrivals.T)),
                f"check_block disagrees with the host oracle at drain {d}")
        require(np.array_equal(checker.check_batch(arrivals.T), hits),
                "check_batch disagrees with check_block")
        newly = checker.record_block(d * BLOCK, arrivals)
        require(np.array_equal(newly, hits),
                f"record_block disagrees with the host oracle at drain {d}")
        chosen += int(newly.sum())
    result["checker_chosen"] = chosen
    # The ProxyLeader's vote path at full width: every arm is checked
    # against its dict oracle inside run() (a mismatch raises).
    votes = tracker_lt.run(dev)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    record_drains("headline_and_tracker")
    require(all(launches[name] > 0 for name in MAIN_PATH),
            f"a kernel of the main path never launched: {launches}")
    return result, votes, launches

#: Starts of phase 17's runs: drain 0, and near 2^31 (the index, the
#: proposals and the lag wrap as int32; each 40-drain run crosses the wrap
#: inside one launch).
TELEMETRY_STARTS = (0, 2**31 - 20)
#: Phase 17's boards and chunks at window/block 1 to 6: at 1 and 2 the
#: new, old and GC blocks alias (the occupancy is read after pass 1 and
#: again after pass 2 on one column) and the kernel takes its memory path;
#: at 3 and 4 the register carry's next and ahead columns are zeroed by a
#: GC before their drain instead of loaded; at 3, 5 and 6 (rings that are
#: not a power of two) a run that crosses the int32 wrap takes the memory
#: path, the others the register carry.
TELEMETRY_RUNS = tuple((ratio * BLOCK, (1, 2, 3, 40))
                       for ratio in range(1, 7))
#: Phase 17's other predicates at the full width, each a register form
#: of its own that the headline's two shapes do not take: a group of 5, a
#: 2x3 read grid, a 2x3 write grid through a permutation, a 3x3 grid, a
#: 3x1 grid (run as one row of the other kind), WPaxos's 3x3 zone grid
#: (a majority of every row: three groups) and two overlapping groups (the
#: loop over groups), and a board of 17 acceptors (the memory path); runs
#: of ``OTHER_CHUNKS`` one after another.
OTHER_FORMS = ("majority5", "grid2x3_read", "grid_perm_write",
               "grid3x3_write", "grid3x1_write", "zonegrid3x3", "groups2",
               "majority17")
OTHER_CHUNKS = (1, 3, 64)


def form_specs() -> dict:
    """The headline's two specs and phase 17's other forms, by name."""
    return {**specs(),
            "grid3x3_write": Grid([[0, 1, 2], [3, 4, 5],
                                   [6, 7, 8]]).write_spec(),
            "grid3x1_write": Grid([[0], [1], [2]]).write_spec(),
            "zonegrid3x3": ZoneGrid([[0, 1, 2], [3, 4, 5],
                                     [6, 7, 8]]).write_spec(),
            "groups2": QuorumSpec(np.array([[1, 1, 0], [0, 1, 1]]),
                                  np.array([1, 1]), ALL, (0, 1, 2)),
            "majority17": SimpleMajority(range(17)).write_spec()}


def drain_forms(dev) -> dict:
    """Device µs a drain of each drain kernel in each form at the full
    width (``launch_ms`` of a run of ``FIGURE_DRAINS`` drains, over the
    drains): the headline's two and phase 17's other forms."""
    out = {name: {} for name in DRAIN_KERNELS}
    # Some milliseconds of drains first, so that the card's clocks have
    # ramped up before the first form is timed.
    warm = tp.make_state(WINDOW, 3, device=dev)
    tp.run_steps_from(warm, 0, 1 << 15, BLOCK,
                      *headline.spec_arrays(specs()["majority3"]))
    for form, spec in form_specs().items():
        if form not in ("majority3", "grid2x3_write") + OTHER_FORMS:
            continue
        arrays = headline.spec_arrays(spec)
        for name, module, telemetry in (
                ("steady_state_step", tp, False),
                ("steady_state_step_telemetry", tp, True),
                ("steady_state_step_baseline", tpin, False)):
            kw = {"telemetry": True} if telemetry else {}
            state = module.make_state(WINDOW, spec.num_nodes, device=dev,
                                      **kw)
            at = [0]

            def run():
                module.run_steps_from(state, at[0], FIGURE_DRAINS, BLOCK,
                                      *arrays)
                at[0] += FIGURE_DRAINS
            out[name][form] = launch_ms(run, 7) * 1e3 / FIGURE_DRAINS
    return out


def _nonzero_proposals(first: int, drains: int) -> int:
    """Host count of the proposals ``lane * 7 + i * 13 + 1`` that are not
    0 as int32 (they wrap)."""
    lanes = np.arange(BLOCK, dtype=np.int64)
    return int(sum(((lanes * 7 + i * 13 + 1) % 2**32 != 0).sum()
                   for i in range(first, first + drains)))


def _clone(state):
    """A copy of a drain state, counters included."""
    tel = state.telemetry
    copy = tp.PipelineState(*(t.clone() for t in state[:7]))
    if tel is None:
        return copy
    fresh = tp.make_telemetry(tel.occupancy.numel() - 1,
                              device=tel.buffer.device)
    fresh.buffer.copy_(tel.buffer)
    return copy._replace(telemetry=fresh)


def phase_telemetry(dev) -> dict:
    """The aliasing ratios and the kernel's other forms (K3, K14 and the
    pinned copy against the plain loop, as phase 5 does), the counters
    re-adding, no hidden sync on the telemetry-on runs, one collect, and
    a run inside a side stream's context ordered on that stream."""
    worst = dict.fromkeys(DRAIN_KERNELS, 0)
    others = form_specs()
    for name in OTHER_FORMS:
        spec = others[name]
        arrays = headline.spec_arrays(spec)
        states = _drain_states(WINDOW, spec.num_nodes, dev)
        drains = _run_chunks(states, arrays, tp.predicate_for(*arrays, dev),
                             2**31 - 40, OTHER_CHUNKS, f"{name} W={WINDOW}",
                             worst)
        committed = int(states[0].committed)
        require(committed > (drains - 4) * BLOCK,
                f"K3 {name} committed only {committed} in {drains} drains")
    for (name, n), (window, chunks), first in itertools.product(
            (("majority3", 3), ("grid2x3_write", 6)), TELEMETRY_RUNS,
            TELEMETRY_STARTS):
        arrays = headline.spec_arrays(specs()[name])
        states = _drain_states(window, n, dev)
        at = f"{name} W={window}"
        drains = _run_chunks(states, arrays, tp.predicate_for(*arrays, dev),
                             first, chunks, at, worst)
        on = states[1]
        snap = tobs.collect(on)
        committed = int(on.committed)
        require(snap.drains == drains and sum(snap.lag_hist) == drains
                and sum(snap.occupancy) == committed
                and snap.shard_committed == (committed,)
                and snap.proposed == _nonzero_proposals(first, drains)
                and snap.pad_lanes == 0
                and committed > (drains - 4) * BLOCK,
                f"K14's counters do not re-add on {at} from {first}: "
                f"{snap}, committed {committed}")
    # No hidden sync on telemetry-on runs: under the sync debug mode any
    # synchronising CUDA call raises. Then one collect.
    arrays = headline.spec_arrays(specs()["majority3"])
    state = tp.make_state(WINDOW, 3, telemetry=True, device=dev)
    tp.run_steps_from(state, 0, 1, BLOCK, *arrays)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        at = 1
        for chunk in (1, 64, 4096):
            tp.run_steps_from(state, at, chunk, BLOCK, *arrays)
            at += chunk
    finally:
        torch.cuda.set_sync_debug_mode("default")
    snap = tobs.collect(state)
    require(snap.drains == at and snap.committed == int(state.committed),
            f"collect after the guarded runs: {snap}")
    # A run launched inside ``with torch.cuda.stream(s):`` is ordered on
    # s: the state it resumes is copied in on s behind some milliseconds
    # of work (a launch on another stream would read a stale state), and
    # K14's scratch is the side stream's own.
    for telemetry in (False, True):
        src = tp.make_state(WINDOW, 3, telemetry=telemetry, device=dev)
        tp.run_steps_from(src, 0, 10, BLOCK, *arrays)
        want = tp.run_steps_from(_clone(src), 10, 3, BLOCK, *arrays)
        target = tp.make_state(WINDOW, 3, telemetry=telemetry, device=dev)
        side = torch.cuda.Stream(dev)
        torch.cuda.synchronize(dev)
        with torch.cuda.stream(side):
            require(_build.stream_handle(dev.index) == side.cuda_stream,
                    "the drain's stream handle does not follow "
                    "torch.cuda.stream")
            _busy(dev)
            for dst, got in zip(target[:7], src[:7]):
                dst.copy_(got)
            if telemetry:
                target.telemetry.buffer.copy_(src.telemetry.buffer)
            tp.run_steps_from(target, 10, 3, BLOCK, *arrays)
        side.synchronize()
        err = _fields_err(target, want)
        if telemetry:
            err = max(err, max_abs_err(target.telemetry.buffer,
                                       want.telemetry.buffer))
        require(err == 0, f"a run (telemetry {telemetry}) launched inside "
                          f"a side stream's context was not ordered on "
                          f"that stream")
    torch.cuda.synchronize(dev)
    return worst


def phase_overhead(dev) -> tuple[dict, dict]:
    """The telemetry path: the overhead twin at the reference's widths
    and the headline width, with the reference's ``--smoke`` knobs."""
    reset_launches()
    result = telemetry_overhead.run(
        dev, smoke=True,
        widths=(*telemetry_overhead.WIDTHS, (WINDOW, BLOCK)))
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    record_drains("telemetry")
    require(all(row["arms_agree"] for row in result["pairs"].values()),
            f"the overhead arms disagree: {result['pairs']}")
    require(all(launches[name] > 0 for name in TELEMETRY_PATH),
            f"a kernel of the telemetry path never launched: {launches}")
    return result, launches


REPLY_ROWS = (1, 4096, 1 << 16)
REPLY_WIDTHS = (1, 2, 3, 5, 7, 16)


def phase_k15(dev, rng) -> int:
    """K15 against its plain version, exact: ids from a few values (ties
    everywhere) with an eighth near +-2^31, 30% of the replies invalid,
    an eighth of the rows with none valid; and an empty S."""
    worst = 0
    seen = {"tie": 0, "none_valid": 0}
    for s in REPLY_ROWS:
        for n in REPLY_WIDTHS:
            ids = rng.integers(0, 4, size=(s, n)).astype(np.int32)
            far = rng.random((s, n)) < 0.125
            ids[far] = rng.choice(INT32_EXTREMES, size=int(far.sum()))
            valid = rng.random((s, n)) < 0.7
            valid[rng.random(s) < 0.125] = False
            it, vt = (torch.from_numpy(x).to(dev) for x in (ids, valid))
            got = tv.count_matching_replies(it, vt)
            want = tv.count_matching_replies_plain(it, vt)
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            worst = max(worst, err)
            require(err == 0, f"K15 differs from plain at S={s} N={n}")
            counts = got[1].cpu().numpy()
            seen["none_valid"] += int((counts == 0).any())
            seen["tie"] += int(n >= 2 and (counts * 2 <= n).any())
    empty = torch.zeros((0, 3), dtype=torch.int32, device=dev)
    modal, count = tv.count_matching_replies(empty, empty.bool())
    require(modal.shape == (0,) and count.shape == (0,),
            "K15 on an empty batch")
    require(all(seen.values()), f"K15 cases lack an outcome: {seen}")
    torch.cuda.synchronize(dev)
    return worst


#: libbench's dependency batch, then phase 13's shapes.
PAIR_SHAPES = ((4096, 3, 64),) + DEPSET_SHAPES


def phase_depset_rest(dev, rng) -> dict:
    """K16 and K17 in every mode against their plain versions, exact."""
    names = ("union", "intersect", "compact", "equal", "size", "contains")
    worst = dict.fromkeys(names, 0)
    seen = {"equal": 0, "unequal": 0}

    def check(name, got, want, what):
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        worst[name] = max(worst[name], err)
        require(err == 0, f"{name} differs from plain at {what}")

    for shape in PAIR_SHAPES:
        b, l, w = shape
        for base in (1 << 16, 2**31 - 1 - w // 2, -w // 2 - 5):
            for kind in ("bits", "bytes"):
                what = f"{shape} base {base} ({kind})"
                x = _depset_batch(rng, shape, base, kind, dev)
                y = _depset_batch(rng, shape, base, kind, dev)
                nx = td.normalized(x)
                for p, q in ((x, y), (x, x), (nx, nx)):
                    check("union", td.union(p, q), td.union_plain(p, q),
                          what)
                    check("intersect", td.intersect(p, q),
                          td.intersect_plain(p, q), what)
                    eq = td.equal(p, q)
                    check("equal", eq, td.equal_plain(p, q), what)
                    seen["equal"] += int(eq.any())
                    seen["unequal"] += int((~eq).any())
                check("size", td.size(x), td.size_plain(x), what)
                for executed in (
                        np.int32(base + w // 2),
                        rng.integers(base - 8, base + w + 8, size=l),
                        rng.integers(base - 8, base + w + 8, size=(1, l)),
                        rng.integers(base - 8, base + w + 8, size=(b, l))):
                    ex = torch.from_numpy(np.array(np.clip(
                        np.asarray(executed, np.int64), -2**31,
                        2**31 - 1), dtype=np.int32)).to(dev)
                    check("compact", td.compact(x, ex),
                          td.compact_plain(x, ex), f"{what} executed "
                          f"{tuple(ex.shape)}")
                leader = torch.from_numpy(rng.integers(
                    -1, l + 1, size=b).astype(np.int32)).to(dev)
                vid = torch.from_numpy(np.clip(
                    base + rng.integers(-w, 2 * w, size=b), -2**31,
                    2**31 - 1).astype(np.int32)).to(dev)
                check("contains", td.contains(x, leader, vid),
                      td.contains_plain(x, leader, vid), what)
                for lead, v in ((-1, base - 1), (l, base + w - 1),
                                (l + 3, base + w)):
                    v = min(max(v, -2**31), 2**31 - 1)
                    check("contains", td.contains(x, lead, v),
                          td.contains_plain(x, lead, v), f"{what} scalar")
    require(all(seen.values()), f"K17 equal lacks an outcome: {seen}")
    torch.cuda.synchronize(dev)
    return worst


def phase_libbench(dev) -> tuple[dict, dict]:
    """The libbench path: the twin at the reference's sizes."""
    reset_launches()
    result = libbench.run(dev)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    require(all(launches[name] > 0 for name in LIBBENCH_PATH),
            f"a kernel of the libbench path never launched: {launches}")
    return result, launches



#: K18's zones (the storm's topology) and wave sizes (1-31: a wave
#: shorter than the 16-frame head, 8-frame groups, and ragged tails).
K18_ZONES = 1000
K18_WAVES = (1, 15, 16, 17, 31, 32, 33, 500, 4096, 1 << 16)
#: Ragged lengths of the offset views, and of the transport entry.
K18_RAGGED = (1, 15, 16, 17, 31, 33, 500)


def _k18_ids(rng, n: int, z: int) -> tuple:
    """A wave's zone ids in [-1, Z-1] with every edge of JAX's index
    rule placed at both ends of the source and destination columns."""
    edges = np.array([-1, -z - 1, -z - 2, -5 * z, -2**31, z, z + 1, 7 * z,
                      2**31 - 1], np.int32)
    src = rng.integers(-1, z, n).astype(np.int32)
    dst = rng.integers(-1, z, n).astype(np.int32)
    k = min(n, len(edges))
    src[:k] = edges[:k]
    dst[n - k:] = edges[len(edges) - k:]
    return src, dst


def _k18_up(rng, z: int) -> np.ndarray:
    up = rng.random((z + 1, z + 1)) >= 0.2
    up[z, :] = True
    up[:, z] = True
    return up


def phase_k18(dev, rng) -> int:
    """K18 against its plain version (on the card and on the host), the
    transport-facing entry against it, a partition between two calls,
    and the result's ownership."""
    worst = 0
    z = K18_ZONES
    up = _k18_up(rng, z)
    up_t = torch.from_numpy(up).to(dev)
    for n in K18_WAVES:
        src, dst = _k18_ids(rng, n, z)
        src_t, dst_t = (torch.from_numpy(a).to(dev) for a in (src, dst))
        got = tsw.link_keep_mask_tensor(src_t, dst_t, up_t)
        want = tsw.link_keep_mask_plain(src_t, dst_t, up_t)
        host = tsw.link_keep_mask_plain(torch.from_numpy(src),
                                        torch.from_numpy(dst),
                                        torch.from_numpy(up))
        err = max_abs_err(got, want)
        worst = max(worst, err, max_abs_err(got.cpu(), host))
        require(err == 0 and torch.equal(got.cpu(), host),
                f"link_keep_mask differs from plain at n={n}")
        entry = tsw.link_keep_mask_cuda(src, dst, up)
        require(np.array_equal(entry, host.numpy()),
                f"link_keep_mask_cuda differs from plain at n={n}")
    # Views whose start is 1-15 elements off a 16-byte boundary, with
    # src, dst and out offset alike (a head, 8-frame groups and a tail)
    # and apart (no common aligned frame: every frame scalar).
    for n in K18_RAGGED:
        src, dst = _k18_ids(rng, n + 16, z)
        src_t, dst_t = (torch.from_numpy(a).to(dev) for a in (src, dst))
        out_t = torch.zeros(n + 16, dtype=torch.bool, device=dev)
        for off in range(1, 16):
            for d_off, o_off in ((off, off), (off, 0), ((off + 1) % 16, off),
                                 (0, (off * 7) % 16)):
                s_v, d_v = src_t[off:off + n], dst_t[d_off:d_off + n]
                want = tsw.link_keep_mask_plain(s_v, d_v, up_t)
                got = tsw.link_keep_mask_tensor(s_v, d_v, up_t)
                into = tsw.link_keep_mask_tensor(s_v, d_v, up_t,
                                                 out=out_t[o_off:])
                err = max(max_abs_err(got, want), max_abs_err(into, want))
                worst = max(worst, err)
                require(err == 0 and into.data_ptr() == out_t[o_off:]
                        .data_ptr(),
                        f"link_keep_mask differs from plain at n={n}, "
                        f"offsets src {off} dst {d_off} out {o_off}")
        # The transport entry at ragged lengths, each after a longer
        # wave (its reused buffers hold a stale tail).
        tsw.link_keep_mask_cuda(*_k18_ids(rng, 4096, z), up)
        entry = tsw.link_keep_mask_cuda(src[:n], dst[:n], up)
        require(np.array_equal(entry, tsw.link_keep_mask_plain(
            torch.from_numpy(src[:n]), torch.from_numpy(dst[:n]),
            torch.from_numpy(up)).numpy()),
            f"link_keep_mask_cuda differs from plain at n={n}")
    # The FIFO arm's wave, its ids rewritten on a side stream just before
    # the launch (from the sentinel row, every link up, to live ids).
    n = sim_core_ab.FIFO_DEPTH
    src, dst = _k18_ids(rng, n, z)
    stale = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fresh = torch.from_numpy(src).to(dev)
    dst_t = torch.from_numpy(dst).to(dev)
    side_stream_check(dev, "link_keep_mask", stale, fresh,
                      lambda: tsw.link_keep_mask_tensor(stale, dst_t, up_t),
                      tsw.link_keep_mask_plain(fresh, dst_t, up_t))
    # A partition between two calls: the topology hands out a new
    # up-matrix, and the cut link's frames (both ways) flip to dropped.
    topo = GeoTopology({f"r{i}": [f"z{i}-{j}" for j in range(10)]
                        for i in range(z // 10)}, seed=SEED)
    a, b = topo.zones[3], topo.zones[517]
    ia, ib = 3, 517
    src = rng.integers(-1, z, 4096).astype(np.int32)
    dst = rng.integers(-1, z, 4096).astype(np.int32)
    src[:64:2], dst[:64:2] = ia, ib
    src[1:64:2], dst[1:64:2] = ib, ia
    before = tsw.link_keep_mask_cuda(src, dst, topo.up_matrix())
    keep = before.copy()
    require(before.flags.writeable and before.all(),
            "link_keep_mask_cuda on a healed topology dropped a frame")
    topo.partition_link(a, b)
    after = tsw.link_keep_mask_cuda(src, dst, topo.up_matrix())
    cut = ((src == ia) & (dst == ib)) | ((src == ib) & (dst == ia))
    require(np.array_equal(after, ~cut),
            "a partition between two calls did not change exactly the cut "
            "link's frames")
    require(np.array_equal(before, keep),
            "the next call overwrote an earlier result")
    after &= False  # the transport ANDs its partition mask in place
    again = tsw.link_keep_mask_cuda(src, dst, topo.up_matrix())
    require(np.array_equal(again, ~cut),
            "an in-place edit of a result reached the next call")
    torch.cuda.synchronize(dev)
    return worst


def phase_geo(dev) -> tuple[dict, dict, dict]:
    """The geo path: the geo_lt twin, then the storm twin, on one count;
    their gates raise inside ``run``. K5, K6 and K18 must have launched,
    and K7 never."""
    reset_launches()
    try:
        geo = geo_lt.run(dev)
        storm = sim_core_ab.run(dev)
    except (geo_lt.GateFailure, sim_core_ab.GateFailure) as exc:
        raise SmokeFailure(f"geo: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    require(all(launches[name] > 0 for name in GEO_PATH),
            f"a kernel of the geo path never launched: {launches}")
    require(launches["reshape_columns"] == 0,
            f"K7 ran on the geo path, whose grid universe is fixed: "
            f"{launches}")
    return geo, storm, launches


def phase_sharded(dev) -> tuple[dict, dict, dict]:
    """The sharded path on four ranks that share the card (and on one
    rank per card where there are two or more cards): the gates raise
    inside ``multichip.check``. Returns the figures, the summed launches
    of the path and each kernel's largest error."""
    del dev
    reset_launches()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    errors = dict.fromkeys(SHARDED_PATH, 0)
    cases = {}

    def record(world, group, slot, spec, telemetry, key):
        try:
            ranks = multichip.check(world, group, slot, spec, telemetry,
                                    window=WINDOW, block=BLOCK,
                                    drains=SHARDED_DRAINS)
        except multichip.WorldFailure as exc:
            raise SmokeFailure(f"sharded: {exc}") from exc
        for r in ranks:
            for name in SHARDED_PATH:
                launches[name] += r["launches"][name]
                errors[name] = max(errors[name], r["errors"][name])
        cases[key] = multichip.check_summary(ranks)

    t0 = time.perf_counter()
    with multichip.RankWorld(4, device_type="cuda") as world:
        backend = world.backend
        spawn_s = time.perf_counter() - t0
        for group, slot, spec in SHARDED_MESHES:
            for telemetry in (False, True):
                record(world, group, slot, spec, telemetry,
                       f"{group}x{slot} {spec} telemetry "
                       f"{'on' if telemetry else 'off'}")
    nccl = "not run: one card (NCCL takes one rank per card)"
    cards = torch.cuda.device_count()
    if cards >= 2:
        k = min(cards, 4)
        with multichip.RankWorld(k, device_type="cuda") as world:
            require(world.backend == "nccl",
                    f"{k} ranks on {cards} cards chose {world.backend}")
            for telemetry in (False, True):
                record(world, 1, k, "majority3", telemetry,
                       f"1x{k} majority3 telemetry "
                       f"{'on' if telemetry else 'off'} over nccl")
        nccl = f"1x{k} over nccl, one rank per card"
    return ({"backend": backend, "ranks": 4, "spawn_s": spawn_s,
             "cases": cases, "nccl": nccl}, launches, errors)


def _shard_kernel_figures(dev, rng) -> dict:
    """K1, K2, K4 and K6 at the shapes one rank's shard of phase 26's
    (1, 4) meshes gives them: wrapper call time (CUDA events), device
    time (profiler), the plain version's time and the bound. K1 on the
    synchronous tracker's 4096-slot drain (whole on every rank); K2 on a
    4096-slot block of the 2^18-column local window; K4 on a 256-lane
    chunk of it; K6 on a 256-lane chunk of the epoch board's 2^12-column
    local window (N = 4, K = 2)."""
    spec = specs()["majority3"]
    n = spec.num_nodes
    pred = predicate(spec, dev)
    g = pred.masks.shape[0]
    w_local, e_local, width, chunk = WINDOW // 4, EPOCH_WINDOW // 4, 4096, 256
    votes = torch.from_numpy(
        (rng.random((n, width)) < 0.6).astype(np.uint8)).to(dev)
    k2_k, k2_p = (tq.make_vote_board(w_local, n, device=dev)
                  for _ in range(2))
    (k4_k, k4_p), k4_lanes, k4_cols = _sparse_case(dev, rng, n, w_local,
                                                  chunk)
    universe = tuple(range(4))
    planes = tq.make_multi_predicate(*pad_specs(
        [SimpleMajority(m).write_spec().reindexed(universe)
         for m in ((0, 1, 2), (0, 1, 3))]), device=dev)
    kk, kg, kn = planes.masks.shape
    plane_bytes = 4 * kk * kg * kn + 4 * kk * kg + kk + 4 * (kk - 1)
    bounds = torch.tensor([EPOCH_WINDOW // 2], dtype=torch.int32,
                          device=dev)
    (k6_k, k6_p), k6_lanes, k6_cols = _sparse_case(dev, rng, kn, e_local,
                                                  chunk)
    cases = (
        ("quorum_hit", lambda: tq.quorum_hit(votes, pred),
         lambda: tq.quorum_hit_plain(votes, pred), "quorum_hit_kernel",
         (n + 1) * width, (2 * g * n + 2 * g) * width,
         f"N={n} B={width}"),
        ("record_block",
         lambda: tq.record_block(k2_k, 0, 0, votes, 0, pred),
         lambda: tq.record_block_plain(k2_p, 0, 0, votes, 0, pred),
         "record_block_kernel", (3 * n + 19) * width,
         (6 * n + 2 * g * n + 30) * width,
         f"N={n} B={width} w_local={w_local}"),
        ("record_and_check",
         lambda: tq.record_and_check(k4_k, k4_lanes, pred),
         lambda: tq.record_and_check_plain(k4_p, k4_lanes, pred),
         "record_and_check_kernel", 21 * chunk + 2 * (9 + n) * k4_cols,
         (40 + 2 * g * n) * chunk, f"N={n} B={chunk} w_local={w_local}"),
        ("record_and_check_epochs",
         lambda: tq.record_and_check_epochs(k6_k, k6_lanes, bounds, planes),
         lambda: tq.record_and_check_epochs_plain(k6_p, k6_lanes, bounds,
                                                  planes),
         "record_and_check_epochs_kernel",
         21 * chunk + 2 * (9 + kn) * k6_cols + plane_bytes,
         (42 + 2 * kg * kn) * chunk,
         f"N={kn} K={kk} B={chunk} w_local={e_local}"),
    )
    out = {}
    for name, fn, plain, kname, nbytes, ops, shape in cases:
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT_OPS_PER_S * 1e3
        out[name] = {"ms": time_ms(fn, 2000), "plain_ms": time_ms(plain, 100),
                     "device_ms": device_ms(fn, kname),
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "library_ms": None, "shape": shape}
    return out


def _board_summary(result: dict, figures: dict) -> dict:
    """Phase 26's figures: per tracker arm (rank 0) the drains, host ms
    per drain, all-reduces per drain and their share of the drain (each
    all-reduce's synchronised host ms times the count), and the kernels'
    device ms per drain (rank 0's launches per drain times each kernel's
    device time at the shard's shape); the slowest rank's ms per drain;
    the all-reduce's ms alone."""
    ranks = result["ranks"]
    lead = next(r for r in ranks if r["rank"] == 0)
    reduce_ms = lead["allreduce_ms"]
    arms = {}
    for name, arm in lead["arms"].items():
        drains = arm["drains"]
        per_drain = arm["allreduces"] / drains
        # A dense part's all-reduce carries up to 4096 bytes, a sparse
        # part's 256: bound the share by the wider one.
        kernels = sum(arm["launches"][k] / drains
                      * (figures[k]["device_ms"] or figures[k]["ms"])
                      for k in figures if arm["launches"].get(k))
        arms[name] = {
            "drains": drains, "chosen": arm["chosen"],
            "run_s": arm["run_s"], "drain_ms_median": arm["drain_ms_median"],
            "drain_ms_mean": arm["drain_ms_mean"],
            "drain_ms_mean_slowest_rank": max(
                r["arms"][name]["drain_ms_mean"] for r in ranks
                if name in r["arms"]),
            "allreduces_per_drain": per_drain,
            "allreduce_ms_per_drain_at_most": per_drain * reduce_ms[4096],
            "kernels_device_ms_per_drain": kernels,
            "launches_rank0": arm["launches"]}
    return {"backend": lead["backend"], "ranks": len(ranks),
            "allreduce_ms_rank0": reduce_ms, "arms": arms,
            "expectations_s": result["expect_s"],
            "shard_kernels": figures}


def phase_sharded_board(dev, rng) -> tuple[dict, dict, dict]:
    """The sharded vote board's path on four ranks that share the card
    (and on one rank per card where there are two or more cards); the
    gates raise inside ``multichip_board.check_board``. Returns the
    figures, the summed launches of the path and each kernel's largest
    error against its plain version."""
    reset_launches()
    errors: dict = {}
    t0 = time.perf_counter()

    def run(world, **kw):
        try:
            result = multichip_board.check_board(world, device=dev, **kw)
        except multichip.WorldFailure as exc:
            raise SmokeFailure(f"sharded board: {exc}") from exc
        for r in result["ranks"]:
            for name, err in (r["errors"] or {}).items():
                errors[name] = max(errors.get(name, 0), err)
        return result

    with multichip.RankWorld(4, device_type="cuda") as world:
        spawn_s = time.perf_counter() - t0
        result = run(world)
    launches = {name: result["launches"].get(name, 0) for name in WRAPPERS}
    summary = _board_summary(result, _shard_kernel_figures(dev, rng))
    summary["spawn_s"] = spawn_s
    summary["nccl"] = "not run: one card (NCCL takes one rank per card)"
    cards = torch.cuda.device_count()
    if cards >= 2:
        k = min(cards, 4)
        with multichip.RankWorld(k, device_type="cuda") as world:
            require(world.backend == "nccl",
                    f"{k} ranks on {cards} cards chose {world.backend}")
            arms = {f"{name} 1x{k}": ((1, k), *arm[1:]) for name, arm in
                    multichip_board.BOARD_ARMS.items()}
            nccl = run(world, arms=arms, side=(1, k))
        summary["nccl"] = {
            "ranks": k, "backend": "nccl",
            "allreduce_ms_rank0": next(r for r in nccl["ranks"]
                                       if r["rank"] == 0)["allreduce_ms"],
            "drain_ms_median": {name: arm["drain_ms_median"] for name, arm in
                                next(r for r in nccl["ranks"] if r["rank"]
                                     == 0)["arms"].items()}}
    return summary, launches, errors


def time_ms(fn, iters: int, warm: int = 20) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: The in-turn order of phase 28's kernel-against-library timing (K18
#: also with the main path's reused out= buffer), repeated
#: ``TURN_ROUNDS`` times: each of the three gets six blocks.
TURN_ORDER = ("kernel", "library", "out", "out", "library", "kernel")
TURN_ROUNDS = 3
TURN_CALLS = 400


def in_turns(fns: dict) -> dict:
    """CUDA-event ms per call of each of ``fns`` (keyed as in
    ``TURN_ORDER``), timed in blocks of ``TURN_CALLS`` calls in turns;
    ``{key: (median of its blocks, [blocks])}``."""
    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    blocks = {key: [] for key in fns}
    for _ in range(TURN_ROUNDS):
        for key in TURN_ORDER:
            if key not in fns:
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TURN_CALLS):
                fns[key]()
            end.record()
            end.synchronize()
            blocks[key].append(start.elapsed_time(end) / TURN_CALLS)
    return {key: (statistics.median(b), b) for key, b in blocks.items()}


def device_ms(fn, kernel: str, iters: int = 200):
    """Mean device time of ``kernel`` from the profiler's CUDA trace, or
    None when the trace shows no device time for it."""
    from torch.profiler import profile, ProfilerActivity

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel in evt.key and evt.count:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = getattr(evt, "cuda_time_total", 0)
            if total:
                return total / evt.count / 1e3
    return None


#: Drains per run where the drain kernels are timed alone (phase 28's
#: rows): the telemetry twin's chunk, one launch a run.
FIGURE_DRAINS = 1024
#: Launches timed one by one for a drain row's device time.
FIGURE_LAUNCHES = 21


def launch_ms(fn, launches: int = FIGURE_LAUNCHES) -> float:
    """Device ms of one call of ``fn`` that is ONE long launch: CUDA
    events recorded on the stream right before and after each of
    ``launches`` calls (after one warm call), the median. A millisecond
    of sleep is queued ahead of each start event, so the launch is
    enqueued before the start event runs and the events bracket the
    kernel alone, not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_block_sweep(dev) -> dict:
    """The block-size frontier (``bench/block_sweep.py``) at cut
    repeats: every block size of the reference at window 2^20, one timed
    run each after a warm run, a short latency distribution."""
    return block_sweep.run(dev, repeats=1, latency_budget_s=2.0,
                           target_samples=64)


def _sparse_case(dev, rng, n: int, window: int, b: int):
    """Two fresh boards and one chunk of ``b`` straggler lanes (distinct
    slots behind a frontier, valid, round 0), as the tracker sends K4
    and K6; also the count of distinct columns the chunk touches."""
    true = rng.choice(window, size=b, replace=False).astype(np.int64)
    lanes = torch.from_numpy(tq.pack_lanes(
        true % window, true, rng.integers(0, n, size=b),
        np.zeros(b, np.int32), np.ones(b, bool))).to(dev)
    boards = [tq.make_vote_board(window, n, device=dev) for _ in range(2)]
    return boards, lanes, len(np.unique(true % window))


def phase_figures(dev, rng, paths: dict, errors: dict) -> list:
    """Per kernel at the main paths' shapes: wrapper call time (CUDA
    events), device time (profiler), the plain version's time, and the
    bound from the bytes and integer operations the call needs.
    ``paths`` maps each path's name to its launch counts."""
    spec = specs()["majority3"]
    n = spec.num_nodes
    pred = predicate(spec, dev)
    g = pred.masks.shape[0]
    votes = torch.from_numpy(
        (rng.random((n, BLOCK)) < 0.6).astype(np.uint8)).to(dev)
    board_k = tq.make_vote_board(WINDOW, n, device=dev)
    board_p = tq.make_vote_board(WINDOW, n, device=dev)
    # K3, K14 and the pinned copy: one call is a run of FIGURE_DRAINS
    # drains (one launch); the plain versions run them drain by drain.
    forms = drain_forms(dev)
    drain_arrays = headline.spec_arrays(spec)
    drain_at = {}

    def drain_run(key, state, run):
        drain_at[key] = 0

        def call():
            run(state, drain_at[key], FIGURE_DRAINS, BLOCK, *drain_arrays)
            drain_at[key] = tp._wrap32(drain_at[key] + FIGURE_DRAINS)
        return call

    def drain_plain(key, state, step):
        drain_at[key] = 0

        def call():
            for k in range(FIGURE_DRAINS):
                step(state, tp._wrap32(drain_at[key] + k), BLOCK, pred)
            drain_at[key] = tp._wrap32(drain_at[key] + FIGURE_DRAINS)
        return call

    k3 = drain_run("k3", tp.make_state(WINDOW, n, device=dev),
                   tp.run_steps_from)
    k3_plain = drain_plain("k3p", tp.make_state(WINDOW, n, device=dev),
                           tp.steady_state_step_plain)

    # K4: one scatter chunk of the pipelined tracker (max_chunk lanes).
    chunk = 256
    (k4_k, k4_p), k4_lanes, k4_cols = _sparse_case(dev, rng, n, WINDOW,
                                                  chunk)
    # K5: the pipelined prewarm's release of max_dense columns.
    rel = 4096
    k5_k, k5_p = (tq.make_vote_board(WINDOW, n, device=dev)
                  for _ in range(2))
    k5_slots = torch.arange(rel, dtype=torch.int32, device=dev)
    k5_valid = torch.ones(rel, dtype=torch.bool, device=dev)
    # K6: the epoch tracker after the handover: N = 4, K = 2, window 2^14.
    universe = tuple(range(4))
    planes = tq.make_multi_predicate(*pad_specs(
        [SimpleMajority(m).write_spec().reindexed(universe)
         for m in ((0, 1, 2), (0, 1, 3))]), device=dev)
    kk, kg, kn = planes.masks.shape
    plane_bytes = 4 * kk * kg * kn + 4 * kk * kg + kk + 4 * (kk - 1)
    bounds = torch.tensor([EPOCH_WINDOW // 2], dtype=torch.int32,
                          device=dev)
    (k6_k, k6_p), k6_lanes, k6_cols = _sparse_case(dev, rng, kn,
                                                  EPOCH_WINDOW, chunk)
    present = torch.from_numpy(
        (rng.random((chunk, kn)) < 0.6).astype(np.int32)).to(dev)
    cfg = torch.from_numpy(rng.integers(0, kk, size=chunk).astype(
        np.int32)).to(dev)
    # K7: the epoch board's reshape at the handover, [3, W] -> [4, W].
    k7_block = torch.from_numpy((rng.random((3, EPOCH_WINDOW)) < 0.5)
                                .astype(np.uint8)).to(dev)
    k7_cmap = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=dev)

    # K8: the recovery window of the cluster's failover, [2^16, 3].
    k8_rounds, k8_ids = _k8_inputs(rng, n, dev)

    # K9/K10: depset_lt's drain batch, [4096, 3, 32]; K10 in seq mode:
    # the cluster's slow-path quorum, [4, 5, 8]; K11: the fast path's
    # three identical replies, [3, 5, 8] (every byte compared).
    lt_batch = _depset_batch(rng, (4096, 3, 32), 1000, "bits", dev)
    slow = _depset_batch(rng, (4, 5, 8), 1000, "bits", dev)
    slow_seqs = torch.zeros(4, dtype=torch.int32, device=dev)
    one = _depset_batch(rng, (1, 5, 8), 1000, "bits", dev)
    fast = td.DepSetBatch(one.watermarks.repeat(3, 1),
                          one.tails.repeat(3, 1, 1), one.tail_base)
    depset_cu = "frankenpaxos_tpu_torch/ops/csrc/depset.cu"
    depset_ref = "frankenpaxos_tpu/ops/depset.py"

    # K12: a GC role's fold, the f + 1 = 2 quorum watermark of the
    # [replicas, leaders] = [3, 2] frontier matrix, read by columns.
    frontiers = torch.from_numpy(rng.integers(
        0, 1 << 14, size=(3, 2)).astype(np.int32)).to(dev)
    k12_rows, k12_q = frontiers.t(), 2
    k12_b, k12_n = k12_rows.shape
    require(torch.equal(torch.kthvalue(k12_rows, k12_n - k12_q + 1,
                                       dim=-1).values,
                        tw.quorum_watermark(k12_rows, k12_q)),
            "torch.kthvalue does not compute K12's function")
    # K13: libbench's [4096] present vector, one False in the middle;
    # the prefix (2048 + the zero) is read, one int32 written.
    k13 = torch.ones(4096, dtype=torch.bool, device=dev)
    k13[2048] = False
    watermark_cu = "frankenpaxos_tpu_torch/ops/csrc/watermark.cu"
    watermark_ref = "frankenpaxos_tpu/ops/watermark.py"
    library = {"quorum_watermark": lambda: torch.kthvalue(
        k12_rows, k12_n - k12_q + 1, dim=-1)}

    # K14 and the pinned K3 copy: the headline's drain, telemetry on, and
    # the overhead bench's baseline arm; the counters are n + 22 words.
    k14 = drain_run("k14", tp.make_state(WINDOW, n, telemetry=True,
                                         device=dev), tp.run_steps_from)
    k14_plain = drain_plain("k14p", tp.make_state(WINDOW, n, telemetry=True,
                                                  device=dev),
                            tp.steady_state_step_plain)
    pinned = drain_run("pin", tpin.make_state(WINDOW, n, device=dev),
                       tpin.run_steps_from)
    pinned_plain = drain_plain("pinp", tpin.make_state(WINDOW, n,
                                                       device=dev),
                               tpin.steady_state_step_plain)
    tel_words = 4 * tp.make_telemetry(n, device=dev).buffer.numel()
    # The drain state's bytes: votes and chosen (N + 1 a slot), commands
    # and results (8 a slot), three int32 scalars.
    state_bytes = (n + 9) * WINDOW + 12
    k3_ops = (2 * (10 * n + 2 * g * n + 8) + 30) * BLOCK
    # K15 at S = 2^16, N = 5: ids from a few values, 70% valid.
    k15_s, k15_n = 1 << 16, 5
    k15_ids = torch.from_numpy(rng.integers(
        0, 4, size=(k15_s, k15_n)).astype(np.int32)).to(dev)
    k15_valid = torch.from_numpy(rng.random((k15_s, k15_n)) < 0.7).to(dev)
    # K16 / K17: libbench's [4096, 3, 64] batch at tail base 2^16 (K16's
    # union is libbench's call); executed per column, [L]; a leader and
    # a vid per row.
    lib_a = _depset_batch(rng, (4096, 3, 64), 1 << 16, "bits", dev)
    lib_b = _depset_batch(rng, (4096, 3, 64), 1 << 16, "bits", dev)
    lib_rows = lib_a.watermarks.shape[0]
    lib_exec = torch.from_numpy(rng.integers(
        (1 << 16) - 8, (1 << 16) + 72, size=3).astype(np.int32)).to(dev)
    lib_leader = torch.from_numpy(rng.integers(
        0, 3, size=lib_rows).astype(np.int32)).to(dev)
    lib_vid = torch.from_numpy(rng.integers(
        (1 << 16) - 64, (1 << 16) + 128, size=lib_rows).astype(
        np.int32)).to(dev)
    lib_cells = lib_a.tails.numel() + lib_a.watermarks.numel()

    # K18: the FIFO arm's wave, 32768 frames over the storm's [1001, 1001]
    # up-matrix; the library call takes in-range ids as int64. Bytes:
    # the ids and the mask (9 per frame) and each distinct matrix entry
    # the wave gathers (JAX's index rule applied), read once.
    k18_n = sim_core_ab.FIFO_DEPTH
    k18_up_np = _k18_up(rng, K18_ZONES)
    k18_up = torch.from_numpy(k18_up_np).to(dev)
    k18_src_np, k18_dst_np = (rng.integers(0, K18_ZONES + 1, k18_n)
                              .astype(np.int32) for _ in range(2))
    k18_src, k18_dst = (torch.from_numpy(a).to(dev)
                        for a in (k18_src_np, k18_dst_np))
    k18_src_l, k18_dst_l = k18_src.long(), k18_dst.long()
    require(torch.equal(k18_up[k18_src_l, k18_dst_l],
                        tsw.link_keep_mask_tensor(k18_src, k18_dst, k18_up)),
            "up[src, dst] does not compute K18's function")
    k18_pairs = len(np.unique(k18_src_np.astype(np.int64)
                              * (K18_ZONES + 1) + k18_dst_np))
    library["link_keep_mask"] = lambda: k18_up[k18_src_l, k18_dst_l]
    k18_out = torch.empty(k18_n, dtype=torch.bool, device=dev)
    with_out = {"link_keep_mask": lambda: tsw.link_keep_mask_tensor(
        k18_src, k18_dst, k18_up, out=k18_out)}

    # K19-K21: rank 0's shard of phase 25's (1, 4) majority-3 mesh
    # (b_local 8192 of a 2^18-slot local window), telemetry off. A phase
    # alone needs no collective, so a mesh without process groups serves.
    sh_mesh = Mesh(1, 4, 0, dev)
    sh_b, sh_s = tp.local_block(BLOCK, 4)[0], 4
    sh_states = {key: tp.make_sharded_state(sh_mesh, WINDOW, BLOCK, n)[0]
                 for key in ("k19", "p19", "k20", "p20", "k21", "p21")}
    sh_plans = {key: tp.make_shard_plan(sh_mesh, BLOCK, pred)
                for key in sh_states}
    sh_at = dict.fromkeys(sh_states, 0)

    def shard_call(key, fn):
        def run():
            fn(sh_states[key], sh_at[key], sh_plans[key])
            sh_at[key] += 1
        return run

    sh_rows = sh_plans["k19"].parts.shape[1]
    # The pinned copies on the same shard.
    pin_states = {key: tpin.make_sharded_state(sh_mesh, WINDOW, BLOCK, n)[0]
                  for key in ("k19", "p19", "k20", "p20", "k21", "p21")}
    pin_plans = {key: tpin.make_shard_plan(sh_mesh, BLOCK, pred)
                 for key in pin_states}
    pin_at = dict.fromkeys(pin_states, 0)

    def pinned_call(key, fn):
        def run():
            fn(pin_states[key], pin_at[key], pin_plans[key])
            pin_at[key] += 1
        return run

    pinned_cu = "frankenpaxos_tpu_torch/ops/csrc/pipeline_sharded_baseline.cu"
    pinned_ref = "frankenpaxos_tpu/bench/pipeline_baseline.py"
    sharded_cu = "frankenpaxos_tpu_torch/ops/csrc/pipeline_sharded.cu"
    sharded_ref = "frankenpaxos_tpu/bench/pipeline.py"
    sh_shape = f"N={n} b_local={sh_b} w_local={WINDOW // sh_s}, mesh (1, 4)"

    quorum, sparse, epoch = (f"frankenpaxos_tpu_torch/ops/csrc/{f}.cu"
                             for f in ("quorum", "sparse", "epoch"))
    ref = "frankenpaxos_tpu/ops/quorum.py"
    cases = [
        # name, kernel fn, plain fn, device kernel name, bytes, int ops,
        # source, replaces, shape
        ("quorum_hit", lambda: tq.quorum_hit(votes, pred),
         lambda: tq.quorum_hit_plain(votes, pred), "quorum_hit_kernel",
         (n + 1) * BLOCK, (2 * g * n + 2 * g) * BLOCK, quorum, f"{ref}:77",
         f"N={n} B={BLOCK}"),
        ("record_block",
         lambda: tq.record_block(board_k, 0, 0, votes, 0, pred),
         lambda: tq.record_block_plain(board_p, 0, 0, votes, 0, pred),
         "record_block_kernel", (3 * n + 19) * BLOCK,
         (6 * n + 2 * g * n + 30) * BLOCK, quorum, f"{ref}:267",
         f"N={n} B={BLOCK} W={WINDOW}"),
        # K3 (and K14, the pinned copy) per run of FIGURE_DRAINS drains:
        # the state read once and written once, and each drain's integer
        # operations (the reference's (5N+17)·B bytes a drain go beside
        # the row as reference_bytes).
        ("steady_state_step", k3, k3_plain, "run_steps_kernel",
         2 * state_bytes, k3_ops * FIGURE_DRAINS,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline.cu",
         "frankenpaxos_tpu/bench/pipeline.py:145 (run_steps L341, "
         "run_steps_from L358)",
         f"N={n} B={BLOCK} W={WINDOW}, {FIGURE_DRAINS} drains a run"),
        # Lanes (20 B each) and newly (1 B) plus, per distinct column,
        # owner, round, chosen and N vote bytes read and written.
        ("record_and_check",
         lambda: tq.record_and_check(k4_k, k4_lanes, pred),
         lambda: tq.record_and_check_plain(k4_p, k4_lanes, pred),
         "record_and_check_kernel", 21 * chunk + 2 * (9 + n) * k4_cols,
         (40 + 2 * g * n) * chunk, sparse, f"{ref}:214",
         f"N={n} B={chunk} W={WINDOW}"),
        ("release", lambda: tq.release(k5_k, k5_slots, k5_valid),
         lambda: tq.release_plain(k5_p, k5_slots, k5_valid),
         "release_kernel", 5 * rel + (9 + n) * rel, (8 + n) * rel, sparse,
         f"{ref}:327", f"N={n} B={rel} W={WINDOW}"),
        ("record_and_check_epochs",
         lambda: tq.record_and_check_epochs(k6_k, k6_lanes, bounds, planes),
         lambda: tq.record_and_check_epochs_plain(k6_p, k6_lanes, bounds,
                                                  planes),
         "record_and_check_epochs_kernel",
         21 * chunk + 2 * (9 + kn) * k6_cols + plane_bytes,
         (42 + 2 * kg * kn) * chunk, epoch, f"{ref}:237",
         f"N={kn} K={kk} B={chunk} W={EPOCH_WINDOW}"),
        ("check_batch_multi",
         lambda: tq.check_batch_multi(present, cfg, planes),
         lambda: tq.check_batch_multi_plain(present, cfg, planes),
         "check_batch_multi_kernel", (4 * kn + 5) * chunk + plane_bytes,
         (2 * kg * kn + kg) * chunk, epoch, f"{ref}:359",
         f"N={kn} K={kk} B={chunk}"),
        ("reshape_columns", lambda: tq.reshape_columns(k7_block, k7_cmap),
         lambda: tq.reshape_columns_plain(k7_block, k7_cmap),
         "reshape_columns_kernel", (3 + 4) * EPOCH_WINDOW + 16,
         4 * EPOCH_WINDOW, epoch, f"{ref}:441",
         f"[3, {EPOCH_WINDOW}] -> [4, {EPOCH_WINDOW}]"),
        # Both matrices read once, a bool and an int32 written per row;
        # N - 1 compares and a select per row.
        ("safe_values", lambda: tv.safe_values(k8_rounds, k8_ids),
         lambda: tv.safe_values_plain(k8_rounds, k8_ids),
         "safe_values_kernel", (8 * n + 5) * RECOVERY_ROWS,
         2 * n * RECOVERY_ROWS, "frankenpaxos_tpu_torch/ops/csrc/value.cu",
         "frankenpaxos_tpu/ops/value.py:19", f"S={RECOVERY_ROWS} N={n}"),
        # K9-K11: the batch read once (B*L*(4+W) bytes), the output
        # written once; a few integer operations per tail byte.
        ("normalized", lambda: td.normalized(lt_batch),
         lambda: td.normalized_plain(lt_batch), "depset_normalized_kernel",
         2 * _rows(lt_batch) + 4, 4 * lt_batch.tails.numel(), depset_cu,
         f"{depset_ref}:74", _shape(lt_batch)),
        ("union_reduce", lambda: td.union_reduce(lt_batch),
         lambda: td.union_reduce_plain(lt_batch),
         "depset_union_reduce_kernel",
         _rows(lt_batch) + 4 + _rows(lt_batch) // lt_batch.tails.shape[0],
         2 * lt_batch.tails.numel(), depset_cu, f"{depset_ref}:97",
         _shape(lt_batch)),
        ("conflict_max", lambda: td.conflict_max(slow_seqs, slow),
         lambda: td.conflict_max_plain(slow_seqs, slow),
         "depset_union_reduce_kernel",
         _rows(slow) + 8 + 4 * slow.tails.shape[0]
         + _rows(slow) // slow.tails.shape[0],
         2 * slow.tails.numel() + slow.tails.shape[0], depset_cu,
         f"{depset_ref}:168", _shape(slow)),
        ("all_equal", lambda: td.all_equal(fast),
         lambda: td.all_equal_plain(fast), "depset_all_equal_kernel",
         _rows(fast) + 5, 8 * fast.tails.numel(), depset_cu,
         f"{depset_ref}:114", _shape(fast)),
        # K12: every watermark read once, one int32 written per row; two
        # compares and two adds per pair of a row's elements.
        ("quorum_watermark", lambda: tw.quorum_watermark(k12_rows, k12_q),
         lambda: tw.quorum_watermark_plain(k12_rows, k12_q),
         "quorum_watermark_kernel", 4 * k12_b * k12_n + 4 * k12_b,
         4 * k12_b * k12_n * k12_n, watermark_cu, f"{watermark_ref}:17",
         f"[B, n] = [{k12_b}, {k12_n}] (strided), q = {k12_q}"),
        # K13: the prefix up to its first zero read, an int32 written; a
        # multiply and an add per element read.
        ("contiguous_prefix_length",
         lambda: tw.contiguous_prefix_length(k13),
         lambda: tw.contiguous_prefix_length_plain(k13),
         "contiguous_prefix_kernel", 2049 + 4, 2 * 2049, watermark_cu,
         f"{watermark_ref}:38", "[4096] bool, first False at 2048"),
        # K14: K3's bytes and operations, the counters read and written
        # once, a vote sum and a bin add per newly-chosen lane.
        ("steady_state_step_telemetry", k14, k14_plain,
         "run_steps_kernel", 2 * (state_bytes + tel_words),
         (k3_ops + 2 * (n + 2) * BLOCK) * FIGURE_DRAINS,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline.cu",
         "frankenpaxos_tpu/bench/pipeline.py:145 (ops/telemetry.py:99, "
         ":108, :136)",
         f"N={n} B={BLOCK} W={WINDOW}, telemetry on, {FIGURE_DRAINS} "
         f"drains a run"),
        ("steady_state_step_baseline", pinned, pinned_plain,
         "run_steps_kernel", 2 * state_bytes, k3_ops * FIGURE_DRAINS,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline_baseline.cu",
         "frankenpaxos_tpu/bench/pipeline_baseline.py:76 (run_steps_from "
         "L201)", f"N={n} B={BLOCK} W={WINDOW}, {FIGURE_DRAINS} drains a "
         f"run"),
        # K15: ids (4 B) and valid (1 B) read, two int32 written per row;
        # N^2 compares, ANDs and adds per row.
        ("count_matching_replies",
         lambda: tv.count_matching_replies(k15_ids, k15_valid),
         lambda: tv.count_matching_replies_plain(k15_ids, k15_valid),
         "count_matching_replies_kernel", (5 * k15_n + 8) * k15_s,
         3 * k15_n * k15_n * k15_s,
         "frankenpaxos_tpu_torch/ops/csrc/value.cu",
         "frankenpaxos_tpu/ops/value.py:40", f"S={k15_s} N={k15_n}"),
        # K16: two batches read, one written (compact: one batch and
        # `executed`; union, timed on libbench's aliased call, one batch
        # read); K17: one batch read (two for equal), 1 or 4 bytes
        # written per row; contains reads a watermark, a byte, a leader
        # and a vid per row.
        ("union", lambda: td.union(lib_a, lib_a),
         lambda: td.union_plain(lib_a, lib_a), "depset_pair_kernel",
         2 * _rows(lib_a) + 4, 2 * lib_cells, depset_cu,
         f"{depset_ref}:49", _shape(lib_a) + " (libbench's, aliased)"),
        ("intersect", lambda: td.intersect(lib_a, lib_b),
         lambda: td.intersect_plain(lib_a, lib_b), "depset_pair_kernel",
         3 * _rows(lib_a) + 4, 12 * lib_cells, depset_cu,
         f"{depset_ref}:181", _shape(lib_a)),
        ("compact", lambda: td.compact(lib_a, lib_exec),
         lambda: td.compact_plain(lib_a, lib_exec), "depset_pair_kernel",
         2 * _rows(lib_a) + 4 * 3 + 4, 6 * lib_cells, depset_cu,
         f"{depset_ref}:213", _shape(lib_a) + ", executed [L]"),
        ("equal", lambda: td.equal(lib_a, lib_b),
         lambda: td.equal_plain(lib_a, lib_b), "depset_query_kernel",
         2 * _rows(lib_a) + lib_rows, 2 * lib_cells, depset_cu,
         f"{depset_ref}:129", _shape(lib_a)),
        ("size", lambda: td.size(lib_a), lambda: td.size_plain(lib_a),
         "depset_query_kernel", _rows(lib_a) + 4 * lib_rows, lib_cells,
         depset_cu, f"{depset_ref}:161", _shape(lib_a)),
        ("contains", lambda: td.contains(lib_a, lib_leader, lib_vid),
         lambda: td.contains_plain(lib_a, lib_leader, lib_vid),
         "depset_query_kernel", (4 + 1 + 8 + 1) * lib_rows + 4,
         12 * lib_rows, depset_cu, f"{depset_ref}:137 (contains L148)",
         _shape(lib_a) + ", a leader and a vid per row"),
        # K18: two id loads, a wrap, two clamps, a multiply-add and a
        # compare per frame.
        ("link_keep_mask",
         lambda: tsw.link_keep_mask_tensor(k18_src, k18_dst, k18_up),
         lambda: tsw.link_keep_mask_plain(k18_src, k18_dst, k18_up),
         "link_keep_mask_kernel", 9 * k18_n + k18_pairs, 8 * k18_n,
         "frankenpaxos_tpu_torch/ops/csrc/simwave.cu",
         "frankenpaxos_tpu/ops/simwave.py:79 (_link_keep_jax L107)",
         f"n={k18_n} over [{K18_ZONES + 1}, {K18_ZONES + 1}] bool"),
        # K19: per lane, both passes' N vote bytes read and written, a
        # command and the R partial rows of both passes written; an
        # arrival hash per vote and G * N multiply-adds per pass. K20:
        # per lane both passes' partials and chosen bytes, the old
        # command read, a result and the GC column (N + 1) written. K21:
        # the slot words and three scalars read and written.
        ("shard_vote_count", shard_call("k19", tp.shard_vote_count),
         shard_call("p19", tp.shard_vote_count_plain),
         "shard_vote_count_kernel", (4 * n + 4 + 8 * sh_rows) * sh_b,
         (2 * (10 * n + 2 * g * n) + 10) * sh_b, sharded_cu,
         f"{sharded_ref}:145 (make_sharded_step L494, psums L271-275)",
         sh_shape),
        ("shard_commit", shard_call("k20", tp.shard_commit),
         shard_call("p20", tp.shard_commit_plain), "shard_commit_kernel",
         (8 * sh_rows + 4 + 8 + n + 1) * sh_b + 8 * (sh_s + 1),
         (2 * (2 * g + 6) + n + 10) * sh_b, sharded_cu,
         f"{sharded_ref}:145 (L276-322 after the group psum)", sh_shape),
        ("shard_fold", shard_call("k21", tp.shard_fold),
         shard_call("p21", tp.shard_fold_plain), "shard_fold_kernel",
         8 * (sh_s + 1) + 24, 4 * (sh_s + 1) + 20, sharded_cu,
         f"{sharded_ref}:145 (L282-313 after the slot psum)",
         f"S={sh_s}, telemetry off"),
        # The pinned copies of K19-K21 (the pinned drain's mesh form):
        # K19's and K20's work without the telemetry rows, K21's.
        ("shard_vote_count_baseline",
         pinned_call("k19", tpin.shard_vote_count),
         pinned_call("p19", tpin.shard_vote_count_plain),
         "shard_vote_count_baseline_kernel", (4 * n + 4 + 8 * g) * sh_b,
         (2 * (10 * n + 2 * g * n) + 10) * sh_b, pinned_cu,
         f"{pinned_ref}:76 (L76-80 with axes; psums L154-L185)", sh_shape),
        ("shard_commit_baseline", pinned_call("k20", tpin.shard_commit),
         pinned_call("p20", tpin.shard_commit_plain),
         "shard_commit_baseline_kernel",
         (8 * g + 4 + 8 + n + 1) * sh_b + 8 * (sh_s + 1),
         (2 * (2 * g + 6) + n + 10) * sh_b, pinned_cu,
         f"{pinned_ref}:76 (L160-L185 after the group psum)", sh_shape),
        ("shard_fold_baseline", pinned_call("k21", tpin.shard_fold),
         pinned_call("p21", tpin.shard_fold_plain),
         "shard_fold_baseline_kernel", 8 * (sh_s + 1) + 24,
         4 * (sh_s + 1) + 20, pinned_cu,
         f"{pinned_ref}:76 (L169, L185 after the slot psum)",
         f"S={sh_s}"),
    ]
    out = []
    for (name, fn, plain, kname, nbytes, ops, source, replaces,
         shape) in cases:
        turns = None
        if name in library:
            # In turns with the library call (and the out= form).
            turns = in_turns({"kernel": fn, "library": library[name],
                              **({"out": with_out[name]}
                                 if name in with_out else {})})
            ms, library_ms = turns["kernel"][0], turns["library"][0]
        elif name in DRAIN_KERNELS:
            ms, library_ms = time_ms(fn, 200), None
        else:
            ms, library_ms = time_ms(fn, 2000), None
        if name in DRAIN_KERNELS:
            # A run of FIGURE_DRAINS plain drains takes about a second.
            plain_ms = time_ms(plain, 1, warm=1)
            dev_ms = launch_ms(fn)
        else:
            plain_ms = time_ms(plain, 200)
            dev_ms = device_ms(fn, kname)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT_OPS_PER_S * 1e3
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path[path] for path in MAIN_PATHS),
            "launches_by_path": by_path,
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "device_ms": dev_ms, "bytes": nbytes,
            "shape": shape,
        })
        if name in DRAIN_KERNELS:
            per = FIGURE_DRAINS
            by_drains = {path: counts.get(name, 0)
                         for path, counts in DRAINS_BY_PATH.items()}
            ref_bytes = (5 * n + 17) * BLOCK * per
            out[-1].update({
                "device_ms_source": "cuda events around one launch "
                                    f"(median of {FIGURE_LAUNCHES})",
                "reference_bytes": ref_bytes,
                "reference_bound_ms": ref_bytes / HBM_BYTES_PER_S * 1e3,
                "device_us_per_drain_by_form": forms[name],
                "drains_per_call": per,
                "drains": sum(by_drains.values()),
                "drains_by_path": by_drains,
                "ms_per_drain": ms / per,
                "device_us_per_drain": dev_ms * 1e3 / per,
                "bound_us_per_drain": max(bytes_ms, ops_ms) * 1e3 / per,
                "plain_ms_per_drain": plain_ms / per,
            })
        if turns is not None:
            out[-1]["in_turns_ms_blocks"] = {k: b for k, (_, b) in
                                            turns.items()}
            if "out" in turns:
                out[-1]["ms_out"] = turns["out"][0]
    # The transport-facing calls (numpy in, through reused pinned
    # staging, one staged ctypes call, numpy out): host clock per call.
    # K18 at the FIFO wave; K12's vector form on the GC roles' [3, 2].
    frontiers_np = frontiers.cpu().numpy().astype(np.int64)
    for name, call in (
            ("link_keep_mask",
             lambda: tsw.link_keep_mask_cuda(k18_src_np, k18_dst_np,
                                             k18_up_np)),
            ("quorum_watermark",
             lambda: tw.quorum_watermark_vector(frontiers_np, k12_q))):
        call()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        row = next(r for r in out if r["name"] == name)
        row["entry_ms"] = (time.perf_counter() - t0) / 2000 * 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.abspath(frankenpaxos_tpu_torch.__file__).startswith(
            os.path.join(here, "")):
        print("chip_smoke: frankenpaxos_tpu_torch is not the checkout's "
              "own package", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    try:
        name = torch.cuda.get_device_name(dev)
        smi = nvidia_smi_line()
        phase(1, f"device: {name} ({torch.cuda.device_count()} "
            f"visible), torch {torch.__version__}, cuda {torch.version.cuda}")
        require(smi is not None, "nvidia-smi gave no name and power limit")
        log(smi)

        seconds = _build.build()
        phase(2, f"build: {seconds:.1f} s")
        for lib in _build.SIGNATURES:
            for line in _build.build_log(lib).splitlines():
                if re.search(r"registers|spill", line):
                    log(f"      {lib}: {line.strip()}")

        errors = {"quorum_hit": phase_k1(dev, rng)}
        phase(3, f"K1 quorum_hit == plain (5 specs, B={BLOCK})")
        errors["record_block"] = phase_k2(dev, rng)
        phase(4, f"K2 record_block == plain (64 calls, W={WINDOW})")
        errors.update(phase_k3(dev))
        phase(5, f"K3 and K14 (one launch a run) == the plain drains, K3 "
            f"== the pinned copy, at W={WINDOW}: runs of "
            + "; ".join(f"{name} {list(c)} from {first}"
                        for name, runs in DRAIN_CHUNKS.items()
                        for first, c in runs.items()))
        errors["record_and_check"] = phase_k4(dev, rng)
        phase(6, f"K4 record_and_check == plain (64 calls of 64-4096 "
            f"lanes x 2 specs, W={WINDOW})")
        errors["release"] = phase_k5(dev, rng)
        phase(7, f"K5 release == plain (16 calls of 4096 lanes, "
            f"W={WINDOW})")
        errors.update(phase_k6(dev, rng))
        phase(8, f"K6 check_batch_multi and record_and_check_epochs == "
            f"plain (3 epochs, 5-node union, W={EPOCH_WINDOW})")
        errors["reshape_columns"] = phase_k7(dev, rng)
        phase(9, f"K7 reshape_columns == plain ([3, {WINDOW}] -> "
            f"[4, {WINDOW}] and [2, {WINDOW}])")
        errors["safe_values"] = phase_k8(dev, rng)
        phase(10, f"K8 safe_values == plain ([{RECOVERY_ROWS}, 3] and "
            f"[{RECOVERY_ROWS}, 6])")

        result, votes, launches = phase_main_path(dev, rng)
        phase(11, f"main path on {name} ({smi}): headline "
            f"{result['value']} cmds/s majority-3, "
            f"{result['grid_cmds_per_sec']} cmds/s grid 2x3; mean drain "
            f"{result['mean_quorum_batch_latency_us']} us; the timed runs' "
            f"host / device us a drain and device idle share: "
            + ", ".join(f"{arm} {fig['host_us_per_drain']} / "
                        f"{fig['device_us_per_drain']}, "
                        f"{fig['device_idle_share']}"
                        for arm, fig in result["timed_run"].items())
            + f"; p50 "
            f"{result['p50_drain_latency_us']} us, p99 "
            f"{result['p99_drain_latency_us']} us; tracker_lt votes/s "
            + ", ".join(f"{arm} {fig['votes_per_sec']:.0f}"
                        for arm, fig in votes["arms"].items())
            + f"; measured min_device_slots "
            f"{votes['measured_min_device_slots']}; launches {launches}")
        log(json.dumps({"headline": result}))
        log(json.dumps({"tracker_lt": votes}))

        cluster, cluster_launches = phase_cluster(dev)
        arms = cluster["arms"]
        phase(12, f"cluster on {name} ({smi}): committed writes/s "
            + ", ".join(f"{arm} {fig['writes_per_sec']:.0f}"
                        for arm, fig in arms.items())
            + f"; K8 recovery {arms['failover']['recovery']['shape']}; "
            f"launches {cluster_launches}, of them by the arms' traffic "
            f"{cluster['launches']}")
        log(json.dumps({"cluster": cluster}))

        errors.update(phase_depset(dev, rng))
        phase(13, f"K9 normalized, K10 union_reduce / conflict_max, K11 "
            f"all_equal == plain at {list(DEPSET_SHAPES)}, bases near "
            f"2^31 - 1 and below 0")

        epaxos, pairs, epaxos_launches = phase_epaxos(dev)
        phase(14, f"EPaxos on {name} ({smi}): committed commands/s "
            + ", ".join(f"{arm} {b} {fig[b]['commands_per_sec']:.0f}"
                        for arm, fig in epaxos["arms"].items()
                        for b in ("host", "cuda"))
            + "; depset_lt coalesced/per_message "
            + ", ".join(f"{w}: {p['throughput_ratio']:.2f}x"
                        for w, p in pairs["pairs"].items())
            + f"; launches {epaxos_launches}, of them by the cluster's "
            f"traffic {epaxos['launches']}")
        log(json.dumps({"epaxos": epaxos}))
        log(json.dumps({"depset_lt": pairs}))

        errors.update(phase_watermark(dev, rng))
        phase(15, f"K12 quorum_watermark == plain at n in "
            f"{list(WATERMARK_WIDTHS)}, B in {list(WATERMARK_ROWS)}, and "
            f"n in {list(WATERMARK_TILED_WIDTHS)}, B in "
            f"{list(WATERMARK_TILED_ROWS)} (tiled), every "
            f"quorum size, per-row and out-of-range sizes, int64 that "
            f"wraps; K13 contiguous_prefix_length == plain on bool, byte "
            f"and signed rows")

        bpaxos, bpaxos_launches = phase_bpaxos(dev)
        phase(16, f"BPaxos on {name} ({smi}): committed commands/s "
            + ", ".join(f"{arm} {b} {fig[b]['commands_per_sec']:.0f}"
                        for arm, fig in bpaxos["arms"].items()
                        for b in ("host", "cuda"))
            + f"; launches {bpaxos_launches}, of them by the cluster's "
            f"traffic {bpaxos['launches']}")
        log(json.dumps({"bpaxos": bpaxos}))

        for kernel, err in phase_telemetry(dev).items():
            errors[kernel] = max(errors[kernel], err)
        phase(17, f"K3, K14 == plain, K3 == the pinned copy in the other "
            f"forms ({list(OTHER_FORMS)}, runs {list(OTHER_CHUNKS)}) and "
            f"at window/block 1-6 ((W, runs) {list(TELEMETRY_RUNS)} x 2 "
            f"specs x "
            f"starts {list(TELEMETRY_STARTS)}); the counters re-add; no "
            f"sync under set_sync_debug_mode('error'); one collect; runs "
            f"inside a side stream's context ordered on it")

        overhead, overhead_launches = phase_overhead(dev)
        phase(18, f"telemetry overhead on {name} ({smi}): "
            + ", ".join(f"{row['window']}/{row['block']}: off/baseline "
                        f"{row['off_over_baseline_ratio']} "
                        f"{row['off_over_baseline_ratio_range']}, on/off "
                        f"{row['on_over_off_ratio']} "
                        f"{row['on_over_off_ratio_range']}"
                        for row in overhead["pairs"].values())
            + f"; gate_passed {overhead['gate_passed']} (measured, not "
            f"enforced); launches {overhead_launches}")
        log(json.dumps({"telemetry_overhead": overhead}))

        errors["count_matching_replies"] = phase_k15(dev, rng)
        phase(19, f"K15 count_matching_replies == plain at S in "
            f"{list(REPLY_ROWS)}, N in {list(REPLY_WIDTHS)}, and S = 0")

        errors.update(phase_depset_rest(dev, rng))
        phase(20, f"K16 union / intersect / compact, K17 equal / size / "
            f"contains == plain at {list(PAIR_SHAPES)}")

        lib, lib_launches = phase_libbench(dev)
        phase(21, f"libbench on {name} ({smi}): launches {lib_launches}")
        log(json.dumps({"libbench": lib}))

        errors["link_keep_mask"] = phase_k18(dev, rng)
        phase(22, f"K18 link_keep_mask == plain at {K18_ZONES} zones, n in "
            f"{list(K18_WAVES)}, every JAX index edge; the numpy entry "
            f"equal, writable and unaliased; a partition between two calls "
            f"flips exactly the cut link")

        geo, storm, geo_launches = phase_geo(dev)
        phase(23, f"WPaxos over geo on {name} ({smi}): "
            + ", ".join(
                f"{b}: home p50/WAN "
                f"{run['home_zone']['home_p50_over_wan_rtt']:.4f}, steal/WAN "
                f"{run['steal']['steal_latency_over_wan_rtt']:.4f}, flat "
                f"geo/multipaxos "
                f"{run['flat']['geo_over_multipaxos_ratio_median']:.3f}, "
                f"geo/plain {run['flat']['geo_over_plain_ratio_median']:.3f}"
                f", {run['seconds']:.1f} s, waves >= 32: "
                f"{run['latency_arms_waves']['waves_at_least_vector_min']}"
                f" + {run['flat']['waves_at_least_vector_min']}, launches "
                f"{run['launches']}"
                for b, run in geo["backends"].items())
            + "; cuda == dict exactly")
        log(json.dumps({"geo_lt": geo}))
        phase(24, f"storm twin on {name} ({smi}): "
            + "; ".join(
                f"{arm}: events/s "
                + ", ".join(f"{m} {r:.0f}"
                            for m, r in fig["events_per_s"].items())
                + f", waves {fig['wave_size_histogram']}, >= 32: "
                f"{fig['waves_at_least_vector_min']}, K18 launches per "
                f"block {fig['k18_launches_per_block']}"
                for arm, fig in storm["arms"].items())
            + f"; projections identical; geo-path launches K5 "
            f"{geo_launches['release']}, K6 "
            f"{geo_launches['record_and_check_epochs']}, K7 "
            f"{geo_launches['reshape_columns']}, K18 "
            f"{geo_launches['link_keep_mask']}")
        log(json.dumps({"sim_core_ab": storm}))

        sharded, sharded_launches, sharded_errors = phase_sharded(dev)
        errors.update(sharded_errors)
        phase(25, f"sharded drain on {name} ({smi}): backend "
            f"{sharded['backend']}, {sharded['ranks']} ranks on one card "
            f"(spawned in {sharded['spawn_s']:.1f} s); K19-K21 == plain "
            f"(error 0), the gathered state == the unsharded drain's after "
            f"{SHARDED_DRAINS} drains at W={WINDOW}, B={BLOCK}; per-drain "
            f"ms (rank 0: K19, K20, K21 device; the all-reduces host): "
            + "; ".join(
                f"{key}: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in
                    (fig["device_ms_rank0"] or {}).items())
                + f", psum_group {fig['split_ms_rank0']['psum_group']:.4g}"
                f", psum_slot {fig['split_ms_rank0']['psum_slot']:.4g}"
                for key, fig in sharded["cases"].items())
            + f"; {sharded['nccl']}; launches "
            + str({k: sharded_launches[k] for k in SHARDED_PATH}))
        log(json.dumps({"sharded": sharded}))

        board, board_launches, board_errors = phase_sharded_board(dev, rng)
        for kernel, err in board_errors.items():
            errors[kernel] = max(errors.get(kernel, 0), err)
        phase(26, f"sharded vote board on {name} ({smi}): backend "
            f"{board['backend']}, {board['ranks']} ranks on one card "
            f"(spawned in {board['spawn_s']:.1f} s); kernels == plain on "
            f"every shard (error 0); every drain == the unsharded tracker "
            f"== the dict oracle, boards equal, at W={WINDOW}; all-reduce "
            f"ms (rank 0, 256 / 4096 B) "
            f"{board['allreduce_ms_rank0'][256]:.4g} / "
            f"{board['allreduce_ms_rank0'][4096]:.4g}; per-drain ms: "
            + "; ".join(
                f"{arm}: {fig['drain_ms_median']:.4g} (all-reduces "
                f"{fig['allreduces_per_drain']:.3g} per drain, <= "
                f"{fig['allreduce_ms_per_drain_at_most']:.4g} ms; kernels "
                f"{fig['kernels_device_ms_per_drain']:.3g} ms)"
                for arm, fig in board["arms"].items())
            + f"; {board['nccl'] if isinstance(board['nccl'], str) else 'nccl run'}"
            f"; launches " + str({k: v for k, v in board_launches.items()
                                  if v}))
        log(json.dumps({"sharded_board": board}))

        sweep = phase_block_sweep(dev)
        phase(27, f"block sweep on {name} ({smi}), W={WINDOW}, one timed "
            f"run a block: "
            + ", ".join(f"{r['block_slots']}: {r['cmds_per_sec']:.4g} "
                        f"cmds/s, mean {r['drain_latency_us']:.4g} us, p50 "
                        f"{r['p50_drain_latency_us']} us"
                        for r in sweep["rows"])
            + f"; best under {block_sweep.TARGET_US} us: "
            f"{sweep['chosen_block']}")
        log(json.dumps({"block_sweep": sweep}))

        log(json.dumps({"drain_breakdown": result["timed_run"]}))
        split = call_split.split(dev)
        log(json.dumps({"call_split": split}))
        kernels = phase_figures(dev, rng, {
            "headline_and_tracker": launches, "cluster": cluster_launches,
            "cluster_traffic": cluster["launches"],
            "epaxos": epaxos_launches,
            "epaxos_traffic": epaxos["launches"],
            "bpaxos": bpaxos_launches,
            "bpaxos_traffic": bpaxos["launches"],
            "telemetry": overhead_launches,
            "libbench": lib_launches, "geo": geo_launches,
            "sharded": sharded_launches,
            "sharded_board": board_launches}, errors)
        turns = {row["name"]: row for row in kernels
                 if "in_turns_ms_blocks" in row}
        phase(28, f"per-kernel figures on {name} ({smi}); in turns, ms "
            f"per call: "
            + "; ".join(f"{k} {row['ms']:.5f}"
                        + (f" (out= {row['ms_out']:.5f})" if "ms_out" in row
                           else "")
                        + f" vs library {row['library_ms']:.5f}, device "
                        f"{row['device_ms']} vs bound {row['bound_ms']:.4g},"
                        f" entry {row['entry_ms']:.5f}"
                        for k, row in turns.items())
            + "; whole calls (host ns): "
            + ", ".join(f"{k} {v['whole_ns']:.0f}"
                        for k, v in split["paths"].items())
            + f"; {time.perf_counter() - T0:.1f} s in all")
        print(json.dumps({"kernels": kernels}), flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
