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
  5. K3 ``steady_state_step`` against its plain version: 64 drains at
     window 2^20, block 2^15, majority-3 and 2x3 grid; every field of
     the state equal after every drain;
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
     size for both arms (2^30 commits each, commit count checked), a
     ``TpuQuorumChecker`` drain loop at window 2^20 (check_block,
     check_batch, record_block) checked against the host oracle, and
     ``bench/tracker_lt.py`` at full width (window 2^20, 2^20 slots per
     arm: sync, pipelined, 2x3 grid, epoch handover), every arm checked
     against its dict oracle; K1-K7 must each have launched;
  12. the MultiPaxos cluster path, with every count set to 0 again
     first: ``bench/multipaxos_sim.py`` at full width (2^16 steady
     writes on the synchronous tracker, a failover whose recovery runs
     K8 on [2^16, 3], 2^14 writes on the pipelined tracker whose last
     wave has one acceptor's votes straggle across a failover), every
     write answered with its state machine result, both replicas'
     logs equal, K8's recovery equal to the host path's; K1, K2, K4
     and K8 must each have launched on the arms' traffic (K4 on the
     pipelined arm's straggling votes; K5 runs only in the pipelined
     trackers' construction prewarm, as no role releases the board);
  13. per-kernel figures at the main path's shapes: CUDA-event time per
     call over many calls, the plain version's time, the bound
     (bytes / 3.35 TB/s vs integer operations / 67 T/s, the larger) and
     the launches of phases 11 and 12, printed as one
     ``{"kernels": [...]}`` line; before it, each headline arm's drain
     split into device time (profiler) and the share of the drain the
     device sits idle.

The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import sys
import time
import warnings

import frankenpaxos_tpu_torch
from frankenpaxos_tpu_torch.bench import (
    headline,
    multipaxos_sim,
    pipeline as tp,
    tracker_lt,
)
from frankenpaxos_tpu_torch.device import nvidia_smi_line
from frankenpaxos_tpu_torch.ops import _build, quorum as tq, value as tv
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority
from frankenpaxos_tpu_torch.quorums.spec import pad_specs
import numpy as np
import torch

WINDOW = 1 << 20
BLOCK = 1 << 15
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT_OPS_PER_S = 67e12       # H100 non-tensor float32 peak, used for int ops
SEED = 20261017


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_k3(dev) -> int:
    worst = 0
    for name, n in (("majority3", 3), ("grid2x3_write", 6)):
        pred = predicate(specs()[name], dev)
        kern = tp.make_state(WINDOW, n, device=dev)
        plain = tp.make_state(WINDOW, n, device=dev)
        for i in range(64):
            tp.steady_state_step(kern, i, block_size=BLOCK, predicate=pred)
            tp.steady_state_step_plain(plain, i, BLOCK, pred)
            err = max(max_abs_err(a, b) for a, b in zip(kern[:7], plain[:7]))
            worst = max(worst, err)
            require(err == 0, f"K3 differs from plain on {name} at drain "
                              f"{i}")
        require(int(kern.committed) > 60 * BLOCK,
                f"K3 {name} committed only {int(kern.committed)}")
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
}
#: The kernels of the main path, K1-K7 (check_batch_multi, K6's
#: stateless predicate, is not on it).
MAIN_PATH = ("quorum_hit", "record_block", "steady_state_step",
             "record_and_check", "release", "record_and_check_epochs",
             "reshape_columns")


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def phase_cluster(dev) -> tuple[dict, dict]:
    """The MultiPaxos cluster path at full width; its gates raise inside
    ``multipaxos_sim.run``. The counts read after it include the
    pipelined trackers' construction prewarm; the launch gate reads the
    arms' traffic alone."""
    reset_launches()
    try:
        result = multipaxos_sim.run(dev)
    except multipaxos_sim.GateFailure as exc:
        raise SmokeFailure(f"cluster: {exc}") from exc
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    traffic = result["launches"]
    require(all(traffic[name] > 0
                for name in multipaxos_sim.CLUSTER_KERNELS),
            f"a kernel of the cluster path never launched on its "
            f"traffic: {traffic}")
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
    require(all(launches[name] > 0 for name in MAIN_PATH),
            f"a kernel of the main path never launched: {launches}")
    return result, votes, launches


def time_ms(fn, iters: int) -> float:
    for _ in range(20):
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


def phase_breakdown(dev, result: dict) -> dict:
    """Per headline arm: the device time of one drain (profiler) beside
    the headline's host-timed mean drain, and the share of each drain
    the device sits idle."""
    out = {}
    for arm, mean_key in (("majority3", "mean_quorum_batch_latency_us"),
                          ("grid2x3_write", "grid_mean_batch_latency_us")):
        spec = specs()[arm]
        pred = predicate(spec, dev)
        state = tp.make_state(WINDOW, spec.num_nodes, device=dev)
        drain = iter(range(1 << 30))
        kernel_ms = device_ms(
            lambda: tp.steady_state_step(state, next(drain),
                                         block_size=BLOCK, predicate=pred),
            "steady_state_step_kernel", iters=1000)
        mean_us = result[mean_key]
        out[arm] = {
            "mean_drain_us": mean_us,
            "kernel_us": None if kernel_ms is None else kernel_ms * 1e3,
            "device_idle_share": None if kernel_ms is None
            else 1 - kernel_ms * 1e3 / mean_us,
        }
    return out


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


def phase_figures(dev, rng, launches: dict, cluster_launches: dict,
                  cluster_traffic: dict, errors: dict) -> list:
    """Per kernel at the main path's shapes: wrapper call time (CUDA
    events), device time (profiler), the plain version's time, and the
    bound from the bytes and integer operations the call needs."""
    spec = specs()["majority3"]
    n = spec.num_nodes
    pred = predicate(spec, dev)
    g = pred.masks.shape[0]
    votes = torch.from_numpy(
        (rng.random((n, BLOCK)) < 0.6).astype(np.uint8)).to(dev)
    board_k = tq.make_vote_board(WINDOW, n, device=dev)
    board_p = tq.make_vote_board(WINDOW, n, device=dev)
    state_k = tp.make_state(WINDOW, n, device=dev)
    state_p = tp.make_state(WINDOW, n, device=dev)
    drains = {"k": 0, "p": 0}

    def k3():
        tp.steady_state_step(state_k, drains["k"], block_size=BLOCK,
                             predicate=pred)
        drains["k"] += 1

    def k3_plain():
        tp.steady_state_step_plain(state_p, drains["p"], BLOCK, pred)
        drains["p"] += 1

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
        ("steady_state_step", k3, k3_plain, "steady_state_step_kernel",
         (5 * n + 17) * BLOCK, (2 * (10 * n + 2 * g * n + 8) + 30) * BLOCK,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline.cu",
         "frankenpaxos_tpu/bench/pipeline.py:145",
         f"N={n} B={BLOCK} W={WINDOW}"),
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
    ]
    out = []
    for (name, fn, plain, kname, nbytes, ops, source, replaces,
         shape) in cases:
        ms = time_ms(fn, 2000)
        plain_ms = time_ms(plain, 200)
        dev_ms = device_ms(fn, kname)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT_OPS_PER_S * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name] + cluster_launches[name],
            "launches_by_path": {"headline_and_tracker": launches[name],
                                 "cluster": cluster_launches[name],
                                 "cluster_traffic":
                                     cluster_traffic.get(name, 0)},
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "device_ms": dev_ms, "bytes": nbytes,
            "shape": shape,
        })
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
    t_start = time.perf_counter()
    try:
        name = torch.cuda.get_device_name(dev)
        smi = nvidia_smi_line()
        log(f"[1/13] device: {name} ({torch.cuda.device_count()} "
            f"visible), torch {torch.__version__}, cuda {torch.version.cuda}")
        require(smi is not None, "nvidia-smi gave no name and power limit")
        log(smi)

        seconds = _build.build()
        log(f"[2/13] build: {seconds:.1f} s")
        for lib in _build.SIGNATURES:
            for line in _build.build_log(lib).splitlines():
                if re.search(r"registers|spill", line):
                    log(f"      {lib}: {line.strip()}")

        errors = {"quorum_hit": phase_k1(dev, rng)}
        log(f"[3/13] K1 quorum_hit == plain (5 specs, B={BLOCK})")
        errors["record_block"] = phase_k2(dev, rng)
        log(f"[4/13] K2 record_block == plain (64 calls, W={WINDOW})")
        errors["steady_state_step"] = phase_k3(dev)
        log("[5/13] K3 steady_state_step == plain (64 drains x 2 specs)")
        errors["record_and_check"] = phase_k4(dev, rng)
        log(f"[6/13] K4 record_and_check == plain (64 calls of 64-4096 "
            f"lanes x 2 specs, W={WINDOW})")
        errors["release"] = phase_k5(dev, rng)
        log(f"[7/13] K5 release == plain (16 calls of 4096 lanes, "
            f"W={WINDOW})")
        errors.update(phase_k6(dev, rng))
        log(f"[8/13] K6 check_batch_multi and record_and_check_epochs == "
            f"plain (3 epochs, 5-node union, W={EPOCH_WINDOW})")
        errors["reshape_columns"] = phase_k7(dev, rng)
        log(f"[9/13] K7 reshape_columns == plain ([3, {WINDOW}] -> "
            f"[4, {WINDOW}] and [2, {WINDOW}])")
        errors["safe_values"] = phase_k8(dev, rng)
        log(f"[10/13] K8 safe_values == plain ([{RECOVERY_ROWS}, 3] and "
            f"[{RECOVERY_ROWS}, 6])")

        result, votes, launches = phase_main_path(dev, rng)
        log(f"[11/13] main path on {name} ({smi}): headline "
            f"{result['value']} cmds/s majority-3, "
            f"{result['grid_cmds_per_sec']} cmds/s grid 2x3; mean drain "
            f"{result['mean_quorum_batch_latency_us']} us, p50 "
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
        log(f"[12/13] cluster on {name} ({smi}): committed writes/s "
            + ", ".join(f"{arm} {fig['writes_per_sec']:.0f}"
                        for arm, fig in arms.items())
            + f"; K8 recovery {arms['failover']['recovery']['shape']}; "
            f"launches {cluster_launches}, of them by the arms' traffic "
            f"{cluster['launches']}")
        log(json.dumps({"cluster": cluster}))

        log(json.dumps({"drain_breakdown": phase_breakdown(dev, result)}))
        kernels = phase_figures(dev, rng, launches, cluster_launches,
                                cluster["launches"], errors)
        log(f"[13/13] per-kernel figures on {name} ({smi}); "
            f"{time.perf_counter() - t_start:.1f} s in all")
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
