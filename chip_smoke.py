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
  6. the main path, with every kernel's launch count set to 0 first:
     the headline (``frankenpaxos_tpu_torch.bench.headline``) at full
     size for both arms (2^30 commits each, commit count checked), then
     a ``TpuQuorumChecker`` drain loop at window 2^20 (check_block,
     check_batch, record_block) checked against the host oracle;
  7. per-kernel figures at the main path's shapes: CUDA-event time per
     call over many calls, the plain version's time, the bound
     (bytes / 3.35 TB/s vs integer operations / 67 T/s, the larger) and
     the launches of phase 6, printed as one ``{"kernels": [...]}`` line;
     before it, each headline arm's drain split into device time
     (profiler) and the share of the drain the device sits idle.

The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import sys
import time
import warnings

import frankenpaxos_tpu_torch
from frankenpaxos_tpu_torch.bench import headline, pipeline as tp
from frankenpaxos_tpu_torch.device import nvidia_smi_line
from frankenpaxos_tpu_torch.ops import _build, quorum as tq
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority
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


def reset_launches() -> None:
    tq.quorum_hit.launches = 0
    tq.record_block.launches = 0
    tp.steady_state_step.launches = 0


def phase_main_path(dev, rng) -> tuple[dict, dict]:
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
    launches = {"quorum_hit": tq.quorum_hit.launches,
                "record_block": tq.record_block.launches,
                "steady_state_step": tp.steady_state_step.launches}
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    result["checker_chosen"] = chosen
    return result, launches


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


def phase_figures(dev, rng, launches: dict, errors: dict) -> list:
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

    cases = [
        # name, kernel fn, plain fn, device kernel name, bytes, int ops,
        # source, replaces
        ("quorum_hit", lambda: tq.quorum_hit(votes, pred),
         lambda: tq.quorum_hit_plain(votes, pred), "quorum_hit_kernel",
         (n + 1) * BLOCK, (2 * g * n + 2 * g) * BLOCK,
         "frankenpaxos_tpu_torch/ops/csrc/quorum.cu",
         "frankenpaxos_tpu/ops/quorum.py:77"),
        ("record_block",
         lambda: tq.record_block(board_k, 0, 0, votes, 0, pred),
         lambda: tq.record_block_plain(board_p, 0, 0, votes, 0, pred),
         "record_block_kernel", (3 * n + 19) * BLOCK,
         (6 * n + 2 * g * n + 30) * BLOCK,
         "frankenpaxos_tpu_torch/ops/csrc/quorum.cu",
         "frankenpaxos_tpu/ops/quorum.py:267"),
        ("steady_state_step", k3, k3_plain, "steady_state_step_kernel",
         (5 * n + 17) * BLOCK, (2 * (10 * n + 2 * g * n + 8) + 30) * BLOCK,
         "frankenpaxos_tpu_torch/ops/csrc/pipeline.cu",
         "frankenpaxos_tpu/bench/pipeline.py:145"),
    ]
    out = []
    for name, fn, plain, kname, nbytes, ops, source, replaces in cases:
        ms = time_ms(fn, 2000)
        plain_ms = time_ms(plain, 200)
        dev_ms = device_ms(fn, kname)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT_OPS_PER_S * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "device_ms": dev_ms, "bytes": nbytes,
            "shape": f"N={n} B={BLOCK} W={WINDOW}",
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
        log(f"[1/7] device: {name} ({torch.cuda.device_count()} visible), "
            f"torch {torch.__version__}, cuda {torch.version.cuda}")
        require(smi is not None, "nvidia-smi gave no name and power limit")
        log(smi)

        seconds = _build.build()
        log(f"[2/7] build: {seconds:.1f} s")
        for lib in _build.SIGNATURES:
            for line in _build.build_log(lib).splitlines():
                if re.search(r"registers|spill", line):
                    log(f"      {lib}: {line.strip()}")

        errors = {"quorum_hit": phase_k1(dev, rng)}
        log(f"[3/7] K1 quorum_hit == plain (5 specs, B={BLOCK})")
        errors["record_block"] = phase_k2(dev, rng)
        log(f"[4/7] K2 record_block == plain (64 calls, W={WINDOW})")
        errors["steady_state_step"] = phase_k3(dev)
        log(f"[5/7] K3 steady_state_step == plain (64 drains x 2 specs)")

        result, launches = phase_main_path(dev, rng)
        log(f"[6/7] headline on {name} ({smi}): "
            f"{result['value']} cmds/s majority-3, "
            f"{result['grid_cmds_per_sec']} cmds/s grid 2x3; mean drain "
            f"{result['mean_quorum_batch_latency_us']} us, p50 "
            f"{result['p50_drain_latency_us']} us, p99 "
            f"{result['p99_drain_latency_us']} us; launches {launches}")
        log(json.dumps({"headline": result}))

        log(json.dumps({"drain_breakdown": phase_breakdown(dev, result)}))
        kernels = phase_figures(dev, rng, launches, errors)
        log(f"[7/7] per-kernel figures on {name} ({smi}); "
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
