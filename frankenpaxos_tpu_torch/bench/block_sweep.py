"""Block-size frontier of the device drain on one GPU.

The port's twin of ``frankenpaxos_tpu/bench/block_sweep.py``: sweeps the
per-drain block size of the steady-state MultiPaxos pipeline
(``bench/pipeline.py::run_steps``, one launch of the chunked drain
kernel per run of up to ``MAX_DRAINS`` drains) at the 1M-slot window and
records, per block size, committed cmds/s and per-drain latency. It is
the reference's justification for ``BLOCK = 2^15`` in the headline
(``bench/headline.py``): the highest-throughput point whose per-drain
latency stays under the 50 us target of ``BASELINE.json``. Each point is
``repeats`` timed runs after one warm run, summarized by its WORST run,
and the chunked per-drain distribution
(``pipeline.drain_latency_distribution``). Run::

    python -m frankenpaxos_tpu_torch.bench.block_sweep [--repeats 3] \\
        [--device cpu] [--out FILE]

It prints one JSON line per block size, then the frontier as ONE JSON
line (written to ``--out`` when given). Off CUDA it raises unless a
device is named.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from frankenpaxos_tpu_torch.bench.headline import spec_arrays
from frankenpaxos_tpu_torch.bench.pipeline import (
    drain_latency_distribution,
    make_state,
    run_steps,
)
from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.quorums import SimpleMajority
import torch

WINDOW = 1 << 20
NUM_ACCEPTORS = 3
BLOCKS = (1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17)
TARGET_US = 50.0
#: Drains a point runs: ``max(MIN_ITERS, WORK // block)``, so the
#: committed work stays about equal across points (the reference's).
WORK = 1 << 30
MIN_ITERS = 2048


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(block: int, iters: int, repeats: int = 3, *,
            latency_budget_s: float = 8.0, target_samples: int = 256,
            device=None) -> dict:
    """One block size on ``device``: ``repeats`` timed runs of ``iters``
    drains from fresh states after one warm run, each of which must
    commit what the warm run did (within 2 blocks of ``iters * block``),
    summarized by the WORST run; then the chunked per-drain latency
    distribution at this block size."""
    device = resolve_device(device)
    arrays = spec_arrays(SimpleMajority(range(NUM_ACCEPTORS)).write_spec())
    state = make_state(WINDOW, NUM_ACCEPTORS, device=device)
    run_steps(state, iters, block, *arrays)
    warm_committed = int(state.committed)

    runs = []
    for _ in range(repeats):
        state = make_state(WINDOW, NUM_ACCEPTORS, device=device)
        _sync(device)
        t0 = time.perf_counter()
        run_steps(state, iters, block, *arrays)
        committed = int(state.committed)  # the fetch orders after compute
        elapsed = time.perf_counter() - t0
        if committed != warm_committed:
            raise RuntimeError(f"nondeterministic pipeline: {committed} "
                               f"committed vs {warm_committed} warm")
        if abs(committed - iters * block) > 2 * block:
            raise RuntimeError(f"committed {committed}, expected "
                               f"{iters * block} +- {2 * block}")
        runs.append({"elapsed_s": elapsed,
                     "cmds_per_sec": committed / elapsed,
                     "drain_latency_us": elapsed / iters * 1e6})
    worst = min(runs, key=lambda r: r["cmds_per_sec"])
    dist = drain_latency_distribution(
        arrays, NUM_ACCEPTORS, WINDOW, block, worst["drain_latency_us"],
        time_budget_s=latency_budget_s, target_samples=target_samples,
        device=device)
    return {
        "block_slots": block,
        "iters": iters,
        "committed": warm_committed,
        "runs": runs,
        "cmds_per_sec": worst["cmds_per_sec"],
        "drain_latency_us": max(r["drain_latency_us"] for r in runs),
        **{k: dist[k] for k in ("p50_drain_latency_us",
                                "p99_drain_latency_us",
                                "latency_samples", "drains_per_sample")},
    }


def run(device=None, *, repeats: int = 3, latency_budget_s: float = 8.0,
        target_samples: int = 256, log=None) -> dict:
    """Every block size of :data:`BLOCKS` and the frontier: the highest
    worst-run throughput whose worst mean drain stays under
    :data:`TARGET_US`. ``repeats`` and the latency distribution's budget
    and samples may be cut (the smoke cuts them)."""
    device = resolve_device(device)
    rows = []
    for block in BLOCKS:
        row = measure(block, max(MIN_ITERS, WORK // block), repeats,
                      latency_budget_s=latency_budget_s,
                      target_samples=target_samples, device=device)
        rows.append(row)
        if log is not None:
            log(json.dumps(row))
    eligible = [r for r in rows if r["drain_latency_us"] < TARGET_US]
    best = max(eligible or rows, key=lambda r: r["cmds_per_sec"])
    return {
        "suite": "block_sweep",
        "window_slots": WINDOW,
        "num_acceptors": NUM_ACCEPTORS,
        "target_drain_latency_us": TARGET_US,
        "repeats": repeats,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "rows": rows,
        "chosen_block": best["block_slots"],
        "target_met": bool(eligible),
        "frontier": [(r["block_slots"], r["cmds_per_sec"],
                      r["drain_latency_us"], r["p50_drain_latency_us"])
                     for r in rows],
        "note": ("each point is `repeats` timed runs after a warm run; "
                 "cmds_per_sec / drain_latency_us summarize the WORST run, "
                 "so the chosen block (the highest worst-case throughput "
                 "under the 50 us latency target) is robust to run noise"
                 if eligible else
                 "no block size met the latency target on this run; "
                 "chosen_block is the fastest point regardless"),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--out", default=None,
                        help="also write the frontier here")
    args = parser.parse_args(argv)
    result = run(args.device, repeats=args.repeats,
                 log=lambda line: print(line, flush=True))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
