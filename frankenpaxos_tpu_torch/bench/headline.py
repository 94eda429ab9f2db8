"""Headline benchmark: committed cmds/s of the device-resident MultiPaxos
steady-state pipeline at 1M in-flight slots, on one GPU.

The single-GPU counterpart of the JAX package's ``bench.py``: the same
window, drain shape and iteration count, the same majority-3 and 2x3
grid arms, the same per-drain p50/p99 method, and ``vs_baseline``
against the same reference figure (peak batched compartmentalized
MultiPaxos, ~934k cmds/s; BASELINE.md). Run::

    python -m frankenpaxos_tpu_torch.bench.headline

Prints ONE JSON line. Off CUDA it REFUSES to stamp a headline: the line
says ``"degraded": true`` with no value and the exit code is nonzero.
"""

from __future__ import annotations

import json
import sys
import time

from frankenpaxos_tpu_torch.bench.pipeline import (
    drain_latency_distribution,
    make_state,
    run_steps,
)
from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority
import torch

METRIC = "committed_cmds_per_sec_at_1M_inflight_slots"
BASELINE_CMDS_PER_SEC = 934_000.0

WINDOW = 1 << 20          # 1M in-flight slots
NUM_ACCEPTORS = 3         # f = 1, SimpleMajority
BLOCK = 1 << 15           # 32K-slot drains, as bench.py
ITERS = 32768             # ITERS * BLOCK = 2^30 commits: no int32 wrap


def spec_arrays(spec) -> tuple:
    """``(masks_t, thresholds_t, combine_any)`` of a ``QuorumSpec``."""
    masks, thresholds, combine_any = spec.as_arrays()
    return (tuple(tuple(int(x) for x in row) for row in masks),
            tuple(int(t) for t in thresholds), combine_any)


def measure_arm(spec, num_acceptors: int,
                device=None) -> tuple[float, float, float]:
    """``(cmds_per_sec, mean drain latency us, mean drain device us)`` of
    ``ITERS`` drains at ``WINDOW``/``BLOCK``: a warm run, then a timed run
    from a fresh state that must commit what the warm run did, within 2
    blocks of ``ITERS * BLOCK``. The host clock times the run to its
    value fetch; CUDA events recorded on the stream around the same run
    time its device work (one launch of the drain kernel)."""
    device = resolve_device(device)
    arrays = spec_arrays(spec)
    state = make_state(WINDOW, num_acceptors, device=device)
    run_steps(state, ITERS, BLOCK, *arrays)
    warm_committed = int(state.committed)

    state = make_state(WINDOW, num_acceptors, device=device)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    begin.record()
    run_steps(state, ITERS, BLOCK, *arrays)
    end.record()
    # A value fetch cannot complete before the last drain.
    committed = int(state.committed)
    elapsed = time.perf_counter() - t0
    if committed != warm_committed:
        raise RuntimeError(f"nondeterministic pipeline: {committed} "
                           f"committed vs {warm_committed} warm")
    expected = ITERS * BLOCK
    if abs(committed - expected) > 2 * BLOCK:
        raise RuntimeError(f"committed {committed}, expected {expected} "
                           f"+- {2 * BLOCK}")
    device_us = begin.elapsed_time(end) * 1e3 / ITERS
    return committed / elapsed, elapsed / ITERS * 1e6, device_us


def measure(device=None, latency_budget_s: float = 20.0) -> dict:
    """The headline's JSON fields, measured on ``device`` (a CUDA
    device; ``cuda`` when None)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the headline measures a CUDA device")
    majority = SimpleMajority(range(NUM_ACCEPTORS)).write_spec()
    cmds_per_sec, batch_latency_us, device_us = measure_arm(
        majority, NUM_ACCEPTORS, device)
    dist = drain_latency_distribution(
        spec_arrays(majority), NUM_ACCEPTORS, WINDOW, BLOCK,
        batch_latency_us, time_budget_s=latency_budget_s, device=device)
    # The grid (flexible-quorum) predicate at the same scale: a 2x3
    # grid's write quorums, "one vote in every row".
    grid_cmds_per_sec, grid_latency_us, grid_device_us = measure_arm(
        Grid([[0, 1, 2], [3, 4, 5]]).write_spec(), 6, device)
    return {
        "metric": METRIC,
        "value": round(cmds_per_sec, 1),
        "unit": "cmds/s",
        "mean_quorum_batch_latency_us": round(batch_latency_us, 2),
        **dist,
        "grid_cmds_per_sec": round(grid_cmds_per_sec, 1),
        "grid_mean_batch_latency_us": round(grid_latency_us, 2),
        "latency_note": ("mean_quorum_batch_latency_us is the mean over "
                         "the timed run (throughput figure); p50/p99_"
                         "drain_latency_us come from the chunked "
                         "distribution (see latency_method)"),
        # The timed runs unrounded: host clock and CUDA events over the
        # same run, and the share of it the device sat idle.
        "timed_run": {
            arm: {"host_us_per_drain": host, "device_us_per_drain": dev,
                  "device_idle_share": 1 - dev / host}
            for arm, host, dev in (
                ("majority3", batch_latency_us, device_us),
                ("grid2x3_write", grid_latency_us, grid_device_us))},
        "block_slots": BLOCK,
        "window_slots": WINDOW,
        "iters": ITERS,
        "probe_note": f"cuda device {device} of "
                      f"{torch.cuda.device_count()}",
        "device": torch.cuda.get_device_name(device),
        "nvidia_smi": nvidia_smi_line(),
        "degraded": False,
        "vs_baseline": round(cmds_per_sec / BASELINE_CMDS_PER_SEC, 3),
    }


def main() -> int:
    if not torch.cuda.is_available():
        # REFUSE the headline: no value, no vs_baseline -- a CPU run
        # must never be recorded as a device result.
        print(json.dumps({
            "metric": METRIC,
            "degraded": True,
            "note": "refusing to stamp a headline: no CUDA device "
                    "(torch.cuda.is_available() is False)",
        }))
        return 1
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
