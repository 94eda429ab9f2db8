"""paxpulse telemetry overhead on one GPU: pinned-baseline / off / on
paired A/B.

The port's twin of ``frankenpaxos_tpu/bench/telemetry_overhead.py``.
Run::

    python -m frankenpaxos_tpu_torch.bench.telemetry_overhead \\
        [--smoke] [--device cpu] [--out FILE]

It prints ONE JSON line (and writes it to ``--out`` when given). The
telemetry plane (``ops/telemetry.py``) claims to be free when disabled:
a state without telemetry launches K3, the drain as it was before the
plane. Three arms, each a persistent state advanced in ``iters``-drain
chunks by ``run_steps_from``:

  * **baseline** -- the pinned telemetry-off drain
    (``bench/pipeline_baseline.py``, its own copy of the K3 source,
    re-pinned to the chunked design), so the comparison arm
    cannot drift when the live module is edited;
  * **off** -- the live drain with ``telemetry=False`` (K3). Gate: less
    than 3% throughput overhead against the baseline at the worst width;
  * **on** -- the live drain with ``telemetry=True`` (K14), recorded but
    not gated: telemetry is an explicit opt-in.

Every arm advances a chunk as ONE launch of its chunked drain kernel.

Methodology (the reference's): chunks of the three arms interleaved,
order rotated every chunk, GC off across the timed region, warmup chunks
discarded, one value fetch (a full sync) after each chunk; per-block
ratio = summed-time ratio; the row = median over independent blocks,
each with fresh states. The arms' committed counts must agree.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

from frankenpaxos_tpu_torch.bench import (
    pipeline as live,
    pipeline_baseline as pinned,
)
from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.quorums import SimpleMajority
import torch

ARMS = ("baseline", "off", "on")
#: The reference's ``--smoke`` knobs and its full-run knobs.
SMOKE_KNOBS = {"warmup": 1, "chunks": 4, "iters": 1024, "blocks": 7}
FULL_KNOBS = {"warmup": 2, "chunks": 5, "iters": 512, "blocks": 5}
#: The reference's widths (window, block); ``--smoke`` runs the first.
WIDTHS = ((1 << 12, 1 << 8), (1 << 13, 1 << 9))


def _spec_arrays() -> tuple:
    masks, thresholds, combine_any = \
        SimpleMajority(range(3)).write_spec().as_arrays()
    return (tuple(tuple(int(x) for x in row) for row in masks),
            tuple(int(t) for t in thresholds), combine_any)


def measure_ab_block(window: int, block_size: int, *, warmup: int,
                     chunks: int, iters: int, device=None) -> dict:
    """One chunk-interleaved block over the three persistent arms on
    ``device`` (``cuda`` when None)."""
    dev = resolve_device(device)
    masks_t, thresholds_t, combine_any = _spec_arrays()
    n_acc = len(masks_t[0])

    states = {
        "baseline": pinned.make_state(window, n_acc, device=dev),
        "off": live.make_state(window, n_acc, telemetry=False, device=dev),
        "on": live.make_state(window, n_acc, telemetry=True, device=dev),
    }

    def advance(arm, start):
        mod = pinned if arm == "baseline" else live
        mod.run_steps_from(states[arm], start, iters, block_size, masks_t,
                           thresholds_t, combine_any)

    # Warm every arm at the timed shape; the arms must stay in lockstep
    # (same committed watermark) for the pairing to be fair.
    for arm in ARMS:
        advance(arm, 0)
    committed = {arm: int(states[arm].committed) for arm in ARMS}
    assert len(set(committed.values())) == 1, committed
    at = iters

    total = {arm: 0.0 for arm in ARMS}
    gc.collect()
    gc.disable()
    try:
        for k in range(warmup + chunks):
            order = ARMS[k % 3:] + ARMS[:k % 3]
            for arm in order:
                t0 = time.perf_counter()
                advance(arm, at)
                _ = int(states[arm].committed)  # value fetch: full sync
                if k >= warmup:
                    total[arm] += time.perf_counter() - t0
            at += iters
    finally:
        gc.enable()

    committed = {arm: int(states[arm].committed) for arm in ARMS}
    cmds = chunks * iters * block_size
    return {
        **{f"{arm}_s": total[arm] for arm in ARMS},
        **{f"{arm}_cmds_per_sec": cmds / total[arm] for arm in ARMS},
        "off_over_baseline_ratio": total["baseline"] / total["off"],
        "on_over_off_ratio": total["off"] / total["on"],
        "arms_agree": len(set(committed.values())) == 1,
        "committed": committed["off"],
    }


def measure_width(window: int, block_size: int, knobs: dict,
                  device=None) -> dict:
    """Median-of-blocks for one (window, block) width; fresh states per
    block so one cold block cannot swing the ratio."""
    rows = [measure_ab_block(window, block_size,
                             warmup=knobs["warmup"],
                             chunks=knobs["chunks"],
                             iters=knobs["iters"], device=device)
            for _ in range(knobs["blocks"])]
    out = {
        "window": window,
        "block": block_size,
        "blocks": len(rows),
        "drains_per_chunk": knobs["iters"],
        "arms_agree": all(r["arms_agree"] for r in rows),
    }
    for arm in ARMS:
        out[f"{arm}_cmds_per_sec_med"] = round(statistics.median(
            r[f"{arm}_cmds_per_sec"] for r in rows), 1)
    for key in ("off_over_baseline_ratio", "on_over_off_ratio"):
        values = [r[key] for r in rows]
        out[key] = round(statistics.median(values), 4)
        out[key + "_range"] = [round(min(values), 4),
                               round(max(values), 4)]
    return out


def run(device=None, smoke: bool = False, blocks=None, widths=None,
        knobs=None) -> dict:
    """Every width (the reference's: both, or the first with ``smoke``)
    on ``device`` (``cuda`` when None; raises without a GPU unless a
    device is named); the reference's artifact keys, plus the device."""
    dev = resolve_device(device)
    widths = widths or (WIDTHS[:1] if smoke else WIDTHS)
    knobs = dict(knobs or (SMOKE_KNOBS if smoke else FULL_KNOBS))
    if blocks:
        knobs["blocks"] = blocks
    pairs = {str(block): measure_width(window, block, knobs, dev)
             for window, block in widths}
    off_worst = max((1.0 - row["off_over_baseline_ratio"]) * 100.0
                    for row in pairs.values())
    on_worst = max((1.0 - row["on_over_off_ratio"]) * 100.0
                   for row in pairs.values())
    return {
        "benchmark": "telemetry_overhead",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "host_cpus": os.cpu_count(),
        "smoke": smoke,
        "pairs": pairs,
        "off_overhead_pct_worst_width": round(off_worst, 2),
        "on_overhead_pct_worst_width": round(on_worst, 2),
        "gate": "telemetry-off drain must be < 3% below the pinned "
                "pre-telemetry baseline at the worst width; the ON arm "
                "is recorded, not gated (explicit opt-in)",
        "gate_passed": off_worst < 3.0,
        "methodology": (
            "three-arm paired in-process A/B, alternating-chunk with GC "
            "off: pinned telemetry-off drain (bench/pipeline_baseline.py "
            "over ops/csrc/pipeline_baseline.cu, immune to live-module "
            "edits; re-pinned to the chunked design, a verbatim copy "
            "of the chunked K3 kernel) vs live telemetry-off (K3) vs "
            "live telemetry-on (K14), each chunk ONE launch of its chunked "
            "drain kernel. Persistent per-arm states "
            "advance in run_steps_from chunks (ring positions and arrival "
            "hashes continue across chunks), order rotated per chunk, "
            "warmup chunks discarded, one value fetch per chunk, "
            "committed watermarks asserted equal across arms. Per-block "
            "ratio = summed-time ratio; row = median over independent "
            "fresh-state blocks."),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--out", default=None,
                        help="also write the artifact here")
    parser.add_argument("--smoke", action="store_true",
                        help="the reference's reduced knobs")
    parser.add_argument("--blocks", type=int, default=None)
    args = parser.parse_args(argv)
    result = run(args.device, smoke=args.smoke, blocks=args.blocks)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
