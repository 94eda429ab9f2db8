"""Another checkout of the port against this one, in turns, on one GPU.

An A/B of two commits in one call: each measurement runs in a fresh
process that imports ``frankenpaxos_tpu_torch`` from one tree (each
builds its kernels into its own ``ops/_build``), in the order parent,
change, change, parent, five times over, so that both trees see the
host's drift alike.
Measurements:

  * ``split``: ``bench/call_split.py`` of THIS tree against each tree's
    call paths (the K18 / K12 wrappers and their transport-facing
    entries: host ns per call, and each function's share under
    ``cProfile``);
  * ``storm``: ``bench/sim_core_ab.py``'s arms (jittered and jitter-free
    storm, FIFO backlog), events/s with the numpy mask and with K18;
  * ``bpaxos``: ``bench/bpaxos_sim.py`` (simple-conflict2/25 and gc) on
    the host and the cuda backends, commands/s, at ``--bpaxos-commands``
    per arm; every gate of both benches holds in every run.

Unpack the parent into a directory the checkout ignores, then run from
the root of this checkout::

    git archive <parent> | tar -x -C _chipcheck/parent
    python frankenpaxos_tpu_torch/bench/tree_ab.py --parent _chipcheck/parent

(``--device cpu --bpaxos-commands 256`` rehearses it on the CPU, without
the split.) It prints ONE JSON line (the medians per tree, a verdict
per metric, then every reading) and, with ``--out FILE``, writes it
there too. A verdict is a gain or a loss only when one tree wins at
least nine pairs in ten and the medians differ by more than the
parent's interquartile spread; else it is unresolved.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
#: Ten runs of each tree in alternating pairs: one pair moves the storm
#: and BPaxos arms by more than a host-side change gains.
ORDER = ("parent", "change", "change", "parent") * 5
BPAXOS_COMMANDS = 1 << 13


def _worker(kind: str, tree: str, commands: int, device=None) -> dict:
    """One measurement against ``tree``'s package, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    if kind == "storm":
        from frankenpaxos_tpu_torch.bench import sim_core_ab

        out = sim_core_ab.run(device)
        return {arm: {"events_per_s": fig["events_per_s"],
                      "k18_launches_per_block":
                          fig["k18_launches_per_block"],
                      "projection_sha256": fig["projection_sha256"]}
                for arm, fig in out["arms"].items()}
    if kind == "bpaxos":
        from frankenpaxos_tpu_torch.bench import bpaxos_sim

        out = bpaxos_sim.run(device, commands=commands)
        return {arm: {b: fig[b]["commands_per_sec"]
                      for b in ("host", "cuda")}
                for arm, fig in out["arms"].items()}
    raise ValueError(f"unknown measurement {kind!r}")


def _run(cmd: list, timeout: float) -> dict:
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _flatten(reading: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in reading.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + " / "))
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            out[name] = value
    return out


def _verdicts(sides: dict) -> dict:
    """Per metric (host ns, lower is better; events/s and commands/s,
    higher), over the runs in pairs (the i-th parent run beside the i-th
    change run): both medians, the parent's interquartile spread, the
    pairs the change won, and the verdict. A ``gain`` (or ``loss``) needs
    the change (or the parent) to win at least nine pairs in ten and
    the medians to differ by more than the parent's spread; anything
    else is ``unresolved``. The split's per-function shares are left
    out."""
    flat = {side: [_flatten(r) for r in runs] for side, runs in sides.items()}
    out = {}
    for key in flat["parent"][0]:
        if key.startswith("split_ns") or not all(
                key in f for side in flat for f in flat[side]):
            continue
        lower = "_ns" in key
        parent = [f[key] for f in flat["parent"]]
        change = [f[key] for f in flat["change"]]
        pairs = list(zip(parent, change))
        won = sum((c < p) if lower else (c > p) for p, c in pairs)
        lost = sum((c > p) if lower else (c < p) for p, c in pairs)
        q1, _, q3 = statistics.quantiles(parent, n=4) if len(parent) > 1 \
            else (parent[0],) * 3
        mp, mc = statistics.median(parent), statistics.median(change)
        apart = abs(mc - mp) > q3 - q1
        better = (mc < mp) if lower else (mc > mp)
        verdict = "unresolved"
        if apart and better and won >= 0.9 * len(pairs):
            verdict = "gain"
        elif apart and not better and lost >= 0.9 * len(pairs):
            verdict = "loss"
        out[key] = {"parent": mp, "change": mc, "parent_iqr": q3 - q1,
                    "change_won": won, "pairs": len(pairs),
                    "verdict": verdict}
    return out


def run(parent: str, commands: int = BPAXOS_COMMANDS, device=None) -> dict:
    """The measurements in turns, ``parent`` against this checkout; on
    the CPU (``device="cpu"``, a rehearsal) without the split, which
    times CUDA calls."""
    trees = {"parent": os.path.abspath(parent), "change": ROOT}
    kinds = ("storm", "bpaxos") if device == "cpu" \
        else ("split", "storm", "bpaxos")
    readings = {kind: {"parent": [], "change": []} for kind in kinds}
    started = time.perf_counter()
    for kind in readings:
        for side in ORDER:
            if kind == "split":
                cmd = [sys.executable, os.path.join(HERE, "call_split.py"),
                       "--tree", trees[side]]
            else:
                cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                       kind, "--tree", trees[side], "--bpaxos-commands",
                       str(commands)] + (["--device", device] if device
                                         else [])
            reading = _run(cmd, timeout=900)
            if kind == "split":
                reading = {"whole_ns": {path: fig["whole_ns"] for path, fig
                                        in reading["paths"].items()},
                           "split_ns": {path: fig["split_ns"] for path, fig
                                        in reading["paths"].items()},
                           "library_ns": reading["library_ns"],
                           "nvidia_smi": reading["nvidia_smi"]}
            readings[kind][side].append(reading)
    medians = {}
    for kind, sides in readings.items():
        for side, runs in sides.items():
            flat = [_flatten(r) for r in runs]
            # A split's smallest entries may differ from run to run.
            keys = [k for k in flat[0] if all(k in f for f in flat)]
            medians.setdefault(kind, {})[side] = {
                key: statistics.median(f[key] for f in flat) for key in keys}
    verdicts = {kind: _verdicts(sides) for kind, sides in readings.items()}
    digests = {side: [{arm: fig["projection_sha256"]
                       for arm, fig in r.items()}
                      for r in readings["storm"][side]]
               for side in trees}
    if any(d != digests["parent"][0] for side in digests
           for d in digests[side]):
        raise RuntimeError(f"the storm's deliveries differ across trees: "
                           f"{digests}")
    return {"benchmark": "tree_ab", "trees": trees, "order": list(ORDER),
            "bpaxos_commands": commands,
            "nvidia_smi": (readings["split"]["change"][0]["nvidia_smi"]
                           if "split" in readings else None),
            "seconds": time.perf_counter() - started,
            "medians": medians, "verdicts": verdicts, "readings": readings}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the other checkout's root")
    parser.add_argument("--bpaxos-commands", type=int,
                        default=BPAXOS_COMMANDS)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda); cpu rehearses "
                             "without the split")
    parser.add_argument("--worker", choices=("storm", "bpaxos"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--tree", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker, args.tree,
                                 args.bpaxos_commands, args.device)),
              flush=True)
        return 0
    if not args.parent:
        parser.error("--parent is required")
    result = json.dumps(run(args.parent, args.bpaxos_commands, args.device))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(result + "\n")
    print(result, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
