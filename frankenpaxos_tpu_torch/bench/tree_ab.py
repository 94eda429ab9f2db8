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
  * ``multipaxos``: ``bench/multipaxos_sim.py``'s steady arm (the
    synchronous tracker, K1) and pipelined arm (K2, K4) at
    ``--bpaxos-commands`` writes each in waves of 4096, committed
    writes/s; every gate of the bench holds in every run;
  * ``bpaxos``: ``bench/bpaxos_sim.py`` (simple-conflict2/25 and gc) on
    the host and the cuda backends, commands/s, at ``--bpaxos-commands``
    per arm; every gate of both benches holds in every run;
  * ``epaxos``: ``bench/epaxos_sim.py`` (conflict2 and conflict25) on
    the host and the cuda backends, commands/s, at the same
    ``--bpaxos-commands`` per arm (2^13, cut from the bench's 2^14 to
    hold ten runs a tree); every gate of the bench holds in every run;
  * ``headline``: ``bench/headline.py``'s measurement (majority-3 and
    2x3 grid cmds/s at 1M in-flight slots, the mean drain, p50 / p99 of
    the per-drain distribution with a cut time budget); its commit-count
    checks hold in every run;
  * ``telemetry``: ``bench/telemetry_overhead.py``'s ``measure_width``
    at the headline width 2^20/2^15 with the reference's ``--smoke``
    knobs: the off/baseline and on/off ratios and each arm's cmds/s
    (the arms must agree);
  * ``tracker``: ``bench/tracker_lt.py``'s sync arm (K1), pipelined and
    grid arms (K2, K4, K5) and epoch arm (K6) at full width (window
    2^20, 2^20 slots, the grid's 2^18; the epoch window 2^14), votes/s
    with each arm's pairs equal to its dict oracle's, and the
    crossover's ``measured_min_device_slots`` (lower is better);
  * ``geo``: ``bench/geo_lt.py`` at the reference's deployment, the host
    seconds of its cuda run and of its dict run (every gate of the bench
    holds, and the cuda run equals the dict run);
  * ``mesh``: ``bench/multichip_lt.py`` on four ranks that share the card
    (gloo): its (1, 4) arm at the full width (window 2^20, block 2^15)
    with the bench's smoke knobs (mesh and 1-device cmds/s; the arms'
    registers must agree), then its per-rank drain latency (p50 / p99 a
    drain of host-timed runs of its ``LAT_ITERS`` drains, rank 0's and
    the worst rank's);
  * ``libbench``: ``bench/libbench.py``'s ``bench_device_ops`` (K12, K13,
    and K16's union then K10, each 50 calls chained with one synchronize,
    best of three): its three slots/s and deps/s rates.

``--kinds`` picks some of them
(``split,storm,multipaxos,bpaxos,epaxos,headline,telemetry,tracker,geo,mesh,libbench``
on a card, all by default).

Unpack the parent into a directory the checkout ignores, then run from
the root of this checkout::

    git archive <parent> | tar -x -C _chipcheck/parent
    python frankenpaxos_tpu_torch/bench/tree_ab.py --parent _chipcheck/parent

(``--device cpu --bpaxos-commands 256`` rehearses it on the CPU, without
the split, the headline, the mesh and libbench, the telemetry arm at 2^12/2^8 with
tiny knobs; ``--worker mesh --tree . --device cpu`` runs one mesh reading
on CPU ranks at the bench's smoke width.) It prints ONE JSON line (the medians per tree, a verdict
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
#: Every measurement, in the order they run; ``split``, ``headline``,
#: ``mesh`` and ``libbench`` time CUDA calls only.
KINDS = ("split", "storm", "multipaxos", "bpaxos", "epaxos", "headline",
         "telemetry", "tracker", "geo", "mesh", "libbench")
CUDA_ONLY = ("split", "headline", "mesh", "libbench")
#: The headline arm's latency-distribution budget (the bench's 20 s,
#: cut: ten runs a tree).
HEADLINE_LATENCY_S = 5.0


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
    if kind == "multipaxos":
        from frankenpaxos_tpu_torch.bench import multipaxos_sim
        from frankenpaxos_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        wave = min(4096, commands)
        return {"steady": multipaxos_sim.steady(
                    dev, commands, wave)["writes_per_sec"],
                "pipelined": multipaxos_sim.pipelined(
                    dev, commands, wave)["writes_per_sec"]}
    if kind == "bpaxos":
        from frankenpaxos_tpu_torch.bench import bpaxos_sim

        out = bpaxos_sim.run(device, commands=commands)
        return {arm: {b: fig[b]["commands_per_sec"]
                      for b in ("host", "cuda")}
                for arm, fig in out["arms"].items()}
    if kind == "epaxos":
        from frankenpaxos_tpu_torch.bench import epaxos_sim

        out = epaxos_sim.run(device, commands=commands)
        return {arm: {b: fig[b]["commands_per_sec"]
                      for b in ("host", "cuda")}
                for arm, fig in out["arms"].items()}
    if kind == "headline":
        from frankenpaxos_tpu_torch.bench import headline

        out = headline.measure(device,
                               latency_budget_s=HEADLINE_LATENCY_S)
        return {"majority3_cmds_per_s": out["value"],
                "grid_cmds_per_s": out["grid_cmds_per_sec"],
                "majority3_mean_drain_us":
                    out["mean_quorum_batch_latency_us"],
                "grid_mean_drain_us": out["grid_mean_batch_latency_us"],
                "p50_drain_us": out["p50_drain_latency_us"],
                "p99_drain_us": out["p99_drain_latency_us"],
                "nvidia_smi": out["nvidia_smi"]}
    if kind == "telemetry":
        from frankenpaxos_tpu_torch.bench import telemetry_overhead as tover

        if device == "cpu":
            width, knobs = (1 << 12, 1 << 8), {"warmup": 0, "chunks": 1,
                                               "iters": 4, "blocks": 1}
        else:
            width, knobs = (1 << 20, 1 << 15), tover.SMOKE_KNOBS
        row = tover.measure_width(*width, knobs, device)
        if not row["arms_agree"]:
            raise RuntimeError(f"the overhead arms disagree: {row}")
        return {key: row[key] for key in (
            "off_over_baseline_ratio", "on_over_off_ratio",
            "baseline_cmds_per_sec_med", "off_cmds_per_sec_med",
            "on_cmds_per_sec_med")}
    if kind == "tracker":
        return _tracker_arms(device)
    if kind == "geo":
        from frankenpaxos_tpu_torch.bench import geo_lt

        out = geo_lt.run(device)
        return {f"{b}_seconds": out["backends"][b]["seconds"]
                for b in ("cuda", "dict")}
    if kind == "mesh":
        return _mesh_arms(device)
    if kind == "libbench":
        from frankenpaxos_tpu_torch.bench import libbench
        from frankenpaxos_tpu_torch.device import nvidia_smi_line

        return {**libbench.bench_device_ops(device=device),
                "nvidia_smi": nvidia_smi_line()}
    raise ValueError(f"unknown measurement {kind!r}")


def _tracker_arms(device) -> dict:
    """``bench/tracker_lt.py``'s sync and epoch arms and its crossover,
    through the functions every tree's copy of it has (at a small size
    on the CPU); raises when an arm disagrees with its dict oracle."""
    from frankenpaxos_tpu_torch.bench import tracker_lt as lt
    from frankenpaxos_tpu_torch.device import nvidia_smi_line, \
        resolve_device
    from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
        DictQuorumTracker,
        TpuQuorumTracker,
    )
    from frankenpaxos_tpu_torch.reconfig import (
        EpochQuorumTracker,
        EpochStore,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":
        slots, window, drain, handover = (lt.SLOTS, lt.WINDOW, lt.DRAIN,
                                          lt.HANDOVER)
        grid_slots, widths = lt.GRID_SLOTS, lt.CROSSOVER_WIDTHS
    else:
        slots, window, drain, handover = 1 << 13, 1 << 12, 1024, 1 << 12
        grid_slots, widths = 1 << 12, (1, 64)
    config = lt.make_config()
    stream = lt.make_stream(slots, 3, drain)
    votes = lt.count_votes(stream)
    oracle = lt.replay(DictQuorumTracker(config), stream, 3)
    sync = TpuQuorumTracker(config, window=window, device=dev)
    got, sync_s = lt._timed(dev, lambda: lt.replay(sync, stream, 3))
    lt.check_against_oracle("sync", got, oracle)
    piped = TpuQuorumTracker(config, window=window, pipelined=True,
                             device=dev)
    got, piped_s = lt._timed(dev, lambda: lt.replay_pipelined(piped, stream,
                                                              3))
    lt.check_against_oracle("pipelined", got, oracle)
    grid_config = lt.make_config(flexible=True)
    grid_stream = lt.make_stream(grid_slots, 6, drain, lt.SEED + 1)
    grid_oracle = lt.replay(DictQuorumTracker(grid_config), grid_stream, 3)
    grid = TpuQuorumTracker(grid_config, window=window, pipelined=True,
                            device=dev)
    got, grid_s = lt._timed(dev, lambda: lt.replay_pipelined(
        grid, grid_stream, 3))
    lt.check_against_oracle("grid", got, grid_oracle)
    members = (("a0", "a1", "a2"), ("a0", "a1", "a3"))
    reported = {}
    for backend in ("dict", "cuda"):
        store = EpochStore.from_members(members[0], f=1)
        tracker = EpochQuorumTracker(store, backend=backend,
                                     window=min(window, 1 << 14),
                                     device=dev)
        reported[backend] = lt._timed(dev, lambda: lt.replay_epochs(
            tracker, store, stream, drain, handover, members))
    lt.check_against_oracle("epoch", reported["cuda"][0],
                            reported["dict"][0])
    _, threshold = lt.crossover(dev, widths)
    return {"sync_votes_per_s": votes / sync_s,
            "pipelined_votes_per_s": votes / piped_s,
            "grid_votes_per_s": lt.count_votes(grid_stream) / grid_s,
            "epoch_votes_per_s": votes / reported["cuda"][1],
            "measured_min_device_slots": threshold,
            "nvidia_smi": nvidia_smi_line() if dev.type == "cuda"
            else None}


def _mesh_arms(device) -> dict:
    """``bench/multichip_lt.py``'s (1, 4) arm and per-rank latency on a
    world of four ranks sharing the card, through the functions every
    tree's copy of it has (its smoke width on the CPU); raises when the
    arms' registers disagree."""
    from frankenpaxos_tpu_torch.bench import multichip, multichip_lt as mlt
    from frankenpaxos_tpu_torch.device import nvidia_smi_line, \
        resolve_device
    from frankenpaxos_tpu_torch.ops import _build

    dev = resolve_device(device)
    if dev.type == "cuda":
        _build.build()  # once, before the ranks start
        window, block = mlt.ARMS_FULL[0][1], mlt.BLOCK
    else:
        window, block = mlt.ARMS_SMOKE[0][1], mlt.SMOKE_BLOCK
    with multichip.RankWorld(4, device_type=dev.type) as world:
        arm = mlt.measure_arm(world, 4, window, block, mlt.SMOKE_CHUNKS,
                              True)
        world.call(mlt._here("lt_setup"), deadline_s=600, slot=4,
                   window=window, block=block, iters=mlt.LAT_ITERS)
        lat = [r for r in world.call(
            mlt._here("lt_latency"), deadline_s=600, start=mlt.LAT_ITERS,
            samples=mlt.LAT_SAMPLES_FULL) if r is not None]
        world.call(mlt._here("lt_finish"))
    if not arm.get("arms_agree"):
        raise RuntimeError(f"the multichip_lt arms disagree: {arm}")
    return {"mesh_cmds_per_s": arm["mesh_cmds_per_sec"],
            "onechip_cmds_per_s": arm["onechip_cmds_per_sec"],
            "rank0_p50_drain_us": lat[0]["p50_us"],
            "rank0_p99_drain_us": lat[0]["p99_us"],
            "worst_p50_drain_us": max(r["p50_us"] for r in lat),
            "worst_p99_drain_us": max(r["p99_us"] for r in lat),
            "nvidia_smi": nvidia_smi_line() if dev.type == "cuda"
            else None}


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
    """Per metric (host ns, drain µs, host seconds and the crossover's
    slots, lower is better; events/s, commands/s, votes/s and the
    overhead ratios, higher), over the runs in pairs
    (the i-th parent run beside the i-th change run): both medians, the
    parent's interquartile spread, the pairs the change won, and the
    verdict. A ``gain`` (or ``loss``) needs the change (or the parent)
    to win at least nine pairs in ten and the medians to differ by more
    than the parent's spread; anything else is ``unresolved``. The
    split's per-function shares are left out."""
    flat = {side: [_flatten(r) for r in runs] for side, runs in sides.items()}
    out = {}
    for key in flat["parent"][0]:
        if key.startswith("split_ns") or not all(
                key in f for side in flat for f in flat[side]):
            continue
        lower = "_ns" in key or key.endswith(("_us", "_seconds",
                                              "_slots"))
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


def run(parent: str, commands: int = BPAXOS_COMMANDS, device=None,
        kinds=KINDS) -> dict:
    """The measurements of ``kinds`` in turns, ``parent`` against this
    checkout; on the CPU (``device="cpu"``, a rehearsal) without the
    split and the headline, which time CUDA calls."""
    trees = {"parent": os.path.abspath(parent), "change": ROOT}
    unknown = set(kinds) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown measurements {sorted(unknown)}")
    kinds = [kind for kind in KINDS if kind in kinds
             and not (device == "cpu" and kind in CUDA_ONLY)]
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
    if "storm" in readings:
        digests = {side: [{arm: fig["projection_sha256"]
                           for arm, fig in r.items()}
                          for r in readings["storm"][side]]
                   for side in trees}
        if any(d != digests["parent"][0] for side in digests
               for d in digests[side]):
            raise RuntimeError(f"the storm's deliveries differ across "
                               f"trees: {digests}")
    smi = next((readings[kind]["change"][0]["nvidia_smi"]
                for kind in ("split", "headline", "tracker", "mesh",
                             "libbench")
                if kind in readings), None)
    return {"benchmark": "tree_ab", "trees": trees, "order": list(ORDER),
            "kinds": kinds, "bpaxos_commands": commands,
            "nvidia_smi": smi,
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
    parser.add_argument("--kinds", default=",".join(KINDS),
                        help="the measurements, comma-separated, of "
                             + ",".join(KINDS))
    parser.add_argument("--worker", choices=KINDS[1:],
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
    result = json.dumps(run(args.parent, args.bpaxos_commands, args.device,
                            kinds=args.kinds.split(",")))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(result + "\n")
    print(result, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
