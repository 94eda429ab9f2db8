"""paxmesh A/B twin: the sharded drain against one GPU, same window.

Counterpart of ``frankenpaxos_tpu/bench/multichip_lt.py``. One world of
8 spawned ranks (``bench/multichip.py``) serves every part:

  * **arms**: the 1-GPU drain (K3 on rank 0) and the sharded drain
    (K19-K21 on a ``(1, slot)`` mesh) over the SAME global window --
    2^20 and 2^23 slots at the 2^15-slot block, majority of 3 -- both
    persistent, driven alternately in equal chunks with the order
    flipped every chunk and GC off in the timed region, warmup chunks
    discarded, per-arm times summed, median over independent blocks;
    ``committed`` and ``sm_state`` must agree between the arms after
    equal drains;
  * **per-shard drain latency**: p50/p99 per rank of host-timed runs of
    8 drains, each ending in that rank's synchronise, less the null
    round trip;
  * **oracle gates**: the sharded drain at ``(1, 1)``, ``(2, 4)``,
    ``(8, 1)`` (block 128, window 512) and ``(2, 3)`` (block 100, window
    400: the non-divisible split), n = 8, 7 drains, every leaf equal to
    the unsharded drain's through ``gathered_layout``;
  * **ingest gate**: ``place_block`` lands each shard's lanes on its own
    rank, and the segments round-trip to the block.

Where ranks share a card (8 ranks on fewer than 8 cards: gloo, every
all-reduce through the host) or run on the CPU, the artifact says
``"shared_card": true`` (``"host_mesh": true`` on the CPU) and stamps NO
speedup: ``speedup`` is null with the reason, as the reference's
``host_mesh`` artifact says its ratio is no hardware claim. The arms
then use 4 of the 8 ranks. A mesh probe that fails writes
``"degraded": true`` and exits nonzero.

Usage::

    python -m frankenpaxos_tpu_torch.bench.multichip_lt [--smoke]
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from frankenpaxos_tpu_torch.bench import multichip
from frankenpaxos_tpu_torch.bench import pipeline as tp
from frankenpaxos_tpu_torch.bench.pipeline import (
    gathered_layout,
    local_block,
    padded_window,
)
from frankenpaxos_tpu_torch.convert import pipeline_state_to_numpy
from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ingest.shard import place_block
from frankenpaxos_tpu_torch.mesh import make_mesh, mesh_probe
from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.quorums import SimpleMajority

#: Headline arms: the 1M-slot window and the scale-out 8M one, at the
#: 32K-slot drain with the f = 1 majority (the reference's).
NUM_ACCEPTORS = 3
BLOCK = 1 << 15
ARMS_FULL = (("window_1m", 1 << 20), ("window_8m", 1 << 23))
ARMS_SMOKE = (("window_16k", 1 << 14),)
SMOKE_BLOCK = 1 << 10
FULL_CHUNKS = dict(warmup=2, chunks=8, iters=64, blocks=3)
SMOKE_CHUNKS = dict(warmup=1, chunks=4, iters=8, blocks=2)
LAT_ITERS = 8
LAT_SAMPLES_FULL = 48
LAT_SAMPLES_SMOKE = 12
#: The oracle gates: (group, slot, block, window), n = 8 acceptors.
GATES = ((1, 1, 128, 512), (2, 4, 128, 512), (8, 1, 128, 512),
         (2, 3, 100, 400))
GATE_ACCEPTORS = 8
GATE_DRAINS = 7
RANKS = 8


def _spec(n: int):
    return SimpleMajority(range(n)).write_spec().as_arrays()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- cases the ranks run (``RankWorld.call(_here(name))``) ----------------


def case_lt_setup(ctx, *, slot: int, window: int, block: int,
                  iters: int) -> Optional[dict]:
    """Fresh persistent arms: the unsharded state on rank 0, the
    ``(1, slot)`` mesh's shards on its ranks, one warm chunk each; rank 0
    returns both arms' committed counts."""
    masks, thresholds, combine_any = _spec(NUM_ACCEPTORS)
    mesh = make_mesh(1, slot, ctx.device)
    ctx.store["lt"] = lt = {"mesh": mesh, "iters": iters}
    if mesh is None:
        return None
    probe = mesh_probe(mesh)
    if not probe.collective_ok:
        return {"probe": probe._asdict()}
    lt["state"], _ = tp.make_sharded_state(mesh, window, block,
                                           NUM_ACCEPTORS)
    lt["runner"] = tp.make_sharded_runner(
        mesh, block_size=block, masks=masks, thresholds=thresholds,
        combine_any=combine_any, iters=iters)
    lt["runner"](lt["state"], 0)
    out = {"probe": probe._asdict()}
    if mesh.rank == 0:
        lt["one"] = tp.make_state(window, NUM_ACCEPTORS, device=ctx.device)
        lt["spec"] = (masks, thresholds, combine_any)
        tp.run_steps_from(lt["one"], 0, iters, block, *lt["spec"])
        lt["block"] = block
        out["committed"] = (int(lt["one"].committed),
                            int(lt["state"].committed))
    return out


def case_lt_chunk(ctx, *, arm: str, start: int) -> Optional[float]:
    """One chunk of ``arm`` (``one``: rank 0's unsharded drain; ``mesh``:
    every shard) from drain ``start``, host-timed to the synchronise
    (on rank 0; the mesh chunk between two barriers), GC off."""
    lt = ctx.store["lt"]
    mesh = lt["mesh"]
    if mesh is None or (arm == "one" and mesh.rank != 0):
        return None
    gc.collect()
    gc.disable()
    try:
        if arm == "mesh":
            dist.barrier(group=mesh.mesh_pg)
        t0 = time.perf_counter()
        if arm == "one":
            tp.run_steps_from(lt["one"], start, lt["iters"], lt["block"],
                              *lt["spec"])
        else:
            lt["runner"](lt["state"], start)
        _sync(ctx.device)
        if arm == "mesh":
            dist.barrier(group=mesh.mesh_pg)
        return time.perf_counter() - t0
    finally:
        gc.enable()


def case_lt_latency(ctx, *, start: int, samples: int) -> Optional[dict]:
    """Per-rank drain latency: ``samples`` host-timed runs of LAT_ITERS
    drains, each ending in this rank's synchronise (an upper bound: the
    all-reduces tie the shards together), and the null round trip."""
    lt = ctx.store["lt"]
    mesh = lt["mesh"]
    if mesh is None:
        return None

    masks, thresholds, combine_any = _spec(NUM_ACCEPTORS)
    runner = tp.make_sharded_runner(
        mesh, block_size=lt["runner"].plan.block_size, masks=masks,
        thresholds=thresholds, combine_any=combine_any, iters=LAT_ITERS)
    x = torch.zeros((), dtype=torch.int32, device=ctx.device)
    null = []
    for _ in range(20):
        t0 = time.perf_counter()
        x += 1
        _ = int(x)
        null.append(time.perf_counter() - t0)
    times = []
    for k in range(samples):
        t0 = time.perf_counter()
        runner(lt["state"], start + k * LAT_ITERS)
        _sync(ctx.device)
        times.append(time.perf_counter() - t0)
    null_us = float(np.percentile(null, 50) * 1e6)
    us = np.maximum(np.asarray(times) * 1e6 - null_us, 0.0) / LAT_ITERS
    return {"rank": mesh.rank, "device": str(ctx.device),
            "p50_us": float(np.percentile(us, 50)),
            "p99_us": float(np.percentile(us, 99)),
            "null_rtt_p50_us": null_us}


def case_lt_finish(ctx) -> Optional[dict]:
    """Both arms' registers (rank 0), then the arms are dropped."""
    lt = ctx.store.pop("lt")
    mesh = lt["mesh"]
    if mesh is None:
        return None
    out = None
    if mesh.rank == 0 and "one" in lt:
        one, msh = lt["one"], lt["state"]
        out = {"committed": (int(one.committed), int(msh.committed)),
               "sm_state": (int(one.sm_state), int(msh.sm_state))}

    dist.barrier(group=mesh.mesh_pg)
    mesh.close()
    return out


def case_oracle_gate(ctx, *, group: int, slot: int, block: int,
                     window: int) -> Optional[dict]:
    """GATE_DRAINS drains sharded at ``(group, slot)`` against the
    unsharded drain (K3 on the card), every leaf through
    ``gathered_layout``."""
    masks, thresholds, combine_any = _spec(GATE_ACCEPTORS)
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        state, w_padded = tp.make_sharded_state(mesh, window, block,
                                                GATE_ACCEPTORS)
        step = tp.make_sharded_step(mesh, block_size=block, masks=masks,
                                    thresholds=thresholds,
                                    combine_any=combine_any)
        for i in range(GATE_DRAINS):
            step(state, i)
        gathered = tp.gather_state(mesh, state)
        if mesh.rank:
            return None
        host = tp.make_state(window, GATE_ACCEPTORS, device=ctx.device)
        tp.run_steps(host, GATE_DRAINS, block, masks, thresholds,
                     combine_any)
        bad = multichip.unsharded_mismatches(
            gathered, pipeline_state_to_numpy(host), slot, window, block)
        return {"mesh": f"{group}x{slot}", "block": block,
                "window": window, "padded_window": w_padded,
                "non_divisible": block % slot != 0,
                "drains": GATE_DRAINS, "bit_identical": not bad,
                "mismatch": bad}


def case_ingest_gate(ctx, *, slot: int, block: int) -> Optional[dict]:
    """The lane router on the ``(1, slot)`` mesh: each rank lands its
    segment with one copy; rank 0 gathers and checks the round trip."""
    ids = (np.arange(block, dtype=np.int32) * 7 + 1)
    with ctx.mesh(1, slot) as mesh:
        if mesh is None:
            return None
        placed = place_block(mesh, ids, block)
        rows = [None] * mesh.size
        dist.all_gather_object(rows, (str(placed.device),
                                      placed.cpu().numpy()),
                               group=mesh.mesh_pg)
        if mesh.rank:
            return None
        b_local, _ = local_block(block, slot)
        logical, valid = gathered_layout(slot, b_local, b_local, block)
        flat = np.concatenate([row for _, row in rows])
        out = np.zeros(block, np.int32)
        out[logical[valid]] = flat[valid]
        return {"round_trip_ok": bool(np.array_equal(out, ids))
                and not flat[~valid].any(),
                "copies_per_drain": len(rows),
                "devices": sorted({device for device, _ in rows}),
                "block": block,
                "note": "one host-to-device copy per rank "
                        "(ingest.shard.place_block); lanes land on their "
                        "owning slot shard"}


def _here(case: str) -> str:
    """The world's name for a case of this module (by its import path:
    under ``python -m`` this module's ``__name__`` is ``__main__``)."""
    return f"frankenpaxos_tpu_torch.bench.multichip_lt:case_{case}"


# --- the parent --------------------------------------------------------------


def measure_ab_block(world, slot: int, window: int, block: int, *,
                     warmup: int, chunks: int, iters: int) -> dict:
    """One chunk-interleaved A/B block over fresh persistent arms."""
    setup = world.call(_here("lt_setup"), deadline_s=600, slot=slot,
                       window=window, block=block, iters=iters)[0]
    if not setup["probe"]["collective_ok"]:
        world.call(_here("lt_finish"))
        return {"probe": setup["probe"]}
    if setup["committed"][0] != setup["committed"][1]:
        raise RuntimeError(f"the arms disagree after the warm chunk: "
                           f"{setup['committed']}")
    total = {"one": 0.0, "mesh": 0.0}
    at = iters
    for k in range(warmup + chunks):
        for arm in (("one", "mesh") if k % 2 else ("mesh", "one")):
            seconds = world.call(_here("lt_chunk"), deadline_s=600, arm=arm,
                                 start=at)[0]
            if k >= warmup:
                total[arm] += seconds
        at += iters
    regs = world.call(_here("lt_finish"))[0]
    cmds = chunks * iters * block
    return {
        "probe": setup["probe"],
        "one_s": total["one"], "mesh_s": total["mesh"],
        "onechip_cmds_per_sec": cmds / total["one"],
        "mesh_cmds_per_sec": cmds / total["mesh"],
        "time_ratio": total["one"] / total["mesh"],
        "arms_agree": (regs["committed"][0] == regs["committed"][1]
                       and regs["sm_state"][0] == regs["sm_state"][1]),
        "committed": regs["committed"][1],
    }


def measure_arm(world, slot: int, window: int, block: int, knobs: dict,
                shared: bool) -> dict:
    """The median-of-blocks A/B for one window arm."""
    rows = [measure_ab_block(world, slot, window, block,
                             warmup=knobs["warmup"], chunks=knobs["chunks"],
                             iters=knobs["iters"])
            for _ in range(knobs["blocks"])]
    if any("one_s" not in r for r in rows):
        return {"probe": rows[0]["probe"]}
    ratios = sorted(r["time_ratio"] for r in rows)
    mid = rows[[r["time_ratio"] for r in rows].index(
        ratios[len(ratios) // 2])]
    return {
        "window_slots": window, "block_slots": block,
        "padded_window_slots": padded_window(window, block, slot),
        "mesh": f"1x{slot}", "chunks": knobs["chunks"],
        "iters_per_chunk": knobs["iters"], "blocks": knobs["blocks"],
        "onechip_cmds_per_sec": mid["onechip_cmds_per_sec"],
        "mesh_cmds_per_sec": mid["mesh_cmds_per_sec"],
        "speedup": None if shared else mid["time_ratio"],
        "speedup_range": None if shared else ratios,
        "speedup_note": ("not stamped: the mesh's ranks share one device "
                         "and every all-reduce goes through the host, so "
                         "the ratio is no claim about several cards"
                         if shared else ""),
        "arms_agree": all(r["arms_agree"] for r in rows),
        "committed_per_block": mid["committed"],
    }


def run(device=None, *, smoke: bool = False) -> dict:
    """The artifact, on ``device`` (``cuda`` when None: raises without a
    GPU; ``cpu`` runs the plain versions over gloo, a host mesh)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        _build.build()  # once, before the ranks start
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    shared = cards < RANKS
    arm_slots = 4 if shared else RANKS
    block = SMOKE_BLOCK if smoke else BLOCK
    knobs = SMOKE_CHUNKS if smoke else FULL_CHUNKS
    arms = ARMS_SMOKE if smoke else ARMS_FULL
    with multichip.RankWorld(RANKS, device_type=dev.type) as world:
        arm_rows = {}
        for name, window in arms:
            arm_rows[name] = measure_arm(world, arm_slots, window, block,
                                         knobs, shared)
            if "probe" in arm_rows[name]:
                return {"kind": "multichip_lt", "degraded": True,
                        "probe": arm_rows[name]["probe"],
                        "probe_note": arm_rows[name]["probe"]["note"]}
            print(f"# {name}: mesh {arm_rows[name]['mesh_cmds_per_sec']:.4g}"
                  f" cmds/s, 1-device "
                  f"{arm_rows[name]['onechip_cmds_per_sec']:.4g}",
                  file=sys.stderr, flush=True)
        world.call(_here("lt_setup"), deadline_s=600, slot=arm_slots,
                   window=arms[0][1], block=block, iters=LAT_ITERS)
        lat = [r for r in world.call(
            _here("lt_latency"), deadline_s=600, start=LAT_ITERS,
            samples=LAT_SAMPLES_SMOKE if smoke else LAT_SAMPLES_FULL)
            if r is not None]
        world.call(_here("lt_finish"))
        gates = [world.call(_here("oracle_gate"), deadline_s=300, group=g,
                            slot=s, block=b, window=w)[0]
                 for g, s, b, w in GATES]
        ing = world.call(_here("ingest_gate"), deadline_s=300, slot=arm_slots,
                         block=block)[0]
        backend = world.backend
    gates_pass = (all(g["bit_identical"] for g in gates)
                  and any(g["non_divisible"] for g in gates)
                  and ing["round_trip_ok"]
                  and all(r["arms_agree"] for r in arm_rows.values()))
    return {
        "kind": "multichip_lt",
        "mode": "smoke" if smoke else "full",
        "degraded": False,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "cards": cards, "ranks": RANKS, "backend": backend,
        "shared_card": shared and dev.type == "cuda",
        "host_mesh": dev.type == "cpu",
        "mesh_shape": {"group": 1, "slot": arm_slots},
        "num_acceptors": NUM_ACCEPTORS,
        "arms": arm_rows,
        "per_shard_latency": {
            "per_rank": lat,
            "worst_p50_us": max(r["p50_us"] for r in lat),
            "drains_per_sample": LAT_ITERS,
            "method": ("host-timed runs of drains_per_sample drains per "
                       "rank, each ending in the rank's synchronise; "
                       "per-drain = (t - null_rtt_p50) / "
                       "drains_per_sample (an upper bound: the "
                       "all-reduces tie the shards together)")},
        "oracle_gates": gates,
        "ingest_gate": ing,
        "gates_pass": gates_pass,
        "methodology": (
            "alternating-chunk paired A/B: both arms persistent over the "
            "SAME global window, driven in equal iters_per_chunk-drain "
            "chunks with the order flipped each chunk, GC disabled in the "
            "timed region, warmup chunks discarded; the median block by "
            "the 1-device / mesh time ratio"),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device type (default cuda)")
    parser.add_argument("--out", default=None,
                        help="also write the artifact here")
    parser.add_argument("--smoke", action="store_true",
                        help="the reference's reduced shape, same gates")
    args = parser.parse_args(argv)
    artifact = run(args.device, smoke=args.smoke)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
            f.write("\n")
    print(json.dumps(artifact), flush=True)
    if artifact["degraded"]:
        return 1
    return 0 if artifact["gates_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
