"""The cluster sims' host time by role and by function, on one GPU.

Runs each cluster bench's own run function once under ``cProfile`` and splits
the run's host time by where it was spent:

  * ``multipaxos``: ``bench/multipaxos_sim.py``'s ``steady`` arm (f = 1,
    the synchronous ``"cuda"`` tracker, K1) on ``--writes`` writes in
    waves of 4096;
  * ``epaxos``: ``bench/epaxos_sim.py``'s ``drive`` on its conflict25
    workload of ``--commands`` commands, backends ``host`` and ``cuda``;
  * ``bpaxos``: ``bench/bpaxos_sim.py``'s ``drive_simple`` on its
    simple-conflict25 workload of ``--commands`` commands, backends
    ``host`` and ``cuda``.

Each run is made in this process (no worker processes, so the profiler
sees all of it), after the kernels are built and one unprofiled
MultiPaxos run of a wave has warmed the device paths. For each run: the
host seconds under the profiler and the commands it committed; ``roles``, each function's own time (the time
in its body, not in what it calls) summed by the class that defines it
(``Replica``, ``ProxyLeader``, ``SimTransport``, ...; a module-level
function by its module), the largest ``TOP`` and the rest summed;
``wire``, the own time of the message codecs (``pickle`` and the port's
binary codecs: ``runtime/serializer.py``, the ``*wire*.py`` modules,
``native``); and ``functions``, the largest ``TOP`` functions by own
time with their calls. The profiler adds its own cost to every function,
so the shares say where the time goes, not what a run costs.

``--tree ROOT`` imports ``frankenpaxos_tpu_torch`` from ``ROOT`` (another
commit, for a before/after in one call), else from this checkout. Run
from the root of a checkout::

    python frankenpaxos_tpu_torch/bench/sim_profile.py [--tree ROOT] \\
        [--sims multipaxos,epaxos,bpaxos] [--out FILE]

It prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import ast
import cProfile
import json
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SIMS = ("multipaxos", "epaxos", "bpaxos")
#: Roles and functions listed by name; the rest are summed.
TOP = 25
WAVE = 4096


def _qualnames(path: str) -> dict:
    """``{first line of a def: its dotted class path or None}`` for one
    source file (a function of a class reports the class)."""
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError, ValueError):
        return {}
    out: dict = {}

    def visit(node, owner):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name if owner is None
                      else f"{owner}.{child.name}")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                line = (child.decorator_list[0].lineno
                        if child.decorator_list else child.lineno)
                out[child.lineno] = owner
                out[line] = owner
                visit(child, owner)
            else:
                visit(child, owner)

    visit(tree, None)
    return out


def _is_wire(path: str, func: str) -> bool:
    if path == "~":
        return "pickle" in func or "_struct" in func or "Struct" in func
    name = os.path.basename(path)
    return (name == "serializer.py" or "wire" in name
            or os.sep + "native" + os.sep in path)


def split(profile: cProfile.Profile, package_root: str) -> dict:
    """A profile's own time by role, the codecs' share, and the top
    functions."""
    stats = pstats.Stats(profile).stats
    cache: dict = {}
    roles: dict = {}
    funcs = []
    wire = 0.0
    total = 0.0
    for (path, line, func), (_cc, calls, own, _cum, _callers) in \
            stats.items():
        total += own
        if path == "~":
            role = f"builtin {func}"
        else:
            if path not in cache:
                cache[path] = _qualnames(path)
            owner = cache[path].get(line)
            rel = (os.path.relpath(path, package_root)
                   if path.startswith(package_root) else
                   os.path.join(*path.split(os.sep)[-2:]))
            role = owner or rel
        roles[role] = roles.get(role, 0.0) + own
        if _is_wire(path, func):
            wire += own
        where = (func if path == "~" else
                 f"{os.path.basename(path)}:{line}:{func}")
        funcs.append((own, calls, where))
    ranked = sorted(roles.items(), key=lambda kv: -kv[1])
    top_roles = dict(ranked[:TOP])
    top_roles["(rest)"] = sum(s for _, s in ranked[TOP:])
    funcs.sort(reverse=True)
    return {
        "profiled_s": total,
        "wire_s": wire,
        "wire_share": wire / total if total else 0.0,
        "roles": {k: {"own_s": v, "share": v / total if total else 0.0}
                  for k, v in top_roles.items()},
        "functions": [{"where": w, "own_s": o, "calls": c}
                      for o, c, w in funcs[:TOP]],
    }


def _profiled(fn, package_root: str):
    profile = cProfile.Profile()
    t0 = time.perf_counter()
    profile.enable()
    try:
        result = fn()
    finally:
        profile.disable()
    seconds = time.perf_counter() - t0
    return result, {"seconds": seconds, **split(profile, package_root)}


def run(device=None, sims=SIMS, writes: int = 1 << 13,
        commands: int = 1 << 12, seed: int = 0) -> dict:
    import torch

    import frankenpaxos_tpu_torch
    from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device

    package_root = os.path.dirname(os.path.abspath(
        frankenpaxos_tpu_torch.__file__))
    dev = resolve_device(device)
    if dev.type == "cuda":
        # Build every kernel before the first profiled run, so that no
        # run's figures hold the compiler's time.
        from frankenpaxos_tpu_torch.ops import _build

        _build.build()
    out: dict = {"tree": os.path.dirname(package_root),
                 "device": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else str(dev)),
                 "nvidia_smi": (nvidia_smi_line() if dev.type == "cuda"
                                else None),
                 "writes": writes, "commands": commands, "runs": {}}
    if "multipaxos" in sims:
        from frankenpaxos_tpu_torch.bench import multipaxos_sim

        wave = min(WAVE, writes)
        # One unprofiled warm run: the first cluster of a process pays
        # the stagings, the pinned blocks and the kernels' first loads.
        multipaxos_sim.steady(dev, wave, wave)
        _, prof = _profiled(
            lambda: multipaxos_sim.steady(dev, writes, wave), package_root)
        out["runs"]["multipaxos/steady/cuda"] = {"commands": writes,
                                                 **prof}
    for name, module, drive, conflict in (
            ("epaxos", "epaxos_sim", "drive", 0.25),
            ("bpaxos", "bpaxos_sim", "drive_simple", 0.25)):
        if name not in sims:
            continue
        import importlib

        sim = importlib.import_module(
            f"frankenpaxos_tpu_torch.bench.{module}")
        work = sim.workload(conflict, commands, seed)
        for backend, bdev in (("host", torch.device("cpu")), ("cuda", dev)):
            result, prof = _profiled(
                lambda: getattr(sim, drive)(bdev, backend, work, seed),
                package_root)
            out["runs"][f"{name}/conflict25/{backend}"] = {
                "commands": len(result["replies"]), **prof}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="import frankenpaxos_tpu_torch from this root")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--sims", default=",".join(SIMS))
    parser.add_argument("--writes", type=int, default=1 << 13)
    parser.add_argument("--commands", type=int, default=1 << 12)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree or ROOT))
    result = json.dumps(run(args.device, args.sims.split(","),
                            args.writes, args.commands))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(result + "\n")
    print(result, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
