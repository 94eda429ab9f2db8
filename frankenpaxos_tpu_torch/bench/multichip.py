"""The sharded drain's rank worker, the spawned world that serves it, and
the twin of ``__graft_entry__.dryrun_multichip``.

A :class:`RankWorld` spawns ``ranks`` worker processes (the ``spawn``
start method: a forked child must not inherit an initialised CUDA
context), joins them into one ``torch.distributed`` world through a
``FileStore`` under a fresh temporary directory (no fixed port, so
worlds started at once never collide), and serves named cases over
queues: every rank runs the case, and ``call`` returns each rank's
result or raises with the failing ranks' tracebacks. Every wait has a
deadline; a world that misses one is torn down. The workers import this
module and the port, nothing else: the cases live here.

Cases (each rank builds the case's mesh over the first ranks of the
world, every rank taking part in the subgroups' creation):

  * ``drain`` -- a sharded run (``make_sharded_step`` or
    ``make_sharded_runner``), optionally from a gathered state, returning
    the gathered state on rank 0;
  * ``place_block`` -- the ingest lane router's one copy per shard;
  * ``telemetry_updates`` -- the telemetry updates over the slot axis;
  * ``dryrun`` -- the body of :func:`dryrun`;
  * ``check_drain`` -- on the card: K19-K21 held against their plain
    versions, the gathered state against the unsharded drain (K3 or
    K14), and the per-phase time split (``chip_smoke.py``);
  * ``modules`` -- which top-level modules a worker has loaded;
  * the sharded vote board's cases (``bench/multichip_board.py``, merged
    into :data:`CASES`).

:func:`dryrun` is the twin of the reference's ``dryrun_multichip`` on
its forced host mesh: one drain sharded over an ``n``-rank mesh
(majority and grid specs), then the ProxyLeader's pipelined
``TpuQuorumTracker`` with its vote board sharded over the same mesh,
which must choose three ring wraps of slots, each drain equal to the
dict oracle.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import multiprocessing
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import multichip_board
from frankenpaxos_tpu_torch.bench import pipeline as tp
from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ingest.shard import place_block
from frankenpaxos_tpu_torch.mesh import init_world, make_mesh, mesh_probe
from frankenpaxos_tpu_torch.obs.telemetry import collect
from frankenpaxos_tpu_torch.ops import _build, telemetry as ttel
from frankenpaxos_tpu_torch.ops.quorum import make_predicate
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority


#: Seconds the spawned ranks may take to join the world.
START_DEADLINE_S = 180.0


class WorldFailure(RuntimeError):
    """A case failed on some rank, or the world missed a deadline."""


class RankWorld:
    """``ranks`` spawned worker processes joined into one world on
    ``device_type`` (``cpu``: gloo; ``cuda``: rank ``r`` on card
    ``r % cards``, nccl when each rank has a card of its own, else gloo).
    ``device_type=None`` is ``cuda``, and raises here when no GPU is
    present; ``"cpu"`` must be named. Use as a context manager;
    :meth:`close` stops every process."""
    def __init__(self, ranks: int, *, device_type: Optional[str] = None):
        device_type = resolve_device(device_type).type
        self.ranks = ranks
        self._tmp = tempfile.mkdtemp(prefix="fpx-world-")
        init_method = "file://" + os.path.join(self._tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        self._inboxes = [ctx.Queue() for _ in range(ranks)]
        self._outbox = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, daemon=True, args=(
                rank, ranks, init_method, device_type,
                self._inboxes[rank], self._outbox))
            for rank in range(ranks)]
        try:
            for proc in self._procs:
                proc.start()
            ready = self._collect("ready", START_DEADLINE_S)
        except BaseException:
            self.close()
            raise
        self.backend = ready[0]["backend"]
        self.devices = [r["device"] for r in ready]

    def _collect(self, what: str, deadline_s: float) -> list:
        results, errors = [None] * self.ranks, {}
        deadline = time.monotonic() + deadline_s
        pending = set(range(self.ranks))
        while pending:
            left = deadline - time.monotonic()
            dead = [r for r in pending if not self._procs[r].is_alive()]
            if left <= 0 or dead:
                self.close()
                raise WorldFailure(
                    f"{what}: ranks {sorted(pending)} "
                    + (f"exited ({sorted(dead)})" if dead else
                       f"missed the {deadline_s:.0f} s deadline")
                    + "".join(f"\nrank {r}:\n{tb}"
                              for r, tb in errors.items()))
            try:
                kind, rank, value = self._outbox.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            pending.discard(rank)
            if kind == "error":
                errors[rank] = value
            else:
                results[rank] = value
        if errors:
            raise WorldFailure(f"{what} failed on ranks {sorted(errors)}:"
                               + "".join(f"\nrank {r}:\n{tb}"
                                         for r, tb in errors.items()))
        return results

    def call(self, case: str, deadline_s: float = 120.0, **kwargs) -> list:
        """Run ``case`` (a name of :data:`CASES`, or ``"module:function"``
    in the port) on every rank; each rank's result, by rank."""
        if not self._procs:
            raise WorldFailure("the world is closed")
        for inbox in self._inboxes:
            inbox.put((case, kwargs))
        return self._collect(case, deadline_s)

    def close(self, deadline_s: float = 30.0) -> None:
        """Stop every worker (politely, then by force) and remove the
        rendezvous directory."""
        started = [p for p in self._procs if p.pid is not None]
        for proc, inbox in zip(self._procs, self._inboxes):
            if proc.pid is not None and proc.is_alive():
                inbox.put(None)
        deadline = time.monotonic() + deadline_s
        for proc in started:
            while proc.is_alive() and time.monotonic() < deadline:
                with contextlib.suppress(queue.Empty):
                    self._outbox.get(timeout=0.1)
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=5)
        for q in (*self._inboxes, self._outbox):
            q.close()
            q.cancel_join_thread()
        self._procs = []
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "RankWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WorkerContext:
    """What a case sees of its worker: rank, backend, device, and a store
    that keeps state between calls of one world."""
    def __init__(self, rank: int, backend: str, device: torch.device):
        self.rank = rank
        self.backend, self.device = backend, device
        self.store: dict = {}

    @contextlib.contextmanager
    def mesh(self, group: int, slot: int):
        """The case's ``group x slot`` mesh (None on ranks beyond it),
        closed after a world barrier when the case ends."""
        mesh = make_mesh(group, slot, self.device)
        try:
            yield mesh
        finally:
            dist.barrier()
            if mesh is not None:
                mesh.close()


def _worker(rank: int, world: int, init_method: str, device_type: str,
            inbox, outbox) -> None:

    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        backend, device = init_world(rank, world, init_method,
                                     device_type=device_type)
        ctx = WorkerContext(rank, backend, device)
        outbox.put(("ok", rank, {"backend": backend, "device": str(device)}))
    except BaseException:
        outbox.put(("error", rank, traceback.format_exc()))
        return
    try:
        while (job := inbox.get()) is not None:
            case, kwargs = job
            try:
                outbox.put(("ok", rank, _case(case)(ctx, **kwargs)))
            except Exception:
                outbox.put(("error", rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# --- cases ------------------------------------------------------------------


def _case(name: str):
    """A case by name: one of :data:`CASES`, or ``"module:function"`` for
    a case that lives in another module of the port (a bench's)."""
    if ":" not in name:
        return CASES[name]
    module, function = name.split(":")
    if not module.startswith("frankenpaxos_tpu_torch."):
        raise ValueError(f"case {name!r} is not in the port")
    return getattr(importlib.import_module(module), function)


def _state_dict(state) -> dict:
    out = {name: np.asarray(value) for name, value in
           zip(state._fields[:7], state[:7])}
    out["telemetry"] = None if state.telemetry is None else {
        name: np.asarray(value) for name, value in
        zip(state.telemetry._fields[:6], state.telemetry[:6])}
    return out


def case_drain(ctx: WorkerContext, *, group: int, slot: int, window: int,
               block: int, spec: tuple, iters: int, start: int = 0,
               telemetry: bool = False, chunk: Optional[int] = None,
               init: Optional[dict] = None) -> Optional[dict]:
    """``iters`` drains from ``start`` on a ``group x slot`` mesh, by
    ``make_sharded_step`` (or ``make_sharded_runner`` in chunks of
    ``chunk``), from a fresh state or from ``init`` (a gathered state, as
    ``convert.sharded_state_from_numpy`` takes it). Rank 0 returns the
    gathered state as a dict of arrays; with telemetry, every rank's
    ``obs.telemetry.collect`` snapshot of its own counters comes with it
    under ``snapshots``."""
    masks, thresholds, combine_any = spec
    n_acc = len(masks[0])
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        if init is None:
            state, _ = tp.make_sharded_state(mesh, window, block, n_acc,
                                             telemetry=telemetry)
        else:
            state = convert.sharded_state_from_numpy(mesh, init, window,
                                                     block)
        kw = dict(block_size=block, masks=masks, thresholds=thresholds,
                  combine_any=combine_any, telemetry=telemetry)
        if chunk is None:
            step = tp.make_sharded_step(mesh, **kw)
            for i in range(start, start + iters):
                step(state, i)
        else:
            runner = tp.make_sharded_runner(mesh, iters=chunk, **kw)
            for at in range(start, start + iters, chunk):
                runner(state, at)
        gathered = convert.sharded_state_to_numpy(mesh, state)
        snapshots = [None] * mesh.size
        if telemetry:
            dist.all_gather_object(snapshots, collect(state).to_json(),
                                   group=mesh.mesh_pg)
        if mesh.rank:
            return None
        return dict(_state_dict(gathered), snapshots=snapshots)


def case_place_block(ctx: WorkerContext, *, group: int, slot: int,
                     ids: np.ndarray, block: int) -> Optional[dict]:
    """Each rank lands its slot shard's row with ``place_block``; rank 0
    returns every rank's ``(device, row)``."""
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        placed = place_block(mesh, ids, block)
        mine = (str(placed.device), placed.cpu().numpy())
        every = [None] * mesh.size
        dist.all_gather_object(every, mine, group=mesh.mesh_pg)
        return {"rows": every} if mesh.rank == 0 else None


def case_telemetry_updates(ctx: WorkerContext, *, group: int, slot: int,
                           num_acceptors: int, counts: np.ndarray,
                           newly: np.ndarray, proposed: np.ndarray,
                           valid: np.ndarray, lag: int) -> Optional[dict]:
    """One ``quorum_pass_update`` and one ``drain_update`` over the slot
    axis, slot shard ``s`` taking row ``s`` of each input; rank 0 returns
    its counters."""
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        s = mesh.slot_idx
        tel = ttel.make_telemetry(num_acceptors, slot, device=mesh.device)

        def row(a):
            return torch.from_numpy(np.ascontiguousarray(a[s])).to(
                mesh.device)

        ttel.quorum_pass_update(tel, votes_count=row(counts),
                                newly=row(newly), slot_axis=mesh.slot_axis)
        ttel.drain_update(tel, proposed_block=row(proposed),
                          lane_valid=row(valid),
                          lag=torch.tensor(lag, dtype=torch.int32,
                                           device=mesh.device),
                          slot_axis=mesh.slot_axis)
        return ({name: getattr(tel, name).cpu().numpy()
                 for name in ttel.FIELDS} if mesh.rank == 0 else None)


def _dryrun_shape(n: int) -> tuple:
    """The reference's factoring of ``n`` devices into ``(group, slot)``:
    a group axis of 3, else 2, else 1."""
    group = next((c for c in (3, 2) if n % c == 0), 1)
    return group, n // group


def case_dryrun(ctx: WorkerContext, *, n: int) -> Optional[dict]:
    """One drain (i = 2) on the reference's dryrun mesh under the majority
    spec and under the 3 x group grid write spec, then the sharded
    pipelined tracker's three ring wraps
    (``multichip_board.sharded_tracker_dryrun``); rank 0 returns both
    committed counts and the slots the tracker chose."""
    group, slot = _dryrun_shape(n)
    n_acc, window, block = 3 * group, 1 << 12, 1 << 9
    out = {"mesh": f"{group}x{slot}"}
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        probe = mesh_probe(mesh)
        if not probe.collective_ok:
            raise RuntimeError(f"mesh probe failed: {probe.note}")
        for name, spec in (
                ("committed", SimpleMajority(range(n_acc)).write_spec()),
                ("grid_committed",
                 Grid(np.arange(n_acc).reshape(3, group).tolist())
                 .write_spec())):
            masks, thresholds, combine_any = spec.as_arrays()
            state, _ = tp.make_sharded_state(mesh, window, block, n_acc)
            tp.make_sharded_step(mesh, block_size=block, masks=masks,
                                 thresholds=thresholds,
                                 combine_any=combine_any)(state, 2)
            out[name] = int(state.committed)
        out["chosen"] = multichip_board.sharded_tracker_dryrun(mesh)
        return out if mesh.rank == 0 else None


#: The specs ``check_drain`` takes by name: the headline's majority of 3
#: and the 2x3 grid write spec.
def _named_spec(name: str):

    if name == "majority3":
        return SimpleMajority(range(3)).write_spec()
    if name == "grid2x3":
        return Grid([[0, 1, 2], [3, 4, 5]]).write_spec()
    raise ValueError(f"unknown spec {name!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        return 1 << 62
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def _state_err(a, b) -> int:
    err = max(_err(x, y) for x, y in zip(a[:7], b[:7]))
    if a.telemetry is not None:
        err = max(err, _err(a.telemetry.buffer, b.telemetry.buffer))
    return err


def unsharded_mismatches(gathered, host, slot: int, window: int,
                         block: int) -> list:
    """Where a gathered sharded state and the unsharded drain's state
    (both host numpy) differ, through ``gathered_layout``: the names of
    the leaves that differ (empty when they agree bit for bit)."""
    b_local, pad = tp.local_block(block, slot)
    w_padded = gathered.votes.shape[1]
    logical, valid = tp.gathered_layout(slot, w_padded // slot, b_local,
                                        block)
    bad = []
    for name in ("votes", "chosen", "commands", "results"):
        got = getattr(gathered, name)
        want = np.asarray(getattr(host, name))
        if not np.array_equal(got[..., valid][..., np.argsort(
                logical[valid], kind="stable")], want) \
                or got[..., ~valid].any():
            bad.append(name)
    for name in ("sm_state", "committed", "exec_wm"):
        if int(getattr(gathered, name)) != int(getattr(host, name)):
            bad.append(name)
    if host.telemetry is not None:
        tel, ref = gathered.telemetry, host.telemetry
        for name in ("proposed", "occupancy", "lag_hist", "drains"):
            if not np.array_equal(getattr(tel, name),
                                  np.asarray(getattr(ref, name))):
                bad.append(f"telemetry.{name}")
        if int(tel.shard_committed.sum()) != int(ref.shard_committed.sum()):
            bad.append("telemetry.shard_committed")
        if int(tel.pad_lanes) != pad * int(ref.drains):
            bad.append("telemetry.pad_lanes")
    return bad


def case_check_drain(ctx: WorkerContext, *, group: int, slot: int,
                     spec: str, window: int, block: int, drains: int,
                     compare_drains: int, time_drains: int,
                     telemetry: bool) -> Optional[dict]:
    """On the card: (1) K19, K20 and K21 held against their plain
    versions on identical shards, phase by phase, for
    ``compare_drains`` drains, then :func:`sharded_step` against
    :func:`sharded_step_plain` for two more (the largest difference per
    kernel); (2) with the launch counts at 0, ``drains`` drains through
    ``make_sharded_step``, the counts read, the state gathered and, on
    rank 0, held against the unsharded drain (K3, or K14 with
    telemetry) over the same drains; (3) ``time_drains`` drains with
    every phase synchronised: host milliseconds of each kernel and each
    all-reduce, and on rank 0 the kernels' device time (profiler)."""
    spec = _named_spec(spec)
    n = spec.num_nodes
    kernels = (tp.shard_vote_count, tp.shard_commit, tp.shard_fold)
    plains = (tp.shard_vote_count_plain, tp.shard_commit_plain,
              tp.shard_fold_plain)
    names = [k.__name__ for k in kernels]
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        probe = mesh_probe(mesh)
        if not probe.collective_ok:
            raise RuntimeError(f"mesh probe failed: {probe.note}")
        dev = mesh.device
        pred = make_predicate(*spec.as_arrays(), device=dev)

        def fresh():
            state, _ = tp.make_sharded_state(mesh, window, block, n,
                                             telemetry=telemetry)
            return state, tp.make_shard_plan(mesh, block, pred,
                                             telemetry=telemetry)

        (sk, pk), (sp, pp) = fresh(), fresh()
        errors = dict.fromkeys(names, 0)
        reduce = (lambda p: mesh.psum_group(p.parts),
                  lambda p: mesh.psum_slot(p.slot), lambda p: None)
        for i in range(compare_drains):
            for name, kernel, plain, after in zip(names, kernels, plains,
                                                  reduce):
                kernel(sk, i, pk)
                plain(sp, i, pp)
                errors[name] = max(errors[name], _state_err(sk, sp),
                                   _err(pk.parts, pp.parts),
                                   _err(pk.slot, pp.slot))
                after(pk)
                after(pp)
        for i in range(compare_drains, compare_drains + 2):
            tp.sharded_step(mesh, sk, i, pk)
            tp.sharded_step_plain(mesh, sp, i, pp)
            err = _state_err(sk, sp)
            for name in names:
                errors[name] = max(errors[name], err)
        _sync(dev)

        # (2) The main path through the entry point, counts from 0.
        for kernel in kernels:
            kernel.launches = 0
        state, _ = tp.make_sharded_state(mesh, window, block, n,
                                         telemetry=telemetry)
        masks, thresholds, combine_any = spec.as_arrays()
        step = tp.make_sharded_step(
            mesh, block_size=block, masks=masks, thresholds=thresholds,
            combine_any=combine_any, telemetry=telemetry)
        t0 = time.perf_counter()
        for i in range(drains):
            step(state, i)
        _sync(dev)
        run_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        gathered = tp.gather_state(mesh, state)
        bad = None
        if mesh.rank == 0:
            host = tp.make_state(window, n, telemetry=telemetry,
                                 device=dev)
            for i in range(drains):
                tp.steady_state_step(host, i, block_size=block,
                                     predicate=pred)
            bad = unsharded_mismatches(
                gathered, convert.pipeline_state_to_numpy(host), slot, window,
                block)

        # (3) The per-phase split, every phase synchronised.
        split = {key: [] for key in ("shard_vote_count", "psum_group",
                                     "shard_commit", "psum_slot",
                                     "shard_fold")}
        phases = ((names[0], lambda i: kernels[0](state, i, step.plan)),
                  ("psum_group", lambda i: mesh.psum_group(step.plan.parts)),
                  (names[1], lambda i: kernels[1](state, i, step.plan)),
                  ("psum_slot", lambda i: mesh.psum_slot(step.plan.slot)),
                  (names[2], lambda i: kernels[2](state, i, step.plan)))
        for i in range(drains, drains + time_drains):
            for key, run in phases:
                t0 = time.perf_counter()
                run(i)
                _sync(dev)
                split[key].append((time.perf_counter() - t0) * 1e3)
        device_ms = None
        at = drains + time_drains
        if mesh.rank == 0 and dev.type == "cuda":
            from torch.profiler import profile, ProfilerActivity

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(at, at + time_drains):
                    step(state, i)
                _sync(dev)
            device_ms = {}
            for evt in prof.key_averages():
                for name in names:
                    if f"{name}_kernel" in evt.key and evt.count:
                        total = getattr(evt, "device_time_total", None) \
                            or getattr(evt, "cuda_time_total", 0)
                        device_ms[name] = total / evt.count / 1e3
        else:
            for i in range(at, at + time_drains):
                step(state, i)
        _sync(dev)
        return {
            "rank": mesh.rank, "backend": mesh.backend,
            "device": str(dev), "errors": errors, "launches": launches,
            "unsharded_mismatch": bad, "run_s": run_s,
            "committed": int(state.committed),
            "split_ms": {k: float(np.median(v)) for k, v in split.items()},
            "device_ms": device_ms,
        }


#: The full-width check's meshes, ``(group, slot, spec)``: the slot
#: shards; a split that does not divide (b_local 10923, one pad lane per
#: block); whole grid rows per group shard (the fused row path); rows
#: that straddle the shards (the psum'd matmul).
CHECK_MESHES = ((1, 4, "majority3"), (1, 3, "majority3"),
                (2, 2, "grid2x3"), (3, 1, "grid2x3"))
#: The kernels of the sharded drain, by wrapper name.
SHARDED_KERNELS = ("shard_vote_count", "shard_commit", "shard_fold")


def check(world: RankWorld, group: int, slot: int, spec: str,
          telemetry: bool, *, window: int = 1 << 20, block: int = 1 << 15,
          drains: int = 40, compare_drains: int = 3,
          time_drains: int = 20) -> list:
    """``check_drain`` on every rank of ``world`` (defaults: the
    headline's full width, 40 drains so the 32-block ring wraps); the
    mesh ranks' results. Raises ``WorldFailure`` when a kernel differs
    from its plain version, a rank did not launch each kernel once per
    drain, or the gathered state differs from the unsharded drain's."""
    ranks = [r for r in world.call(
        "check_drain", deadline_s=300, group=group, slot=slot, spec=spec,
        window=window, block=block, drains=drains,
        compare_drains=compare_drains, time_drains=time_drains,
        telemetry=telemetry) if r is not None]
    case = f"{group}x{slot} {spec}, telemetry {telemetry}"
    for r in ranks:
        if any(r["errors"].values()):
            raise WorldFailure(f"{case}: a kernel differs from its plain "
                               f"version on rank {r['rank']}: {r['errors']}")
        if any(r["launches"][k] != drains for k in SHARDED_KERNELS):
            raise WorldFailure(f"{case}: rank {r['rank']} launched "
                               f"{r['launches']} in {drains} drains")
    if len(ranks) != group * slot or ranks[0]["unsharded_mismatch"]:
        raise WorldFailure(f"{case}: the gathered state differs from the "
                           f"unsharded drain's in "
                           f"{ranks[0]['unsharded_mismatch']}")
    return ranks


def check_summary(ranks: list) -> dict:
    """The figures of one :func:`check`: rank 0's device times and
    per-phase split, and each phase's slowest rank."""
    lead = ranks[0]
    return {
        "backend": lead["backend"], "ranks": len(ranks),
        "devices": sorted({r["device"] for r in ranks}),
        "committed": lead["committed"], "drains_s": lead["run_s"],
        "split_ms_rank0": lead["split_ms"],
        "split_ms_max": {k: max(r["split_ms"][k] for r in ranks)
                         for k in lead["split_ms"]},
        "device_ms_rank0": lead["device_ms"]}


def case_modules(ctx: WorkerContext) -> list:
    """The top-level modules this worker has loaded."""
    del ctx
    return sorted({name.split(".")[0] for name in sys.modules})


def dryrun(n_devices: int = 8, *, device_type: Optional[str] = None,
           world: Optional[RankWorld] = None) -> dict:
    """Shard one drain of the pipeline over an ``n_devices``-rank
    ``(group, slot)`` mesh -- acceptor rows over ``group`` (3, else 2,
    else 1), the slot window over ``slot`` -- under the majority and the
    grid write specs, after a mesh probe; then run the ProxyLeader's
    pipelined tracker with its vote board sharded over the mesh for
    three ring wraps against the dict oracle. Raises when a run commits
    nothing or the tracker does not choose exactly ``3 << 10`` slots;
    returns the counts. Spawns its own world on
    ``device_type`` (None: ``cuda``, raising with no GPU; name ``"cpu"``
    for gloo ranks on the host) unless one of at least ``n_devices``
    ranks is given."""
    if world is None:
        with RankWorld(n_devices, device_type=device_type) as own:
            return dryrun(n_devices, world=own)
    out = world.call("dryrun", n=n_devices)[0]
    if out["committed"] <= 0 or out["grid_committed"] <= 0:
        raise RuntimeError(f"the sharded drain committed nothing: {out}")
    if out["chosen"] != 3 << 10:
        raise RuntimeError(f"the sharded tracker chose {out['chosen']} "
                           f"slots, not {3 << 10}")
    group = out["mesh"].split("x")[0]
    print(f"dryrun_multichip ok: mesh {out['mesh']} (group x slot) over "
          f"{world.backend}, {out['committed']} slots committed in one "
          f"step (majority spec) and {out['grid_committed']} under the "
          f"3x{group} grid write spec; real TpuQuorumChecker vote board "
          f"sharded over the mesh chose {out['chosen']} slots across 3 "
          f"ring wraps, bit-identical to the host oracle")
    return out


CASES = {
    "drain": case_drain,
    "place_block": case_place_block,
    "telemetry_updates": case_telemetry_updates,
    "dryrun": case_dryrun,
    "check_drain": case_check_drain,
    "modules": case_modules,
    **multichip_board.CASES,
}


def main(argv=None) -> int:
    """``python -m frankenpaxos_tpu_torch.bench.multichip [--ranks N]``:
    build the kernels, spawn ``N`` ranks on the card(s) (one per card
    over NCCL when there are as many cards, else sharing over gloo), run
    :func:`check` on every mesh of :data:`CHECK_MESHES` that fits,
    telemetry off and on, then the sharded vote board's check
    (``multichip_board.check_board``; its arms on ``(1, N)`` unless N is
    4); one JSON line, nonzero on a failed gate."""
    parser = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    args = parser.parse_args(argv)
    resolve_device(None)
    _build.build()
    out = {"cards": torch.cuda.device_count(),
           "nvidia_smi": nvidia_smi_line(), "cases": {}}
    with RankWorld(args.ranks, device_type="cuda") as world:
        out["backend"] = world.backend
        for group, slot, spec in CHECK_MESHES:
            if group * slot > args.ranks:
                continue
            for telemetry in (False, True):
                out["cases"][f"{group}x{slot} {spec} telemetry "
                             f"{'on' if telemetry else 'off'}"] = \
                    check_summary(check(world, group, slot, spec, telemetry))
        arms, side = multichip_board.BOARD_ARMS, (1, 4)
        if args.ranks != 4:
            side = (1, args.ranks)
            arms = {name: (side, *arm[1:])
                    for name, arm in multichip_board.BOARD_ARMS.items()}
        board = multichip_board.check_board(
            world, device=torch.device("cuda", 0), arms=arms, side=side)
        lead = next(r for r in board["ranks"] if r["rank"] == 0)
        out["board"] = {
            "launches": board["launches"],
            "allreduce_ms_rank0": lead["allreduce_ms"],
            "arms": {name: {k: arm[k] for k in (
                "drains", "chosen", "drain_ms_median", "allreduces")}
                for name, arm in lead["arms"].items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
