"""The sharded vote board's rank cases, its on-card check and the vote
board part of the multichip dryrun.

The reference lays the ``TpuQuorumChecker`` / ``EpochSegmentedChecker``
vote board out over a device mesh (``ops/quorum.py::_shard_board``: the
slot columns split over every mesh axis, the acceptor axis whole) under
``TpuQuorumTracker(mesh=)`` and ``GeoQuorumTracker(mesh=)``, splits the
EPaxos dependency-set batches by rows, and runs its pinned drain with
``group_axis`` / ``slot_axis``. Here each of those runs SPMD over the
ranks of :class:`~frankenpaxos_tpu_torch.bench.multichip.RankWorld`:
every rank builds the same checker or tracker with the same mesh and is
fed the same calls in the same order (the host inputs replicated, as
JAX's single process feeds every device), holds only its columns or
rows, and returns the same answer.

Cases (merged into ``multichip.CASES``; each builds its ``group x slot``
mesh over the first ranks of the world):

  * ``tracker_replay`` -- a ``TpuQuorumTracker(mesh=)`` fed drains of
    votes, reporting per drain;
  * ``checker_ops`` -- a script of calls on ``TpuQuorumChecker(mesh=)``
    or ``EpochSegmentedChecker(mesh=)``, optionally from a carried-in
    board, with the gathered board at the end;
  * ``board_ops`` -- the sharded board functions (K2, K4, K5) on a raw
    board, for parity with the reference's jitted board functions;
  * ``geo_ops`` -- a script on ``GeoQuorumTracker(backend="cuda",
    mesh=)``;
  * ``depset`` -- the batch-sharded dependency-set algebra;
  * ``pinned_drain`` -- the pinned drain's mesh form
    (``bench/pipeline_baseline.py``);
  * ``check_board`` -- on the card: each kernel on the rank's shard
    against its plain version, then the full-width path with the launch
    counts from 0, then the per-call figures (``chip_smoke.py``).

:func:`sharded_tracker_dryrun` is the third part of
``__graft_entry__.dryrun_multichip``: the ProxyLeader's pipelined
tracker on the mesh chooses three ring wraps of slots, each drain equal
to the dict oracle.
"""

from __future__ import annotations

import hashlib
import pickle
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import pipeline as tp
from frankenpaxos_tpu_torch.bench import pipeline_baseline as tpin
from frankenpaxos_tpu_torch.bench import tracker_lt
from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch
from frankenpaxos_tpu_torch.geo.quorum import GeoQuorumTracker
from frankenpaxos_tpu_torch.ops import depset as td
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
    DictQuorumTracker,
    TpuQuorumTracker,
)

#: The kernels of the sharded board's path (``chip_smoke.py``'s gate):
#: K1 (the synchronous tracker, whole on every rank), K2, K4, K5, K6, K7.
BOARD_KERNELS = ("quorum_hit", "record_block", "record_and_check",
                 "release", "record_and_check_epochs", "reshape_columns")
#: The pinned mesh form's kernels, by their rows in the kernels line.
PINNED_KERNELS = {"shard_vote_count_baseline": tpin.shard_vote_count,
                  "shard_commit_baseline": tpin.shard_commit,
                  "shard_fold_baseline": tpin.shard_fold}
_BOARD_WRAPPERS = {"quorum_hit": tq.quorum_hit,
                   "record_block": tq.record_block,
                   "record_and_check": tq.record_and_check,
                   "release": tq.release,
                   "record_and_check_epochs": tq.record_and_check_epochs,
                   "reshape_columns": tq.reshape_columns}


def _digest(value) -> str:
    return hashlib.sha256(pickle.dumps(value)).hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replay_by_drain(tracker, drains: list, row: int,
                    stats: Optional[dict] = None) -> list:
    """Feed ``drains`` (``bench/tracker_lt.py``'s events: ``("range",
    start, end, round, acceptor)`` or ``("vote", slot, round,
    acceptor)``, acceptor ``a`` voting as ``(a // row, a % row)``) into a
    MultiPaxos tracker, one ``drain()`` per drain; a pipelined tracker's
    dispatches are collected right after their drain. Returns each
    drain's reports, sorted. With ``stats``, appends each drain's host
    seconds (record to collected) to ``stats["seconds"]`` and adds its
    dispatched parts (on a mesh, one all-reduce each) to
    ``stats["parts"]``."""
    out = []
    for events in drains:
        t0 = time.perf_counter()
        for event in events:
            if event[0] == "range":
                _, start, end, rnd, acc = event
                tracker.record_range(start, end, rnd, acc // row, acc % row)
            else:
                _, slot, rnd, acc = event
                tracker.record(slot, rnd, acc // row, acc % row)
        got = list(tracker.drain())
        if getattr(tracker, "pipelined", False):
            while (dispatch := tracker.take_dispatch()) is not None:
                if stats is not None:
                    stats["parts"] = stats.get("parts", 0) + len(dispatch)
                got.extend(tracker.collect(dispatch))
        if stats is not None:
            stats.setdefault("seconds", []).append(time.perf_counter() - t0)
        out.append(sorted((int(slot), int(rnd)) for slot, rnd in got))
    return out


def _answer(mesh, value, extra: Optional[dict] = None) -> dict:
    """Every rank's answer: the digest of ``value`` (so the parent can
    hold the ranks equal) and, on rank 0 only, the value itself."""
    out = {"rank": mesh.rank, "digest": _digest(value),
           "value": value if mesh.rank == 0 else None}
    out.update(extra or {})
    return out


def case_tracker_replay(ctx, *, group: int, slot: int, config,
                        window: int, pipelined: bool, drains: list,
                        row: int = 3) -> Optional[dict]:
    """A ``TpuQuorumTracker(mesh=)`` fed ``drains``: its per-drain
    reports."""
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        tracker = TpuQuorumTracker(config, window=window,
                                   pipelined=pipelined, mesh=mesh)
        return _answer(mesh, replay_by_drain(tracker, drains, row))


def _run_ops(target, ops: list) -> list:
    """Call ``target.<name>(*args)`` for each ``(name, *args)`` of
    ``ops``; each result as numpy (None for a call that returns
    nothing)."""
    results = []
    for name, *args in ops:
        got = getattr(target, name)(*args)
        results.append(None if got is None else np.asarray(got))
    return results


def case_checker_ops(ctx, *, group: int, slot: int, kind: str, specs,
                     window: int, ops: list, boundaries=None,
                     init=None) -> Optional[dict]:
    """A ``TpuQuorumChecker(mesh=)`` (``kind="quorum"``, ``specs`` one
    spec) or ``EpochSegmentedChecker(mesh=)`` (``kind="epoch"``) from a
    fresh board or the whole board ``init`` (numpy arrays), the calls of
    ``ops`` (``(method, *args)``), and the gathered board."""
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        if kind == "quorum":
            checker = tq.TpuQuorumChecker(specs, window, mesh=mesh)
        else:
            checker = tq.EpochSegmentedChecker(specs, boundaries,
                                               window=window, mesh=mesh)
        if init is not None:
            checker.board = convert.sharded_vote_board_from_numpy(
                mesh, init, window)
        results = _run_ops(checker, ops)
        board = convert.gather_vote_board(mesh, checker.board)
        universe = getattr(checker, "universe", None)
        return _answer(mesh, (results, universe),
                       {"board": board if mesh.rank == 0 else None})


def case_board_ops(ctx, *, group: int, slot: int, spec: tuple, window: int,
                   ops: list, init=None) -> Optional[dict]:
    """The sharded board functions on a raw board of ``window`` columns
    under the predicate ``spec`` (masks, thresholds, combine_any):
    ``("record_block", start, true_start, block, round)``,
    ``("record_and_check", lanes)`` and ``("release", slots, valid)``;
    each call's result and the gathered board after it."""
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        pred = tq.make_predicate(*spec, device=mesh.device)
        n = pred.num_nodes
        board = (tq.make_vote_board(window, n, mesh=mesh) if init is None
                 else convert.sharded_vote_board_from_numpy(mesh, init,
                                                            window))
        results = []
        for name, *args in ops:
            if name == "record_block":
                got = tq.record_block_sharded(board, mesh, *args, pred)
            elif name == "record_and_check":
                got = tq.record_and_check_sharded(board, mesh, *args, pred)
            elif name == "release":
                got = tq.release_sharded(board, mesh, *args)
            else:
                raise ValueError(f"unknown board op {name!r}")
            results.append((None if got is None else got.cpu().numpy(),
                            convert.gather_vote_board(mesh, board)))
        return _answer(mesh, results)


def case_geo_ops(ctx, *, group: int, slot: int, store, geo_group: int,
                 grid, window: int, ops: list) -> Optional[dict]:
    """A ``GeoQuorumTracker(backend="cuda", mesh=)`` over ``store`` fed
    ``ops``: ``("record", slot, ballot, acceptor)``, ``("drain",)``,
    ``("offer", epoch_fields)`` (a ``GeoEpoch`` offered to the store),
    ``("note_epochs",)`` and ``("release", slots)``; the drains'
    reports, each sorted."""
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        tracker = GeoQuorumTracker(store, geo_group, grid, backend="cuda",
                                   window=window, mesh=mesh)
        return _answer(mesh, run_geo(tracker, store, ops))


def _gather_rows(mesh, tensors: dict) -> dict:
    """Each named tensor's rows from every rank, concatenated in rank
    order, as numpy."""
    local = {k: v.detach().cpu().numpy() for k, v in tensors.items()}
    pieces = [None] * mesh.size
    dist.all_gather_object(pieces, local, group=mesh.mesh_pg)
    return {k: np.concatenate([p[k] for p in pieces]) for k in local}


def case_depset(ctx, *, group: int, slot: int, a: tuple,
                b: tuple) -> Optional[dict]:
    """The batch-sharded algebra on the whole batches ``a`` and ``b``
    (numpy ``(watermarks, tails, tail_base)``): ``union``, ``equal`` and
    ``size`` on each rank's rows, gathered; ``union_reduce_sharded`` of
    ``a``."""
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        sa, sb = (td.shard_rows(convert.depset_from_jax(*x, device="cpu"),
                                mesh) for x in (a, b))
        union = td.union(sa, sb)
        rows = _gather_rows(mesh, {
            "union_watermarks": union.watermarks,
            "union_tails": union.tails, "equal": td.equal(sa, sb),
            "equal_self": td.equal(sa, sa), "size": td.size(sa)})
        reduced = convert.depset_to_numpy(td.union_reduce_sharded(sa, mesh))
        return _answer(mesh, {**rows,
                              "reduce_watermarks": reduced.watermarks,
                              "reduce_tails": reduced.tails})


def gather_pinned_state(mesh, state: tpin.PipelineState) -> dict:
    """The whole pinned sharded state as numpy arrays on every rank
    (collective), each leaf assembled by ``PIPELINE_PARTITION``."""
    names = tpin.PipelineState._fields
    local = {name: t.detach().cpu().numpy() for name, t in zip(names, state)}
    pieces = [None] * mesh.size
    dist.all_gather_object(pieces, local, group=mesh.mesh_pg)
    return {name: tp.unshard_leaf([p[name] for p in pieces],
                                  getattr(tp.PIPELINE_PARTITION, name),
                                  mesh, name)
            for name in names}


def case_pinned_drain(ctx, *, group: int, slot: int, window: int,
                      block: int, spec: tuple, iters: int,
                      start: int = 0) -> Optional[dict]:
    """``iters`` pinned drains from ``start`` on a ``group x slot`` mesh
    (``pipeline_baseline.make_sharded_step``); the gathered state."""
    masks, thresholds, combine_any = spec
    with ctx.mesh(group, slot) as mesh:
        if mesh is None:
            return None
        state, _ = tpin.make_sharded_state(mesh, window, block,
                                           len(masks[0]))
        step = tpin.make_sharded_step(mesh, block_size=block, masks=masks,
                                      thresholds=thresholds,
                                      combine_any=combine_any)
        for i in range(start, start + iters):
            step(state, i)
        return _answer(mesh, gather_pinned_state(mesh, state))


def sharded_tracker_dryrun(mesh) -> int:
    """The reference's third dryrun part on ``mesh``: the ProxyLeader's
    ``TpuQuorumTracker(pipelined=True, window=1 << 10, mesh=)`` and the
    dict oracle fed the same two votes per slot for 3 ring wraps in
    drains of 128 slots; raises when a drain differs or the slots chosen
    are not exactly ``3 << 10``. Returns that count."""
    from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
        make_multipaxos,
    )

    config = make_multipaxos(f=1).config
    oracle = DictQuorumTracker(config)
    tracker = TpuQuorumTracker(config, window=1 << 10, pipelined=True,
                               mesh=mesh)
    chosen = 0
    for base in range(0, 3 << 10, 128):
        for slot in range(base, base + 128):
            for record in (oracle.record, tracker.record):
                record(slot, 0, 0, slot % 3)
                record(slot, 0, 0, (slot + 1) % 3)
        dispatched = tracker.drain()
        if dispatched:
            raise RuntimeError(f"the pipelined tracker reported in its "
                               f"drain: {dispatched[:4]}")
        got = []
        while (dispatch := tracker.take_dispatch()) is not None:
            got.extend(tracker.collect(dispatch))
        want = sorted(oracle.drain())
        if sorted(got) != want:
            raise RuntimeError(f"the sharded tracker diverged from the "
                               f"dict oracle at base {base}")
        chosen += len(got)
    if chosen != 3 << 10:
        raise RuntimeError(f"expected {3 << 10} chosen, got {chosen}")
    return chosen


# --- the on-card check (chip_smoke.py) -----------------------------------

#: ``check_board``'s tracker arms, by name: ``(mesh shape, flexible 2x3
#: grid, slots, pipelined)``, each at the ProxyLeader's default window
#: (``BOARD_WINDOW``) and fed ``bench/tracker_lt.py``'s stream (drains of
#: 4096 with stragglers, duplicates and round bumps) made on every rank.
BOARD_ARMS = {
    "pipelined majority3 1x4": ((1, 4), False, 1 << 20, True),
    "pipelined majority3 2x2": ((2, 2), False, 1 << 18, True),
    "pipelined grid2x3 2x2": ((2, 2), True, 1 << 18, True),
    "sync majority3 1x4": ((1, 4), False, 1 << 16, False),
}
BOARD_WINDOW = 1 << 20
#: The epoch checker's window (the ProxyLeader's epoch tracker's).
EPOCH_WINDOW = 1 << 14
#: The pinned mesh form's block and drains (the 32-block ring wraps).
PINNED_BLOCK = 1 << 15
PINNED_DRAINS = 40
#: The batch-sharded union's batch, ``[B, L, W]`` (libbench's).
DEPSET_SHAPE = (4096, 3, 64)
#: Every wrapper whose launches the sharded board's path counts, by its
#: row in ``chip_smoke.py``'s kernels line.
PATH_WRAPPERS = {**_BOARD_WRAPPERS,
                 "check_batch_multi": tq.check_batch_multi,
                 "normalized": td.normalized,
                 "union_reduce": td.union_reduce, **PINNED_KERNELS}


def arm_stream(flexible: bool, slots: int) -> list:
    """An arm's drains: ``tracker_lt``'s stream over 3 acceptors (or the
    2x3 grid's 6, seeded apart as ``tracker_lt.run`` seeds them)."""
    acceptors, seed = ((6, tracker_lt.SEED + 1) if flexible
                       else (3, tracker_lt.SEED))
    return tracker_lt.make_stream(slots, acceptors, tracker_lt.DRAIN, seed)


def epoch_script() -> tuple:
    """``(specs, boundaries, ops)`` for ``EpochSegmentedChecker`` at
    ``EPOCH_WINDOW``: a majority of (0, 1, 2) fed 24 batches of 256 votes
    across the window, a release, then a handover at mid-window to a
    majority of (0, 1, 3) -- the union universe grows, so the board
    reshapes (K7) -- 24 more batches on both sides of it, and a stateless
    check."""
    from frankenpaxos_tpu_torch.quorums import SimpleMajority

    rng = np.random.default_rng(tracker_lt.SEED + 2)
    window, width = EPOCH_WINDOW, 256
    ops = []

    def votes(cols):
        for _ in range(24):
            ops.append(("record_and_check",
                        rng.integers(0, window, size=width),
                        rng.choice(cols, size=width),
                        rng.integers(0, 2, size=width)))

    votes([0, 1, 2])
    ops.append(("release", rng.integers(0, window, size=512)))
    ops.append(("add_epoch", SimpleMajority((0, 1, 3)).write_spec(),
                window // 2))
    votes([0, 1, 2, 3])
    ops.append(("check_batch", (rng.random((width, 4)) < 0.5).astype(
        np.uint8), rng.integers(0, window, size=width)))
    return [SimpleMajority((0, 1, 2)).write_spec()], [0], ops


def geo_script() -> tuple:
    """``(store, grid, ops)``: the ZoneGrid stream of the reference's
    ``tests/test_multichip_epoch.py`` (two object groups, group 0 stolen
    by zone 2 at slot 8 with ballot 5; 16 slots of random voters, drained
    every 5 votes)."""
    import random

    from frankenpaxos_tpu_torch.geo.epochs import ObjectEpochStore
    from frankenpaxos_tpu_torch.quorums import ZoneGrid

    store = ObjectEpochStore(2, [0, 1])
    store.offer(GeoEpoch(group=0, epoch=1, start_slot=8, home_zone=2,
                         ballot=5))
    rng = random.Random(11)
    votes = []
    for slot in range(16):
        ballot = 0 if slot < 8 else 5
        for acceptor in rng.sample(range(9), rng.randint(1, 9)):
            votes.append((slot, ballot, acceptor))
    rng.shuffle(votes)
    ops = []
    for i, vote in enumerate(votes):
        ops.append(("record", *vote))
        if i % 5 == 4:
            ops.append(("drain",))
    ops.append(("drain",))
    return store, ZoneGrid([[0, 1, 2], [3, 4, 5], [6, 7, 8]]), ops


def run_geo(tracker, store, ops: list) -> list:
    """``ops`` (as ``case_geo_ops`` takes them) on a geo tracker over
    ``store``: each drain's reports, sorted."""
    drains = []
    for name, *args in ops:
        if name == "offer":
            store.offer(GeoEpoch(**args[0]))
        elif name == "drain":
            drains.append(sorted((int(slot), int(ballot))
                                 for slot, ballot in tracker.drain()))
        else:
            getattr(tracker, name)(*args)
    return drains


def depset_batch() -> tuple:
    """A seeded ``(watermarks, tails, tail_base)`` batch of
    ``DEPSET_SHAPE`` with 0/1 tails and watermarks on both sides of the
    window's start (tail base 2^16)."""
    rng = np.random.default_rng(tracker_lt.SEED + 3)
    b, l, _ = DEPSET_SHAPE
    base = 1 << 16
    return (rng.integers(base - 16, base + 48, size=(b, l)).astype(np.int32),
            (rng.random(DEPSET_SHAPE) < 0.5).astype(np.uint8),
            np.int32(base))


def board_digest(board) -> str:
    """A digest of a whole board's four leaves (dtype, shape, bytes)."""
    return _digest(tuple((np.asarray(x).dtype.str, np.shape(x),
                          np.ascontiguousarray(x).tobytes()) for x in board))


def _err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        return 1 << 62
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def _compare_on_shard(mesh, calls: int) -> dict:
    """Each kernel of the path on this rank's shard against its plain
    version on an identical shard (both on the card), on seeded calls
    localized as the sharded forms localize them: K1 on a replicated
    4096-slot block; K2 on 4096-wide blocks across the shard edges of the
    2^20 window; K4 on 256 straggler lanes (some outside the window); K5
    on 512 slots; K6 and K7 on the epoch board; the pinned K19-K21
    copies phase by phase over the mesh's two all-reduces. The largest
    difference per kernel."""
    from frankenpaxos_tpu_torch.quorums import SimpleMajority

    dev = mesh.device
    rng = np.random.default_rng(tracker_lt.SEED + 4)
    errors = dict.fromkeys(PATH_WRAPPERS, 0)
    spec = SimpleMajority(range(3)).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device=dev)
    window, width = BOARD_WINDOW, 4096
    lo, hi = mesh.columns(window)
    bk, bp = (tq.make_vote_board(window, 3, mesh=mesh) for _ in range(2))

    def note(name, *pairs):
        errors[name] = max([errors[name]] + [_err(a, b) for a, b in pairs])

    def boards(a, b):
        return tuple(zip(a, b))

    for k in range(calls):
        block = (rng.random((3, width)) < 0.6).astype(np.uint8)
        bt = tq.stage(block, dev)
        note("quorum_hit", (tq.quorum_hit(bt, pred),
                            tq.quorum_hit_plain(bt, pred)))
        edge = (k % (mesh.size - 1) + 1) * (hi - lo) if mesh.size > 1 \
            else window // 2
        start = edge - int(rng.integers(1, width))
        true_start = k * window + start
        part = tq.block_part(mesh, window, start, width)
        if part is not None:
            first, last, local = part
            sub = tq.stage(block[:, first:last], dev)
            rnd = int(rng.integers(0, 2))
            note("record_block",
                 (tq.record_block(bk, local, true_start + first, sub, rnd,
                                  pred),
                  tq.record_block_plain(bp, local, true_start + first, sub,
                                        rnd, pred)), *boards(bk, bp))
        true = k * window + rng.integers(-window // 2, window, size=256)
        slots = true % window
        slots[:8] = rng.integers(window, 2 * window, size=8)
        lanes, _ = tq.localize_lanes(tq.pack_lanes(
            slots, true, rng.integers(0, 3, size=256),
            rng.integers(0, 2, size=256), np.ones(256, bool)), mesh, window)
        lt = tq.stage(lanes, dev)
        note("record_and_check", (tq.record_and_check(bk, lt, pred),
                                  tq.record_and_check_plain(bp, lt, pred)),
             *boards(bk, bp))
        gc = rng.integers(lo, hi, size=512) - lo
        st, vt = tq.stage(gc.astype(np.int32), dev), tq.stage(
            np.ones(512, bool), dev)
        tq.release(bk, st, vt)
        tq.release_plain(bp, st, vt)
        note("release", *boards(bk, bp))

    specs, bounds, ops = epoch_script()
    ek, ep = (tq.EpochSegmentedChecker(specs, bounds, window=EPOCH_WINDOW,
                                       mesh=mesh) for _ in range(2))
    for name, *args in ops:
        if name == "record_and_check":
            lanes, _ = tq.localize_lanes(tq._checker_lanes(
                np.asarray(args[0], np.int64), args[1], args[2],
                EPOCH_WINDOW, 256), mesh, EPOCH_WINDOW)
            lt = tq.stage(lanes, dev)
            note("record_and_check_epochs",
                 (tq.record_and_check_epochs(ek.board, lt, ek._boundaries,
                                             ek.planes),
                  tq.record_and_check_epochs_plain(ep.board, lt,
                                                   ep._boundaries,
                                                   ep.planes)),
                 *boards(ek.board, ep.board))
        elif name == "add_epoch":
            old = ek.universe
            ek.add_epoch(*args)
            ep._own_specs.append(args[0])
            ep._starts.append(int(args[1]))
            ep._rebuild_universe()
            cmap = tq.stage(tq.epoch_column_map(old, ep.universe), dev)
            ep.board = ep.board._replace(votes=tq.reshape_columns_plain(
                ep.board.votes, cmap))
            note("reshape_columns", *boards(ek.board, ep.board))

    state_k, _ = tpin.make_sharded_state(mesh, window, PINNED_BLOCK, 3)
    state_p, _ = tpin.make_sharded_state(mesh, window, PINNED_BLOCK, 3)
    plan_k, plan_p = (tpin.make_shard_plan(mesh, PINNED_BLOCK, pred)
                      for _ in range(2))
    phases = (("shard_vote_count_baseline", tpin.shard_vote_count,
               tpin.shard_vote_count_plain,
               lambda p: mesh.psum_group(p.parts)),
              ("shard_commit_baseline", tpin.shard_commit,
               tpin.shard_commit_plain, lambda p: mesh.psum_slot(p.slot)),
              ("shard_fold_baseline", tpin.shard_fold,
               tpin.shard_fold_plain, lambda p: None))
    for i in range(3):
        for name, kernel, plain, after in phases:
            kernel(state_k, i, plan_k)
            plain(state_p, i, plan_p)
            note(name, *boards(state_k, state_p),
                 (plan_k.parts, plan_p.parts), (plan_k.slot, plan_p.slot))
            after(plan_k)
            after(plan_p)
    _sync(dev)
    return errors


def _allreduce_ms(mesh, width: int, iters: int) -> float:
    """Median host ms of one all-reduce SUM of ``width`` bytes over the
    mesh, synchronised (the per-lane result's collective)."""
    out = torch.zeros(width, dtype=torch.uint8, device=mesh.device)
    times = []
    for k in range(iters + 5):
        _sync(mesh.device)
        t0 = time.perf_counter()
        mesh.psum_mesh(out)
        _sync(mesh.device)
        if k >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def case_check_board(ctx, *, arms: dict, side: tuple, compare_calls: int,
                     time_iters: int) -> Optional[dict]:
    """On the card (the CPU runs the plain versions): (1) each kernel of
    the path on this rank's shard against its plain version
    (:func:`_compare_on_shard`, on the ``side`` mesh); (2) with every
    launch count at 0, the path: each arm of ``arms`` through
    ``TpuQuorumTracker(mesh=)`` (per-drain reports, the gathered board,
    host ms per drain, all-reduces per drain, launches), then on the
    ``side`` mesh ``EpochSegmentedChecker(mesh=)`` across a handover that
    grows the universe, ``GeoQuorumTracker(mesh=)`` on the ZoneGrid
    stream, ``union_reduce_sharded`` and the pinned mesh form; the counts
    read; (3) the all-reduce's host ms alone. Digests on every rank, the
    values on rank 0."""
    with ctx.mesh(*side) as mesh:
        errors = None if mesh is None else _compare_on_shard(
            mesh, compare_calls)
    for wrapper in PATH_WRAPPERS.values():
        wrapper.launches = 0

    def counts():
        return {name: w.launches for name, w in PATH_WRAPPERS.items()}

    out = {"rank": ctx.rank, "errors": errors, "arms": {}}
    for name, (shape, flexible, slots, pipelined) in arms.items():
        with ctx.mesh(*shape) as mesh:
            if mesh is None:
                continue
            drains = arm_stream(flexible, slots)
            before = counts()
            tracker = TpuQuorumTracker(
                tracker_lt.make_config(flexible), window=BOARD_WINDOW,
                pipelined=pipelined, mesh=mesh)
            stats: dict = {}
            t0 = time.perf_counter()
            reports = replay_by_drain(tracker, drains, 3, stats)
            _sync(mesh.device)
            run_s = time.perf_counter() - t0
            after = counts()
            board = convert.gather_vote_board(mesh, tracker.checker.board)
            out["arms"][name] = {
                "digest": _digest(reports), "board_digest": board_digest(
                    board), "drains": len(drains),
                "chosen": sum(map(len, reports)), "run_s": run_s,
                "drain_ms_median": float(np.median(stats["seconds"])) * 1e3,
                "drain_ms_mean": float(np.mean(stats["seconds"])) * 1e3,
                "allreduces": stats.get("parts", 0),
                "launches": {k: after[k] - before[k] for k in after}}
    with ctx.mesh(*side) as mesh:
        if mesh is not None:
            specs, bounds, ops = epoch_script()
            checker = tq.EpochSegmentedChecker(specs, bounds,
                                               window=EPOCH_WINDOW, mesh=mesh)
            results = _run_ops(checker, ops)
            out["epoch"] = {"digest": _digest(results),
                            "board_digest": board_digest(
                                convert.gather_vote_board(mesh,
                                                          checker.board))}
            store, grid, gops = geo_script()
            geo = run_geo(GeoQuorumTracker(store, 0, grid, backend="cuda",
                                           mesh=mesh), store, gops)
            out["geo"] = {"digest": _digest(geo)}
            whole = convert.depset_from_jax(*depset_batch(), device="cpu")
            reduced = convert.depset_to_numpy(td.union_reduce_sharded(
                td.shard_rows(whole, mesh), mesh))
            out["depset"] = {"digest": _digest(reduced[:2]),
                             "value": reduced[:2] if mesh.rank == 0
                             else None}
            state, _ = tpin.make_sharded_state(mesh, BOARD_WINDOW,
                                               PINNED_BLOCK, 3)
            step = tpin.make_sharded_step(
                mesh, block_size=PINNED_BLOCK, masks=[[1, 1, 1]],
                thresholds=[2], combine_any=False)
            for i in range(PINNED_DRAINS):
                step(state, i)
            pinned = gather_pinned_state(mesh, state)
            out["pinned"] = {"digest": _digest(pinned),
                             "value": pinned if mesh.rank == 0 else None}
    _sync(ctx.device)
    out["launches"] = counts()
    with ctx.mesh(*side) as mesh:
        if mesh is not None:
            out["allreduce_ms"] = {
                width: _allreduce_ms(mesh, width, time_iters)
                for width in (256, 4096)}
            out["backend"], out["device"] = mesh.backend, str(mesh.device)
    return out


def board_expectations(device, arms: dict) -> dict:
    """What ``check_board`` must find, from the unsharded port on
    ``device`` and the dict oracles: per arm the per-drain reports'
    digest (the dict tracker's and the unsharded tracker's, which must
    agree) and the unsharded board's digest; the epoch checker's results
    and board; the geo dict oracle's drains; the unsharded union; the
    unsharded pinned drain laid out as the gathered mesh state."""
    from frankenpaxos_tpu_torch.bench.multichip import WorldFailure

    out = {"arms": {}}
    for name, (shape, flexible, slots, pipelined) in arms.items():
        drains = arm_stream(flexible, slots)
        config = tracker_lt.make_config(flexible)
        oracle = replay_by_drain(DictQuorumTracker(config), drains, 3)
        tracker = TpuQuorumTracker(config, window=BOARD_WINDOW,
                                   pipelined=pipelined, device=device)
        unsharded = replay_by_drain(tracker, drains, 3)
        if unsharded != oracle:
            raise WorldFailure(f"{name}: the unsharded tracker differs from "
                               f"the dict oracle")
        out["arms"][name] = {
            "digest": _digest(oracle), "chosen": sum(map(len, oracle)),
            "board_digest": board_digest(convert.vote_board_to_numpy(
                tracker.checker.board))}
    specs, bounds, ops = epoch_script()
    checker = tq.EpochSegmentedChecker(specs, bounds, window=EPOCH_WINDOW,
                                       device=device)
    out["epoch"] = {"digest": _digest(_run_ops(checker, ops)),
                    "board_digest": board_digest(
                        convert.vote_board_to_numpy(checker.board))}
    store, grid, gops = geo_script()
    out["geo"] = {"digest": _digest(run_geo(GeoQuorumTracker(
        store, 0, grid, backend="dict"), store, gops))}
    reduced = convert.depset_to_numpy(td.union_reduce(
        convert.depset_from_jax(*depset_batch(), device=device)))
    out["depset"] = {"digest": _digest(reduced[:2])}
    host = tpin.make_state(BOARD_WINDOW, 3, device=device)
    pred = tq.make_predicate([[1, 1, 1]], [2], False, device=device)
    for i in range(PINNED_DRAINS):
        tpin.steady_state_step(host, i, block_size=PINNED_BLOCK,
                               predicate=pred)
    out["pinned_host"] = {name: t.cpu().numpy() for name, t in
                          zip(tpin.PipelineState._fields, host)}
    return out


def pinned_mismatches(gathered: dict, host: dict, slot_shards: int) -> list:
    """The leaves where the gathered pinned mesh state and the unsharded
    pinned drain's differ, through ``gathered_layout`` (pad columns must
    hold zeros)."""
    w_padded = gathered["votes"].shape[1]
    b_local, _ = tpin.local_block(PINNED_BLOCK, slot_shards)
    logical, valid = tp.gathered_layout(slot_shards, w_padded // slot_shards,
                                        b_local, PINNED_BLOCK)
    bad = []
    for name in ("votes", "chosen", "commands", "results"):
        got = gathered[name]
        if not np.array_equal(got[..., valid][..., np.argsort(
                logical[valid], kind="stable")], host[name]) \
                or got[..., ~valid].any():
            bad.append(name)
    for name in ("sm_state", "committed", "exec_wm"):
        if int(gathered[name]) != int(host[name]):
            bad.append(name)
    return bad


def check_board(world, *, device, arms: Optional[dict] = None,
                side: tuple = (1, 4), compare_calls: int = 8,
                time_iters: int = 50) -> dict:
    """``check_board`` on every rank of ``world`` against
    :func:`board_expectations` on ``device``; raises
    ``multichip.WorldFailure`` when a kernel differs from its plain
    version, a rank answers differently from the others, any result
    differs from the unsharded port's or the dict oracle's, or a kernel
    of the path (K1, K2, K4-K7, the pinned copies) never launched.
    Returns the mesh ranks' results with the expectations' seconds."""
    from frankenpaxos_tpu_torch.bench.multichip import WorldFailure

    arms = BOARD_ARMS if arms is None else arms
    t0 = time.perf_counter()
    want = board_expectations(device, arms)
    expect_s = time.perf_counter() - t0
    ranks = [r for r in world.call(
        "check_board", deadline_s=900, arms=arms, side=side,
        compare_calls=compare_calls, time_iters=time_iters)
        if r is not None]
    bad = []
    for r in ranks:
        if r["errors"] is not None and any(r["errors"].values()):
            bad.append(f"rank {r['rank']}: a kernel differs from its plain "
                       f"version: {r['errors']}")
        for name, arm in r["arms"].items():
            for key in ("digest", "board_digest"):
                if arm[key] != want["arms"][name][key]:
                    bad.append(f"rank {r['rank']}, {name}: the {key} "
                               f"differs from the unsharded tracker's and "
                               f"the dict oracle's")
        for part in ("epoch", "geo", "depset"):
            for key, value in want[part].items():
                if part in r and r[part][key] != value:
                    bad.append(f"rank {r['rank']}, {part}: {key} differs "
                               f"from the unsharded port's")
        if "pinned" in r and r["pinned"]["digest"] != \
                ranks[0]["pinned"]["digest"]:
            bad.append(f"rank {r['rank']}: the pinned state differs")
    lead = next(r for r in ranks if r["rank"] == 0)
    mismatch = pinned_mismatches(lead["pinned"]["value"], want["pinned_host"],
                                 side[1])
    if mismatch:
        bad.append(f"the gathered pinned mesh state differs from the "
                   f"unsharded pinned drain's in {mismatch}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in PATH_WRAPPERS}
    never = [k for k in (*BOARD_KERNELS, *PINNED_KERNELS)
             if launches[k] == 0]
    if never:
        bad.append(f"kernels of the path never launched: {never} "
                   f"({launches})")
    if bad:
        raise WorldFailure("; ".join(bad))
    return {"ranks": ranks, "launches": launches, "expect_s": expect_s,
            "chosen": {n: a["chosen"] for n, a in want["arms"].items()}}


CASES = {
    "check_board": case_check_board,
    "tracker_replay": case_tracker_replay,
    "checker_ops": case_checker_ops,
    "board_ops": case_board_ops,
    "geo_ops": case_geo_ops,
    "depset": case_depset,
    "pinned_drain": case_pinned_drain,
}


def same_on_every_rank(results: list) -> object:
    """Rank 0's value, after checking that every mesh rank's digest
    equals it (raises ``multichip.WorldFailure`` otherwise)."""
    from frankenpaxos_tpu_torch.bench.multichip import WorldFailure

    ranks = [r for r in results if r is not None]
    digests = {r["digest"] for r in ranks}
    if len(digests) != 1:
        raise WorldFailure(f"the ranks answered differently: "
                           f"{[(r['rank'], r['digest'][:8]) for r in ranks]}")
    return ranks[0]["value"]
