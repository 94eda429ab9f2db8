"""The PINNED telemetry-off drain of the port, the overhead baseline.

Counterpart of ``frankenpaxos_tpu/bench/pipeline_baseline.py``
(``steady_state_step`` L76, ``run_steps_from`` L201). This module is a
frozen copy of the port's ``bench/pipeline.py`` hot path without the
telemetry plane: ``PipelineState``, ``make_state``, the plain step and
``run_steps_from``, over its own copy of the K3 source
(``ops/csrc/pipeline_baseline.cu``) behind its own C entry point,
``fpx_run_steps_baseline``. Re-pinned to the chunked design:
a run of drains is ONE packed call of a verbatim copy of K3's chunked
drain kernel, as the live telemetry-off arm's is. It exists for one
purpose: the paired overhead A/B in ``bench/telemetry_overhead.py``
holds the telemetry-OFF arm of the live drain against this copy, so the
baseline arm must be immune to later edits of ``bench/pipeline.py`` and
``ops/csrc/pipeline.cu``.

The mesh form at the end of the module is the pinned drain of the
reference with its axes (``steady_state_step`` L76-80 with
``group_axis`` / ``slot_axis``): a frozen copy of the live sharded
drain's telemetry-off path, over ``ops/csrc/pipeline_sharded_baseline.cu``.

Do NOT edit the function bodies here; they are the measurement. If the
live drain's semantics change on purpose, re-pin a fresh copy and say so
in the overhead bench's methodology string.
"""

from __future__ import annotations

from typing import NamedTuple

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops.quorum import (
    int32,
    make_predicate,
    quorum_hit_plain,
    QuorumPredicate,
    use_kernel,
)
import torch


class PipelineState(NamedTuple):
    votes: torch.Tensor      # [n, window] uint8
    chosen: torch.Tensor     # [window] bool
    commands: torch.Tensor   # [window] int32 proposed command ids
    results: torch.Tensor    # [window] int32 state-machine outputs
    sm_state: torch.Tensor   # [] int32: the replica's running register
    committed: torch.Tensor  # [] int32 committed commands
    exec_wm: torch.Tensor    # [] int32 executed watermark (global slots)


_STATE_DTYPES = (torch.uint8, torch.bool) + (torch.int32,) * 5


def make_state(window: int, num_acceptors: int,
               device=None) -> PipelineState:
    """A fresh pipeline state on ``device`` (``cuda`` when None; raises
    without a GPU)."""
    device = resolve_device(device)

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)

    return PipelineState(
        votes=torch.zeros((num_acceptors, window), dtype=torch.uint8,
                          device=device),
        chosen=torch.zeros((window,), dtype=torch.bool, device=device),
        commands=torch.zeros((window,), dtype=torch.int32, device=device),
        results=torch.zeros((window,), dtype=torch.int32, device=device),
        sm_state=scalar(), committed=scalar(), exec_wm=scalar())


def _wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _arrivals(i: int, lanes: torch.Tensor, accs: torch.Tensor,
              salt: int) -> torch.Tensor:
    """Deterministic pseudo-random ``[len(accs), len(lanes)]`` uint8
    arrival mask, in int32 arithmetic that wraps as the reference's."""
    step = torch.tensor(_wrap32(i + salt), dtype=torch.int32,
                        device=lanes.device)
    h = (lanes[None, :] * 1103515245 + accs[:, None] * 12820163
         + step * 22695477) >> 7
    return ((h & 7) < 7).to(torch.uint8)  # ~87.5% arrive this drain


def steady_state_step_plain(state: PipelineState, i: int, block_size: int,
                            pred: QuorumPredicate) -> PipelineState:
    """The pinned plain drain: propose, pass 1 on the new block, pass 2
    on the old block, execute, GC, updating ``state`` in place."""
    votes, chosen, commands, results = state[:4]
    n, w = votes.shape
    b = block_size
    num_blocks = w // b
    dev = votes.device
    i_t = torch.tensor(i, dtype=torch.int32, device=dev)
    lanes = torch.arange(b, dtype=torch.int32, device=dev)
    accs = torch.arange(n, dtype=torch.int32, device=dev)
    start_new = (i % num_blocks) * b
    start_old = (_wrap32(i - 1) % num_blocks) * b
    start_gc = (_wrap32(i - 2) % num_blocks) * b

    commands[start_new:start_new + b] = lanes * 7 + i_t * 13 + 1

    def quorum_pass(start, arrivals):
        cols = slice(start, start + b)
        block = votes[:, cols] | arrivals
        votes[:, cols] = block
        hit = quorum_hit_plain(block, pred)
        old = chosen[cols].clone()
        chosen[cols] = hit | old
        state.committed.add_((hit & ~old).sum(dtype=torch.int32))

    quorum_pass(start_new, _arrivals(i, lanes, accs, salt=0))
    quorum_pass(start_old, 1 - _arrivals(_wrap32(i - 1), lanes, accs,
                                         salt=0))
    cmds_old = commands[start_old:start_old + b].clone()
    results[start_old:start_old + b] = cmds_old * 3 + 7
    state.sm_state.add_(cmds_old.sum(dtype=torch.int32))
    state.exec_wm.copy_(i_t * b if i >= 1 else torch.zeros_like(i_t))
    votes[:, start_gc:start_gc + b] = 0
    chosen[start_gc:start_gc + b] = False
    return state


#: Drains per launch at most (``pipeline_baseline.cu``'s ``kMaxDrains``).
MAX_DRAINS = 1 << 16

#: The packed entry: ``fpx_run_steps``'s 24 int64 slots.
_K3 = _build.Entry("pipeline_baseline", "fpx_run_steps_baseline", 24)


def _run(state: PipelineState, start: int, iters: int, block_size: int,
         predicate: QuorumPredicate) -> PipelineState:
    """The pinned run: drains ``start`` .. ``start + iters - 1`` (the
    index wrapping as int32) applied to ``state`` IN PLACE. CUDA state
    makes ONE packed call of ``csrc/pipeline_baseline.cu`` per launch of
    at most :data:`MAX_DRAINS` drains (counted in
    ``steady_state_step.launches`` and ``.drains``); CPU state loops
    :func:`steady_state_step_plain`. Never synchronises."""
    tensors = state[:7]
    votes = state.votes
    n, window = votes.shape
    if block_size <= 0 or window % block_size:
        raise ValueError(f"window {window} must hold whole "
                         f"{block_size}-slot blocks")
    if n != predicate.num_nodes:
        raise ValueError(f"state has {n} acceptors, predicate has "
                         f"{predicate.num_nodes}")
    if tuple(t.dtype for t in tensors) != _STATE_DTYPES \
            or tuple(t.shape for t in tensors[1:]) != (
                (window,),) * 3 + ((),) * 3:
        raise ValueError("state tensors do not match make_state's")
    start = int32(start)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not use_kernel(*tensors, predicate.masks):
        for k in range(iters):
            steady_state_step_plain(state, _wrap32(start + k), block_size,
                                    predicate)
        return state
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the drain kernel needs contiguous tensors")
    index = votes.get_device()
    stream = _build.stream_handle(index)
    fn = _K3.fn or _K3.resolve()
    head = (*(t.data_ptr() for t in tensors), window, block_size)
    pred_args = predicate.c_args()
    while iters > 0:
        k = min(iters, MAX_DRAINS)
        rc = fn(_K3.pack(*head, start, k, *pred_args, 0, 0, index, stream))
        if rc:
            _K3.check(rc)
        steady_state_step.launches += 1
        steady_state_step.drains += k
        start, iters = _wrap32(start + k), iters - k
    return state


def steady_state_step(state: PipelineState, i: int, *, block_size: int,
                      predicate: QuorumPredicate) -> PipelineState:
    """The pinned K3: one drain applied to ``state`` IN PLACE, the run of
    one."""
    return _run(state, i, 1, block_size, predicate)


steady_state_step.launches = 0
steady_state_step.drains = 0


def run_steps_from(state: PipelineState, start: int, iters: int,
                   block_size: int, masks_t: tuple, thresholds_t: tuple,
                   combine_any: bool) -> PipelineState:
    """The pinned chunked runner: ``iters`` drains from drain ``start``
    in one launch (one per :data:`MAX_DRAINS` drains), without
    synchronising; ``state`` in place. The predicate is made and
    uploaded once per spec and device, as the live runner's is."""
    key = (tuple(map(tuple, masks_t)), tuple(thresholds_t),
           bool(combine_any), state.votes.device)
    pred = _PREDICATES.get(key)
    if pred is None:
        pred = _PREDICATES[key] = make_predicate(
            masks_t, thresholds_t, combine_any, device=key[3])
    return _run(state, start, iters, block_size, pred)


#: ``{(masks_t, thresholds_t, combine_any, device): QuorumPredicate}``.
_PREDICATES: dict = {}


# --------------------------------------------------------------------------
# The pinned drain's mesh form: the reference's pinned ``steady_state_step``
# with ``group_axis`` / ``slot_axis`` (L76-80) as ``shard_map`` runs it,
# split at its psums into three phases around two all-reduces, over its
# own copies of the telemetry-off K19-K21 (``ops/csrc/
# pipeline_sharded_baseline.cu``, entries ``fpx_shard_*_baseline``). A
# frozen copy of the live sharded drain's telemetry-off path
# (``bench/pipeline.py``), immune to later redesigns of that path, as the
# unsharded drain above is to ``pipeline.cu``.
# --------------------------------------------------------------------------


def local_block(block_size: int, slot_shards: int) -> tuple:
    """``(b_local, pad)``: lanes per slot shard (the global block rounded
    UP over the slot shards) and the pad lanes the rounding adds."""
    b_local = -(-block_size // slot_shards)
    return b_local, b_local * slot_shards - block_size


def padded_window(window: int, block_size: int, slot_shards: int) -> int:
    """The padded GLOBAL window of a sharded run (whole ``b_local``
    blocks per shard)."""
    if window % block_size:
        raise ValueError(
            f"window {window} must hold whole {block_size}-slot blocks")
    b_local, _ = local_block(block_size, slot_shards)
    return (window // block_size) * b_local * slot_shards


#: The shard's quorum partials: the psum'd mask matmul, or the missing
#: (write grid) / full (read grid) row counts of the fused grid path.
MATMUL, GRID_WRITE, GRID_READ = 0, 1, 2


class ShardPlan(NamedTuple):
    """One rank's place in the mesh, its widths, its slice of the
    predicate and the two partial buffers the all-reduces carry."""

    group_shards: int
    slot_shards: int
    group_idx: int
    slot_idx: int
    block_size: int          # GLOBAL block
    b_local: int
    n_local: int
    kind: int                # MATMUL, GRID_WRITE or GRID_READ
    cols: int                # grid row length (grid kinds)
    masks: torch.Tensor      # [G, n_local] int32: this shard's columns
    thresholds: torch.Tensor  # [G] int32
    combine_any: bool
    parts: torch.Tensor      # [2, R, b_local] int32: per pass, R rows
    slot: torch.Tensor       # [S + 1] int32, 0 between drains


def make_shard_plan(mesh, block_size: int,
                    predicate: QuorumPredicate) -> ShardPlan:
    """This rank's plan for ``predicate`` (GLOBAL masks on the mesh's
    device): the fused grid path when the spec is a row-major grid and
    every group shard holds whole rows, else the psum'd matmul."""
    g_sh, s_sh = mesh.group_shards, mesh.slot_shards
    n_global = predicate.num_nodes
    if n_global % g_sh:
        raise ValueError(f"{n_global} acceptors do not split over "
                         f"{g_sh} group shards")
    n_local = n_global // g_sh
    b_local, _ = local_block(block_size, s_sh)
    kind, cols, grid = MATMUL, 0, predicate.grid
    if grid is not None and grid[3] is None and n_local % grid[2] == 0:
        kind = GRID_WRITE if grid[0] == "write" else GRID_READ
        cols = grid[2]
    gi = mesh.group_idx
    masks = predicate.masks[:, gi * n_local:(gi + 1) * n_local].contiguous()
    rows = masks.shape[0] if kind == MATMUL else 1
    dev = predicate.masks.device
    return ShardPlan(
        group_shards=g_sh, slot_shards=s_sh, group_idx=gi,
        slot_idx=mesh.slot_idx, block_size=block_size, b_local=b_local,
        n_local=n_local, kind=kind, cols=cols, masks=masks,
        thresholds=predicate.thresholds, combine_any=predicate.combine_any,
        parts=torch.zeros((2, rows, b_local), dtype=torch.int32,
                          device=dev),
        slot=torch.zeros(s_sh + 1, dtype=torch.int32, device=dev))


def make_sharded_state(mesh, window: int, block_size: int,
                       num_acceptors: int, device=None) -> tuple:
    """``(state, w_padded)``: this rank's fresh shard of a GLOBAL
    ``window`` (padded when the block does not divide over the slot
    shards): votes ``[n / group, w_padded / slot]``, the slot columns
    ``[w_padded / slot]``, the scalars whole."""
    device = mesh.device if device is None else torch.device(device)
    if num_acceptors % mesh.group_shards:
        raise ValueError(f"{num_acceptors} acceptors do not split over "
                         f"{mesh.group_shards} group shards")
    w_padded = padded_window(window, block_size, mesh.slot_shards)
    return make_state(w_padded // mesh.slot_shards,
                      num_acceptors // mesh.group_shards,
                      device=device), w_padded


def _check_shard(state: PipelineState, plan: ShardPlan) -> int:
    tensors = state[:7]
    n, w_local = state.votes.shape
    if n != plan.n_local or w_local % plan.b_local or not w_local:
        raise ValueError(f"a [{n}, {w_local}] board is not a shard of "
                         f"{plan.n_local} acceptor rows and whole "
                         f"{plan.b_local}-lane blocks")
    if tuple(t.dtype for t in tensors) != _STATE_DTYPES \
            or tuple(t.shape for t in tensors[1:]) != (
                (w_local,),) * 3 + ((),) * 3:
        raise ValueError("state tensors do not match make_sharded_state's")
    return w_local


def _ring(i: int, w_local: int, b_local: int) -> tuple:
    num_blocks = w_local // b_local
    return tuple((_wrap32(i - k) % num_blocks) * b_local for k in range(3))


def _shard_lanes(plan: ShardPlan, device) -> tuple:
    lanes = plan.slot_idx * plan.b_local + torch.arange(
        plan.b_local, dtype=torch.int32, device=device)
    return lanes, lanes < plan.block_size


def shard_vote_count_plain(state: PipelineState, i: int,
                           plan: ShardPlan) -> torch.Tensor:
    """Plain version of the pinned K19: propose on the shard's lanes, OR
    each pass's arrivals (pad lanes get none) into its block and write
    its partials into ``plan.parts``."""
    votes, commands = state.votes, state.commands
    dev = votes.device
    n_local, w_local = votes.shape
    b = plan.b_local
    start_new, start_old, _ = _ring(i, w_local, b)
    lanes, valid = _shard_lanes(plan, dev)
    accs = plan.group_idx * n_local + torch.arange(
        n_local, dtype=torch.int32, device=dev)
    i_t = torch.tensor(i, dtype=torch.int32, device=dev)
    commands[start_new:start_new + b] = torch.where(
        valid, lanes * 7 + i_t * 13 + 1, torch.zeros_like(lanes))
    mask = valid.to(torch.uint8)[None, :]
    passes = ((start_new, _arrivals(i, lanes, accs, salt=0)),
              (start_old, 1 - _arrivals(_wrap32(i - 1), lanes, accs,
                                        salt=0)))
    for p, (start, arrivals) in enumerate(passes):
        cols = slice(start, start + b)
        block = votes[:, cols] | (arrivals & mask)
        votes[:, cols] = block
        out = plan.parts[p]
        if plan.kind == MATMUL:
            out[:] = (plan.masks[:, :, None]
                      * block.to(torch.int32)[None]).sum(1, dtype=torch.int32)
        else:
            write = plan.kind == GRID_WRITE
            total = torch.zeros_like(block[0])
            for r in range(plan.n_local // plan.cols):
                row = block[r * plan.cols]
                for c in range(1, plan.cols):
                    cell = block[r * plan.cols + c]
                    row = (row | cell) if write else (row & cell)
                total = total + ((1 - row) if write else row)
            out[0] = total.to(torch.int32)
    return plan.parts


def shard_commit_plain(state: PipelineState, i: int,
                       plan: ShardPlan) -> torch.Tensor:
    """Plain version of the pinned K20: each pass's hits from the
    group-reduced partials (never on a pad lane), ``chosen``, execution
    of the old block and GC; the newly count and the ``cmds_old`` sum
    are added into ``plan.slot``."""
    votes, chosen, commands, results = state[:4]
    w_local = votes.shape[1]
    b, s_sh = plan.b_local, plan.slot_shards
    start_new, start_old, start_gc = _ring(i, w_local, b)
    _, valid = _shard_lanes(plan, votes.device)
    for p, start in enumerate((start_new, start_old)):
        part = plan.parts[p]
        if plan.kind == MATMUL:
            satisfied = part >= plan.thresholds[:, None]
            hit = satisfied.any(0) if plan.combine_any else satisfied.all(0)
        else:
            hit = part[0] == 0 if plan.kind == GRID_WRITE else part[0] > 0
        hit = hit & valid
        cols = slice(start, start + b)
        old = chosen[cols].clone()
        chosen[cols] = hit | old
        plan.slot[plan.slot_idx] += (hit & ~old).sum(dtype=torch.int32)
    cmds_old = commands[start_old:start_old + b].clone()
    results[start_old:start_old + b] = torch.where(
        valid, cmds_old * 3 + 7, torch.zeros_like(cmds_old))
    plan.slot[s_sh] += cmds_old.sum(dtype=torch.int32)
    votes[:, start_gc:start_gc + b] = 0
    chosen[start_gc:start_gc + b] = False
    return plan.slot


def shard_fold_plain(state: PipelineState, i: int,
                     plan: ShardPlan) -> PipelineState:
    """Plain version of the pinned K21: fold the slot-reduced
    ``plan.slot`` into committed, sm_state and exec_wm (the GLOBAL
    block), then zero it."""
    s_sh, slot = plan.slot_shards, plan.slot
    i_t = torch.tensor(i, dtype=torch.int32, device=slot.device)
    state.committed.add_(slot[:s_sh].sum(dtype=torch.int32))
    state.sm_state.add_(slot[s_sh])
    state.exec_wm.copy_(i_t * plan.block_size if i >= 1
                        else torch.zeros_like(i_t))
    slot.zero_()
    return state


def _shard_kernel(plan: ShardPlan, *tensors: torch.Tensor) -> bool:
    return use_kernel(*tensors, plan.masks, plan.thresholds, plan.parts,
                      plan.slot)


def shard_vote_count(state: PipelineState, i: int,
                     plan: ShardPlan) -> torch.Tensor:
    """The pinned K19 (``fpx_shard_vote_count_baseline``) on CUDA state,
    counted in ``shard_vote_count.launches``; the plain version on CPU
    state. Never synchronises."""
    w_local = _check_shard(state, plan)
    i = int32(i)
    if not _shard_kernel(plan, state.votes, state.commands):
        return shard_vote_count_plain(state, i, plan)
    lib = _build.library("pipeline_sharded_baseline")
    rc = lib.fpx_shard_vote_count_baseline(
        state.votes.data_ptr(), state.commands.data_ptr(), w_local, i,
        plan.block_size, plan.b_local, plan.slot_idx, plan.group_idx,
        plan.n_local, plan.kind, plan.masks.shape[0], plan.cols,
        plan.masks.data_ptr(), plan.parts.data_ptr(),
        *_build.stream_args(state.votes.device))
    _build.check("pipeline_sharded_baseline",
                 "fpx_shard_vote_count_baseline", rc)
    shard_vote_count.launches += 1
    return plan.parts


def shard_commit(state: PipelineState, i: int,
                 plan: ShardPlan) -> torch.Tensor:
    """The pinned K20 (``fpx_shard_commit_baseline``) on CUDA state,
    counted in ``shard_commit.launches``; the plain version on CPU
    state. Never synchronises."""
    w_local = _check_shard(state, plan)
    i = int32(i)
    tensors = state[:4]
    if not _shard_kernel(plan, *tensors):
        return shard_commit_plain(state, i, plan)
    lib = _build.library("pipeline_sharded_baseline")
    rc = lib.fpx_shard_commit_baseline(
        *(t.data_ptr() for t in tensors), w_local, i, plan.block_size,
        plan.b_local, plan.slot_idx, plan.slot_shards, plan.n_local,
        plan.kind, plan.masks.shape[0], plan.thresholds.data_ptr(),
        int(plan.combine_any), plan.parts.data_ptr(), plan.slot.data_ptr(),
        *_build.stream_args(state.votes.device))
    _build.check("pipeline_sharded_baseline", "fpx_shard_commit_baseline",
                 rc)
    shard_commit.launches += 1
    return plan.slot


def shard_fold(state: PipelineState, i: int,
               plan: ShardPlan) -> PipelineState:
    """The pinned K21 (``fpx_shard_fold_baseline``) on CUDA state, counted
    in ``shard_fold.launches``; the plain version on CPU state. Never
    synchronises."""
    _check_shard(state, plan)
    i = int32(i)
    scalars = state[4:7]
    if not _shard_kernel(plan, *scalars):
        return shard_fold_plain(state, i, plan)
    lib = _build.library("pipeline_sharded_baseline")
    rc = lib.fpx_shard_fold_baseline(
        *(t.data_ptr() for t in scalars), i, plan.block_size,
        plan.slot_shards, plan.slot.data_ptr(),
        *_build.stream_args(state.votes.device))
    _build.check("pipeline_sharded_baseline", "fpx_shard_fold_baseline", rc)
    shard_fold.launches += 1
    return state


shard_vote_count.launches = 0
shard_commit.launches = 0
shard_fold.launches = 0


def _sharded(mesh, state: PipelineState, i: int, plan: ShardPlan,
             phases: tuple) -> PipelineState:
    vote_count, commit, fold = phases
    vote_count(state, i, plan)
    mesh.psum_group(plan.parts)
    commit(state, i, plan)
    mesh.psum_slot(plan.slot)
    fold(state, i, plan)
    return state


def sharded_step(mesh, state: PipelineState, i: int,
                 plan: ShardPlan) -> PipelineState:
    """One pinned drain on this rank's shard, IN PLACE: the K19 copy, the
    group all-reduce, the K20 copy, the slot all-reduce, the K21 copy
    (each phase's plain version on CPU state). Every rank of the mesh
    calls it with the same ``i``."""
    _check_shard(state, plan)
    return _sharded(mesh, state, int32(i), plan,
                    (shard_vote_count, shard_commit, shard_fold))


def sharded_step_plain(mesh, state: PipelineState, i: int,
                       plan: ShardPlan) -> PipelineState:
    """:func:`sharded_step` with the three phases' plain versions, on any
    device."""
    _check_shard(state, plan)
    return _sharded(mesh, state, int32(i), plan,
                    (shard_vote_count_plain, shard_commit_plain,
                     shard_fold_plain))


def make_sharded_step(mesh, *, block_size: int, masks, thresholds,
                      combine_any: bool):
    """``step(state, i)``: one pinned drain on this rank's shard, in
    place; ``block_size`` and ``masks`` are GLOBAL, the plan is
    ``step.plan``."""
    plan = make_shard_plan(mesh, block_size, make_predicate(
        masks, thresholds, combine_any, device=mesh.device))

    def step(state: PipelineState, i: int) -> PipelineState:
        return sharded_step(mesh, state, i, plan)

    step.plan = plan
    return step
