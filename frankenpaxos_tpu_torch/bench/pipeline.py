"""The device-resident MultiPaxos steady-state pipeline on one GPU.

Counterpart of ``frankenpaxos_tpu/bench/pipeline.py`` (unsharded): the
steady-state Phase-2 write path of compartmentalized MultiPaxos --
propose -> acceptor votes -> quorum check -> chosen -> replica execute
-> GC -- over a ``[acceptors, window]`` vote board. A RUN of drains is
ONE launch of the hand-written chunked drain kernel K3
(``ops/csrc/pipeline.cu``, ``run_steps_kernel<false>``), or of its
telemetry-on twin K14 when the state carries the telemetry plane
(``ops/telemetry.py``: ``make_state(telemetry=True)``), as the
reference runs its drains in one jitted ``lax.fori_loop``; a single
drain is a run of one. Every run updates the :class:`PipelineState`
tensors IN PLACE. Vote arrivals are the reference's hash of (drain,
block lane, acceptor), so both packages produce the same votes for the
same slot: ~87.5% of votes arrive in the drain after the proposal, the
rest one drain later.

The sharded drain (the reference's ``make_sharded_step`` /
``make_sharded_runner``) runs the same drain over a ``(group, slot)``
mesh of ``torch.distributed`` ranks (``frankenpaxos_tpu_torch.mesh``):
each rank holds one shard of the board -- acceptor rows over ``group``,
the slot window over ``slot`` -- and a drain is split at the reference's
psums (``ops/csrc/pipeline_sharded.cu``): K19 :func:`shard_vote_count`
writes this shard's quorum partials, one all-reduce over the group
subgroup sums them, and K20 :func:`shard_commit` decides, executes and
adds the slot partials into the drain's row of the plan's slot table. A
RUN of drains (:func:`sharded_run`, the runner of
:func:`make_sharded_runner`) does that for each drain, then ONE
all-reduce of the used rows over the slot subgroup and ONE K21
:func:`shard_fold`, which folds the rows in drain order into the
replicated scalars and counters: nothing inside a run reads what the
slot all-reduce produces, so the state after a run is the reference's
after its per-drain psums. A single drain (:func:`sharded_step`) is the
run of one. A block that does not divide over the slot shards pads
every block (:func:`local_block`); the pad lanes are masked out of every
effect, so the gathered state equals the unsharded one through
:func:`gathered_layout`.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.mesh import Mesh
from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops.quorum import (
    int32,
    make_predicate,
    quorum_hit_plain,
    QuorumPredicate,
    use_kernel,
)
from frankenpaxos_tpu_torch.ops.telemetry import (
    buffer_words,
    close_drain,
    drain_deltas,
    lag_bucket,
    make_telemetry,
    pass_deltas,
    quorum_pass_update,
    TELEMETRY_PARTITION,
    TelemetryState,
)
import numpy as np
import torch
import torch.distributed as dist

#: Drains per launch at most (``pipeline.cu``'s ``kMaxDrains``: K14's
#: scratch holds one int32 per drain); a longer run is split into
#: launches of this many drains.
MAX_DRAINS = 1 << 16


class PipelineState(NamedTuple):
    votes: torch.Tensor      # [n, window] uint8
    chosen: torch.Tensor     # [window] bool
    commands: torch.Tensor   # [window] int32 proposed command ids
    results: torch.Tensor    # [window] int32 state-machine outputs
    sm_state: torch.Tensor   # [] int32: the replica's running register
    committed: torch.Tensor  # [] int32 committed commands
    exec_wm: torch.Tensor    # [] int32 executed watermark (global slots)
    # The telemetry counters (ops/telemetry.py); None means the plane is
    # OFF and the drain launches K3, which carries none.
    telemetry: Optional[TelemetryState] = None


_STATE_DTYPES = (torch.uint8, torch.bool) + (torch.int32,) * 5


def make_state(window: int, num_acceptors: int, *, telemetry: bool = False,
               slot_shards: int = 1, device=None) -> PipelineState:
    """A fresh pipeline state on ``device`` (``cuda`` when None; raises
    without a GPU), with zeroed telemetry counters over ``slot_shards``
    slot shards when ``telemetry``. The unsharded drain takes one slot
    shard; :func:`make_sharded_state` builds a shard's state for more."""
    device = resolve_device(device)

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)

    return PipelineState(
        votes=torch.zeros((num_acceptors, window), dtype=torch.uint8,
                          device=device),
        chosen=torch.zeros((window,), dtype=torch.bool, device=device),
        commands=torch.zeros((window,), dtype=torch.int32, device=device),
        results=torch.zeros((window,), dtype=torch.int32, device=device),
        sm_state=scalar(), committed=scalar(), exec_wm=scalar(),
        telemetry=(make_telemetry(num_acceptors, slot_shards, device=device)
                   if telemetry else None))


def _wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _arrivals(i: int, lanes: torch.Tensor, accs: torch.Tensor,
              salt: int) -> torch.Tensor:
    """Deterministic pseudo-random ``[len(accs), len(lanes)]`` uint8
    arrival mask (the reference's ``_arrivals``), in int32 arithmetic
    that wraps as the reference's does: the drain's term is wrapped to
    int32 on the host and added to int32 tensors, so no scalar is copied
    to the device (and no copy waits for it)."""
    step = _wrap32(_wrap32(i + salt) * 22695477)
    h = (lanes[None, :] * 1103515245 + accs[:, None] * 12820163 + step) >> 7
    return ((h & 7) < 7).to(torch.uint8)  # ~87.5% arrive this drain


def _drain_plain(state: PipelineState, i: int, block_size: int,
                 pred: QuorumPredicate) -> torch.Tensor:
    """One drain of the plain version in the reference's order (propose,
    pass 1 on the new block, pass 2 on the old block, execute, GC),
    updating ``state`` in place, with every telemetry counter but the
    once-per-drain lag sample and drain count; returns the drain's int32
    newly-chosen count. The drain index enters as int32 values wrapped
    on the host: nothing here waits for the device."""
    votes, chosen, commands, results = state[:4]
    n, w = votes.shape
    b = block_size
    num_blocks = w // b
    dev = votes.device
    lanes = torch.arange(b, dtype=torch.int32, device=dev)
    accs = torch.arange(n, dtype=torch.int32, device=dev)
    start_new = (i % num_blocks) * b
    start_old = (_wrap32(i - 1) % num_blocks) * b
    start_gc = (_wrap32(i - 2) % num_blocks) * b

    tel = state.telemetry
    total = torch.zeros((), dtype=torch.int32, device=dev)

    # Leader: assign slots, propose command ids.
    proposed = lanes * 7 + _wrap32(i * 13 + 1)
    commands[start_new:start_new + b] = proposed

    def quorum_pass(start, arrivals):
        cols = slice(start, start + b)
        block = votes[:, cols] | arrivals
        votes[:, cols] = block
        hit = quorum_hit_plain(block, pred)
        old = chosen[cols].clone()
        chosen[cols] = hit | old
        newly = hit & ~old
        count = newly.sum(dtype=torch.int32)
        state.committed.add_(count)
        total.add_(count)
        if tel is not None:
            quorum_pass_update(tel, newly=newly, slot_axis=None,
                               votes_count=block.sum(0, dtype=torch.int32))

    # Acceptors + ProxyLeader: pass 1 on the new block, pass 2 (the
    # stragglers of drain i-1) on the previous one.
    quorum_pass(start_new, _arrivals(i, lanes, accs, salt=0))
    quorum_pass(start_old, 1 - _arrivals(_wrap32(i - 1), lanes, accs,
                                         salt=0))
    # Replica: execute the now fully-chosen previous block.
    cmds_old = commands[start_old:start_old + b].clone()
    results[start_old:start_old + b] = cmds_old * 3 + 7
    state.sm_state.add_(cmds_old.sum(dtype=torch.int32))
    state.exec_wm.fill_(_wrap32(i * b) if i >= 1 else 0)
    # GC: release block i-2 so the ring can wrap.
    votes[:, start_gc:start_gc + b] = 0
    chosen[start_gc:start_gc + b] = False
    # Telemetry: the drain's nonzero proposals.
    if tel is not None:
        tel.proposed.add_(drain_deltas(proposed, None)[0])
    return total


def steady_state_step_plain(state: PipelineState, i: int, block_size: int,
                            pred: QuorumPredicate) -> PipelineState:
    """Plain PyTorch version of K3 and K14, one drain (the per-drain
    reference): :func:`_drain_plain`, then, with telemetry on, the
    end-of-drain watermark lag sampled and the drain counted where the
    reference's ``drain_update`` does both."""
    _drain_plain(state, i, block_size, pred)
    if state.telemetry is not None:
        close_drain(state.telemetry,
                    _wrap32((i + 1) * block_size) - state.committed)
    return state


def fold_lag_plain(tel: TelemetryState, committed: torch.Tensor,
                   newly: torch.Tensor, start: int,
                   block_size: int) -> TelemetryState:
    """Plain PyTorch version of K14's once-per-launch fold, in place: from
    ``newly`` (the ``[iters]`` int32 newly-chosen counts of drains
    ``start`` ..., the index wrapping as int32) and the END-of-run
    ``committed``, the run's starting committed (the final value minus
    the run's sum, mod 2^32), each drain's end-of-drain committed by
    prefix sums (int32, wrapping), one :func:`lag_bucket` sample of each
    drain's lag ``(i + 1) * block_size - committed`` and the drain
    count. The arithmetic is int64 cut to int32, as the kernel's uint32."""
    counts = newly.to(torch.int64)
    iters = counts.numel()
    ends = committed.to(torch.int64) - counts.sum() + counts.cumsum(0)
    drains = torch.arange(iters, dtype=torch.int64, device=counts.device)
    lag = ((start + drains + 1) * block_size - ends + 2**31) % 2**32 - 2**31
    buckets = lag_bucket(lag.to(torch.int32)).long()
    tel.lag_hist.scatter_add_(0, buckets, torch.ones_like(buckets,
                                                          dtype=torch.int32))
    tel.drains.add_(_wrap32(iters))
    return tel


def run_steps_plain(state: PipelineState, start: int, iters: int,
                    block_size: int, pred: QuorumPredicate) -> PipelineState:
    """Plain PyTorch version of one launch of K3 / K14: drains ``start``
    .. ``start + iters - 1`` (the index wrapping as int32) by
    :func:`_drain_plain`, collecting the per-drain newly counts; with
    telemetry on, the lags are then folded in at once by
    :func:`fold_lag_plain`, as the kernel folds them."""
    newly = [_drain_plain(state, _wrap32(start + k), block_size, pred)
             for k in range(iters)]
    if state.telemetry is not None and newly:
        fold_lag_plain(state.telemetry, state.committed, torch.stack(newly),
                       start, block_size)
    return state


def _kernel_args(state: PipelineState, block_size: int,
                 predicate: QuorumPredicate) -> tuple:
    """The tensors the drain kernel takes -- K3's seven, then the flat
    telemetry buffer when the state carries one -- and the board's
    ``(n, window)``, after the checks K3 and K14 share. The buffer needs
    only what K14's writes need (contiguous int32 of ``n + 22`` words:
    one slot shard, ``n + 1`` occupancy bins), read from its attributes;
    ``collect`` checks the counter views in full
    (:func:`~frankenpaxos_tpu_torch.ops.telemetry.flat_buffer`)."""
    tensors = state[:7]
    n, window = state.votes.shape
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
    tel = state.telemetry
    if tel is None:
        return tensors, n, window
    buffer = tel.buffer
    if buffer is None or buffer.dtype != torch.int32 \
            or not buffer.is_contiguous() or buffer.numel() != buffer_words(n):
        if tel.shard_committed.numel() != 1:
            raise ValueError(
                "telemetry over several slot shards is the sharded drain's: "
                "run it under make_sharded_step")
        raise ValueError(f"the telemetry state does not hold the flat "
                         f"int32 buffer make_telemetry builds for {n} "
                         f"acceptors")
    return tensors + (buffer,), n, window


#: The packed entries: 24 int64 slots each (``pipeline.cu``'s block).
_K3 = _build.Entry("pipeline", "fpx_run_steps", 24)
_K14 = _build.Entry("pipeline", "fpx_run_steps_telemetry", 24)

#: ``{(card index, stream handle): [capacity] int32}``: K14's scratch, one
#: int32 per drain of a launch, zero between launches (the kernel's last
#: block zeroes what it used). Per stream, so that runs on two streams
#: never share one.
_SCRATCH: dict = {}


def _scratch(index: int, stream: int, iters: int,
             device: torch.device) -> int:
    key = (index, stream)
    got = _SCRATCH.get(key)
    if got is None or got.numel() < iters:
        got = _SCRATCH[key] = torch.zeros(
            1 << max(6, (iters - 1).bit_length()), dtype=torch.int32,
            device=device)
    return got.data_ptr()


def _run(state: PipelineState, start: int, iters: int, block_size: int,
         pred: QuorumPredicate) -> PipelineState:
    """Drains ``start`` .. ``start + iters - 1`` (the index wrapping as
    int32) on ``state``, in place: on CUDA state ONE packed C call per
    launch of at most :data:`MAX_DRAINS` drains, K3 (counted in
    ``steady_state_step.launches`` and ``.drains``) or, with telemetry,
    K14 (``telemetry_drain.launches`` and ``.drains``); on CPU state
    :func:`run_steps_plain`. Never synchronises."""
    tensors, n, window = _kernel_args(state, block_size, pred)
    start = int32(start)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not use_kernel(*tensors, pred.masks):
        return run_steps_plain(state, start, iters, block_size, pred)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the drain kernel needs contiguous tensors")
    index = state.votes.get_device()
    stream = _build.stream_handle(index)
    if state.telemetry is None:
        entry, counter, tel = _K3, steady_state_step, 0
    else:
        entry, counter = _K14, telemetry_drain
        tel = tensors[7].data_ptr()
    fn = entry.fn or entry.resolve()
    head = (*(t.data_ptr() for t in tensors[:7]), window, block_size)
    pred_args = pred.c_args()
    while iters > 0:
        k = min(iters, MAX_DRAINS)
        scratch = 0 if tel == 0 else _scratch(index, stream, k,
                                               state.votes.device)
        rc = fn(entry.pack(*head, start, k, *pred_args, tel, scratch, index,
                           stream))
        if rc:
            entry.check(rc)
        counter.launches += 1
        counter.drains += k
        start, iters = _wrap32(start + k), iters - k
    return state


def steady_state_step(state: PipelineState, i: int, *, block_size: int,
                      predicate: QuorumPredicate) -> PipelineState:
    """One event-loop drain -- new proposals + straggler completion --
    applied to ``state`` IN PLACE (the reference donates it); returns
    ``state``: the run of one drain.

    ``i`` is the drain index (an int32 value). ``predicate`` comes from
    :func:`~frankenpaxos_tpu_torch.ops.quorum.make_predicate` on the
    state's device. CUDA state launches K3 (``run_steps_kernel<false>``)
    or, when the state carries telemetry, K14 (``<true>``) with
    ``iters = 1``; CPU state takes :func:`run_steps_plain`. Never
    synchronises."""
    return _run(state, i, 1, block_size, predicate)


#: K3's counts: launches, and drains over all its launches.
steady_state_step.launches = 0
steady_state_step.drains = 0
#: K14's counts: :func:`steady_state_step` and :func:`run_steps_from`
#: launch K14 on a state that carries telemetry and count it here.
telemetry_drain = SimpleNamespace(launches=0, drains=0)

#: ``{(masks_t, thresholds_t, combine_any, device): QuorumPredicate}``:
#: each predicate made and uploaded once.
_PREDICATES: dict = {}


def predicate_for(masks_t, thresholds_t, combine_any: bool,
                  device) -> QuorumPredicate:
    """The predicate of a spec's arrays on ``device``, made (and copied
    to the device) at its first use and reused after."""
    key = (tuple(map(tuple, masks_t)), tuple(thresholds_t),
           bool(combine_any), torch.device(device))
    pred = _PREDICATES.get(key)
    if pred is None:
        pred = _PREDICATES[key] = make_predicate(masks_t, thresholds_t,
                                                 combine_any, device=key[3])
    return pred


def run_steps(state: PipelineState, iters: int, block_size: int,
              masks_t: tuple, thresholds_t: tuple,
              combine_any: bool) -> PipelineState:
    """``iters`` drains from drain 0 (the bench hot loop) in one launch
    (one per :data:`MAX_DRAINS` drains), without synchronising; ``state``
    is updated in place."""
    return run_steps_from(state, 0, iters, block_size, masks_t,
                          thresholds_t, combine_any)


def run_steps_from(state: PipelineState, start: int, iters: int,
                   block_size: int, masks_t: tuple, thresholds_t: tuple,
                   combine_any: bool) -> PipelineState:
    """:func:`run_steps` from drain ``start``: chunked runs resume the
    drain counter where the previous chunk left off (ring positions and
    arrival hashes continue instead of replaying drain 0); the index
    wraps as int32 inside a run."""
    pred = predicate_for(masks_t, thresholds_t, combine_any,
                         state.votes.device)
    return _run(state, start, iters, block_size, pred)


def drain_latency_distribution(spec_arrays, num_acceptors: int,
                               window: int, block_size: int,
                               mean_drain_us: float,
                               time_budget_s: float = 20.0,
                               target_samples: int = 1024,
                               device=None) -> dict:
    """A per-drain latency distribution: host-timed runs of ``chunk``
    drains each, one launch a run, p50/p99 over dozens to 1k samples
    (the reference's method, on the GPU).

    The null round trip (one tiny launch plus a value fetch, the same
    sync pattern as a timed sample) is measured first; its p50 is
    subtracted from every sample, and the chunk doubles from 128 until
    compute is at least 8x the null p90, so jitter beyond the median
    round trip is attributed to the drain (the p99 is an upper bound).
    """
    device = resolve_device(device)
    masks_t, thresholds_t, combine_any = spec_arrays

    x = torch.zeros((), dtype=torch.int32, device=device)
    for _ in range(3):
        x = x + 1
        _ = int(x)
    null = []
    for _ in range(30):
        t0 = time.perf_counter()
        x = x + 1
        _ = int(x)
        null.append(time.perf_counter() - t0)
    null_p50_us = float(np.percentile(null, 50) * 1e6)
    null_p90_us = float(np.percentile(null, 90) * 1e6)

    chunk = 128
    while chunk * mean_drain_us < 8 * null_p90_us and chunk < MAX_DRAINS:
        chunk *= 2
    est_sample_s = (chunk * mean_drain_us + null_p50_us) / 1e6
    samples = max(24, min(target_samples,
                          int(time_budget_s / max(est_sample_s, 1e-9))))

    pred = predicate_for(masks_t, thresholds_t, combine_any, device)
    state = make_state(window, num_acceptors, device=device)
    _run(state, 0, chunk, block_size, pred)
    _ = int(state.committed)  # warm the exact chunked shape
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        _run(state, 0, chunk, block_size, pred)
        _ = int(state.committed)  # value fetch: cannot complete early
        times.append(time.perf_counter() - t0)
    per_drain_us = (np.asarray(times) * 1e6 - null_p50_us) / chunk
    per_drain_us = np.maximum(per_drain_us, 0.0)
    return {
        "p50_drain_latency_us": round(float(
            np.percentile(per_drain_us, 50)), 2),
        "p99_drain_latency_us": round(float(
            np.percentile(per_drain_us, 99)), 2),
        "latency_samples": samples,
        "drains_per_sample": chunk,
        "null_rtt_p50_us": round(null_p50_us, 1),
        "null_rtt_p90_us": round(null_p90_us, 1),
        "latency_method": (
            "host-timed runs of drains_per_sample drains each (ONE kernel "
            "launch per run: the chunked drain kernel runs every drain of "
            "the sample, one value fetch per sample); per-drain = (sample "
            "- null_rtt_p50) / drains_per_sample; chunk auto-scaled so "
            "compute >= 8x null-RTT p90, so jitter beyond the median round "
            "trip is attributed to the drain (p99 is an upper bound)"),
    }


# --------------------------------------------------------------------------
# The sharded drain: the same drain over a (group, slot) mesh of ranks.
# --------------------------------------------------------------------------


def local_block(block_size: int, slot_shards: int) -> tuple:
    """``(b_local, pad)``: the per-shard lane count (the global block
    rounded UP over the slot shards) and the pad lanes the rounding adds
    to the padded global block (the reference's ``local_block``)."""
    b_local = -(-block_size // slot_shards)
    return b_local, b_local * slot_shards - block_size


def padded_window(window: int, block_size: int, slot_shards: int) -> int:
    """The padded GLOBAL window of a sharded run: every shard holds whole
    ``b_local`` blocks, so the window grows by ``pad`` lanes per block
    when the block does not divide over the slot shards."""
    if window % block_size:
        raise ValueError(
            f"window {window} must hold whole {block_size}-slot blocks")
    b_local, _ = local_block(block_size, slot_shards)
    return (window // block_size) * b_local * slot_shards


def gathered_layout(slot_shards: int, w_local: int, b_local: int,
                    block_size: int) -> tuple:
    """``(logical, valid)`` for each physical column of the gathered
    sharded window (shard windows concatenated): ``logical[c]`` is the
    unsharded slot id the column holds, ``valid[c]`` False for pad
    columns. Within shard ``s``, local column ``j`` holds block
    ``j // b_local`` at block lane ``s * b_local + (j % b_local)``."""
    cols = np.arange(slot_shards * w_local)
    s, j = cols // w_local, cols % w_local
    bi, lane = j // b_local, s * b_local + (j % b_local)
    return bi * block_size + lane, lane < block_size


#: How each leaf of a sharded state is laid out over the mesh (the
#: reference's ``PIPELINE_PARTITION``): dimension ``k`` of a leaf is
#: split over the mesh axis ``axes[k]`` and replicated over the others;
#: votes over both axes, the slot columns over ``slot`` (replicated over
#: ``group``), the scalars replicated; the telemetry counters per
#: ``TELEMETRY_PARTITION``. :func:`shard_leaf` and :func:`unshard_leaf`
#: read it to cut and to gather a state.
PIPELINE_PARTITION = PipelineState(
    votes=("group", "slot"),
    chosen=("slot",),
    commands=("slot",),
    results=("slot",),
    sm_state=(),
    committed=(),
    exec_wm=(),
)


def state_sharding(telemetry: bool = False) -> PipelineState:
    """The partition table of a sharded state: ``PIPELINE_PARTITION``
    leaf for leaf, with ``TELEMETRY_PARTITION`` attached when the
    telemetry plane is on (it does not depend on the mesh's sizes)."""
    return PIPELINE_PARTITION._replace(
        telemetry=TELEMETRY_PARTITION if telemetry else None)


def _shard_coords(mesh: Mesh) -> dict:
    return {"group": (mesh.group_idx, mesh.group_shards),
            "slot": (mesh.slot_idx, mesh.slot_shards)}


def shard_leaf(array: np.ndarray, axes: tuple, mesh: Mesh) -> np.ndarray:
    """This rank's piece of a gathered leaf laid out by ``axes`` (its
    entry of the partition table): dimension ``k`` cut into
    ``mesh``'s shards along ``axes[k]``."""
    coords = _shard_coords(mesh)
    index = []
    for dim, axis in enumerate(axes):
        at, shards = coords[axis]
        size, rest = divmod(array.shape[dim], shards)
        if rest:
            raise ValueError(f"dimension {dim} ({array.shape[dim]}) does "
                             f"not split over {shards} {axis} shards")
        index.append(slice(at * size, (at + 1) * size))
    return array[tuple(index)]


def unshard_leaf(pieces: list, axes: tuple, mesh: Mesh,
                 name: str) -> np.ndarray:
    """The gathered leaf from every rank's piece (``pieces[r]`` for mesh
    rank ``r``), laid out by ``axes``: pieces concatenated along the
    axes the leaf is split over. Raises when the replicas of one piece
    (the ranks that differ only along the other axes) disagree."""
    s_sh = mesh.slot_shards
    counts = {"group": mesh.group_shards, "slot": s_sh}
    owners = {}
    for r, piece in enumerate(pieces):
        coord = {"group": r // s_sh, "slot": r % s_sh}
        key = tuple(coord[axis] for axis in axes)
        if key not in owners:
            owners[key] = piece
        elif not np.array_equal(owners[key], piece):
            raise RuntimeError(f"{name} differs between the replicas of "
                               f"shard {key}")

    def build(prefix: tuple) -> np.ndarray:
        if len(prefix) == len(axes):
            return owners[prefix]
        return np.concatenate(
            [build(prefix + (k,)) for k in range(counts[axes[len(prefix)]])],
            axis=len(prefix))

    return build(())


#: The shard's quorum partials: the psum'd mask matmul, or the missing
#: (write grid) / full (read grid) row counts of the fused grid path.
MATMUL, GRID_WRITE, GRID_READ = 0, 1, 2

#: Rows of a run's slot table, one a drain (``csrc/pipeline_sharded.cu``'s
#: ``kFoldThreads``: K21 folds a row a thread); a longer run flushes the
#: table (one slot all-reduce, one K21) each time it is full.
RUN_ROWS = 256


class ShardPlan(NamedTuple):
    """What one rank's drain needs besides its state: its place in the
    mesh, the global and local widths, its slice of the predicate, and
    the two partial buffers the all-reduces carry."""

    group_shards: int
    slot_shards: int
    group_idx: int
    slot_idx: int
    block_size: int          # GLOBAL block
    b_local: int             # lanes per slot shard (rounded up)
    n_local: int             # acceptor rows per group shard
    n_global: int
    kind: int                # MATMUL, GRID_WRITE or GRID_READ
    cols: int                # grid row length (grid kinds)
    masks: torch.Tensor      # [G, n_local] int32: this shard's columns
    thresholds: torch.Tensor  # [G] int32
    combine_any: bool
    telemetry: bool
    parts: torch.Tensor      # [2, R, b_local] int32: per pass, R rows
    slot: torch.Tensor       # [RUN_ROWS, S + 1 (+ n + 3)] int32: a row a
    #                          drain of a run, 0 between runs


def make_shard_plan(mesh: Mesh, block_size: int, predicate: QuorumPredicate,
                    *, telemetry: bool = False) -> ShardPlan:
    """This rank's :class:`ShardPlan` for ``predicate`` (GLOBAL masks,
    from ``make_predicate`` on the mesh's device). The fused grid path
    engages when the spec is a row-major grid and every group shard holds
    whole rows; otherwise the shard psums its mask-matmul counts (the
    reference's gate, ``bench/pipeline.py`` L202-207).

    Partials: ``parts[p]`` is pass ``p``'s ``[R, b_local]``: the G mask
    counts (matmul) or one row count (grid), then the vote-byte sums when
    ``telemetry``. ``slot``: the run's table of :data:`RUN_ROWS` rows,
    drain ``d`` of a run in row ``d``: ``[S]`` newly counts (each shard
    its own entry), the ``cmds_old`` sum, then with telemetry ``[n + 1]``
    occupancy bins, valid proposals and pad lanes."""
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
    rows = (masks.shape[0] if kind == MATMUL else 1) + int(telemetry)
    dev = predicate.masks.device
    return ShardPlan(
        group_shards=g_sh, slot_shards=s_sh, group_idx=gi,
        slot_idx=mesh.slot_idx, block_size=block_size, b_local=b_local,
        n_local=n_local, n_global=n_global, kind=kind, cols=cols,
        masks=masks, thresholds=predicate.thresholds,
        combine_any=predicate.combine_any, telemetry=telemetry,
        parts=torch.zeros((2, rows, b_local), dtype=torch.int32,
                          device=dev),
        slot=torch.zeros((RUN_ROWS, s_sh + 1 + (n_global + 3 if telemetry
                                                else 0)),
                         dtype=torch.int32, device=dev))


def _check_shard(state: PipelineState, plan: ShardPlan) -> int:
    """The shard's local window, after the checks the three phases
    share."""
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
    tel = state.telemetry
    if (tel is not None) != plan.telemetry:
        raise ValueError("the state's telemetry plane and the plan's "
                         "disagree")
    if tel is not None:
        buffer = tel.buffer
        if buffer is None or buffer.dtype != torch.int32 \
                or not buffer.is_contiguous() or buffer.numel() \
                != buffer_words(plan.n_global, plan.slot_shards):
            raise ValueError(
                f"the telemetry state does not hold the flat int32 buffer "
                f"make_telemetry builds for {plan.n_global} acceptors over "
                f"{plan.slot_shards} slot shards")
    return w_local


def _ring(i: int, w_local: int, b_local: int) -> tuple:
    """``(start_new, start_old, start_gc)``: the local columns of blocks
    i, i-1 and i-2 in the shard's ring."""
    num_blocks = w_local // b_local
    return tuple((_wrap32(i - k) % num_blocks) * b_local for k in range(3))


def _shard_lanes(plan: ShardPlan, device) -> tuple:
    """The shard's global block lanes and which of them are real (lanes
    past the global block are pad)."""
    lanes = plan.slot_idx * plan.b_local + torch.arange(
        plan.b_local, dtype=torch.int32, device=device)
    return lanes, lanes < plan.block_size


def _proposals(lanes: torch.Tensor, valid: torch.Tensor,
               i_t: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, lanes * 7 + i_t * 13 + 1,
                       torch.zeros_like(lanes))


def _partials(block: torch.Tensor, plan: ShardPlan,
              out: torch.Tensor) -> None:
    """One pass's ``[R, b_local]`` partials of the shard's ``[n_local,
    b_local]`` vote block, into ``out``."""
    if plan.kind == MATMUL:
        out[:plan.masks.shape[0]] = (
            plan.masks[:, :, None] * block.to(torch.int32)[None]
        ).sum(1, dtype=torch.int32)
    else:
        # The reference's uint8 chain: OR (write) or AND (read) along
        # each local row, then a uint8 sum of the missing / full rows.
        write = plan.kind == GRID_WRITE
        total = torch.zeros_like(block[0])
        for r in range(plan.n_local // plan.cols):
            row = block[r * plan.cols]
            for c in range(1, plan.cols):
                cell = block[r * plan.cols + c]
                row = (row | cell) if write else (row & cell)
            total = total + ((1 - row) if write else row)
        out[0] = total.to(torch.int32)
    if plan.telemetry:
        out[-1] = block.to(torch.int32).sum(0, dtype=torch.int32)


def shard_vote_count_plain(state: PipelineState, i: int,
                           plan: ShardPlan) -> torch.Tensor:
    """Plain PyTorch version of K19: propose on the shard's lanes, OR
    each pass's arrivals (pad lanes get none) into its block and write
    its partials into ``plan.parts``; returns ``plan.parts``."""
    votes, commands = state.votes, state.commands
    dev = votes.device
    n_local, w_local = votes.shape
    b = plan.b_local
    start_new, start_old, _ = _ring(i, w_local, b)
    lanes, valid = _shard_lanes(plan, dev)
    accs = plan.group_idx * n_local + torch.arange(
        n_local, dtype=torch.int32, device=dev)
    i_t = torch.tensor(i, dtype=torch.int32, device=dev)
    commands[start_new:start_new + b] = _proposals(lanes, valid, i_t)
    mask = valid.to(torch.uint8)[None, :]
    passes = ((start_new, _arrivals(i, lanes, accs, salt=0)),
              (start_old, 1 - _arrivals(_wrap32(i - 1), lanes, accs,
                                        salt=0)))
    for p, (start, arrivals) in enumerate(passes):
        cols = slice(start, start + b)
        block = votes[:, cols] | (arrivals & mask)
        votes[:, cols] = block
        _partials(block, plan, plan.parts[p])
    return plan.parts


def _shard_hit(part: torch.Tensor, plan: ShardPlan) -> torch.Tensor:
    if plan.kind == MATMUL:
        satisfied = part[:plan.masks.shape[0]] >= plan.thresholds[:, None]
        return satisfied.any(0) if plan.combine_any else satisfied.all(0)
    return part[0] == 0 if plan.kind == GRID_WRITE else part[0] > 0


def shard_commit_plain(state: PipelineState, i: int, plan: ShardPlan,
                       row: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K20: from the group-reduced
    ``plan.parts``, each pass's hits (never on a pad lane), ``chosen``
    and newly-chosen lanes, then execution of the old block and GC; the
    slot partials are added into row ``row`` of ``plan.slot`` (the
    drain's row of its run), which it returns."""
    votes, chosen, commands, results = state[:4]
    dev = votes.device
    w_local = votes.shape[1]
    b, s_sh, n = plan.b_local, plan.slot_shards, plan.n_global
    start_new, start_old, start_gc = _ring(i, w_local, b)
    lanes, valid = _shard_lanes(plan, dev)
    slot = plan.slot[_row(row)]
    for p, start in enumerate((start_new, start_old)):
        part = plan.parts[p]
        hit = _shard_hit(part, plan) & valid
        cols = slice(start, start + b)
        old = chosen[cols].clone()
        newly = hit & ~old
        chosen[cols] = hit | old
        if plan.telemetry:
            occ, count = pass_deltas(part[-1], newly, n + 1)
            slot[s_sh + 1:s_sh + n + 2] += occ
        else:
            count = newly.sum(dtype=torch.int32)
        slot[plan.slot_idx] += count
    cmds_old = commands[start_old:start_old + b].clone()
    results[start_old:start_old + b] = torch.where(
        valid, cmds_old * 3 + 7, torch.zeros_like(cmds_old))
    slot[s_sh] += cmds_old.sum(dtype=torch.int32)
    votes[:, start_gc:start_gc + b] = 0
    chosen[start_gc:start_gc + b] = False
    if plan.telemetry:
        i_t = torch.tensor(i, dtype=torch.int32, device=dev)
        proposed, pad = drain_deltas(_proposals(lanes, valid, i_t), valid)
        slot[s_sh + n + 2] += proposed
        slot[s_sh + n + 3] += pad
    return slot


def _row(row: int) -> int:
    if not 0 <= row < RUN_ROWS:
        raise ValueError(f"row {row} is not a row of the {RUN_ROWS}-row "
                         f"slot table")
    return row


def _rows(k: int) -> int:
    if not 1 <= k <= RUN_ROWS:
        raise ValueError(f"a fold takes 1 to {RUN_ROWS} rows, not {k}")
    return k


def shard_fold_plain(state: PipelineState, i: int, plan: ShardPlan,
                     k: int = 1) -> PipelineState:
    """Plain PyTorch version of K21: fold the first ``k`` slot-reduced
    rows of ``plan.slot`` (drains ``i .. i + k - 1`` of a run, the index
    wrapping as int32) into committed and sm_state (their sums), exec_wm
    (the last drain's ``i`` times the GLOBAL block) and the telemetry
    counters (the column sums, and each drain's lag from its
    end-of-drain committed by :func:`fold_lag_plain`), then zero those
    rows."""
    s_sh, n = plan.slot_shards, plan.n_global
    rows = plan.slot[:_rows(k)]
    newly = rows[:, :s_sh].sum(1, dtype=torch.int32)
    state.committed.add_(newly.sum(dtype=torch.int32))
    state.sm_state.add_(rows[:, s_sh].sum(dtype=torch.int32))
    last = _wrap32(i + k - 1)
    state.exec_wm.fill_(_wrap32(last * plan.block_size) if last >= 1 else 0)
    tel = state.telemetry
    if tel is not None:
        totals = rows.sum(0, dtype=torch.int32)
        tel.shard_committed.add_(totals[:s_sh])
        tel.proposed.add_(totals[s_sh + n + 2])
        tel.occupancy.add_(totals[s_sh + 1:s_sh + n + 2])
        tel.pad_lanes.add_(totals[s_sh + n + 3])
        fold_lag_plain(tel, state.committed, newly, i, plan.block_size)
    rows.zero_()
    return state


#: K19's register forms (``csrc/pipeline_sharded.cu``), by shard
#: structure: ``(kind, n_local, g)`` with one mask group for n_local
#: 1-16 (a majority's shard), two groups over two acceptors (the 2x3
#: grid's rows over three group shards), and whole rows of three over
#: three acceptors (the 2x3 grid over two group shards, write or read).
#: :func:`shard_form` chooses from it; the C entry launches the form it
#: is handed and refuses one it does not instantiate.
SHARD_FORMS = frozenset(
    [(MATMUL, n, 1) for n in range(1, 17)] + [(MATMUL, 2, 2)]
    + [(kind, 3, 3) for kind in (GRID_WRITE, GRID_READ)])


def shard_form(plan: ShardPlan) -> tuple:
    """The form K19 runs for ``plan``'s shard (the C entry launches
    the one named here): ``("groups", n_local, g)`` (the mask-group counts in registers),
    ``("rows", n_local, cols)`` (whole grid rows in registers) or
    ``("generic", n_local, 0)`` (runtime sizes)."""
    if plan.kind == MATMUL:
        key = (MATMUL, plan.n_local, plan.masks.shape[0])
        if key in SHARD_FORMS:
            return ("groups", plan.n_local, plan.masks.shape[0])
    elif (plan.kind, plan.n_local, plan.cols) in SHARD_FORMS:
        return ("rows", plan.n_local, plan.cols)
    return ("generic", plan.n_local, 0)


#: The C entry's code of each kind of form (``VoteFormKind``).
_FORM_CODES = {"generic": 0, "groups": 1, "rows": 2}

def commit_form(plan: ShardPlan) -> tuple:
    """The form K20 runs for ``plan``'s shard (its C entry chooses it from
    the kind, the group count and ``n_local``): the mask groups of
    :func:`shard_form`'s ``groups`` forms, whole grid rows over three
    acceptors (``("rows", 3, cols)``), or the generic template."""
    if plan.kind != MATMUL and plan.n_local == 3:
        return ("rows", 3, plan.cols)
    form = shard_form(plan)
    return form if form[0] == "groups" else ("generic", plan.n_local, 0)


#: The packed entries: K19's 18 int64 slots, K20's 21, K21's 12
#: (``pipeline_sharded.cu``'s blocks).
_K19 = _build.Entry("pipeline_sharded", "fpx_shard_vote_count", 18)
_K20 = _build.Entry("pipeline_sharded", "fpx_shard_commit", 21)
_K21 = _build.Entry("pipeline_sharded", "fpx_shard_fold", 12)


def shard_vote_count(state: PipelineState, i: int,
                     plan: ShardPlan) -> torch.Tensor:
    """K19 (``csrc/pipeline_sharded.cu::shard_vote_count_kernel``, in
    the form :func:`shard_form` names) on CUDA state through the lean
    call path (one packed ``ctypes`` call), counted in
    ``shard_vote_count.launches``; :func:`shard_vote_count_plain` on CPU
    state. Never synchronises."""
    w_local = _check_shard(state, plan)
    i = int32(i)
    if not use_kernel(state.votes, state.commands, plan.masks,
                      plan.thresholds, plan.parts, plan.slot):
        return shard_vote_count_plain(state, i, plan)
    index = state.votes.get_device()
    fn = _K19.fn or _K19.resolve()
    rc = fn(_K19.pack(
        state.votes.data_ptr(), state.commands.data_ptr(), w_local, i,
        plan.block_size, plan.b_local, plan.slot_idx, plan.group_idx,
        plan.n_local, plan.kind, plan.masks.shape[0], plan.cols,
        plan.masks.data_ptr(), int(plan.telemetry), plan.parts.data_ptr(),
        _FORM_CODES[shard_form(plan)[0]], index,
        _build.stream_handle(index)))
    if rc:
        _K19.check(rc)
    shard_vote_count.launches += 1
    return plan.parts


def shard_commit(state: PipelineState, i: int, plan: ShardPlan,
                 row: int = 0) -> torch.Tensor:
    """K20 (``shard_commit_kernel``, in the form :func:`commit_form`
    names) on CUDA state through the lean call path, its slot partials
    added into row ``row`` of ``plan.slot`` (the row's address in the
    packed block), counted in ``shard_commit.launches``;
    :func:`shard_commit_plain` on CPU state. Returns the row. Never
    synchronises."""
    w_local = _check_shard(state, plan)
    i = int32(i)
    tensors = state[:4]
    if not use_kernel(*tensors, plan.masks, plan.thresholds, plan.parts,
                      plan.slot):
        return shard_commit_plain(state, i, plan, row)
    index = state.votes.get_device()
    fn = _K20.fn or _K20.resolve()
    slot = plan.slot
    rc = fn(_K20.pack(
        *(t.data_ptr() for t in tensors), w_local, i, plan.block_size,
        plan.b_local, plan.slot_idx, plan.slot_shards, plan.n_local,
        plan.n_global, plan.kind, plan.masks.shape[0],
        plan.thresholds.data_ptr(), int(plan.combine_any),
        int(plan.telemetry), plan.parts.data_ptr(),
        slot.data_ptr() + 4 * slot.shape[1] * _row(row), index,
        _build.stream_handle(index)))
    if rc:
        _K20.check(rc)
    shard_commit.launches += 1
    return slot[row]


def shard_fold(state: PipelineState, i: int, plan: ShardPlan,
               k: int = 1) -> PipelineState:
    """K21 (``shard_fold_kernel``) on CUDA state through the lean call
    path: the first ``k`` rows of ``plan.slot``, drains ``i .. i + k -
    1`` of a run, folded and zeroed in one launch, counted in
    ``shard_fold.launches``; :func:`shard_fold_plain` on CPU state.
    Never synchronises."""
    _check_shard(state, plan)
    i = int32(i)
    scalars = state[4:7]
    tel = state.telemetry
    extra = () if tel is None else (tel.buffer,)
    if not use_kernel(*scalars, *extra, plan.masks, plan.thresholds,
                      plan.parts, plan.slot):
        return shard_fold_plain(state, i, plan, k)
    index = state.votes.get_device()
    fn = _K21.fn or _K21.resolve()
    rc = fn(_K21.pack(
        *(t.data_ptr() for t in scalars), i, _rows(k), plan.block_size,
        plan.slot_shards, plan.n_global, plan.slot.data_ptr(),
        0 if tel is None else tel.buffer.data_ptr(), index,
        _build.stream_handle(index)))
    if rc:
        _K21.check(rc)
    shard_fold.launches += 1
    return state


shard_vote_count.launches = 0
shard_commit.launches = 0
shard_fold.launches = 0


#: The phases of the sharded drain, and their plain versions.
_KERNELS = (shard_vote_count, shard_commit, shard_fold)
_PLAINS = (shard_vote_count_plain, shard_commit_plain, shard_fold_plain)


def _sharded(mesh: Mesh, state: PipelineState, start: int, iters: int,
             plan: ShardPlan, phases: tuple) -> PipelineState:
    """Drains ``start .. start + iters - 1`` (the index wrapping as
    int32): for each, K19, the group all-reduce of the partials and K20
    into the drain's row; per :data:`RUN_ROWS` drains (and at the end)
    the slot all-reduce of the used rows and one K21 over them."""
    _check_shard(state, plan)
    start = int32(start)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    vote_count, commit, fold = phases
    while iters > 0:
        k = min(iters, RUN_ROWS)
        for row in range(k):
            i = _wrap32(start + row)
            vote_count(state, i, plan)
            mesh.psum_group(plan.parts)
            commit(state, i, plan, row)
        mesh.psum_slot(plan.slot[:k])
        fold(state, start, plan, k)
        start, iters = _wrap32(start + k), iters - k
    return state


def sharded_step(mesh: Mesh, state: PipelineState, i: int,
                 plan: ShardPlan) -> PipelineState:
    """One drain on this rank's shard, IN PLACE, the run of one: K19,
    the group all-reduce of the partials, K20, the slot all-reduce of
    the slot partials, K21 (each phase's plain version on CPU state); the
    state is complete after the call. Every rank of the mesh calls it
    with the same ``i``."""
    return _sharded(mesh, state, i, 1, plan, _KERNELS)


def sharded_step_plain(mesh: Mesh, state: PipelineState, i: int,
                       plan: ShardPlan) -> PipelineState:
    """Plain PyTorch version of :func:`sharded_step` on any device: the
    three phases' plain versions around the same two all-reduces."""
    return _sharded(mesh, state, i, 1, plan, _PLAINS)


def sharded_run(mesh: Mesh, state: PipelineState, start: int, iters: int,
                plan: ShardPlan) -> PipelineState:
    """Drains ``start .. start + iters - 1`` on this rank's shard, IN
    PLACE: per drain K19, the group all-reduce and K20 into the drain's
    row of ``plan.slot``; per run of up to :data:`RUN_ROWS` drains ONE
    slot all-reduce of the used rows and ONE K21 (each phase's plain
    version on CPU state). The state is complete after the call. Every
    rank of the mesh calls it with the same arguments. Never
    synchronises beyond the all-reduces."""
    return _sharded(mesh, state, start, iters, plan, _KERNELS)


def sharded_run_plain(mesh: Mesh, state: PipelineState, start: int,
                      iters: int, plan: ShardPlan) -> PipelineState:
    """Plain PyTorch version of :func:`sharded_run` on any device: the
    plain phases on the same all-reduce schedule."""
    return _sharded(mesh, state, start, iters, plan, _PLAINS)


def make_sharded_state(mesh: Mesh, window: int, block_size: int,
                       num_acceptors: int, *, telemetry: bool = False,
                       device=None) -> tuple:
    """``(state, w_padded)``: this rank's fresh shard of a GLOBAL
    ``window`` of whole ``block_size`` blocks over ``num_acceptors``
    acceptors, on ``device`` (the mesh's when None): the unsharded state
    of the padded window (:func:`padded_window`; a block that does not
    divide over the slot shards pads it) cut by the partition table, so
    each leaf holds :func:`shard_leaf`'s piece; the telemetry counters
    are over the global acceptors and every slot shard."""
    device = mesh.device if device is None else torch.device(device)
    if num_acceptors % mesh.group_shards:
        raise ValueError(f"{num_acceptors} acceptors do not split over "
                         f"{mesh.group_shards} group shards")
    w_padded = padded_window(window, block_size, mesh.slot_shards)
    coords = _shard_coords(mesh)
    # The board's [n, w] cut by its table entry; make_state sizes the
    # slot columns from the board's second dimension.
    n_local, w_local = (size // coords[axis][1] for size, axis in zip(
        (num_acceptors, w_padded), PIPELINE_PARTITION.votes))
    state = make_state(w_local, n_local, device=device)
    if telemetry:
        state = state._replace(telemetry=make_telemetry(
            num_acceptors, mesh.slot_shards, device=device))
    return state, w_padded


def make_sharded_step(mesh: Mesh, *, block_size: int, masks, thresholds,
                      combine_any: bool,
                      telemetry: bool = False) -> Callable:
    """``step(state, i)``: one drain on this rank's shard, in place (the
    reference's ``make_sharded_step``, whose quorum counts psum over
    ``group`` and counters over ``slot``). ``block_size`` and ``masks``
    are GLOBAL; the step's plan is ``step.plan``."""
    pred = make_predicate(masks, thresholds, combine_any,
                          device=mesh.device)
    plan = make_shard_plan(mesh, block_size, pred, telemetry=telemetry)

    def step(state: PipelineState, i: int) -> PipelineState:
        return sharded_step(mesh, state, i, plan)

    step.plan = plan
    return step


def make_sharded_runner(mesh: Mesh, *, block_size: int, masks, thresholds,
                        combine_any: bool, iters: int,
                        telemetry: bool = False) -> Callable:
    """``runner(state, start)``: drains ``start .. start + iters - 1`` on
    this rank's shard, in place, by :func:`sharded_run` -- one slot
    all-reduce and one K21 a run (a table of :data:`RUN_ROWS` drains) --
    without synchronising beyond the all-reduces (the reference's
    ``make_sharded_runner``); the runner's plan is ``runner.plan``."""
    plan = make_sharded_step(mesh, block_size=block_size, masks=masks,
                             thresholds=thresholds, combine_any=combine_any,
                             telemetry=telemetry).plan

    def runner(state: PipelineState, start: int) -> PipelineState:
        return sharded_run(mesh, state, start, iters, plan)

    runner.plan = plan
    return runner


def gather_state(mesh: Mesh, state: PipelineState) -> PipelineState:
    """The whole sharded state as host numpy arrays, on every rank of
    the mesh (collective): what ``jax.device_get`` gives for the
    reference's sharded state -- votes ``[n, w_padded]`` and the slot
    columns ``[w_padded]`` in the physical layout (shard windows
    concatenated; :func:`gathered_layout` maps them to slots), the
    scalars and counters as one copy, each leaf assembled by the
    partition table (:func:`unshard_leaf`). Goes through the host
    (``all_gather_object``), since gloo gathers only CPU tensors. Raises
    when replicas that must agree (over ``group``, or everywhere) do
    not."""
    tel = state.telemetry
    table = state_sharding(tel is not None)
    names = PipelineState._fields[:7]
    local = {name: t.detach().cpu().numpy()
             for name, t in zip(names, state[:7])}
    if tel is not None:
        local["telemetry"] = tel.buffer.detach().cpu().numpy()
    pieces = [None] * mesh.size
    dist.all_gather_object(pieces, local, group=mesh.mesh_pg)
    out = {name: unshard_leaf([p[name] for p in pieces],
                              getattr(table, name), mesh, name)
           for name in names}
    if tel is not None:
        buffer = unshard_leaf([p["telemetry"] for p in pieces],
                              table.telemetry.buffer, mesh, "telemetry")
        at, values = 0, {}
        for field, view in zip(TelemetryState._fields[:6], tel[:6]):
            values[field] = buffer[at:at + view.numel()].reshape(
                tuple(view.shape))
            at += view.numel()
        out["telemetry"] = TelemetryState(**values)
    return PipelineState(**out)
