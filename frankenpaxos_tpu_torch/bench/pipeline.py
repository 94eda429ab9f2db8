"""The device-resident MultiPaxos steady-state pipeline on one GPU.

Counterpart of ``frankenpaxos_tpu/bench/pipeline.py`` (unsharded): the
steady-state Phase-2 write path of compartmentalized MultiPaxos --
propose -> acceptor votes -> quorum check -> chosen -> replica execute
-> GC -- over a ``[acceptors, window]`` vote board, one drain per
launch of the hand-written kernel K3 (``ops/csrc/pipeline.cu``), or of
its telemetry-on twin K14 when the state carries the telemetry plane
(``ops/telemetry.py``: ``make_state(telemetry=True)``).

Where the reference iterates a jitted step under ``lax.fori_loop`` with
donated state, :func:`run_steps` is a Python loop of one launch per
drain, and every drain updates the :class:`PipelineState` tensors IN
PLACE. Vote arrivals are the reference's hash of (drain, block lane,
acceptor), so both packages produce the same votes for the same slot:
~87.5% of votes arrive in the drain after the proposal, the rest one
drain later.

The sharded (multi-GPU) functions are not ported yet (ROADMAP.md
queue 1 item 10).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

from frankenpaxos_tpu_torch.device import resolve_device
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
    drain_update,
    make_telemetry,
    quorum_pass_update,
    TelemetryState,
)
import numpy as np
import torch


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
    without a GPU), with zeroed telemetry counters when ``telemetry``.
    One GPU holds one slot shard: ``slot_shards`` other than 1 is the
    multi-GPU drain (ROADMAP.md queue 1 item 10) and raises."""
    device = resolve_device(device)
    if slot_shards != 1:
        raise NotImplementedError(
            f"slot_shards={slot_shards}: the sharded (multi-GPU) drain is "
            f"not ported (ROADMAP.md queue 1 item 10)")

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)

    return PipelineState(
        votes=torch.zeros((num_acceptors, window), dtype=torch.uint8,
                          device=device),
        chosen=torch.zeros((window,), dtype=torch.bool, device=device),
        commands=torch.zeros((window,), dtype=torch.int32, device=device),
        results=torch.zeros((window,), dtype=torch.int32, device=device),
        sm_state=scalar(), committed=scalar(), exec_wm=scalar(),
        telemetry=(make_telemetry(num_acceptors, 1, device=device)
                   if telemetry else None))


def _wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _arrivals(i: int, lanes: torch.Tensor, accs: torch.Tensor,
              salt: int) -> torch.Tensor:
    """Deterministic pseudo-random ``[len(accs), len(lanes)]`` uint8
    arrival mask (the reference's ``_arrivals``), in int32 arithmetic
    that wraps as the reference's does: the drain index is an int32
    tensor, never a Python int."""
    step = torch.tensor(_wrap32(i + salt), dtype=torch.int32,
                        device=lanes.device)
    h = (lanes[None, :] * 1103515245 + accs[:, None] * 12820163
         + step * 22695477) >> 7
    return ((h & 7) < 7).to(torch.uint8)  # ~87.5% arrive this drain


def steady_state_step_plain(state: PipelineState, i: int, block_size: int,
                            pred: QuorumPredicate) -> PipelineState:
    """Plain PyTorch version of K3 and K14: one drain, in the reference's
    order (propose, pass 1 on the new block, pass 2 on the old block,
    execute, GC), updating ``state`` in place; with telemetry on, each
    pass's :func:`quorum_pass_update` and the end-of-drain
    :func:`drain_update` woven in where the reference weaves them."""
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

    tel = state.telemetry

    # Leader: assign slots, propose command ids.
    proposed = lanes * 7 + i_t * 13 + 1
    commands[start_new:start_new + b] = proposed

    def quorum_pass(start, arrivals):
        cols = slice(start, start + b)
        block = votes[:, cols] | arrivals
        votes[:, cols] = block
        hit = quorum_hit_plain(block, pred)
        old = chosen[cols].clone()
        chosen[cols] = hit | old
        newly = hit & ~old
        state.committed.add_(newly.sum(dtype=torch.int32))
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
    state.exec_wm.copy_(i_t * b if i >= 1 else torch.zeros_like(i_t))
    # GC: release block i-2 so the ring can wrap.
    votes[:, start_gc:start_gc + b] = 0
    chosen[start_gc:start_gc + b] = False
    # Telemetry: proposals, and the end-of-drain watermark lag.
    if tel is not None:
        lag = (i_t + 1) * b - state.committed
        drain_update(tel, proposed_block=proposed, lane_valid=None,
                     lag=lag, slot_axis=None)
    return state


def _kernel_args(state: PipelineState, block_size: int,
                 predicate: QuorumPredicate) -> tuple:
    """The tensors the drain kernel takes -- K3's seven, then the flat
    telemetry buffer when the state carries one -- and the board's
    ``(n, window)``, after the checks K3 and K14 share. Per drain the
    buffer needs only what K14's writes need (contiguous int32 of
    ``n + 22`` words: one slot shard, ``n + 1`` occupancy bins), read
    from its attributes; ``collect`` checks the counter views in full
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
            raise NotImplementedError(
                "telemetry over several slot shards is the sharded drain "
                "(ROADMAP.md queue 1 item 10)")
        raise ValueError(f"the telemetry state does not hold the flat "
                         f"int32 buffer make_telemetry builds for {n} "
                         f"acceptors")
    return tensors + (buffer,), n, window


def steady_state_step(state: PipelineState, i: int, *, block_size: int,
                      predicate: QuorumPredicate) -> PipelineState:
    """One event-loop drain -- new proposals + straggler completion --
    applied to ``state`` IN PLACE (the reference donates it); returns
    ``state``.

    ``i`` is the drain index (an int32 value). ``predicate`` comes from
    :func:`~frankenpaxos_tpu_torch.ops.quorum.make_predicate` on the
    state's device. CUDA state launches
    ``csrc/pipeline.cu::steady_state_step_kernel<false>`` (K3, counted
    in ``steady_state_step.launches``), or ``<true>`` (K14, the same
    drain plus the counters in one launch, counted in
    ``telemetry_drain.launches``) when the state carries telemetry; CPU
    state takes :func:`steady_state_step_plain`. Never synchronises."""
    tensors, n, window = _kernel_args(state, block_size, predicate)
    i = int32(i)
    if not use_kernel(*tensors, predicate.masks):
        return steady_state_step_plain(state, i, block_size, predicate)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("steady_state_step needs contiguous tensors")
    lib = _build.library("pipeline")
    args = (*(t.data_ptr() for t in tensors[:7]), window, block_size, i,
            *predicate.c_args())
    stream = _build.stream_args(state.votes.device)
    if state.telemetry is None:
        rc = lib.fpx_steady_state_step(*args, *stream)
        _build.check("pipeline", "fpx_steady_state_step", rc)
        steady_state_step.launches += 1
    else:
        rc = lib.fpx_steady_state_step_telemetry(
            *args, tensors[7].data_ptr(), *stream)
        _build.check("pipeline", "fpx_steady_state_step_telemetry", rc)
        telemetry_drain.launches += 1
    return state


steady_state_step.launches = 0
#: K14's launch count: :func:`steady_state_step` launches K14 on a state
#: that carries telemetry and counts it here.
telemetry_drain = SimpleNamespace(launches=0)


def run_steps(state: PipelineState, iters: int, block_size: int,
              masks_t: tuple, thresholds_t: tuple,
              combine_any: bool) -> PipelineState:
    """``iters`` drains from drain 0 (the bench hot loop), one kernel
    launch each, without synchronising; ``state`` is updated in place."""
    return run_steps_from(state, 0, iters, block_size, masks_t,
                          thresholds_t, combine_any)


def run_steps_from(state: PipelineState, start: int, iters: int,
                   block_size: int, masks_t: tuple, thresholds_t: tuple,
                   combine_any: bool) -> PipelineState:
    """:func:`run_steps` from drain ``start``: chunked runs resume the
    drain counter where the previous chunk left off (ring positions and
    arrival hashes continue instead of replaying drain 0)."""
    pred = make_predicate(masks_t, thresholds_t, combine_any,
                          device=state.votes.device)
    return _run(state, start, iters, block_size, pred)


def _run(state: PipelineState, start: int, iters: int, block_size: int,
         pred: QuorumPredicate) -> PipelineState:
    for i in range(start, start + iters):
        steady_state_step(state, i, block_size=block_size, predicate=pred)
    return state


def drain_latency_distribution(spec_arrays, num_acceptors: int,
                               window: int, block_size: int,
                               mean_drain_us: float,
                               time_budget_s: float = 20.0,
                               target_samples: int = 1024,
                               device=None) -> dict:
    """A per-drain latency distribution: host-timed runs of ``chunk``
    drains each, p50/p99 over dozens to 1k samples (the reference's
    method, on the GPU).

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
    while chunk * mean_drain_us < 8 * null_p90_us and chunk < (1 << 16):
        chunk *= 2
    est_sample_s = (chunk * mean_drain_us + null_p50_us) / 1e6
    samples = max(24, min(target_samples,
                          int(time_budget_s / max(est_sample_s, 1e-9))))

    pred = make_predicate(masks_t, thresholds_t, combine_any, device)
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
            "host-timed runs of drains_per_sample drains each (one "
            "kernel launch per drain, one value fetch per sample); "
            "per-drain = (sample - null_rtt_p50) / drains_per_sample; "
            "chunk auto-scaled so compute >= 8x null-RTT p90, so jitter "
            "beyond the median round trip is attributed to the drain "
            "(p99 is an upper bound)"),
    }
