"""The PINNED pre-telemetry drain of the port, the overhead baseline.

Counterpart of ``frankenpaxos_tpu/bench/pipeline_baseline.py``
(``steady_state_step`` L76, ``run_steps_from`` L201). This module is a
frozen copy of the port's ``bench/pipeline.py`` hot path as it stood
before the telemetry plane: ``PipelineState``, ``make_state``, the plain
step and ``run_steps_from``, over its own copy of the K3 source
(``ops/csrc/pipeline_baseline.cu``) behind its own C entry point,
``fpx_steady_state_step_baseline``. It exists for one purpose: the
paired overhead A/B in ``bench/telemetry_overhead.py`` holds the
telemetry-OFF arm of the live drain against this copy, so the baseline
arm must be immune to later edits of ``bench/pipeline.py`` and
``ops/csrc/pipeline.cu``.

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


def steady_state_step(state: PipelineState, i: int, *, block_size: int,
                      predicate: QuorumPredicate) -> PipelineState:
    """The pinned K3: one drain applied to ``state`` IN PLACE. CUDA state
    launches ``csrc/pipeline_baseline.cu``; CPU state takes
    :func:`steady_state_step_plain`."""
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
    i = int32(i)
    if not use_kernel(*tensors, predicate.masks):
        return steady_state_step_plain(state, i, block_size, predicate)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("steady_state_step needs contiguous tensors")
    lib = _build.library("pipeline_baseline")
    rc = lib.fpx_steady_state_step_baseline(
        *(t.data_ptr() for t in tensors), window, block_size, i,
        *predicate.c_args(), *_build.stream_args(votes.device))
    _build.check("pipeline_baseline", "fpx_steady_state_step_baseline", rc)
    steady_state_step.launches += 1
    return state


steady_state_step.launches = 0


def run_steps_from(state: PipelineState, start: int, iters: int,
                   block_size: int, masks_t: tuple, thresholds_t: tuple,
                   combine_any: bool) -> PipelineState:
    """The pinned chunked runner: ``iters`` drains from drain ``start``,
    one launch each, without synchronising; ``state`` in place."""
    pred = make_predicate(masks_t, thresholds_t, combine_any,
                          device=state.votes.device)
    for i in range(start, start + iters):
        steady_state_step(state, i, block_size=block_size, predicate=pred)
    return state
