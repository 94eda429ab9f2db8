"""Batched Phase-1 safe-value selection on one GPU: K8.

Counterpart of ``frankenpaxos_tpu/ops/value.py::safe_values``. Reference
behavior: multipaxos/Leader.scala:318-330 (``safeValue``): given the
Phase1b votes for a slot, adopt the value with the highest vote round,
or a Noop if no acceptor voted. The Leader lifts its whole recovery
window into one ``[S, N]`` reduction (``Leader._recover_values``).

:func:`safe_values` launches ``csrc/value.cu::safe_values_kernel`` for
CUDA tensors and runs :func:`safe_values_plain` for CPU tensors; it
never falls back. The reference's ``count_matching_replies`` has no
protocol caller and is not ported (ROADMAP.md, queue 2).
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops.quorum import use_kernel
import torch

NO_VOTE = -1


def _check(vote_rounds: torch.Tensor, value_ids: torch.Tensor) -> None:
    if vote_rounds.dtype != torch.int32 or value_ids.dtype != torch.int32 \
            or vote_rounds.dim() != 2 \
            or value_ids.shape != vote_rounds.shape:
        raise ValueError(
            f"safe_values takes two [S, N] int32 tensors, got "
            f"{vote_rounds.dtype} {tuple(vote_rounds.shape)} and "
            f"{value_ids.dtype} {tuple(value_ids.shape)}")
    if vote_rounds.shape[1] == 0:
        raise ValueError("safe_values needs at least one acceptor column")


def safe_values_plain(vote_rounds: torch.Tensor, value_ids: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8: ``torch.argmax`` (first maximum, as
    ``jnp.argmax``) over each row, then the gathers."""
    _check(vote_rounds, value_ids)
    best = torch.argmax(vote_rounds, dim=-1, keepdim=True)
    best_round = torch.gather(vote_rounds, 1, best)[:, 0]
    chosen = torch.gather(value_ids, 1, best)[:, 0]
    return best_round > NO_VOTE, chosen


def safe_values(vote_rounds: torch.Tensor, value_ids: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: per row of ``[S, N]`` int32 ``vote_rounds`` (``NO_VOTE`` where
    the acceptor did not vote), the first column with the row's highest
    round; returns ``(has_vote [S] bool, value_id [S] int32)``, the id
    taken from ``value_ids`` at that column. ``value_id`` is
    ``value_ids[s, 0]`` where ``has_vote`` is False (callers substitute
    Noop)."""
    _check(vote_rounds, value_ids)
    if not use_kernel(vote_rounds, value_ids):
        return safe_values_plain(vote_rounds, value_ids)
    if not (vote_rounds.is_contiguous() and value_ids.is_contiguous()):
        raise ValueError("safe_values needs contiguous tensors")
    s, n = vote_rounds.shape
    has_vote = torch.empty((s,), dtype=torch.bool, device=vote_rounds.device)
    value_id = torch.empty((s,), dtype=torch.int32,
                           device=vote_rounds.device)
    if s == 0:
        return has_vote, value_id
    lib = _build.library("value")
    rc = lib.fpx_safe_values(
        vote_rounds.data_ptr(), value_ids.data_ptr(), s, n,
        has_vote.data_ptr(), value_id.data_ptr(),
        *_build.stream_args(vote_rounds.device))
    _build.check("value", "fpx_safe_values", rc)
    safe_values.launches += 1
    return has_vote, value_id


safe_values.launches = 0
