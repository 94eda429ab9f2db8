"""Batched Phase-1 safe-value selection on one GPU: K8, and the modal
reply count K15.

Counterpart of ``frankenpaxos_tpu/ops/value.py``. Reference
behavior: multipaxos/Leader.scala:318-330 (``safeValue``): given the
Phase1b votes for a slot, adopt the value with the highest vote round,
or a Noop if no acceptor voted. The Leader lifts its whole recovery
window into one ``[S, N]`` reduction (``Leader._recover_values``).

:func:`safe_values` launches ``csrc/value.cu::safe_values_kernel`` for
CUDA tensors and runs :func:`safe_values_plain` for CPU tensors; it
never falls back. :func:`count_matching_replies` (K15, the EPaxos
fast-path / Fast Paxos "k identical replies" reduction) follows the same
rule; no protocol of the reference calls it yet.
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


def _check_replies(ids: torch.Tensor, valid: torch.Tensor) -> None:
    if ids.dtype != torch.int32 or valid.dtype != torch.bool \
            or ids.dim() != 2 or valid.shape != ids.shape:
        raise ValueError(
            f"count_matching_replies takes [S, N] int32 ids and a [S, N] "
            f"bool mask, got {ids.dtype} {tuple(ids.shape)} and "
            f"{valid.dtype} {tuple(valid.shape)}")
    if ids.shape[1] == 0:
        raise ValueError("count_matching_replies needs at least one reply "
                         "column (the reference's argmax of an empty axis)")


def count_matching_replies_plain(ids: torch.Tensor, valid: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K15: the reference's masked pairwise
    equality matrix, its row sums, ``torch.argmax`` (first maximum) and
    the gathers."""
    _check_replies(ids, valid)
    eq = (ids[:, :, None] == ids[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    counts = eq.sum(-1, dtype=torch.int32)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    return (torch.gather(ids, 1, best)[:, 0],
            torch.gather(counts, 1, best)[:, 0])


def count_matching_replies(ids: torch.Tensor, valid: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K15: per row of ``[S, N]`` int32 reply ids under a ``[S, N]`` bool
    mask, the most frequent valid id and its count; returns
    ``(modal_id [S] int32, count [S] int32)``. Ties go to the first
    column with the highest count; a row with no valid reply gives
    ``(ids[s, 0], 0)``. ``N = 0`` raises. CUDA tensors launch
    ``csrc/value.cu::count_matching_replies_kernel`` (one thread per
    row); CPU tensors take :func:`count_matching_replies_plain`."""
    _check_replies(ids, valid)
    if not use_kernel(ids, valid):
        return count_matching_replies_plain(ids, valid)
    if not (ids.is_contiguous() and valid.is_contiguous()):
        raise ValueError("count_matching_replies needs contiguous tensors")
    s, n = ids.shape
    modal = torch.empty((s,), dtype=torch.int32, device=ids.device)
    count = torch.empty((s,), dtype=torch.int32, device=ids.device)
    if s == 0:
        return modal, count
    lib = _build.library("value")
    rc = lib.fpx_count_matching_replies(
        ids.data_ptr(), valid.data_ptr(), s, n, modal.data_ptr(),
        count.data_ptr(), *_build.stream_args(ids.device))
    _build.check("value", "fpx_count_matching_replies", rc)
    count_matching_replies.launches += 1
    return modal, count


count_matching_replies.launches = 0
