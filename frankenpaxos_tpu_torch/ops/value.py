"""Batched Phase-1 safe-value selection on one GPU: K8, and the modal
reply count K15.

Counterpart of ``frankenpaxos_tpu/ops/value.py``. Reference
behavior: multipaxos/Leader.scala:318-330 (``safeValue``): given the
Phase1b votes for a slot, adopt the value with the highest vote round,
or a Noop if no acceptor voted. The Leader lifts its whole recovery
window into one ``[S, N]`` reduction (``Leader._recover_values``).

:func:`safe_values` launches ``csrc/value.cu::safe_values_kernel`` for
CUDA tensors (the lean call path) and runs :func:`safe_values_plain` for
CPU tensors; it never falls back. The Leader's recovery takes the
host-facing pair instead: :func:`recovery_matrices` hands it the two
matrices as views of one reused pinned block, and
:func:`safe_values_staged` runs K8 on them in ONE call (on the CPU, the
plain version on fresh arrays). :func:`count_matching_replies` (K15, the
EPaxos fast-path / Fast Paxos "k identical replies" reduction) follows
the tensor rule; no protocol of the reference calls it yet.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops.quorum import use_kernel
import numpy as np
import torch

NO_VOTE = -1

#: K8's lean entry (8 int64: rounds, ids, s, n, has_vote, value_id,
#: device, stream) and its staged entry (5 int64: the pinned block, rows,
#: n, device, stream), whose kernel reads and writes the pinned block in
#: place (mapped memory, no copy; on an H100 faster than a copy up and
#: down at 2^13 rows and level at 2^16, ``PERF.md`` §7).
_K8 = _build.Entry("value", "fpx_safe_values", 8)
_K8_STAGED = _build.Entry("value", "fpx_safe_values_staged", 5,
                          keep_gil=False)
#: ``{card index, or the device named: _build.Staging}``
#: (``_build.staging``).
_STAGING: dict = {}


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


def _check_out(out, s: int, index: int) -> tuple[torch.Tensor, torch.Tensor]:
    has_vote, value_id = out
    for t, dtype in ((has_vote, torch.bool), (value_id, torch.int32)):
        if t.dtype is not dtype or tuple(t.shape) != (s,) \
                or not t.is_contiguous() or t.get_device() != index:
            raise ValueError(
                f"out must be a pair of contiguous [{s}] bool and int32 "
                f"tensors on the inputs' device, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    return has_vote, value_id


def safe_values(vote_rounds: torch.Tensor, value_ids: torch.Tensor,
                out: tuple | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: per row of ``[S, N]`` int32 ``vote_rounds`` (``NO_VOTE`` where
    the acceptor did not vote), the first column with the row's highest
    round; returns ``(has_vote [S] bool, value_id [S] int32)``, the id
    taken from ``value_ids`` at that column. ``value_id`` is
    ``value_ids[s, 0]`` where ``has_vote`` is False (callers substitute
    Noop). ``out``, a pair of contiguous ``[S]`` bool and int32 tensors
    on the inputs' device, receives the result and is returned.

    On a card the call path is lean (one packed ``ctypes`` call, the
    form chosen in C by N); the tensors must be contiguous."""
    _check(vote_rounds, value_ids)
    index = vote_rounds.get_device()
    if index < 0 or value_ids.get_device() != index:
        if not use_kernel(vote_rounds, value_ids,
                          *(() if out is None else out)):
            got = safe_values_plain(vote_rounds, value_ids)
            if out is None:
                return got
            has_vote, value_id = _check_out(out, got[0].shape[0], index)
            return has_vote.copy_(got[0]), value_id.copy_(got[1])
    if not (vote_rounds.is_contiguous() and value_ids.is_contiguous()):
        raise ValueError("safe_values needs contiguous tensors")
    s, n = vote_rounds.shape
    if out is None:
        has_vote = vote_rounds.new_empty((s,), dtype=torch.bool)
        value_id = vote_rounds.new_empty((s,))
    else:
        has_vote, value_id = _check_out(out, s, index)
    if s == 0:
        return has_vote, value_id
    fn = _K8.fn or _K8.resolve()
    rc = fn(_K8.pack(vote_rounds.data_ptr(), value_ids.data_ptr(), s, n,
                     has_vote.data_ptr(), value_id.data_ptr(), index,
                     _build.stream_handle(index)))
    if rc:
        _K8.check(rc)
    safe_values.launches += 1
    return has_vote, value_id


safe_values.launches = 0


def recovery_staging(device=None) -> None:
    """Make ``device``'s staging for :func:`safe_values_staged` (its
    stream) and look up its C entry (the library built and loaded) now,
    so that a first recovery pays for neither; nothing on the CPU."""
    if _build.staging(_STAGING, device) is not None:
        _K8_STAGED.fn or _K8_STAGED.resolve()


def _recovery_cells(rows: int, n: int) -> int:
    """int32 cells of the staged call's pinned block: rounds and ids
    ``[rows, n]`` each, then value_id ``[rows]`` int32 and has_vote
    ``[rows]`` bytes."""
    return 2 * rows * n + rows + (rows + 3) // 4


def recovery_matrices(rows: int, n: int, device=None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The Leader's ``[rows, n]`` int32 recovery matrices for
    :func:`safe_values_staged` on ``device`` (the current card when None;
    ``"cpu"`` runs the plain version): vote rounds prefilled with
    ``NO_VOTE`` and value ids with 0. On a card they are zero-copy views
    of one reused pinned block (rounds, then ids, side by side, then
    room for the result), good until the next call for the same device;
    on the CPU, fresh arrays."""
    staging = _build.staging(_STAGING, device)
    if staging is None:
        return (np.full((rows, n), NO_VOTE, dtype=np.int32),
                np.zeros((rows, n), dtype=np.int32))
    cells = rows * n
    block = staging.pair("recovery", _recovery_cells(rows, n), torch.int32,
                         on_card=False).host
    block[:cells] = NO_VOTE
    block[cells:2 * cells] = 0
    return (block[:cells].reshape(rows, n),
            block[cells:2 * cells].reshape(rows, n))


def safe_values_staged(vote_rounds: np.ndarray, value_ids: np.ndarray,
                       device=None) -> tuple[np.ndarray, np.ndarray]:
    """K8 on two ``[rows, n]`` int32 host matrices: ``(has_vote [rows]
    bool, value_id [rows] int32)`` as fresh arrays. On a card (the
    current one when ``device`` is None) the matrices that
    :func:`recovery_matrices` handed out are read where they lie, and
    any others are copied into its pinned block first; then ONE
    ``ctypes`` call, with the GIL released, launches the kernel on the
    pinned block in place, its result written after the matrices, and
    waits on the staging's own stream. ``device="cpu"`` runs
    :func:`safe_values_plain`."""
    rounds = np.asarray(vote_rounds)
    ids = np.asarray(value_ids)
    if rounds.dtype != np.int32 or ids.dtype != np.int32 \
            or rounds.ndim != 2 or ids.shape != rounds.shape:
        raise ValueError(
            f"safe_values_staged takes two [rows, n] int32 matrices, got "
            f"{rounds.dtype} {rounds.shape} and {ids.dtype} {ids.shape}")
    if rounds.shape[1] == 0:
        raise ValueError("safe_values needs at least one acceptor column")
    staging = _build.staging(_STAGING, device)
    if staging is None:
        has_vote, value_id = safe_values_plain(
            torch.from_numpy(np.ascontiguousarray(rounds)),
            torch.from_numpy(np.ascontiguousarray(ids)))
        return has_vote.numpy(), value_id.numpy()
    rows, n = rounds.shape
    if rows == 0:
        return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int32)
    cells = rows * n
    block = staging.pair("recovery", _recovery_cells(rows, n), torch.int32,
                         on_card=False)
    if rounds.ctypes.data != block.host_ptr \
            or ids.ctypes.data != block.host_ptr + 4 * cells \
            or not (rounds.flags.c_contiguous and ids.flags.c_contiguous):
        # Copies first: either matrix may be a view of the block.
        rounds, ids = np.array(rounds), np.array(ids)
        block.host[:cells].reshape(rows, n)[...] = rounds
        block.host[cells:2 * cells].reshape(rows, n)[...] = ids
    fn = _K8_STAGED.fn or _K8_STAGED.resolve()
    rc = fn(_K8_STAGED.pack(block.host_ptr, rows, n, staging.index,
                            staging.stream_handle))
    if rc:
        _K8_STAGED.check(rc)
    safe_values.launches += 1
    # value_id [rows] int32, then has_vote [rows] bytes, after the
    # matrices.
    has_vote = 4 * (2 * cells + rows)
    return (block.host.view(np.bool_)[has_vote:has_vote + rows].copy(),
            block.host[2 * cells:2 * cells + rows].copy())


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
