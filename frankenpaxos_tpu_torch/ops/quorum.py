"""The dense vote board and ``TpuQuorumChecker`` on one GPU.

Counterpart of ``frankenpaxos_tpu/ops/quorum.py``. The board keeps the
reference's ``votes[acceptors, window]`` layout (slot-major, so the
threads of a warp read neighbouring bytes of one acceptor row) and its
ring semantics: column ``slot % window`` holds slot ``slot`` and carries
its OWNER slot, so wrapping is self-reclaiming.

Two kernels live here, each beside its plain PyTorch version:

  * K1 :func:`quorum_hit` -- the quorum predicate over a vote block
    (the reference's ``_check_block`` / ``_check_batch``);
  * K2 :func:`record_block` -- the dense board update for one
    contiguous slot block (the reference's ``_record_block``).

A wrapper launches its CUDA kernel (``csrc/quorum.cu``) for CUDA tensors
and runs the plain version only for CPU tensors; it never falls back.
The JAX reference donates the board; here the board tensors are updated
IN PLACE.

The sparse scatter path (``record_and_check``), ``release``,
``reshape`` and the epoch / multi-config checkers are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.quorums.spec import ANY, QuorumSpec
import numpy as np
import torch

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def int32(x: int) -> int:
    """``x`` as an int32 value; raises ``OverflowError`` outside the
    int32 range (as the reference's ``jnp.int32(x)`` does) rather than
    letting a C ``int`` argument truncate it."""
    x = int(x)
    if not _INT32_MIN <= x <= _INT32_MAX:
        raise OverflowError(f"{x} does not fit in int32")
    return x


class VoteBoard(NamedTuple):
    """Per-slot vote-collection state for a window of slots (a ring over
    slot space; see the module docstring). Updated in place."""

    votes: torch.Tensor   # [n, window] uint8: acceptor voted in `rounds`
    rounds: torch.Tensor  # [window] int32: highest round seen per slot
    chosen: torch.Tensor  # [window] bool: quorum already reached
    owner: torch.Tensor   # [window] int32: slot occupying the column


_BOARD_DTYPES = (torch.uint8, torch.int32, torch.bool, torch.int32)


def make_vote_board(window: int, num_nodes: int, device=None) -> VoteBoard:
    """A fresh board on ``device`` (``cuda`` when None; raises without a
    GPU)."""
    device = resolve_device(device)
    return VoteBoard(
        votes=torch.zeros((num_nodes, window), dtype=torch.uint8,
                          device=device),
        rounds=torch.full((window,), -1, dtype=torch.int32, device=device),
        chosen=torch.zeros((window,), dtype=torch.bool, device=device),
        owner=torch.full((window,), -1, dtype=torch.int32, device=device),
    )


def grid_layout(masks, thresholds, combine_any: bool):
    """Detect a Grid quorum predicate in factored (masks, thresholds)
    form (a copy of the reference's ``grid_layout``).

    Returns ``(kind, rows, cols, perm)`` when the spec is a grid:
    ``kind`` is ``"write"`` (thresholds all 1, ALL-combine) or ``"read"``
    (thresholds == row sizes, ANY-combine); ``perm`` is a column
    permutation into row-major ``[rows, cols]`` order, or None when the
    universe is already row-major. Returns None for anything else.
    """
    masks = np.asarray(masks, dtype=np.uint8)
    thresholds = np.asarray(thresholds, dtype=np.int64)
    if masks.ndim != 2:
        return None
    g, n = masks.shape
    if g < 1 or n < 1 or n % g != 0:
        return None
    cols = n // g
    if not (masks.sum(axis=0) == 1).all():
        return None
    if not (masks.sum(axis=1) == cols).all():
        return None
    if combine_any:
        if not (thresholds == cols).all():
            return None
        kind = "read"
    else:
        if not (thresholds == 1).all():
            return None
        kind = "write"
    perm = np.concatenate([np.flatnonzero(masks[r]) for r in range(g)])
    if (perm == np.arange(n)).all():
        return kind, g, cols, None
    return kind, g, cols, tuple(int(x) for x in perm)


def spec_statics(spec: QuorumSpec) -> tuple[tuple, tuple]:
    """``(masks_t, meta)`` with ``meta = (thresholds_t, combine_any,
    grid_or_None)``: the reference's ``_spec_statics``."""
    masks_t = tuple(tuple(int(x) for x in row) for row in spec.masks)
    combine_any = spec.combine == ANY
    thresholds_t = tuple(int(t) for t in spec.thresholds)
    meta = (thresholds_t, combine_any,
            grid_layout(spec.masks, spec.thresholds, combine_any))
    return masks_t, meta


class QuorumPredicate(NamedTuple):
    """A quorum predicate laid out for the kernels on one device."""

    masks: torch.Tensor       # [G, N] int32
    thresholds: torch.Tensor  # [G] int32
    perm: torch.Tensor        # [N] int32 row-major grid order (identity)
    combine_any: bool
    grid: Optional[tuple]     # grid_layout(...) or None

    @property
    def num_nodes(self) -> int:
        return self.masks.shape[1]

    def c_args(self) -> tuple:
        """The predicate arguments of every C entry point."""
        g, n = self.masks.shape
        kind, rows, cols = 0, 0, 0
        if self.grid is not None:
            kind = 1 if self.grid[0] == "write" else 2
            rows, cols = self.grid[1], self.grid[2]
        return (self.masks.data_ptr(), self.thresholds.data_ptr(),
                self.perm.data_ptr(), n, g, int(self.combine_any), kind,
                rows, cols)


def make_predicate(masks, thresholds, combine_any: bool,
                   device=None) -> QuorumPredicate:
    """The predicate of ``masks [G, N]``, ``thresholds [G]`` and the
    any/all combiner on ``device``, with its grid form detected by
    :func:`grid_layout` (as the reference selects its branch)."""
    device = resolve_device(device)
    masks = np.asarray(masks, dtype=np.int32)
    thresholds = np.asarray(thresholds, dtype=np.int32)
    if masks.ndim != 2 or thresholds.shape != (masks.shape[0],):
        raise ValueError(f"masks {masks.shape} and thresholds "
                         f"{thresholds.shape} are not [G, N] and [G]")
    grid = grid_layout(masks, thresholds, combine_any)
    n = masks.shape[1]
    perm = np.arange(n, dtype=np.int32) if grid is None or grid[3] is None \
        else np.asarray(grid[3], dtype=np.int32)
    return QuorumPredicate(
        masks=torch.from_numpy(np.ascontiguousarray(masks)).to(device),
        thresholds=torch.from_numpy(thresholds).to(device),
        perm=torch.from_numpy(perm).to(device),
        combine_any=bool(combine_any), grid=grid)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel (every tensor on one CUDA device),
    False to run the plain version (every tensor on the CPU)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors span several CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take CUDA "
                     f"tensors and the plain versions CPU tensors, "
                     f"never a mix")


# --- K1: the quorum predicate ----------------------------------------------


def quorum_hit_plain(votes: torch.Tensor,
                     pred: QuorumPredicate) -> torch.Tensor:
    """Plain PyTorch version of K1: ``[N, B]`` uint8 votes (any strides)
    -> ``[B]`` bool, taking the same branch as the reference's
    ``_predicate_hit``: the uint8 OR/AND grid chain, or the int32
    weighted count against the thresholds."""
    if pred.grid is not None:
        kind, rows, cols, perm = pred.grid
        row_of = (lambda i: votes[i]) if perm is None \
            else (lambda i: votes[perm[i]])
        acc = None
        for r in range(rows):
            row = row_of(r * cols)
            for c in range(1, cols):
                cell = row_of(r * cols + c)
                row = (row | cell) if kind == "write" else (row & cell)
            acc = row if acc is None \
                else ((acc & row) if kind == "write" else (acc | row))
        return acc.to(torch.bool)
    # Elementwise product and int32 sum: the matmul's arithmetic without
    # a matmul (CUDA has no int32 matmul).
    counts = (pred.masks[:, :, None]
              * votes.to(torch.int32)[None, :, :]).sum(1, dtype=torch.int32)
    satisfied = counts >= pred.thresholds[:, None]
    return satisfied.any(0) if pred.combine_any else satisfied.all(0)


def quorum_hit(votes: torch.Tensor, pred: QuorumPredicate) -> torch.Tensor:
    """K1: ``[N, B]`` uint8 vote block -> ``[B]`` bool quorum hits.

    ``votes`` may have any strides (``check_batch`` passes a transposed
    ``[B, N]`` view, which the kernel reads in place). CUDA tensors
    launch ``csrc/quorum.cu::quorum_hit_kernel``; CPU tensors take
    :func:`quorum_hit_plain`."""
    if votes.dtype != torch.uint8 or votes.dim() != 2:
        raise ValueError(f"votes must be a 2-D uint8 tensor, got "
                         f"{votes.dtype} {tuple(votes.shape)}")
    n, b = votes.shape
    if n != pred.num_nodes:
        raise ValueError(f"votes have {n} rows, predicate has "
                         f"{pred.num_nodes} nodes")
    if not use_kernel(votes, pred.masks):
        return quorum_hit_plain(votes, pred)
    out = torch.empty((b,), dtype=torch.bool, device=votes.device)
    if b == 0:
        return out
    lib = _build.library("quorum")
    rc = lib.fpx_quorum_hit(
        votes.data_ptr(), votes.stride(0), votes.stride(1), b,
        out.data_ptr(), *pred.c_args(), *_build.stream_args(votes.device))
    _build.check("quorum", "fpx_quorum_hit", rc)
    quorum_hit.launches += 1
    return out


quorum_hit.launches = 0


# --- K2: the dense board update --------------------------------------------


def record_block_plain(board: VoteBoard, start: int, true_start: int,
                       block: torch.Tensor, vote_round: int,
                       pred: QuorumPredicate) -> torch.Tensor:
    """Plain PyTorch version of K2 (the reference's ``_record_block``):
    records ``block [N, B]`` for columns ``[start, start + B)`` holding
    slots from ``true_start``, all in round ``vote_round``; updates the
    board in place and returns the ``[B]`` newly-chosen mask."""
    dev = board.votes.device
    b = block.shape[1]
    cols_sl = slice(start, start + b)
    touched = (block != 0).any(0)
    # Ring self-reclaim; slot ids wrap as int32 like the reference's.
    slot_ids = (torch.tensor(true_start, dtype=torch.int32, device=dev)
                + torch.arange(b, dtype=torch.int32, device=dev))
    old_owner = board.owner[cols_sl]
    claim = touched & (slot_ids > old_owner)
    stale = touched & (slot_ids < old_owner)
    touched = touched & ~stale
    new_owner = torch.where(claim, slot_ids, old_owner)
    block = block & touched[None, :].to(torch.uint8)

    vote_round_t = torch.tensor(vote_round, dtype=torch.int32, device=dev)
    old_rounds = torch.where(claim, -1, board.rounds[cols_sl])
    new_rounds = torch.where(touched, torch.maximum(old_rounds, vote_round_t),
                             old_rounds)
    preempted = new_rounds > old_rounds
    cols = torch.where((claim | preempted)[None, :], 0,
                       board.votes[:, cols_sl])
    live = touched & (vote_round_t == new_rounds)
    cols = cols | (block & live[None, :].to(torch.uint8))

    hit = quorum_hit_plain(cols, pred)
    old_chosen = torch.where(claim, False, board.chosen[cols_sl])
    newly = hit & ~old_chosen & touched
    board.votes[:, cols_sl] = cols
    board.rounds[cols_sl] = new_rounds
    board.chosen[cols_sl] = hit | old_chosen
    board.owner[cols_sl] = new_owner
    return newly


def record_block(board: VoteBoard, start: int, true_start: int,
                 block: torch.Tensor, vote_round: int,
                 pred: QuorumPredicate) -> torch.Tensor:
    """K2: the dense board update for one contiguous block, IN PLACE.

    ``block`` is ``[N, B]`` uint8 with ``start + B <= window``;
    ``true_start`` is the slot number of column ``start``. Returns the
    ``[B]`` newly-chosen mask. CUDA tensors launch
    ``csrc/quorum.cu::record_block_kernel``; CPU tensors take
    :func:`record_block_plain`."""
    n, window = board.votes.shape
    if block.dtype != torch.uint8 or block.dim() != 2 \
            or block.shape[0] != n:
        raise ValueError(f"block must be [{n}, B] uint8, got {block.dtype} "
                         f"{tuple(block.shape)}")
    if n != pred.num_nodes:
        raise ValueError(f"board has {n} rows, predicate has "
                         f"{pred.num_nodes} nodes")
    b = block.shape[1]
    start, true_start, vote_round = (int32(start), int32(true_start),
                                     int32(vote_round))
    if not 0 <= start <= window - b:
        raise ValueError(f"block [{start}, {start + b}) outside the "
                         f"window {window}")
    if tuple(t.dtype for t in board) != _BOARD_DTYPES \
            or board.rounds.shape != (window,) \
            or any(t.shape != board.rounds.shape for t in board[2:]):
        raise ValueError("board tensors do not match make_vote_board's")
    if not use_kernel(block, *board, pred.masks):
        return record_block_plain(board, start, true_start, block,
                                  vote_round, pred)
    if not all(t.is_contiguous() for t in (block, *board)):
        raise ValueError("record_block needs contiguous tensors")
    newly = torch.empty((b,), dtype=torch.bool, device=block.device)
    if b == 0:
        return newly
    lib = _build.library("quorum")
    rc = lib.fpx_record_block(
        board.votes.data_ptr(), board.rounds.data_ptr(),
        board.chosen.data_ptr(), board.owner.data_ptr(), window,
        block.data_ptr(), b, start, true_start, vote_round, newly.data_ptr(),
        *pred.c_args(), *_build.stream_args(block.device))
    _build.check("quorum", "fpx_record_block", rc)
    record_block.launches += 1
    return newly


record_block.launches = 0


# --- stateless wrappers -------------------------------------------------------


def check_block(block: torch.Tensor, pred: QuorumPredicate) -> torch.Tensor:
    """``[N, B]`` slot-major vote block -> ``[B]`` bool (stateless); the
    reference's ``_check_block``."""
    return quorum_hit(block, pred)


def check_batch(present: torch.Tensor, pred: QuorumPredicate) -> torch.Tensor:
    """``[B, N]`` responder rows -> ``[B]`` bool (stateless); the
    reference's ``_check_batch``. The kernel reads the rows through a
    transposed view: no copy."""
    return quorum_hit(present.t(), pred)


def _bucket(b: int) -> int:
    padded = 64
    while padded < b:
        padded *= 2
    return padded


class TpuQuorumChecker:
    """Stateful batched quorum checking for one quorum predicate, on one
    device (the reference's ``TpuQuorumChecker``, dense half).

    Typical use (ProxyLeader Phase2b path)::

        checker = TpuQuorumChecker(qs.write_spec(), window=1 << 20)
        hits = checker.check_block(arrivals)          # drain-local
        newly = checker.record_block(start_slot, arrivals, vote_round=3)

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the plain versions. The board lives on the
    device and is updated in place.
    """

    def __init__(self, spec: QuorumSpec, window: int, device=None):
        self.device = resolve_device(device)
        if window <= 0:
            raise ValueError("window must be positive")
        self.spec = spec
        self.window = window
        self.num_nodes = spec.num_nodes
        # Ring-invariant surveillance ("window > max slots in flight"):
        # a vote trailing the newest recorded slot by >= window may land
        # on a reclaimed column and be dropped on device. Counted here
        # from the slot numbers, with no sync.
        self._max_slot_seen = -1
        self.window_violations = 0
        self._masks_t, self._meta = spec_statics(spec)
        self._pred = make_predicate(self._masks_t, *self._meta[:2],
                                    device=self.device)
        self.board = make_vote_board(window, spec.num_nodes, self.device)

    def _to_device(self, block: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            block, dtype=np.uint8)).to(self.device)

    def record_block_async(self, start_slot: int, block: np.ndarray,
                           vote_round: int = 0) -> torch.Tensor:
        """Like :meth:`record_block` but returns the DEVICE newly-chosen
        mask without waiting. It keeps the PADDED bucket length (entries
        past the input width are padding)."""
        n, b = block.shape
        if n != self.num_nodes:
            raise ValueError(f"block has {n} acceptor rows, spec has "
                             f"{self.num_nodes}")
        start = start_slot % self.window
        if start + b > self.window:
            raise ValueError(
                f"block [{start}, {start + b}) straddles the ring end "
                f"(window {self.window}); split it")
        self._note_slot_span(start_slot, start_slot + b - 1)
        padded = _bucket(b)
        # Power-of-two buckets from 64, but no padding across the ring
        # end: a bucket that would cross it keeps the exact width.
        if padded != b and start + padded <= self.window:
            block = np.concatenate(
                [np.asarray(block, dtype=np.uint8),
                 np.zeros((n, padded - b), dtype=np.uint8)], axis=1)
        return record_block(self.board, start, int32(start_slot),
                            self._to_device(block), int32(vote_round),
                            self._pred)

    def record_block(self, start_slot: int, block: np.ndarray,
                     vote_round: int = 0) -> np.ndarray:
        """Dense path: record ``block[n, B]`` arrivals for slots
        ``[start_slot, start_slot + B)`` (must not straddle the ring
        end); return the ``[B]`` newly-chosen mask."""
        b = block.shape[1]
        return self.record_block_async(start_slot, block,
                                       vote_round).cpu().numpy()[:b]

    def check_block_async(self, block: np.ndarray) -> torch.Tensor:
        """Stateless drain-local quorum over a ``[n, B]`` vote block:
        returns the DEVICE ``[B]`` hit mask, padded to the bucket."""
        n, b = block.shape
        if n != self.num_nodes:
            raise ValueError(f"block has {n} acceptor rows, spec has "
                             f"{self.num_nodes}")
        padded = _bucket(b)
        if padded != b:
            block = np.concatenate(
                [np.asarray(block, dtype=np.uint8),
                 np.zeros((n, padded - b), dtype=np.uint8)], axis=1)
        return check_block(self._to_device(block), self._pred)

    def check_block(self, block: np.ndarray) -> np.ndarray:
        """Synchronous :meth:`check_block_async`, sliced to the input
        width."""
        b = block.shape[1]
        return self.check_block_async(block).cpu().numpy()[:b]

    def check_batch(self, present: np.ndarray) -> np.ndarray:
        """Stateless: evaluate the predicate for ``[B, N]`` responder
        rows (taken as uint8)."""
        present = np.asarray(present, dtype=np.uint8)
        if present.ndim != 2 or present.shape[1] != self.num_nodes:
            raise ValueError(f"present must be [B, {self.num_nodes}], got "
                             f"{present.shape}")
        return check_batch(self._to_device(present),
                           self._pred).cpu().numpy()

    def _note_slot_span(self, lowest: int, highest: int) -> None:
        """Flag votes that trail the frontier by >= window (they may hit
        a self-reclaimed column and be dropped on device). The batch's
        own span counts too."""
        if max(self._max_slot_seen, highest) - lowest >= self.window:
            self.window_violations += 1
            if self.window_violations == 1:
                import warnings

                warnings.warn(
                    f"TpuQuorumChecker: vote for slot {lowest} trails the "
                    f"frontier ({self._max_slot_seen}) by >= window "
                    f"({self.window}); straggler votes may be silently "
                    f"dropped -- raise `window` above the max slots in "
                    f"flight (further violations counted in "
                    f"`window_violations` without warning)",
                    RuntimeWarning, stacklevel=3)
        if highest > self._max_slot_seen:
            self._max_slot_seen = highest
