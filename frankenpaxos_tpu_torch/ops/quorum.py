"""The vote board, ``TpuQuorumChecker`` and the epoch / multi-config
checkers on one GPU.

Counterpart of ``frankenpaxos_tpu/ops/quorum.py``. The board keeps the
reference's ``votes[acceptors, window]`` layout (slot-major, so the
threads of a warp read neighbouring bytes of one acceptor row) and its
ring semantics: column ``slot % window`` holds slot ``slot`` and carries
its OWNER slot, so wrapping is self-reclaiming.

Seven kernels live here, each beside its plain PyTorch version:

  * K1 :func:`quorum_hit` -- the quorum predicate over a vote block
    (the reference's ``_check_block`` / ``_check_batch``);
  * K2 :func:`record_block` -- the dense board update for one
    contiguous slot block (``_record_block``);
  * K4 :func:`record_and_check` -- the sparse scatter of straggler
    votes (``_apply_sparse_votes`` + ``_record_and_check``);
  * K5 :func:`release` -- the column reset of GC'd slots (``_release``);
  * K6 :func:`record_and_check_epochs` and :func:`check_batch_multi` --
    the epoch-segmented scatter and the per-row multi-config predicate
    (``_record_and_check_epochs``, ``_check_batch_multi``);
  * K7 :func:`reshape_columns` -- the epoch reshape gather of the
    acceptor axis (``_reshape_columns``).

(K3, the fused drain, is in ``bench/pipeline.py``.) A wrapper launches
its CUDA kernel (``csrc/quorum.cu``, ``sparse.cu``, ``epoch.cu``) for
CUDA tensors and runs the plain version only for CPU tensors; it never
falls back. The JAX reference donates the board; here the board tensors
are updated IN PLACE (K7 alone writes a new tensor).

The board may be split over a ``mesh.Mesh`` of ``torch.distributed``
ranks (the reference's ``_shard_board``: the slot columns over every
mesh axis, the acceptor axis whole on each shard). No kernel is needed
for that beyond the ones above: with the acceptor axis whole, every
per-column step of K2, K4, K5, K6 and K7 is local to the rank that holds
the column, and the only value that crosses ranks is the per-lane
result, which one rank computes. So the partitioned program is host
arithmetic that maps each call onto local columns (no launch), the
unchanged kernels on the local ``[N, W / size]`` board, and one
all-reduce of the per-lane result per call (the sharded section below).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.quorums.spec import ANY, pad_specs, QuorumSpec
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


def make_vote_board(window: int, num_nodes: int, device=None,
                    mesh=None) -> VoteBoard:
    """A fresh board on ``device`` (``cuda`` when None; raises without a
    GPU). With a ``mesh``, this rank's shard of a ``window``-column board
    (:func:`shard_board`'s columns, on the mesh's device); raises unless
    the mesh size divides ``window``."""
    if mesh is not None:
        lo, hi = mesh.columns(window)
        window, device = hi - lo, mesh_device(mesh, device)
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


def stage(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device`` WITHOUT waiting for the
    device: a CUDA copy goes through a pinned host buffer (PyTorch's
    caching host allocator keeps it alive until the copy is done) and is
    enqueued on the current stream, so a drain that dispatches kernels
    never blocks on the ones before it. On the CPU, a copy."""
    array = np.ascontiguousarray(array)
    if device.type != "cuda":
        return torch.from_numpy(array.copy()).to(device)
    dtype = torch.from_numpy(np.empty(0, dtype=array.dtype)).dtype
    host = torch.empty(array.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = array
    return host.to(device, non_blocking=True)


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


# --- K4 / K6 shared: the sparse board update --------------------------------

#: The reference's ``_NEG_INF32``: the "no candidate" value of a lane's
#: owner and round max.
NEG_INF32 = -(2**31) + 1
LANE_FIELDS = 5  # slots % window, true slots, nodes, rounds, valid


def pack_lanes(slots, true_slots, nodes, vote_rounds, valid,
               size: Optional[int] = None) -> np.ndarray:
    """The ``[5, size]`` int32 lane array the sparse kernels take: slots
    (already reduced mod window), true slots, acceptor rows, rounds and
    valid (0/1), each assigned into int32 as the reference packs them
    (so true slots past 2^31 - 1 wrap), then padding lanes up to
    ``size`` at slot 0 with valid 0."""
    b = np.shape(slots)[0]
    lanes = np.zeros((LANE_FIELDS, max(b, size or 0)), dtype=np.int32)
    for row, values in enumerate((slots, true_slots, nodes, vote_rounds,
                                  valid)):
        lanes[row, :b] = values
    return lanes


def _checker_lanes(slots: np.ndarray, node_cols, rounds, window: int,
                   size: int) -> np.ndarray:
    """The checkers' packing of one batch of votes (all valid; rounds 0
    when None), padded to ``size``."""
    b = slots.shape[0]
    rounds = np.zeros(b, dtype=np.int32) if rounds is None \
        else np.asarray(rounds, dtype=np.int32)
    return pack_lanes(slots % window, slots,
                      np.asarray(node_cols, dtype=np.int32), rounds,
                      np.ones(b, dtype=bool), size)


def _check_lanes(board: VoteBoard, lanes: torch.Tensor) -> int:
    n, window = board.votes.shape
    if lanes.dtype != torch.int32 or lanes.dim() != 2 \
            or lanes.shape[0] != LANE_FIELDS:
        raise ValueError(f"lanes must be [{LANE_FIELDS}, B] int32, got "
                         f"{lanes.dtype} {tuple(lanes.shape)}")
    if tuple(t.dtype for t in board) != _BOARD_DTYPES \
            or board.rounds.shape != (window,) \
            or any(t.shape != board.rounds.shape for t in board[2:]):
        raise ValueError("board tensors do not match make_vote_board's")
    return lanes.shape[1]


def _launch_sparse(entry: str, source: str, board: VoteBoard,
                   lanes: torch.Tensor, extra: tuple,
                   pred_args: tuple) -> torch.Tensor:
    """Launch one of the single-block sparse kernels (K4, K6): the board,
    the lanes, ``extra`` arguments, the ``newly`` output and a scratch
    buffer, then the predicate's ``pred_args``. Returns ``newly``; the
    caller, which has made sure ``B > 0``, counts the launch."""
    if not all(t.is_contiguous() for t in (lanes, *board)):
        raise ValueError(f"{entry} needs contiguous tensors")
    b = lanes.shape[1]
    newly = torch.empty((b,), dtype=torch.bool, device=lanes.device)
    scratch = torch.empty((2 * b,), dtype=torch.int32, device=lanes.device)
    n, window = board.votes.shape
    lib = _build.library(source)
    rc = getattr(lib, entry)(
        board.votes.data_ptr(), board.rounds.data_ptr(),
        board.chosen.data_ptr(), board.owner.data_ptr(), window,
        lanes.data_ptr(), b, *extra, newly.data_ptr(), scratch.data_ptr(),
        *pred_args, *_build.stream_args(lanes.device))
    _build.check(source, entry, rc)
    return newly


_INT32_MIN = -(2**31)


def _lane_max(inv: torch.Tensor, values: torch.Tensor,
              num_cols: int) -> torch.Tensor:
    """Per-column max of per-lane int32 ``values`` (``inv`` maps each lane
    to its column), starting from int32's least value, which a lane that
    writes nothing contributes: the reference's ``.at[slots].max`` as an
    order-free reduction."""
    out = torch.full((num_cols,), _INT32_MIN, dtype=torch.int32,
                     device=values.device)
    return out.scatter_reduce_(0, inv, values, "amax")


def _apply_sparse_votes_plain(board: VoteBoard, lanes: torch.Tensor):
    """Plain PyTorch version of the shared sparse update (the reference's
    ``_apply_sparse_votes``), on the batch's UNIQUE columns: every
    per-slot value is equal across a slot's duplicate lanes, so each
    phase is a per-column max (``scatter_reduce_`` "amax", order-free)
    and the write-back has no duplicate index. Returns ``(cols, inv,
    mine, votes [N, U], rounds [U], chosen0 [U], owner [U], writes)``;
    the board is not written.

    A slot outside ``[0, window)`` follows JAX's index rules: a negative
    slot counts from the end; one still out of range reads the clamped
    column and writes nothing (``writes`` is false for its lane)."""
    n, window = board.votes.shape
    slots, true_slots, nodes, vote_rounds = lanes[:4]
    valid = lanes[4] != 0
    neg = torch.tensor(NEG_INF32, dtype=torch.int32, device=lanes.device)
    none = torch.tensor(_INT32_MIN, dtype=torch.int32, device=lanes.device)
    s = slots.long()
    s = torch.where(s < 0, s + window, s)
    writes = (s >= 0) & (s < window)
    cols, inv = torch.unique(s.clamp(0, window - 1), return_inverse=True)
    u = cols.numel()
    # Ring self-reclaim: a newer slot claims its column.
    old_owner = board.owner[cols]
    owner = torch.maximum(old_owner, _lane_max(
        inv, torch.where(writes, torch.where(valid, true_slots, neg), none),
        u))
    reclaimed = owner > old_owner
    mine = valid & (true_slots == owner[inv])
    votes = torch.where(reclaimed[None, :], 0, board.votes[:, cols])
    rounds0 = torch.where(reclaimed, -1, board.rounds[cols])
    chosen0 = board.chosen[cols] & ~reclaimed
    # A newer round preempts the column's votes.
    rounds = torch.maximum(rounds0, _lane_max(
        inv, torch.where(writes, torch.where(mine, vote_rounds, neg), none),
        u))
    votes = torch.where((rounds > rounds0)[None, :], 0, votes)
    # votes.at[nodes, slots].max(live): JAX normalises a negative node
    # and drops one still out of range.
    live = mine & (vote_rounds == rounds[inv])
    node = torch.where(nodes < 0, nodes + n, nodes)
    cast = live & writes & (node >= 0) & (node < n)
    flat = node.long()[cast] * u + inv[cast]
    got = torch.zeros((n * u,), dtype=torch.int32, device=lanes.device)
    got.scatter_reduce_(0, flat, torch.ones_like(flat, dtype=torch.int32),
                        "amax")
    votes = torch.maximum(votes, got.view(n, u).to(torch.uint8))
    return cols, inv, mine, votes, rounds, chosen0, owner, writes


def _finish_sparse_plain(board: VoteBoard, cols, inv, mine, votes, rounds,
                         chosen0, owner, writes,
                         hit: torch.Tensor) -> torch.Tensor:
    """``newly = hit & ~chosen0``, ``chosen.at[slots].max(hit)``, and the
    write-back of the unique columns (``index_copy_`` with no duplicate
    index, so no order question; a column only lanes that write nothing
    name is written back unchanged)."""
    hit = hit & mine
    newly = hit & ~chosen0[inv]
    chosen = chosen0 | (_lane_max(inv, (hit & writes).to(torch.int32),
                                  cols.numel()) > 0)
    board.votes.index_copy_(1, cols, votes)
    board.rounds.index_copy_(0, cols, rounds)
    board.chosen.index_copy_(0, cols, chosen)
    board.owner.index_copy_(0, cols, owner)
    return newly


# --- K4: the sparse scatter ---------------------------------------------------


def record_and_check_plain(board: VoteBoard, lanes: torch.Tensor,
                           pred: QuorumPredicate) -> torch.Tensor:
    """Plain PyTorch version of K4 (the reference's ``_record_and_check``):
    updates the board in place and returns the per-lane ``[B]`` "slot
    newly has quorum" mask."""
    state = _apply_sparse_votes_plain(board, lanes)
    cols, inv, mine, votes = state[:4]
    hit = quorum_hit_plain(votes, pred)[inv]
    return _finish_sparse_plain(board, *state, hit)


def record_and_check(board: VoteBoard, lanes: torch.Tensor,
                     pred: QuorumPredicate) -> torch.Tensor:
    """K4: the sparse scatter of one batch of votes, IN PLACE.

    ``lanes`` is the ``[5, B]`` int32 array of :func:`pack_lanes`. Slots
    and nodes out of range follow JAX's index rules: a negative one
    counts from the end; a slot still outside ``[0, window)`` reads the
    clamped column and writes nothing, a node outside ``[-N, N)``
    records nothing. Duplicate slots each report quorum.
    CUDA tensors launch ``csrc/sparse.cu::record_and_check_kernel`` (one
    thread block, ordered phases); CPU tensors take
    :func:`record_and_check_plain`."""
    n = board.votes.shape[0]
    b = _check_lanes(board, lanes)
    if n != pred.num_nodes:
        raise ValueError(f"board has {n} rows, predicate has "
                         f"{pred.num_nodes} nodes")
    if not use_kernel(lanes, *board, pred.masks):
        return record_and_check_plain(board, lanes, pred)
    if b == 0:
        return torch.empty((0,), dtype=torch.bool, device=lanes.device)
    newly = _launch_sparse("fpx_record_and_check", "sparse", board, lanes,
                           (), pred.c_args())
    record_and_check.launches += 1
    return newly


record_and_check.launches = 0


# --- K5: release ----------------------------------------------------------------


def release_plain(board: VoteBoard, slots: torch.Tensor,
                  valid: torch.Tensor) -> None:
    """Plain PyTorch version of K5 (the reference's ``_release``): reset
    every column a valid lane names (a negative slot counts from the
    end, one out of range is dropped, as JAX's scatter does)."""
    window = board.votes.shape[1]
    s = slots.long()
    s = torch.where(s < 0, s + window, s)
    cols = torch.unique(s[valid & (s >= 0) & (s < window)])
    board.votes.index_fill_(1, cols, 0)
    board.rounds.index_fill_(0, cols, -1)
    board.chosen.index_fill_(0, cols, False)
    board.owner.index_fill_(0, cols, -1)


def release(board: VoteBoard, slots: torch.Tensor,
            valid: torch.Tensor) -> None:
    """K5: reset the columns of GC'd slots IN PLACE: votes 0, round -1,
    chosen false, owner -1, for each lane whose ``valid`` is true.

    ``slots`` is ``[B]`` int32, ``valid`` ``[B]`` bool. A slot named by
    several lanes is reset when ANY of them is valid (JAX's ``.set``
    leaves the order of such duplicates unspecified; every caller passes
    all-valid lanes). CUDA tensors launch
    ``csrc/sparse.cu::release_kernel``; CPU tensors take
    :func:`release_plain`."""
    n, window = board.votes.shape
    if slots.dtype != torch.int32 or valid.dtype != torch.bool \
            or slots.dim() != 1 or valid.shape != slots.shape:
        raise ValueError("release takes [B] int32 slots and [B] bool valid")
    if not use_kernel(slots, valid, *board):
        return release_plain(board, slots, valid)
    if not all(t.is_contiguous() for t in (slots, valid, *board)):
        raise ValueError("release needs contiguous tensors")
    b = slots.shape[0]
    if b == 0:
        return None
    lib = _build.library("sparse")
    rc = lib.fpx_release(
        board.votes.data_ptr(), board.rounds.data_ptr(),
        board.chosen.data_ptr(), board.owner.data_ptr(), window, n,
        slots.data_ptr(), valid.data_ptr(), b,
        *_build.stream_args(slots.device))
    _build.check("sparse", "fpx_release", rc)
    release.launches += 1
    return None


release.launches = 0


# --- K6: the multi-config predicate and the epoch-segmented scatter -----------


class MultiPredicate(NamedTuple):
    """Padded per-configuration planes (``pad_specs``) on one device."""

    masks: torch.Tensor        # [K, G, N] int32
    thresholds: torch.Tensor   # [K, G] int32
    combine_any: torch.Tensor  # [K] bool

    @property
    def num_nodes(self) -> int:
        return self.masks.shape[2]

    def c_args(self) -> tuple:
        k, g, n = self.masks.shape
        return (self.masks.data_ptr(), self.thresholds.data_ptr(),
                self.combine_any.data_ptr(), k, g, n)


def make_multi_predicate(masks, thresholds, combine_any,
                         device=None) -> MultiPredicate:
    """The planes of ``pad_specs`` output on ``device``."""
    device = resolve_device(device)
    masks = np.ascontiguousarray(masks, dtype=np.int32)
    thresholds = np.ascontiguousarray(thresholds, dtype=np.int32)
    combine_any = np.ascontiguousarray(combine_any, dtype=bool)
    k = masks.shape[0] if masks.ndim == 3 else 0
    if k < 1 or thresholds.shape != masks.shape[:2] \
            or combine_any.shape != (k,):
        raise ValueError(f"planes {masks.shape}, {thresholds.shape}, "
                         f"{combine_any.shape} are not [K, G, N], [K, G], "
                         f"[K] with K >= 1")
    return MultiPredicate(*(torch.from_numpy(a).to(device)
                            for a in (masks, thresholds, combine_any)))


def check_batch_multi_plain(present: torch.Tensor, config_idx: torch.Tensor,
                            planes: MultiPredicate) -> torch.Tensor:
    """Plain PyTorch version of K6's predicate (the reference's
    ``_check_batch_multi``): ``[B, N]`` int32 rows, each checked under
    plane ``config_idx[b]`` (negative counts from the end, out of range
    clamps, as JAX's gather) by the int32 weighted count; no grid
    branch."""
    k = planes.masks.shape[0]
    idx = torch.where(config_idx < 0, config_idx + k, config_idx)
    idx = idx.clamp(0, k - 1).long()
    counts = (present.to(torch.int32)[:, None, :]
              * planes.masks[idx]).sum(-1, dtype=torch.int32)
    satisfied = counts >= planes.thresholds[idx]
    return torch.where(planes.combine_any[idx], satisfied.any(-1),
                       satisfied.all(-1))


def check_batch_multi(present: torch.Tensor, config_idx: torch.Tensor,
                      planes: MultiPredicate) -> torch.Tensor:
    """K6 (stateless): ``[B, N]`` int32 responder rows (any strides) ->
    ``[B]`` bool, each row under its own configuration plane. CUDA
    tensors launch ``csrc/epoch.cu::check_batch_multi_kernel``; CPU
    tensors take :func:`check_batch_multi_plain`."""
    if present.dtype != torch.int32 or present.dim() != 2 \
            or present.shape[1] != planes.num_nodes:
        raise ValueError(f"present must be [B, {planes.num_nodes}] int32, "
                         f"got {present.dtype} {tuple(present.shape)}")
    b = present.shape[0]
    if config_idx.dtype != torch.int32 or config_idx.shape != (b,):
        raise ValueError(f"config_idx must be [{b}] int32")
    if not use_kernel(present, config_idx, *planes):
        return check_batch_multi_plain(present, config_idx, planes)
    if not config_idx.is_contiguous() \
            or not all(t.is_contiguous() for t in planes):
        raise ValueError("check_batch_multi needs contiguous planes")
    out = torch.empty((b,), dtype=torch.bool, device=present.device)
    if b == 0:
        return out
    lib = _build.library("epoch")
    rc = lib.fpx_check_batch_multi(
        present.data_ptr(), present.stride(0), present.stride(1), b,
        config_idx.data_ptr(), out.data_ptr(), *planes.c_args(),
        *_build.stream_args(present.device))
    _build.check("epoch", "fpx_check_batch_multi", rc)
    check_batch_multi.launches += 1
    return out


check_batch_multi.launches = 0


def record_and_check_epochs_plain(board: VoteBoard, lanes: torch.Tensor,
                                  boundaries: torch.Tensor,
                                  planes: MultiPredicate) -> torch.Tensor:
    """Plain PyTorch version of K6's scatter (the reference's
    ``_record_and_check_epochs``): K4's board update, then each lane's
    column checked under the plane of its true slot's epoch,
    ``searchsorted(boundaries, true_slot, side="right")``."""
    state = _apply_sparse_votes_plain(board, lanes)
    cols, inv, mine, votes = state[:4]
    config_idx = torch.searchsorted(boundaries, lanes[1], right=True,
                                    out_int32=True)
    hit = check_batch_multi_plain(votes[:, inv].t(), config_idx, planes)
    return _finish_sparse_plain(board, *state, hit)


def record_and_check_epochs(board: VoteBoard, lanes: torch.Tensor,
                            boundaries: torch.Tensor,
                            planes: MultiPredicate) -> torch.Tensor:
    """K6: the epoch-segmented sparse scatter, IN PLACE.

    As :func:`record_and_check`, but each lane's quorum predicate is the
    plane of its SLOT's epoch; ``boundaries`` is the ``[K-1]`` int32
    nondecreasing start slots of epochs 1..K-1. CUDA tensors launch
    ``csrc/epoch.cu::record_and_check_epochs_kernel``; CPU tensors take
    :func:`record_and_check_epochs_plain`."""
    n = board.votes.shape[0]
    b = _check_lanes(board, lanes)
    if n != planes.num_nodes:
        raise ValueError(f"board has {n} rows, planes have "
                         f"{planes.num_nodes} nodes")
    if boundaries.dtype != torch.int32 \
            or boundaries.shape != (planes.masks.shape[0] - 1,):
        raise ValueError(f"boundaries must be [{planes.masks.shape[0] - 1}]"
                         f" int32")
    if not use_kernel(lanes, *board, boundaries, *planes):
        return record_and_check_epochs_plain(board, lanes, boundaries,
                                             planes)
    if not all(t.is_contiguous() for t in (boundaries, *planes)):
        raise ValueError("record_and_check_epochs needs contiguous planes")
    if b == 0:
        return torch.empty((0,), dtype=torch.bool, device=lanes.device)
    newly = _launch_sparse("fpx_record_and_check_epochs", "epoch", board,
                           lanes, (boundaries.data_ptr(),
                                   boundaries.shape[0]), planes.c_args())
    record_and_check_epochs.launches += 1
    return newly


record_and_check_epochs.launches = 0


# --- K7: the epoch reshape -------------------------------------------------------


def epoch_column_map(old_universe, new_universe) -> np.ndarray:
    """``[N_new]`` int32 gather map for an epoch reshape: new row ``i``
    draws its votes from old row ``map[i]``, or ``-1`` when node
    ``new_universe[i]`` is new to the board (its row starts empty)."""
    old_col = {node: i for i, node in enumerate(old_universe)}
    return np.asarray([old_col.get(node, -1) for node in new_universe],
                      dtype=np.int32)


def reshape_columns_plain(block: torch.Tensor,
                          cmap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (the reference's ``_reshape_columns``):
    ``[N_old, B] x [N_new] -> [N_new, B]``, a zero row where ``cmap`` is
    negative, an index past the end clamped (``jnp.clip``)."""
    src = cmap.clamp(0, block.shape[0] - 1).long()
    return torch.where((cmap >= 0)[:, None], block[src],
                       torch.zeros((), dtype=block.dtype))


def reshape_columns(block: torch.Tensor, cmap: torch.Tensor) -> torch.Tensor:
    """K7: gather the acceptor rows of a ``[N_old, B]`` uint8 block by the
    ``[N_new]`` int32 map into a NEW ``[N_new, B]`` tensor. CUDA tensors
    launch ``csrc/epoch.cu::reshape_columns_kernel``; CPU tensors take
    :func:`reshape_columns_plain`."""
    if block.dtype != torch.uint8 or block.dim() != 2 \
            or block.shape[0] < 1:
        raise ValueError(f"block must be [N_old >= 1, B] uint8, got "
                         f"{block.dtype} {tuple(block.shape)}")
    if cmap.dtype != torch.int32 or cmap.dim() != 1:
        raise ValueError("cmap must be [N_new] int32")
    if not use_kernel(block, cmap):
        return reshape_columns_plain(block, cmap)
    if not (block.is_contiguous() and cmap.is_contiguous()):
        raise ValueError("reshape_columns needs contiguous tensors")
    n_old, b = block.shape
    n_new = cmap.shape[0]
    out = torch.empty((n_new, b), dtype=torch.uint8, device=block.device)
    if n_new == 0 or b == 0:
        return out
    lib = _build.library("epoch")
    rc = lib.fpx_reshape_columns(block.data_ptr(), n_old, b, cmap.data_ptr(),
                                 n_new, out.data_ptr(),
                                 *_build.stream_args(block.device))
    _build.check("epoch", "fpx_reshape_columns", rc)
    reshape_columns.launches += 1
    return out


reshape_columns.launches = 0


def reshape_block(block: np.ndarray, old_universe, new_universe,
                  device=None) -> np.ndarray:
    """Host wrapper over :func:`reshape_columns` for a standalone
    ``[N_old, B]`` vote block (drain blocks crossing an epoch boundary),
    run on ``device`` (``cuda`` when None)."""
    device = resolve_device(device)
    cmap = epoch_column_map(old_universe, new_universe)
    return reshape_columns(
        stage(np.asarray(block, dtype=np.uint8), device),
        stage(cmap, device)).cpu().numpy()


# --- the sharded board: the slot axis over a mesh -------------------------------
#
# The reference's ``_shard_board`` splits the board's slot columns over
# every axis of a mesh and keeps the acceptor axis whole on each device,
# and XLA's partitioner inserts the collectives. Every per-column step of
# K2, K4, K5, K6 and K7 reads and writes only its own column (plus
# per-lane and per-call scalars), so on a rank that holds columns
# ``[lo, hi)`` each kernel runs unchanged on the local ``[N, W / size]``
# board: the only value that crosses ranks is a per-lane result
# (``newly``), which exactly one rank computes. So the sharded forms below
# are (1) host arithmetic that maps the call onto local columns, (2) the
# kernel on the local board, and (3) one all-reduce SUM of the per-lane
# result over the mesh (a uint8 0/1 view: gloo does not reduce bool
# reliably). Every rank of the mesh makes the same calls in the same
# order, and every rank gets the whole result.


class MeshResult:
    """A per-lane result whose mesh all-reduce may still be in flight:
    :meth:`wait` (or ``.cpu()``, as a fetch of a device mask does) waits
    on the all-reduce and returns the ``[B]`` bool tensor."""

    __slots__ = ("_out", "_work")

    def __init__(self, out: torch.Tensor, work) -> None:
        self._out, self._work = out, work

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out.view(torch.bool)

    def cpu(self) -> torch.Tensor:
        return self.wait().cpu()


def mesh_device(mesh, device=None) -> torch.device:
    """The device of a sharded board: ``mesh.device`` (a ``device`` of
    another kind raises, as does a ``cuda`` mesh with no GPU present)."""
    dev = torch.device(mesh.device)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; make the mesh on "
                           "the CPU (device_type='cpu') for the plain "
                           "PyTorch versions")
    return dev


def shard_board(board: VoteBoard, mesh, window: int) -> VoteBoard:
    """This rank's columns of a whole ``window``-column board (any
    device), as a new contiguous board on the mesh's device: the
    reference's ``_shard_board`` for one rank. Raises unless the mesh
    size divides ``window``."""
    lo, hi = mesh.columns(window)
    if board.votes.shape[1] != window:
        raise ValueError(f"a board of {board.votes.shape[1]} columns is not "
                         f"a {window}-column window")
    dev = mesh_device(mesh)
    return VoteBoard(board.votes[:, lo:hi].contiguous().to(dev),
                     *(t[lo:hi].contiguous().to(dev) for t in board[1:]))


def _combine(mesh, out: torch.Tensor, async_op: bool):
    """The mesh-wide sum of a uint8 per-lane result (each lane set by at
    most one rank): a bool tensor, or a :class:`MeshResult` to wait on."""
    if async_op:
        return MeshResult(out, mesh.psum_mesh_async(out))
    return mesh.psum_mesh(out).view(torch.bool)


def localize_lanes(lanes: np.ndarray, mesh, window: int) -> tuple:
    """``(local, owned)``: this rank's copy of a ``[5, B]`` lane array
    (:func:`pack_lanes`) for a ``window`` split over ``mesh``, and which
    lanes it owns. The owner of a lane follows JAX's index rules for the
    GLOBAL window: a negative slot counts from the end; a slot still
    ``>= window`` reads the clamped column ``window - 1`` and writes
    nothing, so the last rank owns it at local slot ``w_local`` (out of
    range there too); one still negative reads column 0 and writes
    nothing, so rank 0 owns it at local slot ``-w_local - 1``. An owned
    lane's slot is rebased to local columns; its true slot (the owner id
    and K6's epoch key) is kept. A lane another rank owns becomes an
    out-of-range invalid lane (local slot ``w_local``, valid 0), which
    writes nothing and reports nothing -- not a pad lane at slot 0, whose
    owner max would touch column 0."""
    lo, hi = mesh.columns(window)
    w_local = hi - lo
    s = lanes[0].astype(np.int64)
    s = np.where(s < 0, s + window, s)
    owner = np.where(s < 0, 0, np.where(s >= window, mesh.size - 1,
                                        s // w_local))
    local_slot = np.where(s < 0, -w_local - 1,
                          np.where(s >= window, w_local, s - lo))
    owned = owner == mesh.rank
    local = lanes.copy()
    local[0] = np.where(owned, local_slot, w_local)
    local[4] = np.where(owned, lanes[4], 0)
    return local, owned


def _host_lanes(lanes) -> np.ndarray:
    lanes = np.asarray(lanes)
    if lanes.dtype != np.int32 or lanes.ndim != 2 \
            or lanes.shape[0] != LANE_FIELDS:
        raise ValueError(f"lanes must be a [{LANE_FIELDS}, B] int32 host "
                         f"array, got {lanes.dtype} {lanes.shape}")
    return lanes


def record_block_sharded(board: VoteBoard, mesh, start: int, true_start: int,
                         block, vote_round: int, pred: QuorumPredicate, *,
                         async_op: bool = False):
    """K2 on a sharded board: records the host ``block [N, B]`` (uint8)
    for GLOBAL columns ``[start, start + B)`` (within the window
    ``w_local * mesh.size``) holding slots from ``true_start``. This rank
    runs K2 on its part of the block, the local columns with
    ``true_start`` shifted (as int32 wraps); a rank whose part is empty
    launches nothing. Returns the ``[B]`` newly-chosen mask on every rank
    (a :class:`MeshResult` when ``async_op``)."""
    n, w_local = board.votes.shape
    window = w_local * mesh.size
    block = np.asarray(block)
    if block.dtype != np.uint8 or block.ndim != 2 or block.shape[0] != n:
        raise ValueError(f"block must be [{n}, B] uint8, got {block.dtype} "
                         f"{block.shape}")
    b = block.shape[1]
    start, true_start, vote_round = (int32(start), int32(true_start),
                                     int32(vote_round))
    if not 0 <= start <= window - b:
        raise ValueError(f"block [{start}, {start + b}) outside the "
                         f"window {window}")
    dev = board.votes.device
    out = torch.zeros((b,), dtype=torch.uint8, device=dev)
    part = block_part(mesh, window, start, b)
    if part is not None:
        first, last, local = part
        out[first:last] = record_block(
            board, local, _wrap32(true_start + first), stage(
                block[:, first:last], dev), vote_round, pred)
    return _combine(mesh, out, async_op)


def block_part(mesh, window: int, start: int, b: int):
    """This rank's part of the dense block of GLOBAL columns ``[start,
    start + b)``: ``(first, last, local)`` -- the block's columns
    ``[first, last)`` lie on this rank from local column ``local`` -- or
    None when none does."""
    lo, hi = mesh.columns(window)
    first, last = max(start, lo), min(start + b, hi)
    if first >= last:
        return None
    return first - start, last - start, first - lo


def _sparse_sharded(board: VoteBoard, mesh, lanes, launch,
                    async_op: bool):
    lanes = _host_lanes(lanes)
    window = board.votes.shape[1] * mesh.size
    local, owned = localize_lanes(lanes, mesh, window)
    dev = board.votes.device
    b = lanes.shape[1]
    if not b:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    if owned.any():
        out = launch(stage(local, dev)).to(torch.uint8)
    else:
        out = torch.zeros((b,), dtype=torch.uint8, device=dev)
    return _combine(mesh, out, async_op)


def record_and_check_sharded(board: VoteBoard, mesh, lanes,
                             pred: QuorumPredicate, *,
                             async_op: bool = False):
    """K4 on a sharded board: the host ``[5, B]`` int32 ``lanes``
    (:func:`pack_lanes`, slots as the GLOBAL window sees them) localized
    by :func:`localize_lanes`, K4 on the local board (not launched when
    this rank owns no lane), and the per-lane result summed over the
    mesh: the ``[B]`` newly mask on every rank."""
    return _sparse_sharded(
        board, mesh, lanes, lambda t: record_and_check(board, t, pred),
        async_op)


def record_and_check_epochs_sharded(board: VoteBoard, mesh, lanes,
                                    boundaries: torch.Tensor,
                                    planes: MultiPredicate, *,
                                    async_op: bool = False):
    """K6 on a sharded board, as :func:`record_and_check_sharded`; the
    epoch planes and boundaries are whole on every rank, and each lane's
    plane comes from its (unrebased) true slot."""
    return _sparse_sharded(
        board, mesh, lanes,
        lambda t: record_and_check_epochs(board, t, boundaries, planes),
        async_op)


def release_sharded(board: VoteBoard, mesh, slots, valid) -> None:
    """K5 on a sharded board: of the host ``[B]`` slots (JAX's rules for
    the GLOBAL window: negative from the end, out of range dropped) this
    rank resets the columns it holds; a rank that holds none launches
    nothing. No collective: K5 returns nothing per lane."""
    window = board.votes.shape[1] * mesh.size
    lo, hi = mesh.columns(window)
    s = np.asarray(slots).astype(np.int64)
    valid = np.asarray(valid, dtype=bool)
    if s.ndim != 1 or valid.shape != s.shape:
        raise ValueError("release takes [B] slots and [B] valid")
    s = np.where(s < 0, s + window, s)
    mine = (s >= lo) & (s < hi)
    if mine.any():
        dev = board.votes.device
        release(board, stage((s[mine] - lo).astype(np.int32), dev),
                stage(valid[mine], dev))


def _wrap32(x: int) -> int:
    return (int(x) + 2**31) % 2**32 - 2**31


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
    device (the reference's ``TpuQuorumChecker``).

    Typical use (ProxyLeader Phase2b path)::

        checker = TpuQuorumChecker(qs.write_spec(), window=1 << 20)
        hits = checker.check_block(arrivals)          # drain-local
        newly = checker.record_block(start_slot, arrivals, vote_round=3)
        newly = checker.record_and_check(slots, acceptor_cols, rounds)

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the plain versions. The board lives on the
    device and is updated in place.

    ``mesh`` (a ``mesh.Mesh`` of ``torch.distributed`` ranks): the board's
    SLOT axis is split over every rank of the mesh in rank order (the
    reference's ``_shard_board``), each rank holding ``window /
    mesh.size`` columns on ``mesh.device``. Every rank builds the same
    checker and makes the same calls in the same order, with the same
    host inputs; the board calls run on local columns and sum their
    per-lane result over the mesh, so every rank returns the unsharded
    checker's answer. The stateless ``check_block`` / ``check_batch``
    run whole on every rank, with no collective.
    """

    def __init__(self, spec: QuorumSpec, window: int, mesh=None,
                 device=None):
        if window <= 0:
            raise ValueError("window must be positive")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh_device(mesh, device)
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
        self.board = make_vote_board(window, spec.num_nodes, self.device,
                                     mesh)

    def _to_device(self, block: np.ndarray) -> torch.Tensor:
        return stage(np.asarray(block, dtype=np.uint8), self.device)

    def record_block_async(self, start_slot: int, block: np.ndarray,
                           vote_round: int = 0):
        """Like :meth:`record_block` but returns the DEVICE newly-chosen
        mask without waiting. It keeps the PADDED bucket length (entries
        past the input width are padding). On a mesh it is a
        :class:`MeshResult`, whose ``.cpu()`` waits for the all-reduce."""
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
        if self.mesh is not None:
            return record_block_sharded(
                self.board, self.mesh, start, int32(start_slot),
                np.asarray(block, dtype=np.uint8), int32(vote_round),
                self._pred, async_op=True)
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

    def record_and_check_async(self, slots, node_cols, rounds=None,
                               pad_to: Optional[int] = None):
        """Like :meth:`record_and_check` but returns the DEVICE per-vote
        mask without waiting; it keeps the PADDED batch length (on a
        mesh, a :class:`MeshResult`)."""
        slots = np.asarray(slots, dtype=np.int32)
        b = slots.shape[0]
        if b:
            self._note_slot_span(int(slots.min()), int(slots.max()))
        lanes = _checker_lanes(slots, node_cols, rounds, self.window,
                               _bucket(b) if pad_to is None else pad_to)
        if self.mesh is not None:
            return record_and_check_sharded(self.board, self.mesh, lanes,
                                            self._pred, async_op=True)
        return record_and_check(self.board, stage(lanes, self.device),
                                self._pred)

    def record_and_check(self, slots, node_cols, rounds=None,
                         pad_to: Optional[int] = None) -> np.ndarray:
        """Sparse path: record out-of-order votes (slot, acceptor column,
        round); return per-vote "slot newly has quorum". Duplicate slots
        in one batch each report quorum; callers dedup."""
        b = np.asarray(slots).shape[0]
        return self.record_and_check_async(
            slots, node_cols, rounds, pad_to).cpu().numpy()[:b]

    def reshape(self, new_spec: QuorumSpec) -> None:
        """Epoch reshape: remap the board's ACCEPTOR axis onto
        ``new_spec``'s universe by one gather (K7) and swap the
        predicate. Slot-axis state (rounds, chosen, owner) is kept."""
        self.board = _reshape_board(self.board, self.spec.universe,
                                    new_spec.universe)
        self.spec = new_spec
        self.num_nodes = new_spec.num_nodes
        self._masks_t, self._meta = spec_statics(new_spec)
        self._pred = make_predicate(self._masks_t, *self._meta[:2],
                                    device=self.device)

    def release(self, slots) -> None:
        """GC slot columns below the chosen watermark so the ring can
        wrap (K5)."""
        _release_slots(self.board, slots, self.mesh)

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


def _release_slots(board: VoteBoard, slots, mesh=None) -> None:
    """K5 on the columns of ``slots`` (taken % window), all valid; on a
    mesh, on the columns this rank holds."""
    if mesh is not None:
        window = board.votes.shape[1] * mesh.size
        slots = np.asarray(slots, dtype=np.int32) % window
        release_sharded(board, mesh, slots, np.ones(slots.shape[0], bool))
        return
    window = board.votes.shape[1]
    slots = np.asarray(slots, dtype=np.int32) % window
    device = board.votes.device
    release(board, stage(slots, device),
            stage(np.ones(slots.shape[0], dtype=bool), device))


def _reshape_board(board: VoteBoard, old_universe,
                   new_universe) -> VoteBoard:
    """The board with its acceptor rows gathered onto ``new_universe``
    by K7; the slot-axis state is kept. A sharded board's reshape is the
    same call on its local columns (the acceptor axis is whole on every
    rank), with no collective."""
    cmap = epoch_column_map(old_universe, new_universe)
    return board._replace(votes=reshape_columns(
        board.votes, stage(cmap, board.votes.device)))


class EpochSegmentedChecker:
    """Quorum checking where each SLOT selects its epoch's predicate (the
    reference's ``EpochSegmentedChecker``).

    Epochs partition slot space at activation watermarks (epoch ``k``
    governs ``[start_k, start_{k+1})``), each with its own acceptor set
    and ``QuorumSpec``. The specs are padded into one ``[K, G, N]`` plane
    stack over the UNION universe (first-seen order, so a new epoch only
    appends rows), and every kernel selects a slot's plane by
    ``searchsorted`` over the int32 boundaries: one call spans a
    handover. ``add_epoch`` grows the stack and reshapes the live board
    by K7, so mid-flight votes of surviving acceptors keep counting.
    ``device`` defaults to ``cuda``.

    ``mesh``: the board's slot axis split over the mesh's ranks as in
    :class:`TpuQuorumChecker`; the planes and boundaries are whole on
    every rank (each builds them from the same specs), and ``add_epoch``
    reshapes the local columns (K7, no collective).
    """

    def __init__(self, specs: Sequence[QuorumSpec], boundaries: Sequence[int],
                 window: int = 4096, mesh=None, device=None):
        if len(specs) != len(boundaries):
            raise ValueError(
                f"{len(specs)} specs vs {len(boundaries)} boundaries")
        if list(boundaries) != sorted(boundaries):
            raise ValueError(
                f"epoch boundaries must be nondecreasing: {boundaries}")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh_device(mesh, device)
        self.window = window
        self._own_specs = list(specs)
        self._starts = [int(b) for b in boundaries]
        self.universe: tuple = ()
        self._rebuild_universe()
        self.board = make_vote_board(window, len(self.universe), self.device,
                                     mesh)

    def _rebuild_universe(self) -> None:
        seen: dict = {}
        for spec in self._own_specs:
            for node in spec.universe:
                seen.setdefault(node, len(seen))
        self.universe = tuple(seen)
        specs = [s.reindexed(self.universe) for s in self._own_specs]
        self.planes = make_multi_predicate(*pad_specs(specs),
                                           device=self.device)
        # boundaries[k-1] = first slot of epoch k, int32 like the board's
        # slot state (as the reference keeps it on the device).
        self._boundaries = stage(np.asarray(self._starts[1:],
                                            dtype=np.int32), self.device)
        self._boundaries_np = np.asarray(self._starts[1:], dtype=np.int64)

    def column_of(self, node_id) -> int:
        return self.universe.index(node_id)

    def add_epoch(self, spec: QuorumSpec, start_slot: int) -> None:
        """Append an epoch: slots >= ``start_slot`` check under ``spec``.
        Reshapes the live board onto the widened union universe (K7)."""
        if start_slot < self._starts[-1]:
            raise ValueError(
                f"epoch start {start_slot} below the newest epoch's "
                f"{self._starts[-1]}")
        self._own_specs.append(spec)
        self._starts.append(int(start_slot))
        old_universe = self.universe
        self._rebuild_universe()
        if self.universe != old_universe:
            self.board = _reshape_board(self.board, old_universe,
                                        self.universe)

    def config_indices(self, slots) -> np.ndarray:
        """Which epoch plane governs each slot."""
        return np.searchsorted(self._boundaries_np,
                               np.asarray(slots, dtype=np.int64),
                               side="right")

    def check_batch(self, present, slots) -> np.ndarray:
        """Stateless: ``[B, N]`` union-universe responder rows (taken as
        uint8) checked under each row's slot's epoch (K6)."""
        present = np.asarray(present, dtype=np.uint8).astype(np.int32)
        config_idx = self.config_indices(slots).astype(np.int32)
        return check_batch_multi(stage(present, self.device),
                                 stage(config_idx, self.device),
                                 self.planes).cpu().numpy()

    def check_block(self, start_slot: int, block) -> np.ndarray:
        """Stateless dense form: ``block[N, B]`` covers slots
        ``[start_slot, start_slot + B)``, across any epoch boundaries."""
        b = block.shape[1]
        slots = start_slot + np.arange(b, dtype=np.int64)
        return self.check_batch(np.asarray(block, dtype=np.uint8).T, slots)

    def record_and_check(self, slots, node_cols, rounds=None) -> np.ndarray:
        """Stateful sparse path (K6): record votes on the union-universe
        board and return the per-vote "slot newly has quorum" mask, each
        slot judged under its epoch's spec."""
        slots = np.asarray(slots, dtype=np.int64)
        b = slots.shape[0]
        lanes = _checker_lanes(slots, node_cols, rounds, self.window,
                               _bucket(b))
        if self.mesh is not None:
            return record_and_check_epochs_sharded(
                self.board, self.mesh, lanes, self._boundaries,
                self.planes).cpu().numpy()[:b]
        return record_and_check_epochs(
            self.board, stage(lanes, self.device), self._boundaries,
            self.planes).cpu().numpy()[:b]

    def release(self, slots) -> None:
        """GC chosen columns below the watermark (ring wrap; K5)."""
        _release_slots(self.board, slots, self.mesh)


class MultiConfigQuorumChecker:
    """Stateless batched checks where each row picks its own quorum
    system (the reference's ``MultiConfigQuorumChecker``), built from
    ``pad_specs``; ``device`` defaults to ``cuda``."""

    def __init__(self, specs: Sequence[QuorumSpec], device=None):
        self.device = resolve_device(device)
        self.universe = specs[0].universe
        self.planes = make_multi_predicate(*pad_specs(specs),
                                           device=self.device)

    def check_batch(self, present, config_idx) -> np.ndarray:
        """``[B, N]`` rows (integers or bools, taken as int32 as the
        reference's ``astype`` takes them) under ``config_idx[b]``."""
        present = np.asarray(present).astype(np.int32)
        config_idx = np.asarray(config_idx).astype(np.int32)
        return check_batch_multi(stage(present, self.device),
                                 stage(config_idx, self.device),
                                 self.planes).cpu().numpy()
