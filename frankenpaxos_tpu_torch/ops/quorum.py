"""The vote board, ``TpuQuorumChecker`` and the epoch / multi-config
checkers on one GPU.

Counterpart of ``frankenpaxos_tpu/ops/quorum.py``. The board keeps the
reference's ``votes[acceptors, window]`` layout (slot-major, so the
threads of a warp read neighbouring bytes of one acceptor row) and its
ring semantics: column ``slot % window`` holds slot ``slot`` and carries
its OWNER slot, so wrapping is self-reclaiming.

Seven kernels live here, each beside its plain PyTorch version:

  * K1 :func:`quorum_hit` -- the quorum predicate over a vote block
    (the reference's ``_check_block`` / ``_check_batch``), and
    :func:`quorum_hit_staged`, the synchronous tracker's whole drain in
    one call;
  * K2 :func:`record_block` -- the dense board update for one
    contiguous slot block (``_record_block``); :func:`record_block_run`
    takes a run of blocks in one launch, and
    :meth:`TpuQuorumChecker.dense_run` a run of dense blocks in one
    staged call that does not wait;
  * K4 :func:`record_and_check` -- the sparse scatter of straggler
    votes (``_apply_sparse_votes`` + ``_record_and_check``);
    :func:`record_and_check_run` takes a run of chunks in one launch,
    and :meth:`TpuQuorumChecker.board_run` is the pipelined tracker's
    whole drain (its dense blocks and its sparse chunks, in order) in
    one staged call that does not wait;
  * K5 :func:`release` -- the column reset of GC'd slots (``_release``),
    and :func:`release_all`, its all-valid form, which the checkers run
    on the releases they hold until their next board call
    (:class:`_HeldReleases`);
  * K6 :func:`record_and_check_epochs` and :func:`check_batch_multi` --
    the epoch-segmented scatter and the per-row multi-config predicate
    (``_record_and_check_epochs``, ``_check_batch_multi``); the scatter
    takes a run of chunks in one launch
    (:func:`record_and_check_epochs_run`, the trackers' loop over
    256-vote chunks), and :meth:`EpochSegmentedChecker.record_and_check_run`
    is a tracker drain in one call;
  * K7 :func:`reshape_columns` -- the epoch reshape gather of the
    acceptor axis (``_reshape_columns``).

(K3, the fused drain, is in ``bench/pipeline.py``.) A wrapper launches
its CUDA kernel (``csrc/quorum.cu`` with ``sparse.cuh``, ``sparse.cu``,
``epoch.cu``) for
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

import functools
import itertools
from typing import NamedTuple, Optional, Sequence
import weakref

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

    @property
    def perm_identity(self) -> int:
        """1 where ``perm`` is the identity (every predicate but a grid
        over a universe out of row-major order), so that a kernel reads
        its rows without looking ``perm`` up."""
        return int(self.grid is None or self.grid[3] is None)

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


_K1 = _build.Entry("quorum", "fpx_quorum_hit", 16)
_K1_STAGED = _build.Entry("quorum", "fpx_quorum_hit_staged", 16,
                          keep_gil=False)


def quorum_hit(votes: torch.Tensor, pred: QuorumPredicate) -> torch.Tensor:
    """K1: ``[N, B]`` uint8 vote block -> ``[B]`` bool quorum hits.

    ``votes`` may have any strides (``check_batch`` passes a transposed
    ``[B, N]`` view, which the kernel reads in place). CUDA tensors
    launch ``csrc/quorum.cu::quorum_hit_kernel`` through the lean call
    path (one packed ``ctypes`` call); CPU tensors take
    :func:`quorum_hit_plain`."""
    if votes.dtype is not torch.uint8 or votes.dim() != 2:
        raise ValueError(f"votes must be a 2-D uint8 tensor, got "
                         f"{votes.dtype} {tuple(votes.shape)}")
    n, b = votes.shape
    if n != pred.num_nodes:
        raise ValueError(f"votes have {n} rows, predicate has "
                         f"{pred.num_nodes} nodes")
    index = votes.get_device()
    if (index < 0 or pred.masks.get_device() != index) \
            and not use_kernel(votes, pred.masks):
        return quorum_hit_plain(votes, pred)
    out = torch.empty((b,), dtype=torch.bool, device=votes.device)
    if b == 0:
        return out
    fn = _K1.fn or _K1.resolve()
    rc = fn(_K1.pack(votes.data_ptr(), votes.stride(0), votes.stride(1), b,
                     out.data_ptr(), *pred.c_args(), index,
                     _build.stream_handle(index)))
    if rc:
        _K1.check(rc)
    quorum_hit.launches += 1
    return out


def quorum_hit_staged(staging: _build.Staging, width: int,
                      pred: QuorumPredicate) -> np.ndarray:
    """K1 over the ``[N, width]`` block already written into
    ``staging``'s pinned ``"votes"`` buffer (row-major), in
    ONE ``ctypes`` call with the GIL released: the block up, the launch,
    the hits down into pinned memory, a wait, all on PyTorch's current
    stream (which runs work the caller queued first, before the launch
    reads the predicate).
    Returns the ``[width]`` bool hits, a view of the staging's pinned
    ``"hits"`` buffer that the next call overwrites."""
    n = pred.num_nodes
    votes = staging.pair("votes", n * width, torch.uint8)
    hits = staging.pair("hits", width, torch.bool)
    if width:
        fn = _K1_STAGED.fn or _K1_STAGED.resolve()
        rc = fn(_K1_STAGED.pack(votes.host_ptr, votes.device_ptr, width,
                                hits.device_ptr, hits.host_ptr,
                                *pred.c_args(), staging.index,
                                _build.stream_handle(staging.index)))
        if rc:
            _K1_STAGED.check(rc)
        quorum_hit.launches += 1
    return hits.host[:width]


quorum_hit.launches = 0


# --- K2: the dense board update --------------------------------------------

#: Fields of a row of a run's table: board column, true start (int32),
#: width, staged column, round, and 1 where the block starts a launch.
RUN_FIELDS = 6
#: Blocks of one K2 launch at most (the table travels in the kernel's
#: parameters); a longer run takes several launches, in order.
MAX_RUN_BLOCKS = 64


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def run_table(starts, widths, rounds, window: int,
              true_starts=None) -> tuple:
    """``(table, stride)`` for a run of dense blocks: block ``k`` records
    ``widths[k]`` columns from slot ``starts[k]`` (which must not straddle
    the ring end) in round ``rounds[k]``; ``true_starts[k]``, when given,
    is the slot number of its first column in place of ``starts[k]``
    (``record_block``'s ``true_start``). ``table`` is the ``[nb, 6]``
    int32 array of :data:`RUN_FIELDS`, the blocks side by side in a
    ``[N, stride]`` staged block. A block
    starts a new launch where it shares a board column with a block of
    the current launch (the reference applies blocks in order; only a
    window violation brings two blocks of a drain onto one column), or
    past :data:`MAX_RUN_BLOCKS`."""
    nb = len(starts)
    table = np.empty((nb, RUN_FIELDS), dtype=np.int32)
    end = 0
    launch: list = []
    if true_starts is None:
        true_starts = starts
    for k, (start, true_start, width, rnd) in enumerate(
            zip(starts, true_starts, widths, rounds)):
        start, width = int(start), int(width)
        col = start % window
        if width < 0 or col + width > window:
            raise ValueError(f"block [{col}, {col + width}) outside the "
                             f"window {window}")
        at, end = end, end + width
        overlap = any(col < c + w and c < col + width for c, w in launch)
        fresh = not launch or overlap or len(launch) == MAX_RUN_BLOCKS
        if fresh:
            launch = []
        launch.append((col, width))
        table[k] = (col, int32(true_start), width, at, int32(rnd),
                    int(fresh))
    return table, end


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


def record_block_run_plain(board: VoteBoard, table: np.ndarray,
                           blocks: torch.Tensor,
                           pred: QuorumPredicate) -> torch.Tensor:
    """Plain PyTorch version of K2's run: :func:`record_block_plain` on
    each block of ``table`` (:func:`run_table`) in order, block ``k``
    from the staged ``blocks [N, stride]`` columns ``[at, at + width)``.
    Returns the ``[stride]`` newly mask at the staged columns (False
    elsewhere)."""
    newly = torch.zeros((blocks.shape[1],), dtype=torch.bool,
                        device=blocks.device)
    for col, true_start, width, at, rnd, _ in np.asarray(table).tolist():
        newly[at:at + width] = record_block_plain(
            board, col, true_start, blocks[:, at:at + width], rnd, pred)
    return newly


def _check_board(board: VoteBoard, pred: QuorumPredicate) -> tuple:
    n, window = board.votes.shape
    if n != pred.num_nodes:
        raise ValueError(f"board has {n} rows, predicate has "
                         f"{pred.num_nodes} nodes")
    if tuple(t.dtype for t in board) != _BOARD_DTYPES \
            or board.rounds.shape != (window,) \
            or any(t.shape != board.rounds.shape for t in board[2:]):
        raise ValueError("board tensors do not match make_vote_board's")
    return n, window


def _board_ptrs(board: VoteBoard) -> tuple:
    n, window = board.votes.shape
    return (board.votes.data_ptr(), board.rounds.data_ptr(),
            board.chosen.data_ptr(), board.owner.data_ptr(), window, n)


_K2 = _build.Entry("quorum", "fpx_record_block_run", 23)
_K2_STAGED = _build.Entry("quorum", "fpx_record_block_run_staged", 29)
#: A drain's run of dense and sparse segments in one call (K2, K4).
_BOARD_STAGED = _build.Entry("quorum", "fpx_board_run_staged", 36)


def record_block_run(board: VoteBoard, table: np.ndarray,
                     blocks: torch.Tensor,
                     pred: QuorumPredicate) -> torch.Tensor:
    """K2 on a run of blocks, IN PLACE: the host ``table`` of
    :func:`run_table` and the ``[N, stride]`` uint8 staged ``blocks``;
    returns the ``[stride]`` newly mask at the staged columns. CUDA
    tensors launch ``csrc/quorum.cu::record_block_run_kernel`` through
    the lean call path (one packed ``ctypes`` call; one launch, more only
    where the table starts one); CPU tensors take
    :func:`record_block_run_plain`."""
    n, window = _check_board(board, pred)
    table = np.ascontiguousarray(table, dtype=np.int32)
    if table.ndim != 2 or table.shape[1] != RUN_FIELDS:
        raise ValueError(f"table must be [nb, {RUN_FIELDS}] int32")
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 \
            or blocks.shape[0] != n:
        raise ValueError(f"blocks must be [{n}, stride] uint8, got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    stride = blocks.shape[1]
    if table.size and ((table[:, 0] < 0).any() or (table[:, 2] < 0).any()
                       or (table[:, 3] < 0).any()
                       or (table[:, 0] + table[:, 2] > window).any()
                       or (table[:, 3] + table[:, 2] > stride).any()):
        raise ValueError("a block of the table lies outside the window or "
                         "the staged block")
    index = blocks.get_device()
    if (index < 0 or board.votes.get_device() != index
            or pred.masks.get_device() != index) \
            and not use_kernel(blocks, *board, pred.masks):
        return record_block_run_plain(board, table, blocks, pred)
    if not (blocks.is_contiguous()
            and all(t.is_contiguous() for t in board)):
        raise ValueError("record_block_run needs contiguous tensors")
    newly = torch.zeros((stride,), dtype=torch.bool, device=blocks.device)
    if not len(table):
        return newly
    fn = _K2.fn or _K2.resolve()
    rc = fn(_K2.pack(*_board_ptrs(board), table.ctypes.data, len(table),
                     blocks.data_ptr(), stride, newly.data_ptr(),
                     pred.perm_identity, *pred.c_args(), index,
                     _build.stream_handle(index)))
    if rc:
        _K2.check(rc)
    record_block.launches += _launch_count(table)
    return newly


def _launch_count(table: np.ndarray) -> int:
    """The launches of a run's table, as the C entry splits it: one at
    the first block, at each flagged block, and past MAX_RUN_BLOCKS."""
    count, k, nb = 0, 0, len(table)
    while k < nb:
        count += 1
        last = k + 1
        while last < nb and last - k < MAX_RUN_BLOCKS \
                and not table[last, 5]:
            last += 1
        k = last
    return count


def record_block(board: VoteBoard, start: int, true_start: int,
                 block: torch.Tensor, vote_round: int,
                 pred: QuorumPredicate) -> torch.Tensor:
    """K2: the dense board update for one contiguous block, IN PLACE.

    ``block`` is ``[N, B]`` uint8 with ``start + B <= window``;
    ``true_start`` is the slot number of column ``start``. Returns the
    ``[B]`` newly-chosen mask. CUDA tensors launch
    ``csrc/quorum.cu::record_block_run_kernel`` on a run of one block
    (one packed ``ctypes`` call); CPU tensors take
    :func:`record_block_plain`."""
    n, window = _check_board(board, pred)
    if block.dtype != torch.uint8 or block.dim() != 2 \
            or block.shape[0] != n:
        raise ValueError(f"block must be [{n}, B] uint8, got {block.dtype} "
                         f"{tuple(block.shape)}")
    b = block.shape[1]
    start, true_start, vote_round = (int32(start), int32(true_start),
                                     int32(vote_round))
    if not 0 <= start <= window - b:
        raise ValueError(f"block [{start}, {start + b}) outside the "
                         f"window {window}")
    index = block.get_device()
    if (index < 0 or board.votes.get_device() != index
            or pred.masks.get_device() != index) \
            and not use_kernel(block, *board, pred.masks):
        return record_block_plain(board, start, true_start, block,
                                  vote_round, pred)
    if not (block.is_contiguous()
            and all(t.is_contiguous() for t in board)):
        raise ValueError("record_block needs contiguous tensors")
    newly = torch.empty((b,), dtype=torch.bool, device=block.device)
    if b == 0:
        return newly
    table = np.array([[start, true_start, b, 0, vote_round, 1]],
                     dtype=np.int32)
    fn = _K2.fn or _K2.resolve()
    rc = fn(_K2.pack(*_board_ptrs(board), table.ctypes.data, 1,
                     block.data_ptr(), b, newly.data_ptr(),
                     pred.perm_identity, *pred.c_args(), index,
                     _build.stream_handle(index)))
    if rc:
        _K2.check(rc)
    record_block.launches += 1
    return newly


record_block.launches = 0


class RunRing:
    """The pinned slots of a checker's staged K2 runs, one a dispatch in
    flight. A slot holds a pinned in-block (held released slots, then
    the staged ``[N, stride]`` block), its device copy, a device and a
    pinned ``newly``, and an event the run records after its copy down.
    :meth:`take` hands out the next slot in ring order when it is free,
    and otherwise inserts a new one there, so the ring grows while a
    collector lags and keeps its oldest dispatch next in turn. A slot is
    free again once its result was waited on (its event complete) and
    read (:meth:`RunResult.free`); so a pinned buffer is never written
    while a copy of it may be in flight.

    ``alloc(nbytes)`` returns ``(host uint8 array, host pointer, device
    pointer, keep-alive)`` and ``events`` has ``create()``,
    ``wait(handle)`` and ``destroy(handle)``: on a card, pinned and
    device tensors and ``csrc/quorum.cu``'s event entries
    (``TpuQuorumChecker._run_ring``); the tests stand in for them."""

    #: Slots made at the first dispatch.
    INITIAL = 2

    def __init__(self, alloc, events):
        self.alloc, self.events = alloc, events
        self.slots: list = []
        self.next = 0
        # The slots' events go with the ring.
        weakref.finalize(self, RunRing._destroy, events, self.slots)

    @staticmethod
    def _destroy(events, slots: list) -> None:
        for slot in slots:
            events.destroy(slot.event)

    def _new(self) -> "_RunSlot":
        return _RunSlot(self.events.create())

    def take(self, in_bytes: int, out_bytes: int) -> "_RunSlot":
        if not self.slots:
            self.slots.extend(self._new() for _ in range(self.INITIAL))
        slot = self.slots[self.next]
        if slot.busy:
            slot = self._new()
            self.slots.insert(self.next, slot)
        self.next = (self.next + 1) % len(self.slots)
        if slot.in_cap < in_bytes:
            slot.in_cap = 1 << max(12, (in_bytes - 1).bit_length())
            slot.host_in, slot.host_in_ptr, slot.dev_in_ptr, slot.keep_in = \
                self.alloc(slot.in_cap)
        if slot.out_cap < out_bytes:
            slot.out_cap = 1 << max(12, (out_bytes - 1).bit_length())
            (slot.host_out, slot.host_out_ptr, slot.dev_out_ptr,
             slot.keep_out) = self.alloc(slot.out_cap)
        slot.busy = True
        return slot


class _RunSlot:
    __slots__ = ("event", "busy", "in_cap", "host_in", "host_in_ptr",
                 "dev_in_ptr", "keep_in", "out_cap", "host_out",
                 "host_out_ptr", "dev_out_ptr", "keep_out")

    def __init__(self, event: int):
        self.event, self.busy = event, False
        self.in_cap = self.out_cap = 0
        self.host_in = self.host_out = self.keep_in = self.keep_out = None
        self.host_in_ptr = self.dev_in_ptr = 0
        self.host_out_ptr = self.dev_out_ptr = 0


class _CardEvents:
    """``RunRing``'s events on card ``index`` (``csrc/quorum.cu``)."""

    def __init__(self, index: int):
        self.index = index
        self._out = np.zeros(1, dtype=np.int64)

    def create(self) -> int:
        fn = _EVENT_CREATE.fn or _EVENT_CREATE.resolve()
        rc = fn(_EVENT_CREATE.pack(self.index, self._out.ctypes.data))
        if rc:
            _EVENT_CREATE.check(rc)
        return int(self._out[0])

    @staticmethod
    def wait(handle: int) -> None:
        fn = _EVENT_WAIT.fn or _EVENT_WAIT.resolve()
        rc = fn(_EVENT_WAIT.pack(handle))
        if rc:
            _EVENT_WAIT.check(rc)

    @staticmethod
    def destroy(handle: int) -> None:
        fn = _EVENT_DESTROY.fn or _EVENT_DESTROY.resolve()
        fn(_EVENT_DESTROY.pack(handle))


_EVENT_CREATE = _build.Entry("quorum", "fpx_event_create", 2)
_EVENT_WAIT = _build.Entry("quorum", "fpx_event_wait", 1, keep_gil=False)
_EVENT_DESTROY = _build.Entry("quorum", "fpx_event_destroy", 1)


def _card_alloc(device: torch.device):
    """``RunRing``'s buffers on ``device``: a pinned host tensor and a
    device tensor of ``nbytes`` each."""
    def alloc(nbytes: int):
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        return host.numpy(), host.data_ptr(), dev.data_ptr(), (host, dev)

    return alloc


class RunResult:
    """A dispatched run's results: :meth:`wait` blocks until they are on
    the host (on the card: a wait on the run's event with the GIL
    released) and returns the dense blocks' ``newly`` (``[stride]`` bool
    at the staged columns), :meth:`lanes` the sparse chunks' (``[B]``
    bool at lane index), each a view of the run's pinned slot on the
    card; :meth:`free` gives the slot back once the caller has read
    them."""

    __slots__ = ("_newly", "_lanes", "_slot", "_events", "_parts",
                 "_lane_parts", "_stride", "_lane_at", "_nlanes", "_waited")

    def __init__(self, newly=None, slot=None, events=None, parts=None,
                 stride: int = 0, lane_parts=None, lane_at: int = 0,
                 nlanes: int = 0):
        self._newly, self._slot, self._events = newly, slot, events
        self._parts, self._stride = parts, stride
        self._lane_parts, self._lane_at, self._nlanes = (lane_parts,
                                                         lane_at, nlanes)
        self._lanes = None
        self._waited = False

    def wait(self) -> np.ndarray:
        if self._slot is not None:
            if not self._waited:
                self._events.wait(self._slot.event)
                self._waited = True
            return self._slot.host_out[:self._stride].view(bool)
        if self._parts is not None:
            newly = np.zeros(self._stride, dtype=bool)
            for at, width, part in self._parts:
                newly[at:at + width] = part.cpu().numpy()[:width]
            self._newly, self._parts = newly, None
        if self._newly is None:
            self._newly = np.zeros(self._stride, dtype=bool)
        return self._newly

    def lanes(self) -> np.ndarray:
        """The sparse chunks' per-lane ``newly`` (``[B]`` bool)."""
        if self._slot is not None:
            self.wait()
            at = self._lane_at
            return self._slot.host_out[at:at + self._nlanes].view(bool)
        if self._lanes is None:
            lanes = np.zeros(self._nlanes, dtype=bool)
            for at, width, part in self._lane_parts or ():
                lanes[at:at + width] = part.cpu().numpy()[:width]
            self._lanes, self._lane_parts = lanes, None
        return self._lanes

    def free(self) -> None:
        """Give the pinned slot back (after :meth:`wait`; the views it
        and :meth:`lanes` returned must not be read after this)."""
        slot, self._slot = self._slot, None
        if slot is not None:
            if not self._waited:
                self._events.wait(slot.event)
            slot.busy = False


class BoardRun:
    """A drain's board updates being staged for ONE dispatch (see
    :meth:`TpuQuorumChecker.board_run`): an ordered list of segments,
    each a run of dense blocks (K2) or a run of sparse chunks (K4).
    ``block`` is the zeroed ``[N, stride]`` uint8 host block of the dense
    blocks (on a card a view of a pinned ring slot), block ``k`` (in
    order over every dense segment) at columns ``offsets[k]``; the caller
    writes its votes (0/1) there, then calls :meth:`dispatch` before its
    next call to the checker. The sparse chunks' lanes are packed at
    construction, chunk ``k`` at lanes ``[bounds[k], bounds[k + 1])``."""

    __slots__ = ("checker", "segments", "table", "stride", "block",
                 "offsets", "chunks", "bounds", "seg_table", "_slot",
                 "_held", "_off", "_lanes_off", "_newly_off")

    def __init__(self, checker, segments):
        self.checker, self.segments = checker, []
        n, window = checker.num_nodes, checker.window
        tables, chunks, seg_rows, stride, rows = [], [], [], 0, 0
        for kind, items in segments:
            if not items:
                continue
            if kind == "dense":
                starts, widths, rounds = [], [], []
                for start_slot, width, vote_round in items:
                    start = start_slot % window
                    if start + width > window:
                        raise ValueError(
                            f"block [{start}, {start + width}) straddles "
                            f"the ring end (window {window}); split it")
                    starts.append(int32(start_slot))
                    widths.append(width)
                    rounds.append(int32(vote_round))
                table, width = run_table(starts, widths, rounds, window)
                if stride:
                    table[:, 3] += stride
                stride += width
                tables.append(table)
                seg_rows.append((0, rows, rows + len(table)))
                rows += len(table)
            elif kind == "sparse":
                items = [(np.asarray(sl, dtype=np.int32), cl, rl, pad)
                         for sl, cl, rl, pad in items]
                seg_rows.append((1, len(chunks), len(chunks) + len(items)))
                chunks.extend(items)
            else:
                raise ValueError(f"a segment is 'dense' or 'sparse', got "
                                 f"{kind!r}")
            self.segments.append((kind, items))
        self.table = tables[0] if len(tables) == 1 else np.concatenate(
            tables) if tables else np.zeros((0, RUN_FIELDS), dtype=np.int32)
        self.stride = stride
        self.offsets = self.table[:, 3]
        self.chunks = chunks
        self.bounds = chunk_bounds([c[0].shape[0] for c in chunks]) \
            if chunks else _NO_BOUNDS
        self.seg_table = np.asarray(seg_rows, dtype=np.int32)
        b = int(self.bounds[-1])
        self._slot = None
        if checker._staged and (not chunks or checker._drain_staged):
            self._held = checker._take_held()
            r = self._held.size
            self._off = _align16(4 * r)
            self._lanes_off = _align16(self._off + n * stride)
            self._newly_off = _align16(stride)
            in_bytes = self._lanes_off + 4 * LANE_FIELDS * b if b \
                else self._off + n * stride
            slot = checker._run_ring().take(
                in_bytes, self._newly_off + b if b else stride)
            if r:
                slot.host_in[:4 * r].view(np.int32)[:] = self._held
            self.block = slot.host_in[self._off:self._off + n * stride] \
                .reshape(n, stride)
            self.block.fill(0)
            if b:
                # Every chunk's lanes side by side, packed in one pass.
                sl = np.concatenate([c[0] for c in chunks])
                cl = np.concatenate([np.asarray(c[1], dtype=np.int32)
                                     for c in chunks])
                rl = np.concatenate([
                    np.zeros(c[0].shape[0], np.int32) if c[2] is None
                    else np.asarray(c[2], dtype=np.int32) for c in chunks])
                _checker_lanes(sl, cl, rl, window, b, out=slot.host_in[
                    self._lanes_off:self._lanes_off + 4 * LANE_FIELDS * b]
                    .view(np.int32).reshape(LANE_FIELDS, b))
            self._slot = slot
        else:
            self.block = np.zeros((n, stride), dtype=np.uint8)

    def _note_spans(self) -> None:
        """The checker's window surveillance, in the reference's order:
        each dense block, then each chunk's slots, segment by segment."""
        c = self.checker
        for kind, items in self.segments:
            if kind == "dense":
                for start_slot, width, _ in items:
                    c._note_slot_span(start_slot, start_slot + width - 1)
            else:
                for sl, _, _, _ in items:
                    if sl.size:
                        c._note_slot_span(int(sl.min()), int(sl.max()))

    def dispatch(self) -> RunResult:
        """Record the run on the board, segment by segment in order: on a
        card ONE staged C call that does not wait (the in-block up, K5 on
        the held releases, each segment's launch, both ``newly`` down, an
        event), on PyTorch's current stream; on the CPU the plain
        versions (each chunk through the checker's
        :meth:`~TpuQuorumChecker.record_and_check_async`); on a mesh
        each block's :func:`record_block_sharded` and each chunk's
        :func:`record_and_check_sharded` (one all-reduce each)."""
        c = self.checker
        b = int(self.bounds[-1])
        if self._slot is None:
            return self._unstaged(b)
        self._note_spans()
        slot, board, pred = self._slot, c._board, c._pred
        r = self._held.size
        index = c._ring_index
        if not self.chunks:
            fn = _K2_STAGED.fn or _K2_STAGED.resolve()
            rc = fn(_K2_STAGED.pack(
                *_board_ptrs(board), self.table.ctypes.data,
                len(self.table), slot.host_in_ptr, slot.dev_in_ptr, r,
                self._off, self.stride, slot.dev_out_ptr, slot.host_out_ptr,
                self.stride, pred.perm_identity, *pred.c_args(), slot.event,
                index, _build.stream_handle(index)))
            if rc:
                _K2_STAGED.check(rc)
        else:
            fn = _BOARD_STAGED.fn or _BOARD_STAGED.resolve()
            rc = fn(_BOARD_STAGED.pack(
                *_board_ptrs(board), pred.perm_identity, *pred.c_args(),
                self.seg_table.ctypes.data, len(self.seg_table),
                self.table.ctypes.data, len(self.table),
                self.bounds.ctypes.data, len(self.chunks), slot.host_in_ptr,
                slot.dev_in_ptr, r, self._off, self.stride, self._lanes_off,
                b, slot.dev_out_ptr, slot.host_out_ptr, self._newly_off,
                self._newly_off + b, slot.event, index,
                _build.stream_handle(index)))
            if rc:
                _BOARD_STAGED.check(rc)
        for (kind, first, last) in self.seg_table.tolist():
            if kind == 0:
                record_block.launches += _launch_count(
                    self.table[first:last])
            else:
                record_and_check.launches += _sparse_launches(
                    self.bounds[first:last + 1])
        if r:
            release.launches += 1
        return RunResult(slot=slot, events=c._ring.events,
                         stride=self.stride, lane_at=self._newly_off,
                         nlanes=b)

    def _unstaged(self, b: int) -> RunResult:
        """The run off the staged path, segment by segment: the plain
        versions on the CPU, the sharded calls on a mesh. A card's board
        without a mesh raises: its runs take the staged entries."""
        c = self.checker
        mesh = c.mesh
        if mesh is None and c.device.type == "cuda":
            raise RuntimeError(
                "a board run on a card without a mesh takes its staged "
                "entry; the plain versions never run on card tensors")
        newly = None if mesh is not None else np.zeros(self.stride, bool)
        parts, lane_parts = [], []
        for (kind, items), (_, first, last) in zip(self.segments,
                                                   self.seg_table.tolist()):
            if kind == "dense":
                for start_slot, width, _ in items:
                    c._note_slot_span(start_slot, start_slot + width - 1)
                rows = self.table[first:last]
                if mesh is not None:
                    parts.extend((at, width, record_block_sharded(
                        c.board, mesh, col, true_start,
                        self.block[:, at:at + width], rnd, c._pred,
                        async_op=True))
                        for col, true_start, width, at, rnd, _
                        in rows.tolist())
                    continue
                got = record_block_run_plain(
                    c.board, rows, torch.from_numpy(self.block), c._pred)
                for _, _, width, at, _, _ in rows.tolist():
                    newly[at:at + width] = got[at:at + width].numpy()
            else:
                for j, (sl, cl, rl, pad) in enumerate(items):
                    lo = int(self.bounds[first + j])
                    lane_parts.append((lo, sl.shape[0],
                                       c.record_and_check_async(
                                           sl, cl, rl, pad_to=pad)))
        if mesh is not None:
            return RunResult(parts=parts, stride=self.stride,
                             lane_parts=lane_parts, nlanes=b)
        return RunResult(newly=newly, stride=self.stride,
                         lane_parts=lane_parts, nlanes=b)


# --- K4 / K6 shared: the sparse board update --------------------------------

#: The reference's ``_NEG_INF32``: the "no candidate" value of a lane's
#: owner and round max.
NEG_INF32 = -(2**31) + 1
LANE_FIELDS = 5  # slots % window, true slots, nodes, rounds, valid


def pack_lanes(slots, true_slots, nodes, vote_rounds, valid,
               size: Optional[int] = None,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """The ``[5, size]`` int32 lane array the sparse kernels take: slots
    (already reduced mod window), true slots, acceptor rows, rounds and
    valid (0/1), each assigned into int32 as the reference packs them
    (so true slots past 2^31 - 1 wrap), then padding lanes up to
    ``size`` at slot 0 with valid 0. ``out``, a ``[5, size]`` int32
    array (a view of pinned staging), is written and returned in place of
    a new array."""
    b = np.shape(slots)[0]
    if out is None:
        out = np.zeros((LANE_FIELDS, max(b, size or 0)), dtype=np.int32)
    else:
        out[:, b:] = 0
    for row, values in enumerate((slots, true_slots, nodes, vote_rounds,
                                  valid)):
        out[row, :b] = values
    return out


def _checker_lanes(slots: np.ndarray, node_cols, rounds, window: int,
                   size: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The checkers' packing of one batch of votes (all valid; rounds 0
    when None), padded to ``size`` (into ``out`` when given)."""
    b = slots.shape[0]
    rounds = np.zeros(b, dtype=np.int32) if rounds is None \
        else np.asarray(rounds, dtype=np.int32)
    return pack_lanes(slots % window, slots,
                      np.asarray(node_cols, dtype=np.int32), rounds,
                      np.ones(b, dtype=bool), size, out)


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

#: Chunks of one K4 launch at most (their lane offsets travel in the
#: kernel's parameters, ``csrc/sparse.cuh``); a longer run takes more
#: launches, in order.
MAX_RUN_CHUNKS = 256


def record_and_check_plain(board: VoteBoard, lanes: torch.Tensor,
                           pred: QuorumPredicate) -> torch.Tensor:
    """Plain PyTorch version of K4 (the reference's ``_record_and_check``):
    updates the board in place and returns the per-lane ``[B]`` "slot
    newly has quorum" mask."""
    state = _apply_sparse_votes_plain(board, lanes)
    cols, inv, mine, votes = state[:4]
    hit = quorum_hit_plain(votes, pred)[inv]
    return _finish_sparse_plain(board, *state, hit)


def chunk_bounds(sizes) -> np.ndarray:
    """The ``[len(sizes) + 1]`` int32 lane offsets of a run of chunks of
    ``sizes`` lanes laid side by side (what :func:`record_and_check_run`
    takes)."""
    return np.fromiter(itertools.accumulate(sizes, initial=0),
                       dtype=np.int32, count=len(sizes) + 1)


#: The bounds of a run of no chunk.
_NO_BOUNDS = chunk_bounds([])


def record_and_check_run_plain(board: VoteBoard, lanes: torch.Tensor,
                               bounds,
                               pred: QuorumPredicate) -> torch.Tensor:
    """Plain PyTorch version of K4's run: :func:`record_and_check_plain`
    on each chunk ``lanes[:, bounds[k]:bounds[k + 1]]`` in order. Returns
    the ``[B]`` newly mask (False on lanes outside every chunk)."""
    newly = torch.zeros((lanes.shape[1],), dtype=torch.bool,
                        device=lanes.device)
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if hi > lo:
            newly[lo:hi] = record_and_check_plain(board, lanes[:, lo:hi],
                                                  pred)
    return newly


def _sparse_launches(bounds: np.ndarray) -> int:
    """The launches of a run's chunks, as the C entry splits them: one
    per :data:`MAX_RUN_CHUNKS` chunks that hold a lane."""
    n = bounds.size - 1
    return sum(int(bounds[min(k + MAX_RUN_CHUNKS, n)] > bounds[k])
               for k in range(0, n, MAX_RUN_CHUNKS))


def _run_bounds(bounds, b: int) -> np.ndarray:
    bounds = np.ascontiguousarray(bounds, dtype=np.int32)
    if bounds.ndim != 1 or bounds.size < 1 or bounds[0] < 0 \
            or bounds[-1] > b or (bounds[1:] < bounds[:-1]).any():
        raise ValueError(f"bounds must be nondecreasing lane offsets in "
                         f"[0, {b}]")
    return bounds


_K4 = _build.Entry("quorum", "fpx_record_and_check_run", 23)


def _launch_run(board: VoteBoard, lanes: torch.Tensor, bounds: np.ndarray,
                newly: torch.Tensor, pred: QuorumPredicate) -> None:
    """One packed call of K4's run on checked tensors."""
    if not all(t.is_contiguous() for t in (lanes, *board)):
        raise ValueError("record_and_check needs contiguous tensors")
    index = lanes.get_device()
    fn = _K4.fn or _K4.resolve()
    rc = fn(_K4.pack(*_board_ptrs(board), lanes.data_ptr(), lanes.shape[1],
                     bounds.ctypes.data, bounds.size - 1, newly.data_ptr(),
                     pred.perm_identity, *pred.c_args(), index,
                     _build.stream_handle(index)))
    if rc:
        _K4.check(rc)


def _check_sparse(board: VoteBoard, lanes: torch.Tensor,
                  pred: QuorumPredicate) -> int:
    n = board.votes.shape[0]
    b = _check_lanes(board, lanes)
    if n != pred.num_nodes:
        raise ValueError(f"board has {n} rows, predicate has "
                         f"{pred.num_nodes} nodes")
    return b


def record_and_check_run(board: VoteBoard, lanes: torch.Tensor, bounds,
                         pred: QuorumPredicate) -> torch.Tensor:
    """K4 on a RUN of chunks, IN PLACE: chunk ``k`` is the lanes
    ``[bounds[k], bounds[k + 1])`` of the ``[5, B]`` int32 ``lanes``
    (:func:`pack_lanes`; ``bounds`` a host array of nondecreasing lane
    offsets, :func:`chunk_bounds`), each chunk one call of
    :func:`record_and_check`, in order: duplicates inside a chunk each
    report, a chunk sees the ``chosen`` bits of the chunks before it.
    Returns the ``[B]`` newly mask (False outside every chunk). Padding
    lanes change nothing, so a run takes its lanes unpadded. CUDA tensors
    launch ``csrc/sparse.cuh::record_and_check_run_kernel`` through the
    lean call path (one packed ``ctypes`` call; one launch per
    :data:`MAX_RUN_CHUNKS` chunks); CPU tensors take
    :func:`record_and_check_run_plain`."""
    b = _check_sparse(board, lanes, pred)
    bounds = _run_bounds(bounds, b)
    if not use_kernel(lanes, *board, pred.masks):
        return record_and_check_run_plain(board, lanes, bounds, pred)
    # Lanes outside every chunk read False; the kernel writes the rest.
    covered = bounds[0] == 0 and bounds[-1] == b
    newly = (torch.empty if covered else torch.zeros)(
        (b,), dtype=torch.bool, device=lanes.device)
    launches = _sparse_launches(bounds)
    if launches:
        _launch_run(board, lanes, bounds, newly, pred)
        record_and_check.launches += launches
    return newly


def record_and_check(board: VoteBoard, lanes: torch.Tensor,
                     pred: QuorumPredicate) -> torch.Tensor:
    """K4: the sparse scatter of one batch of votes, IN PLACE.

    ``lanes`` is the ``[5, B]`` int32 array of :func:`pack_lanes`. Slots
    and nodes out of range follow JAX's index rules: a negative one
    counts from the end; a slot still outside ``[0, window)`` reads the
    clamped column and writes nothing, a node outside ``[-N, N)``
    records nothing. Duplicate slots each report quorum. CUDA tensors
    launch ``csrc/sparse.cuh::record_and_check_run_kernel`` on a run of
    one chunk (one packed ``ctypes`` call); CPU tensors take
    :func:`record_and_check_plain`."""
    b = _check_sparse(board, lanes, pred)
    if not use_kernel(lanes, *board, pred.masks):
        return record_and_check_plain(board, lanes, pred)
    newly = torch.empty((b,), dtype=torch.bool, device=lanes.device)
    if b == 0:
        return newly
    _launch_run(board, lanes, np.array([0, b], dtype=np.int32), newly, pred)
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


_K5 = _build.Entry("sparse", "fpx_release", 11)
_K5_ALL = _build.Entry("sparse", "fpx_release_all", 10)
_K5_STAGED = _build.Entry("sparse", "fpx_release_staged", 11,
                          keep_gil=False)


def release(board: VoteBoard, slots: torch.Tensor,
            valid: torch.Tensor) -> None:
    """K5: reset the columns of GC'd slots IN PLACE: votes 0, round -1,
    chosen false, owner -1, for each lane whose ``valid`` is true.

    ``slots`` is ``[B]`` int32, ``valid`` ``[B]`` bool. A slot named by
    several lanes is reset when ANY of them is valid (JAX's ``.set``
    leaves the order of such duplicates unspecified; every caller passes
    all-valid lanes, which :func:`release_all` takes). CUDA tensors
    launch ``csrc/sparse.cu::release_kernel`` (one packed ``ctypes``
    call); CPU tensors take :func:`release_plain`."""
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
    index = slots.get_device()
    fn = _K5.fn or _K5.resolve()
    rc = fn(_K5.pack(*_board_ptrs(board), slots.data_ptr(),
                     valid.data_ptr(), b, index,
                     _build.stream_handle(index)))
    if rc:
        _K5.check(rc)
    release.launches += 1
    return None


def release_all_plain(board: VoteBoard, slots: torch.Tensor) -> None:
    """Plain PyTorch version of K5's all-valid form: :func:`release_plain`
    with every lane valid."""
    release_plain(board, slots, torch.ones(slots.shape, dtype=torch.bool,
                                           device=slots.device))


def release_all(board: VoteBoard, slots: torch.Tensor) -> None:
    """K5's all-valid form, IN PLACE: reset the column of every ``[B]``
    int32 slot (JAX's index rules, as :func:`release`). CUDA tensors
    launch ``csrc/release.cuh::release_all_kernel`` (four lanes a thread,
    no ``valid`` array; one packed call); CPU tensors take
    :func:`release_all_plain`."""
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise ValueError("release_all takes [B] int32 slots")
    if not use_kernel(slots, *board):
        return release_all_plain(board, slots)
    if not all(t.is_contiguous() for t in (slots, *board)):
        raise ValueError("release_all needs contiguous tensors")
    if slots.shape[0] == 0:
        return None
    index = slots.get_device()
    fn = _K5_ALL.fn or _K5_ALL.resolve()
    rc = fn(_K5_ALL.pack(*_board_ptrs(board), slots.data_ptr(),
                         slots.shape[0], index, _build.stream_handle(index)))
    if rc:
        _K5_ALL.check(rc)
    release.launches += 1
    return None


def release_staged(board: VoteBoard, staging: _build.Staging,
                   cols: np.ndarray) -> None:
    """K5's all-valid form on host ``cols`` (int32, already % window) in
    ONE call with the GIL released: the slots written into ``staging``'s
    pinned ``"released"`` buffer, up, the launch, a wait on PyTorch's
    current stream (the stream the board call that follows uses)."""
    r = cols.shape[0]
    if not r:
        return
    pair = staging.pair("released", r, torch.int32)
    pair.host[:r] = cols
    fn = _K5_STAGED.fn or _K5_STAGED.resolve()
    rc = fn(_K5_STAGED.pack(*_board_ptrs(board), pair.host_ptr,
                            pair.device_ptr, r, staging.index,
                            _build.stream_handle(staging.index)))
    if rc:
        _K5_STAGED.check(rc)
    release.launches += 1


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


def _multi_planes_np(masks, thresholds, combine_any) -> tuple:
    """``pad_specs`` output as contiguous int32 / int32 / bool arrays;
    raises where the shapes are not ``[K, G, N]``, ``[K, G]``, ``[K]``."""
    masks = np.ascontiguousarray(masks, dtype=np.int32)
    thresholds = np.ascontiguousarray(thresholds, dtype=np.int32)
    combine_any = np.ascontiguousarray(combine_any, dtype=bool)
    k = masks.shape[0] if masks.ndim == 3 else 0
    if k < 1 or thresholds.shape != masks.shape[:2] \
            or combine_any.shape != (k,):
        raise ValueError(f"planes {masks.shape}, {thresholds.shape}, "
                         f"{combine_any.shape} are not [K, G, N], [K, G], "
                         f"[K] with K >= 1")
    return masks, thresholds, combine_any


def make_multi_predicate(masks, thresholds, combine_any,
                         device=None) -> MultiPredicate:
    """The planes of ``pad_specs`` output on ``device``."""
    device = resolve_device(device)
    return MultiPredicate(*(torch.from_numpy(a).to(device) for a in
                            _multi_planes_np(masks, thresholds, combine_any)))


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


#: K6's stateless entry (18 int64; ``csrc/epoch.cu``): every caller's, the
#: tensor wrapper's launch (rows on the card, the current stream, no wait)
#: and :class:`MultiCheck`'s staged call (rows in a pinned block read in
#: place, the planes and a small batch in the kernel's parameters, a wait
#: with the GIL released).
_K6_MULTI = _build.Entry("epoch", "fpx_check_batch_multi_staged", 18,
                         keep_gil=False)
#: The flags of its packed block: the rows are packed 32-bit words; the
#: rows, indices and answers lie in a pinned block (mapped memory).
_MULTI_BITS, _MULTI_MAPPED = 1, 2
#: The int32 cells the entry carries in the kernel's parameters
#: (``kParamCells``): planes' host cells up to this many are never read
#: from the card.
_MULTI_PARAM_CELLS = 32
#: ``{card index, or the device named: _build.Staging}``: the stream of
#: the staged checks (their inputs all come from the host).
_MULTI_STAGING: dict = {}


def check_batch_multi(present: torch.Tensor, config_idx: torch.Tensor,
                      planes: MultiPredicate) -> torch.Tensor:
    """K6 (stateless): ``[B, N]`` int32 responder rows (any strides) ->
    ``[B]`` bool, each row under its own configuration plane. CUDA
    tensors launch ``csrc/epoch.cu``'s check (the planes read from the
    card) on the current stream; CPU tensors take
    :func:`check_batch_multi_plain`. Host rows take :class:`MultiCheck`."""
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
    k, g, n = planes.masks.shape
    index = present.get_device()
    fn = _K6_MULTI.fn or _K6_MULTI.resolve()
    rc = fn(_K6_MULTI.pack(
        present.data_ptr(), present.stride(0), present.stride(1), b, n,
        config_idx.data_ptr() if k > 1 else 0, out.data_ptr(), 0, 0, 0,
        planes.masks.data_ptr(), planes.thresholds.data_ptr(),
        planes.combine_any.data_ptr(), k, g, 0, index,
        _build.stream_handle(index)))
    if rc:
        _K6_MULTI.check(rc)
    check_batch_multi.launches += 1
    return out


check_batch_multi.launches = 0


def _ceil4(x: int) -> int:
    return (x + 3) & ~3


def _pinned_cells(cells: int) -> torch.Tensor:
    """A pinned host block of ``cells`` int32 (:class:`MultiCheck`'s)."""
    return torch.empty(cells, dtype=torch.int32, pin_memory=True)


class MultiCheck:
    """K6's stateless check of HOST rows, one staged call a check.

    The planes (``pad_specs``' ``[K, G, N]`` masks, ``[K, G]`` thresholds
    and ``[K]`` any flags) are made once: on the card, and as host cells
    that ride in the kernel's parameters where they fit (the masks as one
    32-bit word a group when every mask is 0 or 1 and N <= 32). A check
    writes its rows (int32) and config indices into this checker's reused
    pinned block; ONE ``ctypes`` call with the GIL released launches the
    check on them in place (a small batch carried in the parameters) and
    waits on the staging's stream; the answer bytes come back in the same
    block. :meth:`check_word` is the one-row form of a 0/1 row given as a
    word, counted by popcount (packing a batch's 0/1 rows into words on
    the host measured slower than the int32 copy); :meth:`check_word_all`
    checks one word under every plane in one call. ``device="cpu"`` runs
    :func:`check_batch_multi_plain`."""

    #: int32 cells at the front of the block for :meth:`check_word`: the
    #: word at 0, its config index at ``ONE_CFG``, its answer byte at cell
    #: ``ONE_OUT``; :meth:`check_word_all`'s indices ``0..K-1`` start at
    #: ``ONE_CELLS`` and its K answer bytes at :attr:`all_out`; a batch's
    #: rows start at :attr:`rows_at`.
    ONE_CFG, ONE_OUT, ONE_CELLS = 4, 8, 16

    def __init__(self, masks, thresholds, combine_any, device=None):
        masks, thresholds, combine_any = self._planes_np = _multi_planes_np(
            masks, thresholds, combine_any)
        self.device = resolve_device(device)
        self.k, self.g, self.n = masks.shape
        kg = self.k * self.g
        any_cells = np.zeros(_ceil4(self.k), dtype=np.uint8)
        any_cells[:self.k] = combine_any
        tail = [thresholds.ravel(), any_cells.view(np.int32)]
        #: The planes' host cells, int32 form: masks, thresholds, any.
        self.cells_int = np.concatenate([masks.ravel()] + tail)
        #: True where the masks are all 0 or 1 and N <= 32: a 0/1 row then
        #: packs into a word (:meth:`check_word`) and counts by popcount.
        self.bits = self.n <= 32 and bool(((masks == 0) | (masks == 1)).all())
        self.cells_bits = None
        if self.bits:
            words = (masks.reshape(kg, self.n).astype(np.int64)
                     << np.arange(self.n)).sum(1).astype(np.uint32)
            self.cells_bits = np.concatenate([words.view(np.int32)] + tail)
        #: The cells of :meth:`check_word_all`'s answers, and of a batch's
        #: rows after them (on the 16-byte grid).
        self.all_out = self.ONE_CELLS + _ceil4(self.k)
        self.rows_at = self.all_out + _ceil4(_ceil4(self.k) // 4)
        # The planes go up to the card only where a staged call reads
        # them there (their host cells do not fit the parameters): see
        # _card_planes.
        self._planes = self._bits_card = None
        self._card_ready = self.device.type != "cuda"
        self._staging = _build.staging(_MULTI_STAGING, self.device) \
            if self.device.type == "cuda" else None
        if self._staging is None:
            return
        self._cap = 0
        self._grow(self.rows_at + 48)
        _K6_MULTI.fn or _K6_MULTI.resolve()

    @property
    def planes(self) -> MultiPredicate:
        """The planes on :attr:`device` (made at the first use: the
        tensor wrapper's argument, and the plain version's)."""
        if self._planes is None:
            self._planes = MultiPredicate(*(
                torch.from_numpy(a).to(self.device) for a in self._planes_np))
            self._card_ready = self.device.type != "cuda"
        return self._planes

    def _card_planes(self, bits: bool) -> tuple:
        """The card pointers a staged call in ``bits`` form passes for the
        planes: 0s where the host cells fit the parameters (the entry
        carries them there and never reads the card), else the planes on
        the card, waited for once after each upload (the staged calls run
        on the staging's own stream, the uploads on the current one)."""
        cells = self.cells_bits if bits else self.cells_int
        if cells.size <= _MULTI_PARAM_CELLS:
            return 0, 0, 0
        if bits:
            if self._bits_card is None:
                self._bits_card = torch.from_numpy(cells).to(self.device)
                self._card_ready = self.device.type != "cuda"
            kg = self.k * self.g
            ptr = self._bits_card.data_ptr()
            ptrs = ptr, ptr + 4 * kg, ptr + 8 * kg
        else:
            planes = self.planes
            ptrs = (planes.masks.data_ptr(), planes.thresholds.data_ptr(),
                    planes.combine_any.data_ptr())
        if not self._card_ready:
            torch.cuda.synchronize(self.device)
            self._card_ready = True
        return ptrs

    def _grow(self, cells: int) -> None:
        """A pinned block of at least ``cells`` int32 cells, and the packed
        calls of :meth:`check_word` and :meth:`check_word_all` on it."""
        if cells <= self._cap:
            return
        cells = max(cells, self.rows_at)
        self._cap = 1 << max(6, (cells - 1).bit_length())
        self._block = _pinned_cells(self._cap)
        self._host = self._block.numpy()
        self._host[:self.rows_at] = 0
        self._host[self.ONE_CELLS:self.ONE_CELLS + self.k] = np.arange(self.k)
        self._u8 = self._host.view(np.uint8)
        self._u32 = self._host.view(np.uint32)
        self._base = self._block.data_ptr()
        if self.bits:
            base = self._base
            self._one = self._pack(base, 1, 1, 1, base + 4 * self.ONE_CFG,
                                   base + 4 * self.ONE_OUT, True)
            # The word at cell 0 read K times (row stride 0), each time
            # under the preset index of its row.
            self._all = self._pack(base, 0, 1, self.k,
                                   base + 4 * self.ONE_CELLS,
                                   base + 4 * self.all_out, True)

    def _pack(self, rows: int, row_stride: int, col_stride: int, b: int,
              cfg: int, out: int, bits: bool) -> bytes:
        cells = self.cells_bits if bits else self.cells_int
        masks, thr, anys = self._card_planes(bits)
        st = self._staging
        return _K6_MULTI.pack(
            rows, row_stride, col_stride, b, self.n,
            cfg if self.k > 1 else 0, out,
            (_MULTI_BITS if bits else 0) | _MULTI_MAPPED,
            cells.ctypes.data, cells.size, masks, thr, anys, self.k, self.g,
            self._base, st.index, st.stream_handle)

    def check_word(self, word: int, config: int = 0) -> bool:
        """One 0/1 row given as a word (bit ``i``: universe node ``i``
        voted) under plane ``config``; needs :attr:`bits`."""
        if self._staging is None:
            row = torch.tensor([[(word >> i) & 1 for i in range(self.n)]],
                               dtype=torch.int32)
            return bool(check_batch_multi_plain(
                row, torch.tensor([config], dtype=torch.int32),
                self.planes)[0])
        if not self.bits:
            raise ValueError("check_word needs 0/1 masks and N <= 32")
        self._u32[0] = word
        if self.k > 1:
            self._host[self.ONE_CFG] = config
        rc = _K6_MULTI.fn(self._one)
        if rc:
            _K6_MULTI.check(rc)
        check_batch_multi.launches += 1
        return bool(self._u8[4 * self.ONE_OUT])

    def check_word_all(self, word: int) -> np.ndarray:
        """One 0/1 row given as a word under EVERY plane -> ``[K]`` bool, a
        fresh array: :meth:`check` of K equal rows under ``arange(K)`` in
        one staged call (the word read K times, the indices preset in the
        block); needs :attr:`bits`."""
        if not self.bits:
            raise ValueError("check_word_all needs 0/1 masks and N <= 32")
        if self._staging is None:
            row = torch.tensor([(word >> i) & 1 for i in range(self.n)],
                               dtype=torch.int32)
            return check_batch_multi_plain(
                row.expand(self.k, self.n),
                torch.arange(self.k, dtype=torch.int32), self.planes).numpy()
        self._u32[0] = word
        rc = _K6_MULTI.fn(self._all)
        if rc:
            _K6_MULTI.check(rc)
        check_batch_multi.launches += 1
        at = 4 * self.all_out
        return self._u8[at:at + self.k].view(np.bool_).copy()

    def check(self, present, config_idx=None) -> np.ndarray:
        """``[B, N]`` rows (integers or bools, taken as int32 as the
        reference's ``astype`` takes them) under ``config_idx[b]`` (all 0
        when None) -> ``[B]`` bool, a fresh array."""
        present = np.asarray(present)
        if present.ndim != 2 or present.shape[1] != self.n:
            raise ValueError(f"present must be [B, {self.n}], got "
                             f"{present.shape}")
        b = present.shape[0]
        cfg = np.zeros(b, dtype=np.int32) if config_idx is None \
            else np.asarray(config_idx)
        if cfg.shape != (b,):
            raise ValueError(f"config_idx must be [{b}], got {cfg.shape}")
        if self._staging is None:
            return check_batch_multi_plain(
                torch.from_numpy(present.astype(np.int32)),
                torch.from_numpy(cfg.astype(np.int32)), self.planes).numpy()
        if b == 0:
            return np.zeros(0, dtype=bool)
        rows_at = self.rows_at
        cfg_at = rows_at + _ceil4(b * self.n)
        out_at = cfg_at + (_ceil4(b) if self.k > 1 else 0)
        self._grow(out_at + _ceil4(b) // 4)
        self._host[rows_at:rows_at + b * self.n].reshape(
            b, self.n)[...] = present
        if self.k > 1:
            self._host[cfg_at:cfg_at + b] = cfg
        base = self._base
        rc = _K6_MULTI.fn(self._pack(base + 4 * rows_at, self.n, 1, b,
                                     base + 4 * cfg_at, base + 4 * out_at,
                                     False))
        if rc:
            _K6_MULTI.check(rc)
        check_batch_multi.launches += 1
        return self._u8[4 * out_at:4 * out_at + b].view(np.bool_).copy()


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


def record_and_check_epochs_run_plain(board: VoteBoard, lanes: torch.Tensor,
                                      boundaries: torch.Tensor,
                                      planes: MultiPredicate,
                                      chunk: int) -> torch.Tensor:
    """Plain PyTorch version of K6's run: :func:`record_and_check_epochs_plain`
    on each ``chunk`` lanes in order, the results concatenated."""
    b = lanes.shape[1]
    parts = [record_and_check_epochs_plain(board, lanes[:, at:at + chunk],
                                           boundaries, planes)
             for at in range(0, b, chunk)]
    return torch.cat(parts) if parts \
        else torch.empty((0,), dtype=torch.bool, device=lanes.device)


def _epochs_block(board: VoteBoard, lanes_ptr: int, b: int, chunk: int,
                  boundaries: torch.Tensor, planes: MultiPredicate,
                  newly_ptr: int) -> tuple:
    """The first 17 slots of K6's packed block (the device and the stream
    follow)."""
    n, window = board.votes.shape
    k, g, _ = planes.masks.shape
    return (board.votes.data_ptr(), board.rounds.data_ptr(),
            board.chosen.data_ptr(), board.owner.data_ptr(), window, n,
            lanes_ptr, b, chunk, boundaries.data_ptr(), boundaries.shape[0],
            newly_ptr, planes.masks.data_ptr(), planes.thresholds.data_ptr(),
            planes.combine_any.data_ptr(), k, g)


_K6 = _build.Entry("epoch", "fpx_record_and_check_epochs", 19)
_K6_STAGED = _build.Entry("epoch", "fpx_record_and_check_epochs_staged", 22,
                          keep_gil=False)


def _check_epochs(board: VoteBoard, lanes: torch.Tensor,
                  boundaries: torch.Tensor, planes: MultiPredicate) -> int:
    n = board.votes.shape[0]
    b = _check_lanes(board, lanes)
    if n != planes.num_nodes:
        raise ValueError(f"board has {n} rows, planes have "
                         f"{planes.num_nodes} nodes")
    if boundaries.dtype != torch.int32 \
            or boundaries.shape != (planes.masks.shape[0] - 1,):
        raise ValueError(f"boundaries must be [{planes.masks.shape[0] - 1}]"
                         f" int32")
    return b


def record_and_check_epochs_run(board: VoteBoard, lanes: torch.Tensor,
                                boundaries: torch.Tensor,
                                planes: MultiPredicate,
                                chunk: int) -> torch.Tensor:
    """K6 on a RUN of chunks, IN PLACE: the ``[5, B]`` lanes taken
    ``chunk`` at a time, in order, each chunk one call of
    :func:`record_and_check_epochs` (duplicates inside a chunk each
    report; a chunk sees the ``chosen`` bits of the chunks before it).
    Returns the ``[B]`` newly mask, the chunks' results concatenated.
    Padding lanes change nothing, so a run takes its lanes unpadded.
    CUDA tensors launch ``csrc/epoch.cu::record_and_check_epochs_run_kernel``
    ONCE (one packed ``ctypes`` call); CPU tensors take
    :func:`record_and_check_epochs_run_plain`."""
    b = _check_epochs(board, lanes, boundaries, planes)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if not use_kernel(lanes, *board, boundaries, *planes):
        return record_and_check_epochs_run_plain(board, lanes, boundaries,
                                                 planes, chunk)
    return _launch_epochs(board, lanes, boundaries, planes, chunk, b)


def _launch_epochs(board: VoteBoard, lanes: torch.Tensor,
                   boundaries: torch.Tensor, planes: MultiPredicate,
                   chunk: int, b: int) -> torch.Tensor:
    """One launch of K6's run kernel on checked CUDA tensors."""
    if not all(t.is_contiguous() for t in (lanes, boundaries, *board,
                                            *planes)):
        raise ValueError("record_and_check_epochs needs contiguous tensors")
    newly = torch.empty((b,), dtype=torch.bool, device=lanes.device)
    if b == 0:
        return newly
    index = lanes.get_device()
    fn = _K6.fn or _K6.resolve()
    rc = fn(_K6.pack(*_epochs_block(
        board, lanes.data_ptr(), b, chunk, boundaries, planes,
        newly.data_ptr()), index, _build.stream_handle(index)))
    if rc:
        _K6.check(rc)
    record_and_check_epochs.launches += 1
    return newly


def record_and_check_epochs(board: VoteBoard, lanes: torch.Tensor,
                            boundaries: torch.Tensor,
                            planes: MultiPredicate) -> torch.Tensor:
    """K6: the epoch-segmented sparse scatter, IN PLACE.

    As :func:`record_and_check`, but each lane's quorum predicate is the
    plane of its SLOT's epoch; ``boundaries`` is the ``[K-1]`` int32
    nondecreasing start slots of epochs 1..K-1. The run kernel with one
    chunk of all ``B`` lanes (:func:`record_and_check_epochs_run`); CPU
    tensors take :func:`record_and_check_epochs_plain`."""
    b = _check_epochs(board, lanes, boundaries, planes)
    if not use_kernel(lanes, *board, boundaries, *planes):
        return record_and_check_epochs_plain(board, lanes, boundaries,
                                             planes)
    return _launch_epochs(board, lanes, boundaries, planes, max(b, 1), b)


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


#: K7's packed entry: 8 int64 (block, n_old, b, n_new, out, the map on
#: the card or 0, device, stream), then the map's int32 when it crosses
#: in the block (up to :func:`reshape_map_max` rows).
_K7 = _build.Entry("epoch", "fpx_reshape_columns", 8)


@functools.cache
def reshape_map_max() -> int:
    """The longest map K7's packed block carries: the C entry's
    ``kMapMax``, asked of the library at the first launch."""
    return _build.library("epoch").fpx_reshape_columns_map_max()


def _check_reshape(block: torch.Tensor, cmap) -> None:
    if block.dtype != torch.uint8 or block.dim() != 2 \
            or block.shape[0] < 1:
        raise ValueError(f"block must be [N_old >= 1, B] uint8, got "
                         f"{block.dtype} {tuple(block.shape)}")
    if not _int32_map(cmap) or cmap.ndim != 1:
        raise ValueError("cmap must be [N_new] int32")


def _int32_map(cmap) -> bool:
    return cmap.dtype == (np.int32 if isinstance(cmap, np.ndarray)
                          else torch.int32)


def _check_reshape_out(out: torch.Tensor, block: torch.Tensor,
                       n_new: int) -> torch.Tensor:
    b = block.shape[1]
    if out.dtype is not torch.uint8 or tuple(out.shape) != (n_new, b) \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous [{n_new}, {b}] uint8 "
                         f"tensor, got {out.dtype} {tuple(out.shape)}")
    lo, hi = out.data_ptr(), out.data_ptr() + out.numel()
    if out.numel() and block.numel() and lo < block.data_ptr() \
            + block.numel() and block.data_ptr() < hi:
        raise ValueError("reshape_columns: out overlaps the block")
    return out


def reshape_columns(block: torch.Tensor, cmap,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K7: gather the acceptor rows of a ``[N_old, B]`` uint8 block by the
    ``[N_new]`` int32 map into a NEW ``[N_new, B]`` tensor, or into
    ``out`` (a contiguous ``[N_new, B]`` uint8 tensor on the block's
    device that does not overlap it), which is returned. ``cmap`` is a
    host map (a numpy array or a CPU tensor) or a tensor on the block's
    card. CUDA blocks launch ``csrc/epoch.cu::reshape_columns_kernel``
    through the lean call path: a host map of up to
    :func:`reshape_map_max` rows crosses in the call's packed block (no
    copy is queued ahead of the launch), a longer one is staged to the
    card first, and a map on the card is read there. CPU blocks take
    :func:`reshape_columns_plain`."""
    _check_reshape(block, cmap)
    host = cmap if isinstance(cmap, np.ndarray) \
        else cmap.numpy() if cmap.device.type == "cpu" else None
    index = block.get_device()
    if index < 0 or (host is None and cmap.get_device() != index) \
            or (out is not None and out.get_device() != index):
        if not use_kernel(block, *(() if host is not None else (cmap,)),
                          *(() if out is None else (out,))):
            got = reshape_columns_plain(
                block, torch.from_numpy(host) if host is not None else cmap)
            return got if out is None else \
                _check_reshape_out(out, block, got.shape[0]).copy_(got)
    if not block.is_contiguous() or (host is None
                                     and not cmap.is_contiguous()):
        raise ValueError("reshape_columns needs contiguous tensors")
    n_old, b = block.shape
    n_new = cmap.shape[0]
    if out is None:
        out = block.new_empty((n_new, b))
    else:
        _check_reshape_out(out, block, n_new)
    if n_new == 0 or b == 0:
        return out
    tail = b""
    if host is None:
        dmap = cmap.data_ptr()
    elif n_new <= reshape_map_max():
        dmap, tail = 0, np.ascontiguousarray(host).tobytes()
    else:
        staged = stage(host, block.device)
        dmap = staged.data_ptr()
    fn = _K7.fn or _K7.resolve()
    rc = fn(_K7.pack(block.data_ptr(), n_old, b, n_new, out.data_ptr(),
                     dmap, index, _build.stream_handle(index)) + tail)
    if rc:
        _K7.check(rc)
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
    return reshape_columns(stage(np.asarray(block, dtype=np.uint8), device),
                           cmap).cpu().numpy()


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
                                    chunk: Optional[int] = None,
                                    async_op: bool = False):
    """K6 on a sharded board, as :func:`record_and_check_sharded`; the
    epoch planes and boundaries are whole on every rank, and each lane's
    plane comes from its (unrebased) true slot. With ``chunk``, the lanes
    are a run (:func:`record_and_check_epochs_run`): one launch and one
    all-reduce for all of its chunks (a lane another rank owns is inert
    in its chunk, so each chunk keeps its batch semantics)."""
    return _sparse_sharded(
        board, mesh, lanes,
        lambda t: record_and_check_epochs_run(board, t, boundaries, planes,
                                              chunk or max(t.shape[1], 1)),
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


_NO_SLOTS = np.zeros(0, dtype=np.int32)


class _HeldReleases:
    """A checker's board and the releases it holds.

    The reference's ``release`` resets the columns at once. A checker
    without a mesh keeps the released slots (% window) in a host list
    until its next board call instead: K2's run (:class:`BoardRun`) and
    K6's run (``EpochSegmentedChecker.record_and_check_run``) apply them on
    the card ahead of their own launch, in the same staged call and on the
    same stream; every other access to the board (K4, a single K2 call,
    K7's reshape, reading or replacing ``board``) flushes them first
    (:meth:`flush_releases`: one staged K5 call on a card, the plain
    version on the CPU). Only the checker's own calls read or write its
    board, so the board goes through the same sequence of resets and
    updates as with an immediate release. On a mesh a release is
    immediate (``release_sharded``)."""

    @property
    def board(self) -> VoteBoard:
        self.flush_releases()
        return self._board

    @board.setter
    def board(self, board: VoteBoard) -> None:
        self.flush_releases()
        self._board = board

    def release(self, slots) -> None:
        """GC slot columns below the chosen watermark so the ring can wrap
        (K5): held until the checker's next board call (see the class
        docstring); on a mesh, reset at once on this rank's columns."""
        slots = np.asarray(slots, dtype=np.int32) % self.window
        if self.mesh is not None:
            release_sharded(self._board, self.mesh, slots,
                            np.ones(slots.shape[0], dtype=bool))
        elif slots.size:
            self._held.append(slots.astype(np.int32, copy=False))

    def flush_releases(self) -> None:
        """Apply the held releases to the board now."""
        if not self._held:
            return
        cols = self._take_held()
        if self._staged:
            release_staged(self._board, self._stage(), cols)
        else:
            release_all_plain(self._board,
                              torch.from_numpy(cols).to(self.device))

    def _take_held(self) -> np.ndarray:
        held, self._held = self._held, []
        if not held:
            return _NO_SLOTS
        return held[0] if len(held) == 1 else np.concatenate(held)

    def _stage(self) -> _build.Staging:
        if self._staging is None:
            self._staging = _build.Staging(self.device)
        return self._staging


class TpuQuorumChecker(_HeldReleases):
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
        self._board = make_vote_board(window, spec.num_nodes, self.device,
                                      mesh)
        self._held: list = []
        # The staged paths (K1's check_staged, K2's runs, K5's flush) on a
        # card without a mesh; check_block's host block and the flush's
        # slots in pinned staging made at the first call, K2's runs in a
        # ring of pinned slots (RunRing).
        self._staged = self.device.type == "cuda" and mesh is None
        # A board run with sparse segments takes the drain's staged
        # entry (fpx_board_run_staged) where this is set (on a card, with
        # _staged); a CPU checker runs the plain versions chunk by chunk.
        self._drain_staged = self._staged
        self._staging = None
        self._host_block = None
        self._ring = None
        self._ring_index = self.device.index

    def _run_ring(self) -> RunRing:
        if self._ring is None:
            if self._ring_index is None:
                self._ring_index = torch.cuda.current_device()
            dev = torch.device("cuda", self._ring_index)
            self._ring = RunRing(_card_alloc(dev),
                                 _CardEvents(self._ring_index))
        return self._ring

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
            wide = np.zeros((n, padded), dtype=np.uint8)
            wide[:, :b] = block
            block = wide
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
        end); return the ``[B]`` newly-chosen mask. A run of one block
        (:meth:`dense_run`): on a card one staged call, then a wait."""
        n, b = np.shape(block)
        if n != self.num_nodes:
            raise ValueError(f"block has {n} acceptor rows, spec has "
                             f"{self.num_nodes}")
        run = self.dense_run([(start_slot, b, vote_round)])
        at = int(run.offsets[0])
        run.block[:, at:at + b] = block
        result = run.dispatch()
        newly = result.wait()[at:at + b].copy()
        result.free()
        return newly

    def dense_run(self, spans) -> BoardRun:
        """A run of dense blocks for ONE K2 dispatch: ``spans`` is
        ``[(start_slot, width, vote_round)]``, each block within the ring
        (no straddle), applied in order. Returns a :class:`BoardRun`
        whose zeroed ``block`` the caller fills, block ``k`` at columns
        ``offsets[k]``, then dispatches it (:meth:`BoardRun.dispatch`):
        on a card one staged call and (where blocks overlap modulo the
        window, which only a window violation brings) more than one
        launch, with the held releases applied ahead of them."""
        return BoardRun(self, [("dense", spans)])

    def board_run(self, segments) -> BoardRun:
        """A drain's board updates for ONE dispatch, in order: each of
        ``segments`` is ``("dense", [(start_slot, width, vote_round)])``
        (a run of dense blocks, as :meth:`dense_run`'s spans) or
        ``("sparse", [(slots, node_cols, rounds, pad_to)])`` (a run of
        sparse chunks, each one :meth:`record_and_check_async` call of
        its votes, ``pad_to`` its padded width there). Returns a
        :class:`BoardRun` whose ``block`` the caller fills, then
        dispatches: on a card ONE staged call (a K2 launch per dense
        segment, a K4 launch per sparse one, the held releases ahead),
        whose result gives the dense ``newly`` and the chunks' per-lane
        ``newly`` (:class:`RunResult`)."""
        return BoardRun(self, segments)

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
        """Stateless drain-local quorum over a ``[n, B]`` vote block:
        the ``[B]`` hit mask. The block is padded to its bucket in the
        staging and checked by :meth:`check_staged` (one call)."""
        n, b = block.shape
        if n != self.num_nodes:
            raise ValueError(f"block has {n} acceptor rows, spec has "
                             f"{self.num_nodes}")
        self.stage_block(_bucket(b))[:, :b] = block
        return self.check_staged(_bucket(b))[:b].copy()

    def stage_block(self, width: int) -> np.ndarray:
        """A zeroed ``[n, width]`` uint8 host block for the next
        :meth:`check_staged`: on a CUDA device a view of this checker's
        reused pinned staging, on the CPU a numpy array. The caller
        writes its votes into it (several segments may lie side by
        side: K1 is column-local) and reads it until the next call."""
        if self.device.type != "cuda":
            self._host_block = np.zeros((self.num_nodes, width),
                                        dtype=np.uint8)
            return self._host_block
        if self._staging is None:
            self._staging = _build.Staging(self.device)
        n = self.num_nodes
        view = self._staging.pair("votes", n * width, torch.uint8).host
        view = view[:n * width].reshape(n, width)
        view.fill(0)
        return view

    def check_staged(self, width: int) -> np.ndarray:
        """K1 over the block of the last :meth:`stage_block` ``(width)``:
        the ``[width]`` bool hits. On a CUDA device ONE ``ctypes`` call
        (:func:`quorum_hit_staged`; its result is a view of pinned
        memory that the next call overwrites); on the CPU the plain
        version. Stateless: on a mesh it runs whole on every rank."""
        if self.device.type != "cuda":
            return quorum_hit_plain(torch.from_numpy(self._host_block),
                                    self._pred).numpy()
        return quorum_hit_staged(self._staging, width, self._pred)

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


def _reshape_board(board: VoteBoard, old_universe,
                   new_universe) -> VoteBoard:
    """The board with its acceptor rows gathered onto ``new_universe``
    by K7; the slot-axis state is kept. A sharded board's reshape is the
    same call on its local columns (the acceptor axis is whole on every
    rank), with no collective. The map crosses in K7's call itself."""
    return board._replace(votes=reshape_columns(
        board.votes, epoch_column_map(old_universe, new_universe)))


class EpochSegmentedChecker(_HeldReleases):
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
        self._board = make_vote_board(window, len(self.universe),
                                      self.device, mesh)
        self._held: list = []
        # record_and_check_run's pinned lanes (and held releases) and
        # newly, made at the first call on a CUDA device without a mesh.
        self._staged = self.device.type == "cuda" and mesh is None
        self._staging = None

    def _rebuild_universe(self) -> None:
        seen: dict = {}
        for spec in self._own_specs:
            for node in spec.universe:
                seen.setdefault(node, len(seen))
        self.universe = tuple(seen)
        specs = [s.reindexed(self.universe) for s in self._own_specs]
        self._padded = pad_specs(specs)
        self.planes = make_multi_predicate(*self._padded, device=self.device)
        self._multi = None
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
        uint8) checked under each row's slot's epoch (K6, one staged call:
        :class:`MultiCheck`, made at the first call after a change of the
        epochs)."""
        present = np.asarray(present, dtype=np.uint8)
        config_idx = self.config_indices(slots).astype(np.int32)
        if self._multi is None:
            self._multi = MultiCheck(*self._padded, device=self.device)
        return self._multi.check(present, config_idx)

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

    def record_and_check_run(self, slots, node_cols, rounds=None,
                             chunk: int = 256) -> np.ndarray:
        """A tracker drain's votes through K6 ``chunk`` at a time, in
        order: equal to :meth:`record_and_check` on each chunk in turn,
        the masks concatenated. On a CUDA device ONE ``ctypes`` call with
        the GIL released (the lanes written unpadded into reused pinned
        staging, the held releases after them, both sent up, K5's
        all-valid form on the releases, one launch of the run, ``newly``
        down, a wait, all on PyTorch's current stream, so that K7's
        reshapes queued before it land first); on the CPU the held
        releases, then the plain run. With a mesh, one sharded run: one
        launch on each rank's columns and one all-reduce a drain."""
        slots = np.asarray(slots, dtype=np.int64)
        b = slots.shape[0]
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if self.mesh is not None:
            lanes = _checker_lanes(slots, node_cols, rounds, self.window, b)
            return record_and_check_epochs_sharded(
                self.board, self.mesh, lanes, self._boundaries, self.planes,
                chunk=chunk).cpu().numpy()
        if not self._staged:
            lanes = _checker_lanes(slots, node_cols, rounds, self.window, b)
            return record_and_check_epochs_run(
                self.board, stage(lanes, self.device), self._boundaries,
                self.planes, chunk).numpy()
        if b == 0:
            return np.zeros(0, dtype=bool)
        st = self._stage()
        held = self._take_held()
        r = held.size
        lanes = st.pair("lanes", LANE_FIELDS * b + r, torch.int32)
        _checker_lanes(slots, node_cols, rounds, self.window, b,
                       out=lanes.host[:LANE_FIELDS * b].reshape(LANE_FIELDS,
                                                                b))
        if r:
            lanes.host[LANE_FIELDS * b:LANE_FIELDS * b + r] = held
        newly = st.pair("newly", b, torch.bool)
        fn = _K6_STAGED.fn or _K6_STAGED.resolve()
        rc = fn(_K6_STAGED.pack(*_epochs_block(
            self._board, lanes.device_ptr, b, chunk, self._boundaries,
            self.planes, newly.device_ptr), st.index,
            _build.stream_handle(st.index), lanes.host_ptr, newly.host_ptr,
            r))
        if rc:
            _K6_STAGED.check(rc)
        record_and_check_epochs.launches += 1
        if r:
            release.launches += 1
        return newly.host[:b].copy()


def newly_pairs(slots: np.ndarray, rounds: np.ndarray,
                newly: np.ndarray) -> list:
    """A tracker drain's reports from its per-vote ``newly`` mask: the
    ``(slot, round)`` of each newly-chosen vote, the first vote of each
    slot only, in vote order (the board reports every same-batch
    duplicate of a newly-chosen slot; exactly-once within the drain is
    host-side, across drains the chosen bitmap's)."""
    idx = np.flatnonzero(newly)
    if not idx.size:
        return []
    _, first = np.unique(slots[idx], return_index=True)
    keep = idx[np.sort(first)]
    return list(zip(slots[keep].tolist(), rounds[keep].tolist()))


class MultiConfigQuorumChecker:
    """Stateless batched checks where each row picks its own quorum
    system (the reference's ``MultiConfigQuorumChecker``), built from
    ``pad_specs``; ``device`` defaults to ``cuda``."""

    def __init__(self, specs: Sequence[QuorumSpec], device=None):
        self._init(pad_specs(specs), specs[0].universe, device)

    @classmethod
    def from_planes(cls, masks, thresholds, combine_any, universe,
                    device=None) -> "MultiConfigQuorumChecker":
        """A checker over given padded planes (``[K, G, N]`` masks, ``[K,
        G]`` thresholds, ``[K]`` any flags) on ``universe``."""
        checker = cls.__new__(cls)
        checker._init((masks, thresholds, combine_any), universe, device)
        return checker

    def _init(self, planes, universe, device) -> None:
        self.device = resolve_device(device)
        self.universe = tuple(universe)
        self.multi = MultiCheck(*planes, device=self.device)
        # Universe node -> its column, and its bit of a responder word.
        self._col = {node: i for i, node in enumerate(self.universe)}
        self._bit = {node: 1 << i for node, i in self._col.items()}

    @property
    def planes(self) -> MultiPredicate:
        return self.multi.planes

    def check_batch(self, present, config_idx) -> np.ndarray:
        """``[B, N]`` rows (integers or bools, taken as int32 as the
        reference's ``astype`` takes them) under ``config_idx[b]``: one
        staged call (:class:`MultiCheck`)."""
        return self.multi.check(present,
                                np.asarray(config_idx).astype(np.int32))

    def check_all(self, nodes) -> np.ndarray:
        """``[K]`` bool: does ``nodes`` (universe node ids; others are
        ignored) satisfy each configuration? The reference's
        ``check_batch`` of K equal 0/1 rows under ``arange(K)``: one
        word under every plane in one staged call where
        :attr:`MultiCheck.bits` holds, else that batch."""
        if self.multi.bits:
            bit, word = self._bit, 0
            for node in nodes:
                word |= bit.get(node, 0)
            return self.multi.check_word_all(word)
        col = self._col
        present = np.zeros((self.multi.k, self.multi.n), dtype=np.uint8)
        present[:, [col[node] for node in nodes if node in col]] = 1
        return self.check_batch(present,
                                np.arange(self.multi.k, dtype=np.int32))
