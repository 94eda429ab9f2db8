"""Carry state across from the JAX package, and back.

The pipeline and the vote board hold no weights; their state is what a
run carries. A JAX ``PipelineState`` or ``VoteBoard`` fetched to the host
(``jax.device_get``) is a named tuple of numpy arrays; these functions
move such a tuple (or a dict of the same fields) into the port's tensors
on a device and back, with every dtype kept: ``votes`` uint8, ``chosen``
bool, everything else int32. A pipeline's telemetry counters cross as a
``TelemetryState`` both ways (into the port's one flat buffer). A dtype
or a field that does not match raises rather than being converted. An
``EpochSegmentedChecker`` is carried as its epochs' specs and boundaries
plus its board, so a test can start the JAX checker and the port's from
one mid-flight state. A sharded pipeline state crosses as its gathered
(physical) layout, each rank taking its shard; a vote board sharded over
a mesh crosses as the whole board, each rank taking its columns, and is
gathered back to the whole board on every rank. A JAX ``DepSetBatch``
crosses as its three numpy
arrays, and a GC role's ``QuorumWatermarkVector`` as its
``[replicas, leaders]`` int64 matrix. A WPaxos leader's
``ObjectEpochStore`` crosses as its epoch chains, and a
``GeoQuorumTracker`` as its store, its board (through the
``EpochSegmentedChecker`` conversion, the planes rebuilt from the
chain) and its buffered votes.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.bench.pipeline import (
    gather_state,
    gathered_layout,
    local_block,
    padded_window,
    PIPELINE_PARTITION,
    PipelineState,
    shard_leaf,
)
from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.geo.epochs import GeoEpoch, ObjectEpochStore
from frankenpaxos_tpu_torch.geo.quorum import GeoQuorumTracker
from frankenpaxos_tpu_torch.ops.depset import DepSetBatch
from frankenpaxos_tpu_torch.ops.quorum import (
    EpochSegmentedChecker,
    shard_board,
    VoteBoard,
)
from frankenpaxos_tpu_torch.ops.telemetry import (
    FIELDS as TELEMETRY_FIELDS,
    make_telemetry,
    TelemetryState,
)
from frankenpaxos_tpu_torch.quorums.spec import QuorumSpec
from frankenpaxos_tpu_torch.utils.watermark import QuorumWatermarkVector
import numpy as np
import torch
import torch.distributed as dist

_DTYPES = {"votes": np.uint8, "chosen": np.bool_}


def _fields(arrays) -> dict:
    return dict(arrays._asdict()) if hasattr(arrays, "_asdict") \
        else dict(arrays)


def _telemetry_from_numpy(arrays, device) -> TelemetryState:
    fields = {name: np.asarray(value) for name, value in
              _fields(arrays).items() if name != "buffer"}
    if set(fields) != set(TELEMETRY_FIELDS):
        raise ValueError(f"telemetry fields {sorted(fields)} do not match "
                         f"TelemetryState")
    for name, value in fields.items():
        if value.dtype != np.int32:
            raise ValueError(f"telemetry {name} is {value.dtype}, "
                             f"expected int32")
    tel = make_telemetry(fields["occupancy"].shape[0] - 1,
                         fields["shard_committed"].shape[0], device=device)
    for name in TELEMETRY_FIELDS:
        view = getattr(tel, name)
        if fields[name].shape != tuple(view.shape):
            raise ValueError(f"telemetry {name} is {fields[name].shape}, "
                             f"expected {tuple(view.shape)}")
        view.copy_(torch.from_numpy(np.array(fields[name], copy=True)))
    return tel


def _from_numpy(cls, arrays, device):
    device = resolve_device(device)
    fields = _fields(arrays)
    telemetry = fields.pop("telemetry", None)
    if set(fields) != set(cls._fields) - {"telemetry"}:
        raise ValueError(f"fields {sorted(fields)} do not match "
                         f"{cls.__name__}")
    out = {}
    for name, value in fields.items():
        value = np.asarray(value)
        want = np.dtype(_DTYPES.get(name, np.int32))
        if value.dtype != want:
            raise ValueError(f"{name} is {value.dtype}, expected {want}")
        out[name] = torch.from_numpy(np.array(value, copy=True)).to(device)
    if telemetry is not None:
        out["telemetry"] = _telemetry_from_numpy(telemetry, device)
    return cls(**out)


def _to_numpy(state) -> dict:
    out = {}
    for name, value in _fields(state).items():
        if isinstance(value, TelemetryState):
            out[name] = TelemetryState(*(
                t.detach().cpu().numpy() for t in value[:len(
                    TELEMETRY_FIELDS)]))
        elif value is not None:
            out[name] = value.detach().cpu().numpy()
    return out


def pipeline_state_from_numpy(arrays, device=None) -> PipelineState:
    """A port ``PipelineState`` on ``device`` (``cuda`` when None) from a
    named tuple or dict of numpy arrays; its ``telemetry``, when not
    None, is a named tuple or dict of the six int32 counters."""
    return _from_numpy(PipelineState, arrays, device)


def pipeline_state_to_numpy(state: PipelineState) -> PipelineState:
    """The state as a ``PipelineState`` of numpy arrays on the host (its
    telemetry, when on, a ``TelemetryState`` of the six counters)."""
    return PipelineState(**_to_numpy(state))


def sharded_state_from_numpy(mesh, arrays, window: int,
                             block_size: int, device=None) -> PipelineState:
    """This rank's shard, on ``device`` (the mesh's when None), of a
    GATHERED sharded state: what ``jax.device_get`` gives for the
    reference's state under ``make_sharded_step`` (or what
    ``bench.pipeline.gather_state`` gives here) -- votes ``[n,
    w_padded]`` and the slot columns ``[w_padded]`` in the physical
    layout, the scalars and the telemetry counters (``shard_committed``
    over every slot shard) whole. Pad columns, which
    ``gathered_layout`` marks, must hold no votes and no commands."""
    fields = _fields(arrays)
    g_sh, s_sh = mesh.group_shards, mesh.slot_shards
    w_padded = padded_window(window, block_size, s_sh)
    votes = np.asarray(fields["votes"])
    n = votes.shape[0]
    if votes.shape != (n, w_padded) or n % g_sh:
        raise ValueError(f"votes {votes.shape} are not a gathered [n, "
                         f"{w_padded}] board over {g_sh} group shards")
    b_local, _ = local_block(block_size, s_sh)
    _, valid = gathered_layout(s_sh, w_padded // s_sh, b_local, block_size)
    if votes[:, ~valid].any() or np.asarray(fields["commands"])[~valid].any():
        raise ValueError("pad columns of the gathered state hold votes or "
                         "commands")
    local = dict(fields)
    for name, axes in zip(PipelineState._fields[:7], PIPELINE_PARTITION):
        local[name] = shard_leaf(np.asarray(fields[name]), axes, mesh)
    return _from_numpy(PipelineState, local,
                       mesh.device if device is None else device)


def sharded_state_to_numpy(mesh, state: PipelineState) -> PipelineState:
    """The gathered sharded state as numpy arrays (collective over the
    mesh), the inverse of :func:`sharded_state_from_numpy`: the
    conversion's name for ``bench.pipeline.gather_state``, which it
    calls, so that each direction has its name here as in the
    reference's tests."""
    return gather_state(mesh, state)


def vote_board_from_numpy(arrays, device=None) -> VoteBoard:
    """A port ``VoteBoard`` on ``device`` (``cuda`` when None) from a
    named tuple or dict of numpy arrays."""
    return _from_numpy(VoteBoard, arrays, device)


def vote_board_to_numpy(board: VoteBoard) -> VoteBoard:
    """The board as a ``VoteBoard`` of numpy arrays on the host."""
    return VoteBoard(**_to_numpy(board))


def sharded_vote_board_from_numpy(mesh, arrays, window: int) -> VoteBoard:
    """This rank's shard of a whole ``window``-column board given as numpy
    arrays (a named tuple or dict, e.g. a JAX board fetched with
    ``jax.device_get``, sharded or not): the columns ``shard_board``
    gives this rank, on the mesh's device."""
    return shard_board(vote_board_from_numpy(arrays, device="cpu"), mesh,
                       window)


def gather_vote_board(mesh, board: VoteBoard) -> VoteBoard:
    """The whole sharded board as a ``VoteBoard`` of numpy arrays on
    every rank of ``mesh`` (collective): each rank's columns gathered in
    rank order, the column map of ``shard_board``. Goes through the host
    (``all_gather_object``), since gloo gathers only CPU tensors."""
    local = vote_board_to_numpy(board)
    if mesh.size == 1:
        return local
    pieces = [None] * mesh.size
    dist.all_gather_object(pieces, local, group=mesh.mesh_pg)
    return VoteBoard(np.concatenate([p.votes for p in pieces], axis=1),
                     *(np.concatenate([p[k] for p in pieces])
                       for k in range(1, 4)))


def quorum_spec_from(spec) -> QuorumSpec:
    """The port's ``QuorumSpec`` with the fields of ``spec`` (``masks``,
    ``thresholds``, ``combine``, ``universe``), e.g. one of the JAX
    package's specs."""
    return QuorumSpec(masks=np.asarray(spec.masks, dtype=np.uint8),
                      thresholds=np.asarray(spec.thresholds, dtype=np.int32),
                      combine=str(spec.combine),
                      universe=tuple(spec.universe))


def epoch_checker_from_numpy(specs, boundaries, window: int, board,
                             device=None) -> EpochSegmentedChecker:
    """A port ``EpochSegmentedChecker`` in a mid-flight state: the epochs
    ``specs`` (each in its own universe, in epoch order) starting at
    ``boundaries``, with the vote ``board`` (a named tuple or dict of
    numpy arrays over their union universe) carried in."""
    checker = EpochSegmentedChecker([quorum_spec_from(s) for s in specs],
                                    boundaries, window=window, device=device)
    carried = vote_board_from_numpy(board, checker.device)
    if carried.votes.shape != checker.board.votes.shape:
        raise ValueError(f"board votes {tuple(carried.votes.shape)} do not "
                         f"match the epochs' union universe and window "
                         f"{tuple(checker.board.votes.shape)}")
    checker.board = carried
    return checker


def epoch_planes_to_numpy(checker: EpochSegmentedChecker) -> dict:
    """The checker's padded planes and int32 boundaries on the host:
    ``masks [K, G, N]``, ``thresholds [K, G]``, ``combine_any [K]``,
    ``boundaries [K-1]``."""
    planes = {name: value.cpu().numpy()
              for name, value in checker.planes._asdict().items()}
    planes["boundaries"] = checker._boundaries.cpu().numpy()
    return planes


def depset_from_jax(watermarks, tails, tail_base, device=None) -> DepSetBatch:
    """A port ``DepSetBatch`` on ``device`` (``cuda`` when None) from a
    JAX batch's arrays fetched to the host: ``[B, L]`` int32 watermarks,
    ``[B, L, W]`` uint8 tails and the int32 tail base. A dtype or shape
    that does not match raises rather than being converted."""
    device = resolve_device(device)
    watermarks, tails = np.asarray(watermarks), np.asarray(tails)
    base = np.asarray(tail_base)
    for name, value, dtype, ndim in (("watermarks", watermarks, np.int32, 2),
                                     ("tails", tails, np.uint8, 3),
                                     ("tail_base", base, np.int32, 0)):
        if value.dtype != dtype or value.ndim != ndim:
            raise ValueError(f"{name} is {value.dtype} {value.shape}, "
                             f"expected {np.dtype(dtype)} with {ndim} dims")
    if tails.shape[:2] != watermarks.shape:
        raise ValueError(f"tails {tails.shape} do not match watermarks "
                         f"{watermarks.shape}")
    return DepSetBatch(*(torch.from_numpy(np.array(v, copy=True)).to(device)
                         for v in (watermarks, tails, base)))


def depset_to_numpy(batch: DepSetBatch) -> DepSetBatch:
    """The batch as a ``DepSetBatch`` of numpy arrays on the host."""
    return DepSetBatch(*(v.detach().cpu().numpy() for v in batch))


def watermark_vector_from_numpy(watermarks) -> QuorumWatermarkVector:
    """A port ``QuorumWatermarkVector`` holding ``watermarks``, the
    ``[replicas, leaders]`` int64 matrix of a JAX role's vector (its
    ``_watermarks``), so that a GC role can continue from a mid-run
    state. A dtype or shape that does not match raises."""
    watermarks = np.asarray(watermarks)
    if watermarks.dtype != np.int64 or watermarks.ndim != 2:
        raise ValueError(f"watermarks are {watermarks.dtype} "
                         f"{watermarks.shape}, expected a [replicas, "
                         f"leaders] int64 matrix")
    vector = QuorumWatermarkVector(*watermarks.shape)
    vector._watermarks[...] = watermarks
    return vector


def watermark_vector_to_numpy(vector: QuorumWatermarkVector) -> np.ndarray:
    """The vector's ``[replicas, leaders]`` int64 matrix, a copy."""
    return vector._watermarks.copy()


def epoch_store_from_chains(chains, version: int = 0) -> ObjectEpochStore:
    """A port ``ObjectEpochStore`` holding ``chains``: per object group,
    its epoch entries in order (objects with ``group``, ``epoch``,
    ``start_slot``, ``home_zone`` and ``ballot`` fields, e.g. a JAX
    store's ``known(g)`` for each group), and the store's ``version``.
    A chain that is empty, names another group or skips an epoch
    raises."""
    chains = [list(chain) for chain in chains]
    if any(not chain for chain in chains):
        raise ValueError("every group needs at least its epoch 0")
    store = ObjectEpochStore(len(chains),
                             [chain[0].home_zone for chain in chains])
    for group, chain in enumerate(chains):
        entries = [GeoEpoch(group=int(e.group), epoch=int(e.epoch),
                            start_slot=int(e.start_slot),
                            home_zone=int(e.home_zone),
                            ballot=int(e.ballot)) for e in chain]
        if any(e.group != group for e in entries) or [
                e.epoch for e in entries] != list(
                range(entries[0].epoch, entries[0].epoch + len(entries))):
            raise ValueError(f"group {group}'s chain is not one group's "
                             f"contiguous epochs: {entries}")
        store._chains[group] = entries
    store.version = int(version)
    return store


def geo_tracker_from_numpy(store: ObjectEpochStore, group: int, grid,
                           board, window: int, pending=None,
                           device=None) -> GeoQuorumTracker:
    """A ``"cuda"`` ``GeoQuorumTracker`` of ``group`` over ``store`` in a
    mid-flight state: its checker's planes built from the store's chain,
    its vote ``board`` (a named tuple or dict of numpy arrays, e.g. a
    JAX tracker's ``jax.device_get(tracker._checker.board)``) carried in,
    and ``pending`` -- the votes buffered since the last drain, as
    ``(slots, acceptors, ballots)`` -- restored."""
    tracker = GeoQuorumTracker(store, group, grid, backend="cuda",
                               window=window, device=device)
    specs, starts = tracker._specs_and_starts()
    tracker._checker = epoch_checker_from_numpy(specs, starts, window,
                                                board, tracker.device)
    if pending is not None:
        slots, cols, ballots = (list(map(int, v)) for v in pending)
        if not len(slots) == len(cols) == len(ballots):
            raise ValueError("pending votes need one slot, acceptor and "
                             "ballot each")
        tracker._slots, tracker._cols, tracker._ballots = \
            slots, cols, ballots
    return tracker
