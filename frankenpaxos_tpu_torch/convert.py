"""Carry state across from the JAX package, and back.

The pipeline and the vote board hold no weights; their state is what a
run carries. A JAX ``PipelineState`` or ``VoteBoard`` fetched to the host
(``jax.device_get``) is a named tuple of numpy arrays; these functions
move such a tuple (or a dict of the same fields) into the port's tensors
on a device and back, with every dtype kept: ``votes`` uint8, ``chosen``
bool, everything else int32. A dtype or a field that does not match
raises rather than being converted. An ``EpochSegmentedChecker`` is
carried as its epochs' specs and boundaries plus its board, so a test
can start the JAX checker and the port's from one mid-flight state.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.bench.pipeline import PipelineState
from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.ops.quorum import (
    EpochSegmentedChecker,
    VoteBoard,
)
from frankenpaxos_tpu_torch.quorums.spec import QuorumSpec
import numpy as np
import torch

_DTYPES = {"votes": np.uint8, "chosen": np.bool_}


def _fields(arrays) -> dict:
    return dict(arrays._asdict()) if hasattr(arrays, "_asdict") \
        else dict(arrays)


def _from_numpy(cls, arrays, device):
    device = resolve_device(device)
    fields = _fields(arrays)
    if fields.pop("telemetry", None) is not None:
        raise ValueError("the telemetry plane is not ported; carry state "
                         "from a telemetry-off run")
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
    return cls(**out)


def _to_numpy(state) -> dict:
    return {name: value.detach().cpu().numpy()
            for name, value in _fields(state).items() if value is not None}


def pipeline_state_from_numpy(arrays, device=None) -> PipelineState:
    """A port ``PipelineState`` on ``device`` (``cuda`` when None) from a
    named tuple or dict of numpy arrays."""
    return _from_numpy(PipelineState, arrays, device)


def pipeline_state_to_numpy(state: PipelineState) -> PipelineState:
    """The state as a ``PipelineState`` of numpy arrays on the host."""
    return PipelineState(**_to_numpy(state))


def vote_board_from_numpy(arrays, device=None) -> VoteBoard:
    """A port ``VoteBoard`` on ``device`` (``cuda`` when None) from a
    named tuple or dict of numpy arrays."""
    return _from_numpy(VoteBoard, arrays, device)


def vote_board_to_numpy(board: VoteBoard) -> VoteBoard:
    """The board as a ``VoteBoard`` of numpy arrays on the host."""
    return VoteBoard(**_to_numpy(board))


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
