"""Fast Flexible Paxos quorum specs for the run layer (the port's copy of
``frankenpaxos_tpu/runs/quorums.py``).

Fast Paxos variants need three quorum predicates per configuration
(Fast Flexible Paxos / "Flexible Paxos + fast rounds"):

  * ``classic``: the phase-1 read / classic phase-2 write quorum (q1);
  * ``fast``: the fast-path choose quorum (qf);
  * ``recovery``: after phase 1, value v MAY have been fast-chosen iff
    a fast quorum voted v -- and every fast quorum intersects the
    leader's classic quorum in >= q1 + qf - n nodes, so v must be
    adopted exactly when it has that many votes among the phase-1
    replies.

All three are plain majority-style predicates in the matrix form of
``quorums/spec.py``, evaluated by the host oracle or by K6's stateless
check on the card (``ops/quorum.py::MultiCheck``, one staged call a
check).

The spec builders derive the recovery threshold from the LIVE classic
and fast sizes rather than re-deriving it from ``f``: a configuration
with a weakened fast quorum yields a correspondingly weakened (unsafe)
recovery rule, which is exactly what safety sims must be able to
catch. The intersection-condition validators below are therefore
deliberately NOT called on any protocol path; they exist for tests and
deployment-time config vetting.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from frankenpaxos_tpu_torch.device import resolve_device
from frankenpaxos_tpu_torch.quorums.spec import ANY, QuorumSpec

#: ``SpecChecker``'s backends: the numpy oracle and K6 on a device.
BACKENDS = ("host", "cuda")


def _majority_spec(universe: tuple[int, ...], threshold: int) -> QuorumSpec:
    n = len(universe)
    return QuorumSpec(masks=np.ones((1, n), dtype=np.uint8),
                      thresholds=np.asarray([threshold], dtype=np.int32),
                      combine=ANY, universe=universe)


@dataclasses.dataclass(frozen=True)
class FastFlexibleSpecs:
    """The three predicates of one fast-capable configuration."""

    classic: QuorumSpec
    fast: QuorumSpec
    recovery: QuorumSpec


def fast_flexible_specs(n: int, classic_quorum_size: int,
                        fast_quorum_size: int,
                        universe: Optional[Sequence[int]] = None
                        ) -> FastFlexibleSpecs:
    """Specs for an ``n``-acceptor configuration with the given quorum
    sizes. ``universe`` defaults to acceptor indices ``0..n-1``.

    The recovery threshold is ``max(1, q1 + qf - n)`` -- the guaranteed
    intersection of a fast quorum with the leader's classic quorum,
    computed from the sizes actually configured (see module docstring
    for why it is not re-derived from f).
    """
    ids = tuple(range(n)) if universe is None else tuple(universe)
    if len(ids) != n:
        raise ValueError(f"universe has {len(ids)} nodes, expected {n}")
    return FastFlexibleSpecs(
        classic=_majority_spec(ids, classic_quorum_size),
        fast=_majority_spec(ids, fast_quorum_size),
        recovery=_majority_spec(
            ids, max(1, classic_quorum_size + fast_quorum_size - n)))


def check_fast_flexible(n: int, classic_quorum_size: int,
                        fast_quorum_size: int,
                        classic_quorum_size2: Optional[int] = None
                        ) -> list[str]:
    """Violations of the Fast Flexible Paxos intersection conditions.

    With phase-1 quorums of size q1 and phase-2 classic quorums of size
    q2 (= q1 for the symmetric protocols here), safety needs

      * q1 + q2 > n        (classic rounds: read sees every write), and
      * q1 + 2*qf > 2*n    (two fast quorums + a read quorum share a
                            node, so at most one value can be popular).

    Returns human-readable violation strings (empty = valid). NOT
    called by the protocols -- see the module docstring.
    """
    q1, qf = classic_quorum_size, fast_quorum_size
    q2 = q1 if classic_quorum_size2 is None else classic_quorum_size2
    violations = []
    if q1 + q2 <= n:
        violations.append(
            f"classic intersection: q1 + q2 = {q1 + q2} <= n = {n}")
    if q1 + 2 * qf <= 2 * n:
        violations.append(
            f"fast intersection: q1 + 2*qf = {q1 + 2 * qf} <= 2n = {2 * n}")
    return violations


class SpecChecker:
    """Evaluate one QuorumSpec, on the host or on a device.

    ``backend="host"`` runs the NumPy oracle (``QuorumSpec.evaluate``);
    ``backend="cuda"`` runs K6's stateless check through the port's
    ``MultiConfigQuorumChecker`` over the single config, made at
    construction on ``device`` (the card when None, which raises where
    there is none; ``"cpu"`` runs the plain version). A :meth:`check`
    writes its row into the checker's pinned block as one 32-bit word,
    with no array made per call. Both backends are bit-identical; the
    sims default to host. ``checks`` counts the rows checked.
    """

    def __init__(self, spec: QuorumSpec, backend: str = "host",
                 metrics=None, device=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown quorum backend {backend!r}")
        self.spec = spec
        self.backend = backend
        # Zero-arg callable -> the owning role's metrics sink (or None),
        # resolved per check; a sink is any object with a
        # ``fastquorum_check(rows)`` method.
        self.metrics = metrics
        self.checks = 0
        self._device = None
        self._bits = None
        if backend == "cuda":
            from frankenpaxos_tpu_torch.ops.quorum import (
                MultiConfigQuorumChecker,
            )

            self._device = MultiConfigQuorumChecker(
                [spec], device=resolve_device(device))
            if self._device.multi.bits:
                # Universe node -> its bit of a row's word.
                self._bits = {node: 1 << i
                              for i, node in enumerate(spec.universe)}

    def _count(self, rows: int) -> None:
        self.checks += rows
        if self.metrics is not None:
            metrics = self.metrics()
            if metrics is not None:
                metrics.fastquorum_check(rows)

    def check_batch(self, present: np.ndarray) -> np.ndarray:
        """``[B, N]`` responder rows -> ``[B]`` bool."""
        present = np.asarray(present, dtype=np.uint8)
        self._count(present.shape[0])
        if self._device is not None:
            return self._device.check_batch(
                present, np.zeros(present.shape[0], dtype=np.int32))
        return np.asarray(self.spec.evaluate(present))

    def check(self, nodes: Iterable[int]) -> bool:
        bits = self._bits
        if bits is None:
            present = self.spec.present_vector(list(nodes))
            return bool(self.check_batch(present[None, :])[0])
        self._count(1)
        word = 0
        for node in nodes:
            word |= bits.get(node, 0)
        return self._device.multi.check_word(word)
