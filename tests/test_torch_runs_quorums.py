"""The port's Fast Flexible Paxos quorum specs (``runs/quorums.py``)
against the JAX package's.

Every case of ``tests/test_runs_quorums.py`` runs against the port, the
reference's ``"tpu"`` backend read as ``"cuda"`` on ``device="cpu"`` (K6's
plain version); then the port's ``SpecChecker("cuda", device="cpu")`` is
held bit-identical to the JAX ``SpecChecker("tpu")`` (JAX on the CPU) on
random 0/1 rows from a numpy seed, f = 1-3, through ``check`` (one row, a
packed word) and ``check_batch``, and the backends' refusals are pinned.
"""

import random

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.runs.quorums import (
    check_fast_flexible,
    fast_flexible_specs,
    SpecChecker,
)
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.runs import quorums as jrq

#: The reference's backends, as the port names them.
PORT_BACKEND = {"host": "host", "tpu": "cuda"}


def brute_threshold_oracle(present_row, threshold: int) -> bool:
    return int(np.sum(present_row)) >= threshold


def port_checker(spec, backend: str) -> SpecChecker:
    backend = PORT_BACKEND[backend]
    return SpecChecker(spec, backend,
                       device="cpu" if backend == "cuda" else None)


class TestFastFlexibleSpecs:
    @pytest.mark.parametrize("f", [1, 2, 3])
    def test_classic_and_fast_sizes(self, f):
        n = 2 * f + 1
        q1 = f + 1
        qf = f + ((f + 1) // 2 + 1)  # f + majority-of-quorum
        specs = fast_flexible_specs(n, q1, qf)
        assert specs.classic.universe == tuple(range(n))
        assert int(specs.classic.thresholds[0]) == q1
        assert int(specs.fast.thresholds[0]) == qf

    @pytest.mark.parametrize("f", [1, 2, 3])
    def test_recovery_threshold_is_fast_intersection(self, f):
        n = 2 * f + 1
        q1 = f + 1
        majority_of_quorum = (f + 1) // 2 + 1
        qf = f + majority_of_quorum
        specs = fast_flexible_specs(n, q1, qf)
        assert int(specs.recovery.thresholds[0]) == q1 + qf - n
        assert int(specs.recovery.thresholds[0]) == majority_of_quorum

    def test_recovery_weakens_with_the_live_config(self):
        n, q1 = 3, 2
        weak = fast_flexible_specs(n, q1, q1)  # qf = q1: invalid
        assert int(weak.recovery.thresholds[0]) == max(1, 2 * q1 - n)
        assert weak.recovery.check([0])
        assert weak.recovery.check([1])

    def test_universe_override_and_mismatch(self):
        specs = fast_flexible_specs(3, 2, 3, universe=(7, 8, 9))
        assert specs.classic.universe == (7, 8, 9)
        assert specs.classic.check([7, 9])
        assert not specs.classic.check([7])
        with pytest.raises(ValueError):
            fast_flexible_specs(3, 2, 3, universe=(7, 8))

    @pytest.mark.parametrize("args", [(3, 2, 3), (5, 3, 4), (7, 4, 6),
                                      (3, 2, 2), (5, 5, 3),
                                      (4, 3, 3, (10, 11, 12, 13))])
    def test_specs_equal_the_references(self, args):
        port = fast_flexible_specs(*args)
        ref = jrq.fast_flexible_specs(*args)
        for name in ("classic", "fast", "recovery"):
            p, r = getattr(port, name), getattr(ref, name)
            np.testing.assert_array_equal(p.masks, r.masks)
            np.testing.assert_array_equal(p.thresholds, r.thresholds)
            assert p.combine == r.combine and p.universe == r.universe


class TestCheckFastFlexible:
    @pytest.mark.parametrize("f", [1, 2, 3, 5])
    def test_reference_sizes_are_valid(self, f):
        n = 2 * f + 1
        q1 = f + 1
        qf = f + ((f + 1) // 2 + 1)
        assert check_fast_flexible(n, q1, qf) == []

    def test_weak_fast_quorum_flagged(self):
        violations = check_fast_flexible(3, 2, 2)
        assert len(violations) == 1
        assert "fast intersection" in violations[0]

    def test_weak_classic_quorum_flagged(self):
        violations = check_fast_flexible(5, 2, 5, classic_quorum_size2=2)
        assert any("classic intersection" in v for v in violations)

    def test_relaxed_flexible_sizes(self):
        assert check_fast_flexible(5, 5, 3, classic_quorum_size2=1) == []
        assert check_fast_flexible(5, 3, 3) != []

    @pytest.mark.parametrize("args", [(3, 2, 2), (5, 2, 5, 2), (5, 5, 3, 1),
                                      (5, 3, 3), (9, 5, 7)])
    def test_violations_equal_the_references(self, args):
        assert check_fast_flexible(*args) == jrq.check_fast_flexible(*args)


class TestSpecChecker:
    def test_backend_validation(self):
        """The reference refuses "gpu"; the port refuses the reference's
        "tpu" and "gpu" alike, and every other name."""
        spec = fast_flexible_specs(3, 2, 3).classic
        for name in ("gpu", "tpu", "dict", ""):
            with pytest.raises(ValueError):
                SpecChecker(spec, name)

    def test_cuda_without_a_device_named(self):
        """``"cuda"`` with no device runs on the card, and raises where
        there is none (no quiet fall-back to the plain version)."""
        spec = fast_flexible_specs(3, 2, 3).classic
        if torch.cuda.is_available():
            assert SpecChecker(spec, "cuda").check([0, 1])
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                SpecChecker(spec, "cuda")

    @pytest.mark.parametrize("backend", ["host", "tpu"])
    def test_check_matches_threshold_oracle(self, backend):
        specs = fast_flexible_specs(5, 3, 4)
        for spec, threshold in ((specs.classic, 3), (specs.fast, 4),
                                (specs.recovery, 2)):
            checker = port_checker(spec, backend)
            rng = random.Random(7)
            for _ in range(40):
                nodes = [i for i in range(5) if rng.random() < 0.5]
                expected = len(nodes) >= threshold
                assert checker.check(nodes) == expected, (
                    backend, threshold, nodes)

    def test_tpu_batch_bit_identical_to_host(self):
        rng = np.random.default_rng(13)
        for f in (1, 2, 3):
            n = 2 * f + 1
            q1 = f + 1
            qf = f + ((f + 1) // 2 + 1)
            specs = fast_flexible_specs(n, q1, qf)
            for spec in (specs.classic, specs.fast, specs.recovery):
                host = port_checker(spec, "host")
                tpu = port_checker(spec, "tpu")
                present = (rng.random((64, n)) < 0.5).astype(np.uint8)
                host_out = np.asarray(host.check_batch(present), bool)
                tpu_out = np.asarray(tpu.check_batch(present), bool)
                assert np.array_equal(host_out, tpu_out), (f, spec)

    @pytest.mark.parametrize("backend", ["host", "tpu"])
    def test_check_accepts_dict_keys(self, backend):
        spec = fast_flexible_specs(3, 2, 3).classic
        checker = port_checker(spec, backend)
        assert checker.check({2: "x", 0: "y"})
        assert not checker.check({1: "x"})

    @pytest.mark.parametrize("f", [1, 2, 3])
    def test_cuda_bit_identical_to_the_references_tpu(self, f):
        """The port's ``SpecChecker("cuda", device="cpu")`` against the
        JAX ``SpecChecker("tpu")`` on random 0/1 rows from a numpy seed:
        ``check_batch``, and ``check`` row by row (the port's packed
        word), over a universe that is not ``0..n-1`` too."""
        rng = np.random.default_rng(100 + f)
        n = 2 * f + 1
        q1, qf = f + 1, f + ((f + 1) // 2 + 1)
        for universe in (None, tuple(range(10, 10 + 3 * n, 3))):
            jspecs = jrq.fast_flexible_specs(n, q1, qf, universe=universe)
            for name in ("classic", "fast", "recovery"):
                ref = jrq.SpecChecker(getattr(jspecs, name), "tpu")
                port = convert.spec_checker_from(ref, "cuda", device="cpu")
                present = (rng.random((48, n)) < 0.5).astype(np.uint8)
                want = np.asarray(ref.check_batch(present), bool)
                np.testing.assert_array_equal(port.check_batch(present),
                                              want)
                ids = port.spec.universe
                for row, hit in zip(present, want):
                    nodes = [ids[i] for i in np.flatnonzero(row)]
                    assert port.check(nodes) == bool(hit)
                    assert ref.check(nodes) == bool(hit)

    def test_nodes_outside_the_universe_and_repeats(self):
        """``check`` ignores nodes outside the universe and counts a
        repeated node once, as ``present_vector`` does."""
        spec = fast_flexible_specs(3, 2, 3, universe=(4, 5, 6)).classic
        ref = jrq.SpecChecker(spec.__class__(
            masks=spec.masks, thresholds=spec.thresholds,
            combine=spec.combine, universe=spec.universe), "host")
        for backend in ("host", "tpu"):
            port = port_checker(spec, backend)
            for nodes in ([4, 4], [4, 9, 99], [4, 5], [6, 6, 6, 7], []):
                assert port.check(nodes) == ref.check(nodes), nodes

    def test_metrics_hook_and_check_count(self):
        """The duck-typed metrics hook sees one row a ``check`` and ``B``
        a ``check_batch``; ``checks`` counts the same."""

        class Sink:
            def __init__(self):
                self.rows = []

            def fastquorum_check(self, rows):
                self.rows.append(rows)

        sink = Sink()
        spec = fast_flexible_specs(3, 2, 3).fast
        for backend in ("host", "tpu"):
            checker = SpecChecker(spec, PORT_BACKEND[backend],
                                  metrics=lambda: sink,
                                  device="cpu" if backend == "tpu" else None)
            checker.check([0, 1, 2])
            checker.check_batch(np.ones((5, 3), np.uint8))
            assert checker.checks == 6
        assert sink.rows == [1, 5, 1, 5]
        # A hook that returns None is skipped.
        quiet = SpecChecker(spec, metrics=lambda: None)
        assert quiet.check([0, 1, 2]) and quiet.checks == 1
