"""The port's quorum predicate and dense vote board vs the JAX reference.

Every output is an integer or a bool, so parity is bit-identity
(tolerance 0). The port runs its plain PyTorch versions here
(``device="cpu"``); the CUDA kernels are held against those same plain
versions on the GPU by ``chip_smoke.py``.
"""

import itertools
import warnings

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.quorums import (
    Grid,
    quorum_system_from_dict,
    quorum_system_to_dict,
    SimpleMajority,
    UnanimousWrites,
    ZoneGrid,
)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import quorum as jq
from frankenpaxos_tpu.quorums import (
    Grid as JGrid,
    SimpleMajority as JSimpleMajority,
    UnanimousWrites as JUnanimousWrites,
    ZoneGrid as JZoneGrid,
)

# (name, port quorum system, reference quorum system, "write"/"read")
SPECS = [
    ("majority3", SimpleMajority(range(3)), JSimpleMajority(range(3)),
     "write"),
    ("majority5", SimpleMajority(range(5)), JSimpleMajority(range(5)),
     "write"),
    ("grid2x3_write", Grid([[0, 1, 2], [3, 4, 5]]),
     JGrid([[0, 1, 2], [3, 4, 5]]), "write"),
    ("grid_perm_write", Grid([[0, 2, 4], [1, 3, 5]]),
     JGrid([[0, 2, 4], [1, 3, 5]]), "write"),
    ("grid2x3_read", Grid([[0, 1, 2], [3, 4, 5]]),
     JGrid([[0, 1, 2], [3, 4, 5]]), "read"),
    ("grid3x3_write", Grid([[0, 1, 2], [3, 4, 5], [6, 7, 8]]),
     JGrid([[0, 1, 2], [3, 4, 5], [6, 7, 8]]), "write"),
    ("unanimous_write", UnanimousWrites(range(3)),
     JUnanimousWrites(range(3)), "write"),
    ("unanimous_read", UnanimousWrites(range(4)),
     JUnanimousWrites(range(4)), "read"),
    ("zonegrid_write", ZoneGrid([[0, 1, 2], [3, 4, 5]]),
     JZoneGrid([[0, 1, 2], [3, 4, 5]]), "write"),
    ("zonegrid_read", ZoneGrid([[0, 1, 2], [3, 4, 5]]),
     JZoneGrid([[0, 1, 2], [3, 4, 5]]), "read"),
]
SPEC_IDS = [s[0] for s in SPECS]
WIDTHS = [1, 63, 64, 200, 4096]


def _specs(case):
    _, port_qs, ref_qs, kind = case
    if kind == "write":
        return port_qs.write_spec(), ref_qs.write_spec()
    return port_qs.read_spec(), ref_qs.read_spec()


def _blocks(rng, n, b):
    """A random 0/1 block and a block of arbitrary uint8 bytes."""
    return [(rng.random((n, b)) < 0.6).astype(np.uint8),
            rng.integers(0, 256, size=(n, b), dtype=np.uint8)]


@pytest.mark.parametrize("case", SPECS, ids=SPEC_IDS)
def test_spec_copy_and_statics_match_reference(case):
    spec, ref = _specs(case)
    np.testing.assert_array_equal(spec.masks, ref.masks)
    np.testing.assert_array_equal(spec.thresholds, ref.thresholds)
    assert (spec.combine, spec.universe) == (ref.combine, ref.universe)
    assert spec.masks.dtype == ref.masks.dtype
    assert tq.spec_statics(spec) == jq._spec_statics(ref)
    assert quorum_system_to_dict(case[1]) == \
        quorum_system_to_dict(quorum_system_from_dict(
            quorum_system_to_dict(case[1])))
    every = np.asarray(list(itertools.product([0, 1],
                                              repeat=spec.num_nodes)),
                       dtype=np.uint8)
    np.testing.assert_array_equal(spec.evaluate(every), ref.evaluate(every))


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("case", SPECS, ids=SPEC_IDS)
def test_check_block_and_batch_match_reference(case, b):
    spec, ref = _specs(case)
    rng = np.random.default_rng(b * 31 + SPEC_IDS.index(case[0]))
    masks_t, meta = jq._spec_statics(ref)
    pred = tq.make_predicate(spec.masks, spec.thresholds,
                             spec.combine == "any", device="cpu")
    checker = tq.TpuQuorumChecker(spec, window=1 << 13, device="cpu")
    for block in _blocks(rng, spec.num_nodes, b):
        want = np.asarray(jq._check_block(jnp.asarray(block), masks_t,
                                          meta))
        got = tq.quorum_hit(torch.from_numpy(block), pred).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.bool_
        np.testing.assert_array_equal(checker.check_block(block), want)
        want_batch = np.asarray(jq._check_batch(
            jnp.asarray(np.ascontiguousarray(block.T)), masks_t, meta))
        np.testing.assert_array_equal(checker.check_batch(block.T),
                                      want_batch)


def test_grid_chain_and_weighted_count_differ_on_non_binary_bytes():
    """A write grid with a 2 in one row and a 1 in the other: the grid
    chain gives ``2 & 1 = 0`` (no quorum) while the int32 weighted count
    passes. Each package takes the grid branch for a grid spec, and the
    port's generic branch agrees with the reference's matmul."""
    spec = Grid([[0, 1, 2], [3, 4, 5]]).write_spec()
    ref = JGrid([[0, 1, 2], [3, 4, 5]]).write_spec()
    block = np.zeros((6, 64), dtype=np.uint8)
    block[0, 0], block[4, 0] = 2, 1
    masks_t, meta = jq._spec_statics(ref)
    assert not np.asarray(jq._check_block(jnp.asarray(block), masks_t,
                                          meta))[0]
    pred = tq.make_predicate(spec.masks, spec.thresholds, False,
                             device="cpu")
    assert pred.grid is not None
    assert not tq.quorum_hit(torch.from_numpy(block), pred)[0]
    generic = pred._replace(grid=None)
    want = np.asarray(jq._quorum_hit(
        jnp.asarray(block), jnp.asarray(ref.masks, dtype=jnp.int32),
        jnp.asarray(ref.thresholds), False))
    got = tq.quorum_hit(torch.from_numpy(block), generic).numpy()
    assert want[0] and got[0]
    np.testing.assert_array_equal(got, want)


def _board_equal(port_board, ref_board):
    got = convert.vote_board_to_numpy(port_board)
    want = jax.device_get(ref_board)
    for name in tq.VoteBoard._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", [SPECS[0], SPECS[2], SPECS[3], SPECS[4]],
                         ids=["majority3", "grid2x3_write",
                              "grid_perm_write", "grid2x3_read"])
def test_record_block_sequences_match_reference(case):
    """Random record_block sequences with ring wrap, round preemption,
    stale owners, non-power-of-two widths and arbitrary bytes: newly,
    the whole board and window_violations agree after every call."""
    spec, ref = _specs(case)
    window = 256
    rng = np.random.default_rng(11)
    port = tq.TpuQuorumChecker(spec, window=window, device="cpu")
    jax_checker = jq.TpuQuorumChecker(ref, window=window)
    frontier = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for step in range(24):
            b = int(rng.choice([1, 5, 37, 64, 100]))
            kind = step % 4
            if kind == 0:      # advance the frontier (wraps the ring)
                frontier += int(rng.integers(40, 160))
                start_slot = frontier
            elif kind == 1:    # revisit a recent slot range
                start_slot = max(0, frontier - int(rng.integers(0, 64)))
            elif kind == 2:    # a stale slot range, >= window behind
                start_slot = max(0, frontier - window
                                 - int(rng.integers(0, 64)))
            else:              # land exactly at the ring end
                start_slot = (frontier // window + 1) * window - b
            if start_slot % window + b > window:
                start_slot -= start_slot % window + b - window
            vote_round = int(rng.integers(0, 3))
            if step % 3 == 0:
                block = rng.integers(0, 256, size=(spec.num_nodes, b),
                                     dtype=np.uint8)
            else:
                block = (rng.random((spec.num_nodes, b)) < 0.5
                         ).astype(np.uint8)
            got = port.record_block(start_slot, block, vote_round)
            want = jax_checker.record_block(start_slot, block, vote_round)
            np.testing.assert_array_equal(got, want, err_msg=str(step))
            _board_equal(port.board, jax_checker.board)
            assert port.window_violations == jax_checker.window_violations
    assert port.window_violations > 0


def test_record_block_rejects_a_foreign_board():
    spec = SimpleMajority(range(3)).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    board = tq.make_vote_board(128, 3, device="cpu")
    block = torch.ones((3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="make_vote_board"):
        tq.record_block(board._replace(rounds=board.rounds.to(torch.int64)),
                        0, 0, block, 0, pred)
    with pytest.raises(ValueError, match="make_vote_board"):
        tq.record_block(board._replace(owner=board.owner[:64]), 0, 0,
                        block, 0, pred)
    with pytest.raises(ValueError, match="window"):
        tq.record_block(board, 124, 124, block, 0, pred)


def test_record_block_async_keeps_the_padded_bucket():
    spec = SimpleMajority(range(3)).write_spec()
    checker = tq.TpuQuorumChecker(spec, window=256, device="cpu")
    newly = checker.record_block_async(0, np.ones((3, 5), dtype=np.uint8))
    assert newly.shape == (64,) and newly.dtype == torch.bool
    # No padding across the ring end: the exact width is kept.
    newly = checker.record_block_async(250, np.ones((3, 6), dtype=np.uint8))
    assert newly.shape == (6,)
    assert checker.check_block_async(
        np.ones((3, 65), dtype=np.uint8)).shape == (128,)


# --- ports of the dense-path tests of tests/test_ops_quorum.py -------------


def test_check_batch_matches_oracle():
    qs = Grid([[0, 1, 2], [3, 4, 5]])
    spec = qs.write_spec()
    subsets = [set(c) for r in range(7)
               for c in itertools.combinations(range(6), r)]
    present = np.stack([spec.present_vector(s) for s in subsets])
    checker = tq.TpuQuorumChecker(spec, window=8, device="cpu")
    np.testing.assert_array_equal(checker.check_batch(present),
                                  spec.evaluate(present))


def test_record_block_dense_path():
    qs = SimpleMajority([0, 1, 2])
    checker = tq.TpuQuorumChecker(qs.write_spec(), window=64, device="cpu")
    block = np.zeros((3, 8), dtype=np.uint8)
    block[0, :] = 1
    block[1, :4] = 1
    newly = checker.record_block(8, block)
    np.testing.assert_array_equal(newly, [True] * 4 + [False] * 4)
    block2 = np.zeros((3, 8), dtype=np.uint8)
    block2[2, :] = 1
    newly = checker.record_block(8, block2)
    np.testing.assert_array_equal(newly, [False] * 4 + [True] * 4)


def test_record_block_round_preemption():
    qs = SimpleMajority([0, 1, 2])
    checker = tq.TpuQuorumChecker(qs.write_spec(), window=64, device="cpu")
    block = np.zeros((3, 4), dtype=np.uint8)
    block[0, :] = 1
    assert not checker.record_block(0, block, vote_round=0).any()
    block1 = np.zeros((3, 4), dtype=np.uint8)
    block1[1, :] = 1
    assert not checker.record_block(0, block1, vote_round=2).any()
    block2 = np.zeros((3, 4), dtype=np.uint8)
    block2[2, :] = 1
    assert not checker.record_block(0, block2, vote_round=0).any()
    assert checker.record_block(0, block, vote_round=2).all()


def test_record_block_straddle_rejected():
    qs = SimpleMajority([0, 1, 2])
    checker = tq.TpuQuorumChecker(qs.write_spec(), window=16, device="cpu")
    with pytest.raises(ValueError):
        checker.record_block(12, np.zeros((3, 8), dtype=np.uint8))
    with pytest.raises(ValueError):
        checker.record_block(0, np.zeros((2, 8), dtype=np.uint8))


def test_window_violation_counter():
    """The frontier rule of the reference's sparse-path test, driven
    through single-column dense blocks."""
    qs = SimpleMajority([0, 1, 2])
    checker = tq.TpuQuorumChecker(qs.write_spec(), window=16, device="cpu")
    vote = np.ones((3, 1), dtype=np.uint8)
    checker.record_block(40, vote)
    assert checker.window_violations == 0
    with pytest.warns(RuntimeWarning, match="trails the frontier"):
        checker.record_block(20, vote)
    assert checker.window_violations == 1
    checker.record_block(21, vote)
    assert checker.window_violations == 2
    checker.record_block(30, vote)
    assert checker.window_violations == 2


def test_window_violation_counter_dense_path():
    qs = SimpleMajority([0, 1, 2])
    checker = tq.TpuQuorumChecker(qs.write_spec(), window=64, device="cpu")
    block = np.ones((3, 4), dtype=np.uint8)
    checker.record_block(200, block)
    with pytest.warns(RuntimeWarning):
        checker.record_block(128, block)
    assert checker.window_violations == 1


def test_window_violation_rejected_block():
    qs = SimpleMajority([0, 1, 2])
    checker = tq.TpuQuorumChecker(qs.write_spec(), window=16, device="cpu")
    # A rejected (ring-straddling) block must NOT advance the frontier.
    with pytest.raises(ValueError, match="straddles"):
        checker.record_block(1000, np.ones((3, 10), dtype=np.uint8))
    checker.record_block(990, np.ones((3, 1), dtype=np.uint8))
    assert checker.window_violations == 0


GRIDS = [
    Grid([[0, 1, 2], [3, 4, 5]]),
    Grid([[0, 1], [2, 3], [4, 5]]),
    Grid([[0, 2, 4], [1, 3, 5]]),
    Grid([[7, 8], [9, 10]]),
]


def test_spec_statics_detects_grids():
    for qs in GRIDS:
        for spec in (qs.write_spec(), qs.read_spec()):
            _, meta = tq.spec_statics(spec)
            assert meta[2] is not None, (qs, spec.combine)
    for spec in (SimpleMajority(range(5)).write_spec(),
                 UnanimousWrites(range(3)).read_spec()):
        _, meta = tq.spec_statics(spec)
        assert meta[2] is None
    spec = UnanimousWrites(range(3)).write_spec()
    _, meta = tq.spec_statics(spec)
    assert meta[2] == ("read", 1, 3, None)
    checker = tq.TpuQuorumChecker(spec, window=64, device="cpu")
    blocks = np.array([[1, 1, 0], [1, 1, 1], [0, 0, 0], [1, 0, 1]],
                      dtype=np.uint8)
    np.testing.assert_array_equal(checker.check_batch(blocks),
                                  spec.evaluate(blocks))


@pytest.mark.parametrize("qs", GRIDS, ids=["2x3", "3x2", "perm", "2x2"])
def test_fused_grid_check_block_matches_oracle(qs):
    rng = np.random.default_rng(3)
    for spec in (qs.write_spec(), qs.read_spec()):
        checker = tq.TpuQuorumChecker(spec, window=1 << 9, device="cpu")
        for width in (1, 7, 64, 100):
            block = (rng.random((spec.num_nodes, width)) < 0.5
                     ).astype(np.uint8)
            np.testing.assert_array_equal(checker.check_block(block),
                                          spec.evaluate(block.T),
                                          err_msg=f"{qs} {spec.combine}")


@pytest.mark.parametrize("qs", GRIDS, ids=["2x3", "3x2", "perm", "2x2"])
def test_fused_grid_record_block_matches_oracle(qs):
    """The dense half of the reference's fused-grid record-path test:
    votes accumulated across drains report exactly what the host oracle
    reports."""
    rng = np.random.default_rng(7)
    spec = qs.write_spec()
    checker = tq.TpuQuorumChecker(spec, window=1 << 9, device="cpu")
    n = spec.num_nodes
    host = np.zeros((n, 64), dtype=np.uint8)
    chosen = np.zeros(64, dtype=bool)
    for _ in range(6):
        arrivals = (rng.random((n, 64)) < 0.3).astype(np.uint8)
        newly = checker.record_block(0, arrivals)
        host |= arrivals
        hit = spec.evaluate(host.T)
        np.testing.assert_array_equal(newly, hit & ~chosen)
        chosen |= hit


def test_vote_board_round_trip_keeps_dtypes():
    ref = jq.TpuQuorumChecker(JGrid([[0, 1], [2, 3]]).write_spec(), 128)
    ref.record_block(5, np.ones((4, 9), dtype=np.uint8), 2)
    fetched = jax.device_get(ref.board)
    board = convert.vote_board_from_numpy(fetched, device="cpu")
    assert [t.dtype for t in board] == [torch.uint8, torch.int32,
                                        torch.bool, torch.int32]
    _board_equal(board, ref.board)
    with pytest.raises(ValueError, match="rounds"):
        convert.vote_board_from_numpy(
            fetched._replace(rounds=fetched.rounds.astype(np.int64)),
            device="cpu")
