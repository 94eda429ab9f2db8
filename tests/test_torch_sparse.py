"""The port's sparse vote-board path (K4 ``record_and_check``, K5
``release``) vs the JAX reference.

Every output is an integer or a bool, so parity is bit-identity
(tolerance 0): the per-vote masks and the whole board after every call.
The port runs its plain PyTorch versions here (``device="cpu"``); the
CUDA kernels are held against those same plain versions on the GPU by
``chip_smoke.py``. The second half repeats the sparse cases of
``tests/test_ops_quorum.py`` against the port.
"""

import random
import warnings

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.quorums import (
    Grid,
    SimpleMajority,
    UnanimousWrites,
)
from frankenpaxos_tpu_torch.quorums.spec import pad_specs
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import quorum as jq
from frankenpaxos_tpu.quorums import (
    Grid as JGrid,
    SimpleMajority as JSimpleMajority,
    UnanimousWrites as JUnanimousWrites,
)

# (name, port spec, reference spec)
SPECS = [
    ("majority3", SimpleMajority(range(3)).write_spec(),
     JSimpleMajority(range(3)).write_spec()),
    ("grid2x3_write", Grid([[0, 1, 2], [3, 4, 5]]).write_spec(),
     JGrid([[0, 1, 2], [3, 4, 5]]).write_spec()),
    ("grid_perm_read", Grid([[0, 2, 4], [1, 3, 5]]).read_spec(),
     JGrid([[0, 2, 4], [1, 3, 5]]).read_spec()),
    ("unanimous_write", UnanimousWrites(range(3)).write_spec(),
     JUnanimousWrites(range(3)).write_spec()),
]
SPEC_IDS = [s[0] for s in SPECS]


def _assert_boards_equal(port_board, ref_board, msg=""):
    ref = jq.VoteBoard(*(np.asarray(x) for x in ref_board))
    port = convert.vote_board_to_numpy(port_board)
    for name in tq.VoteBoard._fields:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name),
                                      err_msg=f"{name} {msg}")


def _random_batch(rng, window, n, frontier, b):
    """A batch with duplicate slots, stale and reclaiming owners (slots a
    window apart), several rounds and nodes inside and outside
    ``[-n, n)``."""
    base = rng.integers(max(0, frontier - window), frontier + 8, size=b)
    jump = rng.choice([0, 0, 0, window, -window, 2 * window], size=b)
    slots = np.maximum(base + jump, 0)
    if b > 2:
        slots[rng.integers(0, b, size=b // 3)] = slots[0]  # duplicates
    nodes = rng.integers(0, n, size=b)
    odd = rng.random(b) < 0.1
    nodes[odd] = rng.integers(-n - 1, n + 1, size=int(odd.sum()))
    rounds = rng.integers(0, 3, size=b)
    return slots.astype(np.int64), nodes, rounds


@pytest.mark.parametrize("case", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("seed", range(3))
def test_record_and_check_sequences_match_reference(case, seed):
    """Random sparse batches through both checkers in lockstep: the
    newly masks and the whole board are equal after every call."""
    _, spec, ref_spec = case
    rng = np.random.default_rng(seed)
    window = 64
    n = spec.num_nodes
    port = tq.TpuQuorumChecker(spec, window=window, device="cpu")
    ref = jq.TpuQuorumChecker(ref_spec, window=window)
    frontier = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for step in range(24):
            b = int(rng.integers(1, 80))
            slots, nodes, rounds = _random_batch(rng, window, n, frontier,
                                                 b)
            pad_to = None if step % 3 else 256
            got = port.record_and_check(slots, nodes, rounds, pad_to)
            want = ref.record_and_check(slots, nodes, rounds, pad_to)
            np.testing.assert_array_equal(got, want, err_msg=str(step))
            _assert_boards_equal(port.board, ref.board, str(step))
            frontier += int(rng.integers(0, 24))
    assert port.window_violations == ref.window_violations


def test_record_and_check_int32_slot_wrap():
    """Slot numbers past 2^31 - 1 wrap to negative int32 owners in the
    reference's packing; the port wraps the same way."""
    spec, ref_spec = SPECS[0][1], SPECS[0][2]
    port = tq.TpuQuorumChecker(spec, window=128, device="cpu")
    ref = jq.TpuQuorumChecker(ref_spec, window=128)
    rng = np.random.default_rng(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for start in (2**31 - 70, 2**31 - 10, 2**31 + 40):
            slots = start + rng.integers(0, 60, size=90)
            nodes = rng.integers(0, 3, size=90)
            got = port.record_and_check(slots.astype(np.int64), nodes)
            want = ref.record_and_check(slots.astype(np.int64), nodes)
            np.testing.assert_array_equal(got, want)
            _assert_boards_equal(port.board, ref.board, str(start))
    assert (convert.vote_board_to_numpy(port.board).owner < 0).any()


@pytest.mark.parametrize("seed", range(4))
def test_kernel_plain_version_matches_reference_on_raw_lanes(seed):
    """``record_and_check_plain`` against the reference's jitted
    ``_record_and_check`` on raw lanes: invalid lanes anywhere (not only
    the padding at slot 0), a mid-flight board with arbitrary vote bytes
    carried in from the JAX side, the grid branch on non-0/1 bytes."""
    rng = np.random.default_rng(40 + seed)
    _, spec, ref_spec = SPECS[1 + seed % 3]
    window, n, b = 32, spec.num_nodes, 96
    arrays = jq.VoteBoard(
        votes=rng.integers(0, 4, size=(n, window), dtype=np.uint8),
        rounds=rng.integers(-1, 3, size=window).astype(np.int32),
        chosen=rng.random(window) < 0.2,
        owner=rng.integers(-1, 3 * window, size=window).astype(np.int32))
    board = convert.vote_board_from_numpy(arrays, device="cpu")
    ref_board = jq.VoteBoard(*(jnp.asarray(x) for x in arrays))
    true_slots = rng.integers(0, 4 * window, size=b).astype(np.int32)
    true_slots[:20] = true_slots[0]
    slots = true_slots % window
    nodes = rng.integers(-n - 2, n + 2, size=b).astype(np.int32)
    rounds = rng.integers(-2, 4, size=b).astype(np.int32)
    valid = rng.random(b) < 0.7
    masks_t, meta = tq.spec_statics(spec)
    pred = tq.make_predicate(masks_t, *meta[:2], device="cpu")
    lanes = torch.from_numpy(tq.pack_lanes(slots, true_slots, nodes, rounds,
                                           valid))
    got = tq.record_and_check_plain(board, lanes, pred)
    ref_board, want = jq._record_and_check(
        ref_board, jnp.asarray(slots), jnp.asarray(true_slots),
        jnp.asarray(nodes), jnp.asarray(rounds), jnp.asarray(valid),
        *jq._spec_statics(ref_spec))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_boards_equal(board, ref_board)


@pytest.mark.parametrize("epochs", [False, True], ids=["k4", "k6"])
@pytest.mark.parametrize("seed", range(3))
def test_out_of_range_slots_follow_reference_index_rules(epochs, seed):
    """Raw lanes whose slots lie outside ``[0, window)``: a negative slot
    counts from the end, one still out of range reads the clamped column
    and writes nothing, as JAX's gathers clamp and its scatters drop.
    The masks and boards equal the reference's, for K4 and K6, on a
    board whose owners include int32's least value."""
    rng = np.random.default_rng(80 + seed)
    window, n, b = 16, 3, 64
    arrays = jq.VoteBoard(
        votes=rng.integers(0, 2, size=(n, window), dtype=np.uint8),
        rounds=rng.integers(-1, 3, size=window).astype(np.int32),
        chosen=rng.random(window) < 0.3,
        owner=rng.integers(-1, 3 * window, size=window).astype(np.int32))
    arrays.owner[[0, window - 1]] = np.iinfo(np.int32).min
    board = convert.vote_board_from_numpy(arrays, device="cpu")
    ref_board = jq.VoteBoard(*(jnp.asarray(x) for x in arrays))
    slots = rng.integers(-2 * window, 2 * window, size=b).astype(np.int32)
    slots[:8] = rng.choice([0, window - 1, window, -window - 1], size=8)
    true_slots = rng.integers(0, 3 * window, size=b).astype(np.int32)
    true_slots[rng.random(b) < 0.3] = np.iinfo(np.int32).min
    nodes = rng.integers(0, n, size=b).astype(np.int32)
    rounds = rng.integers(0, 3, size=b).astype(np.int32)
    valid = rng.random(b) < 0.8
    lanes = torch.from_numpy(tq.pack_lanes(slots, true_slots, nodes, rounds,
                                           valid))
    refs = [jnp.asarray(x) for x in (slots, true_slots, nodes, rounds, valid)]
    spec = SimpleMajority(range(n)).write_spec()
    if epochs:
        masks, thresholds, combine_any = pad_specs([spec, spec])
        planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                         device="cpu")
        boundaries = np.asarray([window], dtype=np.int32)
        got = tq.record_and_check_epochs(board, lanes,
                                         torch.from_numpy(boundaries), planes)
        ref_board, want = jq._record_and_check_epochs(
            ref_board, *refs, *(jnp.asarray(x) for x in (
                boundaries, masks, thresholds, combine_any)))
    else:
        masks_t, meta = tq.spec_statics(spec)
        pred = tq.make_predicate(masks_t, *meta[:2], device="cpu")
        got = tq.record_and_check(board, lanes, pred)
        ref_board, want = jq._record_and_check(
            ref_board, *refs, *jq._spec_statics(
                JSimpleMajority(range(n)).write_spec()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_boards_equal(board, ref_board)


def _no_library(name):
    raise AssertionError(f"library {name} loaded for an empty batch")


class _FakeLibrary:
    """Stands in for a kernel library: every entry point returns 0 (no
    CUDA error) without launching anything."""

    def __getattr__(self, entry):
        return lambda *args: 0


def _wrapper_calls():
    """``(wrapper, call(b))`` for each kernel wrapper: ``call`` runs the
    wrapper on CPU tensors of batch ``b``."""
    n, window = 3, 64
    board = tq.make_vote_board(window, n, device="cpu")
    masks_t, meta = tq.spec_statics(SimpleMajority(range(n)).write_spec())
    pred = tq.make_predicate(masks_t, *meta[:2], device="cpu")
    masks, thresholds, combine_any = pad_specs(
        [SimpleMajority(range(n)).write_spec()] * 2)
    planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                     device="cpu")
    boundaries = torch.tensor([32], dtype=torch.int32)

    def lanes(b):
        return torch.from_numpy(tq.pack_lanes(*(np.zeros(b, np.int32),) * 5))

    return [
        (tq.quorum_hit, lambda b: tq.quorum_hit(
            torch.zeros((n, b), dtype=torch.uint8), pred)),
        (tq.record_block, lambda b: tq.record_block(
            board, 0, 0, torch.zeros((n, b), dtype=torch.uint8), 0, pred)),
        (tq.record_and_check, lambda b: tq.record_and_check(
            board, lanes(b), pred)),
        (tq.release, lambda b: tq.release(
            board, torch.zeros(b, dtype=torch.int32),
            torch.ones(b, dtype=torch.bool))),
        (tq.check_batch_multi, lambda b: tq.check_batch_multi(
            torch.zeros((b, n), dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32), planes)),
        (tq.record_and_check_epochs, lambda b: tq.record_and_check_epochs(
            board, lanes(b), boundaries, planes)),
        (tq.reshape_columns, lambda b: tq.reshape_columns(
            torch.zeros((n, b), dtype=torch.uint8),
            torch.arange(n, dtype=torch.int32))),
    ]


@pytest.mark.parametrize("index", range(7), ids=[
    "quorum_hit", "record_block", "record_and_check", "release",
    "check_batch_multi", "record_and_check_epochs", "reshape_columns"])
def test_launch_counts_only_launches(index, monkeypatch):
    """Each wrapper adds one to its count where it launches its kernel
    and nowhere else: an empty batch launches nothing and counts
    nothing; a batch of 4 counts one. The kernel path is forced on CPU
    tensors with a library that launches nothing."""
    wrapper, call = _wrapper_calls()[index]
    monkeypatch.setattr(tq, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tq._build, "library", _no_library)
    monkeypatch.setattr(tq._build, "packed_library",
                        lambda name, keep_gil: _no_library(name))
    for entry in (tq._K1, tq._K6, tq._K7):
        monkeypatch.setattr(entry, "fn", None)
    monkeypatch.setattr(wrapper, "launches", 0)
    call(0)
    assert wrapper.launches == 0
    monkeypatch.setattr(tq._build, "library", lambda name: _FakeLibrary())
    monkeypatch.setattr(tq._build, "packed_library",
                        lambda name, keep_gil: _FakeLibrary())
    monkeypatch.setattr(tq._build, "stream_args", lambda device: (0, None))
    monkeypatch.setattr(tq._build, "stream_handle", lambda index: 0)
    call(4)
    assert wrapper.launches == 1


@pytest.mark.parametrize("seed", range(3))
def test_release_matches_reference(seed):
    rng = np.random.default_rng(60 + seed)
    window, n = 32, 3
    arrays = jq.VoteBoard(
        votes=rng.integers(0, 2, size=(n, window), dtype=np.uint8),
        rounds=rng.integers(-1, 5, size=window).astype(np.int32),
        chosen=rng.random(window) < 0.5,
        owner=rng.integers(-1, 100, size=window).astype(np.int32))
    board = convert.vote_board_from_numpy(arrays, device="cpu")
    ref_board = jq.VoteBoard(*(jnp.asarray(x) for x in arrays))
    # All-valid lanes with duplicates, negative slots (counted from the
    # end) and slots out of range (dropped); then mixed valid flags on
    # distinct slots.
    slots = rng.integers(-window - 4, window + 4, size=40).astype(np.int32)
    valid = np.ones(40, dtype=bool)
    distinct = rng.permutation(window)[:20].astype(np.int32)
    mixed = rng.random(20) < 0.5
    for s, v in ((slots, valid), (distinct, mixed)):
        tq.release(board, torch.from_numpy(s), torch.from_numpy(v))
        ref_board = jq._release(ref_board, jnp.asarray(s), jnp.asarray(v))
        _assert_boards_equal(board, ref_board)


def test_release_duplicate_lanes_reset_when_any_is_valid():
    board = tq.make_vote_board(8, 3, device="cpu")
    board.votes.fill_(1)
    board.owner.fill_(5)
    tq.release(board, torch.tensor([2, 2, 3], dtype=torch.int32),
               torch.tensor([False, True, False]))
    assert board.votes[:, 2].eq(0).all() and board.owner[2] == -1
    assert board.votes[:, 3].eq(1).all() and board.owner[3] == 5


def test_checker_release_matches_reference():
    spec, ref_spec = SPECS[0][1], SPECS[0][2]
    port = tq.TpuQuorumChecker(spec, window=64, device="cpu")
    ref = jq.TpuQuorumChecker(ref_spec, window=64)
    for c in (port, ref):
        c.record_and_check(np.arange(40), np.arange(40) % 3)
        c.release(np.arange(10, 30))
        c.release([-1, 200])
    _assert_boards_equal(port.board, ref.board)


# --- the sparse cases of tests/test_ops_quorum.py, against the port -----------


def _checker(qs, window):
    return tq.TpuQuorumChecker(qs.write_spec(), window=window, device="cpu")


def test_record_and_check_simple_majority():
    checker = _checker(SimpleMajority([0, 1, 2]), 16)
    assert checker.record_and_check([5, 5], [0, 1], [0, 0]).any()
    assert not checker.record_and_check([5], [2], [0]).any()
    assert not checker.record_and_check([6], [0], [0]).any()
    assert checker.record_and_check([6], [2], [0]).any()


def test_round_preemption_clears_votes():
    checker = _checker(SimpleMajority([0, 1, 2]), 16)
    assert not checker.record_and_check([3], [0], [0]).any()
    assert not checker.record_and_check([3], [1], [5]).any()
    assert not checker.record_and_check([3], [2], [0]).any()
    assert checker.record_and_check([3], [0], [5]).any()


def test_release_recycles_rows():
    checker = _checker(SimpleMajority([0, 1, 2]), 4)
    assert checker.record_and_check([1, 1], [0, 1], [0, 0]).any()
    checker.release([1])
    assert not checker.record_and_check([5], [0], [0]).any()
    assert checker.record_and_check([5], [1], [0]).any()


@pytest.mark.parametrize("seed", [1234, 99])
def test_randomized_against_host_oracle(seed):
    rng = random.Random(seed)
    spec = Grid([[0, 1], [2, 3]]).write_spec()
    window = 32
    checker = tq.TpuQuorumChecker(spec, window=window, device="cpu")
    host_rounds, host_votes, host_chosen = {}, {}, set()
    for _ in range(30):
        batch = max(1, rng.randrange(8))
        slots = [rng.randrange(window) for _ in range(batch)]
        cols = [rng.randrange(4) for _ in range(batch)]
        rounds = [rng.randrange(3) for _ in range(batch)]
        newly = checker.record_and_check(slots, cols, rounds)
        batch_round = {}
        for s, r in zip(slots, rounds):
            batch_round[s] = max(batch_round.get(s, -1), r)
        for s, r in batch_round.items():
            if r > host_rounds.get(s, -1):
                host_rounds[s] = r
                host_votes[s] = set()
        for s, c, r in zip(slots, cols, rounds):
            if r == host_rounds.get(s, -1):
                host_votes.setdefault(s, set()).add(c)
        newly_host = set()
        for s in set(slots):
            if s not in host_chosen and spec.check(host_votes.get(s, set())):
                newly_host.add(s)
                host_chosen.add(s)
        assert {s for s, x in zip(slots, newly) if x} == newly_host


def test_padding_invalid_entries_ignored():
    checker = _checker(SimpleMajority([0, 1, 2]), 8)
    newly = checker.record_and_check([2], [0], [0], pad_to=64)
    assert newly.shape == (1,) and not newly.any()
    assert checker.board.votes[0, 0] == 0
    assert checker.record_and_check([0, 0], [1, 2], [0, 0]).any()


def test_record_block_mixed_with_sparse():
    checker = _checker(SimpleMajority([0, 1, 2]), 64)
    block = np.zeros((3, 8), dtype=np.uint8)
    block[0, :] = 1
    assert not checker.record_block(16, block).any()
    assert checker.record_and_check([20], [1], [0]).all()


def test_window_violation_counter():
    checker = _checker(SimpleMajority([0, 1, 2]), 16)
    checker.record_and_check([40], [0], [0])
    assert checker.window_violations == 0
    with pytest.warns(RuntimeWarning, match="trails the frontier"):
        checker.record_and_check([20], [1], [0])
    assert checker.window_violations == 1
    checker.record_and_check([21], [1], [0])
    assert checker.window_violations == 2
    checker.record_and_check([30], [1], [0])
    assert checker.window_violations == 2
    with pytest.warns(RuntimeWarning):
        _checker(SimpleMajority([0, 1, 2]), 16).record_and_check(
            [36, 20], [0, 1], [0, 0])


@pytest.mark.parametrize("qs", [Grid([[0, 1, 2], [3, 4, 5]]),
                                Grid([[0, 2, 4], [1, 3, 5]])],
                         ids=["2x3", "perm"])
def test_fused_grid_record_paths_match_oracle(qs):
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
    slots = rng.integers(0, 64, size=20)
    nodes = rng.integers(0, n, size=20)
    newly = checker.record_and_check(slots, nodes)
    for s, node in zip(slots, nodes):
        host[node, s] = 1
    hit = spec.evaluate(host.T)
    for i, s in enumerate(slots):
        if newly[i]:
            assert hit[s] and not chosen[s]
