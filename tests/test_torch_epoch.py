"""The port's epoch and multi-config checkers (K6 ``check_batch_multi`` /
``record_and_check_epochs``, K7 ``reshape_columns``) vs the JAX
reference.

Bit-identity (tolerance 0) of every mask and board, on the plain
PyTorch versions (``device="cpu"``); ``chip_smoke.py`` holds the CUDA
kernels against these plain versions on the GPU. Also repeats the
multi-config case of ``tests/test_ops_quorum.py`` and the epoch cases of
``tests/test_reconfig.py`` against the port.
"""

import random

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
)
from frankenpaxos_tpu.quorums.spec import pad_specs as jpad_specs


def _random_systems(rng, pool):
    """One random quorum system (majority or non-square grid over a
    permuted universe) as ``(port system, reference system)``."""
    if rng.random() < 0.5:
        members = rng.sample(pool, rng.choice([3, 5, 7]))
        return SimpleMajority(members), JSimpleMajority(members)
    rows, cols = rng.choice([2, 3]), rng.choice([2, 3, 4])
    cells = rng.sample(pool, rows * cols)
    grid = [cells[r * cols:(r + 1) * cols] for r in range(rows)]
    return Grid(grid), JGrid(grid)


def _boards_equal(port_board, ref_board, msg=""):
    port = convert.vote_board_to_numpy(port_board)
    for name, ref in zip(tq.VoteBoard._fields, ref_board):
        np.testing.assert_array_equal(getattr(port, name), np.asarray(ref),
                                      err_msg=f"{name} {msg}")


# --- K6: the multi-config predicate ------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_check_batch_multi_matches_reference(seed):
    """Random padded planes (majorities, grids of either kind, the
    degenerate unanimous spec), rows of 0/1 and of arbitrary int32
    values, and config indices below, inside and past ``[0, K)``."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    universe = tuple(range(12))
    specs = []
    for _ in range(4):
        port, _ = _random_systems(rng, list(universe))
        spec = port.write_spec() if rng.random() < 0.5 else port.read_spec()
        specs.append(spec.reindexed(universe))
    specs.append(UnanimousWrites(range(3)).write_spec().reindexed(universe))
    masks, thresholds, combine_any = jpad_specs(specs)
    planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                     device="cpu")
    k = len(specs)
    b = 300
    present = (nrng.random((b, 12)) < 0.5).astype(np.int32)
    present[:40] = nrng.integers(-2**31, 2**31 - 1, size=(40, 12))
    idx = nrng.integers(-k - 2, k + 3, size=b).astype(np.int32)
    got = tq.check_batch_multi(torch.from_numpy(present),
                               torch.from_numpy(idx), planes)
    want = jq._check_batch_multi(jnp.asarray(present), jnp.asarray(idx),
                                 jnp.asarray(masks), jnp.asarray(thresholds),
                                 jnp.asarray(combine_any))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # A transposed (strided) view gives the same answer.
    strided = torch.from_numpy(np.ascontiguousarray(present.T)).t()
    np.testing.assert_array_equal(
        tq.check_batch_multi(strided, torch.from_numpy(idx), planes),
        got.numpy())


def test_multi_config_checker():
    """tests/test_ops_quorum.py's multi-config case, plus the reference's
    answers on bool and int64 rows."""
    universe = tuple(range(6))
    specs = [Grid([[0, 1, 2], [3, 4, 5]]).write_spec().reindexed(universe),
             SimpleMajority([0, 1, 2, 3, 4]).write_spec().reindexed(universe),
             UnanimousWrites([0, 1, 2]).write_spec().reindexed(universe)]
    checker = tq.MultiConfigQuorumChecker(specs, device="cpu")
    ref = jq.MultiConfigQuorumChecker(specs)
    rng = random.Random(9)
    rows, cfgs, expected = [], [], []
    for _ in range(200):
        xs = {i for i in range(6) if rng.random() < 0.5}
        k = rng.randrange(3)
        rows.append(specs[k].present_vector(xs))
        cfgs.append(k)
        expected.append(specs[k].check(xs))
    rows = np.stack(rows)
    got = checker.check_batch(rows, np.array(cfgs))
    np.testing.assert_array_equal(got, np.array(expected))
    for present in (rows.astype(bool), rows.astype(np.int64) * 3):
        np.testing.assert_array_equal(
            checker.check_batch(present, np.array(cfgs)),
            ref.check_batch(present, np.array(cfgs)))


# --- K7: the epoch reshape -----------------------------------------------------


def test_epoch_column_map_and_reshape_block():
    cmap = tq.epoch_column_map((5, 9, 2), (2, 9, 7, 5))
    assert cmap.tolist() == [2, 1, -1, 0]
    block = np.asarray([[1, 0], [1, 1], [0, 1]], dtype=np.uint8)
    got = tq.reshape_block(block, (5, 9, 2), (2, 9, 7, 5), device="cpu")
    assert got.tolist() == [[0, 1], [1, 1], [0, 0], [1, 0]]
    np.testing.assert_array_equal(
        got, jq.reshape_block(block, (5, 9, 2), (2, 9, 7, 5)))


@pytest.mark.parametrize("n_old,n_new", [(3, 4), (3, 2), (5, 5), (1, 3)])
def test_reshape_columns_matches_reference(n_old, n_new):
    rng = np.random.default_rng(n_old * 10 + n_new)
    block = rng.integers(0, 256, size=(n_old, 100), dtype=np.uint8)
    # Rows drawn from the old block, new rows (-1), and indices past
    # the end (clamped by the reference's clip).
    cmap = rng.integers(-2, n_old + 2, size=n_new).astype(np.int32)
    got = tq.reshape_columns(torch.from_numpy(block), torch.from_numpy(cmap))
    want = jq._reshape_columns(jnp.asarray(block), jnp.asarray(cmap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_tpu_checker_reshape_matches_reference(seed):
    """TpuQuorumChecker.reshape in lockstep with the reference's, and
    (tests/test_reconfig.py) the surviving votes equal a fresh board's
    replay."""
    rng = random.Random(200 + seed)
    pool = list(range(24))
    (old, jold), (new, jnew) = (_random_systems(rng, pool),
                                _random_systems(rng, pool))
    checker = tq.TpuQuorumChecker(old.write_spec(), window=64, device="cpu")
    ref = jq.TpuQuorumChecker(jold.write_spec(), window=64)
    fresh = tq.TpuQuorumChecker(new.write_spec(), window=64, device="cpu")
    old_spec, new_spec = old.write_spec(), new.write_spec()
    pre = [(rng.randrange(0, 48), rng.choice(old_spec.universe))
           for _ in range(40)]
    for slot, voter in pre:
        for c in (checker, ref):
            c.record_and_check([slot], [old_spec.column_of(voter)])
    checker.reshape(new_spec)
    ref.reshape(jnew.write_spec())
    _boards_equal(checker.board, ref.board, "after reshape")
    for slot, voter in pre:
        if voter in new_spec.universe:
            fresh.record_and_check([slot], [new_spec.column_of(voter)])
    post = [(rng.randrange(0, 48), rng.choice(new_spec.universe))
            for _ in range(40)]
    for slot, voter in post:
        col = new_spec.column_of(voter)
        np.testing.assert_array_equal(checker.record_and_check([slot], [col]),
                                      ref.record_and_check([slot], [col]))
        fresh.record_and_check([slot], [col])
    _boards_equal(checker.board, ref.board, "after post")
    touched = sorted({s for s, _ in pre} | {s for s, _ in post})
    got = checker.board.votes.numpy()
    want = fresh.board.votes.numpy()
    for slot in touched:
        np.testing.assert_array_equal(got[:, slot % 64], want[:, slot % 64])


# --- K6: the epoch-segmented checker ---------------------------------------------


class TwoConfigOracle:
    """slot < boundary: the old system's write quorums; else the new's."""

    def __init__(self, old, new, boundary):
        self.old, self.new, self.boundary = old, new, boundary

    def chosen(self, slot, voters) -> bool:
        system = self.old if slot < self.boundary else self.new
        return system.is_superset_of_write_quorum(
            set(voters) & set(system.nodes()))


@pytest.mark.parametrize("seed", range(4))
def test_epoch_segmented_check_batch_matches_oracle(seed):
    rng = random.Random(seed)
    pool = list(range(40))
    (old, jold), (new, jnew) = (_random_systems(rng, pool),
                                _random_systems(rng, pool))
    boundary = rng.randrange(1, 64)
    oracle = TwoConfigOracle(old, new, boundary)
    seen: dict = {}
    for node in tuple(sorted(old.nodes())) + tuple(sorted(new.nodes())):
        seen.setdefault(node, len(seen))
    universe = tuple(seen)
    specs = [old.write_spec().reindexed(universe),
             new.write_spec().reindexed(universe)]
    checker = tq.EpochSegmentedChecker(specs, [0, boundary], window=256,
                                       device="cpu")
    ref = jq.EpochSegmentedChecker(
        [jold.write_spec().reindexed(universe),
         jnew.write_spec().reindexed(universe)], [0, boundary], window=256)
    assert checker.universe == universe
    slots = np.asarray([rng.randrange(0, 128) for _ in range(50)])
    present = np.zeros((50, len(universe)), dtype=np.uint8)
    voters = []
    for i in range(50):
        vs = rng.sample(universe, rng.randrange(0, len(universe) + 1))
        voters.append(vs)
        for v in vs:
            present[i, seen[v]] = 1
    got = checker.check_batch(present, slots)
    assert got.tolist() == [oracle.chosen(int(s), vs)
                            for s, vs in zip(slots, voters)]
    np.testing.assert_array_equal(got, ref.check_batch(present, slots))
    block = present[:20].T
    np.testing.assert_array_equal(checker.check_block(boundary - 10, block),
                                  ref.check_block(boundary - 10, block))


@pytest.mark.parametrize("seed", range(4))
def test_epoch_segmented_record_and_check_matches_reference(seed):
    """Stateful scatter across a handover added mid-collection, in
    lockstep with the reference (masks and boards after every call),
    and cumulative chosen-ness against the two-config oracle."""
    rng = random.Random(100 + seed)
    pool = list(range(30))
    (old, jold), (new, jnew) = (_random_systems(rng, pool),
                                _random_systems(rng, pool))
    boundary = rng.randrange(4, 40)
    oracle = TwoConfigOracle(old, new, boundary)
    old_universe = tuple(sorted(old.nodes()))
    checker = tq.EpochSegmentedChecker(
        [old.write_spec().reindexed(old_universe)], [0], window=128,
        device="cpu")
    ref = jq.EpochSegmentedChecker(
        [jold.write_spec().reindexed(old_universe)], [0], window=128)
    voters_by_slot: dict = {}
    chosen_at: dict = {}

    def feed(slot_range):
        universe_now = list(checker.universe)
        for _ in range(15):
            batch = [(rng.randrange(*slot_range), rng.choice(universe_now))
                     for _ in range(rng.randrange(1, 9))]
            slots = [s for s, _ in batch]
            cols = [checker.column_of(v) for _, v in batch]
            for s, v in batch:
                voters_by_slot.setdefault(s, set()).add(v)
            newly = checker.record_and_check(slots, cols, [0] * len(slots))
            np.testing.assert_array_equal(
                newly, ref.record_and_check(slots, cols, [0] * len(slots)))
            _boards_equal(checker.board, ref.board)
            for s, x in zip(slots, newly):
                if x:
                    chosen_at.setdefault(s, set(voters_by_slot[s]))

    feed((0, boundary))
    checker.add_epoch(new.write_spec(), boundary)
    ref.add_epoch(jnew.write_spec(), boundary)
    assert checker.universe == ref.universe
    _boards_equal(checker.board, ref.board, "after add_epoch")
    feed((0, boundary + 30))
    for slot, voters in voters_by_slot.items():
        if slot in chosen_at:
            assert oracle.chosen(slot, chosen_at[slot]), slot
        else:
            assert not oracle.chosen(slot, voters), slot
    for c in (checker, ref):
        c.release(np.arange(0, 20))
    _boards_equal(checker.board, ref.board, "after release")


@pytest.mark.parametrize("seed", range(3))
def test_record_and_check_epochs_plain_matches_reference_on_raw_lanes(seed):
    """The plain K6 scatter against the reference's jitted kernel on raw
    lanes: invalid lanes, duplicates, nodes outside ``[-N, N)``, true
    slots around each boundary and a board carried in mid-flight."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    universe = tuple(range(5))
    specs = []
    for members in ((0, 1, 2), (0, 1, 3), (1, 3, 4)):
        specs.append(SimpleMajority(members).write_spec().reindexed(universe))
    if seed:
        specs[1] = Grid([[0, 1], [3, 4]]).write_spec().reindexed(universe)
    starts = [0, 40, 90]
    masks, thresholds, combine_any = jpad_specs(specs)
    planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                     device="cpu")
    window, b = 64, 128
    arrays = jq.VoteBoard(
        votes=nrng.integers(0, 3, size=(5, window), dtype=np.uint8),
        rounds=nrng.integers(-1, 3, size=window).astype(np.int32),
        chosen=nrng.random(window) < 0.2,
        owner=nrng.integers(-1, 160, size=window).astype(np.int32))
    board = convert.vote_board_from_numpy(arrays, device="cpu")
    ref_board = jq.VoteBoard(*(jnp.asarray(x) for x in arrays))
    true_slots = np.asarray([rng.choice([39, 40, 41, 89, 90, 91])
                             + rng.choice([0, 0, window, 2 * window])
                             for _ in range(b)], dtype=np.int32)
    slots = true_slots % window
    nodes = nrng.integers(-6, 7, size=b).astype(np.int32)
    rounds = nrng.integers(0, 3, size=b).astype(np.int32)
    valid = nrng.random(b) < 0.8
    boundaries = np.asarray(starts[1:], dtype=np.int32)
    got = tq.record_and_check_epochs(
        board, torch.from_numpy(tq.pack_lanes(slots, true_slots, nodes,
                                              rounds, valid)),
        torch.from_numpy(boundaries), planes)
    ref_board, want = jq._record_and_check_epochs(
        ref_board, *(jnp.asarray(x) for x in (slots, true_slots, nodes,
                                              rounds, valid, boundaries,
                                              masks, thresholds,
                                              combine_any)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _boards_equal(board, ref_board)


def test_epoch_checker_carried_across_mid_flight():
    """A JAX checker stopped mid-flight (after a handover, with int32
    wrapped slots) carries into the port; both then run in lockstep."""
    rng = np.random.default_rng(11)
    ref = jq.EpochSegmentedChecker([JSimpleMajority([0, 1, 2]).write_spec()],
                                   [0], window=64)
    for i in range(6):
        slots = rng.integers(0, 80, size=30)
        ref.record_and_check(slots, rng.integers(0, 3, size=30))
    ref.add_epoch(JSimpleMajority([0, 1, 3]).write_spec(), 50)
    ref.record_and_check(rng.integers(40, 100, size=30),
                         rng.integers(0, 4, size=30))
    port = convert.epoch_checker_from_numpy(
        ref._own_specs, ref._starts, ref.window,
        jq.VoteBoard(*(np.asarray(x) for x in ref.board)), device="cpu")
    planes = convert.epoch_planes_to_numpy(port)
    np.testing.assert_array_equal(planes["masks"], np.asarray(ref._masks))
    np.testing.assert_array_equal(planes["thresholds"],
                                  np.asarray(ref._thresholds))
    np.testing.assert_array_equal(planes["combine_any"],
                                  np.asarray(ref._combine_any))
    np.testing.assert_array_equal(planes["boundaries"],
                                  np.asarray(ref._boundaries))
    for start in (60, 2**31 - 20, 2**31 + 30):
        slots = (start + rng.integers(0, 40, size=50)).astype(np.int64)
        nodes = rng.integers(0, 4, size=50)
        np.testing.assert_array_equal(port.record_and_check(slots, nodes),
                                      ref.record_and_check(slots, nodes))
        _boards_equal(port.board, ref.board, str(start))
    with pytest.raises(ValueError, match="union universe"):
        convert.epoch_checker_from_numpy(
            ref._own_specs[:1], [0], ref.window,
            jq.VoteBoard(*(np.asarray(x) for x in ref.board)), device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_pad_specs_and_reindexed_match_reference(seed):
    """The port's copy of ``pad_specs`` and ``reindexed``: ragged group
    counts padded with the reference's fill values (threshold 0 under
    ALL, N + 1 under ANY), on permuted and widened universes."""
    rng = random.Random(400 + seed)
    pool = list(range(16))
    universe = tuple(rng.sample(pool, 16))
    ports, refs = [], []
    for _ in range(4):
        port, ref = _random_systems(rng, pool)
        kind = rng.choice(["write_spec", "read_spec"])
        ports.append(getattr(port, kind)().reindexed(universe))
        refs.append(getattr(ref, kind)().reindexed(universe))
    for got, want in zip(ports, refs):
        np.testing.assert_array_equal(got.masks, want.masks)
        np.testing.assert_array_equal(got.thresholds, want.thresholds)
        assert (got.combine, got.universe) == (want.combine, want.universe)
    for got, want in zip(pad_specs(ports), jpad_specs(refs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --- K6's run: one launch a drain, chunk by chunk ------------------------------

RUN_CHUNK = 32
RUN_WINDOW = 64
RUN_STARTS = (0, 40, 90)


def _run_planes():
    universe = tuple(range(5))
    specs = [SimpleMajority(m).write_spec().reindexed(universe)
             for m in ((0, 1, 2), (0, 1, 3), (1, 3, 4))]
    return jpad_specs(specs)


def _run_board(nrng):
    return jq.VoteBoard(
        votes=nrng.integers(0, 3, size=(5, RUN_WINDOW), dtype=np.uint8),
        rounds=nrng.integers(-1, 3, size=RUN_WINDOW).astype(np.int32),
        chosen=nrng.random(RUN_WINDOW) < 0.2,
        owner=nrng.integers(-1, 160, size=RUN_WINDOW).astype(np.int32))


def _run_lanes(nrng, case: str) -> tuple:
    """``(slots, true slots, nodes, rounds, valid)`` of one run: chunks of
    ``RUN_CHUNK`` lanes with duplicates inside and across chunks; the
    cases add an epoch boundary inside a chunk, true slots across the
    int32 wrap, slots and nodes out of range, pad lanes and a ragged
    last chunk."""
    chunks = {"one": 1, "two": 2, "many": 12, "boundary": 3, "wrap": 4,
              "oob": 3, "pads": 3, "ragged": 3}[case]
    b = chunks * RUN_CHUNK - (11 if case == "ragged" else 0)
    base = {"boundary": 30, "wrap": 2**31 - 20}.get(case, 100)
    true = base + nrng.integers(0, 24, size=b).astype(np.int64)
    true[nrng.integers(0, b, size=b // 4)] = true[0]  # across chunks
    true[1::7] = true[0::7][:true[1::7].size]         # inside a chunk
    if case == "boundary":
        true[::3] = nrng.choice([39, 40, 41, 89, 90, 91], size=true[::3].size)
    slots = true % RUN_WINDOW
    nodes = nrng.integers(0, 5, size=b)
    rounds = nrng.integers(0, 3, size=b)
    valid = np.ones(b, dtype=bool)
    if case == "oob":
        far = nrng.random(b) < 0.2
        slots[far] += nrng.choice([-2, -1, 1], size=int(far.sum())) \
            * RUN_WINDOW
        odd = nrng.random(b) < 0.2
        nodes[odd] = nrng.choice([-7, -6, -1, 5, 6], size=int(odd.sum()))
    if case in ("pads", "ragged"):
        valid[nrng.random(b) < 0.25] = False
        slots[~valid], true[~valid] = 0, 0
    return slots, true, nodes, rounds, valid


@pytest.mark.parametrize("case", ["one", "two", "many", "boundary", "wrap",
                                  "oob", "pads", "ragged"])
def test_record_and_check_epochs_run_matches_reference_chunks(case):
    """The run's plain version against the reference's
    ``_record_and_check_epochs`` called on each chunk in turn, on a board
    carried in mid-flight: the concatenated newly masks and the board
    after the run equal."""
    nrng = np.random.default_rng(sum(map(ord, case)))
    masks, thresholds, combine_any = _run_planes()
    planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                     device="cpu")
    arrays = _run_board(nrng)
    board = convert.vote_board_from_numpy(arrays, device="cpu")
    ref_board = jq.VoteBoard(*(jnp.asarray(x) for x in arrays))
    slots, true, nodes, rounds, valid = _run_lanes(nrng, case)
    lanes = tq.pack_lanes(slots, true, nodes, rounds, valid)
    boundaries = np.asarray(RUN_STARTS[1:], dtype=np.int32)
    got = tq.record_and_check_epochs_run(
        board, torch.from_numpy(lanes), torch.from_numpy(boundaries),
        planes, RUN_CHUNK)
    want = []
    for at in range(0, lanes.shape[1], RUN_CHUNK):
        ref_board, newly = jq._record_and_check_epochs(
            ref_board, *(jnp.asarray(x) for x in (
                *lanes[:4, at:at + RUN_CHUNK], lanes[4, at:at + RUN_CHUNK]
                != 0, boundaries, masks, thresholds, combine_any)))
        want.append(np.asarray(newly))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))
    _boards_equal(board, ref_board, case)


@pytest.mark.parametrize("seed", range(3))
def test_pad_lanes_are_inert_in_a_run(seed):
    """A run with pad lanes (valid 0, slot 0: what a chunk padded to its
    bucket carries) and the same run without them leave the same board,
    and the other lanes report the same; a pad lane reports nothing. So
    the run takes its lanes unpadded."""
    nrng = np.random.default_rng(40 + seed)
    masks, thresholds, combine_any = _run_planes()
    planes = tq.make_multi_predicate(masks, thresholds, combine_any,
                                     device="cpu")
    boundaries = torch.tensor(RUN_STARTS[1:], dtype=torch.int32)
    arrays = _run_board(nrng)
    slots, true, nodes, rounds, _ = _run_lanes(nrng, "many")
    bare = tq.pack_lanes(slots, true, nodes, rounds,
                         np.ones(slots.size, bool))
    # Each chunk padded at its end, as the chunk loop padded it.
    padded, is_pad = [], []
    for at in range(0, bare.shape[1], RUN_CHUNK - 8):
        part = bare[:, at:at + RUN_CHUNK - 8]
        padded.append(np.pad(part, ((0, 0), (0, 8))))
        is_pad.append(np.arange(part.shape[1] + 8) >= part.shape[1])
    padded, is_pad = np.concatenate(padded, axis=1), np.concatenate(is_pad)
    boards = [convert.vote_board_from_numpy(arrays, device="cpu")
              for _ in range(2)]
    got_padded = tq.record_and_check_epochs_run(
        boards[0], torch.from_numpy(padded), boundaries, planes,
        RUN_CHUNK).numpy()
    got_bare = tq.record_and_check_epochs_run(
        boards[1], torch.from_numpy(bare), boundaries, planes,
        RUN_CHUNK - 8).numpy()
    assert not got_padded[is_pad].any()
    np.testing.assert_array_equal(got_padded[~is_pad], got_bare)
    for a, b in zip(boards[0], boards[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_record_and_check_run_matches_reference_checker(seed):
    """``EpochSegmentedChecker.record_and_check_run`` (one call a drain)
    against the reference checker's ``record_and_check`` on each chunk of
    256 votes in turn (the reference tracker's loop), across a handover
    that widens the universe: masks and boards equal."""
    rng = random.Random(500 + seed)
    nrng = np.random.default_rng(500 + seed)
    members = (("a0", "a1", "a2"), ("a0", "a1", "a3"))
    checker = tq.EpochSegmentedChecker(
        [SimpleMajority(members[0]).write_spec()], [0], window=256,
        device="cpu")
    ref = jq.EpochSegmentedChecker(
        [JSimpleMajority(members[0]).write_spec()], [0], window=256)
    handover = 300
    for drain in range(6):
        if drain == 3:
            checker.add_epoch(SimpleMajority(members[1]).write_spec(),
                              handover)
            ref.add_epoch(JSimpleMajority(members[1]).write_spec(),
                          handover)
        b = rng.randrange(1, 900)
        slots = nrng.integers(drain * 100, drain * 100 + 150,
                              size=b).astype(np.int64)
        cols = nrng.integers(0, len(checker.universe), size=b)
        rounds = nrng.integers(0, 2, size=b).astype(np.int32)
        got = checker.record_and_check_run(slots, cols, rounds)
        want = np.concatenate([ref.record_and_check(
            slots[at:at + 256], cols[at:at + 256], rounds[at:at + 256])
            for at in range(0, b, 256)])
        np.testing.assert_array_equal(got, want)
        _boards_equal(checker.board, ref.board, f"drain {drain}")
    assert checker.record_and_check_run([], [], []).shape == (0,)


@pytest.mark.parametrize("size", [None, 7, 12])
def test_pack_lanes_into_a_view_matches_a_new_array(size):
    """``pack_lanes(out=)`` (the staged drain's pinned view) writes what
    a new array holds: the five rows, true slots past 2^31 - 1 wrapped,
    and the padding lanes zeroed over whatever the view held."""
    rng = np.random.default_rng(3)
    true = rng.integers(2**31 - 4, 2**31 + 4, size=7)
    args = (true % 64, true, rng.integers(0, 5, size=7),
            rng.integers(0, 3, size=7), np.ones(7, bool))
    want = tq.pack_lanes(*args, size)
    view = np.full((tq.LANE_FIELDS, want.shape[1]), -5, dtype=np.int32)
    got = tq.pack_lanes(*args, size, out=view)
    assert got is view
    np.testing.assert_array_equal(got, want)
