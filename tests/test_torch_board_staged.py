"""K2's run of dense blocks and K5's held releases, against the JAX
package (JAX on the CPU), exactly.

(a) ``record_block_run_plain`` (the plain version of K2's run kernel:
``record_block_plain`` on each block of the table in order) against the
JAX package's ``_record_block`` applied block by block: majorities of
1-17 acceptors (16 register forms and the runtime loop) and grids, on
mid-flight boards, with unaligned columns, blocks at the ring end, slot
ids across 2^31 - 1 (the int32 wrap, on a window that does not divide
2^31), vote bytes 2 and 255, claims, stale owners, preemption, and
blocks that overlap an earlier block of the run (``run_table`` starts a
new launch there).
(b) The staged C entries, with the C functions stood in for by a Python
model of their packed blocks (the in-block and the table read from
their addresses, the plain versions on the board, ``newly`` copied
down, the event marked pending until it is waited on): the run's table
and offsets, the held releases at the head of the in-block, the pinned
ring's slot choice, a slot reused only after its event was waited on,
the ring growing while a collector lags, K6's staged entry carrying the
held releases, and the flush entry ahead of every other board call.
(c) The pipelined tracker on tracker_lt's stream through the staged
dense path, against the JAX ``TpuQuorumTracker(pipelined=True)`` and the
dict oracle.
(d) Held releases against the JAX package's immediate ones, on
``TpuQuorumChecker``, ``EpochQuorumTracker`` and ``GeoQuorumTracker``:
identical reports, and identical boards (reading ``board`` flushes).

The CUDA kernels and entries are held against the plain versions on the
H100 by ``chip_smoke.py`` (phases 4, 7 and 8).
"""

import ctypes
import struct
import warnings

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import tracker_lt
from frankenpaxos_tpu_torch.ops import _build, quorum as tq
from frankenpaxos_tpu_torch.protocols.multipaxos import quorum_tracker as qt
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority
from frankenpaxos_tpu_torch.reconfig import (
    EpochConfig,
    EpochQuorumTracker,
    EpochStore,
)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import quorum as jq
from frankenpaxos_tpu.protocols.multipaxos import quorum_tracker as jqt
from frankenpaxos_tpu.protocols.multipaxos.config import (
    DistributionScheme as JDistributionScheme,
    MultiPaxosConfig as JMultiPaxosConfig,
)
from frankenpaxos_tpu.quorums import (
    Grid as JGrid,
    SimpleMajority as JSimpleMajority,
)
from frankenpaxos_tpu.reconfig import (
    EpochConfig as JEpochConfig,
    EpochQuorumTracker as JEpochQuorumTracker,
    EpochStore as JEpochStore,
)

# --- helpers -------------------------------------------------------------------


def _boards_equal(port_board, ref_board, msg=""):
    port = convert.vote_board_to_numpy(port_board)
    ref = jax.device_get(ref_board)
    for name in tq.VoteBoard._fields:
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=f"{name} {msg}")


def _mid_flight(rng, n: int, window: int):
    """Equal port and JAX boards with vote bytes 0-2, rounds -1..3, some
    chosen bits and owners up to two windows of slots."""
    arrays = (rng.integers(0, 3, size=(n, window), dtype=np.uint8),
              rng.integers(-1, 4, size=window).astype(np.int32),
              rng.random(window) < 0.2,
              rng.integers(-1, 2 * window, size=window).astype(np.int32))
    port = tq.VoteBoard(*(torch.from_numpy(a.copy()) for a in arrays))
    ref = jq.VoteBoard(*(jnp.asarray(a) for a in arrays))
    return port, ref


def _jax_config(flexible=False):
    port = tracker_lt.make_config(flexible)
    fields = {f: getattr(port, f) for f in (
        "f", "batcher_addresses", "read_batcher_addresses",
        "leader_addresses", "leader_election_addresses",
        "proxy_leader_addresses", "acceptor_addresses",
        "replica_addresses", "proxy_replica_addresses", "flexible")}
    return JMultiPaxosConfig(**fields,
                             distribution_scheme=JDistributionScheme.HASH)


# --- (a) the run form's plain version against _record_block ------------------

#: (name, port spec, JAX spec): majorities of 1-17 acceptors and grids.
RUN_SPECS = [(f"majority{n}", SimpleMajority(range(n)).write_spec(),
              JSimpleMajority(range(n)).write_spec()) for n in range(1, 18)]
RUN_SPECS += [
    ("grid2x3_write", Grid([[0, 1, 2], [3, 4, 5]]).write_spec(),
     JGrid([[0, 1, 2], [3, 4, 5]]).write_spec()),
    ("grid_perm_write", Grid([[0, 2, 4], [1, 3, 5]]).write_spec(),
     JGrid([[0, 2, 4], [1, 3, 5]]).write_spec()),
    ("grid2x3_read", Grid([[0, 1, 2], [3, 4, 5]]).read_spec(),
     JGrid([[0, 1, 2], [3, 4, 5]]).read_spec()),
]
#: A window that does not divide 2^31, so that slot ids cross 2^31 - 1
#: inside a block; block widths around the 16-column grid.
RUN_WINDOW = 1000
RUN_WIDTHS = (1, 16, 37, 64, 200)


def _run_blocks(rng, window: int, step: int) -> tuple:
    """``(columns, true starts, widths, rounds)`` of one run: 1-5 blocks
    at random columns (the last one at the ring end on even steps), slot
    numbers small (random owners go stale), large (they claim) or across
    the int32 wrap, by step; on odd steps the first block again in a
    newer round (an overlap: another launch)."""
    kind = step % 3
    cols, trues, widths = [], [], []
    at = int(rng.integers(0, window // 2))
    for k in range(int(rng.integers(1, 6))):
        width = int(rng.choice(RUN_WIDTHS))
        col = at + int(rng.integers(0, 20))
        if col + width > window or (k == 0 and step % 2 == 0):
            col = window - width
        true = (col + int(rng.integers(0, 2)) * window if kind == 0
                else col + window * int(rng.integers(3, 1000)) if kind == 1
                else 2**31 - 1 - width // 2)
        cols.append(col)
        trues.append(true)
        widths.append(width)
        at = (col + width) % window
    rounds = [int(r) for r in rng.integers(0, 3, size=len(cols))]
    if step % 2:
        cols.append(cols[0])
        trues.append(trues[0])
        widths.append(widths[0])
        rounds.append(rounds[0] + 1)
    return cols, trues, widths, rounds


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", RUN_SPECS, ids=[c[0] for c in RUN_SPECS])
def test_record_block_run_plain_matches_reference(case, seed):
    _, spec, ref_spec = case
    n = spec.num_nodes
    rng = np.random.default_rng(1000 * seed + n)
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    masks_t, meta = jq._spec_statics(ref_spec)
    board, ref = _mid_flight(rng, n, RUN_WINDOW)
    overlaps = wraps = ends = 0
    for step in range(6):
        cols, trues, widths, rounds = _run_blocks(rng, RUN_WINDOW, step)
        table, stride = tq.run_table(cols, widths, rounds, RUN_WINDOW, trues)
        blocks = (rng.integers(0, 256, size=(n, stride), dtype=np.uint8)
                  if step % 3 == 1 else
                  (rng.random((n, stride)) < 0.6).astype(np.uint8))
        blocks[:, :1] = 2  # a byte whose low bit is 0
        blocks[:, -1:] = 255
        got = tq.record_block_run_plain(board, table,
                                        torch.from_numpy(blocks), pred)
        for col, true, width, at, rnd, _ in table.tolist():
            ref, want = jq._record_block(
                ref, jnp.int32(col), jnp.int32(true),
                jnp.asarray(blocks[:, at:at + width]), jnp.int32(rnd),
                width, masks_t, meta)
            np.testing.assert_array_equal(got[at:at + width].numpy(),
                                          np.asarray(want), err_msg=str(step))
        assert table[:, 3].tolist() == list(np.cumsum([0] + widths[:-1]))
        assert stride == sum(widths)
        overlaps += int(table[1:, 5].sum())
        wraps += any(t + w > 2**31 for t, w in zip(trues, widths))
        ends += int(((table[:, 0] + table[:, 2]) == RUN_WINDOW).any())
        _boards_equal(board, ref, str(step))
    assert overlaps and wraps and ends


def test_run_table_starts_a_launch_at_an_overlap_and_past_the_cap():
    """A block that shares a column with a block of the current launch
    starts a new one (the kernel's blocks run in parallel); so does the
    block past MAX_RUN_BLOCKS; disjoint blocks share one launch, modulo
    the window (a block whose slots lie a window on shares columns)."""
    table, stride = tq.run_table([0, 64, 128, 64 + 256, 96, 192],
                                 [64] * 6, [0] * 6, 256)
    assert table[:, 5].tolist() == [1, 0, 0, 1, 1, 0]
    assert table[:, 0].tolist() == [0, 64, 128, 64, 96, 192]
    assert table[:, 1].tolist() == [0, 64, 128, 320, 96, 192]
    assert table[:, 3].tolist() == [0, 64, 128, 192, 256, 320]
    assert stride == 384
    many = tq.MAX_RUN_BLOCKS + 3
    table, _ = tq.run_table([2 * k for k in range(many)], [1] * many,
                            [0] * many, 1 << 12)
    assert table[:, 5].tolist() == ([1] + [0] * (tq.MAX_RUN_BLOCKS - 1)
                                    + [1, 0, 0])
    with pytest.raises(ValueError, match="outside the window"):
        tq.run_table([250], [10], [0], 256)


@pytest.mark.parametrize("case", RUN_SPECS[:3] + RUN_SPECS[-3:],
                         ids=[c[0] for c in RUN_SPECS[:3] + RUN_SPECS[-3:]])
def test_dense_run_matches_reference_record_block(case):
    """``TpuQuorumChecker.dense_run`` (the tracker's call) against the JAX
    checker's ``record_block`` on each block in order: per-block newly,
    boards, window violations; spans at the ring end, a span a window
    behind (a violation, which overlaps: two launches)."""
    _, spec, ref_spec = case
    rng = np.random.default_rng(5)
    window = 256
    port = tq.TpuQuorumChecker(spec, window=window, device="cpu")
    ref = jq.TpuQuorumChecker(ref_spec, window=window)
    frontier = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for step in range(10):
            spans = []
            for _ in range(int(rng.integers(1, 4))):
                width = int(rng.choice((1, 17, 64)))
                start = frontier + int(rng.integers(0, 10))
                if start % window + width > window:
                    start += window - start % window
                spans.append((start, width, int(rng.integers(0, 2))))
                frontier = start + width
            if step % 4 == 3 and spans[0][0] >= window:
                # A window behind: a violation on the first block's
                # columns (another launch).
                spans.append((spans[0][0] - window, spans[0][1], 0))
            blocks = [(rng.random((spec.num_nodes, w)) < 0.6).astype(
                np.uint8) for _, w, _ in spans]
            run = port.dense_run(spans)
            for off, (_, w, _), blk in zip(run.offsets, spans, blocks):
                run.block[:, off:off + w] = blk
            newly = run.dispatch().wait()
            for off, (start, w, rnd), blk in zip(run.offsets, spans, blocks):
                want = ref.record_block(start, blk, rnd)
                np.testing.assert_array_equal(newly[off:off + w], want,
                                              err_msg=str(step))
            _boards_equal(port.board, ref.board, str(step))
            assert port.window_violations == ref.window_violations
    assert port.window_violations


# --- (b) the staged entries, modelled --------------------------------------------


def _ints(block: bytes, n: int) -> tuple:
    return struct.unpack(f"={n}q", block)


def _at(address: int, count: int, dtype) -> np.ndarray:
    """``count`` elements of ``dtype`` at a host address, as a view."""
    dtype = np.dtype(dtype)
    raw = (ctypes.c_uint8 * (count * dtype.itemsize)).from_address(address)
    return np.frombuffer(raw, dtype=dtype)


class FakeEvents:
    """Events by number: recorded (pending) by a run, complete once
    waited on."""

    def __init__(self):
        self.made, self.pending, self.waits = 0, set(), []

    def create(self) -> int:
        self.made += 1
        return self.made

    def wait(self, handle: int) -> None:
        self.waits.append(handle)
        self.pending.discard(handle)

    def destroy(self, handle: int) -> None:
        self.pending.discard(handle)


def fake_alloc(nbytes: int):
    """A "pinned" and a "device" buffer, both host numpy arrays."""
    host, dev = np.zeros(nbytes, np.uint8), np.zeros(nbytes, np.uint8)
    return host, host.ctypes.data, dev.ctypes.data, (host, dev)


class FakeStaging:
    """``_build.Staging`` on host numpy arrays of each pair's dtype."""

    index, stream_handle = 0, 0

    def __init__(self):
        self.pairs = {}

    def pair(self, name, n, dtype):
        got = self.pairs.get(name)
        if got is None or got.cap < n:
            cap = 1 << max(5, (n - 1).bit_length())
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            host, dev = np.zeros(cap, np_dtype), np.zeros(cap, np_dtype)
            got = self.pairs[name] = _build.Pair(
                cap, host, host.ctypes.data, dev.ctypes.data, (host, dev))
        return got


class Model:
    """The three staged entries of a checker, modelled: each call is
    recorded (its unpacked block) in ``calls``."""

    def __init__(self, checker, events: FakeEvents):
        self.checker, self.events, self.calls = checker, events, []

    def k2_run(self, block) -> int:
        a = _ints(block, 29)
        c = self.checker
        assert a[:6] == tq._board_ptrs(c._board)
        n, nb, held, off, stride = a[5], a[7], a[10], a[11], a[12]
        event = a[26]
        # The host may write a slot only when its last run was waited on.
        assert event not in self.events.pending, "slot written in flight"
        assert off % 16 == 0 and off >= 4 * held
        table = _at(a[6], nb * tq.RUN_FIELDS, np.int32).reshape(
            nb, tq.RUN_FIELDS).copy()
        host_in = _at(a[8], off + n * stride, np.uint8)
        dev_in = _at(a[9], off + n * stride, np.uint8)
        dev_in[:] = host_in
        slots = dev_in[:4 * held].view(np.int32)
        if held:
            tq.release_all_plain(c._board, torch.from_numpy(slots.copy()))
        blocks = torch.from_numpy(dev_in[off:].reshape(n, stride).copy())
        newly = tq.record_block_run_plain(c._board, table, blocks, c._pred)
        _at(a[13], stride, np.uint8)[:] = newly.numpy()
        _at(a[14], a[15], np.uint8)[:] = _at(a[13], a[15], np.uint8)
        self.events.pending.add(event)
        self.calls.append(("k2", table, slots.copy(), blocks.numpy(), a))
        return 0

    def k5_flush(self, block) -> int:
        a = _ints(block, 11)
        c = self.checker
        assert a[:6] == tq._board_ptrs(c._board)
        slots = _at(a[6], a[8], np.int32).copy()
        _at(a[7], a[8], np.int32)[:] = slots
        tq.release_all_plain(c._board, torch.from_numpy(slots))
        self.calls.append(("k5", slots))
        return 0

    def k6_run(self, block) -> int:
        a = _ints(block, 22)
        c = self.checker
        b, held = a[7], a[21]
        lanes = _at(a[19], 5 * b + held, np.int32).copy()
        if held:
            tq.release_all_plain(c._board, torch.from_numpy(lanes[5 * b:]))
        newly = tq.record_and_check_epochs_run_plain(
            c._board, torch.from_numpy(lanes[:5 * b].reshape(5, b).copy()),
            c._boundaries, c.planes, a[8])
        _at(a[20], b, np.uint8)[:] = newly.numpy()
        self.calls.append(("k6", lanes[5 * b:].copy(), a))
        return 0


@pytest.fixture
def staged(monkeypatch):
    """``make(checker)``: the checker's staged paths on fakes (a ring of
    numpy slots, fake events, a fake staging, the modelled entries);
    returns its Model."""
    monkeypatch.setattr(_build, "stream_handle", lambda index: 0)
    for wrapper in (tq.record_block, tq.release,
                    tq.record_and_check_epochs):
        monkeypatch.setattr(wrapper, "launches", 0)
    models = []

    def make(checker):
        events = FakeEvents()
        model = Model(checker, events)
        checker._staged = True
        checker._staging = FakeStaging()
        if isinstance(checker, tq.TpuQuorumChecker):
            checker._ring = tq.RunRing(fake_alloc, events)
            checker._ring_index = 0
        monkeypatch.setattr(tq._K2_STAGED, "fn", model.k2_run)
        monkeypatch.setattr(tq._K5_STAGED, "fn", model.k5_flush)
        monkeypatch.setattr(tq._K6_STAGED, "fn", model.k6_run)
        models.append(model)
        return model

    return make


@pytest.mark.parametrize("seed", range(3))
def test_staged_run_packs_what_the_plain_checker_sees(staged, seed):
    """Runs of 1-4 blocks with releases held before them and a K4 call
    between runs: the staged path's newly and board equal a plain CPU
    checker's; each run is ONE entry call carrying the held slots at the
    head of its in-block, the blocks side by side at the table's
    offsets (zeros elsewhere), newly copied down in full; the flush entry
    runs once before each K4 call that finds releases held."""
    spec = SimpleMajority(range(3)).write_spec()
    rng = np.random.default_rng(40 + seed)
    card = tq.TpuQuorumChecker(spec, window=1 << 16, device="cpu")
    model = staged(card)
    host = tq.TpuQuorumChecker(spec, window=1 << 16, device="cpu")
    frontier, held_total, runs, flushes = 0, 0, 0, 0
    for step in range(12):
        spans, at = [], frontier
        for _ in range(int(rng.integers(1, 5))):
            width = int(rng.choice((64, 256, 1024)))
            spans.append((at, width, int(rng.integers(0, 2))))
            at += width + int(rng.integers(0, 30))
        fills = [(rng.random((3, w)) < 0.6).astype(np.uint8)
                 for _, w, _ in spans]
        released = [np.arange(frontier - 700, frontier - 700
                              + int(rng.integers(1, 40)))
                    for _ in range(int(rng.integers(0, 3)))]
        out = []
        for c in (card, host):
            for slots in released:
                c.release(slots)
            run = c.dense_run(spans)
            for (_, w, _), fill, off in zip(spans, fills, run.offsets):
                run.block[:, off:off + w] = fill
            res = run.dispatch()
            out.append([res.wait()[o:o + w].copy()
                        for o, (_, w, _) in zip(run.offsets, spans)])
            res.free()
        for got, want in zip(*out):
            np.testing.assert_array_equal(got, want)
        kind, table, slots, blocks, a = model.calls[-1]
        runs += 1
        assert kind == "k2" and len(model.calls) == runs + flushes
        want_held = np.concatenate(released) % (1 << 16) if released \
            else np.zeros(0)
        np.testing.assert_array_equal(slots, want_held)
        held_total += slots.size
        widths = [w for _, w, _ in spans]
        assert table[:, 3].tolist() == list(np.cumsum([0] + widths[:-1]))
        assert a[12] == a[15] == sum(widths)
        expect = np.zeros_like(blocks)
        for off, fill in zip(table[:, 3], fills):
            expect[:, off:off + fill.shape[1]] = fill
        np.testing.assert_array_equal(blocks, expect)
        if step % 3 == 2:
            for c in (card, host):
                c.release(np.arange(frontier, frontier + 8))
            flushes += 1
            lanes = (frontier + np.arange(16), np.zeros(16, np.int32))
            np.testing.assert_array_equal(card.record_and_check(*lanes),
                                          host.record_and_check(*lanes))
            assert model.calls[-1][0] == "k5"
            np.testing.assert_array_equal(
                model.calls[-1][1], np.arange(frontier, frontier + 8))
        _boards_equal(card.board, jq.VoteBoard(*(
            jnp.asarray(t.numpy()) for t in host.board)))
        frontier = at
    assert tq.record_block.launches == runs
    assert tq.release.launches == flushes + sum(
        1 for c in model.calls if c[0] == "k2" and c[2].size)
    assert held_total


@pytest.mark.parametrize("lag", [0, 1, 2, 5])
def test_ring_reuses_a_slot_only_after_its_event(staged, lag):
    """A collector that lags ``lag`` dispatches behind (more than the
    ring's initial slots for lag 5): no slot is written while its run
    may be in flight (the model asserts it), the ring grows to
    ``max(lag + 1, INITIAL)`` slots and no further, every result reads
    back the plain checker's newly, and each event is waited once."""
    spec = SimpleMajority(range(3)).write_spec()
    card = tq.TpuQuorumChecker(spec, window=1 << 12, device="cpu")
    model = staged(card)
    host = tq.TpuQuorumChecker(spec, window=1 << 12, device="cpu")
    rng = np.random.default_rng(lag)
    pending = []
    for d in range(12):
        fill = (rng.random((3, 64)) < 0.7).astype(np.uint8)
        run = card.dense_run([(d * 64, 64, 0)])
        run.block[:, :64] = fill
        pending.append((run.dispatch(), host.record_block(d * 64, fill)))
        while len(pending) > lag:
            res, want = pending.pop(0)
            np.testing.assert_array_equal(res.wait()[:64], want)
            res.free()
    for res, want in pending:
        np.testing.assert_array_equal(res.wait()[:64], want)
        res.free()
    assert len(card._ring.slots) == max(lag + 1, tq.RunRing.INITIAL)
    assert len(model.events.waits) == 12
    assert not model.events.pending


def test_ring_hands_out_the_oldest_free_slot():
    """Every slot in flight: the ring inserts a new slot at its cursor,
    so that the oldest dispatch stays next in turn; a freed slot is
    handed out again in ring order."""
    events = FakeEvents()
    ring = tq.RunRing(fake_alloc, events)
    taken = [ring.take(100, 10) for _ in range(5)]
    assert len(ring.slots) == 5 and len({id(s) for s in taken}) == 5
    assert [s.event for s in ring.slots] == [1, 2, 5, 4, 3] or \
        len({s.event for s in ring.slots}) == 5
    taken[0].busy = False
    assert ring.take(100, 10) is taken[0]
    again = ring.take(5000, 10)
    assert again not in taken[:1] and again.in_cap >= 5000
    assert all(s.busy for s in ring.slots)


@pytest.mark.parametrize("seed", range(2))
def test_epoch_staged_entry_carries_the_held_releases(staged, seed):
    """EpochSegmentedChecker's staged drain with releases held before
    it: ONE entry call a drain, the held slots after its lanes, and
    newly and the board equal to a plain CPU checker's."""
    rng = np.random.default_rng(60 + seed)
    specs = [SimpleMajority(m).write_spec() for m in ((0, 1, 2), (0, 1, 3))]
    card = tq.EpochSegmentedChecker(specs, [0, 600], window=1024,
                                    device="cpu")
    model = staged(card)
    host = tq.EpochSegmentedChecker(specs, [0, 600], window=1024,
                                    device="cpu")
    for drain in range(8):
        slots = drain * 100 + rng.integers(0, 200, size=600)
        nodes = rng.integers(0, 4, size=600).astype(np.int32)
        released = drain * 100 - 150 + np.arange(int(rng.integers(0, 30)))
        for c in (card, host):
            if released.size:
                c.release(released)
        got = card.record_and_check_run(slots, nodes, None)
        want = host.record_and_check_run(slots, nodes, None)
        np.testing.assert_array_equal(got, want)
        kind, held, a = model.calls[-1]
        assert kind == "k6" and len(model.calls) == drain + 1
        np.testing.assert_array_equal(held, released % 1024)
        assert a[21] == released.size
        _boards_equal(card.board, jq.VoteBoard(*(
            jnp.asarray(t.numpy()) for t in host.board)))


# --- (c) the pipelined tracker through the staged dense path -----------------


@pytest.mark.parametrize("mode", ["staged", "plain"])
def test_pipelined_tracker_matches_reference_and_oracle(staged, mode):
    """tracker_lt's stream (stragglers, duplicates, leader changes) at a
    small size: the port's pipelined tracker (its dense blocks ONE staged
    run a drain, modelled; or the plain run) reports, drain by drain,
    what the JAX ``TpuQuorumTracker(pipelined=True)`` reports and, in
    all, the dict oracle's pairs, each once: a slot an older round
    completed is never reported again for it."""
    config = tracker_lt.make_config()
    stream = tracker_lt.make_stream(1 << 13, 3, drain=512, seed=9)
    oracle = tracker_lt.replay(qt.DictQuorumTracker(config), stream, 3)
    port = qt.TpuQuorumTracker(config, window=1 << 12, pipelined=True,
                               device="cpu")
    model = staged(port.checker) if mode == "staged" else None
    ref = jqt.TpuQuorumTracker(_jax_config(), window=1 << 12,
                               pipelined=True)
    got_all = []
    seen = many = 0
    for d, events in enumerate(stream):
        for t in (port, ref):
            tracker_lt.replay(t, [events], 3)
        got, want = [], []
        while (x := port.take_dispatch()) is not None:
            got.extend(port.collect(x))
        while (x := ref.take_dispatch()) is not None:
            want.extend(ref.collect(x))
        assert sorted(got) == sorted(want), d
        got_all.extend(got)
        if model is not None:
            # One run a drain; a second only where the drain's blocks
            # meet the ring end and a sub-bucket remainder takes the
            # scatter between them.
            runs = sum(c[0] == "k2" for c in model.calls)
            ends = [e[2] if e[0] == "range" else e[1] + 1 for e in events]
            firsts = [e[1] for e in events]
            crosses = min(firsts) // (1 << 12) != (max(ends) - 1) // (1 << 12)
            assert runs - seen <= (2 if crosses else 1), d
            many += runs - seen > 1
            seen = runs
    tracker_lt.check_against_oracle("pipelined", got_all, oracle)
    if model is not None:
        assert not model.events.pending and many <= 2
        assert len(port.checker._ring.slots) == tq.RunRing.INITIAL


# --- (d) held releases against the JAX package's immediate ones ----------------


@pytest.mark.parametrize("seed", range(3))
def test_checker_held_releases_match_reference(seed):
    """TpuQuorumChecker: releases between board calls of every kind (K2
    single and run, K4, a reshape, the stateless checks), several in a
    row, a released slot voted again a window on: outputs and boards
    equal the JAX checker's, which releases at once."""
    rng = np.random.default_rng(80 + seed)
    window = 256
    port = tq.TpuQuorumChecker(SimpleMajority(range(3)).write_spec(),
                               window=window, device="cpu")
    ref = jq.TpuQuorumChecker(JSimpleMajority(range(3)).write_spec(),
                              window=window)
    frontier = 0
    for step in range(16):
        releases = int(rng.integers(0, 3))
        for _ in range(releases):
            slots = frontier - rng.integers(0, 64, size=int(
                rng.integers(1, 9)))
            port.release(slots)
            ref.release(slots)
        kind = step % 5
        if kind == 0:
            block = (rng.random((3, 64)) < 0.7).astype(np.uint8)
            start = frontier - frontier % window + window \
                if frontier % window + 64 > window else frontier
            np.testing.assert_array_equal(port.record_block(start, block),
                                          ref.record_block(start, block))
            frontier = start + 64
        elif kind == 1:
            slots = frontier - rng.integers(0, 80, size=40) + window
            cols = rng.integers(0, 3, size=40)
            np.testing.assert_array_equal(
                port.record_and_check(slots, cols),
                ref.record_and_check(slots, cols))
        elif kind == 2:
            present = (rng.random((8, 3)) < 0.6).astype(np.uint8)
            np.testing.assert_array_equal(port.check_batch(present),
                                          ref.check_batch(present))
            # The stateless checks read no board: nothing is flushed.
            assert len(port._held) == releases
        elif kind == 3:
            block = (rng.random((3, 32)) < 0.7).astype(np.uint8)
            run = port.dense_run([(frontier, 32, 1)])
            run.block[:, :32] = block
            got = run.dispatch().wait()[:32]
            start = frontier
            np.testing.assert_array_equal(got, ref.record_block(start, block,
                                                                1))
            frontier += 32
        else:
            spec = SimpleMajority(range(3)).write_spec()
            port.reshape(spec)
            ref.reshape(JSimpleMajority(range(3)).write_spec())
        if step % 4 == 3:
            _boards_equal(port.board, ref.board, str(step))
            assert not port._held
    port.release([frontier - 1])
    ref.release([frontier - 1])
    port.flush_releases()
    assert not port._held
    _boards_equal(port.board, ref.board)


@pytest.mark.parametrize("seed", range(2))
def test_epoch_tracker_held_releases_match_reference(seed):
    """EpochQuorumTracker: releases between drains (several between two,
    a released slot voted again a window on in the next drain, a release
    before an epoch that widens the universe, i.e. K7's reshape): the
    reports, drain by drain, and the boards equal the JAX tracker's."""
    rng = np.random.default_rng(90 + seed)
    members = (("a0", "a1", "a2"), ("a0", "a1", "a3"))
    window = 512
    port_store = EpochStore.from_members(members[0], f=1)
    ref_store = JEpochStore.from_members(members[0], f=1)
    port = EpochQuorumTracker(port_store, backend="cuda", window=window,
                              device="cpu")
    ref = JEpochQuorumTracker(ref_store, backend="tpu", window=window)
    chosen: list = []
    for drain in range(10):
        if drain == 5:
            for t, st, cls in ((port, port_store, EpochConfig),
                               (ref, ref_store, JEpochConfig)):
                t.release(np.asarray(chosen[-20:], np.int64))
                st.add(cls(epoch=1, start_slot=700, f=1,
                           members=members[1]))
                t.note_epochs()
        for _ in range(int(rng.integers(1, 4))):
            if chosen:
                slots = np.asarray(chosen[-int(rng.integers(1, 10)):],
                                   np.int64)
                for t in (port, ref):
                    t.release(slots)
        base = drain * 120
        for slot in range(base, base + 120):
            mem = members[slot >= 700]
            for acc in rng.choice(3, size=2, replace=False):
                for t in (port, ref):
                    t.record(slot, 0, mem[acc])
        for slot in chosen[-5:]:
            for acc in range(2):  # a released slot, a window on
                for t in (port, ref):
                    t.record(slot + window, 0, members[
                        slot + window >= 700][acc])
        got, want = port.drain(), ref.drain()
        assert got == want, drain
        chosen.extend(s for s, _ in got)
        _boards_equal(port._checker.board, ref._checker.board, str(drain))


@pytest.mark.parametrize("seed", range(2))
def test_geo_tracker_held_releases_match_reference(seed):
    """GeoQuorumTracker, as the WPaxos leaders call it (a release of the
    slots a watermark advance passed, then the next drain): reports and
    boards equal the JAX tracker's, with one and several releases
    between drains and a released slot voted again a window on."""
    from frankenpaxos_tpu_torch.geo import GeoQuorumTracker, ObjectEpochStore
    from frankenpaxos_tpu_torch.quorums import ZoneGrid

    from frankenpaxos_tpu import geo as jgeo
    from frankenpaxos_tpu.geo import epochs as jepochs
    from frankenpaxos_tpu.quorums import ZoneGrid as JZoneGrid

    rows = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    window = 256
    port = GeoQuorumTracker(ObjectEpochStore(1, [0]), 0, ZoneGrid(rows),
                            backend="cuda", window=window, device="cpu")
    ref = jgeo.GeoQuorumTracker(jepochs.ObjectEpochStore(1, [0]), 0,
                                JZoneGrid(rows), backend="tpu",
                                window=window)
    rng = np.random.default_rng(70 + seed)
    released_to = 0
    for drain in range(12):
        for _ in range(int(rng.integers(0, 3))):
            top = min(released_to + int(rng.integers(1, 4)), drain * 20)
            slots = np.arange(released_to, top)
            released_to = max(released_to, top)
            for t in (port, ref):
                t.release(slots)
        for _ in range(int(rng.integers(20, 60))):
            slot = drain * 20 + int(rng.integers(0, 30))
            if rng.random() < 0.1 and released_to:
                slot = int(rng.integers(0, released_to)) + window
            acceptor = rows[0][int(rng.integers(0, 3))]
            for t in (port, ref):
                t.record(slot, 1, acceptor)
        assert port.drain() == ref.drain(), drain
        _boards_equal(port._checker.board, ref._checker.board, str(drain))
