"""K4's run of sparse chunks, the pipelined drain's one staged call and
K19's lean entry and forms, against the JAX package (JAX on the CPU).

(a) ``record_and_check_run_plain`` (the plain version of K4's run
kernel: ``record_and_check_plain`` on each chunk in order) against the
JAX package's ``_record_and_check`` applied chunk by chunk: majorities of
1-17 acceptors (16 register forms and the runtime loop), the 2x3 and 3x3
grids (write and read, one permuted) and WPaxos's zone grid, on
mid-flight boards, with duplicate slots inside and across chunks,
reclaims, preemption, negative and out-of-range slots and nodes, true
slots across 2^31 - 1 (the int32 wrap), pad lanes, and runs of 1, 4 and
48 chunks.
(b) The K4 wrappers on the CPU, and their kernel path forced on CPU
tensors with the C entry stood in for: the packed block and the launches
(one per ``MAX_RUN_CHUNKS`` chunks that hold a lane).
(c) The drain's staged entry (``fpx_board_run_staged``), with the C
function stood in for by a Python model of its packed block (the
in-block, the segment table, K2's table and the chunk bounds read from
their addresses, the plain versions on the board segment by segment,
both ``newly`` copied down, the event pending until waited on): segment
order, the held releases at the head of the in-block and applied first,
the dense block and the lanes at their offsets, ONE call a dispatch, a
ring slot written again only after its event was waited on (a collector
lagging five dispatches), and a checker on the CPU's results and board.
(d) The pipelined tracker on drains that carry older-round, newer-round
and leftover scatter votes, bursts of several chunks with duplicates,
and a ring-end remainder between two dense runs, against the JAX
``TpuQuorumTracker(pipelined=True)`` drain by drain and the dict oracle:
through the modelled staged entry (one call a drain) and the plain path.
(e) K19-K21's lean entries packing their C blocks (a monkeypatched
library), and the form K19 runs on each mesh of
``tests/test_torch_multichip.py`` and the multichip benches.

The CUDA kernels and entries are held against the plain versions on the
H100 by ``chip_smoke.py`` (phases 6 and 25).
"""

import ctypes
import struct

from frankenpaxos_tpu_torch import convert
from frankenpaxos_tpu_torch.bench import pipeline as tp, tracker_lt
from frankenpaxos_tpu_torch.mesh import Mesh
from frankenpaxos_tpu_torch.ops import _build, quorum as tq
from frankenpaxos_tpu_torch.protocols.multipaxos import quorum_tracker as qt
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority, ZoneGrid
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
    ZoneGrid as JZoneGrid,
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


def _ints(block: bytes, n: int) -> tuple:
    return struct.unpack(f"={n}q", block)


def _at(address: int, count: int, dtype) -> np.ndarray:
    """``count`` elements of ``dtype`` at a host address, as a view."""
    dtype = np.dtype(dtype)
    if not count:
        return np.zeros(0, dtype=dtype)
    raw = (ctypes.c_uint8 * (count * dtype.itemsize)).from_address(address)
    return np.frombuffer(raw, dtype=dtype)


# --- (a) K4's run, plain, against _record_and_check chunk by chunk -------------

#: (name, port spec, JAX spec): majorities of 1-17 acceptors, grids, and
#: the zone grid (three groups of two of three).
ROWS3 = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
SPARSE_SPECS = [(f"majority{n}", SimpleMajority(range(n)).write_spec(),
                 JSimpleMajority(range(n)).write_spec())
                for n in range(1, 18)]
SPARSE_SPECS += [
    ("grid2x3_write", Grid([[0, 1, 2], [3, 4, 5]]).write_spec(),
     JGrid([[0, 1, 2], [3, 4, 5]]).write_spec()),
    ("grid2x3_read", Grid([[0, 1, 2], [3, 4, 5]]).read_spec(),
     JGrid([[0, 1, 2], [3, 4, 5]]).read_spec()),
    ("grid_perm_write", Grid([[0, 2, 4], [1, 3, 5]]).write_spec(),
     JGrid([[0, 2, 4], [1, 3, 5]]).write_spec()),
    ("grid3x3_write", Grid(ROWS3).write_spec(), JGrid(ROWS3).write_spec()),
    ("grid3x3_read", Grid(ROWS3).read_spec(), JGrid(ROWS3).read_spec()),
    ("zone_grid", ZoneGrid(ROWS3).write_spec(),
     JZoneGrid(ROWS3).write_spec()),
]
#: A window that does not divide 2^31, so that true slots cross 2^31 - 1.
SPARSE_WINDOW = 1000
#: Lanes a chunk (the last chunk of a run ragged).
SPARSE_CHUNK = 64
RUN_LENGTHS = (1, 4, 48)


def _chunk_lanes(rng, n: int, frontier: int, b: int, kind: int,
                 kinds: dict) -> np.ndarray:
    """One chunk of ``b`` lanes (``kind`` 0: slots near the frontier; 1:
    a window ahead, reclaiming; 2: true slots across 2^31 - 1): duplicate
    slots, rounds 0-3, nodes and slots out of range and pad lanes."""
    window = SPARSE_WINDOW
    if kind == 2:
        true = (2**31 - 1 - b // 2 + rng.integers(0, b, size=b)) \
            .astype(np.int64)
    else:
        true = frontier - rng.integers(0, 3 * b, size=b) \
            + (window if kind == 1 else 0)
        true = np.maximum(true, 0)
    true[rng.integers(0, b, size=b // 4)] = true[0]
    nodes = rng.integers(0, n, size=b)
    odd = rng.random(b) < 0.05
    nodes[odd] = rng.integers(-n - 2, n + 2, size=int(odd.sum()))
    rounds = rng.integers(0, 4, size=b)
    valid = np.ones(b, dtype=bool)
    pad = int(rng.integers(0, b // 8 + 1))
    if pad:
        valid[-pad:] = False
        true[-pad:] = 0
    slots = true % window
    far = (rng.random(b) < 0.05) & valid
    slots[far] += rng.choice([-2, -1, 1], size=int(far.sum())) * window
    kinds["dup"] += int(len(np.unique(true[valid])) < int(valid.sum()))
    kinds["wrap"] += int((true > 2**31 - 1).any())
    kinds["node"] += int(odd.any())
    kinds["slot"] += int(far.any())
    kinds["pad"] += int(pad > 0)
    return tq.pack_lanes(slots, true, nodes, rounds, valid)


@pytest.mark.parametrize("case", SPARSE_SPECS,
                         ids=[c[0] for c in SPARSE_SPECS])
def test_record_and_check_run_plain_matches_reference(case):
    name, spec, ref_spec = case
    n = spec.num_nodes
    rng = np.random.default_rng(7 * n + len(name))
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    masks_t, meta = jq._spec_statics(ref_spec)
    board, ref = _mid_flight(rng, n, SPARSE_WINDOW)
    kinds = dict.fromkeys(("dup", "wrap", "node", "slot", "pad"), 0)
    frontier, across = SPARSE_WINDOW // 2, 0
    for step, chunks in enumerate(RUN_LENGTHS):
        sizes = [SPARSE_CHUNK] * (chunks - 1) + [37 if chunks > 1 else 64]
        parts = []
        for k, b in enumerate(sizes):
            frontier += int(rng.integers(0, 2 * b))
            parts.append(_chunk_lanes(rng, n, frontier, b, (step + k) % 3,
                                      kinds))
        lanes = np.concatenate(parts, axis=1)
        bounds = tq.chunk_bounds(sizes)
        got = tq.record_and_check_run_plain(board, torch.from_numpy(lanes),
                                            bounds, pred).numpy()
        for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            ref, want = jq._record_and_check(
                ref, *(jnp.asarray(row) for row in lanes[:, lo:hi]),
                masks_t, meta)
            np.testing.assert_array_equal(got[lo:hi], np.asarray(want),
                                          err_msg=f"run {step} chunk {k}")
        # A slot of one chunk named again by a later chunk of the run.
        across += int(len(np.intersect1d(lanes[1, :bounds[1]],
                                          lanes[1, bounds[1]:])) > 0)
        _boards_equal(board, ref, f"run {step}")
    assert all(kinds.values()) and across, kinds


def test_run_of_one_chunk_is_record_and_check():
    """``record_and_check`` is K4's run of one chunk: equal newly and
    boards; an empty chunk in a run changes nothing and reports
    nothing; lanes outside every chunk report False."""
    rng = np.random.default_rng(3)
    spec = SimpleMajority(range(3)).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    a, _ = _mid_flight(rng, 3, SPARSE_WINDOW)
    b = tq.VoteBoard(*(t.clone() for t in a))
    kinds = dict.fromkeys(("dup", "wrap", "node", "slot", "pad"), 0)
    lanes = torch.from_numpy(_chunk_lanes(rng, 3, 600, 100, 0, kinds))
    np.testing.assert_array_equal(
        tq.record_and_check(a, lanes, pred).numpy(),
        tq.record_and_check_run(b, lanes, np.array([0, 100]), pred).numpy())
    got = tq.record_and_check_run(b, lanes, np.array([10, 10, 40]), pred)
    assert not got[:10].any() and not got[40:].any()
    want = tq.record_and_check(a, lanes[:, 10:40].contiguous(), pred)
    np.testing.assert_array_equal(got[10:40].numpy(), want.numpy())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="nondecreasing"):
        tq.record_and_check_run(b, lanes, np.array([0, 50, 40]), pred)
    with pytest.raises(ValueError, match="nondecreasing"):
        tq.record_and_check_run(b, lanes, np.array([0, 101]), pred)


def test_pad_lanes_change_nothing_in_a_run():
    """The run takes the tracker's chunks unpadded: the same chunks with
    their pad lanes (slot 0, valid 0) give the same board and the same
    newly on the real lanes."""
    rng = np.random.default_rng(4)
    spec = SimpleMajority(range(3)).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    a, _ = _mid_flight(rng, 3, SPARSE_WINDOW)
    b = tq.VoteBoard(*(t.clone() for t in a))
    sizes = [30, 64, 5]
    real = [tq.pack_lanes(*(lambda s: (s % SPARSE_WINDOW, s,
                                       rng.integers(0, 3, size=k),
                                       rng.integers(0, 2, size=k),
                                       np.ones(k, bool)))(
        rng.integers(1, 1500, size=k)), size=k) for k in sizes]
    padded = [tq.pack_lanes(*lanes, size=64) for lanes in real]
    got = tq.record_and_check_run(a, torch.from_numpy(
        np.concatenate(real, axis=1)), tq.chunk_bounds(sizes), pred)
    want = tq.record_and_check_run(b, torch.from_numpy(
        np.concatenate(padded, axis=1)), tq.chunk_bounds([64] * 3), pred)
    bounds = tq.chunk_bounds(sizes)
    for k, size in enumerate(sizes):
        np.testing.assert_array_equal(
            got[bounds[k]:bounds[k + 1]].numpy(),
            want[64 * k:64 * k + size].numpy())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- (b) the K4 wrappers' kernel path -----------------------------------------


class _Recorder:
    """Stands in for a packed library: records each entry's name and its
    unpacked int64 slots (and the chunk bounds it points at), returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)

        def call(block):
            slots = struct.unpack(f"={len(block) // 8}q", block)
            extra = None
            if entry == "fpx_record_and_check_run":
                extra = _at(slots[8], slots[9] + 1, np.int32).copy()
            self.calls.append((entry, slots, extra))
            return 0
        return call


def test_k4_lean_entry_packs_the_c_block(monkeypatch):
    """With the kernel path forced on CPU tensors: ``record_and_check``
    hands ``fpx_record_and_check_run`` its 23-slot block (the board, the
    lanes and their row stride, the chunk bounds [0, B] by address, one
    chunk, newly, perm identity, the predicate, device, stream) and
    counts one launch; ``record_and_check_run`` passes its bounds and
    counts one launch per MAX_RUN_CHUNKS chunks that hold a lane; a run
    with no lane makes no call."""
    recorder = _Recorder()
    monkeypatch.setattr(tq, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tq._build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(tq._build, "stream_handle", lambda index: 0)
    monkeypatch.setattr(tq._K4, "fn", None)
    monkeypatch.setattr(tq.record_and_check, "launches", 0)
    spec = Grid([[0, 2, 4], [1, 3, 5]]).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    board = tq.make_vote_board(64, 6, device="cpu")
    lanes = torch.from_numpy(tq.pack_lanes(*(np.arange(40),) * 4,
                                           np.ones(40, bool)))
    newly = tq.record_and_check(board, lanes, pred)
    entry, slots, bounds = recorder.calls[-1]
    assert entry == "fpx_record_and_check_run" and len(slots) == 23
    assert slots[:6] == tq._board_ptrs(board)
    assert slots[6:8] == (lanes.data_ptr(), 40) and slots[9] == 1
    assert bounds.tolist() == [0, 40]
    assert slots[10] == newly.data_ptr() and slots[11] == 0  # permuted
    assert slots[12:21] == pred.c_args() and slots[21:] == (-1, 0)
    assert tq.record_and_check.launches == 1
    sizes = [1] * 300
    sizes[5] = 0
    wide = torch.from_numpy(tq.pack_lanes(*(np.arange(299),) * 4,
                                          np.ones(299, bool)))
    tq.record_and_check_run(board, wide, tq.chunk_bounds(sizes), pred)
    entry, slots, bounds = recorder.calls[-1]
    assert slots[9] == 300 and bounds.tolist() == tq.chunk_bounds(
        sizes).tolist()
    assert tq.record_and_check.launches == 1 + 2  # 256 + 44 chunks
    calls = len(recorder.calls)
    tq.record_and_check_run(board, wide, np.array([0, 0, 0]), pred)
    assert len(recorder.calls) == calls
    assert tq.record_and_check.launches == 3


# --- (c) the drain's staged entry, modelled ---------------------------------------


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


class DrainModel:
    """``fpx_board_run_staged`` (and K2's ``fpx_record_block_run_staged``)
    of one checker, modelled on its packed block; each call is recorded."""

    def __init__(self, checker, events: FakeEvents):
        self.checker, self.events, self.calls = checker, events, []

    def board_run(self, block) -> int:
        a = _ints(block, 36)
        c = self.checker
        assert a[:6] == tq._board_ptrs(c._board)
        assert a[6] == c._pred.perm_identity and a[7:16] == c._pred.c_args()
        n, nseg, nb, nchunks = a[5], a[17], a[19], a[21]
        held, off, stride, lanes_off, b = a[24:29]
        newly_off, out_bytes, event = a[31], a[32], a[33]
        # The host may write a slot only when its last run was waited on.
        assert event not in self.events.pending, "slot written in flight"
        assert off % 16 == 0 and off >= 4 * held
        assert lanes_off % 16 == 0 and lanes_off >= off + n * stride
        assert newly_off >= stride and out_bytes == newly_off + b
        segs = _at(a[16], 3 * nseg, np.int32).reshape(nseg, 3).copy()
        table = _at(a[18], nb * tq.RUN_FIELDS, np.int32).reshape(
            nb, tq.RUN_FIELDS).copy()
        bounds = _at(a[20], nchunks + 1, np.int32).copy()
        in_bytes = lanes_off + 20 * b
        dev_in = _at(a[23], in_bytes, np.uint8)
        dev_in[:] = _at(a[22], in_bytes, np.uint8)
        slots = dev_in[:4 * held].view(np.int32).copy()
        if held:
            tq.release_all_plain(c._board, torch.from_numpy(slots))
        blocks = torch.from_numpy(dev_in[off:off + n * stride].reshape(
            n, stride).copy())
        lanes = torch.from_numpy(dev_in[lanes_off:in_bytes].view(
            np.int32).reshape(5, b).copy())
        dev_out = _at(a[29], out_bytes, np.uint8)
        for kind, first, last in segs.tolist():
            if kind == 0:
                got = tq.record_block_run_plain(
                    c._board, table[first:last], blocks, c._pred).numpy()
                for _, _, width, at, _, _ in table[first:last].tolist():
                    dev_out[at:at + width] = got[at:at + width]
            else:
                got = tq.record_and_check_run_plain(
                    c._board, lanes, bounds[first:last + 1], c._pred)
                lo, hi = bounds[first], bounds[last]
                dev_out[newly_off + lo:newly_off + hi] = got[lo:hi].numpy()
        _at(a[30], out_bytes, np.uint8)[:] = dev_out
        self.events.pending.add(event)
        self.calls.append(("board", segs, table, bounds, slots,
                           blocks.numpy(), lanes.numpy()))
        return 0

    def k2_run(self, block) -> int:
        a = _ints(block, 29)
        c = self.checker
        n, nb, held, off, stride, event = (a[5], a[7], a[10], a[11], a[12],
                                           a[26])
        assert event not in self.events.pending, "slot written in flight"
        table = _at(a[6], nb * tq.RUN_FIELDS, np.int32).reshape(
            nb, tq.RUN_FIELDS).copy()
        dev_in = _at(a[9], off + n * stride, np.uint8)
        dev_in[:] = _at(a[8], off + n * stride, np.uint8)
        slots = dev_in[:4 * held].view(np.int32).copy()
        if held:
            tq.release_all_plain(c._board, torch.from_numpy(slots))
        newly = tq.record_block_run_plain(c._board, table, torch.from_numpy(
            dev_in[off:].reshape(n, stride).copy()), c._pred)
        _at(a[14], stride, np.uint8)[:] = newly.numpy()
        self.events.pending.add(event)
        self.calls.append(("k2", table, slots))
        return 0


@pytest.fixture
def drain_staged(monkeypatch):
    """``make(checker)``: the checker's staged paths (the drain's entry
    included) on fakes: a ring of numpy slots, fake events, the modelled
    entries; returns its DrainModel."""
    monkeypatch.setattr(_build, "stream_handle", lambda index: 0)
    for wrapper in (tq.record_block, tq.release, tq.record_and_check):
        monkeypatch.setattr(wrapper, "launches", 0)

    def make(checker):
        events = FakeEvents()
        model = DrainModel(checker, events)
        checker._staged = checker._drain_staged = True
        checker._ring = tq.RunRing(fake_alloc, events)
        checker._ring_index = 0
        monkeypatch.setattr(tq._BOARD_STAGED, "fn", model.board_run)
        monkeypatch.setattr(tq._K2_STAGED, "fn", model.k2_run)
        return model

    return make


def _segments(rng, frontier: int, window: int) -> tuple:
    """A random drain's segments, alternating kinds (dense first or not):
    dense spans of 1-3 blocks within the ring, sparse runs of 1-4 chunks
    of straggler votes (duplicates, rounds 0-2), each chunk padded to 64
    or 256 lanes as the tracker sends them; and the next frontier."""
    segs, dense = [], bool(rng.integers(0, 2))
    for _ in range(int(rng.integers(1, 5))):
        if dense:
            spans = []
            for _ in range(int(rng.integers(1, 4))):
                width = int(rng.choice((64, 256)))
                start = frontier + int(rng.integers(0, 8))
                if start % window + width > window:
                    start += window - start % window
                spans.append((start, width, int(rng.integers(0, 2))))
                frontier = start + width
            segs.append(("dense", spans))
        else:
            chunks = []
            for _ in range(int(rng.integers(1, 5))):
                b = int(rng.integers(1, 257))
                slots = frontier - rng.integers(0, 600, size=b)
                slots[rng.integers(0, b, size=b // 3)] = slots[0]
                chunks.append((np.maximum(slots, 0),
                               rng.integers(0, 3, size=b).astype(np.int32),
                               rng.integers(0, 3, size=b).astype(np.int32),
                               64 if b <= 64 else 256))
            segs.append(("sparse", chunks))
        dense = not dense
    return segs, frontier


def _dispatch(checker, segs, fills):
    run = checker.board_run(segs)
    k = 0
    for kind, spans in segs:
        if kind == "dense":
            for _, width, _ in spans:
                at = int(run.offsets[k])
                run.block[:, at:at + width] = fills[k]
                k += 1
    return run, run.dispatch()


@pytest.mark.parametrize("seed", range(3))
def test_board_run_packs_what_the_plain_checker_sees(drain_staged, seed):
    """Drains of mixed segments with releases held before them: the
    staged path's dense and per-lane newly and board equal a plain CPU
    checker's (which runs each chunk through ``record_and_check_async``);
    each drain is ONE entry call carrying the held slots at the head of
    its in-block, the dense blocks at the table's offsets, the chunks'
    lanes unpadded at their bounds, its segments in order; K2 and K4
    count a launch per segment."""
    spec = SimpleMajority(range(3)).write_spec()
    rng = np.random.default_rng(50 + seed)
    window = 1 << 12
    card = tq.TpuQuorumChecker(spec, window=window, device="cpu")
    model = drain_staged(card)
    host = tq.TpuQuorumChecker(spec, window=window, device="cpu")
    frontier, segments = 1000, {"dense": 0, "sparse": 0}
    for step in range(10):
        segs, frontier = _segments(rng, frontier, window)
        fills = [(rng.random((3, w)) < 0.6).astype(np.uint8)
                 for kind, spans in segs if kind == "dense"
                 for _, w, _ in spans]
        released = [np.arange(frontier - 900, frontier - 900
                              + int(rng.integers(1, 30)))
                    for _ in range(int(rng.integers(0, 3)))]
        out = []
        for c in (card, host):
            for slots in released:
                c.release(slots)
            run, res = _dispatch(c, segs, fills)
            out.append((res.wait().copy(), res.lanes().copy()))
            res.free()
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_array_equal(out[0][1], out[1][1])
        for kind, _ in segs:
            segments[kind] += 1
        if any(kind == "sparse" for kind, _ in segs):
            kind, seg_table, table, bounds, held, blocks, lanes = \
                model.calls[-1]
            assert kind == "board"
            assert seg_table[:, 0].tolist() == [
                int(k == "sparse") for k, _ in segs]
            want_held = np.concatenate(released) % window if released \
                else np.zeros(0)
            np.testing.assert_array_equal(held, want_held)
            sizes = [len(ch[0]) for k, chunks in segs if k == "sparse"
                     for ch in chunks]
            assert bounds.tolist() == tq.chunk_bounds(sizes).tolist()
            chunks = [ch for k, cs in segs if k == "sparse" for ch in cs]
            for (sl, cl, rl, _), lo, hi in zip(chunks, bounds[:-1],
                                               bounds[1:]):
                np.testing.assert_array_equal(lanes[:, lo:hi], np.stack(
                    [sl % window, sl, cl, rl, np.ones(len(sl))]))
        else:
            assert model.calls[-1][0] == "k2"
        assert len(model.calls) == step + 1
        _boards_equal(card.board, jq.VoteBoard(*(
            jnp.asarray(t.numpy()) for t in host.board)), str(step))
        assert card.window_violations == host.window_violations
    assert tq.record_block.launches == segments["dense"]
    assert tq.record_and_check.launches == segments["sparse"]
    assert segments["sparse"] and segments["dense"]


@pytest.mark.parametrize("lag", [0, 1, 5])
def test_board_ring_reuses_a_slot_only_after_its_event(drain_staged, lag):
    """A collector ``lag`` dispatches behind: no slot is written while
    its run may be in flight (the model asserts it), the ring grows to
    ``max(lag + 1, INITIAL)`` slots, and every result reads back the
    plain checker's; each event is waited once."""
    spec = SimpleMajority(range(3)).write_spec()
    card = tq.TpuQuorumChecker(spec, window=1 << 12, device="cpu")
    model = drain_staged(card)
    host = tq.TpuQuorumChecker(spec, window=1 << 12, device="cpu")
    rng = np.random.default_rng(lag)
    pending, frontier = [], 600
    for d in range(12):
        segs, frontier = _segments(rng, frontier, 1 << 12)
        segs = [("sparse", [(np.arange(frontier - 300, frontier - 200),
                             np.zeros(100, np.int32),
                             np.zeros(100, np.int32), 256)])] + segs
        fills = [(rng.random((3, w)) < 0.7).astype(np.uint8)
                 for kind, spans in segs if kind == "dense"
                 for _, w, _ in spans]
        _, res = _dispatch(card, segs, fills)
        _, want = _dispatch(host, segs, fills)
        pending.append((res, want.wait().copy(), want.lanes().copy()))
        while len(pending) > lag:
            res, dense, lanes = pending.pop(0)
            np.testing.assert_array_equal(res.wait(), dense)
            np.testing.assert_array_equal(res.lanes(), lanes)
            res.free()
    for res, dense, lanes in pending:
        np.testing.assert_array_equal(res.wait(), dense)
        np.testing.assert_array_equal(res.lanes(), lanes)
        res.free()
    assert len(card._ring.slots) == max(lag + 1, tq.RunRing.INITIAL)
    assert len(model.events.waits) == 12 == len(model.calls)
    assert not model.events.pending


# --- (d) the pipelined tracker's drains with sparse segments --------------------

@pytest.mark.parametrize("mode", ["staged", "plain"])
def test_pipelined_tracker_sparse_segments_match_reference(drain_staged,
                                                           mode):
    """The pipelined tracker on drains with every kind of scatter part
    and a ring-end remainder between dense runs: reports, drain by
    drain, equal the JAX pipelined tracker's, and in all the dict
    oracle's pairs, each once. Staged (modelled): ONE entry call a
    drain, and at most one K4 launch a sparse segment."""
    config = tracker_lt.make_config()
    stream = tracker_lt.make_mixed_stream(11)
    oracle = tracker_lt.replay(qt.DictQuorumTracker(config), stream, 3)
    port = qt.TpuQuorumTracker(config, window=tracker_lt.MIXED_WINDOW,
                               pipelined=True, device="cpu")
    model = drain_staged(port.checker) if mode == "staged" else None
    ref = jqt.TpuQuorumTracker(_jax_config(),
                               window=tracker_lt.MIXED_WINDOW,
                               pipelined=True)
    got_all = []
    kinds = dict.fromkeys(("pre", "post", "leftover", "ring_end",
                           "chunks"), 0)
    calls = sparse_segments = 0
    for d, events in enumerate(stream):
        for t in (port, ref):
            tracker_lt.replay(t, [events], 3)
        dispatches = []
        while (x := port.take_dispatch()) is not None:
            dispatches.append(x)
        items = [item for x in dispatches for _, its, _ in x for item in its]
        got = [p for x in dispatches for p in port.collect(x)]
        want = []
        while (x := ref.take_dispatch()) is not None:
            want.extend(ref.collect(x))
        assert sorted(got) == sorted(want), d
        got_all.extend(got)
        rounds = [e[2] if e[0] == "vote" else e[3] for e in events]
        dom = max(set(rounds), key=rounds.count)
        kinds["pre"] += any(r < dom for r in rounds)
        kinds["post"] += any(r > dom for r in rounds)
        kinds["chunks"] += sum(i[0] == "votes" for i in items) > 2
        shape = [i[0] for i in items]
        kinds["ring_end"] += "votes" in shape and "run" in shape[
            shape.index("votes"):] and shape[0] == "run"
        kinds["leftover"] += any(e[0] == "vote" and e[2] == dom
                                 for e in events)
        sparse_segments += sum(
            1 for k, kind in enumerate(shape)
            if kind == "votes" and (k == 0 or shape[k - 1] != "votes"))
        if model is not None:
            new = len(model.calls) - calls
            assert new == len(dispatches) <= 1, d
            calls = len(model.calls)
    tracker_lt.check_against_oracle("pipelined", got_all, oracle)
    assert all(kinds.values()), kinds
    if model is not None:
        assert not model.events.pending
        # The prewarm's two record_and_check calls launch one each.
        assert tq.record_and_check.launches <= sparse_segments + 2
        assert sum(c[0] == "board" for c in model.calls)


# --- (e) K19-K21: the lean entries and the forms -------------------------------


class _PackedRecorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)

        def call(block):
            self.calls.append((entry, struct.unpack(
                f"={len(block) // 8}q", block)))
            return 0
        return call


@pytest.mark.parametrize("telemetry", [False, True])
def test_sharded_phases_pack_the_c_block(monkeypatch, telemetry):
    """With the kernel path forced on CPU state: K19 hands
    ``fpx_shard_vote_count`` its 18-slot block (votes, commands,
    w_local, i, block_size, b_local, slot_idx, group_idx, n_local, kind,
    g, cols, masks, telemetry, parts, form, device, stream: the 2x2
    mesh's shard takes the rows form, code 2), K20
    ``fpx_shard_commit`` its 21 (the drain's row of the slot table by
    its address) and K21 ``fpx_shard_fold`` its 12 (the run's first
    drain and row count, the table, the telemetry buffer or 0), each
    counting one launch; ``i`` as int32."""
    recorder = _PackedRecorder()
    monkeypatch.setattr(tp, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tp._build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(tp._build, "stream_handle", lambda index: 0)
    for entry in (tp._K19, tp._K20, tp._K21):
        monkeypatch.setattr(entry, "fn", None)
    for wrapper in (tp.shard_vote_count, tp.shard_commit, tp.shard_fold):
        monkeypatch.setattr(wrapper, "launches", 0)
    grid = Grid([[0, 1, 2], [3, 4, 5]]).write_spec()
    pred = tq.make_predicate(*grid.as_arrays(), device="cpu")
    mesh = Mesh(2, 2, 3, torch.device("cpu"))
    state, _ = tp.make_sharded_state(mesh, 512, 128, 6, telemetry=telemetry)
    plan = tp.make_shard_plan(mesh, 128, pred, telemetry=telemetry)
    assert tp.shard_vote_count(state, -(2**31) + 5, plan) is plan.parts
    entry, slots = recorder.calls[-1]
    assert entry == "fpx_shard_vote_count" and len(slots) == 18
    assert slots == (state.votes.data_ptr(), state.commands.data_ptr(), 256,
                     -(2**31) + 5, 128, 64, 1, 1, 3, tp.GRID_WRITE, 2, 3,
                     plan.masks.data_ptr(), int(telemetry),
                     plan.parts.data_ptr(), 2, -1, 0)
    for row in (0, 5):
        assert tp.shard_commit(state, 7, plan, row).data_ptr() \
            == plan.slot[row].data_ptr()
        entry, slots = recorder.calls[-1]
        assert entry == "fpx_shard_commit" and len(slots) == 21
        assert slots == (*(t.data_ptr() for t in state[:4]), 256, 7, 128, 64,
                         1, 2, 3, 6, tp.GRID_WRITE, 2,
                         plan.thresholds.data_ptr(), 0, int(telemetry),
                         plan.parts.data_ptr(), plan.slot[row].data_ptr(),
                         -1, 0)
    tel = state.telemetry.buffer.data_ptr() if telemetry else 0
    for k in (1, 6):
        tp.shard_fold(state, 7, plan, k)
        entry, slots = recorder.calls[-1]
        assert entry == "fpx_shard_fold" and len(slots) == 12
        assert slots == (*(t.data_ptr() for t in state[4:7]), 7, k, 128, 2,
                         6, plan.slot.data_ptr(), tel, -1, 0)
    assert (tp.shard_vote_count.launches, tp.shard_commit.launches,
            tp.shard_fold.launches) == (1, 2, 2)


#: ((group, slot), spec, n, the form K19 runs): the meshes of
#: tests/test_torch_multichip.py, chip_smoke.py phase 25 and the
#: multichip benches' oracle gates (n = 8 majorities).
GRID = Grid([[0, 1, 2], [3, 4, 5]])
FORM_CASES = [
    ((2, 2), GRID.write_spec(), ("rows", 3, 3)),
    ((3, 1), GRID.write_spec(), ("groups", 2, 2)),
    ((1, 4), GRID.write_spec(), ("generic", 6, 0)),
    ((2, 2), Grid([[0, 2, 4], [1, 3, 5]]).write_spec(), ("generic", 3, 0)),
    ((2, 1), GRID.read_spec(), ("rows", 3, 3)),
    ((2, 1), SimpleMajority(range(6)).write_spec(), ("groups", 3, 1)),
    ((1, 4), SimpleMajority(range(3)).write_spec(), ("groups", 3, 1)),
    ((1, 3), SimpleMajority(range(3)).write_spec(), ("groups", 3, 1)),
    ((1, 1), SimpleMajority(range(8)).write_spec(), ("groups", 8, 1)),
    ((2, 4), SimpleMajority(range(8)).write_spec(), ("groups", 4, 1)),
    ((8, 1), SimpleMajority(range(8)).write_spec(), ("groups", 1, 1)),
    ((2, 3), SimpleMajority(range(8)).write_spec(), ("groups", 4, 1)),
    ((1, 1), SimpleMajority(range(16)).write_spec(), ("groups", 16, 1)),
    ((1, 1), SimpleMajority(range(17)).write_spec(), ("generic", 17, 0)),
    ((3, 1), Grid(ROWS3).write_spec(), ("rows", 3, 3)),
    ((1, 1), Grid(ROWS3).write_spec(), ("generic", 9, 0)),
]


@pytest.mark.parametrize("case", FORM_CASES, ids=[
    f"{g}x{s}-{spec.num_nodes}-{form[0]}"
    for (g, s), spec, form in FORM_CASES])
def test_k19_form_for_each_mesh(case):
    """The form K19 runs for each mesh's shard (``shard_form``, whose
    choice the C entry launches): the register forms where the shard's
    structure has one, the generic template elsewhere."""
    (g, s), spec, form = case
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    plan = tp.make_shard_plan(Mesh(g, s, 0, torch.device("cpu")), 256, pred)
    assert tp.shard_form(plan) == form
    kind = (plan.kind, plan.n_local,
            plan.cols if plan.kind != tp.MATMUL else plan.masks.shape[0])
    assert (kind in tp.SHARD_FORMS) == (form[0] != "generic")


@pytest.mark.parametrize("case", FORM_CASES, ids=[
    f"{g}x{s}-{spec.num_nodes}-{form[0]}"
    for (g, s), spec, form in FORM_CASES])
def test_k19_hands_the_c_entry_its_form(monkeypatch, case):
    """K19's wrapper hands ``fpx_shard_vote_count`` the code of the form
    ``shard_form`` names (0 generic, 1 mask groups, 2 whole rows) in slot
    15: the C entry launches that form and makes no choice of its own."""
    recorder = _PackedRecorder()
    monkeypatch.setattr(tp, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(tp._build, "packed_library",
                        lambda name, keep_gil: recorder)
    monkeypatch.setattr(tp._build, "stream_handle", lambda index: 0)
    monkeypatch.setattr(tp._K19, "fn", None)
    monkeypatch.setattr(tp.shard_vote_count, "launches", 0)
    (g, s), spec, form = case
    pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    mesh = Mesh(g, s, 0, torch.device("cpu"))
    state, _ = tp.make_sharded_state(mesh, 1024, 256, spec.num_nodes)
    plan = tp.make_shard_plan(mesh, 256, pred)
    tp.shard_vote_count(state, 3, plan)
    entry, slots = recorder.calls[-1]
    assert entry == "fpx_shard_vote_count"
    assert slots[15] == {"generic": 0, "groups": 1, "rows": 2}[form[0]]
    assert slots[8] == form[1] and tp.shard_vote_count.launches == 1


def test_board_run_off_the_staged_path_refuses_a_card_board(monkeypatch):
    """A board run with scatter chunks on a checker whose device is a card
    but whose drain entry is cleared raises before any plain version
    runs: the plain versions never run on card tensors."""
    spec = SimpleMajority(range(3)).write_spec()
    checker = tq.TpuQuorumChecker(spec, window=1 << 10, device="cpu")
    calls = []
    monkeypatch.setattr(checker, "record_and_check_async",
                        lambda *a, **k: calls.append(a))
    checker.device = torch.device("cuda", 0)
    run = checker.board_run([("sparse", [(np.arange(4), np.zeros(
        4, np.int32), None, 64)])])
    with pytest.raises(RuntimeError, match="staged entry"):
        run.dispatch()
    assert calls == []
