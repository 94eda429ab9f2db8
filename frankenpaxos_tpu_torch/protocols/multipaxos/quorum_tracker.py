"""Pluggable Phase2b write-quorum tracking: host dict or GPU vote board.

The port's counterpart of
``frankenpaxos_tpu/protocols/multipaxos/quorum_tracker.py``, with the
same classes and names. The ProxyLeader's vote-collection loop
(ProxyLeader.scala:217-258) is the hottest code in the reference. Here
it is a strategy interface with two implementations:

  * ``DictQuorumTracker`` -- the reference's semantics verbatim: a dict
    keyed (slot, round) accumulating (group, acceptor) votes. The oracle.
  * ``TpuQuorumTracker`` -- votes buffered per event-loop drain, then
    one call of the port's ``TpuQuorumChecker`` per drain: the
    stateless predicate (K1, one staged call) in the synchronous mode;
    in the pipelined mode the drain's dense blocks (K2) and its sparse
    scatter chunks for stragglers (K4), in order, as one board run (one
    staged call, the held ``release`` s (K5) ahead of it). It keeps the
    reference's name; it runs on ``cuda``
    unless given ``device="cpu"``, where the kernels' plain versions run.
    Acceptor coordinates flatten to columns ``group * group_size + index``.
    In non-flexible mode only a slot's own group is ever messaged, so a
    universe-wide count >= f+1 threshold is exactly the per-group f+1
    quorum; in flexible mode the grid write-spec applies.

Both report each (slot, round)'s quorum exactly once.
"""

from __future__ import annotations

import abc

from frankenpaxos_tpu_torch.ops.quorum import TpuQuorumChecker
from frankenpaxos_tpu_torch.protocols.multipaxos.config import (
    MultiPaxosConfig,
)
from frankenpaxos_tpu_torch.quorums import QuorumSpec
from frankenpaxos_tpu_torch.quorums.spec import ANY
import numpy as np

#: The synchronous mode's routing threshold on a CUDA device: a drain
#: whose single-round slot span is at least this wide goes to the device
#: predicate, a narrower one to the host tally. The crossover of
#: ``bench/tracker_lt.py`` on an NVIDIA H100 80GB HBM3 at 700.00 W, in
#: the ranged-ack shape (PERF.md): with the drain one staged K1 call the
#: device path wins from 128 slots on (from 256 when each segment was a
#: launch and a fetch of its own).
#: In ``bench/multipaxos_sim.py``'s traffic (one client, waves of 4096)
#: every vote reaches a ProxyLeader as a Phase2bRange or a packed
#: Phase2bVotes, none as a lone Phase2b, but every drain is 4096 slots
#: or wider, so the threshold itself is not exercised there: how wide a
#: deployed ProxyLeader's drains are is still open (PERF.md). Acceptors
#: that sent lone Phase2bs (``range_phase2bs=False``) would meet the
#: per-slot crossover instead, 512-2048 slots depending on the run.
CUDA_MIN_DEVICE_SLOTS = 128

#: The same threshold for the plain versions on the CPU: the reference's
#: value for a host backend, so CPU runs route as the JAX package's do.
CPU_MIN_DEVICE_SLOTS = 1024


class QuorumTracker(abc.ABC):
    """Tracks Phase2b votes; reports slots whose quorum completes."""

    @abc.abstractmethod
    def record(self, slot: int, round: int, group_index: int,
               acceptor_index: int) -> None:
        ...

    def record_range(self, slot_start: int, slot_end: int, round: int,
                     group_index: int, acceptor_index: int) -> None:
        """One acceptor's votes for slots [slot_start, slot_end) in one
        round (a Phase2bRange). Default: per-slot expansion."""
        for slot in range(slot_start, slot_end):
            self.record(slot, round, group_index, acceptor_index)

    def record_votes(self, slots, rounds, group_index: int,
                     acceptor_index: int) -> None:
        """One acceptor's votes for an ARBITRARY slot array (a packed
        Phase2bVotes from a fragmented drain). Default: per-slot
        expansion."""
        for slot, round in zip(slots.tolist(), rounds.tolist()):
            self.record(int(slot), int(round), group_index,
                        acceptor_index)

    @abc.abstractmethod
    def drain(self) -> list[tuple[int, int]]:
        """Flush buffered votes; return [(slot, round)] newly at quorum."""


class DictQuorumTracker(QuorumTracker):
    def __init__(self, config: MultiPaxosConfig):
        self.config = config
        self.grid = config.quorum_grid() if config.flexible else None
        self._row_size = len(config.acceptor_addresses[0])
        # (slot, round) -> set of (group, index); None once chosen.
        self.states: dict[tuple[int, int], set | None] = {}
        self._newly: list[tuple[int, int]] = []

    def record(self, slot, round, group_index, acceptor_index) -> None:
        key = (slot, round)
        votes = self.states.get(key)
        if votes is None and key in self.states:
            return  # already chosen (Done)
        if votes is None:
            votes = set()
            self.states[key] = votes
        votes.add((group_index, acceptor_index))
        if self.config.flexible:
            flat = {g * self._row_size + i for g, i in votes}
            if not self.grid.is_superset_of_write_quorum(flat):
                return
        else:
            if len(votes) < self.config.f + 1:
                return
        self.states[key] = None  # Done
        self._newly.append(key)

    def drain(self) -> list[tuple[int, int]]:
        newly, self._newly = self._newly, []
        return newly


class TpuQuorumTracker(QuorumTracker):
    """Two operating modes, chosen by ``pipelined``:

    **Synchronous (default).** Each drain whose dominant-round span is
    at least ``min_device_slots`` wide is decided by ONE stateless
    predicate over the drain's ``[n, B]`` vote block (K1: every active
    segment written into the checker's pinned staging, then one call,
    ``TpuQuorumChecker.check_staged``) -- no board state, no ring
    bookkeeping, cost flat in B. Votes below quorum after that check
    (quorums straddling drains) spill into a host tally (a
    ``DictQuorumTracker``, the oracle itself) -- SURVEY.md section 7's
    "overflow -> host-side spill path". Drains NARROWER than the
    threshold skip the device entirely and go straight to the host
    tally: below the crossover a device call's fixed round trip costs
    more than the per-vote Python it saves (the CUDA threshold is
    measured, ``CUDA_MIN_DEVICE_SLOTS``). The result: at trickle widths
    the tracker matches the dict oracle, and past the threshold the
    per-drain cost stays flat while the oracle's grows per vote.

    **Pipelined.** Every dense run goes through the stateful on-device
    vote board (K2; stragglers and off-round votes through the scatter,
    K4): the drain DISPATCHES asynchronously (returning []) and enqueues
    an in-flight record. Its parts -- runs of dense blocks and runs of
    scatter chunks, in the reference's order -- are written straight
    into a pinned slot of the checker's ring and go up as ONE board run
    (``TpuQuorumChecker.board_run``: one staged call, a K2 launch per
    dense segment and a K4 launch per sparse one, both kinds of
    ``newly`` copied down into the slot and an event recorded, nothing
    waited on), so the drain never waits on the device. The caller
    collects completed dispatches via :meth:`take_dispatch` +
    :meth:`collect` -- from a worker thread (ProxyLeader posts results
    back onto the event loop) or a flush timer. This hides the
    device-link latency behind the event loop -- essential when the
    accelerator sits across a high-RTT link -- at the cost of one
    dispatch of added choose latency; the board must see every vote
    because results are not available within the drain.

    ``mesh`` (a ``mesh.Mesh``): the checker's board is split over the
    mesh's ranks (``TpuQuorumChecker(mesh=)``) in both modes; the
    synchronous mode's board is ``min(window, 4096)`` columns, so the
    mesh size must divide that too. Every rank builds the same tracker
    and is fed the same votes in the same order; the dedup ring, the
    host spill tally and ``collect`` stay on the host of every rank, and
    every rank reports the same pairs. The device is the mesh's."""

    def __init__(self, config: MultiPaxosConfig, window: int = 1 << 20,
                 pipelined: bool = False, device=None,
                 min_device_slots: int = 0, mesh=None):
        import collections

        self.config = config
        self.pipelined = pipelined
        # In-flight dispatches: (slots, rounds, device per-vote masks).
        # append/popleft are GIL-atomic, so a collector thread may pop
        # while the event loop appends.
        self._inflight = collections.deque()
        self._row_size = len(config.acceptor_addresses[0])
        num_cols = config.num_acceptor_groups * self._row_size
        universe = tuple(range(num_cols))
        if config.flexible:
            spec = config.quorum_grid().write_spec().reindexed(universe)
        else:
            spec = QuorumSpec(
                masks=np.ones((1, num_cols), dtype=np.uint8),
                thresholds=np.array([config.f + 1], dtype=np.int32),
                combine=ANY,
                universe=universe,
            )
        # Sync mode never records on the vote board (stateless checks +
        # host spill), so don't allocate a full `window`-wide board
        # there -- just enough columns for the largest dense bucket.
        checker_window = window if pipelined else min(window, 4096)
        self.checker = TpuQuorumChecker(spec, window=checker_window,
                                        mesh=mesh, device=device)
        self._slots: list[int] = []
        self._cols: list[int] = []
        self._rounds: list[int] = []
        # Ranged votes (Phase2bRange): [(start, end, col, round)] --
        # O(1) Python per message, expanded vectorized at drain time.
        self._ranges: list[tuple[int, int, int, int]] = []
        # Packed array votes (Phase2bVotes): [(slots, col, rounds)] --
        # O(1) Python per message, arrays straight off the native
        # codec's unpack.
        self._array_votes: list = []
        # Exactly-once reporting across drains, vectorized. The board's
        # `chosen` bitmap provides this for board-recorded votes, but
        # the stateless check_block path never touches the board, so a
        # duplicate full-quorum drain (resent acks) would re-report. A
        # host-side dedup ring keyed slot % window (owner slot + round
        # per column, numpy fancy-indexed in collect()) restores the
        # dict oracle's contract with O(batch) numpy instead of
        # per-slot set ops. Like the vote board itself it forgets a
        # slot once the ring wraps past it -- covered by the same
        # "window > max slots in flight" invariant.
        self._dedup_slot = np.full(window, -1, dtype=np.int64)
        self._dedup_round = np.full(window, np.iinfo(np.int64).min,
                                    dtype=np.int64)
        self._frontier = -1
        self._host_gc_cap = max(1 << 16, 2 * window)
        # Kernel width buckets. Drains are chunked to these widths (the
        # reference's, where each width is one compiled program; here
        # they bound the staging buffers and keep the two packages'
        # dispatches alike). Dense buckets go wide (a contiguous 4k-slot
        # run is one call); the sparse scatter tail stays narrow.
        self.max_chunk = 256
        self.dense_buckets = tuple(
            b for b in (64, 256, 1024, 4096) if b <= window)
        if not self.dense_buckets:
            raise ValueError(f"window must be >= 64 (got {window}): the "
                             f"smallest prewarmed dense kernel bucket is "
                             f"64 columns")
        self.max_dense = self.dense_buckets[-1]
        # A dominant-round cluster goes dense when it's at least this
        # filled; emptier clusters cost fewer device calls via scatter.
        self.min_fill = 0.25
        if min_device_slots <= 0:
            # The host/device routing threshold of the device in use: a
            # constant measured on the H100 for CUDA, the reference's
            # host-backend value for the CPU.
            min_device_slots = (CUDA_MIN_DEVICE_SLOTS
                                if self.checker.device.type == "cuda"
                                else CPU_MIN_DEVICE_SLOTS)
        self.min_device_slots = min_device_slots
        # The synchronous mode's drains by routing: "trickle" and
        # "mixed" (rounds) go to the host tally whatever their width;
        # single-round drains count under their slot span rounded up
        # to a power of two, against ``min_device_slots``.
        self.drain_widths: collections.Counter = collections.Counter()
        # Host spill tally for the synchronous mode (narrow drains +
        # below-quorum residue of stateless checks): the dict oracle
        # itself, so cross-drain accumulation has one authority with
        # proven semantics.
        self._host = DictQuorumTracker(config)
        # Prewarm every bucket at construction -- before client traffic
        # -- so the first real drains pay no kernel build or first-use
        # allocation. The board paths (record_block / record_and_check)
        # only run in pipelined mode. Board prewarm votes land at round
        # -1 (below any real round), and release() clears the touched
        # columns (including the ring owners the prewarm claimed).
        for width in self.dense_buckets:
            warm = np.zeros((self.checker.num_nodes, width),
                            dtype=np.uint8)
            warm[0, 0] = 1
            self.checker.check_block(warm)
            if pipelined:
                self.checker.record_block(0, warm, vote_round=-1)
        if pipelined:
            for width in (1, self.max_chunk):
                self.checker.record_and_check([0] * width, [0] * width,
                                              [-1] * width)
            self.checker.release(np.arange(self.max_dense))

    def record(self, slot, round, group_index, acceptor_index) -> None:
        self._slots.append(slot)
        self._cols.append(group_index * self._row_size + acceptor_index)
        self._rounds.append(round)

    def record_range(self, slot_start, slot_end, round, group_index,
                     acceptor_index) -> None:
        if slot_end <= slot_start:
            # Drop empties like record_votes does: an empty range as
            # ra[0] would seed rnd0/lo from a zero-vote entry and yield
            # hi = start - 1 in _drain_sync.
            return
        self._ranges.append((slot_start, slot_end,
                             group_index * self._row_size
                             + acceptor_index, round))

    def record_votes(self, slots, rounds, group_index,
                     acceptor_index) -> None:
        slots = np.asarray(slots, dtype=np.int64)
        if not slots.size:
            # Drop empties at the door: every drain path assumes
            # non-empty entries (round scans, frontier max, rounds[0]).
            return
        self._array_votes.append(
            (slots, group_index * self._row_size + acceptor_index,
             np.asarray(rounds, dtype=np.int32)))

    def drain(self) -> list[tuple[int, int]]:
        """At most a few device calls per event-loop drain (in the
        synchronous mode one at most, often zero); see the class
        docstring for the two modes."""
        if not self._slots and not self._ranges \
                and not self._array_votes:
            return []
        if self.pipelined:
            return self._drain_pipelined()
        return self._drain_sync()

    # --- synchronous mode -------------------------------------------------

    def _drain_sync(self) -> list[tuple[int, int]]:
        """Stateless device check for wide single-round drains; host
        tally for narrow drains, off-round votes, and the below-quorum
        residue of device checks.

        Steady-state Phase2b streams cover contiguous slot runs in one
        round (Leader.scala:331-408 allocates slots contiguously) and a
        slot's whole write quorum lands in ONE drain (the ProxyLeader
        fans each Phase2a to its quorum in one pass; the acks coalesce
        back together), so the common drain is one ``check_block``
        matmul with an empty residue."""
        ranges, self._ranges = self._ranges, []
        av, self._array_votes = self._array_votes, []
        sl, self._slots = self._slots, []
        cl, self._cols = self._cols, []
        rl, self._rounds = self._rounds, []

        # Trickle drains (a serial client, quiescence dribbles): pure
        # Python straight into the host tally -- no numpy conversions,
        # no device. This is the regime where ANY fixed overhead is
        # visible per command. An explicit tiny min_device_slots (the
        # component benchmarks pin the device path on) lowers this
        # cutoff too.
        nvotes = (len(sl) + sum(e - s for s, e, _, _ in ranges)
                  + sum(s.size for s, _, _ in av))
        if nvotes < min(48, self.min_device_slots):
            self.drain_widths["trickle"] += 1
            row = self._row_size
            frontier = max(sl) if sl else -1
            for k in range(len(sl)):
                g, i = divmod(cl[k], row)
                self._host.record(sl[k], rl[k], g, i)
            if ranges:
                frontier = max(frontier,
                               max(e - 1 for _, e, _, _ in ranges))
            if av:
                frontier = max(frontier,
                               max(int(s.max()) for s, _, _ in av
                                   if s.size))
            self._spill_ranges(ranges)
            self._spill_arrays(av)
            self._note_frontier(frontier)
            return self._host_results()

        slots = np.asarray(sl, dtype=np.int64)
        cols = np.asarray(cl, dtype=np.int32)
        rounds = np.asarray(rl, dtype=np.int32)
        # Ranges as an [R, 4] array: strided workloads shred ranged
        # acks into many single-slot runs, so everything below must be
        # vectorized over R, not Python-per-range.
        ra = (np.asarray(ranges, dtype=np.int64) if ranges
              else np.empty((0, 4), dtype=np.int64))

        # Uniform-round test + slot span.
        uniform = True
        lo = hi = None
        if ranges:
            rnd0 = int(ra[0, 3])
            uniform = bool((ra[:, 3] == rnd0).all())
            lo = int(ra[:, 0].min())
            hi = int(ra[:, 1].max()) - 1
        elif av:
            rnd0 = int(av[0][2][0]) if av[0][2].size else 0
        else:
            rnd0 = int(rounds[0])
        for s_arr, _, r_arr in av:
            if not uniform or not s_arr.size:
                break
            if not (r_arr == rnd0).all():
                uniform = False
                break
            alo, ahi = int(s_arr.min()), int(s_arr.max())
            lo = alo if lo is None else min(lo, alo)
            hi = ahi if hi is None else max(hi, ahi)
        if uniform and slots.size:
            if not (rounds == rnd0).all():
                uniform = False
            else:
                slo = int(slots.min())
                shi = int(slots.max())
                lo = slo if lo is None else min(lo, slo)
                hi = shi if hi is None else max(hi, shi)
        if not uniform:
            # Mixed rounds: election churn, preemption -- rare and
            # thin. Spill everything to the host tally in arrival
            # order (preserving the oracle's old-round-before-new
            # reporting liveness).
            self.drain_widths["mixed"] += 1
            frontier = int(slots.max()) if slots.size else -1
            if ranges:
                frontier = max(frontier, int(ra[:, 1].max()) - 1)
            if av:
                frontier = max(frontier,
                               max(int(s.max()) for s, _, _ in av
                                   if s.size))
            self._spill_ranges(ranges)
            self._spill_arrays(av)
            self._spill_votes(slots, cols, rounds)
            self._note_frontier(frontier)
            return self._host_results()

        width = hi - lo + 1
        self.drain_widths[1 << (width - 1).bit_length()] += 1
        if width < self.min_device_slots:
            # Narrow drain: the fixed device round-trip loses to
            # per-vote Python here -- host tally.
            self._spill_ranges(ranges)
            self._spill_arrays(av)
            self._spill_votes(slots, cols, rounds)
            self._note_frontier(hi)
            return self._host_results()

        # Wide single-round drain: one stateless check per max_dense
        # segment of the span (usually exactly one). Only segments
        # containing votes are materialized, so a pathological sparse
        # span costs O(active segments), not O(span).
        out: list[tuple[int, int]] = []
        seg = self.max_dense
        # Single-slot runs (the strided-ack shape) fill vectorized;
        # only genuinely multi-slot runs take the per-range slice loop.
        single = ra[ra[:, 1] - ra[:, 0] == 1] if ranges else ra
        multi = ([r for r in ranges if r[1] - r[0] > 1]
                 if ranges and single.shape[0] != ra.shape[0] else [])
        active = set()
        if slots.size:
            active.update(np.unique((slots - lo) // seg).tolist())
        if single.shape[0]:
            active.update(np.unique((single[:, 0] - lo) // seg).tolist())
        for s, e, _, _ in multi:
            active.update(range((s - lo) // seg, (e - 1 - lo) // seg + 1))
        for s_arr, _, _ in av:
            if s_arr.size:
                active.update(np.unique((s_arr - lo) // seg).tolist())
        # Every active segment side by side in ONE block, each at its
        # bucket's width (K1 is column-local), written straight into the
        # checker's staging and checked by one call.
        segments = []
        total = 0
        for seg_idx in sorted(active):
            seg_start = lo + seg_idx * seg
            seg_end = min(seg_start + seg, hi + 1)
            segments.append((seg_start, seg_end, total))
            total += next(b for b in self.dense_buckets
                          if b >= seg_end - seg_start)
        view = self.checker.stage_block(total)
        for seg_start, seg_end, at in segments:
            block = view[:, at:at + seg_end - seg_start]
            if single.shape[0]:
                inseg = ((single[:, 0] >= seg_start)
                         & (single[:, 0] < seg_end))
                block[single[inseg, 2],
                      single[inseg, 0] - seg_start] = 1
            for s, e, col, _ in multi:
                cs, ce = max(s, seg_start), min(e, seg_end)
                if cs < ce:
                    block[col, cs - seg_start:ce - seg_start] = 1
            if slots.size:
                inseg = (slots >= seg_start) & (slots < seg_end)
                block[cols[inseg], slots[inseg] - seg_start] = 1
            for s_arr, col, _ in av:
                inseg = (s_arr >= seg_start) & (s_arr < seg_end)
                block[col, s_arr[inseg] - seg_start] = 1
        hits = self.checker.check_staged(total)
        for seg_start, seg_end, at in segments:
            seg_width = seg_end - seg_start
            block = view[:, at:at + seg_width]
            hit = hits[at:at + seg_width]
            touched = block.any(axis=0)
            chosen = np.flatnonzero(hit & touched)
            if chosen.size:
                chosen_slots = seg_start + chosen.astype(np.int64)
                fresh = self._fresh_mask(chosen_slots, rnd0)
                out.extend(zip(chosen_slots[fresh].tolist(),
                               (rnd0,) * int(fresh.sum())))
            resid = touched & ~hit
            if resid.any():
                # Below-quorum residue: votes whose quorum straddles
                # drains. Spill to the host tally (few by
                # construction), which may complete earlier slots.
                rcols, rpos = np.nonzero(block * resid[None, :])
                for col, pos in zip(rcols.tolist(), rpos.tolist()):
                    g, i = divmod(col, self._row_size)
                    self._host.record(seg_start + pos, rnd0, g, i)
        self._note_frontier(hi)
        out.extend(self._host_results())
        return out

    def _spill_votes(self, slots, cols, rounds) -> None:
        for k in range(slots.size):
            g, i = divmod(int(cols[k]), self._row_size)
            self._host.record(int(slots[k]), int(rounds[k]), g, i)

    def _spill_ranges(self, ranges) -> None:
        for s, e, col, r in ranges:
            g, i = divmod(col, self._row_size)
            for slot in range(s, e):
                self._host.record(slot, r, g, i)

    def _spill_arrays(self, array_votes) -> None:
        for s_arr, col, r_arr in array_votes:
            g, i = divmod(col, self._row_size)
            for slot, r in zip(s_arr.tolist(), r_arr.tolist()):
                self._host.record(slot, r, g, i)

    def _note_frontier(self, max_slot: int) -> None:
        """Bound the host tally: the oracle's states dict never evicts,
        which is fine for the oracle (parity with the reference's
        per-slot maps) but the spill tally must not grow for the life
        of the process. Once it exceeds the cap, prune entries the
        dedup ring has forgotten anyway (slot < frontier - ring size)
        -- the same windowed-staleness contract as the vote board's
        self-reclaiming ring."""
        if max_slot > self._frontier:
            self._frontier = max_slot
        if len(self._host.states) > self._host_gc_cap:
            cutoff = self._frontier - self._dedup_slot.shape[0]
            self._host.states = {
                k: v for k, v in self._host.states.items()
                if k[0] >= cutoff}

    def _host_results(self) -> list[tuple[int, int]]:
        """Drain the host tally, marking its completions in the dedup
        ring so a later stateless re-ack of the same slot is not
        re-reported."""
        results = self._host.drain()
        if not results:
            return []
        if len(results) <= 8:  # scalar ring ops beat array setup here
            n = self._dedup_slot.shape[0]
            out = []
            seen: set[int] = set()
            for slot, rnd in results:
                if slot in seen:
                    # Mixed-round churn can complete one slot at two
                    # rounds in one drain; keep the first (oldest
                    # round, arrival order) so the ring holds exactly
                    # one (slot, round) pair per slot.
                    continue
                seen.add(slot)
                i = slot % n
                if (self._dedup_slot[i] != slot
                        or self._dedup_round[i] != rnd):
                    self._dedup_slot[i] = slot
                    self._dedup_round[i] = rnd
                    out.append((slot, rnd))
            return out
        slots = np.asarray([s for s, _ in results], dtype=np.int64)
        rounds = np.asarray([r for _, r in results], dtype=np.int64)
        # _fresh_mask requires unique slots (its last-wins fancy-indexed
        # ring write forgets one pair otherwise, re-reporting a later
        # duplicate re-ack): dedup to one entry per slot, keeping the
        # first = oldest-round arrival, as the dict oracle reports.
        # The DROPPED (slot, newer-round) pair is never reported -- a
        # later re-ack completing it would be its FIRST report, which
        # the per-(slot, round) exactly-once contract permits (the
        # ring can only remember one round per slot).
        uniq, first = np.unique(slots, return_index=True)
        if uniq.size != slots.size:
            first.sort()
            slots = slots[first]
            rounds = rounds[first]
            results = [results[i] for i in first.tolist()]
        fresh = self._fresh_mask(slots, rounds)
        if fresh.all():
            return results
        return [kv for kv, f in zip(results, fresh.tolist()) if f]

    # --- pipelined mode ---------------------------------------------------

    def _drain_pipelined(self) -> list[tuple[int, int]]:
        """Dispatch this drain's votes onto the stateful vote board
        asynchronously; results are collected later (take_dispatch +
        collect). Sparse stragglers and off-round votes go through the
        scatter path; votes in rounds OLDER than the dominant round
        dispatch BEFORE the dense block so an old-round quorum
        completing in this drain is reported before the newer round's
        preemption clears it. The drain's parts, in that order, are the
        segments of ONE board run (``TpuQuorumChecker.board_run``: on a
        card one staged call)."""
        segs: list = []
        slots = np.asarray(self._slots, dtype=np.int64)
        cols = np.asarray(self._cols, dtype=np.int32)
        rounds = np.asarray(self._rounds, dtype=np.int32)
        if self._ranges or self._array_votes:
            # Expand ranged/packed votes vectorized (the whole point of
            # Phase2bRange/Phase2bVotes: no per-slot Python before this
            # point).
            parts_s = [slots] if slots.size else []
            parts_c = [cols] if slots.size else []
            parts_r = [rounds] if slots.size else []
            for start, end, col, rnd in self._ranges:
                width = end - start
                parts_s.append(np.arange(start, end, dtype=np.int64))
                parts_c.append(np.full(width, col, dtype=np.int32))
                parts_r.append(np.full(width, rnd, dtype=np.int32))
            for s_arr, col, r_arr in self._array_votes:
                parts_s.append(s_arr)
                parts_c.append(np.full(s_arr.size, col, dtype=np.int32))
                parts_r.append(r_arr)
            slots = np.concatenate(parts_s)
            cols = np.concatenate(parts_c)
            rounds = np.concatenate(parts_r)

        # The drain's dominant round (fast path: single-round drain).
        if rounds[0] == rounds[-1] and (rounds == rounds[0]).all():
            dom = int(rounds[0])
            # Single-round drain within one dense bucket: one block.
            lo = int(slots.min())
            hi = int(slots.max())
            width = hi - lo + 1
            bucket = next((b for b in self.dense_buckets if b >= width),
                          None) if width <= self.max_dense else None
            if (bucket is not None
                    and slots.shape[0] >= width * self.min_fill):
                self._add_dense(segs, lo, bucket, dom, cols, slots - lo)
                self._dispatch(segs)
                return []
            dense_idx = np.arange(slots.shape[0])
            pre = post = None
        else:
            round_values, round_counts = np.unique(rounds,
                                                   return_counts=True)
            dom = int(round_values[np.argmax(round_counts)])
            dense_idx = np.flatnonzero(rounds == dom)
            pre = np.flatnonzero(rounds < dom)
            post = np.flatnonzero(rounds > dom)
        if pre is not None and pre.size:
            self._add_sparse(segs, slots, cols, rounds, pre)

        # Cluster the dominant round's slots into contiguous runs.
        ds = slots[dense_idx]
        if ds.size and np.all(ds[:-1] <= ds[1:]):  # arrival order is
            sidx = dense_idx                       # already slot-sorted
            ss = ds
        else:
            order = np.argsort(ds, kind="stable")
            sidx = dense_idx[order]
            ss = ds[order]
        sparse_leftover = []
        cluster_bounds = np.flatnonzero(np.diff(ss) >= self.max_dense) + 1
        for cluster in np.split(np.arange(sidx.size), cluster_bounds):
            cl = sidx[cluster]
            cs = ss[cluster]
            hi = int(cs[-1])
            width = hi - int(cs[0]) + 1
            if cl.size < width * self.min_fill:
                sparse_leftover.append(cl)
                continue
            # Chunk the run at prewarmed bucket widths. Each chunk
            # starts at an actual member slot, so the loop is
            # O(#chunks).
            i = 0
            while i < cs.size:
                start = int(cs[i])
                remaining = hi - start + 1
                bucket = next((b for b in self.dense_buckets
                               if b >= min(remaining, self.max_dense)))
                j = int(np.searchsorted(cs, start + bucket))
                members = cl[i:j]
                self._add_dense(segs, start, bucket, dom, cols[members],
                                slots[members] - start)
                i = j

        for cl in sparse_leftover:
            self._add_sparse(segs, slots, cols, rounds, cl)
        if post is not None and post.size:
            self._add_sparse(segs, slots, cols, rounds, post)
        self._dispatch(segs)
        return []

    def _add_dense(self, segs: list, start: int, bucket: int, rnd: int,
                   rows: np.ndarray, pos: np.ndarray) -> None:
        """Add a dense block of ``bucket`` slots from ``start`` (votes of
        acceptor columns ``rows`` at offsets ``pos``) to the drain's
        segments, split at the ring end (record_block's no-straddle
        contract)."""
        room = self.checker.window - start % self.checker.window
        if bucket <= room:
            self._segment(segs, "dense").append((start, bucket, rnd, rows,
                                                 pos))
            return
        # Straddling the ring end: each side decomposed into the bucket
        # widths, sub-bucket remainders through the scatter path.
        first = pos < room
        self._add_bucketed(segs, start, room, rnd, rows[first], pos[first])
        if not first.all():
            self._add_bucketed(segs, start + room, bucket - room, rnd,
                               rows[~first], pos[~first] - room)

    def _add_bucketed(self, segs: list, start: int, width: int, rnd: int,
                      rows: np.ndarray, pos: np.ndarray) -> None:
        i = 0
        while i < width:
            bucket = next((b for b in reversed(self.dense_buckets)
                           if b <= width - i), None)
            if bucket is None:
                # Remainder narrower than the smallest bucket: scatter
                # its distinct votes, in acceptor-then-slot order.
                rest = pos >= i
                key = np.unique(rows[rest].astype(np.int64) * width
                                + pos[rest])
                if key.size:
                    self._add_sparse(
                        segs, start + key % width,
                        (key // width).astype(np.int32),
                        np.full(key.size, rnd, dtype=np.int32),
                        np.arange(key.size))
                return
            inside = (pos >= i) & (pos < i + bucket)
            if inside.any():
                self._segment(segs, "dense").append(
                    (start + i, bucket, rnd, rows[inside], pos[inside] - i))
            i += bucket

    @staticmethod
    def _segment(segs: list, kind: str) -> list:
        """The drain's current segment of ``kind`` (``"dense"`` blocks or
        ``"sparse"`` chunks), a new one where the last is of the other."""
        if not segs or segs[-1][0] != kind:
            segs.append((kind, []))
        return segs[-1][1]

    def _add_sparse(self, segs: list, slots, cols, rounds, idx) -> None:
        """Scatter-path votes, after the dense blocks before them (the
        order the reference applies them in), chunked as the reference
        dispatches them: at most ``max_chunk`` votes a chunk, each chunk
        padded to 64 or ``max_chunk`` lanes there."""
        chunks = self._segment(segs, "sparse")
        for at in range(0, idx.size, self.max_chunk):
            chunk = idx[at:at + self.max_chunk]
            chunks.append((slots[chunk], cols[chunk], rounds[chunk],
                           64 if chunk.size <= 64 else self.max_chunk))

    def _dispatch(self, segs: list) -> None:
        """The drain's segments as ONE dispatch of the checker's board
        run (on a card one staged call: a K2 launch per dense segment, a
        K4 launch per sparse one, the held releases ahead of them): each
        dense block's votes written straight into the run's (pinned)
        staged block. Enqueues the in-flight record and clears the
        drain's buffers."""
        self._slots, self._cols, self._rounds = [], [], []
        self._ranges = []
        self._array_votes = []
        if not segs:
            return
        run = self.checker.board_run(
            [(kind, [(s, w, r) for s, w, r, _, _ in items]
              if kind == "dense" else items) for kind, items in segs])
        offsets = iter(run.offsets.tolist())
        bounds = iter(run.bounds.tolist())
        items = []
        for kind, parts in segs:
            if kind == "dense":
                blocks = []
                for start, width, rnd, rows, pos in parts:
                    at = next(offsets)
                    run.block[rows, at + pos] = 1
                    blocks.append((start, width, rnd, at))
                items.append(("run", blocks))
            else:
                for slots, _, rounds, _ in parts:
                    items.append(("votes", slots, rounds, next(bounds),
                                  slots.size))
        self._inflight.append([("board", items, run.dispatch())])

    def has_pending(self) -> bool:
        return bool(self._inflight)

    def take_dispatch(self):
        """Pop the oldest in-flight dispatch (None if empty); pass it to
        :meth:`collect`. Safe to call from a collector thread."""
        try:
            return self._inflight.popleft()
        except IndexError:
            return None

    def collect(self, dispatch) -> list[tuple[int, int]]:
        """Fetch a dispatch's results (blocking on the device only until
        this dispatch's masks are on the host) and dedup per slot,
        keeping each slot's first reporting round in part order (as the
        dict oracle's arrival-order reporting does).

        A dispatch is ``[("board", items, result)]``: ``result`` is the
        drain's board run (a ``RunResult``: on a card a wait on the run's
        event with the GIL released, then its pinned ``newly``, no
        ``.cpu()``), and ``items`` its parts in order: ``("run",
        [(start, width, round, at)])`` -- the dense blocks of a segment,
        each block's per-slot newly-chosen mask at staged columns ``[at,
        at + width)`` of ``result.wait()``; ``("votes", slots, rounds,
        at, n)`` -- a scatter chunk's per-vote mask at lanes ``[at, at +
        n)`` of ``result.lanes()``."""
        out: list[tuple[int, int]] = []
        for _, items, result in dispatch:
            try:
                m = result.wait()
                lanes = result.lanes() if any(
                    item[0] == "votes" for item in items) else None
                for item in items:
                    if item[0] == "run":
                        for start, width, rnd, at in item[1]:
                            slots = start + np.flatnonzero(
                                m[at:at + width]).astype(np.int64)
                            if slots.size:
                                fresh = self._fresh_mask(slots, rnd)
                                out.extend(zip(slots[fresh].tolist(),
                                               (rnd,) * int(fresh.sum())))
                        continue
                    _, vslots, vrounds, at, n = item
                    hit = np.flatnonzero(lanes[at:at + n])
                    if hit.size:
                        # Dedup duplicate slots within the chunk (keep the
                        # first, as the per-vote mask reports per vote).
                        hslots = np.asarray(vslots, dtype=np.int64)[hit]
                        _, first = np.unique(hslots, return_index=True)
                        sel = hit[np.sort(first)]
                        slots = np.asarray(vslots, dtype=np.int64)[sel]
                        rounds = np.asarray(vrounds, dtype=np.int64)[sel]
                        fresh = self._fresh_mask(slots, rounds)
                        out.extend(zip(slots[fresh].tolist(),
                                       rounds[fresh].tolist()))
            finally:
                result.free()
        return out

    def _fresh_mask(self, slots: np.ndarray, rounds) -> np.ndarray:
        """Vectorized exactly-once filter: True where (slot, round) has
        not been reported before (within the dedup ring's memory);
        marks the fresh ones reported. ``slots`` must be unique within
        the call."""
        idx = slots % self._dedup_slot.shape[0]
        dup = (self._dedup_slot[idx] == slots) \
            & (self._dedup_round[idx] == rounds)
        fresh = ~dup
        fi = idx[fresh]
        self._dedup_slot[fi] = slots[fresh]
        self._dedup_round[fi] = np.asarray(rounds)[fresh] \
            if isinstance(rounds, np.ndarray) else rounds
        return fresh
