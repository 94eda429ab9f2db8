"""MultiPaxos ProxyLeader (the port's copy of
``frankenpaxos_tpu/protocols/multipaxos/proxy_leader.py``).

Reference behavior: multipaxos/ProxyLeader.scala:67-259. On Phase2a: fan
the message to a write quorum (thrifty f+1 of the slot's acceptor group,
or a random grid write quorum in flexible mode) and remember the value.
On Phase2b: collect votes per (slot, round) until quorum -- THE hot loop
-- then broadcast Chosen to every replica.

The vote-collection loop is delegated to a
:class:`~frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker.QuorumTracker`:
the host-dict oracle (``quorum_backend="dict"``) or the GPU vote board
(``"cuda"``: K1 in the synchronous mode, K2, K4 and K5 in the pipelined
mode) flushed once per transport drain (``on_drain``). The reference's
``"tpu"`` is refused. A pipelined board's dispatches are collected by a
flush timer on the simulated transport, and on a threaded one (TCP) by
one daemon collector thread that posts the results back onto the event
loop.

Not ported yet: the epoch-segmented vote counting of a reconfiguration
(``epoch_backend``, ``epoch_quorums``, EpochPhase2aRun, EpochCommit;
ROADMAP.md queue 1 item 4), refused, and the ingest fabric's wire sink
(item 8.2), so vote-ack batch frames are expanded per message.
"""

from __future__ import annotations

import bisect
import dataclasses
import queue
import random
import threading

import numpy as np
import torch

from frankenpaxos_tpu_torch import native
from frankenpaxos_tpu_torch.protocols.multipaxos.config import MultiPaxosConfig
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import (
    Chosen,
    ChosenRun,
    Phase2a,
    Phase2aRun,
    Phase2b,
    Phase2bRange,
    Phase2bVotes,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
    DictQuorumTracker,
    QuorumTracker,
    TpuQuorumTracker,
)
from frankenpaxos_tpu_torch.reconfig import RECONFIG_MESSAGES
from frankenpaxos_tpu_torch.runtime import Actor, Collectors, FakeCollectors, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


@dataclasses.dataclass(frozen=True)
class ProxyLeaderOptions:
    flush_phase2as_every_n: int = 1
    measure_latencies: bool = True
    # "dict" (host oracle) or "cuda" (batched vote board on the GPU).
    quorum_backend: str = "dict"
    tpu_window: int = 1 << 20
    # Sync-mode host/device routing threshold (drain width in slots);
    # 0 = the device's own constant (see TpuQuorumTracker).
    tpu_min_device_slots: int = 0
    # Pipelined device drains: dispatch this drain's votes async and
    # emit them when a later drain or the flush timer collects them
    # (one drain of extra choose latency), so the event loop never
    # waits on the device.
    tpu_pipelined: bool = False
    tpu_flush_period_s: float = 0.005
    # Reconfiguration's epoch-segmented counting: not ported yet; any
    # value other than the defaults is refused.
    epoch_backend: str = ""
    epoch_quorums: bool = False


class ProxyLeader(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: MultiPaxosConfig,
                 options: ProxyLeaderOptions = ProxyLeaderOptions(),
                 collectors: Collectors | None = None, seed: int = 0,
                 device=None):
        if options.quorum_backend not in ("dict", "cuda"):
            raise ValueError(
                f"quorum_backend must be 'dict' or 'cuda', got "
                f"{options.quorum_backend!r}")
        if options.epoch_backend or options.epoch_quorums:
            raise NotImplementedError(
                "epoch-segmented vote counting on the ProxyLeader is not "
                "ported yet (ROADMAP.md queue 1 item 4: reconfiguration)")
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.options = options
        self.rng = random.Random(seed)
        collectors = collectors or FakeCollectors()
        self.metrics_latency = collectors.summary(
            "multipaxos_proxy_leader_requests_latency_seconds", labels=("type",))
        self.metrics_requests = collectors.counter(
            "multipaxos_proxy_leader_requests_total", labels=("type",))
        self.metrics_tpu_dispatches = collectors.counter(
            "multipaxos_proxy_leader_tpu_dispatches_total")
        self.metrics_tpu_inflight = collectors.summary(
            "multipaxos_proxy_leader_tpu_inflight_at_dispatch")
        self.metrics_tpu_collect = collectors.summary(
            "multipaxos_proxy_leader_tpu_collect_seconds")
        self.grid = config.quorum_grid() if config.flexible else None
        self._row_size = len(config.acceptor_addresses[0])
        # (slot, round) -> pending value; moved to _done once chosen.
        self.pending: dict[tuple[int, int], object] = {}
        self._done: set[tuple[int, int]] = set()
        # Pending Phase2aRuns: start -> [end, round, values, remaining
        # (bool ndarray), left]. One O(1) record per run; chosen slots
        # resolve against it by bisect instead of per-slot dict entries.
        self._runs: dict[int, list] = {}
        self._run_starts: list[int] = []  # sorted (bisect.insort)
        # Completed runs' (start, end, round), kept for the stray-ack
        # fatal check (the per-slot path keeps _done forever; this is
        # the run equivalent, far smaller).
        self._done_runs: list[tuple[int, int, int]] = []
        self.chosen_count = 0
        #: Votes received, by the shape they arrived in: per slot
        #: (Phase2b), as a contiguous range (Phase2bRange) or as a
        #: packed fragmented drain (Phase2bVotes).
        self.votes_by_shape = dict.fromkeys(
            ("Phase2b", "Phase2bRange", "Phase2bVotes"), 0)
        self._unflushed_phase2as = 0
        if options.quorum_backend == "cuda":
            self.tracker: QuorumTracker = TpuQuorumTracker(
                config, window=options.tpu_window,
                pipelined=options.tpu_pipelined, device=device,
                min_device_slots=options.tpu_min_device_slots)
        else:
            self.tracker = DictQuorumTracker(config)
        self._flush_timer = None
        self._collector = None
        #: Every error the collector thread logged (a dispatch whose
        #: Chosen broadcasts were lost with it); empty on a healthy run.
        self.collector_errors: list[str] = []
        if options.quorum_backend == "cuda" and options.tpu_pipelined:
            # Branch on the transport's CAPABILITY (threaded event loop),
            # not on whether its loop happens to exist yet: a TcpTransport
            # actor constructed before start() must still get the
            # collector thread, and a SimTransport must never (its actors
            # run inline on the caller's thread).
            if transport.threaded:
                # Real transport: fetch device results on ONE daemon
                # worker thread (preserving dispatch order) and post
                # each completion back onto the event loop, so the loop
                # never blocks on the device. A daemon thread cannot
                # wedge process shutdown on a stuck device wait.
                self._collector = queue.Queue()
                # 1 while the collector thread is inside a collect (that
                # dispatch has left the queue but is still in flight);
                # single writer, read for metrics.
                self._collecting = 0
                self._collector_thread = threading.Thread(
                    target=self._collect_loop,
                    args=(self._collect_device(),), daemon=True,
                    name="cuda-collect")
                self._collector_thread.start()
            else:
                # SimTransport: a flush timer collects synchronously
                # (tests fire it explicitly).
                def flush_pending():
                    self._collect_all()
                    if self.tracker.has_pending():
                        self._flush_timer.start()

                self._flush_timer = self.timer(
                    "tpuDrainFlush", options.tpu_flush_period_s,
                    flush_pending)

    def receive(self, src: Address, message) -> None:
        # timed(label) handler latency summaries (Leader.scala:281-293).
        if self.options.measure_latencies:
            with self.metrics_latency.labels(
                    type(message).__name__).time():
                self._receive_impl(src, message)
        else:
            self._receive_impl(src, message)

    def _receive_impl(self, src: Address, message) -> None:
        if isinstance(message, Phase2a):
            self.metrics_requests.labels("Phase2a").inc()
            self._handle_phase2a(src, message)
        elif isinstance(message, Phase2aRun):
            self.metrics_requests.labels("Phase2aRun").inc()
            self._handle_phase2a_run(src, message)
        elif isinstance(message, Phase2b):
            self.metrics_requests.labels("Phase2b").inc()
            self._handle_phase2b(src, message)
        elif isinstance(message, Phase2bRange):
            self.metrics_requests.labels("Phase2bRange").inc()
            self._handle_phase2b_range(src, message)
        elif isinstance(message, Phase2bVotes):
            self.metrics_requests.labels("Phase2bVotes").inc()
            self._handle_phase2b_votes(src, message)
        elif isinstance(message, RECONFIG_MESSAGES):
            raise NotImplementedError(
                f"{type(message).__name__}: actor-side reconfiguration is "
                f"not ported yet (ROADMAP.md queue 1 item 4)")
        else:
            self.logger.fatal(f"unexpected proxy leader message {message!r}")

    def _handle_phase2a(self, src: Address, phase2a: Phase2a) -> None:
        key = (phase2a.slot, phase2a.round)
        if key in self.pending:
            self.logger.debug(f"duplicate Phase2a for {key}; ignoring")
            return
        if not self.config.flexible:
            group = list(self.config.acceptor_addresses[
                phase2a.slot % self.config.num_acceptor_groups])
            quorum = self.rng.sample(group, self.config.f + 1)
        else:
            write_quorum = self.grid.random_write_quorum(self.rng)
            quorum = [
                self.config.acceptor_addresses[flat // self._row_size]
                [flat % self._row_size] for flat in write_quorum]

        if self.options.flush_phase2as_every_n <= 1:
            for acceptor in quorum:
                self.send(acceptor, phase2a)
        else:
            for acceptor in quorum:
                self.send_no_flush(acceptor, phase2a)
            self._unflushed_phase2as += 1
            if self._unflushed_phase2as >= self.options.flush_phase2as_every_n:
                for group_addresses in self.config.acceptor_addresses:
                    for acceptor in group_addresses:
                        self.flush(acceptor)
                self._unflushed_phase2as = 0
        self.pending[key] = phase2a.value

    def _admit_run(self, start_slot: int, round: int, values) -> bool:
        """Install a run's O(1) pending record, evicting a same-start
        LOWER-round predecessor (a new leader re-proposing the window;
        mirroring the acceptor's round-monotone vote store -- keeping
        the old record would swallow the new proposal and strand its
        slots until recovery). False: duplicate (same or stale round)."""
        pending = self._runs.get(start_slot)
        if pending is not None:
            if round <= pending[1]:
                return False
            del self._runs[start_slot]
            i = bisect.bisect_left(self._run_starts, start_slot)
            self._run_starts.pop(i)
            # Remember the evicted (start, end, round) so straggler
            # old-round acks are recognized instead of tripping the
            # stray-ack fatal check.
            bisect.insort(self._done_runs,
                          (start_slot, pending[0], pending[1]))
        self._runs[start_slot] = [
            start_slot + len(values), round, values,
            np.ones(len(values), dtype=bool), len(values)]
        bisect.insort(self._run_starts, start_slot)
        return True

    def _handle_phase2a_run(self, src: Address, run: Phase2aRun) -> None:
        """One write quorum for the whole run (drain-granular thrifty:
        the reference samples per slot, ProxyLeader.scala:67-120; one
        sample per run keeps acceptor-side runs whole), one forwarded
        message per quorum member, one O(1) pending record."""
        if len(run.values) == 0:
            return
        if not self._admit_run(run.start_slot, run.round, run.values):
            return
        if not self.config.flexible:
            group = list(self.config.acceptor_addresses[0])
            quorum = self.rng.sample(group, self.config.f + 1)
        else:
            write_quorum = self.grid.random_write_quorum(self.rng)
            quorum = [
                self.config.acceptor_addresses[flat // self._row_size]
                [flat % self._row_size] for flat in write_quorum]
        self.broadcast(quorum, run)  # encode the values ONCE

    def _run_for(self, slot: int, round: int):
        """The pending run covering (slot, round), else None."""
        i = bisect.bisect_right(self._run_starts, slot) - 1
        if i < 0:
            return None
        run = self._runs.get(self._run_starts[i])
        if run is not None and slot < run[0] and run[1] == round:
            return run
        return None

    def _in_done_runs(self, slot: int, round: int) -> bool:
        i = bisect.bisect_right(self._done_runs, (slot, float("inf"),
                                                  float("inf"))) - 1
        if i < 0:
            return False
        # Same-start records can coexist (a retired run plus an evicted
        # lower-round predecessor); check every record sharing the
        # covering start (distinct starts never overlap).
        anchor = self._done_runs[i][0]
        while i >= 0 and self._done_runs[i][0] == anchor:
            _, end, rnd = self._done_runs[i]
            if slot < end and rnd == round:
                return True
            i -= 1
        return False

    def _handle_phase2b(self, src: Address, phase2b: Phase2b) -> None:
        self.votes_by_shape["Phase2b"] += 1
        key = (phase2b.slot, phase2b.round)
        if key not in self.pending and self._run_for(*key) is None:
            # Either never proposed here (a fatal bug in the reference,
            # ProxyLeader.scala:227-232) or already chosen. The tracker
            # dedups chosen slots; unknown (slot, round)s are fatal.
            if key not in self._done and not self._in_done_runs(*key):
                self.logger.fatal(
                    f"ProxyLeader got Phase2b for {key} but never sent a "
                    f"Phase2a there")
            return
        self.tracker.record(phase2b.slot, phase2b.round,
                            phase2b.group_index, phase2b.acceptor_index)

    def _handle_phase2b_range(self, src: Address,
                              r: Phase2bRange) -> None:
        """A contiguous run of votes in one message: O(1) Python on the
        device tracker (the dict oracle expands per slot). No per-slot
        pending check here -- every slot in the range was a Phase2a THIS
        proxy leader sent to that acceptor, so each is in ``pending`` or
        already ``_done``; ``_emit_chosen`` dedups either way."""
        self.votes_by_shape["Phase2bRange"] += max(
            0, r.slot_end_exclusive - r.slot_start_inclusive)
        self.tracker.record_range(r.slot_start_inclusive,
                                  r.slot_end_exclusive, r.round,
                                  r.group_index, r.acceptor_index)

    def _handle_phase2b_votes(self, src: Address, m) -> None:
        """A packed fragmented-drain ack (Phase2bVotes): unpack with the
        native codec straight into the tracker's arrays -- no per-vote
        Python on either side (same no-pending-check rationale as
        ranges)."""
        slots, rounds = native.unpack_votes2(m.packed)
        self.votes_by_shape["Phase2bVotes"] += len(slots)
        self.tracker.record_votes(slots, rounds, m.group_index,
                                  m.acceptor_index)

    def on_drain(self) -> None:
        # The batched quorum check (dict tracker or GPU kernel dispatch)
        # plus the Chosen emission it unlocks.
        with self.trace_stage("quorum-kernel"):
            self._emit_chosen(self.tracker.drain())
        if self._collector is not None:
            while True:
                dispatch = self.tracker.take_dispatch()
                if dispatch is None:
                    break
                self.metrics_tpu_dispatches.inc()
                # Depth includes the dispatch the collector thread is
                # currently blocked on (it left the queue but is in
                # flight): a healthy one-deep pipeline reads 1, not 0 --
                # 0 means the device wait is serialized.
                self.metrics_tpu_inflight.observe(
                    self._collector.qsize() + self._collecting)
                self._collector.put(dispatch)
        elif self._flush_timer is not None:
            # (Re)arm the quiescence flush while a dispatch is in
            # flight; the timer collects it if no further messages come.
            self._flush_timer.stop()
            if self.tracker.has_pending():
                self._flush_timer.start()

    def _collect_device(self) -> torch.device:
        """The tracker's device with an explicit index: a card named
        without one (``"cuda"``) is the current card of the thread that
        builds this ProxyLeader, where the tracker's board was made."""
        device = self.tracker.checker.device
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def _collect_loop(self, device) -> None:
        """The collector thread's body: collect each dispatch in order
        until :meth:`close` queues None. The card's current device is per
        host thread, so this thread selects the tracker's card before its
        first wait; if it cannot, the error is kept in
        ``collector_errors`` and every dispatch is still collected and
        posted (each one's own failure kept too)."""
        if device.type == "cuda":
            try:
                torch.cuda.set_device(device)
            except Exception as e:  # noqa: BLE001 - surface, don't swallow
                self._collector_failed(e)
        while True:
            dispatch = self._collector.get()
            if dispatch is None:
                return
            self._collecting = 1
            try:
                self._collect_and_post(dispatch)
            finally:
                self._collecting = 0

    def _collect_and_post(self, dispatch) -> None:
        """Runs on the collector thread: block on the device fetch, then
        hand the results back to the single-threaded event loop."""
        try:
            with self.metrics_tpu_collect.time():
                results = self.tracker.collect(dispatch)
            if results:
                self.transport.loop.call_soon_threadsafe(
                    self._emit_chosen, results)
        except RuntimeError as e:
            if self.transport.loop is not None \
                    and self.transport.loop.is_closed():
                # Loop closed during teardown: dropping in-flight
                # results is expected, but say so.
                self.logger.debug(f"cuda collect post skipped: {e!r}")
                return
            self._collector_failed(e)
        except Exception as e:  # noqa: BLE001 - surface, don't swallow
            self._collector_failed(e)

    def _collector_failed(self, e: Exception) -> None:
        # A swallowed collector error would silently drop this
        # dispatch's Chosen broadcasts and wedge its clients: log it and
        # keep it where a caller can check.
        self.collector_errors.append(repr(e))
        self.logger.error(f"cuda collect failed: {e!r}")

    def close(self) -> None:
        """Stop the collector thread (after the dispatches queued ahead
        of the stop); a no-op without one."""
        if self._collector is not None:
            self._collector.put(None)
            self._collector_thread.join(timeout=10)

    def _collect_all(self) -> None:
        while True:
            dispatch = self.tracker.take_dispatch()
            if dispatch is None:
                return
            self._emit_chosen(self.tracker.collect(dispatch))

    def _emit_chosen(self, keys) -> None:
        if self._runs and len(keys) > 1:
            self._emit_chosen_grouped(keys)
            return
        for key in keys:
            self._emit_one(key)

    def _emit_one(self, key) -> None:
        value = self.pending.pop(key, None)
        if value is None:
            run = self._run_for(*key)
            if run is not None:
                self._emit_run_segment(run, key[0], key[0] + 1)
            return
        self._done.add(key)
        self.chosen_count += 1
        self.broadcast(self.config.replica_addresses,
                       Chosen(slot=key[0], value=value))

    def _emit_chosen_grouped(self, keys) -> None:
        """Group a drain's chosen (slot, round)s into contiguous
        same-round segments (preserving the tracker's arrival-order
        reporting -- no sort) and emit each run-covered segment as ONE
        ChosenRun per replica; anything outside a run falls back to the
        per-slot path."""
        slots = np.fromiter((k[0] for k in keys), dtype=np.int64,
                            count=len(keys))
        rounds = np.fromiter((k[1] for k in keys), dtype=np.int64,
                             count=len(keys))
        breaks = np.flatnonzero((np.diff(slots) != 1)
                                | (np.diff(rounds) != 0)) + 1
        at = 0
        for b in list(breaks.tolist()) + [len(keys)]:
            if b == at:
                continue
            lo = int(slots[at])
            hi = int(slots[b - 1]) + 1
            rnd = int(rounds[at])
            run = self._run_for(lo, rnd)
            if run is not None and hi <= run[0]:
                self._emit_run_segment(run, lo, hi)
            else:
                for i in range(at, b):
                    self._emit_one((int(slots[i]), rnd))
            at = b

    def _emit_run_segment(self, run: list, lo: int, hi: int) -> None:
        """Emit chosen slots [lo, hi) of one pending run: slice the
        values, one ChosenRun per replica, O(1) bookkeeping."""
        end, rnd, values, remaining, left = run
        start = end - len(values)
        seg = remaining[lo - start:hi - start]
        if not seg.all():
            # A re-report within the segment (cannot happen through the
            # tracker's exactly-once contract, but a different tracker
            # implementation might): emit only the fresh sub-slots.
            for off in np.flatnonzero(seg).tolist():
                self._emit_run_segment(run, lo + off, lo + off + 1)
            return
        seg[:] = False
        n = hi - lo
        run[4] = left - n
        self.chosen_count += n
        # Full-run emission (the steady state: the whole run's quorum
        # completes in one drain) forwards the values object itself.
        seg_values = (values if lo == start and hi == end
                      else values[lo - start:hi - start])
        self.broadcast(self.config.replica_addresses,
                       ChosenRun(start_slot=lo, values=seg_values))
        if run[4] == 0:
            self._retire_run(start)

    def _retire_run(self, start: int) -> None:
        """Fully-chosen run: drop its values, remember (start, end,
        round) for the stray-ack check, prune the starts index."""
        run = self._runs.pop(start)
        bisect.insort(self._done_runs, (start, run[0], run[1]))
        i = bisect.bisect_left(self._run_starts, start)
        if i < len(self._run_starts) and self._run_starts[i] == start:
            self._run_starts.pop(i)
