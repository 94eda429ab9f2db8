"""GeoSimTransport: SimTransport with latency-ordered delivery (the
port's copy of ``frankenpaxos_tpu/geo/transport.py``).

Plain ``SimTransport`` buffers frames and lets the caller deliver them
in any order -- FIFO for integration tests, adversarially for the
randomized sims. The geo transport adds a VIRTUAL CLOCK: every send
samples its link's delay from the :class:`GeoTopology` matrix
(deterministic per seed) and stamps an arrival time, and the event
loop (:meth:`run_for` / :meth:`run_until`) delivers strictly in
arrival order -- so a zone-local ack genuinely overtakes a WAN frame
sent earlier, which is the whole phenomenon the wide-area suite
exists to exercise. Latencies measured against :attr:`now` are exact
virtual durations, which is what makes the bench gates in
``bench/geo_lt.py`` sharp instead of host-noise-bound.

Event scheduling is a pair of LAZY HEAPS (arrival times, timer
deadlines): push on send/start, validate against the authoritative
dicts on pop -- out-of-band removals (adversarial deliveries, link
drops, timer stops) just leave stale heap entries to be skipped, so
every per-event operation is O(log n) instead of a buffer scan.

The adversarial simulator API is unchanged: ``generate_command`` /
``deliver_message`` still deliver ANY buffered frame, so the chaos
sims explore reorderings beyond what latencies would produce, with
link partitions/degrades applied at delivery time.

The virtual-clock event loop is a POLICY over the shared wave engine
(sim_transport._run_wave) -- the heap decides WHICH frames form the
next wave (everything due at the next arrival time), then the same
engine evaluates the link/partition masks vectorized
(``topology.up_matrix`` through ``ops.simwave.LINK_KEEP_MASK``, K18 on
the card under ``FPX_SIMWAVE_JIT=1``) and delivers with per-wave
drains. Delivered frames tombstone out of the public buffer list
(``_consume_buffered``) instead of paying a ``list.remove`` scan per
message, which keeps 1000-zone topologies and deep schedules linear
(bench/sim_core_ab.py).

A wave is the set of frames whose arrival stamps are EQUAL: with a
jittered topology (``jitter > 0``), every frame draws its own delay,
so timed waves are mostly singletons and the mask (which runs only at
or above ``WAVE_VECTOR_MIN`` frames) mostly never runs; jitter-free
topologies and FIFO drains over this transport form the large waves.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from frankenpaxos_tpu_torch.geo.topology import GeoTopology
from frankenpaxos_tpu_torch.ops import simwave
from frankenpaxos_tpu_torch.runtime.logger import Logger
from frankenpaxos_tpu_torch.runtime.sim_transport import (
    SimMessage,
    SimTimer,
    SimTransport,
    WAVE_SAFE_DELIVERS,
)
from frankenpaxos_tpu_torch.runtime.transport import Address


class GeoSimTimer(SimTimer):
    """A SimTimer with a virtual deadline: (re)stamped from the
    transport's clock on every start, so the event loop fires it at
    ``now + delay_s`` like a real timer wheel."""

    def start(self) -> None:
        super().start()
        deadline = self._transport.now + self.delay_s
        self._transport._deadlines[self._id] = deadline
        heapq.heappush(self._transport._deadline_heap,
                       (deadline, self._id))

    def stop(self) -> None:
        super().stop()
        self._transport._deadlines.pop(self._id, None)


class GeoSimTransport(SimTransport):
    def __init__(self, topology: GeoTopology,
                 logger: Optional[Logger] = None):
        super().__init__(logger)
        self.topology = topology
        #: The virtual clock, in seconds. Advanced only by the event
        #: loop (never by wall time -- determinism contract, GEO801).
        self.now = 0.0
        #: message id -> virtual arrival time (authoritative; heap
        #: entries are valid only while they match).
        self.arrivals: dict[int, float] = {}
        self._by_id: dict[int, SimMessage] = {}
        self._arrival_heap: list = []
        #: timer id -> virtual deadline (running timers only).
        self._deadlines: dict[int, float] = {}
        self._deadline_heap: list = []
        self._link_only_check = None
        #: Fault bridge: address -> virtual time its sends resume
        #: departing. A role stalled inside a blocking syscall (an
        #: fsync stall) emits its frames late: arrival stamps base at
        #: the stall horizon instead of ``now``. Empty (one falsy test
        #: per send) unless ``stall_sender`` armed it.
        self._stall_until: dict = {}

    # --- sending ----------------------------------------------------------
    def send(self, src: Address, dst: Address, data: bytes) -> None:
        before = len(self.messages)
        super().send(src, dst, data)
        stalls = self._stall_until
        # Stamp every frame this send buffered (the frame itself, plus
        # any reject replies a bounded inbox synthesized), each over
        # its OWN link -- and each from its OWN sender's stall
        # horizon (a synthesized reject originates at dst, which may
        # not share src's stall).
        for message in self.messages[before:]:
            base = self.now
            if stalls:
                until = stalls.get(message.src)
                if until is not None:
                    if until > base:
                        base = until
                    else:
                        del stalls[message.src]  # expired
            arrival = base + self.topology.sample_delay(
                message.src, message.dst, message.id)
            self.arrivals[message.id] = arrival
            self._by_id[message.id] = message
            heapq.heappush(self._arrival_heap, (arrival, message.id))

    def stall_sender(self, address: Address, until_t: float) -> None:
        """Model a role blocked in a syscall until virtual ``until_t``
        (an fsync stall): frames it sends before
        then depart AT the stall horizon -- the event-loop pass that
        issued the blocking call finishes late, exactly like a real
        fsync stall holds a drain's group-commit release. Stalls only
        extend (a second fault during one stall pushes the horizon)."""
        if until_t > self._stall_until.get(address, 0.0):
            self._stall_until[address] = until_t

    def timer(self, address: Address, name: str, delay_s: float,
              f) -> GeoSimTimer:
        return GeoSimTimer(self, next(self._ids), address, name,
                           delay_s, f)

    # --- delivery ---------------------------------------------------------
    def _deliver(self, message: SimMessage):
        self.arrivals.pop(message.id, None)
        self._by_id.pop(message.id, None)
        if not self.topology.link_up(message.src, message.dst):
            # Dropped on the partitioned link: consume the frame
            # without running the handler (the sim's per-address
            # ``partitioned`` drop semantics, at link granularity).
            if not self._remove_buffered(message):
                self.logger.warn(
                    f"dropping unbuffered message {message}")
            return None
        return super()._deliver(message)

    # --- wave-engine policy hooks -----------------------------------------
    def _drop_schedule_stamps(self, wave) -> None:
        """FIFO drains consume frames outside the arrival-order loop;
        their stamps and lazy-heap entries must die with them or a
        later ``run_until`` would double-deliver."""
        arrivals = self.arrivals
        by_id = self._by_id
        for message in wave:
            arrivals.pop(message.id, None)
            by_id.pop(message.id, None)

    def _wave_keep_mask(self, wave) -> Optional[np.ndarray]:
        n = len(wave)
        if n < simwave.WAVE_VECTOR_MIN:
            return None
        topo = self.topology
        zid = topo.zone_id_of
        src_z = np.fromiter((zid(m.src) for m in wave), np.int32, n)
        dst_z = np.fromiter((zid(m.dst) for m in wave), np.int32, n)
        keep = simwave.LINK_KEEP_MASK(src_z, dst_z, topo.up_matrix())
        # The wave is already above WAVE_VECTOR_MIN, so the base mask
        # is exactly the partitioned-address mask (None when no
        # addresses are partitioned).
        partitioned = super()._wave_keep_mask(wave)
        if partitioned is not None:
            keep &= partitioned
        return keep

    def _per_message_check(self):
        base = super()._per_message_check()
        if base is None:
            # The common case (no per-address partitions): one cached
            # closure instead of an allocation per (often singleton)
            # wave.
            check = self._link_only_check
            if check is None:
                link_up = self.topology.link_up
                check = self._link_only_check = \
                    lambda m: link_up(m.src, m.dst)
            return check
        link_up = self.topology.link_up
        return lambda m: base(m) and link_up(m.src, m.dst)

    # --- the virtual-time event loop --------------------------------------
    @staticmethod
    def _peek(heap: list, live: dict) -> Optional[float]:
        while heap:
            t, key = heap[0]
            if live.get(key) == t:
                return t
            heapq.heappop(heap)
        return None

    def next_event_time(self) -> Optional[float]:
        t_msg = self._peek(self._arrival_heap, self.arrivals)
        t_tmr = self._peek(self._deadline_heap, self._deadlines)
        if t_msg is None:
            return t_tmr
        if t_tmr is None:
            return t_msg
        return min(t_msg, t_tmr)

    def _pop_due_messages(self, t: float) -> list:
        """Every buffered frame with arrival <= ``t``, in (arrival,
        send id) order; their heap entries are consumed."""
        due = []
        while self._arrival_heap:
            arrival, message_id = self._arrival_heap[0]
            if arrival > t:
                break
            heapq.heappop(self._arrival_heap)
            if self.arrivals.get(message_id) == arrival:
                message = self._by_id.get(message_id)
                if message is not None:
                    due.append(message)
        return due

    def run_until(self, t_end: float, max_steps: int = 1_000_000) -> int:
        """Advance virtual time to ``t_end``, delivering frames in
        arrival order and firing timers at their deadlines. Frames
        sharing one timestamp land as one wave and each touched
        destination drains once -- the event-loop batching semantics
        of the real transport. Returns the number of events run."""
        if not self._wave_fast_path_ok():
            return self._run_until_compat(t_end, max_steps)
        steps = 0
        try:
            while steps < max_steps:
                t = self.next_event_time()
                if t is None or t > t_end:
                    break
                # max(): the clock never REWINDS. A budget-capped call
                # can end with backlog whose arrival stamps are behind
                # the t_end it advanced to; delivering that backlog
                # next tick at its old stamps would move time backward.
                # In the un-capped case arrivals pop in order, so this
                # is the identity.
                self.now = max(self.now, t)
                # The whole same-timestamp wave delivers even when it
                # overshoots max_steps -- the cap is checked between
                # waves, and truncating here would let the timers due
                # at t fire BEFORE the wave's tail (a schedule
                # divergence from the reference).
                wave = self._pop_due_messages(t)
                if wave:
                    self._drop_schedule_stamps(wave)
                    self._consume_buffered(wave)
                    steps += len(wave)
                    self._run_wave(wave, coalesce=True)
                # Timers due at (or before) t.
                while self._deadline_heap:
                    deadline, timer_id = self._deadline_heap[0]
                    if deadline > t:
                        break
                    heapq.heappop(self._deadline_heap)
                    if self._deadlines.get(timer_id) == deadline:
                        self.trigger_timer(timer_id)
                        steps += 1
        finally:
            self._compact_messages()
        self.now = max(self.now, t_end)
        return steps

    def _run_until_compat(self, t_end: float, max_steps: int) -> int:
        """Per-message fallback for intercepted delivery (identical
        order/drain semantics, every frame through ``_deliver``)."""
        steps = 0
        while steps < max_steps:
            t = self.next_event_time()
            if t is None or t > t_end:
                break
            self.now = max(self.now, t)  # never rewinds (see run_until)
            touched: list = []
            seen: set[int] = set()
            for message in self._pop_due_messages(t):
                actor = self._deliver(message)
                steps += 1
                if actor is not None and id(actor) not in seen:
                    seen.add(id(actor))
                    touched.append(actor)
            for actor in touched:
                self._drain(actor)
            while self._deadline_heap:
                deadline, timer_id = self._deadline_heap[0]
                if deadline > t:
                    break
                heapq.heappop(self._deadline_heap)
                if self._deadlines.get(timer_id) == deadline:
                    self.trigger_timer(timer_id)
                    steps += 1
        self.now = max(self.now, t_end)
        return steps

    def run_for(self, duration: float,
                max_steps: int = 1_000_000) -> int:
        return self.run_until(self.now + duration, max_steps=max_steps)

    def run_until_quiescent(self, max_steps: int = 1_000_000,
                            horizon_s: float = 3600.0) -> int:
        """Deliver every in-flight frame (following arrival order and
        any sends they trigger) WITHOUT firing timers -- virtual time
        advances past deadlines but the timers stay pending, so a
        settle can never be kept awake by resend churn. Bounded by
        ``horizon_s`` of virtual time. The settle primitive for
        integration tests; timer-driven runs use :meth:`run_for`."""
        fast = self._wave_fast_path_ok()
        steps = 0
        t_end = self.now + horizon_s
        try:
            while steps < max_steps:
                t = self._peek(self._arrival_heap, self.arrivals)
                if t is None or t > t_end:
                    break
                self.now = max(self.now, t)
                _, message_id = heapq.heappop(self._arrival_heap)
                message = self._by_id.get(message_id)
                if message is None:
                    continue
                if fast:
                    self.arrivals.pop(message_id, None)
                    self._by_id.pop(message_id, None)
                    self._consume_buffered((message,))
                    steps += 1
                    self._run_wave([message], coalesce=True)
                else:
                    actor = self._deliver(message)
                    steps += 1
                    if actor is not None:
                        self._drain(actor)
        finally:
            self._compact_messages()
        return steps

    def crash(self, address: Address) -> None:
        super().crash(address)
        self._deadlines = {tid: d for tid, d in self._deadlines.items()
                           if tid in self.timers}


# The geo `_deliver` override is wave-aware (its link/partition drops
# are exactly what `_wave_keep_mask`/`_per_message_check` evaluate), so
# the wave engine may bypass it. Subclasses pinning a DIFFERENT
# `_deliver` fall back to per-message delivery.
WAVE_SAFE_DELIVERS.add(GeoSimTransport._deliver)


def delivery_schedule(transport: GeoSimTransport) -> list:
    """The in-flight frames as ``(arrival_s, id, src, dst)`` rows in
    delivery order -- the projection the determinism tests compare."""
    if transport._consumed:
        transport._compact_messages()
    rows = []
    for message in transport.messages:
        arrival = transport.arrivals.get(message.id)
        if arrival is not None:
            heapq.heappush(rows, (round(arrival, 12), message.id,
                                  str(message.src), str(message.dst)))
    return [heapq.heappop(rows) for _ in range(len(rows))]
