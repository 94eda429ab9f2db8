"""SimTransport: the deterministic in-memory transport, the port's copy
of ``frankenpaxos_tpu/runtime/sim_transport.py``.

Reference behavior: FakeTransport.scala:64-230. Messages accumulate in a
buffer instead of being delivered; tests explicitly deliver any buffered
message or trigger any running timer, in any order. That explores
reordering, duplication (via protocol resends), and loss (never
delivering). Everything executes inline on the caller's thread
(FakeTransport.scala:127-140), keeping runs perfectly deterministic for
a given command sequence.

Also supports actor partitioning (JsTransport.scala:77): messages to or
from a partitioned actor are dropped at delivery time.

The NON-adversarial delivery paths (``deliver_all`` and
``deliver_all_coalesced``) share one wave engine, ``_run_wave``: the
batch of frames consumed in one step is spliced out of the buffer as a
unit, drop decisions evaluate as a vectorized mask over the wave
(ops/simwave.py) above ``WAVE_VECTOR_MIN``, and consecutive
same-destination frames deliver through ``Actor.receive_batch`` when
the actor overrides it. The geo transport's virtual-clock loop
(geo/transport.py) runs the same engine over its own waves: delivered
frames tombstone out of the public buffer list (``_consume_buffered``)
instead of paying a scan per message. The adversarial API
(``deliver_message`` of ANY buffered frame, ``generate_command``,
partition/crash controls) is unchanged, and the engine steps aside --
falling back to the per-message compat loop -- whenever delivery is
intercepted (an instance-wrapped ``deliver_message``, or a subclass
pinning another ``_deliver``).

A destination whose actor carries an admission controller with an
inbox capacity (``serve/admission.py``) gets a bounded client-lane
inbox: client-lane frames (``serve/lanes.py``) count against the bound
and are refused ("reject": the client gets a ``Rejected``) or shed
oldest-first ("drop"); control-lane frames always buffer.

With a tracer attached (``obs.Tracer``) every delivery is a receive span
(decode and handler stages inside it) parented by the context the frame
carried from its send (``SimMessage.trace``), every timer fire a timer
span and every ``on_drain`` a drain span; the wave engine then delivers
message by message, so the span structure is the per-message path's.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Optional, Union

import numpy as np

from frankenpaxos_tpu_torch.ops import simwave
from frankenpaxos_tpu_torch.runtime.actor import Actor
from frankenpaxos_tpu_torch.runtime.logger import Logger, PrintLogger
from frankenpaxos_tpu_torch.runtime.transport import Address, Timer, Transport


@dataclasses.dataclass(frozen=True)
class SimMessage:
    id: int
    src: Address
    dst: Address
    data: bytes
    # paxtrace: the frame-layer trace context (obs.TraceContext) --
    # the sim analog of the TCP frame header's ``|ctx`` suffix. None
    # whenever no tracer is attached or no context was active at send.
    trace: object = None


class SimTimer(Timer):
    """A timer that only fires when the test triggers it
    (FakeTransport.scala:9-62)."""

    def __init__(self, transport: "SimTransport", timer_id: int,
                 address: Address, name: str, delay_s: float,
                 f: Callable[[], None]):
        self._transport = transport
        self._id = timer_id
        self.address = address
        self._name = name
        self.delay_s = delay_s
        self._f = f
        self.running = False

    @property
    def name(self) -> str:
        return self._name

    @property
    def id(self) -> int:
        return self._id

    def start(self) -> None:
        self.running = True
        # The transport's registry holds RUNNING timers only: clients
        # create a fresh timer per resend/backoff, so registering for
        # the timer object's lifetime would leak the dict (and the
        # per-tick running_timers() scan) without bound under
        # sustained load (serve/loadgen.py pumps millions).
        self._transport.timers[self._id] = self

    def stop(self) -> None:
        self.running = False
        self._transport.timers.pop(self._id, None)

    def set_delay(self, delay_s: float) -> None:
        self.delay_s = delay_s

    def run(self) -> None:
        """Fire the timer (one-shot: stops first, like
        FakeTransport.scala:40-46)."""
        if self.running:
            self.stop()
            self._f()


# Commands the simulator replays against a SimTransport (the bridge to
# property-based testing, FakeTransport.scala:196-230).
@dataclasses.dataclass(frozen=True)
class DeliverMessage:
    message: SimMessage


@dataclasses.dataclass(frozen=True)
class TriggerTimer:
    address: Address
    name: str
    timer_id: int


SimCommand = Union[DeliverMessage, TriggerTimer]


class SimTransport(Transport):
    """Addresses are arbitrary hashables (conventionally strings)."""

    def __init__(self, logger: Optional[Logger] = None):
        self.logger = logger or PrintLogger()
        self.actors: dict[Address, Actor] = {}
        self.messages: list[SimMessage] = []
        self.timers: dict[int, SimTimer] = {}
        self.partitioned: set[Address] = set()
        self.history: list[SimCommand] = []
        self._ids = itertools.count()
        # paxload (serve/): destinations with a bounded client-lane
        # inbox -- address -> that actor's AdmissionController -- the
        # per-destination count of buffered client-lane frames, and
        # those frames themselves in arrival order (so drop-oldest is
        # an O(capacity) deque pop, not a frame_lane scan of the whole
        # buffer). All three dicts stay empty unless a registered actor
        # carries an admission controller with an inbox capacity, so
        # the admission-off hot path pays one falsy-dict test per send.
        self._inbox_policies: dict[Address, object] = {}
        self._inbox_depth: dict[Address, int] = {}
        self._client_inbox: dict[Address, deque] = {}
        # ``_consumed`` tombstones message ids a wave loop has delivered
        # but not yet compacted out of ``messages`` (the public buffer
        # stays a plain list for the adversarial API). Non-empty ONLY
        # inside a wave loop: every public entry point compacts first.
        # ``_addr_ids`` interns addresses to ints for the vectorized
        # drop masks (ops/simwave.py).
        self._consumed: set[int] = set()
        self._addr_ids: dict[Address, int] = {}
        # Frames shed by drop-oldest while they sat in an in-flight
        # wave (already spliced from ``messages``): the wave engine
        # must not deliver them. Only ever populated when an admission
        # policy is armed.
        self._wave_shed: set[int] = set()
        #: Record delivered/triggered events into ``history``. The
        #: default matches the reference; long runs (the cluster bench)
        #: disable it -- history is an append-only list of per-event
        #: dataclasses that no oracle there reads.
        self.record_history: bool = True

    # --- Transport API ----------------------------------------------------
    def register(self, address: Address, actor: Actor) -> None:
        if address in self.actors:
            raise ValueError(f"an actor is already registered at {address}")
        self.actors[address] = actor
        if actor.admission is not None:
            self.note_admission(address, actor)

    def note_admission(self, address: Address, actor: Actor) -> None:
        """Arm the bounded client-lane inbox for ``address``. Called
        from register() when the controller predates registration, and
        by roles that attach one AFTER ``Actor.__init__`` registered
        them (the usual order: options are parsed in the subclass
        constructor)."""
        admission = actor.admission
        if admission is not None and admission.options.inbox_capacity:
            from frankenpaxos_tpu_torch.serve.lanes import (
                LANE_CLIENT,
                frame_lane,
            )

            if self._consumed:
                self._compact_messages()
            self._inbox_policies[address] = admission
            # Recompute rather than trust stale state: a crash ->
            # restart leaves the dead incarnation's frames buffered
            # (the network does not know about the crash) and they
            # deliver to whatever re-registers here.
            self._client_inbox[address] = deque(
                m for m in self.messages
                if m.dst == address and frame_lane(m.data) == LANE_CLIENT)
            self._inbox_depth[address] = len(self._client_inbox[address])

    def send(self, src: Address, dst: Address, data: bytes) -> None:
        tracked = False
        if self._inbox_policies:
            verdict = self._admit_to_inbox(src, dst, data)
            if not verdict:
                return
            tracked = verdict == "track"
        tracer = self.tracer
        trace = tracer.current if tracer is not None else None
        message = SimMessage(next(self._ids), src, dst, data, trace)
        self.messages.append(message)
        if tracked:
            self._client_inbox.setdefault(dst, deque()).append(message)

    def _admit_to_inbox(self, src: Address, dst: Address,
                        data: bytes) -> Optional[str]:
        """Bounded-inbox enforcement for ``dst`` (serve/admission.py).
        Only CLIENT-lane frames count against (or are ever shed from)
        the bound; control-plane frames always buffer. Returns None
        when the frame must NOT be buffered (reject-newest) -- the
        ONLY falsy verdict, chaos tests hook this to assert control
        frames are never refused -- "buffer" for frames outside the
        bound, or "track" for client-lane frames counted against it
        (mirrored in ``_client_inbox``)."""
        admission = self._inbox_policies.get(dst)
        if admission is None:
            return "buffer"
        from frankenpaxos_tpu_torch.serve.lanes import LANE_CLIENT, frame_lane

        if frame_lane(data) != LANE_CLIENT:
            return "buffer"
        depth = self._inbox_depth.get(dst, 0)
        if admission.inbox_full(depth):
            if admission.options.inbox_policy == "drop":
                # Drop-oldest: shed the longest-waiting client frame
                # (it has aged the most; the newest arrival has the
                # best chance of completing inside its deadline).
                # _client_inbox mirrors the buffered client-lane
                # frames in arrival order, so this is O(capacity).
                pending = self._client_inbox.get(dst)
                while pending:
                    oldest = pending.popleft()
                    if self._remove_buffered(oldest):
                        break
                    # Not buffered: the frame sits in an in-flight
                    # wave (spliced out ahead of delivery -- mark it
                    # shed so the wave engine skips it, else a frame
                    # the admission controller counted as dropped
                    # would still reach its handler; ids are never
                    # reused, so a stale mark is inert) or was removed
                    # out-of-band (same marking, same inertness).
                    self._wave_shed.add(oldest.id)
                    break
                admission.note_shed("drop-oldest")
                depth -= 1
            else:
                # Reject-newest: never buffered, and the client hears
                # about it NOW -- synthesize the Rejected wire replies
                # (extended tag page) from the would-be receiver.
                admission.note_shed("reject-newest")
                self._send_reject_replies(dst, data)
                return None
        self._inbox_depth[dst] = depth + 1
        admission.note_inbox_depth(depth + 1)
        return "track"

    def _send_reject_replies(self, dst: Address, data: bytes) -> None:
        from frankenpaxos_tpu_torch.runtime.serializer import (
            DEFAULT_SERIALIZER,
        )
        from frankenpaxos_tpu_torch.serve.admission import reject_replies_for
        from frankenpaxos_tpu_torch.serve.messages import REASON_QUEUE

        admission = self._inbox_policies[dst]
        try:
            message = DEFAULT_SERIALIZER.from_bytes(data)
        except ValueError:
            return  # corrupt frame: nothing to reject, just shed
        for client, reply in reject_replies_for(
                message, admission.retry_after_ms(), REASON_QUEUE):
            self.messages.append(SimMessage(
                next(self._ids), dst, client,
                DEFAULT_SERIALIZER.to_bytes(reply), None))

    def send_no_flush(self, src: Address, dst: Address, data: bytes) -> None:
        self.send(src, dst, data)

    def flush(self, src: Address, dst: Address) -> None:
        pass

    def timer(self, address: Address, name: str, delay_s: float,
              f: Callable[[], None]) -> SimTimer:
        # Registration happens in SimTimer.start(): self.timers holds
        # running timers only (see SimTimer.start).
        return SimTimer(self, next(self._ids), address, name, delay_s, f)

    # --- test / simulator API (FakeTransport.scala:142-230) ---------------
    def running_timers(self) -> list[SimTimer]:
        return [t for t in self.timers.values() if t.running]

    def deliver_message(self, message: SimMessage) -> None:
        """Remove ``message`` from the buffer and run the destination's
        ``receive`` inline. Unknown/partitioned destinations drop."""
        actor = self._deliver(message)
        if actor is not None:
            self._drain(actor)

    def _drain(self, actor: Actor) -> None:
        tracer = self.tracer
        if tracer is None:
            actor.on_drain()
            return
        with tracer.drain_span(str(actor.address)):
            actor.on_drain()

    # --- the buffer bookkeeping ------------------------------------------
    def _remove_buffered(self, message: SimMessage) -> bool:
        """Consume ``message`` from the buffer: scan by id (an integer
        compare per probe), then verify FULL equality on the hit, so a
        message recorded from a different execution with the same id
        reads as "no longer applies", as a remove-by-equality would.
        Ids are unique in the buffer, so one probe decides."""
        if self._consumed:
            self._compact_messages()
        mid = message.id
        messages = self.messages
        for i, m in enumerate(messages):
            if m.id == mid:
                if m == message:
                    del messages[i]
                    return True
                return False
        return False

    def _compact_messages(self) -> None:
        """Apply pending wave tombstones to the public buffer list."""
        if self._consumed:
            consumed = self._consumed
            self.messages[:] = [m for m in self.messages
                                if m.id not in consumed]
            consumed.clear()

    def _consume_buffered(self, wave) -> None:
        """Tombstone a delivered wave; compact once the dead fraction
        dominates (amortized O(1) per message -- each compaction
        removes at least half the list)."""
        consumed = self._consumed
        for message in wave:
            consumed.add(message.id)
        if (len(consumed) > 1024
                and 2 * len(consumed) >= len(self.messages)):
            self._compact_messages()

    def _deliver(self, message: SimMessage) -> Optional[Actor]:
        """Deliver without draining; returns the receiving actor (None if
        the message was dropped) so callers control drain granularity."""
        if not self._remove_buffered(message):
            self.logger.warn(f"delivering unbuffered message {message}")
            return None
        if self._inbox_policies and message.dst in self._inbox_policies:
            self._note_inbox_delivery(message)
        if (message.dst in self.partitioned
                or message.src in self.partitioned):
            # Dropped at the partition: not part of the delivered
            # history.
            return None
        if self.record_history:
            self.history.append(DeliverMessage(message))
        actor = self.actors.get(message.dst)
        if actor is None:
            self.logger.warn(f"no actor registered at {message.dst}")
            return None
        tracer = self.tracer
        if tracer is None:
            actor.receive(message.src,
                          actor.serializer.from_bytes(message.data))
            return actor
        # Traced delivery: decode and handler run as drain-stage
        # sub-spans of the per-message receive span, which is parented
        # by the frame's propagated context (message.trace).
        self._traced_receive(actor, message)
        return actor
        return actor

    def trigger_timer(self, timer_id: int) -> None:
        timer = self.timers.get(timer_id)
        if timer is None or not timer.running:
            return
        if timer.address in self.partitioned:
            timer.stop()
            return
        if self.record_history:
            self.history.append(
                TriggerTimer(timer.address, timer.name, timer_id))
        tracer = self.tracer
        if tracer is None:
            timer.run()
            return
        with tracer.timer_span(str(timer.address), timer.name):
            timer.run()

    def run_command(self, command: SimCommand) -> None:
        if isinstance(command, DeliverMessage):
            self.deliver_message(command.message)
        else:
            self.trigger_timer(command.timer_id)

    def possible_commands(self) -> list[SimCommand]:
        """Everything that could happen next (FakeTransport.scala:196-220)."""
        if self._consumed:
            self._compact_messages()
        commands: list[SimCommand] = [DeliverMessage(m)
                                      for m in self.messages]
        commands.extend(TriggerTimer(t.address, t.name, t.id)
                        for t in self.running_timers())
        return commands

    def generate_command(self, rng) -> Optional[SimCommand]:
        """Pick a random next step, weighting deliveries vs. timers by
        availability (the spirit of FakeTransport.generateCommand)."""
        if self._consumed:
            self._compact_messages()
        n_msgs = len(self.messages)
        running = self.running_timers()
        total = n_msgs + len(running)
        if total == 0:
            return None
        i = rng.randrange(total)
        if i < n_msgs:
            return DeliverMessage(self.messages[i])
        return TriggerTimer(running[i - n_msgs].address,
                            running[i - n_msgs].name,
                            running[i - n_msgs].id)

    def deliver_all(self, max_steps: int = 100000) -> int:
        """FIFO-deliver until no messages remain (no timers), draining
        after EVERY message. Convenience for non-adversarial
        integration tests."""
        return self._deliver_fifo(max_steps, coalesce=False)

    def deliver_all_coalesced(self, max_steps: int = 100000) -> int:
        """FIFO-deliver in WAVES, draining each touched actor once per
        wave -- the delivery semantics of the real event loop
        (TcpTransport defers ``on_drain`` to the end of a loop pass, so
        a burst of frames lands in one drain). A wave is the set of
        messages buffered when it starts; sends made during the wave
        join the next one. This is the right mode for benchmarking
        batch-amortized actors over SimTransport; adversarial sims keep
        per-message drains (``deliver_message``)."""
        return self._deliver_fifo(max_steps, coalesce=True)

    # --- the wave engine ----------------------------------------------------
    def _wave_fast_path_ok(self) -> bool:
        """Whether the wave engine may splice the buffer and dispatch
        waves directly. False when delivery is intercepted -- an
        instance-wrapped ``deliver_message``, or a subclass pinning a
        ``_deliver`` not in ``WAVE_SAFE_DELIVERS`` -- so every delivered
        frame still flows through the interceptor via the per-message
        compat loop."""
        return ("deliver_message" not in self.__dict__
                and type(self)._deliver in WAVE_SAFE_DELIVERS)

    def _deliver_fifo(self, max_steps: int, coalesce: bool) -> int:
        """The ONE parameterized FIFO drain loop (both public modes
        differ only in drain granularity). Waves are buffer-prefix
        snapshots: sends made by handlers append behind the snapshot
        and join the next wave, which reproduces the legacy loops'
        strict send-order delivery exactly."""
        if not self._wave_fast_path_ok():
            return self._deliver_fifo_compat(max_steps, coalesce)
        steps = 0
        messages = self.messages
        while messages and steps < max_steps:
            wave = messages[:max_steps - steps]
            del messages[:len(wave)]
            self._drop_schedule_stamps(wave)
            steps += len(wave)
            self._run_wave(wave, coalesce)
        return steps

    def _drop_schedule_stamps(self, wave) -> None:
        """Scheduler-policy hook: consume any per-frame scheduling
        state for frames leaving the buffer outside the policy's own
        loop (the geo transport pops arrival stamps here, so a FIFO
        drain can never leave a stale stamp for ``run_until`` to
        double-deliver)."""

    def _deliver_fifo_compat(self, max_steps: int, coalesce: bool) -> int:
        """Per-message fallback: identical delivery order and drain
        granularity, routed through ``deliver_message``/``_deliver`` so
        interceptors observe every step."""
        steps = 0
        while self.messages and steps < max_steps:
            if not coalesce:
                self.deliver_message(self.messages[0])
                steps += 1
                continue
            wave = list(self.messages[:max_steps - steps])
            touched: list[Actor] = []
            seen: set[int] = set()
            for message in wave:
                actor = self._deliver(message)
                steps += 1
                if actor is not None and id(actor) not in seen:
                    seen.add(id(actor))
                    touched.append(actor)
            for actor in touched:
                self._drain(actor)
        return steps

    def _wave_keep_mask(self, wave) -> Optional[np.ndarray]:
        """Vectorized drop mask over a wave (True = deliver), or None
        to decide per message via ``_per_message_check`` -- small waves
        skip array staging entirely (ops/simwave.WAVE_VECTOR_MIN)."""
        if not self.partitioned or len(wave) < simwave.WAVE_VECTOR_MIN:
            return None
        n = len(wave)
        intern = self._intern
        src = np.fromiter((intern(m.src) for m in wave), np.int64, n)
        dst = np.fromiter((intern(m.dst) for m in wave), np.int64, n)
        blocked = np.fromiter((intern(a) for a in self.partitioned),
                              np.int64, len(self.partitioned))
        return simwave.keep_mask(src, dst, blocked)

    def _per_message_check(self) -> Optional[Callable]:
        """Scalar drop check used when ``_wave_keep_mask`` returned
        None; None means nothing can drop (no partitions)."""
        part = self.partitioned
        if not part:
            return None
        return lambda m: m.src not in part and m.dst not in part

    def _intern(self, address) -> int:
        ids = self._addr_ids
        aid = ids.get(address)
        if aid is None:
            aid = ids[address] = len(ids)
        return aid

    def _run_wave(self, wave, coalesce: bool) -> int:
        """Deliver one wave. PRECONDITION: the wave's frames are
        already consumed from the buffer (prefix splice or tombstones).
        Returns the number of frames that reached an actor.

        Delivery order is exactly per-message FIFO; the only batching
        is that consecutive frames to one destination hand off through
        ``Actor.receive_batch`` when (a) drains are coalesced and (b)
        the actor OVERRIDES it -- the default body replays decode +
        ``receive`` in order, so grouping is order-equivalent by
        construction."""
        keep = self._wave_keep_mask(wave)
        check = self._per_message_check() if keep is None else None
        actors = self.actors
        record = self.record_history
        history = self.history
        tracer = self.tracer
        touched: dict[int, Actor] = {}
        delivered = 0
        inbox = bool(self._inbox_policies)
        shed = self._wave_shed if inbox or self._wave_shed else None
        n = len(wave)
        i = 0
        while i < n:
            message = wave[i]
            if shed and message.id in shed:
                # Drop-oldest shed this frame out of the in-flight wave
                # (a handler's send overflowed the bounded inbox
                # mid-wave); per-message delivery would have found it
                # unbuffered and skipped it -- before any inbox
                # accounting.
                shed.discard(message.id)
                i += 1
                continue
            if inbox:
                # BEFORE the drop mask: _deliver decrements the
                # bounded-inbox depth even for frames a partition then
                # drops (the frame left the buffer either way).
                self._note_inbox_delivery(message)
            if (keep is not None and not keep[i]) or \
                    (check is not None and not check(message)):
                # Dropped at a partition (or, in the geo subclass, a
                # downed link): consumed, no history entry, no drain.
                i += 1
                continue
            dst = message.dst
            actor = actors.get(dst)
            if record:
                history.append(DeliverMessage(message))
            if actor is None:
                self.logger.warn(f"no actor registered at {dst}")
                i += 1
                continue
            if tracer is not None:
                self._traced_receive(actor, message)
                delivered += 1
                i += 1
            elif (coalesce and type(actor).receive_batch
                    is not Actor.receive_batch):
                j = i + 1
                while (j < n and wave[j].dst == dst
                       and (keep[j] if keep is not None
                            else check is None or check(wave[j]))
                       and not (shed and wave[j].id in shed)):
                    j += 1
                run = wave[i:j]
                for m in run[1:]:
                    if inbox:
                        self._note_inbox_delivery(m)
                    if record:
                        history.append(DeliverMessage(m))
                actor.receive_batch([(m.src, m.data) for m in run])
                delivered += j - i
                i = j
            else:
                actor.receive(message.src,
                              actor.serializer.from_bytes(message.data))
                delivered += 1
                i += 1
            if coalesce:
                if id(actor) not in touched:
                    touched[id(actor)] = actor
            else:
                self._drain(actor)
        if coalesce:
            for actor in touched.values():
                self._drain(actor)
        return delivered

    def _traced_receive(self, actor: Actor, message: SimMessage) -> None:
        """Per-message traced delivery: the wave engine never groups
        under a tracer, so span structure matches the per-message path
        byte for byte."""
        tracer = self.tracer
        span = tracer.receive_span(str(message.dst), "?", message.trace)
        with span:
            with tracer.stage("decode"):
                decoded = actor.serializer.from_bytes(message.data)
            span.name = (f"receive:{type(decoded).__name__}"
                         f"@{message.dst}")
            with tracer.stage("handler"):
                actor.receive(message.src, decoded)

    def _note_inbox_delivery(self, message: SimMessage) -> None:
        """Bounded-inbox accounting for one frame that left the buffer
        (per-message ``_deliver`` and the wave engine alike)."""
        if message.dst not in self._inbox_policies:
            return
        from frankenpaxos_tpu_torch.serve.lanes import LANE_CLIENT, frame_lane

        if frame_lane(message.data) != LANE_CLIENT:
            return
        self._inbox_depth[message.dst] = max(
            0, self._inbox_depth.get(message.dst, 0) - 1)
        pending = self._client_inbox.get(message.dst)
        if pending:
            # Usually the leftmost (FIFO delivery); adversarial sims
            # deliver out of order, but the deque is capacity-bounded
            # so remove() stays O(capacity).
            if pending[0] is message:
                pending.popleft()
            else:
                try:
                    pending.remove(message)
                except ValueError:
                    pass

    def partition(self, address: Address) -> None:
        self.partitioned.add(address)

    def heal(self, address: Address) -> None:
        self.partitioned.discard(address)

    def crash(self, address: Address) -> None:
        """Process crash (``kill -9``) for the actor at ``address``:
        deregister it and destroy its timers -- every piece of volatile
        state dies with the object, including anything it staged for a
        group commit that never happened. In-flight messages to the
        address stay buffered (the network does not know about the
        crash): they deliver to whatever re-registers there -- the
        restarted actor, whose durable state must make that safe -- or
        drop as 'no actor registered' if nothing does. The restart is
        the harness's job."""
        if self.tracer is not None:
            self.tracer.event(f"crash {address}")
        self.actors.pop(address, None)
        # The bounded-inbox policy dies with its controller; the
        # restarted actor's register() re-attaches (and recomputes the
        # buffered depth) if it carries admission again.
        self._inbox_policies.pop(address, None)
        self._inbox_depth.pop(address, None)
        self._client_inbox.pop(address, None)
        for timer_id in [tid for tid, t in self.timers.items()
                         if t.address == address]:
            del self.timers[timer_id]


#: ``_deliver`` implementations the wave engine is allowed to bypass:
#: the base transport's, plus wave-aware subclasses that register here
#: (geo/transport.py). Any OTHER ``_deliver`` on the class disables the
#: fast path so per-message interception keeps working.
WAVE_SAFE_DELIVERS: set = {SimTransport._deliver}
