"""TcpTransport: the production transport (asyncio); the port's copy of
``frankenpaxos_tpu/runtime/tcp_transport.py``.

Reference behavior: NettyTcpTransport.scala:124-505 --

  * one event-loop thread for everything (``NioEventLoopGroup(1)``,
    NettyTcpTransport.scala:240) -> here: one asyncio loop; ``receive``
    and timer callbacks run serially on it, preserving the single-thread
    contract;
  * 4-byte length-prefixed frames, 10 MiB max
    (``LengthFieldBasedFrameDecoder(10485760, 0, 4, 0, 4)``,
    NettyTcpTransport.scala:353,417);
  * lazy connection establishment with pending-message buffering
    (NettyTcpTransport.scala:377-445), channel map keyed
    ``(local_actor_address, remote_address)``
    (NettyTcpTransport.scala:268-271);
  * ``send_no_flush`` + ``flush`` write coalescing
    (NettyTcpTransport.scala:455-495);
  * timers scheduled on the same loop (NettyTcpTransport.scala:78-122).

Addresses are ``(host, port)`` tuples. Each frame is prefixed by the
sender's address (so the receiving actor sees a meaningful ``src``),
mirroring the reference where inbound connections learn the remote actor
address from the channel.

paxwire (docs/TRANSPORT.md): with ``batching=True`` (the default) the
send path is DRAIN-GRANULAR -- ``send`` queues ``(header, payload)``
entries and one flush per event-loop pass turns a connection's backlog
into batch frames (adjacent same-type messages -> one frame, Phase2b
ack streams -> run-granular ack ranges via registered coalescers) and
pushes the whole thing out with ONE ``socket.sendmsg`` scatter/gather
writev over the original payload bytes -- no per-frame encode, no
per-frame ``bytes`` join, no per-message syscall. ``batching=False``
preserves the historical frame-per-message path (the A/B baseline arm
in ``bench/transport_lt.py``). The receive path scans the inbound
buffer over an offset cursor (no re-copy per scan pass) and expands
batch frames back into their original messages before delivery, so
actors see per-message semantics unchanged.

The frame format is the reference's, byte for byte, so a port process
and a JAX process talk over one socket. A frame header may carry a
trace context (``host:port|<ctx>``, from a traced JAX sender); it
parses and the context is ignored, since the port has no tracer yet.
An actor's admission controller (``serve/admission.py``) gets inbound
client-lane shedding at delivery (a bounded inbox per drain, CoDel's
drain delay); an actor's ingest wire sinks (``Actor.wire_sinks``) take
whole undecoded payloads by their leading tag. Not ported yet, and
refused: a tracer (ROADMAP.md queue 1 item 8.5).
The reference's link-fault seam (``link_faults``) comes with its chaos
harness (item 11).
The runtime-metrics sink gets the drain stages (``observe_stage``); the
transport's own counters are the ``stat_*`` attributes.
"""

from __future__ import annotations

import asyncio
import os
import struct
import threading
import time
from typing import Callable, Optional

from frankenpaxos_tpu_torch.runtime import paxwire
from frankenpaxos_tpu_torch.runtime.actor import Actor
from frankenpaxos_tpu_torch.runtime.logger import Logger, PrintLogger
from frankenpaxos_tpu_torch.runtime.transport import Address, Timer, Transport

MAX_FRAME = 10 * 1024 * 1024  # 10 MiB, like the reference's frame decoder
_LEN = struct.Struct(">I")

_frame_lane_fn = None


def _get_frame_lane():
    """serve.lanes.frame_lane, lazily bound once (serve imports at
    module scope would cycle; a per-send module import would cost a
    sys.modules lookup on the hot path)."""
    global _frame_lane_fn
    if _frame_lane_fn is None:
        from frankenpaxos_tpu_torch.serve.lanes import frame_lane
        _frame_lane_fn = frame_lane
    return _frame_lane_fn


def _encode_frame(src: Address, data: bytes) -> bytes:
    # The framing hot path runs through the native C++ codec when built
    # (frankenpaxos_tpu_torch/native/codec.cpp), with an identical
    # pure-Python fallback inside `native.encode_frame`.
    from frankenpaxos_tpu_torch import native

    host, port = src
    return native.encode_frame(f"{host}:{port}".encode(), data)


class TcpTimer(Timer):
    def __init__(self, loop: asyncio.AbstractEventLoop, name: str,
                 delay_s: float, f: Callable[[], None],
                 transport: "Optional[TcpTransport]" = None,
                 address: Optional[Address] = None):
        self._loop = loop
        self._name = name
        self._delay_s = delay_s
        self._f = f
        self._transport = transport
        self._address = address
        self._handle: Optional[asyncio.TimerHandle] = None

    @property
    def name(self) -> str:
        return self._name

    def start(self) -> None:
        self._loop.call_soon_threadsafe(self._start_on_loop)

    def _start_on_loop(self) -> None:
        if self._handle is None:
            self._handle = self._loop.call_later(self._delay_s, self._fire)

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._stop_on_loop)

    def set_delay(self, delay_s: float) -> None:
        self._delay_s = delay_s

    def _stop_on_loop(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def _fire(self) -> None:
        self._handle = None
        if self._transport is not None:
            self._transport._check_untraced()
        self._f()


class _Conn:
    """One outbound connection with lazy connect + pending buffer
    (NettyTcpTransport.scala:377-445). The buffer is BOUNDED
    (paxload): a slow or dead peer must not grow it without limit --
    past the cap pending entries drop client-lane-oldest-first (the
    control plane is never shed behind client batches; at-most-once
    transport, protocol resends cover) and the stall is counted.

    ``pending`` holds ``(header, payload, lane, size)`` entries: the
    frame header bytes, the message payload bytes (frame assembly is
    deferred to the flush's batch planner), the frame lane for shed
    priority, and the entry's accounted wire size. The legacy
    per-frame arm (``batching=False``) stores the fully encoded frame
    in ``payload`` with ``header=None``."""

    __slots__ = ("writer", "pending", "pending_bytes", "connecting",
                 "header0")

    def __init__(self):
        self.writer: Optional[asyncio.StreamWriter] = None
        self.pending: list = []
        self.pending_bytes = 0
        self.connecting = False
        # The encoded frame header, cached per connection: the per-send
        # f-string format + encode was measurable at batched rates.
        self.header0: Optional[bytes] = None


class TcpTransport(Transport):
    """Run the loop either externally (``await serve()``) or on a daemon
    thread (``start()``) for synchronous callers like the CLI mains."""

    threaded = True

    #: Per-connection outbound buffer cap in bytes (paxload). Past it
    #: the OLDEST pending frames drop -- within the at-most-once
    #: transport contract, like the dead-writer loss path above -- and
    #: ``stat_outbound_dropped`` counts the overflow. Large
    #: enough that only a genuinely wedged/slow peer ever hits it.
    outbound_buffer_cap = 16 * 1024 * 1024

    #: Use ``socket.sendmsg`` scatter/gather output when the platform
    #: and the asyncio transport allow it (class-level so tests can
    #: force the contiguous-write fallback and assert bit-identity).
    use_sendmsg = True

    def __init__(self, listen_address: Optional[Address] = None,
                 logger: Optional[Logger] = None,
                 batching: bool = True):
        self.logger = logger or PrintLogger()
        self.listen_address = listen_address
        #: paxwire drain-granular batching; False = the historical
        #: frame-per-message path (the transport_lt baseline arm).
        self.batching = batching
        self.actors: dict[Address, Actor] = {}
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._conns: dict[tuple[Address, Address], _Conn] = {}
        self._servers: dict[Address, asyncio.AbstractServer] = {}
        self._drain_scheduled: set = set()
        # Connections with unflushed sends this event-loop pass; one
        # call_soon drains them all (_flush_pass) so every message a
        # drain produces rides one writev per peer.
        self._flush_queue: list = []
        self._flush_dirty: set = set()
        self._flush_scheduled = False
        # Transport counters (the transport_lt A/B instruments these).
        # "syscalls" counts our sendmsg calls plus writer.write calls
        # (asyncio issues one send per uncongested write) -- the
        # syscalls/cmd proxy the A/B gate records.
        self.stat_syscalls = 0
        self.stat_flushes = 0
        self.stat_frames = 0
        self.stat_messages = 0
        self.stat_batch_bytes = 0
        self.stat_coalesced_acks = 0
        self.stat_outbound_dropped = 0
        #: Payloads a wire sink took whole, and the messages they held.
        self.stat_sink_frames = 0
        self.stat_sink_messages = 0
        # CLIENT-lane messages in the current drain batch -- the
        # bounded-inbox measure (serve/lanes.py): only client frames
        # may count against (or be shed by) admission_inbox_capacity;
        # a Phase1b/watermark burst must never trip it.
        self._client_batch_depth: dict = {}
        self._batch_t0: dict = {}     # first delivery time (CoDel)
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    # --- lifecycle --------------------------------------------------------
    async def serve(self) -> None:
        """Bind (if a listen address was given) and run until cancelled."""
        self._check_untraced()
        self.loop = asyncio.get_running_loop()
        if self.listen_address is not None:
            await self._bind(self.listen_address)
        for address in list(self.actors):
            if isinstance(address, tuple):  # registered before start()
                await self._bind(address)
        self._started.set()
        try:
            await asyncio.Event().wait()  # run forever
        finally:
            await self._shutdown()

    async def _bind(self, address: Address) -> None:
        if address in self._servers:
            return
        import functools

        host, port = address
        self._servers[address] = await asyncio.start_server(
            functools.partial(self._handle_conn, local=address),
            host, port)

    def start(self) -> None:
        """Spawn the event loop on a daemon thread and wait until bound."""
        self._check_untraced()
        def runner():
            try:
                asyncio.run(self.serve())
            except asyncio.CancelledError:
                pass

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("TcpTransport failed to start")

    def stop(self) -> None:
        if self.loop is not None:
            self.loop.call_soon_threadsafe(
                lambda: [t.cancel() for t in asyncio.all_tasks(self.loop)])
        if self._thread is not None:
            self._thread.join(timeout=5)

    async def _shutdown(self) -> None:
        for server in self._servers.values():
            server.close()
        for conn in self._conns.values():
            if conn.writer is not None:
                conn.writer.close()

    # --- inbound ----------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           local: Address) -> None:
        # Chunked reads + a native frame scan (codec.cpp
        # fpx_scan_frames) instead of two awaits per frame: a burst of
        # small frames costs ONE read syscall and one scan, and every
        # complete frame in the chunk dispatches in the same loop pass
        # (so they land in one actor drain; see _deliver). The scan
        # rides an OFFSET CURSOR into the growing bytearray: the old
        # ``scan_frames(bytes(buf))`` re-copied the whole inbound
        # buffer every 4096-frame pass (quadratic on deep backlogs),
        # and the per-pass ``del buf[:consumed]`` memmoved the tail the
        # same way -- now the prefix compacts only when it is large.
        from frankenpaxos_tpu_torch import native

        buf = bytearray()
        pos = 0  # buf[:pos] is already dispatched
        try:
            while True:
                chunk = await reader.read(1 << 16)
                if not chunk:
                    break
                buf += chunk
                # Dispatch every complete frame currently buffered.
                # The head-frame length check gates each scan: while a
                # large frame is still arriving, each chunk costs one
                # unpack and no rescan of the whole buffer; the
                # oversize check is against the frame's DECLARED
                # length, never the buffer size (a near-cap frame
                # pipelined with the next frame's first bytes is
                # legitimate). The inner loop re-scans because the
                # native scanner caps one pass at 4096 frames -- a
                # single pass over a deeper backlog would strand the
                # remainder until the peer happened to send more.
                while len(buf) - pos >= 4:
                    (inner,) = _LEN.unpack_from(buf, pos)
                    if inner > MAX_FRAME:
                        self.logger.error(
                            f"oversized frame ({inner} bytes)")
                        return
                    if len(buf) - pos < 4 + inner:
                        break
                    try:
                        frames, pos = native.scan_frames(buf, offset=pos)
                    except ValueError as e:  # a mid-buffer oversized frame
                        self.logger.error(str(e))
                        return
                    for start, end in frames:
                        if not self._dispatch_frame(buf, start, end,
                                                    local):
                            return
                # Compact the dispatched prefix only when it is big
                # enough to matter (or the buffer is fully consumed):
                # each del memmoves the tail, so doing it per pass is
                # the quadratic copy this cursor exists to avoid.
                if pos and (pos >= len(buf) or pos >= (1 << 18)):
                    del buf[:pos]
                    pos = 0
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    def _dispatch_frame(self, buf: bytearray, start: int, end: int,
                        local: Address) -> bool:
        """Parse, decode, and deliver one wire frame (batch frames
        expand to their segments). False = corrupt frame, drop the
        connection.

        A corrupt frame (bad header length, non-UTF8 header, malformed
        port, message decode error, torn batch table) must not kill
        the connection task with an unretrieved exception: log it and
        drop the connection cleanly. Only parse/decode runs under the
        corrupt-frame guard -- exceptions from the actor's own
        ``receive()`` on a VALID frame are a different failure class
        and propagate (a FatalError from logger.fatal must stay fatal,
        matching the reference's crash-the-process check semantics,
        Logger.scala:62-117)."""
        try:
            (hlen,) = _LEN.unpack_from(buf, start)
            if hlen > end - start - 4:
                raise ValueError(
                    f"header length {hlen} exceeds frame "
                    f"payload {end - start - 4}")
            header = bytes(
                buf[start + 4:start + 4 + hlen]).decode()
            # ``host:port|<ctx>`` -- the address part first, then an
            # optional trace context from a traced sender, which this
            # untraced receiver ignores.
            addr_part = header.partition("|")[0]
            host, _, port = addr_part.rpartition(":")
            src: Address = (host, int(port))
            data = bytes(buf[start + 4 + hlen:end])
            # The frame's actor, resolved ONCE (decode below reuses it,
            # so the wire-sink check costs one attribute test net).
            actor = self._actor_for(local)
            metrics = self.runtime_metrics
            # paxingest wire-sink fast path (Actor.wire_sinks): hand a
            # whole undecoded payload to the actor's column parser --
            # no per-message decode, no expansion. Only the PARSE runs
            # under this corrupt-frame guard; the handler runs below
            # with ordinary handler semantics. Bypassed under a tracer
            # (per-message span semantics win).
            fast = None
            sinks = getattr(actor, "wire_sinks", None)
            if sinks is not None and self.tracer is None:
                sink = sinks.get(paxwire.leading_tag(data))
                if sink is not None:
                    if metrics is not None:
                        p0 = time.perf_counter()
                        parsed = sink[0](data)
                        metrics.observe_stage(
                            "decode", time.perf_counter() - p0)
                    else:
                        parsed = sink[0](data)
                    if parsed is not None:
                        fast = (actor, sink[1], parsed)
            if fast is not None:
                segments = ()
            elif paxwire.is_batch_payload(data):
                segments = paxwire.split_batch(data)
            else:
                segments = (data,)
            deliveries = []
            for segment in segments:
                if metrics is not None:
                    # The drain-stage histogram sees EVERY decode.
                    p0 = time.perf_counter()
                    delivery = self._decode(local, src, segment,
                                            actor)
                    if delivery is not None:
                        metrics.observe_stage(
                            "decode", time.perf_counter() - p0)
                else:
                    delivery = self._decode(local, src, segment,
                                            actor)
                if delivery is not None:
                    deliveries.append(delivery)
        except Exception as e:
            self.logger.error(
                f"dropping connection on corrupt frame: {e!r}")
            return False
        if fast is not None:
            actor, handler, parsed = fast
            # Handler semantics match receive(): exceptions on a VALID
            # frame propagate (a FatalError stays fatal).
            handler(src, parsed)
            self.stat_sink_frames += 1
            self.stat_sink_messages += parsed.count
            # The client-lane bounded-inbox measure is NOT fed:
            # admission at sink granularity is the sink handler's job.
            self._schedule_drain(actor)
            return True
        for delivery in deliveries:
            self._deliver(*delivery)
        return True

    def _actor_for(self, local: Address):
        """The registered actor for frames arriving on ``local``: each
        registered actor (the role itself plus any embedded
        election/heartbeat participants) listens on its own port."""
        actor = self.actors.get(local)
        if actor is None and self.listen_address is not None:
            actor = self.actors.get(self.listen_address)
        return actor

    def _decode(self, local: Address, src: Address, data: bytes,
                actor: "Actor | None" = None):
        """Frame payload -> (actor, src, message), or None if no actor
        is registered. Decode errors propagate to the caller's
        corrupt-frame guard. ``actor`` skips re-resolving when the
        caller already did (_dispatch_frame resolves once per frame)."""
        if actor is None:
            actor = self._actor_for(local)
        if actor is None:
            self.logger.warn(f"dropping frame from {src} to {local}: "
                             f"no registered actor")
            return None
        return actor, src, actor.serializer.from_bytes(data)

    def _deliver(self, actor: Actor, src: Address, message) -> None:
        expand = getattr(message, "__wire_expand__", None)
        if expand is not None:
            # A coalesced wire envelope (paxwire): flatten back into
            # the messages the sender queued -- admission and the
            # protocol handlers see per-message semantics.
            for inner in expand(actor.serializer):
                self._deliver(actor, src, inner)
            return
        admission = actor.admission
        if admission is not None and self._shed_inbound(actor, admission,
                                                        message):
            return
        metrics = self.runtime_metrics
        if metrics is not None:
            # The handler stage (usually the largest) reaches the
            # drain-stage histogram like every other stage.
            p0 = time.perf_counter()
            actor.receive(src, message)
            metrics.observe_stage("handler", time.perf_counter() - p0)
        else:
            actor.receive(src, message)
        if admission is not None and admission.options.inbox_capacity:
            from frankenpaxos_tpu_torch.serve.lanes import (
                LANE_CLIENT,
                message_lane,
            )

            if message_lane(message) == LANE_CLIENT:
                self._client_batch_depth[actor] = \
                    self._client_batch_depth.get(actor, 0) + 1
        self._schedule_drain(actor)

    def _schedule_drain(self, actor: Actor) -> None:
        """Defer on_drain to the end of this event-loop pass so every
        frame already buffered (a burst of Phase2bs) lands in ONE
        drain -- the batching the device kernels amortize over (the
        reference's event loop drains similarly: all readable frames,
        then flush). CoDel's sojourn clock starts at the batch's FIRST
        delivery; note_drain_delay closes it after on_drain."""
        if actor not in self._drain_scheduled:
            self._drain_scheduled.add(actor)
            admission = actor.admission
            if admission is not None \
                    and admission.options.codel_target_s:
                self._batch_t0[actor] = time.perf_counter()
            self.loop.call_soon(self._drain_actor, actor)

    def _shed_inbound(self, actor: Actor, admission, message) -> bool:
        """Bounded inbox + CoDel shedding at delivery (client lane
        only; serve/lanes.py). True = the frame was shed -- the client
        got an explicit Rejected instead of a handler call. TCP
        enforces reject-newest for both policies: already-delivered
        frames cannot be un-delivered, so drop-oldest only differs on
        SimTransport's buffered queue."""
        from frankenpaxos_tpu_torch.serve.lanes import (
            LANE_CLIENT,
            message_lane,
        )

        if message_lane(message) != LANE_CLIENT:
            return False
        if admission.shed_active():
            reason_queue = False
        elif admission.inbox_full(self._client_batch_depth.get(actor, 0)):
            reason_queue = True
        else:
            return False
        from frankenpaxos_tpu_torch.runtime.serializer import (
            DEFAULT_SERIALIZER,
        )
        from frankenpaxos_tpu_torch.serve.admission import reject_replies_for
        from frankenpaxos_tpu_torch.serve.messages import (
            REASON_CODEL,
            REASON_QUEUE,
        )

        admission.note_shed("reject-newest")
        for client, reply in reject_replies_for(
                message, admission.retry_after_ms(),
                REASON_QUEUE if reason_queue else REASON_CODEL):
            self._write(actor.address, client,
                        DEFAULT_SERIALIZER.to_bytes(reply), flush=True)
        return True

    def _drain_actor(self, actor: Actor) -> None:
        self._drain_scheduled.discard(actor)
        client_depth = self._client_batch_depth.pop(actor, 0)
        self._check_untraced()
        actor.on_drain()
        admission = actor.admission
        if admission is not None:
            t0 = self._batch_t0.pop(actor, None)
            if t0 is not None:
                admission.note_drain_delay(time.perf_counter() - t0)
            # Client-lane depth only: the gauge is the BOUNDED-inbox
            # depth (what inbox_full checks), not the all-lane drain
            # batch -- a healthy Phase2b burst must not read as a
            # client inbox spike (SimTransport reports the same).
            admission.note_inbox_depth(client_depth)

    def _check_untraced(self) -> None:
        if self.tracer is not None:
            raise NotImplementedError(
                "tracing spans are not ported yet (ROADMAP.md queue 1 "
                "item 8.5, obs/trace.py Tracer)")

    def listen_on(self, address: Address) -> None:
        """Bind a listener for ``address`` ahead of actor registration
        (used by supernode mode to make every role address reachable
        before any actor's construction-time sends go out)."""
        assert self.loop is not None, "transport not started"
        asyncio.run_coroutine_threadsafe(
            self._bind(address), self.loop).result(timeout=10)

    # --- Transport API ----------------------------------------------------
    def register(self, address: Address, actor: Actor) -> None:
        """Register ``actor`` and listen on its address.

        A role process hosts one main role actor plus embedded
        sub-actors (leader election, heartbeat participants), each with
        its own (host, port) from the cluster config: every registered
        address gets its own listener so remote peers can reach the
        sub-actors too (the reference runs them as Netty-registered
        actors on the shared event loop the same way).
        """
        if address in self.actors:
            raise ValueError(f"an actor is already registered at {address}")
        self.actors[address] = actor
        if self.loop is not None and address not in self._servers \
                and isinstance(address, tuple):
            if self._on_loop():
                task = self.loop.create_task(self._bind(address))
                task.add_done_callback(
                    lambda t: (not t.cancelled() and t.exception())
                    and self.logger.error(
                        f"bind {address} failed: {t.exception()!r}"))
            else:
                future = asyncio.run_coroutine_threadsafe(
                    self._bind(address), self.loop)
                future.result(timeout=10)

    def _conn_for(self, src: Address, dst: Address) -> _Conn:
        key = (src, dst)
        conn = self._conns.get(key)
        if conn is None:
            conn = _Conn()
            self._conns[key] = conn
        return conn

    def _header_for(self, conn: _Conn, src: Address) -> bytes:
        """The frame header bytes (``host:port``), cached per
        connection -- the per-send f-string format + encode was
        measurable at batched rates."""
        header = conn.header0
        if header is None:
            host, port = src
            header = conn.header0 = f"{host}:{port}".encode()
        return header

    def _write(self, src: Address, dst: Address, data: bytes,
               flush: bool) -> None:
        assert self.loop is not None, "transport not started"
        conn = self._conn_for(src, dst)
        if conn.writer is not None and conn.writer.is_closing():
            # The peer died (process crash / kill -9) or reset the
            # connection: drop the dead writer so this send triggers a
            # fresh lazy connect. Without this, every later message to
            # a RESTARTED role would pour into a closed socket forever
            # -- the failure mode the WAL chaos harness exists to
            # catch. Messages written into the dead socket before the
            # loss was detected are gone, which is within the
            # at-most-once transport contract; protocol resends cover
            # them.
            conn.writer = None
        lane = _get_frame_lane()(data)
        if self.batching:
            header = self._header_for(conn, src)
            if 4 + len(header) + len(data) > MAX_FRAME:
                # Same cap the receiver enforces -- but _write runs as
                # a loop callback (or inline inside a handler's send),
                # so raising here would abort the sending actor or
                # vanish into the loop's exception handler. Dropping
                # with a count is the documented at-most-once behavior
                # for an unsendable frame.
                self.stat_outbound_dropped += 1
                self.logger.error(
                    f"dropping {len(data)}-byte message to {dst}: "
                    f"frame exceeds the 10 MiB cap")
                return
            size = 12 + len(header) + len(data)
            conn.pending.append((header, data, lane, size))
        else:
            frame = _encode_frame(src, data)
            size = len(frame)
            conn.pending.append((None, frame, lane, size))
        conn.pending_bytes += size
        if conn.pending_bytes > self.outbound_buffer_cap:
            dropped = self._shed_outbound(conn)
            self.stat_outbound_dropped += dropped
            self.logger.warn(
                f"outbound buffer to {dst} over "
                f"{self.outbound_buffer_cap} bytes; dropped {dropped} "
                f"oldest frames, client lane first (peer slow or gone; "
                f"resends cover)")
        if conn.writer is not None:
            if flush:
                if self.batching:
                    self._schedule_flush(conn)
                else:
                    self._flush_conn(conn)
        elif not conn.connecting:
            conn.connecting = True
            self.loop.create_task(self._connect(conn, dst))

    def _shed_outbound(self, conn: _Conn) -> int:
        """Bounded outbound buffer (paxload): a slow or dead peer must
        not grow ``pending`` without limit (reachable under chaos once
        a dead peer's writer is dropped for a reconnect). Sheds the OLDEST entries -- they have
        aged the most and their resend timers are the closest to
        firing -- CLIENT-LANE FIRST: control traffic (votes, Phase1,
        epoch commits, heartbeats) is never shed behind a backlog of
        client batches, the invariant the overload chaos tests assert.
        The newest entry always survives so a send makes progress."""
        from frankenpaxos_tpu_torch.serve.lanes import LANE_CLIENT

        dropped = 0
        for pass_lane in (LANE_CLIENT, None):
            if conn.pending_bytes <= self.outbound_buffer_cap:
                break
            pending = conn.pending
            kept: list = []
            last = len(pending) - 1
            for k, entry in enumerate(pending):
                if (conn.pending_bytes > self.outbound_buffer_cap
                        and k != last
                        and (pass_lane is None
                             or entry[2] == pass_lane)):
                    conn.pending_bytes -= entry[3]
                    dropped += 1
                else:
                    kept.append(entry)
            conn.pending = kept
        return dropped

    def _schedule_flush(self, conn: _Conn) -> None:
        """Queue ``conn`` for the end-of-pass flush: every send of the
        current event-loop pass (one actor drain's whole output, often
        several actors') lands in the same writev."""
        if conn in self._flush_dirty:
            return
        self._flush_dirty.add(conn)
        self._flush_queue.append(conn)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self.loop.call_soon(self._flush_pass)

    def _flush_pass(self) -> None:
        self._flush_scheduled = False
        queue, self._flush_queue = self._flush_queue, []
        self._flush_dirty.clear()
        for conn in queue:
            self._flush_conn(conn)

    async def _connect(self, conn: _Conn, dst: Address) -> None:
        host, port = dst
        try:
            _, writer = await asyncio.open_connection(host, port)
        except OSError as e:
            self.logger.warn(f"connect to {dst} failed: {e}; "
                             f"dropping {len(conn.pending)} pending")
            conn.pending.clear()
            conn.pending_bytes = 0
            conn.connecting = False
            return
        conn.writer = writer
        conn.connecting = False
        self._flush_conn(conn)

    def _flush_conn(self, conn: _Conn) -> None:
        if conn.writer is None or not conn.pending:
            return
        entries = conn.pending
        conn.pending = []
        conn.pending_bytes = 0
        writer = conn.writer
        self.stat_flushes += 1
        self.stat_messages += len(entries)
        if not self.batching:
            # Legacy per-frame arm: frames were encoded at send time;
            # one join + write per flush (today's == pre-paxwire
            # behavior, the A/B baseline).
            self.stat_frames += len(entries)
            try:
                writer.write(b"".join(e[1] for e in entries))
                self.stat_syscalls += 1
            except (OSError, RuntimeError) as e:
                self.logger.warn(
                    f"write failed ({e}); dropping connection")
                conn.writer = None
            return
        plan = paxwire.plan_flush(entries)
        self.stat_frames += plan.frames
        self.stat_batch_bytes += plan.nbytes
        self.stat_coalesced_acks += plan.coalesced_acks
        try:
            if not self._writev(writer, plan.segments):
                writer.write(b"".join(plan.segments))
                self.stat_syscalls += 1
        except (OSError, RuntimeError) as e:
            # Connection torn down mid-write: drop the writer; the
            # next send reconnects (see _write) and resends cover the
            # loss.
            self.logger.warn(f"write failed ({e}); dropping connection")
            conn.writer = None

    #: sendmsg iovec ceiling (POSIX IOV_MAX is commonly 1024).
    _IOV_MAX = 1024

    def _writev(self, writer: asyncio.StreamWriter,
                segments: list) -> bool:
        """Zero-copy scatter/gather output: push the flush plan's
        segments with ``os.writev`` -- the payload ``bytes`` objects go
        straight to the kernel as an iovec, never joined. Only safe
        when asyncio's own write buffer is empty (ordering); on a
        partial or blocked send the remainder is handed to
        ``writer.write`` and asyncio's flow control takes over. Returns
        False when writev cannot be used at all (caller falls back to
        one join+write)."""
        if not self.use_sendmsg:
            return False
        transport = writer.transport
        sock = transport.get_extra_info("socket")
        if sock is None or transport.get_write_buffer_size() != 0:
            return False
        try:
            fd = sock.fileno()
        except (OSError, ValueError):
            return False
        if fd < 0:
            return False
        i, n = 0, len(segments)
        while i < n:
            chunk = segments[i:i + self._IOV_MAX]
            try:
                sent = os.writev(fd, chunk)
                self.stat_syscalls += 1
            except (BlockingIOError, InterruptedError):
                sent = 0
            total = sum(len(s) for s in chunk)
            if sent == total:
                i += self._IOV_MAX
                continue
            # Kernel buffer full mid-flush: asyncio owns the rest.
            rest: list = []
            for seg in chunk:
                if sent >= len(seg):
                    sent -= len(seg)
                    continue
                rest.append(seg[sent:] if sent else seg)
                sent = 0
            rest.extend(segments[i + self._IOV_MAX:])
            writer.write(b"".join(rest))
            self.stat_syscalls += 1
            return True
        return True

    def send(self, src: Address, dst: Address, data: bytes) -> None:
        self._call_on_loop(
            lambda: self._write(src, dst, data, flush=True))

    def send_no_flush(self, src: Address, dst: Address, data: bytes) -> None:
        self._call_on_loop(
            lambda: self._write(src, dst, data, flush=False))

    def flush(self, src: Address, dst: Address) -> None:
        if self.batching:
            # Ride the end-of-pass flush: the explicit flush's messages
            # still leave in this loop pass, batched with everything
            # else the drain produced.
            self._call_on_loop(
                lambda: self._schedule_flush(self._conn_for(src, dst)))
        else:
            self._call_on_loop(
                lambda: self._flush_conn(self._conn_for(src, dst)))

    def _on_loop(self) -> bool:
        """Is THIS thread currently running our event loop? Never
        consults private loop attributes (loop._thread_id is
        CPython-internal)."""
        try:
            return asyncio.get_running_loop() is self.loop
        except RuntimeError:
            return False

    def _call_on_loop(self, f: Callable[[], None]) -> None:
        assert self.loop is not None, "transport not started"
        # Running f() inline when already on the loop keeps same-pass
        # sends in the current drain instead of deferring them to the
        # next pass.
        if self._on_loop():
            f()
        else:
            self.loop.call_soon_threadsafe(f)

    def timer(self, address: Address, name: str, delay_s: float,
              f: Callable[[], None]) -> TcpTimer:
        assert self.loop is not None, "transport not started"
        return TcpTimer(self.loop, name, delay_s, f, transport=self,
                        address=address)
