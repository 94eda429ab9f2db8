"""paxwire: drain-granular batched wire frames for the native transport.

The TPU kernels commit ~1.6B cmds/s while the deployed TCP path does
thousands -- the per-message Python frame layer (one header f-string,
one codec dispatch, one ``writer.write`` PER MESSAGE) is the deployed
bottleneck. paxwire is the batch layer underneath TcpTransport:

  * **Batch frames.** A drain's same-type messages to one peer coalesce
    into ONE wire frame whose payload is an ordinary extended-page
    codec message::

        [0x00][tag-128][u32le count][count * u32le seg_len][segments]

    The segments are the messages' unmodified wire payloads, copied
    raw -- a Phase2aRun/ClientReplyArray whose value bytes are
    ``LazyValueArray`` segments batches without re-materializing a
    value. Because the batch leads with a REGISTERED wire tag,
    ``serve/lanes.py``'s one-byte frame classifier (and the bounded
    inbox shedding built on it) works on batch frames without decode:
    client-request batches ride :data:`CLIENT_BATCH_TAG` (shedable),
    everything else :data:`CONTROL_BATCH_TAG` (never shed).

  * **Coalescers.** A protocol can register a per-tag coalescer that
    understands its message layout and merges a run of payloads into
    something DENSER than concatenation -- the ack coalescing path:
    ``protocols/multipaxos/wire.py`` folds a drain's Phase2b stream to
    one peer into run-granular ack ranges (see
    :func:`register_coalescer`).

  * **Flush plans.** :func:`plan_flush` turns a connection's pending
    ``(header, payload, lane)`` entries into the scatter/gather segment
    list one ``socket.sendmsg`` (writev) pushes out -- tiny header
    prefixes interleaved with the original payload ``bytes`` objects,
    never a per-frame join.

Receivers EXPAND batch frames back into the original messages (same
``src``, same frame-header TraceContext) before delivery, so protocol
handlers and per-message admission are untouched: batching changes the
syscall and dispatch count, never the semantics. Expansion rides the
``__wire_expand__`` protocol: any decoded message exposing
``__wire_expand__(serializer) -> iterable`` is flattened by the
transport (coalesced ack batches use it to surface as the
Phase2b/Phase2bRange messages the proxy leaders already handle).

Wire format details and the A/B artifact: docs/TRANSPORT.md.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional

from frankenpaxos_tpu_torch import native

#: Extended-page wire tags for the two batch envelopes. Control is the
#: conservative default; the client tag exists ONLY so the frame-layer
#: classifier can shed a batch of client requests like it sheds the
#: requests themselves.
CONTROL_BATCH_TAG = 150
CLIENT_BATCH_TAG = 151

#: Coalesce a run only when it actually merges something.
MIN_BATCH = 2

_LEN = struct.Struct(">I")
MAX_FRAME = 10 * 1024 * 1024  # TcpTransport's frame cap


class FrameBatch:
    """A decoded control-lane batch frame: opaque wire segments, each
    one complete message payload. The transport expands it; actors
    never see one."""

    __slots__ = ("segments",)

    def __init__(self, segments):
        self.segments = tuple(segments)

    def __wire_expand__(self, serializer):
        return [serializer.from_bytes(bytes(s)) for s in self.segments]

    def __eq__(self, other):
        if isinstance(other, FrameBatch):
            return (type(self) is type(other)
                    and self.segments == other.segments)
        return NotImplemented

    def __repr__(self) -> str:
        return f"{type(self).__name__}(n={len(self.segments)})"


class ClientFrameBatch(FrameBatch):
    """The client-lane twin (named in serve/lanes.py's client lane so
    both the tag-level and type-level classifiers shed it)."""


def _register_batch_codecs() -> None:
    # Deferred: serializer imports nothing from here, but keeping the
    # MessageCodec subclasses inside a function avoids importing the
    # registry at module scope before test monkeypatching can happen.
    from frankenpaxos_tpu_torch.runtime.serializer import (
        MessageCodec,
        register_codec,
    )

    class _BatchCodec(MessageCodec):
        # Encoded and decoded by the TRANSPORT's flush/scan paths, not
        # by any protocol role (paxflow FLOW403 skips transport_layer
        # codecs -- there is deliberately no role send site).
        transport_layer = True

        def encode(self, out, message):
            segments = message.segments
            out += native.batch_header(self.tag,
                                       [len(s) for s in segments])[2:]
            for segment in segments:
                out += segment

        def decode(self, buf, at):
            offsets = native.scan_batch(buf, at)
            return self.message_type(
                tuple(bytes(buf[s:e]) for s, e in offsets)), len(buf)

    class FrameBatchCodec(_BatchCodec):
        message_type = FrameBatch
        tag = CONTROL_BATCH_TAG

    class ClientFrameBatchCodec(_BatchCodec):
        message_type = ClientFrameBatch
        tag = CLIENT_BATCH_TAG

    register_codec(FrameBatchCodec())
    register_codec(ClientFrameBatchCodec())


_register_batch_codecs()


# --- coalescers --------------------------------------------------------------

#: wire tag -> fn(list of payload bytes) -> denser single payload, or
#: None to decline (fall back to the generic batch envelope).
_COALESCERS: dict[int, Callable[[list], Optional[bytes]]] = {}


def register_coalescer(tag: int,
                       fn: Callable[[list], Optional[bytes]]) -> None:
    """Install ``fn`` as the coalescer for runs of ``tag`` payloads on
    one connection within one flush. The function receives the raw wire
    payloads (tag byte included) in send order and returns ONE payload
    that decodes to a message expanding back to equivalent deliveries
    (``__wire_expand__``), or None to decline."""
    _COALESCERS[tag] = fn


def leading_tag(payload) -> Optional[int]:
    """The wire tag a payload leads with: 1..127 primary, 128..255
    extended, -1 for a pickle stream, None when undecidable."""
    if not payload:
        return None
    b0 = payload[0]
    if b0 == 0:
        return 128 + payload[1] if len(payload) > 1 else None
    if b0 >= 128:
        return -1
    return b0


def is_batch_payload(data) -> bool:
    """Is this frame payload a batch envelope? One-or-two byte check,
    run on every inbound frame."""
    return (len(data) > 1 and data[0] == 0
            and data[1] + 128 in (CONTROL_BATCH_TAG, CLIENT_BATCH_TAG))


def split_batch(data) -> list[bytes]:
    """A batch frame payload -> its message payload segments (raises
    ValueError on a torn/corrupt table, the transport's corrupt-frame
    containment channel)."""
    return [bytes(data[s:e]) for s, e in native.scan_batch(data, 2)]


# --- flush planning ----------------------------------------------------------


class FlushPlan:
    """One connection flush: the writev segment list plus its stats."""

    __slots__ = ("segments", "frames", "messages", "nbytes",
                 "coalesced_acks")

    def __init__(self):
        self.segments: list = []
        self.frames = 0
        self.messages = 0
        self.nbytes = 0
        self.coalesced_acks = 0

    def _add_frame(self, header: bytes, payload_parts: list,
                   inner_payload_len: int) -> None:
        inner = 4 + len(header) + inner_payload_len
        prefix = _LEN.pack(inner) + _LEN.pack(len(header)) + header
        self.segments.append(prefix)
        self.segments.extend(payload_parts)
        self.frames += 1
        self.nbytes += 4 + inner


def _client_tags() -> frozenset:
    from frankenpaxos_tpu_torch.serve.lanes import client_lane_tags

    return client_lane_tags()


def plan_flush(entries: list) -> FlushPlan:
    """``entries`` is a connection's pending list in send order; each
    entry is indexable with the frame header at ``[0]`` and the message
    payload at ``[1]``. Consecutive same-header entries with the same
    leading wire tag become one batch frame (or one coalesced frame
    when the tag has a registered coalescer); singletons stay plain
    frames. Send order is preserved throughout -- only ADJACENT
    same-type messages merge."""
    plan = FlushPlan()
    plan.messages = len(entries)
    i, n = 0, len(entries)
    client_tags = None
    while i < n:
        header, payload = entries[i][0], entries[i][1]
        tag = leading_tag(payload)
        j = i + 1
        while j < n and entries[j][0] == header \
                and leading_tag(entries[j][1]) == tag:
            j += 1
        run = [e[1] for e in entries[i:j]]
        if len(run) < MIN_BATCH or tag is None:
            for payload in run:
                plan._add_frame(header, [payload], len(payload))
            i = j
            continue
        coalescer = _COALESCERS.get(tag) if tag is not None else None
        if coalescer is not None:
            try:
                merged = coalescer(run)
            except Exception:
                # The decline contract is "return None", but a raising
                # coalescer must not lose the flush's already-popped
                # entries (or abort the rest of the flush pass):
                # contain it and fall back to the generic batch.
                merged = None
            if merged is not None and \
                    4 + len(header) + len(merged) <= MAX_FRAME:
                plan.coalesced_acks += len(run)
                plan._add_frame(header, [merged], len(merged))
                i = j
                continue
        if client_tags is None:
            client_tags = _client_tags()
        batch_tag = (CLIENT_BATCH_TAG if tag in client_tags
                     else CONTROL_BATCH_TAG)
        # Split the run so no batch frame exceeds the 10 MiB cap (the
        # per-entry cap was enforced at send time, so every chunk makes
        # progress).
        k = 0
        while k < len(run):
            chunk: list = []
            chunk_bytes = 0
            while k < len(run):
                seg = run[k]
                add = 4 + len(seg)
                if chunk and (10 + len(header) + chunk_bytes + add
                              > MAX_FRAME):
                    break
                chunk.append(seg)
                chunk_bytes += add
                k += 1
            if len(chunk) == 1:
                plan._add_frame(header, chunk, len(chunk[0]))
                continue
            bh = native.batch_header(batch_tag,
                                     [len(s) for s in chunk])
            plan._add_frame(header, [bh] + chunk,
                            len(bh) + chunk_bytes - 4 * len(chunk))
        i = j
    return plan
