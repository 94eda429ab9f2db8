"""paxingest wire messages (codecs in ingest/wire.py, tags 204-205 + 210);
the port's copy of ``frankenpaxos_tpu/ingest/messages.py``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IngestRun:
    """A disseminator's pre-batched, pre-encoded run descriptor: one
    CommandBatch-of-one value per slot, in client arrival order.

    ``values`` is a ``LazyValueArray`` on the deployed path (the
    batcher's column scan built the segment; the leader forwards the
    raw bytes into ``Phase2aRun`` without parsing them) or a plain
    tuple on the sim/fallback path. The leader only ever touches run
    METADATA: ``len(values)`` for slot assignment and admission, the
    raw segment for the proposal.

    ``seq`` (paxfan) numbers this batcher's runs per destination
    group, monotonically from 0: batchers PIPELINE descriptors ahead
    of leader acks up to a bounded per-(batcher, group) window, and
    the leader's :class:`IngestCredit` replies carry the drained
    watermark that reopens it."""

    batcher_index: int
    values: tuple  # tuple[CommandBatchOrNoop, ...] | LazyValueArray
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class NotLeaderIngest:
    """An inactive leader bouncing a run back to its disseminator so it
    can re-route after leader discovery (the ingest twin of
    NotLeaderBatcher). ``group_index`` scopes discovery to one Mencius
    leader group (always 0 for MultiPaxos)."""

    group_index: int
    run: IngestRun


@dataclasses.dataclass(frozen=True)
class IngestCredit:
    """The leader's watermark-granular credit reply: every run with
    ``seq <= watermark_seq`` from this batcher for ``group_index`` has
    been drained into proposals (or bounced). ONE credit per batcher
    per leader drain (accumulated in the handler, flushed on_drain),
    not one per run -- the return path stays O(batchers) per pass.
    Control-lane: credits must survive client-lane shedding or the
    window wedges shut."""

    group_index: int
    watermark_seq: int
