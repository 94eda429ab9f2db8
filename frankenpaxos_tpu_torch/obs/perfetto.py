"""Span records -> Chrome-trace-event JSON, critical paths, breakdowns.

``to_chrome_trace`` emits the Trace Event Format's complete events
(``ph: "X"``) that both Perfetto (ui.perfetto.dev) and
chrome://tracing load directly: one track (pid/tid) per role, span
nesting from start/duration, trace and span ids in ``args`` so a
command's hops can be followed across role tracks.

``latency_breakdown`` is the per-stage table the overhead/alignment
analysis prints: where a command's latency goes -- queueing vs decode
vs handler vs quorum kernel vs WAL fsync vs send -- the attribution
"The Performance of Paxos in the Cloud" shows cloud deployments lose
their budget without.
"""

from __future__ import annotations

import json
from typing import Iterable

from frankenpaxos_tpu_torch.obs.trace import SpanRecord


def load_jsonl(path: str) -> list:
    """SpanRecords from one role's ``*.trace.jsonl`` dump (tolerates a
    torn final line -- roles die mid-write in chaos runs)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(SpanRecord.from_json(json.loads(line)))
            except (ValueError, KeyError):
                continue
    return records


def to_chrome_trace(records: Iterable[SpanRecord],
                    counters: Iterable[dict] = ()) -> dict:
    """The Trace Event Format dict (``json.dump`` it; Perfetto and
    chrome://tracing both load it).

    ``counters`` are ready-made COUNTER events (``ph: "C"``, e.g. from
    ``obs.telemetry.counter_events``): Perfetto renders them as value
    tracks alongside the span tracks, so the paxpulse device counters
    line up under the host spans on one timeline."""
    events = []
    roles = {}
    for record in records:
        tid = roles.setdefault(record.role or "role", len(roles) + 1)
        event = {
            "name": record.name,
            "cat": record.cat,
            "ph": "X" if record.cat != "event" else "i",
            "ts": round(record.t0 * 1e6, 3),   # microseconds
            "pid": 1,
            "tid": tid,
            "args": {"trace_id": f"{record.trace_id:016x}",
                     "span_id": f"{record.span_id:016x}",
                     "parent_id": f"{record.parent_id:016x}"},
        }
        if record.cat != "event":
            event["dur"] = round(record.dur * 1e6, 3)
        else:
            event["s"] = "t"
        events.append(event)
    for role, tid in roles.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": role}})
    events.extend(counters)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_tree(records: Iterable[SpanRecord], trace_id: int) -> dict:
    """One command's causal tree: every span of ``trace_id`` keyed by
    span_id with its children resolved -- the critical-path walk's
    input. Returns {"spans": {span_id: record}, "children":
    {span_id: [span_id]}, "roots": [span_id], "critical_path":
    [record]} where the critical path follows, from the
    latest-finishing root, the child whose SUBTREE finishes last (the
    chain that determined the command's end-to-end latency -- a hop's
    consequences can outlive the hop's own span, e.g. a handler stage
    whose send triggers the reply's receive on another role)."""
    spans = {r.span_id: r for r in records if r.trace_id == trace_id}
    children: dict = {}
    roots = []
    for sid, record in spans.items():
        if record.parent_id in spans:
            children.setdefault(record.parent_id, []).append(sid)
        else:
            roots.append(sid)

    subtree_end: dict = {}

    def end_of(sid: int) -> float:
        cached = subtree_end.get(sid)
        if cached is None:
            cached = max([spans[sid].t0 + spans[sid].dur]
                         + [end_of(kid)
                            for kid in children.get(sid, ())])
            subtree_end[sid] = cached
        return cached

    path = []
    if roots:
        at = max(roots, key=end_of)
        while True:
            path.append(spans[at])
            kids = children.get(at)
            if not kids:
                break
            at = max(kids, key=end_of)
    return {"spans": spans, "children": children, "roots": roots,
            "critical_path": path}


def latency_breakdown(records: Iterable[SpanRecord]) -> dict:
    """Per-stage totals: {stage/category name: {count, total_us,
    mean_us, p50_us, p99_us, max_us}}. Stage sub-spans are keyed by
    their stage name; receive/timer/drain spans by category."""
    buckets: dict = {}
    for record in records:
        if record.cat == "stage":
            key = record.name[len("stage:"):]
        elif record.cat == "event":
            continue
        else:
            key = record.cat
        buckets.setdefault(key, []).append(record.dur)
    table = {}
    for key, durs in sorted(buckets.items()):
        durs.sort()
        n = len(durs)
        table[key] = {
            "count": n,
            "total_us": round(sum(durs) * 1e6, 1),
            "mean_us": round(sum(durs) / n * 1e6, 2),
            "p50_us": round(durs[n // 2] * 1e6, 2),
            "p99_us": round(durs[min(n - 1, (99 * n) // 100)] * 1e6, 2),
            "max_us": round(durs[-1] * 1e6, 2),
        }
    return table


def format_breakdown(table: dict) -> str:
    """The human latency-breakdown table (docs/OBSERVABILITY.md)."""
    header = (f"{'stage':<16} {'count':>8} {'total_us':>12} "
              f"{'mean_us':>10} {'p50_us':>10} {'p99_us':>10} "
              f"{'max_us':>10}")
    lines = [header, "-" * len(header)]
    for key, row in table.items():
        lines.append(
            f"{key:<16} {row['count']:>8} {row['total_us']:>12.1f} "
            f"{row['mean_us']:>10.2f} {row['p50_us']:>10.2f} "
            f"{row['p99_us']:>10.2f} {row['max_us']:>10.2f}")
    return "\n".join(lines)
