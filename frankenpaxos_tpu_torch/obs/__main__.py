"""paxtrace CLI: role trace dumps -> one Perfetto file + breakdown (the
port's copy of ``frankenpaxos_tpu/obs/__main__.py``).

Usage::

    python -m frankenpaxos_tpu_torch.obs <dir-or-trace.jsonl>... \
        --out trace.json [--breakdown] [--flight <ring.flight>]

Globs ``*.trace.jsonl`` (spans) and ``*.counters.jsonl`` (paxpulse
device-counter samples) under directories, merges every role's spans
and counter tracks into one Chrome-trace-event JSON (load it at
ui.perfetto.dev or chrome://tracing), prints the drain-stage
latency-breakdown table, and renders flight-recorder rings to their
post-mortem JSON.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from frankenpaxos_tpu_torch.obs.flight import FlightRecorder
from frankenpaxos_tpu_torch.obs.perfetto import (
    format_breakdown,
    latency_breakdown,
    load_jsonl,
    to_chrome_trace,
)
from frankenpaxos_tpu_torch.obs.telemetry import counter_events, load_counters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="frankenpaxos_tpu_torch.obs")
    parser.add_argument("inputs", nargs="*",
                        help="trace.jsonl files or directories of them")
    parser.add_argument("--out", default=None,
                        help="write merged Chrome-trace JSON here")
    parser.add_argument("--breakdown", action="store_true",
                        help="print the per-stage latency table")
    parser.add_argument("--flight", action="append", default=[],
                        help="flight-recorder ring file to render "
                             "(repeatable); writes <file>.json")
    args = parser.parse_args(argv)

    paths = []
    counter_paths = []
    for item in args.inputs:
        if os.path.isdir(item):
            paths.extend(sorted(glob.glob(
                os.path.join(item, "*.trace.jsonl"))))
            counter_paths.extend(sorted(glob.glob(
                os.path.join(item, "*.counters.jsonl"))))
        elif item.endswith(".counters.jsonl"):
            counter_paths.append(item)
        else:
            paths.append(item)
    records = []
    for path in paths:
        records.extend(load_jsonl(path))
    records.sort(key=lambda r: (r.t0, r.role, r.span_id))
    counters = []
    for path in counter_paths:
        by_role: dict = {}
        for t, role, snap in load_counters(path):
            by_role.setdefault(role, []).append((t, snap))
        for role, samples in sorted(by_role.items()):
            counters.extend(counter_events(samples, role))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(to_chrome_trace(records, counters), f)
        print(f"wrote {args.out} ({len(records)} spans from "
              f"{len(paths)} role dumps, {len(counters)} counter "
              f"events from {len(counter_paths)} paxpulse dumps)")
    if args.breakdown:
        print(format_breakdown(latency_breakdown(records)))
    for ring in args.flight:
        out = ring + ".json"
        dump = FlightRecorder.dump_file(ring, out)
        print(f"wrote {out} ({len(dump['records'])} records)")
    if not (args.out or args.breakdown or args.flight):
        parser.print_usage()
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
