"""MultiPaxos over real loopback TCP with every transport traced.

Run::

    python -m frankenpaxos_tpu_torch.bench.traced_tcp [--device cpu]

It prints ONE JSON line. Each arm is ``supernode.run_arm`` (f = 1 in
``deploy.py``'s ``cluster(1, ...)`` layout, ``supernode.CLIENTS``
closed-loop clients, ``PSEUDONYMS`` writes in flight a client) with
``trace_dir`` set: both transports carry a ``Tracer`` at sample rate
``supernode.TRACE_SAMPLE_RATE`` (1.0, the reference CLI's default), with
a flight-recorder
ring and a ``.trace.jsonl`` sink each in a temporary directory, as the
reference's ``--trace`` wires a role process. Under a tracer the
ProxyLeaders' wire sink is bypassed, so a batch frame of vote acks
reaches them message by message; their drains still count the votes on
the tracker (K1 on the synchronous ``"cuda"`` tracker, K2 on the
pipelined one).

Gates (a failed gate raises ``GateFailure``), besides ``run_arm``'s own
(every write answered once with its AppendLog index, the replicas' logs
equal and complete, no error and no collector error):

  * spans were recorded;
  * every ProxyLeader drain span holds exactly one
    ``stage:quorum-kernel`` span, and in a cuda arm each ProxyLeader has
    at least as many of them as its tracker had drains that called the
    device (and some did);
  * a write's causal chain runs from its client's send (the client's
    timer for the first writes; for the later ones a leader's receive of
    the client's frame, which carries no context because the client's
    deferred flush of its staged writes runs outside any span) through a
    ProxyLeader's drain and its quorum-kernel stage; in the dict and the
    synchronous arms the same chain reaches
    the reply's receive back at the client. The pipelined tracker's
    results are posted back to the event loop by its collector thread
    outside any span, so there the chosen values open a trace of their
    own (rooted at a replica's receive), which must reach the reply's
    receive at the client;
  * ``to_chrome_trace`` gives JSON that loads, and every flight ring
    reads back.

Figures per arm: ``run_arm``'s (writes/s, p50 / p99 write latency, also
after the first round), the spans by category, each event loop's busy
share (the time inside its receive, timer and drain spans over its span
window), its ``SLOWEST`` longest spans, the per-stage latency breakdown
(``latency_breakdown``:
count, mean, p50, p99, max in microseconds), the quorum-kernel spans and
device drains per ProxyLeader, the path found, and the flight records
read back.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile

import torch

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.obs import (
    FlightRecorder,
    latency_breakdown,
    load_jsonl,
    to_chrome_trace,
)
from frankenpaxos_tpu_torch.protocols.multipaxos import supernode

WRITES = 1 << 10
PSEUDONYMS = 64
ARMS = {
    "dict": dict(quorum_backend="dict", phase1_backend="cuda"),
    "cuda_sync": dict(quorum_backend="cuda", phase1_backend="cuda"),
    "cuda_pipelined": dict(quorum_backend="cuda", tpu_pipelined=True,
                           phase1_backend="cuda"),
}
#: The longest spans an arm reports.
SLOWEST = 5
#: The arms whose chosen values leave inside the quorum-kernel stage.
REPLY_IN_TRACE = ("dict", "cuda_sync")
#: The role labels of the supernode's two tracers.
ROLES_LABEL, CLIENTS_LABEL = "supernode_0", "client_0"


class GateFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def _actor(record) -> str:
    return record.name.rpartition("@")[2]


def _is_reply(record) -> bool:
    return (record.cat == "receive" and record.role == CLIENTS_LABEL
            and record.name.startswith("receive:ClientReply"))


def _chain(spans: dict, sid: int) -> list:
    """The spans from the trace's root down to ``sid``."""
    chain = []
    while sid in spans:
        chain.append(spans[sid])
        sid = spans[sid].parent_id
    return chain[::-1]


def find_path(records: list, proxy_leaders: set, reply_in_trace: bool
              ) -> "list | None":
    """The span names of a write's causal chain from its client's send
    through a ProxyLeader's drain and its quorum-kernel stage down to
    the reply's receive at the client. The chain starts at a client
    span whose frame a leader receives as a client request (the
    client's timer: the first writes), or at a leader's receive of a
    client frame that carried no context (the client's deferred flush
    of its staged writes runs outside any span: the later writes). Without
    ``reply_in_trace``, the chain from the client's send to the stage,
    then a chain of a trace of its own from a replica's receive of
    chosen values to the reply. A chain rooted at the client's timer is
    preferred. None if there is none."""
    spans = {r.span_id: r for r in records}

    def through(chain: list) -> "int | None":
        """Where the chain leaves the client with a write, if it then
        passes a ProxyLeader's quorum-kernel stage."""
        if chain[0].name.startswith("receive:ClientRequest"):
            start = 0
        else:
            start = next((i for i in range(len(chain) - 1)
                          if chain[i].role == CLIENTS_LABEL
                          and chain[i].cat in ("timer", "drain")
                          and chain[i + 1].name.startswith(
                              "receive:ClientRequest")), None)
        if start is None:
            return None
        for at in range(start + 2, len(chain)):
            if (chain[at].name == "stage:quorum-kernel"
                    and chain[at - 1].cat == "drain"
                    and _actor(chain[at - 1]) in proxy_leaders):
                return start
        return None

    def best(ends) -> "list | None":
        """The first chain rooted at a client's timer, else any."""
        found = None
        for end in ends:
            chain = _chain(spans, end.span_id)
            start = through(chain)
            if start is None:
                continue
            names = [r.name for r in chain[start:]]
            if chain[start].cat == "timer":
                return names
            found = found or names
        return found

    replies = [r for r in records if _is_reply(r)]
    if reply_in_trace:
        return best(replies)
    head = best([r for r in records if r.name == "stage:quorum-kernel"])
    if head is None:
        return None
    for reply in replies:
        chain = _chain(spans, reply.span_id)
        if (chain[0].parent_id == 0
                and chain[0].name.startswith("receive:Chosen")):
            return head + ["..."] + [r.name for r in chain]
    return None


def loop_busy_share(records: list) -> dict:
    """Per tracer role, the share of its span window that its event
    loop spent inside receive, timer and drain spans (one loop thread a
    transport, so these never overlap)."""
    out = {}
    for role in sorted({r.role for r in records}):
        top = [r for r in records
               if r.role == role and r.cat in ("receive", "timer", "drain")]
        if not top:
            continue
        window = max(r.t0 + r.dur for r in top) - min(r.t0 for r in top)
        out[role] = sum(r.dur for r in top) / window if window > 0 else None
    return out


def check_trace(directory: str, arm: str, result: dict,
                on_card: bool) -> dict:
    """The traced arm's gates over the dumps in ``directory``; returns
    its figures. ``on_card``: some tracker drain of a cuda arm must have
    called the device (on the CPU the trackers' routing threshold keeps
    narrow drains on the host tally)."""
    records = []
    for path in sorted(glob.glob(os.path.join(directory, "*.trace.jsonl"))):
        records.extend(load_jsonl(path))
    _require(records, f"{arm}: no span was recorded")
    by_cat: dict = {}
    for r in records:
        by_cat[r.cat] = by_cat.get(r.cat, 0) + 1
    proxy_leaders = [str(a) for a in result["proxy_leaders"]]
    spans = {r.span_id: r for r in records}
    drains = dict.fromkeys(proxy_leaders, 0)
    stages = dict.fromkeys(proxy_leaders, 0)
    for r in records:
        if r.cat == "drain" and _actor(r) in drains:
            drains[_actor(r)] += 1
        parent = spans.get(r.parent_id)
        if (r.name == "stage:quorum-kernel" and parent is not None
                and parent.cat == "drain" and _actor(parent) in stages):
            stages[_actor(parent)] += 1
    device = dict(zip(proxy_leaders, result["device_drains"]))
    for p in proxy_leaders:
        _require(stages[p] == drains[p],
                 f"{arm}: ProxyLeader {p} has {drains[p]} drain spans but "
                 f"{stages[p]} quorum-kernel stages under them")
        _require(stages[p] >= device[p],
                 f"{arm}: ProxyLeader {p}'s tracker called the device in "
                 f"{device[p]} drains, but only {stages[p]} quorum-kernel "
                 f"spans were recorded")
    if on_card and ARMS[arm]["quorum_backend"] == "cuda":
        _require(sum(device.values()) > 0,
                 f"{arm}: no tracker drain called the device")
    path = find_path(records, set(proxy_leaders), arm in REPLY_IN_TRACE)
    _require(path is not None,
             f"{arm}: no write's chain ran from its client through a "
             f"ProxyLeader's quorum-kernel stage to the reply")
    chrome = json.loads(json.dumps(to_chrome_trace(records)))
    _require(len(chrome["traceEvents"]) >= len(records),
             f"{arm}: the Chrome trace lost events")
    flights = {}
    for ring in sorted(glob.glob(os.path.join(directory, "*.flight"))):
        got = FlightRecorder.read(ring)
        _require(got, f"{arm}: the flight ring {ring} read back empty")
        flights[os.path.basename(ring)] = len(got)
    _require(set(flights) == {f"{ROLES_LABEL}.flight",
                              f"{CLIENTS_LABEL}.flight"},
             f"{arm}: flight rings {sorted(flights)}")
    slowest = sorted(records, key=lambda r: r.dur, reverse=True)[:SLOWEST]
    return {"spans": len(records), "spans_by_category": by_cat,
            "loop_busy_share": loop_busy_share(records),
            "slowest_spans": [(r.name, r.role, round(r.dur * 1e6, 1))
                              for r in slowest],
            "breakdown": latency_breakdown(records),
            "quorum_kernel_spans": stages, "device_drains": device,
            "path": path, "flight_records": flights}


def run(device=None, writes: int = WRITES, pseudonyms: int = PSEUDONYMS,
        arms=tuple(ARMS)) -> dict:
    """Every arm in ``arms`` on ``device`` (the card when None), each
    traced into a fresh temporary directory that is removed afterwards.
    ``result["arms"][arm]["executed"]`` is the arm's executed set."""
    dev = resolve_device(device)
    out: dict = {}
    for arm in arms:
        directory = tempfile.mkdtemp(prefix="fpx-trace-")
        try:
            try:
                result = supernode.run_arm(
                    writes, pseudonyms, device=dev, trace_dir=directory,
                    **ARMS[arm])
            except supernode.GateFailure as exc:
                raise GateFailure(f"{arm}: {exc}") from exc
            result.update(check_trace(directory, arm, result,
                                      dev.type == "cuda"))
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        out[arm] = result
    for arm in arms:
        if arm != "dict" and "dict" in out:
            _require(out[arm]["executed"] == out["dict"]["executed"],
                     f"{arm}: the executed commands differ from the dict "
                     f"arm's")
    return {
        "benchmark": "traced_tcp",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "writes": writes, "pseudonyms": pseudonyms,
        "clients": supernode.CLIENTS,
        "sample_rate": supernode.TRACE_SAMPLE_RATE,
        "arms": out,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--writes", type=int, default=WRITES)
    args = parser.parse_args(argv)
    result = run(args.device, args.writes)
    for arm in result["arms"].values():
        arm["executed"] = len(arm["executed"])
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
