"""MultiPaxos as a cluster of actors over SimTransport, on one GPU.

The port's counterpart of ``frankenpaxos_tpu/bench/lt_suite.py``'s
``sim_transport_cmds_per_sec`` / ``sim_ab_pipeline``, plus a failover.
Run::

    python -m frankenpaxos_tpu_torch.bench.multipaxos_sim [--device cpu]

It prints ONE JSON line. The cluster is the harness's default at full
width: ``f = 1``, one group of 3 acceptors, 2 leaders, 2 proxy leaders,
2 replicas, an AppendLog state machine, one coalescing client, and the
ProxyLeaders' vote board at the role's own window (2^20). Writes go in
closed-loop waves of 4096 in flight (the reference suite's wave shape),
delivered in coalesced waves. Three arms, each on a fresh cluster:

  1. ``steady``: 2^16 writes with the synchronous tracker (K1 + host
     spill);
  2. ``failover``: both replicas partitioned, a burst of 2^16 writes
     voted by the acceptors, then heal, leader 0 fails over to leader 1,
     and delivery runs until the transport is quiet. The new leader
     recovers the whole window with ONE K8 call on ``[2^16, 3]``, and
     its recovered values must equal the host path's
     (``phase1_backend="host"``) on the same Phase1bs;
  3. ``pipelined``: 2^14 writes with the pipelined tracker (K2), the
     quiescence flush timer fired as the reference's tests fire it. The
     last wave meets a slow acceptor: its votes to the ProxyLeaders are
     held back while leader 0 fails over to leader 1, and arrive in the
     same wave as the new round's votes on the same slots. The
     ProxyLeader's drain then mixes two rounds, and the minority
     round's votes take the scatter path (K4).

No role releases vote-board columns (the reference's ProxyLeader keeps
its board until the ring wraps), so K5 runs only in the pipelined
tracker's construction prewarm, which the arms do not count.

Gates (a failed gate raises): every write is answered, each reply
equals the index the AppendLog gave its payload, both replicas'
executed logs are equal and hold every write. Figures per arm: committed
writes/s on the host clock (the actors are Python; the card's name and
power limit stand beside it), each kernel's launches by the arm's
traffic (construction excluded), ``per_slot_share`` (the share of the
ProxyLeaders' votes that arrived as per-slot Phase2b, against
Phase2bRange and Phase2bVotes), the synchronous tracker's drain widths
against its ``min_device_slots`` (arms 1 and 2), and the recovery's
host seconds beside K8's call time (arms 2 and 3) and its device time
from a profiler trace of the recovery (arm 2; null when the trace holds
no K8 event).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ops import quorum as tq, value as value_ops
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import (
    deliver_until_quiet,
    executed_prefix,
    make_multipaxos,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.messages import Noop
import torch

#: The kernel wrappers the cluster's roles can reach, by name.
WRAPPERS = {
    "quorum_hit": tq.quorum_hit,
    "record_block": tq.record_block,
    "record_and_check": tq.record_and_check,
    "release": tq.release,
    "safe_values": value_ops.safe_values,
}
#: The kernels the cluster's traffic must launch (on a CUDA device).
CLUSTER_KERNELS = ("quorum_hit", "record_block", "record_and_check",
                   "safe_values")

WINDOW = 1 << 20
WAVE = 1 << 12


class GateFailure(AssertionError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def _launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def _cluster(device, **kwargs):
    sim = make_multipaxos(f=1, coalesced=True, quorum_backend="cuda",
                          phase1_backend="cuda", tpu_window=WINDOW,
                          device=device, **kwargs)
    # A long run: no oracle reads the delivery history.
    sim.transport.record_history = False
    return sim


def _write_wave(sim, pseudonyms, tag: bytes, got: dict) -> None:
    client = sim.clients[0]
    for p in pseudonyms:
        payload = b"%s%d" % (tag, p)
        client.write(p, payload, lambda r, payload=payload:
                     got.__setitem__(payload, r))
    client.flush_writes()


def _check_cluster(sim, got: dict, payloads: list, what: str) -> None:
    """Every write answered with its AppendLog index; both replicas'
    executed logs equal and holding every write."""
    _require(len(got) == len(payloads),
             f"{what}: {len(got)} of {len(payloads)} writes answered")
    logs = [executed_prefix(r) for r in sim.replicas]
    _require(logs[0] == logs[1], f"{what}: the replicas' logs differ")
    executed = sim.replicas[0].state_machine.get()
    index = {payload: i for i, payload in enumerate(executed)}
    _require(len(index) == len(executed),
             f"{what}: a write executed twice")
    missing = [p for p in payloads if p not in index]
    _require(not missing, f"{what}: {len(missing)} writes not in the log")
    wrong = [p for p in payloads if got[p] != b"%d" % index[p]]
    _require(not wrong, f"{what}: {len(wrong)} replies differ from the "
                        f"state machine's")
    in_log = sum(len(v.commands) for v in logs[0]
                 if not isinstance(v, Noop))
    _require(in_log == len(payloads),
             f"{what}: the log holds {in_log} commands, not "
             f"{len(payloads)}")


def _shares(sim) -> dict:
    votes = {"Phase2b": 0, "Phase2bRange": 0, "Phase2bVotes": 0}
    for proxy in sim.proxy_leaders:
        for shape, n in proxy.votes_by_shape.items():
            votes[shape] += n
    total = sum(votes.values())
    return {"votes": votes,
            "per_slot_share": votes["Phase2b"] / total if total else None}


def _arm_figures(sim, writes: int, seconds: float, before: dict) -> dict:
    after = _launches()
    return {"writes": writes, "seconds": seconds,
            "writes_per_sec": writes / seconds,
            "launches": {k: after[k] - before[k] for k in after},
            **_shares(sim)}


def _drain_widths(sim) -> dict:
    """The synchronous trackers' drain widths, and the share of drains
    at or above the device threshold."""
    widths: dict = {}
    for proxy in sim.proxy_leaders:
        for key, n in proxy.tracker.drain_widths.items():
            widths[str(key)] = widths.get(str(key), 0) + n
    threshold = sim.proxy_leaders[0].tracker.min_device_slots
    wide = sum(n for k, n in widths.items()
               if k.isdigit() and int(k) >= threshold)
    return {"drain_widths": widths, "min_device_slots": threshold,
            "device_drain_share": wide / sum(widths.values())}


def _settle(transport) -> None:
    """Deliver until quiet, firing the pipelined trackers' quiescence
    flush timers until none is left."""
    while True:
        deliver_until_quiet(transport)
        flush = [t for t in transport.running_timers()
                 if t.name == "tpuDrainFlush"]
        if not flush:
            return
        for timer in flush:
            transport.trigger_timer(timer.id)


def _spy_recoveries(leader, trace_on=None) -> list:
    """Record every ``_recover_values`` call of ``leader``: its Phase1bs,
    window, chosen watermark and values, and K8's device milliseconds
    in the call from the profiler's trace when ``trace_on`` is a CUDA
    device (else None)."""
    recoveries: list = []
    cuda_recover = leader._recover_values

    def spy(phase1, max_slot):
        device = trace_on
        if device is None or device.type != "cuda":
            values, k8_ms = cuda_recover(phase1, max_slot), None
        else:
            from torch.profiler import profile, ProfilerActivity

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                values = cuda_recover(phase1, max_slot)
                torch.cuda.synchronize(device)
            k8_ms = sum(getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0)
                        for e in prof.key_averages()
                        if "safe_values_kernel" in e.key) / 1e3 or None
        recoveries.append({"phase1": phase1, "max_slot": max_slot,
                           "watermark": leader.chosen_watermark,
                           "values": values, "k8_device_ms": k8_ms})
        return values

    leader._recover_values = spy
    return recoveries


def _check_recovery(leader, recovery: dict, what: str) -> dict:
    """K8 ran on the window's pow2 rows and its values equal the host
    path's on the same Phase1bs; returns the recovery's figures."""
    watermark, max_slot = recovery["watermark"], recovery["max_slot"]
    rows = 1 << max(0, (max_slot - watermark).bit_length())
    _require(leader.last_recovery["shape"] == [rows, 3],
             f"{what}: K8 ran on {leader.last_recovery['shape']}, not "
             f"[{rows}, 3]")
    host = make_multipaxos(f=1, phase1_backend="host").leaders[1]
    host.chosen_watermark = watermark
    _require(host._recover_values(recovery["phase1"], max_slot)
             == recovery["values"],
             f"{what}: K8's recovery differs from the host path's")
    return {"window": [watermark, max_slot], **leader.last_recovery,
            "k8_device_ms": recovery["k8_device_ms"]}


def steady(device, writes: int, wave: int) -> dict:
    """Arm 1: closed-loop waves of ``wave`` writes, synchronous
    tracker."""
    sim = _cluster(device)
    got: dict = {}
    payloads = []
    before = _launches()
    t0 = time.perf_counter()
    for w in range(writes // wave):
        _write_wave(sim, range(wave), b"s%d." % w, got)
        payloads.extend(b"s%d.%d" % (w, p) for p in range(wave))
        deliver_until_quiet(sim.transport)
    seconds = time.perf_counter() - t0
    _check_cluster(sim, got, payloads, "steady")
    return {**_arm_figures(sim, len(payloads), seconds, before),
            **_drain_widths(sim)}


def failover(device, burst: int, wave: int) -> dict:
    """Arm 2: a burst voted while both replicas are partitioned, then a
    failover whose Phase-1 recovery runs on K8."""
    sim = _cluster(device)
    leader = sim.leaders[1]
    recoveries = _spy_recoveries(leader, device)
    for address in sim.config.replica_addresses:
        sim.transport.partition(address)
    got: dict = {}
    payloads = []
    before = _launches()
    t0 = time.perf_counter()
    for w in range(burst // wave):
        pseudonyms = range(w * wave, (w + 1) * wave)
        _write_wave(sim, pseudonyms, b"f", got)
        payloads.extend(b"f%d" % p for p in pseudonyms)
        deliver_until_quiet(sim.transport)
    _require(not got, "failover: a write was answered through the "
                      "partition")
    voted = sum(a.max_voted_slot + 1 for a in sim.acceptors)
    for address in sim.config.replica_addresses:
        sim.transport.heal(address)
    t1 = time.perf_counter()
    sim.leaders[0].leader_change(is_new_leader=False)
    leader.leader_change(is_new_leader=True)
    deliver_until_quiet(sim.transport)
    seconds = time.perf_counter() - t0
    recovery_s = time.perf_counter() - t1
    out = _arm_figures(sim, len(payloads), seconds, before)
    _check_cluster(sim, got, payloads, "failover")
    _require(len(recoveries) == 1,
             f"failover: {len(recoveries)} recoveries, not 1")
    out["recovery"] = {"votes_before_failover": voted,
                       "seconds_to_quiet": recovery_s,
                       **_check_recovery(leader, recoveries[0],
                                         "failover")}
    return {**out, **_drain_widths(sim)}


def _hold_slow_votes(transport, proxies: set, acceptors: set,
                     held: list, slow: list) -> None:
    """Move the slow acceptor's buffered votes to the ProxyLeaders into
    ``held``. The slow acceptor is the sender of the first vote seen
    (``slow`` holds it once chosen), so it is in the run's quorum."""
    keep = []
    for m in transport.messages:
        if m.dst in proxies and m.src in acceptors and (
                not slow or m.src == slow[0]):
            slow[:] = [m.src]
            held.append(m)
        else:
            keep.append(m)
    transport.messages[:] = keep


def pipelined(device, writes: int, wave: int) -> dict:
    """Arm 3: the pipelined tracker; between deliveries the quiescence
    flush timers collect the in-flight dispatches. The last wave's
    votes from one acceptor straggle across a failover (the module's
    docstring)."""
    sim = _cluster(device, tpu_pipelined=True)
    transport = sim.transport
    config = sim.config
    proxies = set(config.proxy_leader_addresses)
    acceptors = {a for group in config.acceptor_addresses for a in group}
    recoveries = _spy_recoveries(sim.leaders[1])
    got: dict = {}
    payloads = []
    before = _launches()
    t0 = time.perf_counter()
    waves = writes // wave
    for w in range(waves):
        _write_wave(sim, range(wave), b"p%d." % w, got)
        payloads.extend(b"p%d.%d" % (w, p) for p in range(wave))
        if w < waves - 1:
            _settle(transport)
    held: list = []
    slow: list = []
    while True:
        _hold_slow_votes(transport, proxies, acceptors, held, slow)
        if transport.messages:
            transport.deliver_all_coalesced(len(transport.messages))
            continue
        flush = [t for t in transport.running_timers()
                 if t.name == "tpuDrainFlush"]
        if not flush:
            break
        for timer in flush:
            transport.trigger_timer(timer.id)
    _require(held, "pipelined: no vote of the last wave was held back")
    sim.leaders[0].leader_change(is_new_leader=False)
    sim.leaders[1].leader_change(is_new_leader=True)
    # Deliver until the new round's votes are buffered for the
    # ProxyLeaders; the held votes join their wave.
    while not any(m.dst in proxies and m.src in acceptors
                  for m in transport.messages):
        _require(transport.messages, "pipelined: the new leader's "
                                     "votes never came")
        transport.deliver_all_coalesced(len(transport.messages))
        _hold_slow_votes(transport, proxies, acceptors, held, slow)
    transport.messages.extend(held)
    _settle(transport)
    seconds = time.perf_counter() - t0
    out = _arm_figures(sim, len(payloads), seconds, before)
    _check_cluster(sim, got, payloads, "pipelined")
    _require(len(recoveries) == 1,
             f"pipelined: {len(recoveries)} recoveries, not 1")
    out["straggler"] = {
        "acceptor": slow[0], "held_messages": len(held),
        "recovery": _check_recovery(sim.leaders[1], recoveries[0],
                                    "pipelined")}
    return out


def run(device=None, writes: int = 1 << 16, burst: int = 1 << 16,
        pipelined_writes: int = 1 << 14, wave: int = WAVE) -> dict:
    """All three arms on ``device`` (``cuda`` when None); raises
    ``GateFailure`` on a failed gate. On a CUDA device every kernel of
    ``CLUSTER_KERNELS`` must have launched in the arms' traffic."""
    dev = resolve_device(device)
    for n in (writes, burst, pipelined_writes):
        if n % wave or n <= 0:
            raise ValueError(f"{n} writes is not a positive multiple of "
                             f"the wave ({wave})")
    arms = {"steady": steady(dev, writes, wave),
            "failover": failover(dev, burst, wave),
            "pipelined": pipelined(dev, pipelined_writes, wave)}
    launches = {k: sum(arm["launches"][k] for arm in arms.values())
                for k in WRAPPERS}
    if dev.type == "cuda":
        missing = [k for k in CLUSTER_KERNELS if not launches[k]]
        _require(not missing, f"cluster traffic never launched {missing}")
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "wave": wave, "window": WINDOW, "arms": arms,
        "launches": launches,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
