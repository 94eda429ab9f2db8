"""Closed-loop Matchmaker MultiPaxos clusters over SimTransport, through
repeated acceptor reconfigurations and a matchmaker reconfiguration, each
on the host quorum backend and on K6's stateless check. Run::

    python -m frankenpaxos_tpu_torch.bench.matchmaker_sim [--device cpu]
        [--writes N]

It prints ONE JSON line. Arms (``ARMS``) at the vldb20 Matchmaker Paxos
widths: f = 1 (2 leaders, 3 matchmakers, 1 reconfigurer, 6 acceptors, 2
replicas) and f = 2 (3 leaders, 5 matchmakers, 1 reconfigurer, 10
acceptors, 3 replicas). ``CLIENTS`` clients with ``PSEUDONYMS`` pseudonyms
each keep one write in flight per pseudonym (the next written from the
reply's callback) until ``writes`` writes are answered. Every
``RECONFIGURE_EVERY`` answers the reconfigurer hands the leaders a burst of
1, 2 or 3 new acceptor configurations in turn (a burst makes the next
phase 1 read several prior configurations); the configurations cycle
through ``SimpleMajority`` and ``UnanimousWrites`` over 2f + 1 acceptors
and a ``Grid`` of 2 rows of f + 1 (a grid of 2f + 1 nodes would be one row
or one column), each drawn from the pool. At half the writes the
matchmakers move to a new epoch (all 2f + 1 of them: the widths have no
spare matchmaker). Each arm runs on ``quorum_backend="dict"`` (the
reference's host loop) and on ``"cuda"`` (K6's stateless check on
``device``: one staged call a Phase1b, the card when None, the plain
version on ``"cpu"``) from the same seed. When delivery goes quiet the
protocol's own timers fire.

Gates (a failed gate raises ``GateFailure``): every write answered
exactly once, the replicas' executed logs equal and each holding every
answered payload once, the ``"cuda"`` run's replica logs and replies
equal to the ``"dict"`` run's, and on a card K6's stateless launches
equal to the ``"cuda"`` run's phase-1 checks, above 0 (the plain version
counts none).

Figures per arm and backend: writes/s on the host clock, the phase 1s
and their checks (one a Phase1b), K6's stateless launches, the median and
p99 host microseconds a check (each leader's check of the prior
configurations timed around its call), the checker set-up microseconds a
phase 1 (read specs, key and cache lookup, and a build on a miss), the
checkers built and the median microseconds of a build, and the count of
phase 1s by K, the prior configurations read. A port-only measurement
harness, like ``bench/fast_sim.py``.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols import matchmaker_harness
from frankenpaxos_tpu_torch.quorums import Grid, SimpleMajority, UnanimousWrites

#: ``{arm: (f, acceptors, matchmakers)}``.
ARMS = {"f1": (1, 6, 3), "f2": (2, 10, 5)}
BACKENDS = ("dict", "cuda")
CLIENTS = 4
PSEUDONYMS = 2
WRITES = 1 << 11
RECONFIGURE_EVERY = 32
BURSTS = (1, 2, 3)
#: Quiet waves (timers fired) a run may take before it fails.
MAX_QUIET_WAVES = 256


class GateFailure(RuntimeError):
    """A matchmaker_sim gate failed."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def _timed(obj, name: str, samples: list, sizes=None) -> None:
    """Time every call of ``obj.name`` into ``samples`` (ns); with
    ``sizes``, also append the length of its first argument."""
    call = getattr(obj, name)
    clock = time.perf_counter_ns

    def timed(*args):
        t0 = clock()
        got = call(*args)
        samples.append(clock() - t0)
        if sizes is not None:
            sizes.append(len(args[0]))
        return got

    setattr(obj, name, timed)


def configuration(kind: int, f: int, acceptors: int, rng: random.Random):
    """The ``kind``-th configuration of the cycle over the pool."""
    kind %= 3
    if kind == 1:
        nodes = rng.sample(range(acceptors), 2 * (f + 1))
        return Grid([nodes[:f + 1], nodes[f + 1:]])
    nodes = rng.sample(range(acceptors), 2 * f + 1)
    return SimpleMajority(nodes) if kind == 0 else UnanimousWrites(nodes)


def _us(samples: list) -> dict:
    us = np.asarray(samples, dtype=np.float64) / 1e3
    if not us.size:
        return {"p50": None, "p99": None, "mean": None}
    return {"p50": float(np.median(us)),
            "p99": float(np.percentile(us, 99)), "mean": float(us.mean())}


def run_arm(f: int, acceptors: int, matchmakers: int, backend: str,
            device=None, writes: int = WRITES, seed: int = 0) -> dict:
    """One closed-loop run; returns its figures and its plain-data replica
    log and replies (``"log"``, ``"replies"``)."""
    (transport, _, leaders, _, reconfigurer, _, replicas,
     clients) = matchmaker_harness.make_mmp(
        f=f, num_acceptors=acceptors, num_clients=CLIENTS, seed=seed,
        num_matchmakers=matchmakers, quorum_backend=backend, device=device)
    checks: list = []
    setups: list = []
    builds: list = []
    ks: list = []
    for leader in leaders:
        _timed(leader, "_read_quorums_met", checks)
        _timed(leader, "_phase1_checker", setups, ks)
        _timed(leader, "_build_checker", builds)
    launches0 = tq.check_batch_multi.launches
    rng = random.Random(seed)
    schedule = {"configurations": 0, "bursts": 0, "epoch_changes": 0}
    replies: dict = {}
    issued = [0]

    def reconfigure() -> None:
        for _ in range(BURSTS[schedule["bursts"] % len(BURSTS)]):
            reconfigurer.reconfigure(configuration(
                schedule["configurations"], f, acceptors, rng))
            schedule["configurations"] += 1
        schedule["bursts"] += 1

    def write(c: int, p: int) -> None:
        if issued[0] >= writes:
            return
        payload = b"w%d" % issued[0]
        issued[0] += 1
        key = (c, p, clients[c].ids.get(p, 0))

        def on_reply(result, key=key, payload=payload):
            _require(key not in replies, f"write {key} answered twice")
            replies[key] = (payload, result)
            if len(replies) % RECONFIGURE_EVERY == 0:
                reconfigure()
            if len(replies) == writes // 2:
                reconfigurer.reconfigure_matchmakers(range(2 * f + 1))
                schedule["epoch_changes"] += 1
            write(key[0], key[1])

        clients[c].write(p, payload, on_reply)

    transport.deliver_all()  # round 0's matchmaking
    t0 = time.perf_counter()
    for c in range(CLIENTS):
        for p in range(PSEUDONYMS):
            write(c, p)
    quiet = 0
    while len(replies) < writes:
        if transport.deliver_all():
            continue
        quiet += 1
        _require(quiet <= MAX_QUIET_WAVES,
                 f"f={f} {backend}: {len(replies)} of {writes} writes "
                 f"answered after {MAX_QUIET_WAVES} quiet waves")
        for timer in transport.running_timers():
            transport.trigger_timer(timer.id)
    transport.deliver_all()
    seconds = time.perf_counter() - t0
    launches = tq.check_batch_multi.launches - launches0

    name = f"f={f} {backend}"
    _require(len(replies) == writes,
             f"{name}: {len(replies)} replies for {writes} writes")
    logs = [r.state_machine.get() for r in replicas]
    for i, log in enumerate(logs):
        _require(log == logs[0], f"{name}: replica {i}'s log differs from "
                                 f"replica 0's")
    _require(sorted(logs[0]) == sorted(p for p, _ in replies.values()),
             f"{name}: the executed payloads are not the writes answered, "
             f"once each")
    for payload, result in replies.values():
        _require(logs[0][int(result)] == payload,
                 f"{name}: {payload!r} answered {result!r}")
    if backend == "cuda" and resolve_device(device).type == "cuda":
        _require(launches == len(checks) and launches > 0,
                 f"{name}: {launches} K6 launches for {len(checks)} "
                 f"phase-1 checks")
    return {
        "writes": writes, "pseudonyms": CLIENTS * PSEUDONYMS,
        "acceptors": acceptors, "matchmakers": matchmakers,
        "seconds": seconds, "writes_per_sec": writes / seconds,
        "configurations": schedule["configurations"],
        "matchmaker_epoch_changes": schedule["epoch_changes"],
        "matchmaker_epoch": max(l.matchmaker_configuration.epoch
                                for l in leaders),
        "phase1s": len(ks) if backend == "cuda" else None,
        "phase1_checks": len(checks),
        "check_batch_multi_launches": launches,
        "check_host_us": _us(checks),
        "setup_host_us": _us(setups),
        "checker_builds": len(builds),
        "build_host_us": _us(builds),
        "k_counts": {str(k): ks.count(k) for k in sorted(set(ks))},
        "log": logs[0], "replies": replies,
    }


def run(device=None, writes: int = WRITES, seed: int = 0) -> dict:
    """Every arm on both backends; the cuda run held to the dict run."""
    dev = resolve_device(device)
    out: dict = {"device": str(dev), "writes": writes, "arms": {}}
    for arm, (f, acceptors, matchmakers) in ARMS.items():
        runs = {backend: run_arm(f, acceptors, matchmakers, backend,
                                 dev if backend == "cuda" else None,
                                 writes, seed)
                for backend in BACKENDS}
        _require(runs["cuda"]["log"] == runs["dict"]["log"],
                 f"{arm}: the cuda run's log differs from the dict run's")
        _require(runs["cuda"]["replies"] == runs["dict"]["replies"],
                 f"{arm}: the cuda run's replies differ from the dict "
                 f"run's")
        out["arms"][arm] = {
            backend: {k: v for k, v in fig.items()
                      if k not in ("log", "replies")}
            for backend, fig in runs.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--writes", type=int, default=WRITES)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    try:
        result = run(args.device, args.writes, args.seed)
    except GateFailure as exc:
        print(f"matchmaker_sim: FAILED: {exc}", file=sys.stderr)
        return 1
    result["nvidia_smi"] = nvidia_smi_line()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
