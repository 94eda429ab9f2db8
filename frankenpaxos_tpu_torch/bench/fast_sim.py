"""Closed-loop Fast MultiPaxos clusters over SimTransport, each on the
host quorum backend and on K6's stateless check. Run::

    python -m frankenpaxos_tpu_torch.bench.fast_sim [--device cpu]
        [--commands N]

It prints ONE JSON line. Arms (``ARMS``): f = 1 (3 acceptors, 2 leaders,
fast quorum 3) and f = 2 (5 acceptors, 3 leaders, fast quorum 4), each
with ``CLIENTS`` closed-loop clients (one command in flight each, the
next proposed from the reply's callback) until ``commands`` commands are
answered; round 0 is fast, so clients propose straight to the acceptors
and the leader counts their Phase2bs. Each arm runs on
``quorum_backend="host"`` (the numpy oracle) and on ``"cuda"`` (K6's
stateless check on ``device``: one staged call a check, the card when
None, the plain version on ``"cpu"``) from the same seed. When delivery
goes quiet the protocol's own timers fire (the reference tests' pump).

Gates (a failed gate raises ``GateFailure``): every command answered
exactly once with its AppendLog index, every payload executed once,
every leader's log equal and complete (no hole below the chosen
watermark), the ``"cuda"`` run's leader logs and replies equal to the
``"host"`` run's, and on a card K6's stateless launches equal to the
``"cuda"`` run's checks, above 0 (the plain version counts none).

Figures per arm and backend: commands/s on the host clock, each leader
SpecChecker's check count (classic, fast, recovery), K6's stateless
launches, and the median and p99 host microseconds a check (every
leader check timed around its call, the timer's own ~0.1 us included).
A port-only measurement harness, like ``bench/reconfig_sim.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols import fast_harness

#: ``{arm: f}``.
ARMS = {"f1": 1, "f2": 2}
BACKENDS = ("host", "cuda")
CLIENTS = 8
COMMANDS = 1 << 12
#: Quiet waves (timers fired) a run may take before it fails.
MAX_QUIET_WAVES = 4096
CHECKERS = ("classic_quorum", "fast_quorum", "recovery_quorum")


class GateFailure(RuntimeError):
    """A fast_sim gate failed."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def _timed(checker, samples: list) -> None:
    """Time every ``checker.check`` into ``samples`` (ns)."""
    check = checker.check
    clock = time.perf_counter_ns

    def timed(nodes):
        t0 = clock()
        got = check(nodes)
        samples.append(clock() - t0)
        return got

    checker.check = timed


def _norm(value):
    """A log entry as plain data: ``None`` for a Noop, else the command's
    (client, id, payload)."""
    if not hasattr(value, "command_id"):
        return None
    cid = value.command_id
    return (cid.client_address, cid.client_id, value.command)


def run_arm(f: int, backend: str, device=None, commands: int = COMMANDS,
            clients: int = CLIENTS, seed: int = 0) -> dict:
    """One closed-loop run; returns its figures and its plain-data logs
    and replies (``"log"``, ``"replies"``)."""
    transport, _, leaders, _, fmp_clients = fast_harness.make_fastmultipaxos(
        f=f, num_clients=clients, seed=seed, quorum_backend=backend,
        device=device)
    samples: list = []
    for leader in leaders:
        for name in CHECKERS:
            _timed(getattr(leader, name), samples)
    launches0 = tq.check_batch_multi.launches
    transport.deliver_all()  # round 0's phase 1 and anySuffix
    issued = [0]
    replies: dict = {}

    def propose(c: int) -> None:
        if issued[0] >= commands:
            return
        payload = b"c%d" % issued[0]
        issued[0] += 1
        client = fmp_clients[c]
        key = (c, client.next_id)

        def on_reply(result, key=key, payload=payload):
            _require(key not in replies, f"command {key} answered twice")
            replies[key] = (payload, result)
            propose(key[0])

        client.propose(payload, on_reply)

    t0 = time.perf_counter()
    for c in range(clients):
        propose(c)
    quiet = 0
    while len(replies) < commands:
        if transport.deliver_all():
            continue
        quiet += 1
        _require(quiet <= MAX_QUIET_WAVES,
                 f"f={f} {backend}: {len(replies)} of {commands} commands "
                 f"answered after {MAX_QUIET_WAVES} quiet waves")
        for timer in transport.running_timers():
            if not timer.name.startswith(fast_harness.QUIET_TIMERS_SKIPPED):
                transport.trigger_timer(timer.id)
    transport.deliver_all()
    seconds = time.perf_counter() - t0
    launches = tq.check_batch_multi.launches - launches0

    _require(len(replies) == commands,
             f"f={f} {backend}: {len(replies)} replies for {commands}")
    log0 = {s: _norm(v) for s, v in leaders[0].log.items()}
    for i, leader in enumerate(leaders):
        log = {s: _norm(v) for s, v in leader.log.items()}
        _require(log == log0, f"f={f} {backend}: leader {i}'s log differs "
                              f"from leader 0's")
        _require(leader.chosen_watermark == len(log) == max(log) + 1,
                 f"f={f} {backend}: leader {i}'s log has a hole "
                 f"(watermark {leader.chosen_watermark}, {len(log)} slots)")
    executed = [e[2] for e in log0.values() if e is not None]
    _require(sorted(executed) == sorted(p for p, _ in replies.values()),
             f"f={f} {backend}: the executed payloads are not the "
             f"commands answered, once each")
    results = leaders[0].state_machine.get()
    for payload, result in replies.values():
        _require(results[int(result)] == payload,
                 f"f={f} {backend}: {payload!r} answered {result!r}")
    checks = {name: sum(getattr(l, name).checks for l in leaders)
              for name in CHECKERS}
    total = sum(checks.values())
    if backend == "cuda" and resolve_device(device).type == "cuda":
        _require(launches == total and launches > 0,
                 f"f={f}: {launches} K6 launches for {total} cuda checks")
    us = np.asarray(samples, dtype=np.float64) / 1e3
    return {
        "commands": commands, "clients": clients, "acceptors": 2 * f + 1,
        "seconds": seconds, "commands_per_sec": commands / seconds,
        "checks": checks, "check_batch_multi_launches": launches,
        "check_host_us_p50": float(np.median(us)) if us.size else None,
        "check_host_us_p99": float(np.percentile(us, 99))
        if us.size else None,
        "slots": len(log0),
        "log": log0, "replies": replies,
    }


def run(device=None, commands: int = COMMANDS, clients: int = CLIENTS,
        seed: int = 0) -> dict:
    """Every arm on both backends; the cuda run held to the host run."""
    dev = resolve_device(device)
    out: dict = {"device": str(dev), "commands": commands,
                 "clients": clients, "arms": {}}
    for arm, f in ARMS.items():
        runs = {backend: run_arm(f, backend, dev if backend == "cuda"
                                 else None, commands, clients, seed)
                for backend in BACKENDS}
        _require(runs["cuda"]["log"] == runs["host"]["log"],
                 f"{arm}: the cuda run's log differs from the host run's")
        _require(runs["cuda"]["replies"] == runs["host"]["replies"],
                 f"{arm}: the cuda run's replies differ from the host "
                 f"run's")
        out["arms"][arm] = {
            backend: {k: v for k, v in fig.items()
                      if k not in ("log", "replies")}
            for backend, fig in runs.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--commands", type=int, default=COMMANDS)
    parser.add_argument("--clients", type=int, default=CLIENTS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    try:
        result = run(args.device, args.commands, args.clients, args.seed)
    except GateFailure as exc:
        print(f"fast_sim: FAILED: {exc}", file=sys.stderr)
        return 1
    result["nvidia_smi"] = nvidia_smi_line()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
