"""MultiPaxos with read batchers, over SimTransport: writes and reads of
a key-value store interleaved, under each read batching scheme.

Run::

    python -m frankenpaxos_tpu_torch.bench.read_batch_sim [--device cpu]

It prints ONE JSON line. The cluster is the harness's ``f = 1`` (one
group of 3 acceptors, 2 leaders, 2 proxy leaders, 2 replicas) with
``READ_BATCHERS`` read batchers, ``CLIENTS`` clients staging their
writes into request arrays, and a ``KeyValueStore`` over ``KEYS`` keys.
The operations come in waves: every pseudonym of every client issues
one operation (a seeded draw of a write, a linearizable read, and under
the ``size`` and ``time`` schemes also sequential and eventual reads),
then the cluster is delivered until every operation of the wave is
answered, firing the read batchers' flush timers and the pipelined
tracker's flush timer whenever delivery goes quiet. Each write sets its
key to a value unique to the operation.

Schemes (``SCHEMES``): ``size`` (a batch flushes at the reference's
batch size 10, or at its timer), ``time`` (a batch flushes at its timer)
and ``adaptive`` (a batch flushes as soon as the previous batch's
max-slot quorum is back; linearizable reads only). Backends
(``BACKENDS``): the ProxyLeaders' ``dict`` tracker and the ``cuda``
tracker synchronous and pipelined. A wave's drains span a few dozen
slots, under the synchronous tracker's host/device routing threshold,
so that arm pins the device path on (``tpu_min_device_slots=1``: K1 on
every drain); the pipelined tracker counts every drain on its board
(K2).

Gates (a failed gate raises ``GateFailure``): every operation is
answered exactly once; every linearizable read returns a value at least
as new, in the replicas' log order, as the last write to its key that
was acknowledged before the read was issued; both replicas' executed
logs are equal and hold every write once; per scheme, the cuda arms'
logs and read replies equal the dict arm's; on a card K1 launches on
the synchronous arms and K2 on the pipelined ones, and every cuda arm's
trackers call the device on its traffic. Figures per arm: reads/s and
writes/s on the host clock, the BatchMaxSlotRequests the acceptors
received, the linearizable batches and reads per batch, the trackers'
drains that called the device, and the launches (the trackers'
construction prewarm included: 4 K1 launches a ProxyLeader).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
import types

import torch

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols.multipaxos import (
    harness,
    ReadBatchingScheme,
)
from frankenpaxos_tpu_torch.runtime import PickleSerializer
from frankenpaxos_tpu_torch.statemachine import (
    GetRequest,
    KeyValueStore,
    SetRequest,
)

OPERATIONS = 1 << 10
CLIENTS = 2
PSEUDONYMS = 32          # a wave: CLIENTS x PSEUDONYMS operations
KEYS = 8
READ_BATCHERS = 2
SCHEMES = {
    "size": dict(kind="size", batch_size=10),
    "time": dict(kind="time"),
    "adaptive": dict(kind="adaptive"),
}
BACKENDS = {
    "dict": dict(quorum_backend="dict"),
    "cuda_sync": dict(quorum_backend="cuda", tpu_min_device_slots=1),
    "cuda_pipelined": dict(quorum_backend="cuda", tpu_pipelined=True),
}
#: The kernel each cuda backend must launch.
BACKEND_KERNEL = {"cuda_sync": "quorum_hit", "cuda_pipelined": "record_block"}
#: Operation kinds and their weights; adaptive batching serves
#: linearizable reads only.
KINDS = {"write": 5, "read": 3, "sequential": 1, "eventual": 1}
ADAPTIVE_KINDS = {"write": 5, "read": 3}
#: The timers a drive fires when delivery goes quiet.
FLUSH_TIMERS = ("linearizableTimer", "sequentialTimer", "eventualTimer",
                "tpuDrainFlush")


class GateFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def port_package() -> types.SimpleNamespace:
    """The names ``scenario`` takes from a package (a test passes the
    JAX package's harness and classes under the same names)."""
    return types.SimpleNamespace(
        make_multipaxos=harness.make_multipaxos,
        executed_prefix=harness.executed_prefix,
        ReadBatchingScheme=ReadBatchingScheme,
        KeyValueStore=KeyValueStore, GetRequest=GetRequest,
        SetRequest=SetRequest, serializer=PickleSerializer())


def settle(sim, done, max_rounds: int = 200) -> None:
    """Deliver until quiet, firing ``FLUSH_TIMERS`` whenever delivery
    goes quiet, until ``done()``."""
    transport = sim.transport
    for _ in range(max_rounds):
        while transport.messages:
            transport.deliver_all_coalesced()
        if done():
            return
        for timer in transport.running_timers():
            if timer.name in FLUSH_TIMERS:
                transport.trigger_timer(timer.id)
    raise GateFailure("the cluster did not settle")


def _decode_log(pkg, log) -> list:
    """A replica's executed log as decoded commands (noops as None)."""
    out = []
    for value in log:
        commands = getattr(value, "commands", None)
        if commands is None:
            out.append(None)
            continue
        out.append(tuple(
            (c.command_id.client_pseudonym, c.command_id.client_id,
             repr(pkg.serializer.from_bytes(c.command)))
            for c in commands))
    return out


def scenario(pkg=None, scheme: str = "size", operations: int = OPERATIONS,
             seed: int = 0, **cluster) -> dict:
    """One arm: ``operations`` operations in waves on a fresh cluster of
    ``pkg`` (the port when None) under ``scheme``, with ``cluster``
    passed to the harness. Returns the replicas' decoded logs, every
    operation's decoded replies, the kinds, the acceptors'
    BatchMaxSlotRequest count, the read batchers' linearizable batches,
    the seconds and the cluster."""
    pkg = pkg or port_package()
    ser = pkg.serializer
    sim = pkg.make_multipaxos(
        f=1, num_clients=CLIENTS, coalesced=True, seed=seed,
        state_machine_factory=pkg.KeyValueStore,
        num_read_batchers=READ_BATCHERS,
        read_batching_scheme=pkg.ReadBatchingScheme(**SCHEMES[scheme]),
        **cluster)
    rng = random.Random(seed)
    kinds_weights = ADAPTIVE_KINDS if scheme == "adaptive" else KINDS
    kinds = list(kinds_weights)
    weights = list(kinds_weights.values())
    ops: list = []            # (kind, key, value or None)
    replies: dict = {}        # operation -> [decoded result, ...]
    acked: dict = {}          # key -> [write values acknowledged, in order]
    seen_acked: dict = {}     # read operation -> acked writes at issue
    read_values: dict = {}    # read operation -> the value it returned
    answered = [0]

    def on_reply(i: int, kind: str, key: str, value):
        def callback(result: bytes) -> None:
            reply = ser.from_bytes(result)
            replies.setdefault(i, []).append(repr(reply))
            if kind == "write":
                acked.setdefault(key, []).append(value)
            else:
                read_values[i] = reply.key_values[0][1]
            answered[0] += 1
        return callback

    t0 = time.perf_counter()
    while len(ops) < operations:
        for client in sim.clients:
            for p in range(PSEUDONYMS):
                if len(ops) >= operations:
                    break
                i = len(ops)
                kind = rng.choices(kinds, weights)[0]
                key = f"k{rng.randrange(KEYS)}"
                value = f"v{i}" if kind == "write" else None
                ops.append((kind, key, value))
                callback = on_reply(i, kind, key, value)
                if kind == "write":
                    client.write(p, ser.to_bytes(
                        pkg.SetRequest(((key, value),))), callback)
                    continue
                seen_acked[i] = len(acked.get(key, ()))
                get = ser.to_bytes(pkg.GetRequest((key,)))
                if kind == "read":
                    client.read(p, get, callback)
                elif kind == "sequential":
                    client.sequential_read(p, get, callback)
                else:
                    client.eventual_read(p, get, callback)
            client.flush_writes()
        want = len(ops)
        settle(sim, lambda: answered[0] >= want)
    seconds = time.perf_counter() - t0
    logs = [_decode_log(pkg, pkg.executed_prefix(r)) for r in sim.replicas]
    return {
        "sim": sim, "ops": ops, "replies": replies, "logs": logs,
        "acked_before": seen_acked, "acked": acked,
        "read_values": read_values, "seconds": seconds,
        "batch_max_slot_requests": sum(
            int(a.metrics_requests.labels("BatchMaxSlotRequest").get())
            for a in sim.acceptors),
        # Each flush of a read batcher's linearizable batch takes the
        # next batch id.
        "linearizable_batches": sum(
            actor.linearizable_id
            for actor in sim.transport.actors.values()
            if type(actor).__name__ == "ReadBatcher"),
    }


def check(run: dict) -> None:
    """The arm's own gates: every operation answered exactly once, the
    replicas' logs equal and holding every write once, and every
    linearizable read at least as new as the writes acknowledged before
    it was issued."""
    ops, replies, logs = run["ops"], run["replies"], run["logs"]
    twice = [i for i, got in replies.items() if len(got) != 1]
    _require(not twice, f"{len(twice)} operations answered more than once")
    _require(len(replies) == len(ops),
             f"{len(replies)} of {len(ops)} operations answered")
    _require(all(log == logs[0] for log in logs),
             "the replicas' executed logs differ")
    position: dict = {}
    for at, entry in enumerate(logs[0]):
        for _, _, command in entry or ():
            position.setdefault(command, []).append(at)
    writes = {value: (key, i) for i, (kind, key, value) in enumerate(ops)
              if kind == "write"}
    where: dict = {}
    for value, (key, _) in writes.items():
        text = repr(SetRequest(((key, value),)))
        at = position.get(text, [])
        _require(len(at) == 1, f"write {value} is in the log {len(at)} "
                               f"times")
        where[value] = at[0]
    stale = []
    for i, (kind, key, _) in enumerate(ops):
        if kind != "read":
            continue
        before = run["acked"].get(key, [])[:run["acked_before"][i]]
        need = max((where[v] for v in before), default=-1)
        got = run["read_values"][i]
        if need >= 0 and (got is None or where.get(got, -1) < need):
            stale.append((i, key, got, before[-3:]))
    _require(not stale, f"{len(stale)} linearizable reads returned a "
                        f"value older than an acknowledged write: "
                        f"{stale[:3]}")


def launches() -> dict:
    return {name: getattr(tq, name).launches
            for name in set(BACKEND_KERNEL.values())}


def _arm_figures(run: dict, before: dict) -> dict:
    ops = run["ops"]
    writes = sum(1 for kind, _, _ in ops if kind == "write")
    reads = len(ops) - writes
    linearizable = sum(1 for kind, _, _ in ops if kind == "read")
    batches = run["linearizable_batches"]
    sim = run["sim"]
    return {
        "operations": len(ops), "writes": writes, "reads": reads,
        "linearizable_reads": linearizable,
        "seconds": run["seconds"],
        "writes_per_sec": writes / run["seconds"],
        "reads_per_sec": reads / run["seconds"],
        "batch_max_slot_requests": run["batch_max_slot_requests"],
        "linearizable_batches": batches,
        "reads_per_batch": linearizable / batches if batches else None,
        "device_drains": sum(getattr(p.tracker, "device_drains", 0)
                             for p in sim.proxy_leaders),
        "launches": {k: v - before[k] for k, v in launches().items()},
        "collector_errors": sum(len(p.collector_errors)
                                for p in sim.proxy_leaders),
    }


def run(device=None, operations: int = OPERATIONS, seed: int = 0) -> dict:
    """Every scheme on every backend, the cuda backends on ``device``
    (the card when None)."""
    dev = resolve_device(device)
    schemes: dict = {}
    for scheme in SCHEMES:
        runs: dict = {}
        arms: dict = {}
        for backend, options in BACKENDS.items():
            if options["quorum_backend"] == "cuda":
                options = dict(options, device=dev)
            before = launches()
            runs[backend] = scenario(scheme=scheme, operations=operations,
                                     seed=seed, **options)
            check(runs[backend])
            arms[backend] = _arm_figures(runs[backend], before)
            for proxy in runs[backend]["sim"].proxy_leaders:
                proxy.close()
        for backend, kernel in BACKEND_KERNEL.items():
            _require(runs[backend]["logs"] == runs["dict"]["logs"],
                     f"{scheme} {backend}: the replicas' logs differ from "
                     f"the dict arm's")
            _require(runs[backend]["replies"] == runs["dict"]["replies"],
                     f"{scheme} {backend}: the replies differ from the "
                     f"dict arm's")
            _require(arms[backend]["collector_errors"] == 0,
                     f"{scheme} {backend}: the collector logged errors")
            _require(arms[backend]["device_drains"] > 0,
                     f"{scheme} {backend}: no tracker drain called the "
                     f"device")
            if dev.type == "cuda":
                _require(arms[backend]["launches"][kernel] > 0,
                         f"{scheme} {backend}: {kernel} never launched")
        schemes[scheme] = arms
    return {
        "benchmark": "read_batch_sim",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "operations": operations, "seed": seed, "clients": CLIENTS,
        "pseudonyms": PSEUDONYMS, "keys": KEYS,
        "read_batchers": READ_BATCHERS, "schemes": schemes,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--operations", type=int, default=OPERATIONS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, args.operations, args.seed)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
