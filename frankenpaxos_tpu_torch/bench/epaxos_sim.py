"""EPaxos as a cluster of actors over SimTransport, on one GPU.

The dependency-set plane of the port end to end: five EPaxos replicas
(``f = 2``), a ``KeyValueStore``, ``top_k_dependencies = 1`` and the
Tarjan dependency graph, built by ``protocols/epaxos/harness.py``. Run::

    python -m frankenpaxos_tpu_torch.bench.epaxos_sim [--device cpu]

It prints ONE JSON line. 64 closed-loop ``(client, pseudonym)`` pairs
(8 clients of 8 pseudonyms; each client sends each command to a replica
it draws at random, as the reference client does) propose
``SetRequest`` writes until 2^14 commands are answered. Two arms after
the EPaxos paper's (SOSP'13 section 7) low- and mid-conflict workloads,
each on a fresh cluster:

  * ``conflict2``: 2% of the commands write one hot key, the rest a key
    of their own;
  * ``conflict25``: the same with 25%.

Each arm runs twice on one seed: with ``dep_backend="host"`` (the
per-reply set loops) and with ``dep_backend="cuda"``, where every
fast-path decision runs K11 ``all_equal`` over the three non-leader
replies and every slow path runs K10 ``conflict_max`` over the quorum's
replies. At ``f = 1`` the device path would not run outside recovery:
the fast path there counts one reply, which the host decides alone.
The host runs launch no kernel, so they go to two worker processes and
overlap the cuda runs, which stay in the calling process (where the
kernels' launch counts are read); each run is timed on its own clock.

Gates (a failed gate raises ``GateFailure``):

  1. every command is answered exactly once, with its ``KeyValueStore``
     result, and every replica executed each command once;
  2. all five replicas hold equal state machines and equal committed
     logs (``instance -> (command, seq, deps)``; the deps compare as
     canonical IntPrefixSet columns, equal iff the materialized sets
     are);
  3. the ``"cuda"`` run's committed logs and replies equal the
     ``"host"`` run's;
  4. on a CUDA device, ``conflict_max`` and ``all_equal`` each launched
     on the ``"cuda"`` run's traffic.

With ``top_k_dependencies = 1`` a hot-key command depends on a
watermark prefix of every column. The port's replica hands its
dependency graph only the part of that prefix it has not executed, and
its ``KeyValueStore`` keeps each key's conflict maxima, so a run's host
cost grows with its length, not with its square (the reference's Python
materializes the whole prefix at every commit).

Figures per arm and backend: committed commands/s on the host clock
(the actors are Python), the fast- and slow-path counts, the device
batches and span fall-backs the replicas counted (``depset_batch`` and
``depset_span_fallback``, as the reference names them), and the
launches of K9-K11 on the traffic; per arm, the call time of K10 and K11
(CUDA events) at the arm's shapes, the rows of the last quorum's
replies.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ProcessPoolExecutor
import json
import multiprocessing
import random
import sys
import time

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ops import depset
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.epaxos.harness import (
    committed_triples,
    make_epaxos,
)
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.runtime import PickleSerializer
from frankenpaxos_tpu_torch.statemachine import KeyValueStore, SetRequest
import torch

#: The dep-set kernel wrappers, by name.
WRAPPERS = {
    "normalized": depset.normalized,
    "union_reduce": depset.union_reduce,
    "conflict_max": depset.conflict_max,
    "all_equal": depset.all_equal,
}
#: The kernels the cluster's traffic must launch (on a CUDA device).
CLUSTER_KERNELS = ("conflict_max", "all_equal")

F = 2
CLIENTS = 8
PSEUDONYMS = 8
COMMANDS = 1 << 14
HOT_KEY = "hot"
#: Arm name -> share of commands that write the hot key.
ARMS = {"conflict2": 0.02, "conflict25": 0.25}

SER = PickleSerializer()


class GateFailure(AssertionError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


class DepsetCounts:
    """The two runtime counters ``device_deps._count`` feeds (the
    reference's ``depset_batch`` and ``depset_span_fallback``)."""

    def __init__(self):
        self.calls = 0
        self.rows = 0
        self.span_fallbacks = 0

    def depset_batch(self, ndeps: int) -> None:
        self.calls += 1
        self.rows += ndeps

    def depset_span_fallback(self, n: int = 1) -> None:
        self.span_fallbacks += n


def _launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def workload(conflict: float, commands: int, seed: int) -> list:
    """``commands`` single-key writes: the hot key with probability
    ``conflict``, else a key of the command's own."""
    rng = random.Random(seed)
    return [(HOT_KEY if rng.random() < conflict else f"k{i}", f"v{i}")
            for i in range(commands)]


class SlowPaths:
    """Counts the replicas' slow-path entries and keeps the last one's
    quorum of dependency sets (the rows K10 reduced)."""

    def __init__(self, replicas):
        self.count = 0
        self.last_quorum: list = []
        for replica in replicas:
            replica._pre_accepting_slow_path = self._spy(
                replica._pre_accepting_slow_path)

    def _spy(self, slow_path):
        def spy(instance, state):
            self.count += 1
            self.last_quorum = [r.dependencies.copy()
                                for r in state.responses.values()]
            return slow_path(instance, state)

        return spy


def drive(device, dep_backend: str, writes: list, seed: int) -> dict:
    """One cluster on ``writes``; returns its figures and, for the
    gates, its replies, committed logs and state machines."""
    transport, _, replicas, clients = make_epaxos(
        f=F, num_clients=CLIENTS, seed=seed, dep_backend=dep_backend,
        device=device)
    transport.record_history = False
    counts = DepsetCounts()
    transport.runtime_metrics = counts
    slow = SlowPaths(replicas)
    replies: dict = {}
    duplicates: list = []
    pending = iter(range(len(writes)))

    def propose(c: int, p: int) -> None:
        i = next(pending, None)
        if i is None:
            return
        payload = SER.to_bytes(SetRequest((writes[i],)))

        def done(result: bytes, i=i) -> None:
            if i in replies:
                duplicates.append(i)
            replies[i] = result
            propose(c, p)

        clients[c].propose(p, payload, done)

    before = _launches()
    t0 = time.perf_counter()
    for c in range(CLIENTS):
        for p in range(PSEUDONYMS):
            propose(c, p)
    while transport.messages:
        transport.deliver_all(1 << 30)
    seconds = time.perf_counter() - t0
    after = _launches()
    return {
        "figures": {
            "commands": len(replies), "seconds": seconds,
            "commands_per_sec": len(replies) / seconds,
            "slow_paths": slow.count,
            "fast_paths": len(replies) - slow.count,
            "depset_batch_calls": counts.calls,
            "depset_batch_rows": counts.rows,
            "depset_span_fallbacks": counts.span_fallbacks,
            "launches": {k: after[k] - before[k] for k in after},
        },
        "replies": replies, "duplicates": duplicates,
        "logs": [committed_triples(r) for r in replicas],
        "states": [r.state_machine.get() for r in replicas],
        "executed": [r.executed_count for r in replicas],
        "last_quorum": slow.last_quorum,
    }


def _check(run: dict, writes: list, what: str) -> None:
    """Gates 1 and 2 on one run."""
    _require(not run["duplicates"],
             f"{what}: {len(run['duplicates'])} commands answered twice")
    _require(len(run["replies"]) == len(writes),
             f"{what}: {len(run['replies'])} of {len(writes)} commands "
             f"answered")
    kv = KeyValueStore()
    wrong = [i for i, (key, value) in enumerate(writes)
             if run["replies"][i] != kv.run(SER.to_bytes(
                 SetRequest(((key, value),))))]
    _require(not wrong, f"{what}: {len(wrong)} replies differ from the "
                        f"KeyValueStore's result")
    _require(all(n == len(writes) for n in run["executed"]),
             f"{what}: replicas executed {run['executed']} commands, not "
             f"{len(writes)} each")
    logs, states = run["logs"], run["states"]
    _require(all(log == logs[0] for log in logs[1:]),
             f"{what}: the replicas' committed logs differ")
    _require(len(logs[0]) == len(writes),
             f"{what}: {len(logs[0])} instances committed, not "
             f"{len(writes)}")
    _require(all(s == states[0] for s in states[1:]),
             f"{what}: the replicas' state machines differ")
    hot = [value for key, value in writes if key == HOT_KEY]
    _require(not hot or states[0][HOT_KEY] in hot,
             f"{what}: the hot key holds a value no command wrote")


def kernel_call_us(dev, rows: list, iters: int = 200) -> dict:
    """K10 and K11 call time (CUDA events, wrapper included) at the
    shapes of the arm's last slow-path quorum: its ``len(rows)`` replies
    for K10, the ``fast_quorum_size - 1`` non-leader ones for K11; None
    off CUDA (not measured)."""
    n = 2 * F + 1
    rows = rows or [InstancePrefixSet(n) for _ in range(n - 1)]
    batch = device_deps.to_batch(rows, n, dev)
    k11 = device_deps.to_batch(rows[1:n - 1], n, dev)
    shapes = {"conflict_max": list(batch.tails.shape),
              "all_equal": list(k11.tails.shape)}
    if dev.type != "cuda":
        return {"shapes": shapes, "conflict_max_us": None,
                "all_equal_us": None}
    seqs = torch.zeros(len(rows), dtype=torch.int32, device=dev)
    out = {"shapes": shapes}
    for name, fn in (("conflict_max", lambda: depset.conflict_max(seqs,
                                                                  batch)),
                     ("all_equal", lambda: depset.all_equal(k11))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out[f"{name}_us"] = start.elapsed_time(end) / iters * 1e3
    return out


def host_run(conflict: float, commands: int, seed: int, name: str
             ) -> dict:
    """The host backend's run of one arm (in a worker process), with
    gates 1 and 2; returns what gate 3 compares."""
    writes = workload(conflict, commands, seed)
    host = drive(torch.device("cpu"), "host", writes, seed)
    _check(host, writes, f"{name}/host")
    _require(host["figures"]["depset_batch_calls"] == 0,
             f"{name}: the host backend reached the device path")
    return {"figures": host["figures"], "replies": host["replies"],
            "log": host["logs"][0], "state": host["states"][0]}


def arm(dev, conflict: float, commands: int, seed: int, name: str,
        host_future) -> tuple[dict, list]:
    """The cuda backend on one workload beside the host run that
    ``host_future`` yields; gates 1-3. Returns the arm's figures and the
    cuda run's last slow-path quorum."""
    writes = workload(conflict, commands, seed)
    cuda = drive(dev, "cuda", writes, seed)
    _check(cuda, writes, f"{name}/cuda")
    host = host_future.result()
    _require(cuda["logs"][0] == host["log"],
             f"{name}: the cuda run's committed log differs from the "
             f"host run's")
    _require(cuda["replies"] == host["replies"],
             f"{name}: the cuda run's replies differ from the host run's")
    _require(cuda["states"][0] == host["state"],
             f"{name}: the cuda run's state differs from the host run's")
    return {"conflict": conflict,
            "hot_writes": sum(key == HOT_KEY for key, _ in writes),
            "host": host["figures"], "cuda": cuda["figures"]
            }, cuda["last_quorum"]


def run(device=None, commands: int = COMMANDS, seed: int = 0) -> dict:
    """Both arms on ``device`` (``cuda`` when None); raises
    ``GateFailure`` on a failed gate. On a CUDA device each kernel of
    ``CLUSTER_KERNELS`` must have launched on the cuda runs' traffic."""
    dev = resolve_device(device)
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(ARMS), mp_context=spawn) as pool:
        hosts = {name: pool.submit(host_run, conflict, commands, seed, name)
                 for name, conflict in ARMS.items()}
        arms = {name: arm(dev, conflict, commands, seed, name, hosts[name])
                for name, conflict in ARMS.items()}
    # Kernel timing once the workers are gone, so that nothing else
    # runs on the host (a worker's result arriving takes the GIL).
    for name, (figures, last_quorum) in arms.items():
        figures["kernels"] = kernel_call_us(dev, last_quorum)
    arms = {name: figures for name, (figures, _) in arms.items()}
    launches = {k: sum(a["cuda"]["launches"][k] for a in arms.values())
                for k in WRAPPERS}
    if dev.type == "cuda":
        missing = [k for k in CLUSTER_KERNELS if not launches[k]]
        _require(not missing, f"EPaxos traffic never launched {missing}")
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "f": F, "replicas": 2 * F + 1, "pairs": CLIENTS * PSEUDONYMS,
        "commands": commands, "seed": seed, "arms": arms,
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
