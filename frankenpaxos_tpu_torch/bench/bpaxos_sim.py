"""SimpleBPaxos and SimpleGcBPaxos as clusters of actors over
SimTransport, on one GPU.

The watermark plane of the port end to end: the reference harness's own
layout at ``f = 1`` (2 leaders, 2 proposers, 3 dep-service nodes, 3
acceptors, 2 replicas; 3 replicas and 3 garbage collectors in the GC
arm), a ``KeyValueStore``, top-1 dependencies and the Tarjan graph,
built by ``protocols/simplebpaxos/harness.py``. Run::

    python -m frankenpaxos_tpu_torch.bench.bpaxos_sim [--device cpu]

It prints ONE JSON line. Three arms, each on a fresh cluster, each run
twice on one seed: on the host backends and on the cuda backends, where
every Leader unions its dep-service quorum's replies by K10
(``dep_backend="cuda"``) and, in the GC arm, every proposer, acceptor
and dep-service node folds each ``GarbageCollect`` into its quorum
watermark by K12 (``gc_backend="cuda"``):

  * ``simple-conflict2`` and ``simple-conflict25``: SimpleBPaxos, 64
    closed-loop ``(client, pseudonym)`` pairs (8 clients of 8
    pseudonyms) propose ``SetRequest`` writes until every command is
    answered; 2% and 25% of them write one hot key, the rest a key of
    their own (the EPaxos paper's, SOSP'13 section 7, mixes, as in
    ``epaxos_sim``);
  * ``gc``: SimpleGcBPaxos on the conflict2 mix, ``send_gc_every_n =
    10`` (the reference's default) and ``snapshot_every_n = 64``, in
    waves of 64 commands, one per ``(client, pseudonym)`` pair. Replica
    2 is partitioned for the first half of the commands, then healed;
    after each later wave its recover timers fire, so it catches up
    through a peer's ``CommitSnapshot`` (the shape of the reference's
    ``test_far_behind_replica_catches_up_via_commit_snapshot``, at full
    size). A closed loop alone cannot drive this arm: while replica 2 is
    cut off, nobody answers the third of the vertices whose reply it
    owes, so a pair whose command it owes is replaced by a fresh
    pseudonym of the same client.

Gates (a failed gate raises ``GateFailure``):

  1. every command is answered at most once, with its ``KeyValueStore``
     result; in the simple arms every command is answered and every
     replica executed each command once. In ``gc`` the unanswered
     commands are exactly those whose reply the laggard owed and whose
     vertex the snapshot it adopted covers: the reference answers a
     duplicate request with nothing, so no one else answers them;
  2. the replicas' state machines are equal (in ``gc`` the laggard's
     too, and it holds a snapshot), and in the simple arms so are their
     committed ``vertex -> (command, deps)`` maps;
  3. the cuda run's committed maps, replies and unanswered commands
     equal the host run's; in ``gc`` also every GC role's
     ``gc_watermark`` and its set of unpruned vertices;
  4. on a CUDA device, K10 (``union_reduce``) and K12
     (``quorum_watermark``) each launched on the cuda runs' traffic.

Figures per arm and backend: committed commands/s on the host clock (the
actors are Python), the Leaders' device batches and span fall-backs
(``depset_batch``, ``depset_span_fallback``), the kernels' launches on
the traffic, and in ``gc`` the ``GarbageCollect`` messages, snapshots
taken and adopted, and the per-vertex states the GC roles pruned. The
host runs launch no kernel; on a CUDA device they go to worker
processes beside the cuda runs, which stay in the calling process
(where the launch counts are read).
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
from frankenpaxos_tpu_torch.ops import depset, watermark
from frankenpaxos_tpu_torch.protocols.simplebpaxos.harness import (
    committed,
    gc_roles,
    make_bpaxos,
    make_gc_bpaxos,
    unpruned,
)
from frankenpaxos_tpu_torch.protocols.simplegcbpaxos import GarbageCollector
from frankenpaxos_tpu_torch.runtime import PickleSerializer
from frankenpaxos_tpu_torch.statemachine import KeyValueStore, SetRequest
import torch

#: The kernel wrappers the cluster reaches, by name.
WRAPPERS = {
    "union_reduce": depset.union_reduce,
    "quorum_watermark": watermark.quorum_watermark,
}
#: The kernels the cluster's traffic must launch (on a CUDA device).
CLUSTER_KERNELS = ("union_reduce", "quorum_watermark")

F = 1
CLIENTS = 8
PSEUDONYMS = 8
COMMANDS = 1 << 14
HOT_KEY = "hot"
#: Arm name -> share of commands that write the hot key.
ARMS = {"simple-conflict2": 0.02, "simple-conflict25": 0.25, "gc": 0.02}
GC_ARM = "gc"
SEND_GC_EVERY_N = 10
SNAPSHOT_EVERY_N = 64
GC_REPLICAS = 3
LAGGARD = 2
#: Commands in flight per wave of the GC arm.
WAVE = CLIENTS * PSEUDONYMS
#: Rounds of the laggard's recover timers after the last wave.
MAX_CATCH_UP_ROUNDS = 4096

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


class Executions:
    """Per replica, the commands its state machine ran: ``(client,
    pseudonym, id) -> vertex``, through each replica's ``_execute``."""

    def __init__(self, replicas):
        self.ran = [dict() for _ in replicas]
        for index, replica in enumerate(replicas):
            replica._execute = self._spy(replica, replica._execute,
                                         self.ran[index])

    @staticmethod
    def _spy(replica, execute, ran: dict):
        def spy(vertex_id, value):
            before = replica.executed_count
            execute(vertex_id, value)
            if replica.executed_count > before:
                ran[(value.client_address, value.client_pseudonym,
                     value.client_id)] = vertex_id

        return spy


class GcCounts:
    """``GarbageCollect`` relays, and per-vertex states the GC roles
    pruned (through each role's ``_prune``)."""

    def __init__(self, transport):
        self.garbage_collects = 0
        self.pruned = 0
        for actor in transport.actors.values():
            if isinstance(actor, GarbageCollector):
                actor.receive = self._count_relay(actor.receive)
        for role in gc_roles(transport):
            role._prune = self._count_prune(role, role._prune)

    def _count_relay(self, receive):
        def spy(src, message):
            self.garbage_collects += 1
            return receive(src, message)

        return spy

    def _count_prune(self, role, prune):
        def spy():
            before = len(unpruned(role))
            prune()
            self.pruned += before - len(unpruned(role))

        return spy


def _result(writes: list, i: int) -> bytes:
    return KeyValueStore().run(SER.to_bytes(SetRequest((writes[i],))))


def drive_simple(device, backend: str, writes: list, seed: int) -> dict:
    """One SimpleBPaxos cluster on ``writes``, closed loop."""
    transport, _, replicas, clients = make_bpaxos(
        f=F, num_clients=CLIENTS, seed=seed, dep_backend=backend,
        device=device)
    transport.record_history = False
    counts = DepsetCounts()
    transport.runtime_metrics = counts
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
        "figures": _figures(replies, seconds, counts, before, after),
        "replies": replies, "duplicates": duplicates,
        "committed": [committed(r) for r in replicas],
        "states": [r.state_machine.get() for r in replicas],
        "executed": [r.executed_count for r in replicas],
    }


def _figures(replies, seconds, counts, before, after) -> dict:
    return {"commands": len(replies), "seconds": seconds,
            "commands_per_sec": len(replies) / seconds,
            "depset_batch_calls": counts.calls,
            "depset_batch_rows": counts.rows,
            "depset_span_fallbacks": counts.span_fallbacks,
            "launches": {k: after[k] - before[k] for k in after}}


def _fire_laggard_timers(transport) -> int:
    laggard = f"replica-{LAGGARD}"
    timers = [t for t in transport.running_timers()
              if t.address == laggard and t.name.startswith("recoverVertex")]
    for timer in timers:
        transport.trigger_timer(timer.id)
    return len(timers)


def drive_gc(device, backend: str, writes: list, seed: int) -> dict:
    """One SimpleGcBPaxos cluster on ``writes``, in waves of ``WAVE``
    commands, with the laggard cut off for the first half."""
    transport, _, _, _, replicas, clients = make_gc_bpaxos(
        f=F, send_gc_every_n=SEND_GC_EVERY_N, seed=seed,
        num_replicas=GC_REPLICAS, snapshot_every_n=SNAPSHOT_EVERY_N,
        dep_backend=backend, gc_backend=backend, device=device,
        num_clients=CLIENTS)
    transport.record_history = False
    counts = DepsetCounts()
    transport.runtime_metrics = counts
    ran = Executions(replicas)
    gc = GcCounts(transport)
    laggard = replicas[LAGGARD]
    replies: dict = {}
    duplicates: list = []
    identity = {}

    def deliver() -> None:
        while transport.messages:
            transport.deliver_all(1 << 30)

    before = _launches()
    t0 = time.perf_counter()
    # Each client's free pseudonyms: one returns when its command is
    # answered; one whose reply the laggard owes stays pending, and a
    # fresh pseudonym takes its place.
    free = [list(range(PSEUDONYMS)) for _ in clients]
    fresh = [PSEUDONYMS] * len(clients)
    transport.partition(laggard.address)
    heal_at = len(writes) // 2
    for start in range(0, len(writes), WAVE):
        if start == heal_at:
            transport.heal(laggard.address)
        for i in range(start, min(start + WAVE, len(writes))):
            c = i % CLIENTS
            if free[c]:
                p = free[c].pop()
            else:
                p, fresh[c] = fresh[c], fresh[c] + 1
            identity[(clients[c].address, p, clients[c].ids.get(p, 0))] = i

            def done(result: bytes, i=i, c=c, p=p) -> None:
                if i in replies:
                    duplicates.append(i)
                replies[i] = result
                free[c].append(p)

            clients[c].propose(p, SER.to_bytes(SetRequest((writes[i],))),
                               done)
        deliver()
        if start >= heal_at:
            _fire_laggard_timers(transport)
            deliver()
    rounds = 0
    while laggard.dependency_graph.num_vertices \
            and rounds < MAX_CATCH_UP_ROUNDS \
            and _fire_laggard_timers(transport):
        rounds += 1
        deliver()
    seconds = time.perf_counter() - t0
    after = _launches()
    figures = _figures(replies, seconds, counts, before, after)
    figures.update(
        garbage_collects=gc.garbage_collects, pruned_states=gc.pruned,
        snapshots_taken=sum(r.snapshot.id + 1 for r in replicas[:LAGGARD]
                            if r.snapshot is not None),
        laggard_snapshot_id=(laggard.snapshot.id
                             if laggard.snapshot is not None else None),
        catch_up_rounds=rounds,
        unanswered=len(writes) - len(replies))
    owed_lost = sorted(
        identity[key] for key, vertex in ran.ran[0].items()
        if vertex.instance_number % GC_REPLICAS == LAGGARD
        and key not in ran.ran[LAGGARD])
    return {
        "figures": figures, "replies": replies, "duplicates": duplicates,
        "states": [r.state_machine.get() for r in replicas],
        "committed": [committed(r) for r in replicas],
        "executed_everywhere": len(ran.ran[0]),
        "owed_lost": owed_lost,
        "laggard_snapshot": laggard.snapshot is not None,
        "laggard_blocked": laggard.dependency_graph.num_vertices,
        "gc_watermarks": [r.gc_watermark for r in gc_roles(transport)],
        "unpruned": [unpruned(r) for r in gc_roles(transport)],
    }


def _check(run: dict, writes: list, what: str, gc: bool) -> None:
    """Gates 1 and 2 on one run."""
    _require(not run["duplicates"],
             f"{what}: {len(run['duplicates'])} commands answered twice")
    wrong = [i for i, result in run["replies"].items()
             if result != _result(writes, i)]
    _require(not wrong, f"{what}: {len(wrong)} replies differ from the "
                        f"KeyValueStore's result")
    states = run["states"]
    _require(all(s == states[0] for s in states[1:]),
             f"{what}: the replicas' state machines differ")
    hot = [value for key, value in writes if key == HOT_KEY]
    _require(not hot or states[0][HOT_KEY] in hot,
             f"{what}: the hot key holds a value no command wrote")
    if not gc:
        _require(len(run["replies"]) == len(writes),
                 f"{what}: {len(run['replies'])} of {len(writes)} commands "
                 f"answered")
        _require(all(n == len(writes) for n in run["executed"]),
                 f"{what}: replicas executed {run['executed']} commands, "
                 f"not {len(writes)} each")
        logs = run["committed"]
        _require(all(log == logs[0] for log in logs[1:]),
                 f"{what}: the replicas' committed vertices differ")
        return
    _require(run["executed_everywhere"] == len(writes),
             f"{what}: replica 0 ran {run['executed_everywhere']} of "
             f"{len(writes)} commands")
    unanswered = sorted(set(range(len(writes))) - set(run["replies"]))
    _require(unanswered == run["owed_lost"],
             f"{what}: {len(unanswered)} commands unanswered, but the "
             f"laggard skipped the replies of {len(run['owed_lost'])}")
    _require(run["laggard_snapshot"] and not run["laggard_blocked"],
             f"{what}: the laggard did not catch up through a snapshot "
             f"({run['laggard_blocked']} vertices still blocked)")


def host_run(conflict: float, commands: int, seed: int, name: str) -> dict:
    """The host backends' run of one arm, with gates 1 and 2; returns
    what gate 3 compares."""
    writes = workload(conflict, commands, seed)
    gc = name == GC_ARM
    host = (drive_gc if gc else drive_simple)(torch.device("cpu"), "host",
                                              writes, seed)
    _check(host, writes, f"{name}/host", gc)
    _require(host["figures"]["depset_batch_calls"] == 0,
             f"{name}: the host backend reached the device path")
    return {k: v for k, v in host.items() if k != "duplicates"}


_COMPARED = ("committed", "replies", "states", "gc_watermarks", "unpruned")


def arm(dev, conflict: float, commands: int, seed: int, name: str,
        host) -> dict:
    """The cuda backends on one workload beside the host run (a dict, or
    a future that yields it); gates 1-3."""
    writes = workload(conflict, commands, seed)
    gc = name == GC_ARM
    cuda = (drive_gc if gc else drive_simple)(dev, "cuda", writes, seed)
    _check(cuda, writes, f"{name}/cuda", gc)
    host = host.result() if hasattr(host, "result") else host
    for key in _COMPARED:
        _require(cuda.get(key) == host.get(key),
                 f"{name}: the cuda run's {key} differ from the host run's")
    return {"conflict": conflict,
            "hot_writes": sum(key == HOT_KEY for key, _ in writes),
            "host": host["figures"], "cuda": cuda["figures"]}


def run(device=None, commands: int = COMMANDS, seed: int = 0) -> dict:
    """Every arm on ``device`` (``cuda`` when None); raises
    ``GateFailure`` on a failed gate. On a CUDA device the host runs go
    to one worker process per arm, beside the cuda runs, and each kernel
    of ``CLUSTER_KERNELS`` must have launched on the cuda runs' traffic;
    on the CPU every run stays in this process."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        spawn = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(len(ARMS), mp_context=spawn) as pool:
            hosts = {name: pool.submit(host_run, conflict, commands, seed,
                                       name)
                     for name, conflict in ARMS.items()}
            arms = {name: arm(dev, conflict, commands, seed, name,
                              hosts[name])
                    for name, conflict in ARMS.items()}
    else:
        arms = {name: arm(dev, conflict, commands, seed, name,
                          host_run(conflict, commands, seed, name))
                for name, conflict in ARMS.items()}
    launches = {k: sum(a["cuda"]["launches"][k] for a in arms.values())
                for k in WRAPPERS}
    if dev.type == "cuda":
        missing = [k for k in CLUSTER_KERNELS if not launches[k]]
        _require(not missing, f"BPaxos traffic never launched {missing}")
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "f": F, "pairs": CLIENTS * PSEUDONYMS, "commands": commands,
        "seed": seed, "send_gc_every_n": SEND_GC_EVERY_N,
        "snapshot_every_n": SNAPSHOT_EVERY_N, "arms": arms,
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
