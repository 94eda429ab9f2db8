"""A reconfigured MultiPaxos cluster with WALs, over SimTransport.

The reference's acceptance scenario for live reconfiguration
(``tests/protocols/test_protocol_reconfig.py``,
``test_multipaxos_reconfigure_out_and_replace``), followed by a failover
that must discover the new epoch from the Phase1bs. Run::

    python -m frankenpaxos_tpu_torch.bench.reconfig_sim [--device cpu]

It prints ONE JSON line. The cluster is the harness's ``f = 1`` (one
group of 3 acceptors, 2 leaders, 2 proxy leaders, 2 replicas, an
AppendLog state machine, one client), every acceptor and replica on a
FileStorage WAL under a fresh temporary directory (real fsyncs, one
per drain of each durable role), the ProxyLeaders' main vote board at
the role's own window (2^20) and the epoch board at 2^14. The writes,
one at a time, each delivered until it is answered:

  1. ``WRITES[0]`` writes;
  2. a replacement acceptor is built, acceptor 2 crashes, and the
     leader gets ``Reconfigure`` (epoch 1: acceptors 0, 1 and the
     replacement);
  3. ``WRITES[1]`` writes (the replicas' watermark then passes epoch 1's
     first slot, which retires epoch 0);
  4. acceptor 1 crashes: a quorum of epoch 1 now needs the replacement;
  5. ``WRITES[2]`` writes;
  6. leader 1 forgets every epoch but 0 and takes over: its Phase 1 must
     discover epoch 1 from the Phase1bs;
  7. ``WRITES[3]`` writes through the new leader.

Arms (``ARMS``), each on a fresh cluster with ``quorum_backend="cuda"``
and ``phase1_backend="cuda"``: the synchronous tracker; the pipelined
one (its flush timer fired with the resend timers); and
``epoch_quorums`` with ``epoch_tag_runs``, the epoch tracker engaged
from construction. The ProxyLeaders count a reconfigured cluster's
votes on K6 (one staged call per drain once the epoch tracker is
engaged) and reshape the epoch board on K7 when epoch 1 is noted. A
``quorum_backend="dict"`` run of the same seed is the reference the
arms' logs are held to.

Gates (a failed gate raises ``GateFailure``): every write is answered
once, each payload executes exactly once, both replicas' executed logs
are equal, every leader ends knowing epochs 0 and 1, the logs of the arms
in ``LOGS_AS_DICT`` equal the dict run's entry for entry, no collector
error, and on a card K6 and K7 each launch in every arm.
Figures per arm: writes/s on the host clock, the launches, the epoch
tracker's staged K6 calls and their host microseconds per drain, and
the fsyncs and their milliseconds per sync (each sync is one drain of
one durable role).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
import types

import torch

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ops import quorum as tq
from frankenpaxos_tpu_torch.protocols.multipaxos import harness
from frankenpaxos_tpu_torch.reconfig import EpochStore, Reconfigure

#: Writes before the reconfiguration, after it, after the second crash
#: and after the failover.
WRITES = (5, 20, 5, 5)
#: The timers a drive fires when delivery goes quiet.
DRIVE_TIMERS = ("recover", "resendWrite", "resendClientRequest",
                "resendEpochCommit", "resendEpochSync", "resendPhase1as",
                "tpuDrainFlush")
ARMS = {
    "sync": {},
    "pipelined": dict(tpu_pipelined=True),
    "epoch_quorums": dict(epoch_quorums=True, epoch_tag_runs=True),
}
#: The arms whose logs equal the dict run's entry for entry. The
#: pipelined tracker answers a drain later, so the client's resends, and
#: with them the duplicate slots of a retried write, fall elsewhere; its
#: arm is held to the gates of ``check`` alone.
LOGS_AS_DICT = ("sync", "epoch_quorums")
#: The kernels the reconfigured cluster runs: K6 and K7.
PATH_KERNELS = ("record_and_check_epochs", "reshape_columns")
REPLACEMENT = "acceptor-0-replacement"


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
        add_replacement_acceptor=harness.add_replacement_acceptor,
        executed_prefix=harness.executed_prefix,
        Reconfigure=Reconfigure, EpochStore=EpochStore)


def drive(sim, done, max_waves: int = 120) -> None:
    """Deliver in coalesced waves, firing the liveness timers
    (``DRIVE_TIMERS``) whenever delivery goes quiet, until ``done()``."""
    for _ in range(max_waves):
        sim.transport.deliver_all_coalesced(max_steps=500)
        if done():
            return
        for timer in sim.transport.running_timers():
            if timer.name.startswith(DRIVE_TIMERS):
                sim.transport.trigger_timer(timer.id)
    raise GateFailure("the cluster did not settle")


class Writer:
    """Client 0's writes, one at a time, each driven until answered."""

    def __init__(self, sim):
        self.sim = sim
        self.results: list = []
        self.n = 0

    def write(self, count: int) -> None:
        client = self.sim.clients[0]
        for _ in range(count):
            payload = b"w%d" % self.n
            self.n += 1
            client.write(0, payload, self.results.append)
            want = self.n
            drive(self.sim, lambda: (len(self.results) >= want
                                     and not client.states))


def _norm(value):
    """A log entry of either package as plain tuples."""
    if type(value).__name__ == "Noop":
        return None
    return tuple((c.command_id.client_address, c.command_id.client_pseudonym,
                  c.command_id.client_id, c.command)
                 for c in value.commands)


def _timed_syncs(storages: dict, totals: dict) -> None:
    """Time every storage's ``sync`` (the fsync of a drain's group
    commit) from now on into ``totals``."""
    def timed(inner):
        def sync(name):
            t0 = time.perf_counter()
            inner(name)
            totals["seconds"] += time.perf_counter() - t0
            totals["syncs"] += 1
        return sync

    for storage in storages.values():
        if not getattr(storage, "_timed", False):
            storage.sync = timed(storage.sync)
            storage._timed = True


def scenario(pkg=None, writes=WRITES, seed: int = 0, time_syncs=False,
             **harness_kwargs) -> dict:
    """Run the scenario on ``pkg``'s harness (the port's by default)
    with ``harness_kwargs``; returns the cluster and what it did."""
    pkg = pkg or port_package()
    sim = pkg.make_multipaxos(f=1, num_clients=1, seed=seed, **harness_kwargs)
    syncs = {"syncs": 0, "seconds": 0.0} if time_syncs else None
    if time_syncs:
        _timed_syncs(sim.wal_storages, syncs)
    w = Writer(sim)
    t0 = time.perf_counter()
    w.write(writes[0])
    group = list(sim.config.acceptor_addresses[0])
    members = tuple(group[:2] + [REPLACEMENT])
    pkg.add_replacement_acceptor(sim, members, REPLACEMENT)
    if time_syncs:
        _timed_syncs(sim.wal_storages, syncs)
    sim.transport.crash(group[2])
    sim.leaders[0].receive("admin", pkg.Reconfigure(members=members))
    w.write(writes[1])
    sim.transport.crash(group[1])
    w.write(writes[2])
    # The failover: leader 1 keeps epoch 0 only, so its Phase 1 must
    # discover epoch 1 from the Phase1bs of the live acceptors.
    sim.leaders[1].epochs = pkg.EpochStore.from_members(tuple(group), f=1)
    for i, leader in enumerate(sim.leaders):
        leader.leader_change(is_new_leader=(i == 1))
    w.write(writes[3])
    seconds = time.perf_counter() - t0
    return {"sim": sim, "results": w.results, "writes": w.n,
            "seconds": seconds, "syncs": syncs,
            "logs": [[_norm(v) for v in pkg.executed_prefix(r)]
                     for r in sim.replicas],
            "executed": [list(r.state_machine.get()) for r in sim.replicas],
            "epochs": [[(c.epoch, c.start_slot, c.f, tuple(c.members))
                        for c in leader.epochs.known()]
                       for leader in sim.leaders]}


def check(run: dict) -> None:
    """The scenario's gates on one run."""
    n = run["writes"]
    _require(len(run["results"]) == n,
             f"{len(run['results'])} of {n} writes answered")
    payloads = sorted(b"w%d" % i for i in range(n))
    for i, executed in enumerate(run["executed"]):
        _require(sorted(executed) == payloads,
                 f"replica {i} did not execute every write exactly once")
    _require(run["logs"][0] == run["logs"][1],
             "the replicas' executed logs differ")
    for i, epochs in enumerate(run["epochs"]):
        _require([e[0] for e in epochs] == [0, 1],
                 f"leader {i} knows epochs {[e[0] for e in epochs]}")
        _require(REPLACEMENT in epochs[-1][3],
                 f"leader {i}'s epoch 1 lacks the replacement")


def launches() -> dict:
    return {name: getattr(tq, name).launches for name in PATH_KERNELS}


def _arm_figures(run: dict, before: dict) -> dict:
    sim = run["sim"]
    trackers = [p._epoch_tracker for p in sim.proxy_leaders
                if p._epoch_tracker is not None]
    calls = sum(t.drain_calls for t in trackers)
    syncs = run["syncs"]
    return {
        "writes": run["writes"],
        "seconds": run["seconds"],
        "writes_per_sec": run["writes"] / run["seconds"],
        "launches": {k: v - before[k] for k, v in launches().items()},
        "epoch_tracker_drains": calls,
        "epoch_drain_host_us": (sum(t.drain_seconds for t in trackers)
                                / calls * 1e6 if calls else None),
        "fsyncs": syncs["syncs"],
        "fsync_ms_per_sync": (syncs["seconds"] / syncs["syncs"] * 1e3
                              if syncs["syncs"] else None),
        "collector_errors": sum(len(p.collector_errors)
                                for p in sim.proxy_leaders),
    }


def run(device=None, writes=WRITES, seed: int = 0,
        tpu_window: int = 1 << 20) -> dict:
    """The dict reference run and the three arms on ``device`` (the card
    when None), each over FileStorage WALs in a fresh temporary
    directory that is removed afterwards."""
    dev = resolve_device(device)
    runs: dict = {}
    arms: dict = {}
    backends = {"dict": dict(quorum_backend="dict", phase1_backend="host")}
    backends.update({arm: dict(quorum_backend="cuda", phase1_backend="cuda",
                               device=dev, **options)
                     for arm, options in ARMS.items()})
    for arm, kwargs in backends.items():
        root = tempfile.mkdtemp(prefix="fpx-wal-")
        try:
            before = launches()
            runs[arm] = scenario(writes=writes, seed=seed, time_syncs=True,
                                 wal=root, tpu_window=tpu_window, **kwargs)
            check(runs[arm])
            arms[arm] = _arm_figures(runs[arm], before)
            for proxy in runs[arm]["sim"].proxy_leaders:
                proxy.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
    for arm in LOGS_AS_DICT:
        _require(runs[arm]["logs"] == runs["dict"]["logs"],
                 f"{arm}: the replicas' logs differ from the dict run's")
    for arm in ARMS:
        _require(arms[arm]["collector_errors"] == 0,
                 f"{arm}: the collector logged errors")
        if dev.type == "cuda":
            missing = [k for k in PATH_KERNELS if not arms[arm]["launches"][k]]
            _require(not missing, f"{arm}: never launched {missing}")
    return {
        "benchmark": "reconfig_sim",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "writes": sum(writes), "seed": seed, "tpu_window": tpu_window,
        "epoch_window": min(tpu_window, 1 << 14),
        "wal": "FileStorage under a temporary directory",
        "arms": arms,
        "logs_equal_the_dict_run": list(LOGS_AS_DICT),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, seed=args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
