"""WPaxos over the geo simulator, on one GPU: zone-local commits, steal
latency, and the geo layer's cost (the twin of
``frankenpaxos_tpu/bench/geo_lt.py``).

The reference's deployment at its sizes: 3 regions of one zone each,
3-acceptor rows (``ZoneGrid``), 6 object groups, one client per zone,
``--writes 40`` per arm, the flat arm 300 commands x 5 reps. Run::

    python -m frankenpaxos_tpu_torch.bench.geo_lt [--device cpu]

It prints ONE JSON line. Every arm runs twice on one seed: on the
leaders' ``"dict"`` quorum backend and on ``"cuda"``, where each leader
counts its drains' Phase2b votes by K6 (``record_and_check_epochs``) and
releases chosen columns by K5 (``release``) through
``geo.GeoQuorumTracker``, with the transport's link mask pointed at K18
(``simwave.LINK_KEEP_MASK = link_keep_mask_cuda``). Arms:

  * ``home_zone``: per-zone clients drive objects homed in their zone;
  * ``static_single_leader``: every group homed in zone 0 and never
    stolen -- remote zones pay the WAN per commit;
  * ``steal``: traffic migrates from zone 0 to zone 1, which steals the
    object's group;
  * ``hot_objects``: Zipf-skewed keys from zone 1, its hot groups
    stolen to zone 1;
  * ``flat``: every link at 0 s; the same protocol over
    ``GeoSimTransport`` vs plain ``SimTransport`` vs the port's
    MultiPaxos, alternated in chunks of 25 writes with GC off, on the
    host clock.

The reference's ``zone_outage`` arm restarts a zone from its WALs; the
WAL is not ported (ROADMAP.md queue 1 item 4), so it is not run.

Gates (a failed gate raises ``GateFailure``): the reference's four
(home-zone p50 below 0.25 x the WAN RTT, steal latency at most 3 x the
WAN RTT, flat geo/multipaxos ratio at least 0.8, flat geo/plain ratio at
least 0.6) on the dict run, which is the reference's configuration; on
the cuda run the two latency gates (the flat ratios there weigh the
device quorum path's per-drain host cost against MultiPaxos's, a
comparison the reference never gated, and are recorded); and exactness
across backends: virtual time is deterministic per seed, so the cuda
run's virtual latencies, acks and replicas' ``group_sequences()`` must
EQUAL the dict run's (the flat arm's acks and sequences too). Recorded
per backend: K5, K6, K7
and K18 launches on the run's traffic (on a CUDA device), and the
delivery waves' size histogram (K18 runs only on waves of at least
``WAVE_VECTOR_MIN`` frames: with this topology's jitter each frame
lands at its own instant, and ``settle`` delivers one frame at a time).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import random
import statistics
import sys
import time

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.geo import (
    GeoQuorumTracker,
    GeoTopology,
    ObjectEpochStore,
)
from frankenpaxos_tpu_torch.ops import quorum as tq, simwave
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
from frankenpaxos_tpu_torch.protocols.wpaxos.harness import (
    make_wpaxos,
    settle,
)
from frankenpaxos_tpu_torch.protocols.wpaxos.messages import Steal
import torch

WRITES = 40
FLAT_COMMANDS = 300
FLAT_REPS = 5
FLAT_CHUNK = 25
BACKENDS = ("dict", "cuda")
#: The kernels of this path and the wrappers that count their launches.
WRAPPERS = {
    "release": tq.release,
    "record_and_check_epochs": tq.record_and_check_epochs,
    "reshape_columns": tq.reshape_columns,
    "link_keep_mask": simwave.link_keep_mask_tensor,
}
#: The kernels that must launch on a cuda run's traffic (K18 is counted
#: but not required here: see the module docstring).
PATH_KERNELS = ("release", "record_and_check_epochs")


class GateFailure(AssertionError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def watch_waves(transport) -> collections.Counter:
    """Count the transport's delivery waves by size bucket (the power of
    two at or below the size) from now on; the counter is returned and
    filled in place."""
    hist: collections.Counter = collections.Counter()
    inner = transport._wave_keep_mask

    def counted(wave):
        hist[1 << (len(wave).bit_length() - 1)] += 1
        return inner(wave)

    transport._wave_keep_mask = counted
    return hist


def wave_figures(hist: collections.Counter) -> dict:
    return {"wave_size_histogram": {str(k): hist[k] for k in sorted(hist)},
            "waves": sum(hist.values()),
            "waves_at_least_vector_min": sum(
                n for k, n in hist.items()
                if k >= simwave.WAVE_VECTOR_MIN)}


@contextlib.contextmanager
def link_mask(backend: str, device):
    """The transport's link mask for one run: K18 on ``device`` for the
    cuda backend, the reference's numpy kernel for dict."""
    saved = simwave.LINK_KEEP_MASK
    if backend == "cuda":
        simwave.LINK_KEEP_MASK = functools.partial(
            simwave.link_keep_mask_cuda, device=device)
    else:
        simwave.LINK_KEEP_MASK = simwave.link_keep_mask
    try:
        yield
    finally:
        simwave.LINK_KEEP_MASK = saved


def _topology(seed: int = 0, flat: bool = False) -> GeoTopology:
    if flat:
        return GeoTopology({"r0": ["zone-0"], "r1": ["zone-1"],
                            "r2": ["zone-2"]},
                           intra_zone_s=0.0, intra_region_s=0.0,
                           cross_region_s=0.0, jitter=0.0, seed=seed)
    return GeoTopology({"r0": ["zone-0"], "r1": ["zone-1"],
                        "r2": ["zone-2"]}, seed=seed)


@dataclasses.dataclass
class Run:
    """One arm on one backend: the cluster, the wave counter and the
    ack results in order."""

    backend: str
    device: object
    sim: object = None
    waves: collections.Counter = None
    acks: list = dataclasses.field(default_factory=list)

    def make(self, topology=None, num_groups: int = 6,
             num_clients: int = 3, initial_home=None, seed: int = 0):
        sim = make_wpaxos(num_zones=3, row_width=3, num_groups=num_groups,
                          num_clients=num_clients, topology=topology,
                          seed=seed, quorum_backend=self.backend,
                          device=self.device)
        if initial_home is not None:
            config = dataclasses.replace(sim.config,
                                         initial_home=tuple(initial_home))
            for actor in (sim.leaders + sim.acceptors + sim.replicas
                          + sim.clients):
                actor.config = config
            for leader in sim.leaders:
                leader.epochs = ObjectEpochStore(config.num_groups,
                                                 config.initial_home)
                leader.trackers = [
                    GeoQuorumTracker(leader.epochs, g, leader.grid,
                                     backend=self.backend,
                                     device=self.device)
                    for g in range(config.num_groups)]
            for acceptor in sim.acceptors:
                acceptor.epochs = ObjectEpochStore(config.num_groups,
                                                   config.initial_home)
            for client in sim.clients:
                client.routing = {g: (home, home) for g, home
                                  in enumerate(config.initial_home)}
            sim.config = config
        self.sim = sim
        self.waves = watch_waves(sim.transport)
        return sim

    def write(self, client: int, key: bytes, payload: bytes) -> float:
        """One closed-loop write, settled on virtual time; returns the
        virtual commit latency."""
        done: list = []
        self.sim.clients[client].write(0, payload, done.append, key=key)
        settle(self.sim, lambda: bool(done), max_waves=400)
        self.acks.extend(done)
        return self.sim.clients[client].latencies[-1][2]

    def exact(self) -> dict:
        """What must be equal across backends."""
        return {"acks": self.acks,
                "latencies": [c.latencies for c in self.sim.clients],
                "sequences": [r.group_sequences()
                              for r in self.sim.replicas]}


def _keys_for_zone(config, zone: int, n: int) -> list:
    keys, i = [], 0
    while len(keys) < n:
        key = b"obj-%d" % i
        group = config.group_of_key(key)
        if config.initial_home[group] == zone:
            keys.append(key)
        i += 1
    return keys


def _percentiles(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {}
    pick = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return {"p50": pick(0.5), "p90": pick(0.9), "p99": pick(0.99),
            "mean": statistics.fmean(xs), "n": len(xs)}


def home_zone_arm(run: Run, writes: int, seed: int = 0) -> dict:
    """Per-zone clients drive objects homed in their own zone."""
    topo = _topology(seed)
    sim = run.make(topology=topo, seed=seed)
    per_zone = {}
    counter = 0
    for zone in range(3):
        key = _keys_for_zone(sim.config, zone, 1)[0]
        lats = []
        for n in range(writes):
            lat = run.write(zone, key, b"hz-%d" % counter)
            counter += 1
            if n > 0:  # first write pays the bootstrap steal
                lats.append(lat)
        per_zone[f"zone-{zone}"] = _percentiles(lats)
    p50s = [v["p50"] for v in per_zone.values()]
    return {"arm": "wpaxos_home_zone", "per_zone": per_zone,
            "wan_rtt_s": topo.wan_rtt(),
            "home_p50_s": max(p50s),
            "home_p50_over_wan_rtt": max(p50s) / topo.wan_rtt()}


def static_single_leader_arm(run: Run, writes: int, seed: int = 0) -> dict:
    """The baseline: every group homed in zone 0 and never stolen --
    remote zones pay the WAN for every commit."""
    topo = _topology(seed)
    run.make(topology=topo, initial_home=[0] * 6, seed=seed)
    per_zone = {}
    counter = 0
    for zone in range(3):
        lats = []
        for n in range(writes):
            lat = run.write(zone, b"obj-0", b"sl-%d" % counter)
            counter += 1
            if n > 0:
                lats.append(lat)
        per_zone[f"zone-{zone}"] = _percentiles(lats)
    remote = [per_zone["zone-1"]["p50"], per_zone["zone-2"]["p50"]]
    return {"arm": "static_single_leader", "per_zone": per_zone,
            "wan_rtt_s": topo.wan_rtt(),
            "remote_p50_s": min(remote),
            "remote_p50_over_wan_rtt": min(remote) / topo.wan_rtt()}


def steal_arm(run: Run, writes: int, seed: int = 0) -> dict:
    """Traffic migrates from the home zone to a remote zone; the remote
    zone steals the object group."""
    topo = _topology(seed)
    sim = run.make(topology=topo, seed=seed)
    key = _keys_for_zone(sim.config, 0, 1)[0]
    group = sim.config.group_of_key(key)
    counter = 0
    for _ in range(max(2, writes // 2)):  # steady home traffic
        run.write(0, key, b"st-%d" % counter)
        counter += 1
    # Traffic migrates: zone 1 now drives the object, paying WAN.
    before = [run.write(1, key, b"st-%d" % (counter + i))
              for i in range(max(2, writes // 2))]
    counter += max(2, writes // 2)
    thief = sim.leaders[1]
    n_events = len(thief.steal_events)
    thief.receive("bench-admin", Steal(group))
    settle(sim, lambda: group in thief.active, max_waves=400)
    settle(sim, lambda: len(thief.steal_events) > n_events, max_waves=400)
    event = thief.steal_events[-1]
    after = [run.write(1, key, b"st-%d" % (counter + i))
             for i in range(writes)]
    steal_latency = event["first_commit_s"] - event["started_s"]
    return {
        "arm": "steal_migration",
        "wan_rtt_s": topo.wan_rtt(),
        "steal_latency_s": steal_latency,
        "steal_latency_over_wan_rtt": steal_latency / topo.wan_rtt(),
        "epoch_activation_s": event["active_s"] - event["started_s"],
        "pre_steal_remote": _percentiles(before),
        "post_steal_local": _percentiles(after[1:] or after),
    }


def hot_object_arm(run: Run, writes: int, seed: int = 0) -> dict:
    """Zipf-skewed keys, traffic concentrated in one remote zone; its hot
    groups are stolen to where the traffic is."""
    topo = _topology(seed)
    sim = run.make(topology=topo, num_groups=6, seed=seed)
    rng = random.Random(seed + 1)
    # Zipf-ish skew over 32 objects (rank-weighted).
    objects = [b"hot-%d" % i for i in range(32)]
    weights = [1.0 / (rank + 1) for rank in range(len(objects))]
    counter = 0

    def run_phase(n):
        nonlocal counter
        lats = []
        for _ in range(n):
            key = rng.choices(objects, weights=weights)[0]
            lats.append(run.write(1, key, b"ho-%d" % counter))
            counter += 1
        return lats

    before = run_phase(writes)
    hot_groups = {sim.config.group_of_key(key) for key in objects}
    for group in sorted(hot_groups):
        if group in sim.leaders[1].active:
            continue
        sim.leaders[1].receive("bench-admin", Steal(group))
        settle(sim, lambda g=group: g in sim.leaders[1].active,
               max_waves=400)
    after = run_phase(writes)
    return {
        "arm": "hot_objects_zipf",
        "wan_rtt_s": topo.wan_rtt(),
        "groups_rehomed": len(hot_groups),
        "before_adapt": _percentiles(before),
        "after_adapt": _percentiles(after),
        "speedup_p50": (_percentiles(before)["p50"]
                        / max(_percentiles(after)["p50"], 1e-12)),
    }


# --- the flat-topology overhead arm -----------------------------------------


class _FlatDriver:
    """One live arm of the flat A/B: a cluster with a counter, driven in
    chunks so the arms alternate inside one noise window."""

    def __init__(self, kind: str, seed: int, backend: str, device):
        self.kind = kind
        self.n = 0
        self.acks: list = []
        if kind == "multipaxos":
            self.sim = make_multipaxos(f=1, seed=seed,
                                       quorum_backend=backend,
                                       device=device)
            return
        self.topology = (_topology(seed, flat=True)
                         if kind == "geo" else None)
        self.sim = make_wpaxos(num_zones=3, row_width=3, num_groups=4,
                               topology=self.topology, seed=seed,
                               quorum_backend=backend, device=device)
        for p in range(4):  # bootstrap steals outside timed chunks
            self.sim.clients[0].write(p, b"warm%d" % p, key=b"k%d" % p)
        self._pump()

    def _pump(self) -> None:
        # Flat links put every arrival at the CURRENT instant, so
        # run_until(now) delivers in same-timestamp waves with one drain
        # per touched actor -- the same drain batching as
        # deliver_all_coalesced on the plain arm.
        if self.kind == "multipaxos":
            self.sim.transport.deliver_all()
        elif self.topology is not None:
            self.sim.transport.run_until(self.sim.transport.now,
                                         max_steps=100_000)
        else:
            self.sim.transport.deliver_all_coalesced(max_steps=100_000)

    def chunk(self, commands: int) -> float:
        """Run ``commands`` closed-loop writes; return elapsed seconds."""
        got: list = []
        t0 = time.perf_counter()
        for _ in range(commands):
            n = self.n
            self.n += 1
            if self.kind == "multipaxos":
                self.sim.clients[0].write(n % 4, b"w%d" % n, got.append)
            else:
                self.sim.clients[0].write(n % 4, b"w%d" % n, got.append,
                                          key=b"k%d" % (n % 4))
            self._pump()
        elapsed = time.perf_counter() - t0
        _require(len(got) == commands,
                 f"flat {self.kind}: {len(got)} of {commands} writes "
                 f"answered")
        self.acks.extend(got)
        return elapsed

    def exact(self):
        if self.kind == "multipaxos":
            return self.acks
        return {"acks": self.acks,
                "sequences": [r.group_sequences()
                              for r in self.sim.replicas]}


def flat_arm(backend: str, device, commands: int, reps: int,
             seed: int = 0, chunk: int = FLAT_CHUNK) -> tuple:
    """The reference's A/B discipline: all three arms' clusters ALIVE,
    alternated in small chunks with GC disabled, the ratio of summed
    per-arm times per rep, the median over fresh-cluster reps. The timed
    clusters carry no wave counter; one untimed chunk on a fresh geo
    cluster gives the arm's wave histogram."""
    ratios, mp_ratios, exact = [], [], []
    for rep in range(reps):
        drivers = {kind: _FlatDriver(kind, seed + rep, backend, device)
                   for kind in ("geo", "plain", "multipaxos")}
        totals = {kind: 0.0 for kind in drivers}
        gc.disable()
        try:
            done = 0
            while done < commands:
                n = min(chunk, commands - done)
                for kind, driver in drivers.items():
                    totals[kind] += driver.chunk(n)
                done += n
        finally:
            gc.enable()
            gc.collect()
        ratios.append(totals["plain"] / totals["geo"])
        mp_ratios.append(totals["multipaxos"] / totals["geo"])
        exact.append({kind: d.exact() for kind, d in drivers.items()})
    probe = _FlatDriver("geo", seed, backend, device)
    waves = watch_waves(probe.sim.transport)
    probe.chunk(chunk)
    return {
        "arm": "flat_topology",
        "commands_per_rep": commands,
        "chunk": chunk,
        "reps": reps,
        # > 1 means the geo layer is FASTER than plain SimTransport.
        "geo_over_plain_ratio_median": statistics.median(ratios),
        "geo_over_plain_ratios": ratios,
        "geo_over_multipaxos_ratio_median": statistics.median(mp_ratios),
        "geo_over_multipaxos_ratios": mp_ratios,
        **wave_figures(waves),
    }, exact


# --- gates + main -----------------------------------------------------------


#: The gates each backend's run must pass (the rest are recorded).
ENFORCED = {
    "dict": ("home_p50_below_quarter_wan_rtt",
             "steal_latency_within_3_wan_rtt",
             "flat_vs_multipaxos_at_noise_floor",
             "flat_geo_layer_overhead_bounded"),
    "cuda": ("home_p50_below_quarter_wan_rtt",
             "steal_latency_within_3_wan_rtt"),
}


def evaluate_gates(result: dict, backend: str) -> dict:
    home = result["home_zone"]
    steal = result["steal"]
    flat = result["flat"]
    gates = {
        "home_p50_below_quarter_wan_rtt": {
            "value": home["home_p50_over_wan_rtt"], "threshold": 0.25,
            "passed": home["home_p50_over_wan_rtt"] < 0.25},
        "steal_latency_within_3_wan_rtt": {
            "value": steal["steal_latency_over_wan_rtt"], "threshold": 3.0,
            "passed": steal["steal_latency_over_wan_rtt"] <= 3.0},
        "flat_vs_multipaxos_at_noise_floor": {
            "value": flat["geo_over_multipaxos_ratio_median"],
            "threshold": 0.8,
            "passed": flat["geo_over_multipaxos_ratio_median"] >= 0.8},
        "flat_geo_layer_overhead_bounded": {
            "value": flat["geo_over_plain_ratio_median"], "threshold": 0.6,
            "passed": flat["geo_over_plain_ratio_median"] >= 0.6},
    }
    for name, gate in gates.items():
        gate["enforced"] = name in ENFORCED[backend]
    gates["all_passed"] = all(g["passed"] for g in gates.values()
                              if g["enforced"])
    return gates


LATENCY_ARMS = {
    "home_zone": home_zone_arm,
    "static_single_leader": static_single_leader_arm,
    "steal": steal_arm,
    "hot_objects": hot_object_arm,
}


def backend_run(backend: str, device, writes: int, flat_commands: int,
                flat_reps: int, seed: int) -> tuple:
    """Every arm on one quorum backend: (figures, what must be equal
    across backends)."""
    before = launches()
    result: dict = {}
    exact: dict = {}
    waves: collections.Counter = collections.Counter()
    t0 = time.perf_counter()
    with link_mask(backend, device):
        for name, arm in LATENCY_ARMS.items():
            run = Run(backend, device)
            result[name] = arm(run, writes, seed)
            exact[name] = run.exact()
            waves.update(run.waves)
        result["flat"], exact["flat"] = flat_arm(
            backend, device, flat_commands, flat_reps, seed)
    result["seconds"] = time.perf_counter() - t0
    result["gates"] = evaluate_gates(result, backend)
    result["wpaxos_vs_static_speedup_p50"] = (
        result["static_single_leader"]["remote_p50_s"]
        / result["home_zone"]["home_p50_s"])
    result["latency_arms_waves"] = wave_figures(waves)
    after = launches()
    result["launches"] = {k: after[k] - before[k] for k in after}
    return result, exact


def run(device=None, writes: int = WRITES,
        flat_commands: int = FLAT_COMMANDS, flat_reps: int = FLAT_REPS,
        seed: int = 0) -> dict:
    """Every arm on both backends on ``device`` (``cuda`` when None);
    raises ``GateFailure`` on a failed gate. On a CUDA device K5 and K6
    must have launched on the cuda run's traffic."""
    dev = resolve_device(device)
    backends, exact = {}, {}
    for backend in BACKENDS:
        backends[backend], exact[backend] = backend_run(
            backend, dev, writes, flat_commands, flat_reps, seed)
        gates = backends[backend]["gates"]
        _require(gates["all_passed"],
                 f"{backend}: a geo gate failed: {gates}")
    for name in exact["dict"]:
        _require(exact["cuda"][name] == exact["dict"][name],
                 f"{name}: the cuda run's acks, virtual latencies or "
                 f"group sequences differ from the dict run's")
    traffic = backends["cuda"]["launches"]
    if dev.type == "cuda":
        missing = [k for k in PATH_KERNELS if not traffic[k]]
        _require(not missing, f"WPaxos traffic never launched {missing}")
    return {
        "benchmark": "geo_lt",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "topology": {"regions": 3, "zones": 3, "acceptors_per_zone": 3,
                     "groups": 6, "clients": 3,
                     "intra_zone_rtt_s": 2 * 0.0005,
                     "intra_region_rtt_s": 2 * 0.004,
                     "wan_rtt_s": 2 * 0.040, "jitter": 0.05},
        "writes": writes, "flat_commands": flat_commands,
        "flat_reps": flat_reps, "seed": seed,
        "zone_outage": "not run: it restarts a zone from its WALs "
                       "(ROADMAP.md queue 1 item 4)",
        "backends": backends,
        "exact_across_backends": True,
        "launches": traffic,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--writes", type=int, default=WRITES)
    parser.add_argument("--flat_commands", type=int, default=FLAT_COMMANDS)
    parser.add_argument("--flat_reps", type=int, default=FLAT_REPS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, args.writes, args.flat_commands,
                         args.flat_reps, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
