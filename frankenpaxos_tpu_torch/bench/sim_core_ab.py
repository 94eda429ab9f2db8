"""The geo simulator core at schedule scale, with the link mask on the
numpy kernel and on K18 (a partial twin of
``frankenpaxos_tpu/bench/sim_core_ab.py``).

The reference's ``GeoStorm`` workload at its full width -- 1000 zones
in regions of 10, one sink actor per zone, bursts of 500 frames a round
from a driver (a quarter flagged to echo one hop to a peer), a
partition/heal cycle on a rotating link pair, ``run_for`` a 3 ms dwell
per round so a multi-round backlog stays in flight -- run on the port's
``GeoSimTransport`` with ``simwave.LINK_KEEP_MASK`` on the reference's
numpy kernel and on K18 (``link_keep_mask_cuda``), in alternating blocks
(numpy, K18, K18, numpy). Run::

    python -m frankenpaxos_tpu_torch.bench.sim_core_ab [--device cpu]

It prints ONE JSON line. Arms:

  * ``storm/jitter=0.05``: the reference's topology. Every frame draws
    its own delay, so waves (frames with EQUAL arrival stamps) are
    almost all single frames and the mask, which the transport runs only
    on waves of at least ``WAVE_VECTOR_MIN`` (32) frames, almost never
    runs;
  * ``storm/jitter=0``: the same storm on the jitter-free topology, where
    a burst lands in a few waves of hundreds of frames (one per latency
    tier);
  * ``fifo/deep-wave``: ``deliver_all_coalesced`` of a 32,768-frame
    backlog from 16 senders spread over the 1000 zones to the zones'
    sinks, with 50 sender/sink zone links partitioned, four times (the
    depth and volume of the reference's ``fifo/deep-wave`` row, on the
    geo transport): each backlog is one wave.

Gates (a failed gate raises ``GateFailure``): in every arm the delivery
projection ``(id, src, dst)`` and the sinks' counts are IDENTICAL across
the mask backends and blocks; on a CUDA device K18 launched. Recorded per
arm: events/s per mask backend (median of its blocks, host clock,
history recording on for the projection), the wave-size histogram (by
the power of two at or below each wave's size), the waves at or above
32, and K18's launches per K18 block. The reference's legacy-core arm
needs ``runtime/sim_legacy.py``, which is not ported (ROADMAP.md queue
1 item 11).
"""

from __future__ import annotations

import argparse
import collections
import functools
import gc
import hashlib
import json
import random
import statistics
import sys
import time

from frankenpaxos_tpu_torch.bench.geo_lt import wave_figures, watch_waves
from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.geo.topology import GeoTopology
from frankenpaxos_tpu_torch.geo.transport import GeoSimTransport
from frankenpaxos_tpu_torch.ops import simwave
from frankenpaxos_tpu_torch.runtime.actor import Actor
from frankenpaxos_tpu_torch.runtime.logger import Logger
from frankenpaxos_tpu_torch.runtime.sim_transport import DeliverMessage
import torch

ZONES = 1000
BURST = 500
#: The reference's smoke depth (its ``--smoke`` storm rounds).
ROUNDS = 60
FIFO_DEPTH = 32768
FIFO_WAVES = 4
FIFO_SENDERS = 16
FIFO_CUT_LINKS = 50
#: Mask backend per block: alternating, so each sees the same noise.
BLOCKS = ("numpy", "k18", "k18", "numpy")


class GateFailure(AssertionError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


class _NullLogger(Logger):
    def debug(self, m):
        pass

    def info(self, m):
        pass

    def warn(self, m):
        pass

    def error(self, m):
        pass

    def fatal(self, m):
        raise RuntimeError(m)


class _RawSerializer:
    """Identity codec: sink payloads are opaque bytes, so the run
    measures the delivery machinery, not pickle."""

    def to_bytes(self, m):
        return m

    def from_bytes(self, d):
        return d


_ECHO = 1  # payload flag: re-send one hop to a deterministic peer


class StormSink(Actor):
    """Counts deliveries; frames flagged ``_ECHO`` re-send one hop to a
    deterministic peer (cross-zone chatter). ``receive_batch`` is the
    path the wave engine takes; both paths process frames in order."""

    serializer = _RawSerializer()

    def __init__(self, address, transport, logger, peers, index):
        super().__init__(address, transport, logger)
        self.peers = peers
        self.index = index
        self.n = 0

    def _react(self, data):
        if data[0] == _ECHO:
            hop = (self.index + data[1]) % len(self.peers)
            self.send(self.peers[hop], bytes((0, data[1])))

    def receive(self, src, data):
        self.n += 1
        self._react(data)

    def receive_batch(self, batch):
        self.n += len(batch)
        react = self._react
        for _, data in batch:
            react(data)


class GeoStorm:
    """The reference's storm: a multi-region topology, per-zone sinks,
    and a deterministic per-round schedule of bursts, partition/heal
    cycles and a short ``run_for``."""

    def __init__(self, zones: int, burst: int, seed: int = 0,
                 jitter: float = 0.05, dwell_s: float = 0.003):
        per_region = 10 if zones >= 100 else 3
        regions = {f"r{i}": [f"z{i}-{j}" for j in range(per_region)]
                   for i in range(zones // per_region)}
        self.topology = GeoTopology(regions, seed=seed, jitter=jitter)
        self.transport = GeoSimTransport(self.topology, _NullLogger())
        self.burst = burst
        self.dwell_s = dwell_s
        self.rng = random.Random(f"sim_core_ab|{seed}")
        self.peers = [f"sink-{i}" for i in range(len(self.topology.zones))]
        self.sinks = [
            StormSink(addr, self.transport, self.transport.logger,
                      self.peers, i)
            for i, addr in enumerate(self.peers)]
        for sink, zone in zip(self.sinks, self.topology.zones):
            self.topology.place(sink.address, zone)
        self.topology.place("driver", self.topology.zones[0])
        self.round = 0

    def run_round(self) -> None:
        r = self.round
        self.round += 1
        rng = self.rng
        send = self.transport.send
        n = len(self.peers)
        for k in range(self.burst):
            flag = _ECHO if k % 4 == 0 else 0
            send("driver", self.peers[rng.randrange(n)],
                 bytes((flag, rng.randrange(7))))
        zones = self.topology.zones
        if r % 20 == 4:
            a = zones[r % len(zones)]
            b = zones[(r * 7 + 3) % len(zones)]
            if a != b:
                self.topology.partition_link(a, b)
        if r % 20 == 14:
            self.topology.heal_all()
        self.transport.run_for(self.dwell_s)

    def finish(self) -> int:
        self.topology.heal_all()
        self.transport.run_until_quiescent()
        return sum(s.n for s in self.sinks)


class FifoSink(Actor):
    serializer = _RawSerializer()

    def __init__(self, address, transport, logger):
        super().__init__(address, transport, logger)
        self.n = 0

    def receive(self, src, data):
        self.n += 1

    def receive_batch(self, batch):
        self.n += len(batch)


def _projection(transport) -> list:
    return [(c.message.id, str(c.message.src), str(c.message.dst))
            for c in transport.history if isinstance(c, DeliverMessage)]


def _set_mask(mask: str, device) -> None:
    simwave.LINK_KEEP_MASK = (
        functools.partial(simwave.link_keep_mask_cuda, device=device)
        if mask == "k18" else simwave.link_keep_mask)


def storm_block(mask: str, device, zones: int, burst: int, rounds: int,
                seed: int, jitter: float) -> dict:
    """One storm from scratch on one mask backend."""
    _set_mask(mask, device)
    storm = GeoStorm(zones, burst, seed=seed, jitter=jitter)
    waves = watch_waves(storm.transport)
    before = simwave.link_keep_mask_tensor.launches
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(rounds):
            storm.run_round()
        events = storm.finish()
        seconds = time.perf_counter() - t0
    finally:
        gc.enable()
    return {"events": events, "seconds": seconds, "waves": waves,
            "k18": simwave.link_keep_mask_tensor.launches - before,
            "projection": _projection(storm.transport),
            "counts": [s.n for s in storm.sinks]}


def fifo_block(mask: str, device, zones: int, depth: int, waves_n: int,
               seed: int) -> dict:
    """Deep FIFO backlogs over the geo transport, some links cut."""
    _set_mask(mask, device)
    regions = {f"r{i}": [f"z{i}-{j}" for j in range(10)]
               for i in range(zones // 10)}
    topology = GeoTopology(regions, seed=seed)
    transport = GeoSimTransport(topology, _NullLogger())
    sinks = [FifoSink(f"s{i}", transport, transport.logger)
             for i in range(len(topology.zones))]
    for sink, zone in zip(sinks, topology.zones):
        topology.place(sink.address, zone)
    zone_list = topology.zones
    senders = [f"c{k}" for k in range(FIFO_SENDERS)]
    for k, sender in enumerate(senders):
        topology.place(sender, zone_list[k * len(zone_list) // len(senders)])
    rng = random.Random(f"sim_core_ab|fifo|{seed}")
    for _ in range(FIFO_CUT_LINKS):
        topology.partition_link(topology.zone_of(rng.choice(senders)),
                                rng.choice(zone_list))
    waves = watch_waves(transport)
    before = simwave.link_keep_mask_tensor.launches
    payload = b"\x00" * 24
    n_sinks = len(sinks)
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(waves_n):
            for i in range(depth):
                transport.send(senders[i % len(senders)],
                               sinks[rng.randrange(n_sinks)].address,
                               payload)
            transport.deliver_all_coalesced(max_steps=depth)
        seconds = time.perf_counter() - t0
    finally:
        gc.enable()
    return {"events": sum(s.n for s in sinks), "sent": depth * waves_n,
            "seconds": seconds, "waves": waves,
            "k18": simwave.link_keep_mask_tensor.launches - before,
            "projection": _projection(transport),
            "counts": [s.n for s in sinks]}


def _arm(block) -> dict:
    """Run ``block(mask)`` for each of ``BLOCKS`` in turn, hold every
    block's projection and counts equal to the first's, and return the
    figures (only the first block's projection is kept)."""
    first = None
    rates = collections.defaultdict(list)
    k18 = []
    for mask in BLOCKS:
        got = block(mask)
        if first is None:
            first = got
        else:
            _require(got["projection"] == first["projection"]
                     and got["counts"] == first["counts"],
                     f"the {mask} block's deliveries differ from the first "
                     f"block's")
        rates[mask].append(got["events"] / got["seconds"])
        if mask == "k18":
            k18.append(got["k18"])
    digest = hashlib.sha256(repr(first["projection"]).encode()).hexdigest()
    return {
        "events": first["events"],
        "events_per_s": {mask: statistics.median(r)
                         for mask, r in rates.items()},
        "events_per_s_blocks": dict(rates),
        **wave_figures(first["waves"]),
        "k18_launches_per_block": k18,
        "projection_sha256": digest,
        "projection_rows": len(first["projection"]),
    }


def run(device=None, zones: int = ZONES, burst: int = BURST,
        rounds: int = ROUNDS, fifo_depth: int = FIFO_DEPTH,
        fifo_waves: int = FIFO_WAVES, seed: int = 0) -> dict:
    """Every arm on ``device`` (``cuda`` when None) with both mask
    backends; raises ``GateFailure`` on a failed gate."""
    dev = resolve_device(device)
    saved = simwave.LINK_KEEP_MASK
    arms = {}
    try:
        for jitter in (0.05, 0.0):
            arms[f"storm/jitter={jitter:g}"] = _arm(functools.partial(
                storm_block, device=dev, zones=zones, burst=burst,
                rounds=rounds, seed=seed, jitter=jitter))
        arms["fifo/deep-wave"] = _arm(functools.partial(
            fifo_block, device=dev, zones=zones, depth=fifo_depth,
            waves_n=fifo_waves, seed=seed))
    finally:
        simwave.LINK_KEEP_MASK = saved
    k18 = sum(sum(a["k18_launches_per_block"]) for a in arms.values())
    if dev.type == "cuda":
        _require(k18 > 0, "K18 never launched on the geo path")
    return {
        "benchmark": "sim_core_ab",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "zones": zones, "burst": burst, "rounds": rounds,
        "fifo_depth": fifo_depth, "fifo_waves": fifo_waves, "seed": seed,
        "blocks": list(BLOCKS),
        "legacy_arm": "not run: runtime/sim_legacy.py is not ported "
                      "(ROADMAP.md queue 1 item 11)",
        "arms": arms,
        "k18_launches": k18,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, rounds=args.rounds, seed=args.seed)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
