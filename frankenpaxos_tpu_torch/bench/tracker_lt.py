"""Phase2b vote-tracking benchmark: the ProxyLeader's hot loop on one GPU.

The twin of ``frankenpaxos_tpu/bench/lt_suite.py::tracker_votes_per_sec``:
a synthetic Phase2b stream replayed into one quorum tracker with the
actor pipeline stripped away. Run::

    python -m frankenpaxos_tpu_torch.bench.tracker_lt

It prints ONE JSON line. Off CUDA it REFUSES to stamp a figure (the line
says ``"degraded": true`` and the exit code is nonzero).

The stream (``make_stream``, from a seed) is the steady state with its
usual damage, drain by drain:

  * each acceptor acks the drain's ``drain``-slot run as ranged votes
    (Phase2bRange), with holes where votes straggle;
  * about 10% of votes straggle, in 16-slot bursts per acceptor, and
    arrive 1-3 drains late as per-slot records;
  * about 1% of votes are duplicate acks of the previous drain's votes;
  * about 1% of slots are bumped to round 1 (a leader change over a
    quarter of one drain's run, 1024 slots at full width, every 25
    drains): one acceptor's round-0 vote lands,
    then every acceptor's round-1 votes arrive 1-3 drains late as
    ranged runs.

Arms (full width: ``f = 1``, one acceptor group of 3, window 2^20, 2^20
slots, i.e. about 3 * 2^20 votes):

  * ``sync``: ``TpuQuorumTracker`` in its synchronous mode (K1 + host
    spill), routed by its own ``min_device_slots``;
  * ``pipelined``: the pipelined mode (K2, K4, K5), its dispatches
    collected on a worker thread as the ProxyLeader's collector does;
  * ``grid``: the pipelined mode on a flexible 2x3-grid config (6
    acceptors, one vote from every row), at 2^18 slots;
  * ``epoch``: ``EpochQuorumTracker`` (K6, K7, K5) with one handover at
    slot 2^19 that swaps one member of three.

Every arm must report exactly the ``(slot, round)`` set of its dict
oracle (``DictQuorumTracker`` or the dict epoch tracker), each pair
once; a mismatch raises. Beside the arms, the dict-vs-device crossover:
votes/s of ``DictQuorumTracker`` and of the synchronous device tracker
forced onto the device (``min_device_slots=1``) over contiguous drains
of 1 ... 4096 slots, three votes per slot, in two shapes: per-slot
records (the reference's Phase2b) and one ranged vote per acceptor and
drain (Phase2bRange, what the acceptors send for a contiguous drain).
The smallest width from which the device wins at every wider width, in
the ranged shape, is the measured ``min_device_slots``.
"""

from __future__ import annotations

import json
import queue
import statistics
import sys
import threading
import time

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.protocols.multipaxos.config import (
    DistributionScheme,
    MultiPaxosConfig,
)
from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
    DictQuorumTracker,
    TpuQuorumTracker,
)
from frankenpaxos_tpu_torch.reconfig import (
    EpochConfig,
    EpochQuorumTracker,
    EpochStore,
)
import numpy as np
import torch

METRIC = "phase2b_votes_per_sec"
WINDOW = 1 << 20          # ProxyLeaderOptions.tpu_window
SLOTS = 1 << 20           # per arm
GRID_SLOTS = 1 << 18
DRAIN = 4096              # slots acked per drain (one ranged run)
HANDOVER = 1 << 19        # the epoch arm's membership change
CROSSOVER_WIDTHS = tuple(1 << k for k in range(13))  # 1 ... 4096
SEED = 20261017

BURST = 16                # straggler burst length
STRAGGLE_P = 0.1          # per acceptor and burst
DUP_P = 0.01              # per vote of the previous drain
BUMP_EVERY = 25           # drains between leader changes
BUMP_SHARE = 4            # 1 / share of a drain's run bumped to round 1


def make_config(flexible: bool = False) -> MultiPaxosConfig:
    """``f = 1`` with one acceptor group of 3 (``make_multipaxos``'s
    default), or a flexible 2x3 grid of acceptors."""
    f = 1
    if flexible:
        acceptors = [[f"acceptor-{g}-{i}" for i in range(3)]
                     for g in range(2)]
    else:
        acceptors = [[f"acceptor-0-{i}" for i in range(2 * f + 1)]]
    config = MultiPaxosConfig(
        f=f,
        batcher_addresses=[],
        read_batcher_addresses=[],
        leader_addresses=[f"leader-{i}" for i in range(f + 1)],
        leader_election_addresses=[f"election-{i}" for i in range(f + 1)],
        proxy_leader_addresses=[f"proxy-leader-{i}" for i in range(f + 1)],
        acceptor_addresses=acceptors,
        replica_addresses=[f"replica-{i}" for i in range(f + 1)],
        proxy_replica_addresses=[],
        flexible=flexible,
        distribution_scheme=DistributionScheme.HASH,
    )
    config.check_valid()
    return config


def make_stream(num_slots: int, acceptors: int, drain: int = DRAIN,
                seed: int = SEED) -> list:
    """The drains of the stream described in the module docstring: a
    list with one list of events per drain, each event
    ``("range", start, end, round, acceptor)`` or
    ``("vote", slot, round, acceptor)``. Late events still pending after
    the last run arrive in up to three trailing drains."""
    rng = np.random.default_rng(seed)
    num_drains = num_slots // drain
    late: dict = {}           # drain index -> [event]
    prev_on_time = None       # [acceptors, drain] bool of the last drain
    drains = []
    for d in range(num_drains + 3):
        events = []
        base = d * drain
        if d < num_drains:
            bumped = np.zeros(drain, dtype=bool)
            if d % BUMP_EVERY == BUMP_EVERY // 2:
                width = drain // BUMP_SHARE
                at = int(rng.integers(0, drain - width + 1))
                bumped[at:at + width] = True
                due = d + int(rng.integers(1, 4))
                for acc in range(acceptors):
                    late.setdefault(due, []).append(
                        ("range", base + at, base + at + width, 1, acc))
            on_time = np.ones((acceptors, drain), dtype=bool)
            on_time[1:, bumped] = False
            straggle = np.repeat(
                rng.random((acceptors, drain // BURST)) < STRAGGLE_P, BURST,
                axis=1) & on_time
            on_time &= ~straggle
            for acc in range(acceptors):
                edges = np.flatnonzero(np.diff(np.concatenate(
                    [[0], on_time[acc].astype(np.int8), [0]])))
                for s, e in zip(edges[::2], edges[1::2]):
                    events.append(("range", base + int(s), base + int(e), 0,
                                   acc))
                for pos in np.flatnonzero(straggle[acc]).tolist():
                    due = d + int(rng.integers(1, 4))
                    late.setdefault(due, []).append(
                        ("vote", base + pos, 0, acc))
            if prev_on_time is not None:
                accs, pos = np.nonzero(prev_on_time
                                       & (rng.random(prev_on_time.shape)
                                          < DUP_P))
                for acc, p in zip(accs.tolist(), pos.tolist()):
                    events.append(("vote", base - drain + p, 0, acc))
            prev_on_time = on_time
        events.extend(late.pop(d, []))
        if events:
            drains.append(events)
    return drains


def count_votes(stream: list) -> int:
    return sum(e[2] - e[1] if e[0] == "range" else 1
               for events in stream for e in events)


def per_slot_share(stream: list) -> float:
    """The share of the stream's votes that arrive as per-slot records
    (the rest arrive ranged)."""
    per_slot = sum(e[0] == "vote" for events in stream for e in events)
    return per_slot / count_votes(stream)


def replay(tracker, stream: list, row: int, on_drain=None) -> list:
    """Feed the stream into a MultiPaxos tracker (acceptor ``a`` votes as
    ``(group a // row, index a % row)``), one ``drain()`` per drain, then
    ``on_drain()``; returns what the drains reported."""
    out = []
    for events in stream:
        for event in events:
            if event[0] == "range":
                _, start, end, rnd, acc = event
                tracker.record_range(start, end, rnd, acc // row, acc % row)
            else:
                _, slot, rnd, acc = event
                tracker.record(slot, rnd, acc // row, acc % row)
        out.extend(tracker.drain())
        if on_drain is not None:
            on_drain()
    return out


def replay_pipelined(tracker: TpuQuorumTracker, stream: list,
                     row: int) -> list:
    """Replay into a pipelined tracker whose dispatches are collected on
    a worker thread (the ProxyLeader's collector: the event loop hands
    each dispatch over after its drain; the worker blocks on the device
    and gathers the results). Returns the results once every dispatch
    is collected."""
    dispatches: queue.Queue = queue.Queue()
    results: list = []
    errors: list = []

    def collect_loop():
        while (dispatch := dispatches.get()) is not None:
            try:
                results.extend(tracker.collect(dispatch))
            except Exception as exc:  # reported on the caller's thread
                errors.append(exc)
                return

    def hand_over():
        while (dispatch := tracker.take_dispatch()) is not None:
            dispatches.put(dispatch)

    worker = threading.Thread(target=collect_loop, name="tracker-collect",
                              daemon=True)
    worker.start()
    try:
        replay(tracker, stream, row, hand_over)
    finally:
        dispatches.put(None)
        worker.join(timeout=600)
    if worker.is_alive():
        raise RuntimeError("the collector thread did not finish")
    if errors:
        raise errors[0]
    return results


def replay_epochs(tracker: EpochQuorumTracker, store: EpochStore,
                  stream: list, drain: int, handover: int,
                  members: tuple) -> list:
    """Feed the stream into an epoch tracker. Votes are by address:
    acceptor ``a`` is ``members[0][a]`` below ``handover`` and
    ``members[1][a]`` from it. The new epoch is committed just before the
    first drain of slots at or past ``handover`` (the watermark-bounded
    handover: no slot of an epoch gets a vote before the epoch exists)."""
    out = []
    switched = False
    for d, events in enumerate(stream):
        if not switched and d * drain >= handover:
            store.add(EpochConfig(epoch=1, start_slot=handover, f=1,
                                  members=members[1]))
            tracker.note_epochs()
            switched = True
        for event in events:
            if event[0] == "range":
                _, start, end, rnd, acc = event
                voter = members[start >= handover][acc]
                tracker.record_range(start, end, rnd, voter)
            else:
                _, slot, rnd, acc = event
                tracker.record(slot, rnd, members[slot >= handover][acc])
        out.extend(tracker.drain())
    return out


def check_against_oracle(arm: str, got: list, oracle: list) -> None:
    """Raise unless ``got`` holds each pair once and the oracle's set."""
    if len(got) != len(set(got)):
        raise RuntimeError(f"{arm}: {len(got) - len(set(got))} (slot, round) "
                           f"pairs reported more than once")
    if set(got) != set(oracle):
        missing, extra = set(oracle) - set(got), set(got) - set(oracle)
        raise RuntimeError(
            f"{arm}: {len(missing)} pairs missing (e.g. "
            f"{sorted(missing)[:3]}), {len(extra)} extra (e.g. "
            f"{sorted(extra)[:3]}) against the dict oracle")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, fn) -> tuple:
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _figures(votes: int, seconds: float, reported: list) -> dict:
    return {"votes": votes, "seconds": seconds,
            "votes_per_sec": votes / seconds, "chosen": len(reported)}


def steady_votes_per_sec(tracker, width: int, drains: int,
                         ranged: bool) -> float:
    """``lt_suite.tracker_votes_per_sec``'s replay: contiguous runs of
    ``width`` slots, three votes per slot (per-slot records, or one
    ranged vote per acceptor), one drain per run, after one warm drain;
    every slot must be reported."""
    def one(base):
        if ranged:
            for acc in range(3):
                tracker.record_range(base, base + width, 0, 0, acc)
        else:
            record = tracker.record
            for slot in range(base, base + width):
                for acc in range(3):
                    record(slot, 0, 0, acc)
        return len(tracker.drain())

    one(0)
    t0 = time.perf_counter()
    chosen = sum(one((d + 1) * width) for d in range(drains))
    elapsed = time.perf_counter() - t0
    if chosen != drains * width:
        raise RuntimeError(f"width {width}: {chosen} chosen of "
                           f"{drains * width}")
    return drains * width * 3 / elapsed


def crossover(device: torch.device, widths=CROSSOVER_WIDTHS,
              target_votes: int = 49152, reps: int = 3) -> tuple:
    """``(rows, measured_min_device_slots)``: per drain width and vote
    shape, the median votes/s of ``DictQuorumTracker`` and of the
    synchronous device tracker forced onto the device, in alternating
    order; the threshold is the smallest width from which the device
    wins at every wider width in the ranged shape (None when it never
    does)."""
    config = make_config()
    rows = []
    for width in widths:
        drains = max(8, min(4096, target_votes // (3 * width)))
        row = {"width": width, "drains": drains}
        for shape in ("per_slot", "ranged"):
            runs: dict = {"dict": [], "device": []}
            for rep in range(reps):
                for arm in (("dict", "device") if rep % 2 == 0
                            else ("device", "dict")):
                    tracker = DictQuorumTracker(config) if arm == "dict" \
                        else TpuQuorumTracker(config, window=1 << 14,
                                              device=device,
                                              min_device_slots=1)
                    runs[arm].append(steady_votes_per_sec(
                        tracker, width, drains, shape == "ranged"))
            for arm, values in runs.items():
                row[f"{shape}_{arm}_votes_per_sec"] = \
                    statistics.median(values)
        rows.append(row)
    threshold = None
    for row in reversed(rows):
        if row["ranged_device_votes_per_sec"] \
                < row["ranged_dict_votes_per_sec"]:
            break
        threshold = row["width"]
    return rows, threshold


def run(device=None, slots: int = SLOTS, grid_slots: int = GRID_SLOTS,
        window: int = WINDOW, drain: int = DRAIN, handover: int = HANDOVER,
        widths=CROSSOVER_WIDTHS) -> dict:
    """Every arm and the crossover on ``device`` (``cuda`` when None);
    raises when an arm disagrees with its dict oracle."""
    device = resolve_device(device)
    if handover % drain:
        raise ValueError("the handover must fall on a drain boundary")
    arms = {}
    config = make_config()
    stream = make_stream(slots, 3, drain)
    votes = count_votes(stream)
    oracle, seconds = _timed(device, lambda: replay(
        DictQuorumTracker(config), stream, 3))
    arms["dict"] = _figures(votes, seconds, oracle)

    sync = TpuQuorumTracker(config, window=window, device=device)
    got, seconds = _timed(device, lambda: replay(sync, stream, 3))
    check_against_oracle("sync", got, oracle)
    arms["sync"] = {**_figures(votes, seconds, got),
                    "min_device_slots": sync.min_device_slots}

    piped = TpuQuorumTracker(config, window=window, pipelined=True,
                             device=device)
    got, seconds = _timed(device, lambda: replay_pipelined(piped, stream, 3))
    check_against_oracle("pipelined", got, oracle)
    arms["pipelined"] = _figures(votes, seconds, got)

    grid_config = make_config(flexible=True)
    grid_stream = make_stream(grid_slots, 6, drain, SEED + 1)
    grid_oracle = replay(DictQuorumTracker(grid_config), grid_stream, 3)
    grid = TpuQuorumTracker(grid_config, window=window, pipelined=True,
                            device=device)
    got, seconds = _timed(device, lambda: replay_pipelined(
        grid, grid_stream, 3))
    check_against_oracle("grid", got, grid_oracle)
    arms["grid"] = _figures(count_votes(grid_stream), seconds, got)

    members = (("a0", "a1", "a2"), ("a0", "a1", "a3"))
    epoch_window = min(window, 1 << 14)  # the ProxyLeader's epoch window
    reported = {}
    for backend in ("dict", "cuda"):
        store = EpochStore.from_members(members[0], f=1)
        tracker = EpochQuorumTracker(store, backend=backend,
                                     window=epoch_window, device=device)
        reported[backend] = _timed(device, lambda: replay_epochs(
            tracker, store, stream, drain, handover, members))
    check_against_oracle("epoch", reported["cuda"][0], reported["dict"][0])
    arms["epoch"] = _figures(votes, reported["cuda"][1], reported["cuda"][0])
    arms["epoch_dict"] = _figures(votes, reported["dict"][1],
                                  reported["dict"][0])

    rows, threshold = crossover(device, widths)
    return {
        "metric": METRIC,
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else str(device),
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "window": window, "slots": slots, "grid_slots": grid_slots,
        "drain": drain, "handover": handover, "seed": SEED,
        "per_slot_share": per_slot_share(stream),
        "arms": arms,
        "crossover": rows,
        "measured_min_device_slots": threshold,
        "degraded": False,
    }


def main() -> int:
    if not torch.cuda.is_available():
        # REFUSE: a CPU run must never be recorded as a device figure.
        print(json.dumps({
            "metric": METRIC,
            "degraded": True,
            "note": "refusing to stamp a figure: no CUDA device "
                    "(torch.cuda.is_available() is False)",
        }))
        return 1
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
