"""depset_lt: paired A/B of the coalesced EPaxos dependency plane against
the per-message path, on one GPU.

The port's twin of ``frankenpaxos_tpu/bench/depset_lt.py``. Run::

    python -m frankenpaxos_tpu_torch.bench.depset_lt [--device cpu]

It prints ONE JSON line. Per in-flight width (256, 1024 and 4096), the
SAME drains of PreAcceptOk replies -- seq/deps payloads around a moving
executed watermark, from the reference's ``make_drain`` -- are
aggregated by two leader-edge arms in one process:

  * ``per_message``: the replica's host slow-path loop over the message
    objects, ``seq = max(seqs)`` plus ``deps.add_all`` per reply
    (epaxos/Replica.scala:795-813);
  * ``coalesced``: the drain's dependency columns
    (``runs/depruns.sets_to_columns``) go through one
    ``columns_to_batch`` scatter into the staging's packed ``[B, 3, W]``
    block, one K10 launch in its seq mode for the whole drain and one
    fetch, as ONE staged call (``depset.union_packed``), then
    ``from_row``.

The port has no wire codecs yet (ROADMAP.md item 3), so both arms start
from decoded data: the reference's per-message ``PreAcceptOkCodec``
decode and run-frame decode are left out of both, and the output says
so. Both arms'
``(sequence number, dependency set)`` aggregates must be equal on every
drain before any timing counts (``GateFailure`` otherwise). Blocks
alternate the arm order with GC off; the per-arm figure is the median
msgs/s over blocks, on the host clock.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import random
import statistics
import sys
import time

from frankenpaxos_tpu_torch.compact import IntPrefixSet
from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
from frankenpaxos_tpu_torch.ops import depset
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.epaxos.instance_prefix_set import (
    Instance,
    InstancePrefixSet,
)
from frankenpaxos_tpu_torch.protocols.epaxos.messages import PreAcceptOk
from frankenpaxos_tpu_torch.runs import depruns
import numpy as np
import torch

WIDTHS = (256, 1024, 4096)
NUM_LEADERS = 3  # f=1 EPaxos: n = 3 dependency columns per set
TAIL_SPAN = 24  # sparse ids live within this window above the base
LEFT_OUT = ("the per-message PreAcceptOkCodec decode and the run-frame "
            "decode: the port has no wire codecs yet, so both arms start "
            "from decoded data")


class GateFailure(AssertionError):
    pass


def make_drain(width: int, rng: random.Random) -> list:
    """One drain of ``width`` PreAcceptOks: per-column watermarks near
    a shared executed frontier, a few sparse tail ids above it, and
    random conflict sequence numbers -- the steady-state shape the
    replica's slow path sees."""
    base = rng.randrange(1000, 2000)
    messages = []
    for i in range(width):
        columns = []
        for _ in range(NUM_LEADERS):
            watermark = base + rng.randrange(0, 4)
            tail = {base + rng.randrange(4, TAIL_SPAN)
                    for _ in range(rng.randrange(0, 4))}
            columns.append(IntPrefixSet(watermark,
                                        {v for v in tail
                                         if v >= watermark}))
        deps = InstancePrefixSet(NUM_LEADERS, columns)
        messages.append(PreAcceptOk(
            instance=Instance(i % NUM_LEADERS, base + i),
            ballot=(0, i % NUM_LEADERS),
            replica_index=i % NUM_LEADERS,
            sequence_number=rng.randrange(0, 1 << 20),
            dependencies=deps))
    return messages


def host_aggregate(messages: list) -> tuple:
    """Arm A: the per-message slow-path loop, verbatim host semantics."""
    union = InstancePrefixSet(NUM_LEADERS)
    seq = 0
    for message in messages:
        seq = max(seq, message.sequence_number)
        union.add_all(message.dependencies)
    return seq, union


def coalesced_aggregate(columns: tuple, seqs: np.ndarray, device) -> tuple:
    """Arm B: one scatter into the staging's packed block, one K10 launch
    in its seq mode and one fetch, as ONE staged call."""
    block = depruns.columns_to_batch(
        *columns, out=functools.partial(depset.packed, device=device),
        seqs=seqs)
    seq, watermarks, tails = depset.union_packed(block)
    return seq, device_deps.from_row(watermarks, tails,
                                     int(block.tail_base))


def run_pair(device, width: int, blocks: int, drains_per_block: int,
             seed: int) -> dict:
    rng = random.Random(seed)
    drains = []
    for _ in range(drains_per_block):
        messages = make_drain(width, rng)
        columns = depruns.sets_to_columns([m.dependencies
                                           for m in messages])
        seqs = np.asarray([m.sequence_number for m in messages],
                          dtype=np.int32)
        drains.append((messages, columns, seqs))

    # The two aggregates equal on every drain BEFORE any timing counts.
    launches = depset.conflict_max.launches
    for messages, columns, seqs in drains:
        host = host_aggregate(messages)
        coalesced = coalesced_aggregate(columns, seqs, device)
        if coalesced != host:
            raise GateFailure(f"width {width}: the coalesced aggregate "
                              f"differs from the per-message one")
    shape = list(depruns.columns_to_batch(*drains[0][1],
                                          device=device).tails.shape)

    per_block: dict = {"per_message": [], "coalesced": []}
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        for block in range(blocks):
            arms = (("per_message", "coalesced") if block % 2 == 0
                    else ("coalesced", "per_message"))
            for arm in arms:
                t0 = time.perf_counter()
                if arm == "per_message":
                    for messages, _, _ in drains:
                        host_aggregate(messages)
                else:
                    for _, columns, seqs in drains:
                        coalesced_aggregate(columns, seqs, device)
                elapsed = time.perf_counter() - t0
                per_block[arm].append(width * drains_per_block / elapsed)
    finally:
        if gc_was_enabled:
            gc.enable()
    pair = {arm: {"arm": arm, "in_flight": width,
                  "msgs_per_s": statistics.median(rates),
                  "blocks_msgs_per_s": rates}
            for arm, rates in per_block.items()}
    pair["throughput_ratio"] = (pair["coalesced"]["msgs_per_s"]
                                / pair["per_message"]["msgs_per_s"])
    pair["k10_shape"] = shape
    pair["k10_launches"] = depset.conflict_max.launches - launches
    return pair


def run(device=None, widths=WIDTHS, blocks: int = 7, seed: int = 0) -> dict:
    """Every width on ``device`` (``cuda`` when None); raises
    ``GateFailure`` when a drain's aggregates differ."""
    dev = resolve_device(device)
    pairs = {}
    for width in widths:
        drains_per_block = max(2, 16 * 1024 // width)
        # Warm the kernel path at this shape outside the measured blocks.
        warm = make_drain(width, random.Random(seed + 99))
        coalesced_aggregate(
            depruns.sets_to_columns([m.dependencies for m in warm]),
            np.zeros(width, dtype=np.int32), dev)
        pairs[str(width)] = run_pair(dev, width, blocks, drains_per_block,
                                     seed)
    return {
        "benchmark": "depset_lt",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "left_out": LEFT_OUT, "blocks": blocks, "num_leaders": NUM_LEADERS,
        "pairs": pairs,
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
