"""Library microbenchmarks: the hot host data structures and the device
dependency-set / watermark kernels, on one GPU.

The port's twin of ``frankenpaxos_tpu/bench/libbench.py`` (the analog of
the reference's ScalaMeter benches, jvm/src/bench/scala/frankenpaxos/).
Run::

    python -m frankenpaxos_tpu_torch.bench.libbench [--device cpu] \\
        [--out FILE]

It prints the JSON artifact. Covered: BufferMap put/get/GC,
IntPrefixSet add/union/materialized diff, the four dependency-graph
implementations on the EPaxos commit -> execute shape (all on the port's
host modules), and the device kernels at a realistic batch width: K12
``quorum_watermark`` on the transposed (strided) ``[4096, 5]`` view with
q = 3, K13 ``contiguous_prefix_length`` on ``[4096]`` with one False at
2048, and K16 ``union`` followed by K10 ``union_reduce`` on
``[4096, 3, 64]`` with tail base 2^16 -- each 50 calls chained, one
synchronize at the end -- and the wire serializer: a Phase2b's round
trips per second through the binary codec and through pickle.
Unlike the reference, which drops to CPU XLA when no accelerator
answers, this bench refuses to run off CUDA unless a device is named.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from frankenpaxos_tpu_torch.device import nvidia_smi_line, resolve_device
import numpy as np
import torch

def _rate(n: int, f) -> float:
    """ops/s of f() (which performs n operations), best of 3."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return n / best


def bench_buffer_map(n: int = 200_000) -> dict:
    from frankenpaxos_tpu_torch.utils.buffer_map import BufferMap

    def puts():
        m = BufferMap(grow_size=5000)
        for i in range(n):
            m.put(i, i)

    filled = BufferMap(grow_size=5000)
    for i in range(n):
        filled.put(i, i)

    def gets():
        for i in range(n):
            filled.get(i)

    def put_gc():
        m = BufferMap(grow_size=5000)
        for i in range(n):
            m.put(i, i)
            if i % 10_000 == 9_999:
                m.garbage_collect(i - 5_000)

    return {"put_ops_per_s": round(_rate(n, puts)),
            "get_ops_per_s": round(_rate(n, gets)),
            "put_gc_ops_per_s": round(_rate(n, put_gc))}


def bench_int_prefix_set(n: int = 200_000) -> dict:
    from frankenpaxos_tpu_torch.compact import IntPrefixSet

    def adds_in_order():
        s = IntPrefixSet()
        for i in range(n):
            s.add(i)

    def adds_scattered():
        s = IntPrefixSet()
        for i in range(0, 2 * n, 2):
            s.add(i)

    a = IntPrefixSet.from_watermark(n)
    b = IntPrefixSet.from_watermark(n // 2)
    for i in range(n // 2, n, 7):
        b.add(i)

    def diffs():
        for _ in range(200):
            list(a.materialized_diff(b))

    diff_items = 200 * len(list(a.materialized_diff(b)))
    return {"add_in_order_ops_per_s": round(_rate(n, adds_in_order)),
            "add_scattered_ops_per_s": round(_rate(n, adds_scattered)),
            "materialized_diff_items_per_s": round(
                _rate(diff_items, diffs))}


def bench_depgraphs(n: int = 20_000, conflict_stride: int = 10) -> dict:
    """EPaxos shape: command i depends on the previous command touching
    its key (i - conflict_stride), committed in order, executed in
    batches (DependencyGraphBench's commit/execute mix)."""
    from frankenpaxos_tpu_torch.depgraph import make_dependency_graph

    out = {}
    for name in ("tarjan", "incremental", "zigzag", "naive"):
        # The naive oracle is quadratic; keep its input small.
        size = n if name != "naive" else n // 20

        def run_sized(name=name, size=size):
            if name == "zigzag":
                # Zigzag keys decompose into (leader, id) vertex ids.
                g = make_dependency_graph(name, num_leaders=1)
                key = (lambda i: (0, i))
            else:
                g = make_dependency_graph(name)
                key = (lambda i: i)
            for i in range(size):
                deps = ([key(i - conflict_stride)]
                        if i >= conflict_stride else [])
                g.commit(key(i), 0, deps)
                if i % 100 == 99:
                    g.execute()
            g.execute()

        out[f"{name}_commit_execute_ops_per_s"] = round(
            _rate(size, run_sized))
    return out


def bench_device_ops(batch: int = 4096, iters: int = 50,
                     device=None) -> dict:
    """The watermark and depset kernels (device twins of QuorumWatermark
    and EPaxos dep sets) at a realistic batch width on ``device``
    (``cuda`` when None). Each run chains ``iters`` calls and
    synchronizes once: a per-call fetch would time the sync, not the
    kernel."""
    from frankenpaxos_tpu_torch.ops.depset import (
        DepSetBatch,
        union,
        union_reduce,
    )
    from frankenpaxos_tpu_torch.ops.quorum import stage
    from frankenpaxos_tpu_torch.ops.watermark import (
        contiguous_prefix_length,
        quorum_watermark,
        quorum_watermark_vector,
    )

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    watermarks = np.random.default_rng(0).integers(
        0, 1 << 20, size=(5, batch)).astype(np.int32)
    quorum_watermark_vector(watermarks, 3, device=dev)  # sync-path check
    # [batch, nodes]: the transposed view of the [nodes, batch] matrix,
    # read in place through its strides.
    watermarks_dev = stage(watermarks, dev).t()

    def watermark_run():
        for _ in range(iters):
            quorum_watermark(watermarks_dev, 3)
        sync()

    present = np.ones(batch, dtype=bool)
    present[batch // 2] = False
    present_dev = stage(present, dev)

    def prefix_run():
        for _ in range(iters):
            contiguous_prefix_length(present_dev)
        sync()

    rng = np.random.default_rng(1)
    leaders, window = 3, 64
    deps = DepSetBatch(
        watermarks=stage(rng.integers(
            0, 1 << 16, size=(batch, leaders)).astype(np.int32), dev),
        tails=stage(rng.integers(
            0, 2, size=(batch, leaders, window)).astype(np.uint8), dev),
        tail_base=torch.tensor(1 << 16, dtype=torch.int32, device=dev))

    def depset_run():
        for _ in range(iters):
            union_reduce(union(deps, deps))
        sync()

    watermark_run()  # warm: build and load the libraries first
    prefix_run()
    depset_run()
    return {
        "quorum_watermark_slots_per_s": round(
            _rate(iters * batch, watermark_run)),
        "contiguous_prefix_slots_per_s": round(
            _rate(iters * batch, prefix_run)),
        "depset_union_reduce_deps_per_s": round(
            _rate(iters * batch, depset_run)),
    }


def bench_serializer(n: int = 50_000) -> dict:
    """Phase2b round trips (encode then decode) per second, through the
    registered binary codec and through pickle, best of 3."""
    import frankenpaxos_tpu_torch.protocols.multipaxos  # noqa: F401 - codecs
    from frankenpaxos_tpu_torch.protocols.multipaxos.messages import Phase2b
    from frankenpaxos_tpu_torch.runtime.serializer import (
        DEFAULT_SERIALIZER,
        PickleSerializer,
    )

    message = Phase2b(group_index=1, acceptor_index=2, slot=123456,
                      round=3)

    def binary():
        s = DEFAULT_SERIALIZER
        for _ in range(n):
            s.from_bytes(s.to_bytes(message))

    def pickled():
        s = PickleSerializer()
        for _ in range(n):
            s.from_bytes(s.to_bytes(message))

    return {"phase2b_binary_roundtrips_per_s": round(_rate(n, binary)),
            "phase2b_pickle_roundtrips_per_s": round(_rate(n, pickled))}


def run(device=None, *, map_ops: int = 200_000, set_ops: int = 200_000,
        graph_ops: int = 20_000, batch: int = 4096, iters: int = 50,
        serializer_ops: int = 50_000) -> dict:
    """The artifact on ``device`` (``cuda`` when None; raises without a
    GPU unless a device is named), with the reference's keys; the sizes
    are the reference's by default."""
    dev = resolve_device(device)
    device_ops = bench_device_ops(batch, iters, dev)
    device_ops["device"] = (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else str(dev))
    device_ops["nvidia_smi"] = (nvidia_smi_line() if dev.type == "cuda"
                                else None)
    return {
        "benchmark": "libbench",
        "buffer_map": bench_buffer_map(map_ops),
        "int_prefix_set": bench_int_prefix_set(set_ops),
        "depgraph": bench_depgraphs(graph_ops),
        "device_ops": device_ops,
        "serializer": bench_serializer(serializer_ops),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--out", default=None,
                        help="also write the artifact here")
    args = parser.parse_args(argv)
    result = run(args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
