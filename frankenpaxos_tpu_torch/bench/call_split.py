"""Host time of the K18 and K12 call paths, split by function, on one GPU.

Each path is the real wrapper or entry, called ``CALLS`` times:

  * ``whole_ns``: host ns per call, one synchronise at the end;
  * ``split_ns``: the same calls under ``cProfile``, each function's own
    time (the time in its body, not in what it calls) in ns per call,
    the largest ``TOP`` by name and the rest summed; ``profiled_ns`` is
    their sum. A C call that ``cProfile`` does not see as a function (a
    ``ctypes`` call, a numpy slice assignment) counts in its caller's
    own time. The profiler adds its own cost to every function it
    times, so the split says where the time goes and ``whole_ns`` what
    a call costs.

Paths (at the main paths' shapes): ``link_keep_mask_tensor`` at n =
32768 over a [1001, 1001] up-matrix (the FIFO arm's wave), and
``quorum_watermark`` on the [2, 3] strided rows of a GC role's [3, 2]
frontier matrix, q = 2; their transport-facing entries
``link_keep_mask_cuda`` at n = 256 (a jitter-free storm wave) and n =
32768, and ``quorum_watermark_vector`` on a [3, 2] int64 matrix, q = 2.
Beside them, host ns per call of the one PyTorch call computing each
function (``up[src, dst]``, ``torch.kthvalue``), of the public forms of
the current stream's handle, and of the wait after a download (the
stream's synchronise against an event's).

It times the calls, not copies of them, so it splits any checkout's
wrappers alike: ``--tree ROOT`` imports ``frankenpaxos_tpu_torch`` from
``ROOT`` (another commit, for an A/B in one call), else from this
checkout. Run from the root of a checkout::

    python frankenpaxos_tpu_torch/bench/call_split.py [--tree ROOT]

It prints ONE JSON line; ``chip_smoke.py``'s phase 28 calls
:func:`split` on its own tree. It raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

import numpy as np
import torch

CALLS = 2000
TOP = 12
ZONES = 1000
WAVES = (256, 32768)
SEED = 20261017


def _whole(fn) -> float:
    """Host ns per call of ``fn()`` over ``CALLS`` calls, unsplit, with
    one synchronise at the end."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / CALLS


def _label(path: str, name: str) -> str:
    """``name`` with the module it is defined in, from the package or
    library directory down (a C function has no file)."""
    if path == "~":
        return name
    parts = path.replace(os.sep, "/").split("/")
    for root in ("frankenpaxos_tpu_torch", "torch", "numpy"):
        if root in parts:
            cut = len(parts) - 1 - parts[::-1].index(root)
            return "/".join(parts[cut:]) + ":" + name
    return os.path.basename(path) + ":" + name


def _split(fn) -> dict:
    """``fn()`` ``CALLS`` times under ``cProfile``: each function's own
    ns per call, the largest ``TOP`` and the rest."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    profile = cProfile.Profile()
    profile.enable()
    for _ in range(CALLS):
        fn()
    profile.disable()
    torch.cuda.synchronize()
    here = os.path.abspath(__file__)
    own: dict = {}
    for (path, _, name), (_, _, tottime, _, _) in \
            pstats.Stats(profile).stats.items():
        if os.path.abspath(path) == here or "_lsprof.Profiler" in name:
            continue
        label = _label(path, name)
        own[label] = own.get(label, 0.0) + tottime * 1e9 / CALLS
    ranked = sorted(own.items(), key=lambda kv: -kv[1])
    split_ns = dict(ranked[:TOP])
    split_ns["(the rest)"] = sum(v for _, v in ranked[TOP:])
    return {"profiled_ns": sum(own.values()), "split_ns": split_ns}


def _inputs():
    rng = np.random.default_rng(SEED)
    up = rng.random((ZONES + 1, ZONES + 1)) >= 0.2
    up[ZONES, :] = True
    up[:, ZONES] = True
    ids = {n: tuple(rng.integers(-1, ZONES, n).astype(np.int32)
                    for _ in range(2)) for n in WAVES}
    frontiers = rng.integers(0, 1 << 14, size=(3, 2))
    return up, ids, frontiers


def _paths(dev, up_np, ids, frontiers) -> dict:
    """``{path: fn}``: each wrapper and entry called as the main paths
    call it."""
    from frankenpaxos_tpu_torch.ops import simwave as tsw, watermark as tw

    src, dst = (torch.from_numpy(a).to(dev) for a in ids[max(WAVES)])
    up = torch.from_numpy(up_np).to(dev)
    w = torch.from_numpy(frontiers.astype(np.int32)).to(dev).t()
    return {
        "link_keep_mask_tensor": lambda: tsw.link_keep_mask_tensor(
            src, dst, up),
        "quorum_watermark": lambda: tw.quorum_watermark(w, 2),
        **{f"link_keep_mask_cuda/n={n}":
           (lambda n=n: tsw.link_keep_mask_cuda(*ids[n], up_np))
           for n in WAVES},
        "quorum_watermark_vector": lambda: tw.quorum_watermark_vector(
            frontiers, 2),
    }


def _library_calls(dev, up_np, ids, frontiers) -> dict:
    """Host ns per call of the one PyTorch call that computes each
    kernel's function at the same shapes (``up[src, dst]`` with in-range
    int64 ids; ``torch.kthvalue``)."""
    up = torch.from_numpy(up_np).to(dev)
    src, dst = (torch.from_numpy(a.astype(np.int64) % (ZONES + 1)).to(dev)
                for a in ids[max(WAVES)])
    w = torch.from_numpy(frontiers.astype(np.int32)).to(dev).t()
    k = w.shape[-1] - 2 + 1
    return {"up[src, dst]": _whole(lambda: up[src, dst]),
            "torch.kthvalue": _whole(
                lambda: torch.kthvalue(w, k, dim=-1))}


def _stream_and_wait(dev) -> dict:
    """Host ns per call of each public stream-handle form, and of the
    wait after a 32 KB download: the stream's synchronise against an
    event recorded after the copy."""
    index = dev.index if dev.index is not None else 0
    forms = {
        "current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(index).cuda_stream,
        "current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "current_device()": torch.cuda.current_device,
    }
    if hasattr(getattr(torch, "accelerator", None), "current_stream") \
            and hasattr(torch.Stream, "native_handle"):
        forms["accelerator.current_stream(index).native_handle"] = \
            lambda: torch.accelerator.current_stream(index).native_handle
    out = {name: _whole(fn) for name, fn in forms.items()}
    src = torch.zeros(32768, dtype=torch.bool, device=dev)
    host = torch.empty(32768, dtype=torch.bool, pin_memory=True)
    event = torch.cuda.Event()
    stream = torch.cuda.current_stream(dev)

    def by_stream():
        host.copy_(src, non_blocking=True)
        stream.synchronize()

    def by_event():
        host.copy_(src, non_blocking=True)
        event.record(stream)
        event.synchronize()

    out["download + stream.synchronize()"] = _whole(by_stream)
    out["download + event.record(); event.synchronize()"] = _whole(by_event)
    return out


def split(device=None) -> dict:
    """Every path's whole time and split on ``device`` (``cuda`` when
    None)."""
    from frankenpaxos_tpu_torch.device import nvidia_smi_line, \
        resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the call split times the CUDA call paths; "
                           f"got device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    up, ids, frontiers = _inputs()
    paths = {name: {"whole_ns": _whole(fn), **_split(fn)}
             for name, fn in _paths(dev, up, ids, frontiers).items()}
    import frankenpaxos_tpu_torch

    return {
        "benchmark": "call_split",
        "package": os.path.dirname(os.path.abspath(
            frankenpaxos_tpu_torch.__file__)),
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": nvidia_smi_line(),
        "calls": CALLS,
        "paths": paths,
        "library_ns": _library_calls(dev, up, ids, frontiers),
        "stream_and_wait_ns": _stream_and_wait(dev),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="import frankenpaxos_tpu_torch from this "
                             "checkout (default: this one)")
    args = parser.parse_args(argv)
    root = args.tree or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(root))
    print(json.dumps(split()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
