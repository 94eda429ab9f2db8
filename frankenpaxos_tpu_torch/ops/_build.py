"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which is loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Every source
is compiled at first use, all in parallel, into ``ops/_build/`` (listed
in ``.gitignore``) under a name that carries a digest of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.
Nothing is built at import time.

Each C entry point takes every pointer and the stream as ``void*``,
launches on the caller's stream, never synchronises, and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The shared quorum predicate (csrc/quorum.cuh): masks, thresholds and
# perm pointers, then n, g, combine_any, grid_kind, rows, cols.
_PRED = [_P, _P, _P, _I, _I, _I, _I, _I, _I]

#: ``{source: {entry point: argtypes}}``; the last two arguments of
#: every entry point are the device index and the stream.
SIGNATURES = {
    "quorum": {
        # votes, row_stride, col_stride, b, out, *pred
        "fpx_quorum_hit": [_P, _L, _L, _I, _P, *_PRED, _I, _P],
        # votes, rounds, chosen, owner, window, block, b, start,
        # true_start, vote_round, newly, *pred
        "fpx_record_block": [_P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _P,
                             *_PRED, _I, _P],
    },
    "sparse": {
        # votes, rounds, chosen, owner, window, lanes [5, b], b, newly,
        # scratch [2, b], *pred
        "fpx_record_and_check": [_P, _P, _P, _P, _L, _P, _I, _P, _P,
                                 *_PRED, _I, _P],
        # votes, rounds, chosen, owner, window, n, slots, valid, b
        "fpx_release": [_P, _P, _P, _P, _L, _I, _P, _P, _I, _I, _P],
    },
    "epoch": {
        # present, row_stride, col_stride, b, config_idx, out, masks,
        # thresholds, combine_any, k, g, n
        "fpx_check_batch_multi": [_P, _L, _L, _I, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _P],
        # votes, rounds, chosen, owner, window, lanes, b, boundaries, nb,
        # newly, scratch, masks, thresholds, combine_any, k, g, n
        "fpx_record_and_check_epochs": [_P, _P, _P, _P, _L, _P, _I, _P, _I,
                                        _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _P],
        # block, n_old, b, cmap, n_new, out
        "fpx_reshape_columns": [_P, _I, _L, _P, _I, _P, _I, _P],
    },
    "value": {
        # vote_rounds, value_ids, s, n, has_vote, value_id
        "fpx_safe_values": [_P, _P, _L, _I, _P, _P, _I, _P],
    },
    "depset": {
        # watermarks, tails, tail_base, rows (B * L), width, out_wm,
        # out_tails
        "fpx_depset_normalized": [_P, _P, _P, _L, _I, _P, _P, _I, _P],
        # watermarks, tails, tail_base, b, l, width, seqs (or NULL), s,
        # out_wm, out_tails, out_seq (or NULL)
        "fpx_depset_union_reduce": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P,
                                    _P, _I, _P],
        # watermarks, tails, tail_base, b, l, width, out (one bool byte)
        "fpx_depset_all_equal": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    },
    "watermark": {
        # watermarks, rows, n, row_stride, elem_stride, quorum sizes (or
        # NULL), quorum size, out
        "fpx_quorum_watermark": [_P, _L, _I, _L, _L, _P, _I, _P, _I, _P],
        # present, elem_kind, rows, length, row_stride, elem_stride, out
        "fpx_contiguous_prefix_length": [_P, _I, _L, _L, _L, _L, _P, _I,
                                         _P],
    },
    "pipeline": {
        # votes, chosen, commands, results, sm_state, committed,
        # exec_wm, window, block_size, i, *pred
        "fpx_steady_state_step": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                                  *_PRED, _I, _P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                digest.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build() -> float:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns the wall seconds spent (0 when
    every library was already built); raises with the compiler's output
    when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = None
    jobs = []
    try:
        for name in SIGNATURES:
            target = _target(name)
            if os.path.exists(target):
                continue
            nvcc = nvcc or _nvcc()
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, target))
        failed = []
        for name, proc, tmp, target in jobs:
            log, _ = proc.communicate()
            with open(target + ".log", "w", encoding="utf-8") as f:
                f.write(log)
            if proc.returncode:
                failed.append(f"nvcc {name}.cu failed:\n{log}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return time.perf_counter() - t0 if jobs else 0.0


def build_log(name: str) -> str:
    """The compiler's output (with ``-Xptxas=-v`` resource usage) of the
    current build of ``name``."""
    with open(_target(name) + ".log", encoding="utf-8") as f:
        return f.read()


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    with ``argtypes``/``restype`` declared for every entry point."""
    build()
    lib = ctypes.CDLL(_target(name))
    for fn, argtypes in SIGNATURES[name].items():
        entry = getattr(lib, fn)
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    lib.fpx_error_string.argtypes = [ctypes.c_int]
    lib.fpx_error_string.restype = ctypes.c_char_p
    return lib


def stream_args(device: torch.device) -> tuple:
    """``(device index, stream handle)`` for a launch on PyTorch's
    current stream of ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


def check(name: str, entry: str, rc: int) -> None:
    """Raise when a kernel's launch reported a CUDA error."""
    if rc != 0:
        msg = library(name).fpx_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
