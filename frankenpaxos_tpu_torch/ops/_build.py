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
``cudaGetLastError()``; :func:`check` raises when that is not 0. The
exceptions are the ``*_staged`` entry points, which run a
transport-facing or tracker call whole (copy up, launch, copy down) and
return after the stream has drained (:class:`Staging` says which
stream), and K2's staged run and the pipelined drain's staged run (K2
and K4), which record an event instead of waiting (their caller waits on
the event when it collects).

The lean call path (:class:`Entry`, :func:`stream_handle`) serves the
wrappers whose host cost is the call itself (K1, K2, K4-K8 with K6's
stateless ``check_batch_multi``, K10, K11, K12, K13, K16's union, K18,
K19-K21, and the drain runs of K3, K14 and the pinned copy): the entry
point
is looked up once; its arguments cross as ONE packed block of int64
(``struct`` bytes), which ctypes converts once instead of one argument
at a time; a launch-only entry is called through a ``ctypes.PyDLL``
handle (it keeps the GIL, which a call that only enqueues does not need
to give up), a staged entry through a ``ctypes.CDLL`` handle (it waits
for its stream, and other Python threads run meanwhile); and the stream
handle is read in the cheapest public form, on every call, so that a
launch follows a caller's ``with torch.cuda.stream(s):``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import time
from typing import NamedTuple

from frankenpaxos_tpu_torch.device import resolve_device
import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: ``--split-compile=0`` optimises a source's kernels on every core: the
#: drain's one instantiation per board structure (``pipeline.cu``) builds
#: in well under half the time.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: One packed block of int64 arguments (``struct`` bytes, which
#: ``c_void_p`` passes as a pointer to their buffer; see :class:`Entry`).
_B = [_P]
# The shared quorum predicate (csrc/quorum.cuh): masks, thresholds and
# perm pointers, then n, g, combine_any, grid_kind, rows, cols.
_PRED = [_P, _P, _P, _I, _I, _I, _I, _I, _I]

#: ``{source: {entry point: argtypes}}``; the last two arguments of
#: every entry point are the device index and the stream.
SIGNATURES = {
    "quorum": {
        # packed: votes, row_stride, col_stride, b, out, the predicate
        # (masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
        # cols), device, stream
        "fpx_quorum_hit": _B,
        # packed: pinned votes [n, b], their device copy, b, device out,
        # pinned out, the predicate, device, stream
        "fpx_quorum_hit_staged": _B,
        # packed: votes, rounds, chosen, owner, window, n, the host table
        # [nb, 6], nb, the staged block [n, stride] (device), stride,
        # newly (device), perm identity, the predicate, device, stream
        "fpx_record_block_run": _B,
        # packed: the board (6), the host table, nb, the pinned in-block
        # (held slots, then the staged block), its device copy, held
        # slots, block offset, stride, device newly, pinned newly, bytes
        # of newly, perm identity, the predicate, event, device, stream
        "fpx_record_block_run_staged": _B,
        # packed: the board (6), lanes [5, stride] (device), stride, the
        # host chunk bounds, nchunks, newly (device), perm identity, the
        # predicate, device, stream
        "fpx_record_and_check_run": _B,
        # packed: the board (6), perm identity, the predicate, the host
        # segment table, nseg, the host K2 table, nb, the host chunk
        # bounds, nchunks, the pinned in-block, its device copy, held
        # slots, dense offset, stride, lanes offset, lanes, device out,
        # pinned out, the lanes' newly offset, bytes of out, event,
        # device, stream
        "fpx_board_run_staged": _B,
        # packed: device, the address of the int64 handle / the event
        "fpx_event_create": _B,
        "fpx_event_wait": _B,
        "fpx_event_destroy": _B,
    },
    "sparse": {
        # packed: votes, rounds, chosen, owner, window, n, slots, valid,
        # b, device, stream
        "fpx_release": _B,
        # packed: the board (6), slots, r, device, stream
        "fpx_release_all": _B,
        # packed: the board (6), pinned slots, their device copy, r,
        # device, stream
        "fpx_release_staged": _B,
    },
    "epoch": {
        # packed: rows, row stride, col stride, b, n, config indices (or
        # 0), out, flags (1 packed words, 2 mapped), the planes' host
        # cells (or 0) and their count, the planes on the card (masks,
        # thresholds, any), k, g, the pinned block (mapped), device,
        # stream
        "fpx_check_batch_multi_staged": _B,
        # packed: votes, rounds, chosen, owner, window, n, lanes [5, b],
        # b, chunk, boundaries, nb, newly, masks, thresholds, combine_any,
        # k, g, device, stream
        "fpx_record_and_check_epochs": _B,
        # packed: the same, then the pinned lanes (and the held released
        # slots after them), the pinned newly, the held slots' count
        "fpx_record_and_check_epochs_staged": _B,
        # packed: block, n_old, b, n_new, out, the map on the card (or 0:
        # the map's n_new int32 follow the block), device, stream
        "fpx_reshape_columns": _B,
        # the longest map the packed block may carry
        "fpx_reshape_columns_map_max": [],
    },
    "value": {
        # packed: vote_rounds, value_ids, s, n, has_vote, value_id,
        # device, stream
        "fpx_safe_values": _B,
        # packed: the pinned block (rounds, ids, then value_id and
        # has_vote), rows, n, device, stream; the kernel reads and
        # writes it in place
        "fpx_safe_values_staged": _B,
        # reply ids, valid, s, n, modal id, count
        "fpx_count_matching_replies": [_P, _P, _L, _I, _P, _P, _I, _P],
    },
    "depset": {
        # watermarks, tails, tail_base, rows (B * L), width, out_wm,
        # out_tails
        "fpx_depset_normalized": [_P, _P, _P, _L, _I, _P, _P, _I, _P],
        # packed: watermarks, tails, tail_base, b, l, width, seqs (or 0),
        # s, out_wm, out_tails, out_seq (or 0), device, stream
        "fpx_depset_union_reduce": _B,
        # packed: watermarks, tails, tail_base, b, l, width, out (one
        # bool byte), device, stream
        "fpx_depset_all_equal": _B,
        # packed: pinned input block, its device copy, its bytes, pinned
        # output block, its device copy, its bytes, b, l, width, s, the
        # input offsets of seqs, watermarks, base and tails, the output
        # offsets of seq, watermarks and tails, device, stream
        "fpx_depset_union_staged": _B,
        # packed: pinned input block, its device copy, its bytes, pinned
        # answer byte, its device copy, b, l, width, the input offsets of
        # watermarks, base and tails, device, stream
        "fpx_depset_all_equal_staged": _B,
        # packed: a watermarks, a tails, b watermarks, b tails, out
        # watermarks, out tails, a's tail_base, out's tail_base (or 0),
        # rows (B * L), width, aliased, device, stream
        "fpx_depset_union": _B,
        # mode (1 intersect, 2 compact), a watermarks, a tails,
        # b watermarks, b tails (or NULL), executed (or NULL), its two
        # strides, tail_base, b, l, width, out_wm, out_tails
        "fpx_depset_pair": [_I, _P, _P, _P, _P, _P, _L, _L, _P, _I, _I, _I,
                            _P, _P, _I, _P],
        # mode (0 equal, 1 size, 2 contains), a watermarks, a tails,
        # b watermarks, b tails (or NULL), leader (or NULL), its stride,
        # vid (or NULL), its stride, tail_base, b, l, width, out
        "fpx_depset_query": [_I, _P, _P, _P, _P, _P, _L, _P, _L, _P, _I, _I,
                             _I, _P, _I, _P],
    },
    "watermark": {
        # packed: watermarks, rows, n, row_stride, elem_stride, quorum
        # sizes (or 0), quorum size, out, device, stream
        "fpx_quorum_watermark": _B,
        # packed: pinned [n, depth] int32, its device copy, n, depth,
        # quorum size, device out [depth], pinned out [depth], device,
        # stream
        "fpx_quorum_watermark_staged": _B,
        # packed: present, elem_kind, rows, length, row_stride,
        # elem_stride, out, device, stream; the form query reads the
        # same block and launches nothing
        "fpx_contiguous_prefix_length": _B,
        "fpx_contiguous_prefix_form": _B,
    },
    "pipeline": {
        # packed: votes, chosen, commands, results, sm_state, committed,
        # exec_wm, window, block_size, start, iters, masks, thresholds,
        # perm, n, g, combine_any, grid_kind, rows, cols, telemetry buffer
        # (0 for K3), scratch (0 for K3), device, stream
        "fpx_run_steps": _B,
        "fpx_run_steps_telemetry": _B,
    },
    "simwave": {
        # packed: src zones, dst zones, n, up, rows, cols, out, device,
        # stream
        "fpx_link_keep_mask": _B,
        # packed: pinned ids (src, then dst at an offset), their device
        # copy, n, dst offset, up, rows, cols, device mask, pinned mask,
        # device, stream
        "fpx_link_keep_mask_staged": _B,
    },
    # The pinned telemetry-off drain: fpx_run_steps's packed block.
    "pipeline_baseline": {
        "fpx_run_steps_baseline": _B,
    },
    # The sharded drain on one shard of a (group, slot) mesh.
    "pipeline_sharded": {
        # packed: votes, commands, w_local, i, block_size, b_local,
        # slot_idx, group_idx, n_local, kind, g, cols, local masks,
        # telemetry, parts, form, device, stream
        "fpx_shard_vote_count": _B,
        # packed: votes, chosen, commands, results, w_local, i,
        # block_size, b_local, slot_idx, slot_shards, n_local, n_global,
        # kind, g, thresholds, combine_any, telemetry, parts, the drain's
        # row of the slot table, device, stream
        "fpx_shard_commit": _B,
        # packed: sm_state, committed, exec_wm, i, k, block_size,
        # slot_shards, n_global, the slot table, telemetry buffer (or 0),
        # device, stream
        "fpx_shard_fold": _B,
    },
    # The pinned sharded drain (the telemetry-off K19-K21 copies).
    "pipeline_sharded_baseline": {
        # votes, commands, w_local, i, block_size, b_local, slot_idx,
        # group_idx, n_local, kind, g, cols, local masks, parts
        "fpx_shard_vote_count_baseline": [_P, _P, _L, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _P, _P, _I, _P],
        # votes, chosen, commands, results, w_local, i, block_size,
        # b_local, slot_idx, slot_shards, n_local, kind, g, thresholds,
        # combine_any, parts, slot_buf
        "fpx_shard_commit_baseline": [_P, _P, _P, _P, _L, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _P, _I, _P, _P, _I,
                                      _P],
        # sm_state, committed, exec_wm, i, block_size, slot_shards,
        # slot_buf
        "fpx_shard_fold_baseline": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
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
    when a build fails. Processes that build at once (the ranks of a
    sharded run) take turns on a lock file, so the second finds the
    first one's libraries."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_missing()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing() -> float:
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


@functools.cache
def packed_library(name: str, keep_gil: bool) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library (built first if needed) with its
    packed entry points declared, through a ``PyDLL`` handle (calls keep
    the GIL) when ``keep_gil``, else a ``CDLL`` one (calls release it)."""
    library(name)
    lib = (ctypes.PyDLL if keep_gil else ctypes.CDLL)(_target(name))
    for fn, argtypes in SIGNATURES[name].items():
        if argtypes is _B:
            entry = getattr(lib, fn)
            entry.argtypes = argtypes
            entry.restype = ctypes.c_int
    return lib


class Entry:
    """One packed C entry point of ``csrc/<source>.cu``, looked up once:
    ``fn`` is None until :meth:`resolve` (which builds and loads the
    library at the first launch), then the ``ctypes`` function itself,
    called as ``fn(entry.pack(*slots))`` with its ``slots`` int64
    arguments (0 for a null pointer). ``keep_gil`` is False for an entry
    that waits on the device, so that other threads run while it waits."""

    __slots__ = ("source", "name", "fn", "pack", "keep_gil")

    def __init__(self, source: str, name: str, slots: int,
                 keep_gil: bool = True):
        self.source, self.name, self.fn = source, name, None
        self.pack = struct.Struct(f"={slots}q").pack
        self.keep_gil = keep_gil

    def resolve(self):
        self.fn = getattr(packed_library(self.source, self.keep_gil),
                          self.name)
        return self.fn

    def check(self, rc: int) -> None:
        """Raise when the call reported a CUDA error."""
        check(self.source, self.name, rc)


class Pair(NamedTuple):
    """A pinned host buffer and a device buffer of ``cap`` elements, the
    host one's numpy view, and both pointers (``device_ptr`` 0 for a
    pinned buffer alone, which a kernel reads and writes in place)."""

    cap: int
    host: np.ndarray
    host_ptr: int
    device_ptr: int
    tensors: tuple


class Staging:
    """One device's staging for a staged call, reused across calls:
    named pinned-host / device buffer pairs, each grown to a power of two
    on demand, and a stream of its own. A staged C call drains the stream
    it ran on before it returns, so a buffer is free again when the next
    call writes it. The transport-facing calls (K12, K18), the EPaxos
    / BPaxos decisions (K10, K11) and the Leader's recovery (K8), whose
    inputs all come from the host, run on this stream and so wait for their own work only, not for a
    caller's queued work; the tracker calls (K1,
    K6), which read state on the card, run on PyTorch's current stream,
    behind the work that made that state."""

    def __init__(self, device: torch.device):
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self.index = device, device.index
        self.stream = torch.cuda.Stream(device)
        self.stream_handle = self.stream.cuda_stream
        self.pairs: dict = {}

    def pair(self, name: str, n: int, dtype: torch.dtype,
             on_card: bool = True) -> Pair:
        """The pair ``name`` of at least ``n`` elements; with
        ``on_card=False``, its pinned buffer alone."""
        got = self.pairs.get(name)
        if got is None or got.cap < n:
            cap = 1 << max(5, (n - 1).bit_length())
            host = torch.empty(cap, dtype=dtype, pin_memory=True)
            device = (torch.empty(cap, dtype=dtype, device=self.device)
                      if on_card else None)
            got = self.pairs[name] = Pair(
                cap, host.numpy(), host.data_ptr(),
                0 if device is None else device.data_ptr(), (host, device))
        return got


def staging(table: dict, device, make=Staging):
    """``table``'s staging for ``device``, made by ``make(dev)`` at its
    first call, or None where ``device`` resolves to the CPU (which
    raises when ``device`` is None and there is no GPU). ``device=None``
    is the current card, looked up on every call; a named device is
    resolved at its first call."""
    key = device
    if device is None and torch.cuda.is_initialized():
        key = torch.cuda.current_device()
    got = table.get(key)
    if got is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            return None
        got = make(dev)
        table[got.index if device is None else device] = got
    return got


def stream_handle(index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device
    ``index`` (``with torch.cuda.stream(s):`` included), read on every
    call: through ``torch.accelerator``, which builds no Python-level
    stream object (``bench/call_split.py`` times the public forms)."""
    return torch.accelerator.current_stream(index).native_handle


def check(name: str, entry: str, rc: int) -> None:
    """Raise when a kernel's launch reported a CUDA error."""
    if rc != 0:
        msg = library(name).fpx_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
