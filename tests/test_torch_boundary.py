"""The port's boundaries: it imports neither JAX nor the JAX package
(the package as a whole and each module of the vote path alone),
its entry points refuse to fall back to the CPU silently, its kernel
wrappers never hand a non-CPU tensor to a plain version, and its C
bindings match the CUDA sources."""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap

import frankenpaxos_tpu_torch
from frankenpaxos_tpu_torch.bench import (
    bpaxos_sim,
    depset_lt,
    epaxos_sim,
    multipaxos_sim,
    pipeline as tp,
    tracker_lt,
)
from frankenpaxos_tpu_torch.ops import (
    _build,
    depset as td,
    quorum as tq,
    value as tv,
    watermark as tw,
)
from frankenpaxos_tpu_torch.protocols.epaxos import device_deps
from frankenpaxos_tpu_torch.protocols.epaxos.harness import make_epaxos
from frankenpaxos_tpu_torch.protocols.multipaxos.harness import make_multipaxos
from frankenpaxos_tpu_torch.protocols.multipaxos.quorum_tracker import (
    TpuQuorumTracker,
)
from frankenpaxos_tpu_torch.protocols.simplebpaxos.harness import (
    make_bpaxos,
    make_gc_bpaxos,
)
from frankenpaxos_tpu_torch.quorums import SimpleMajority
from frankenpaxos_tpu_torch.reconfig import EpochQuorumTracker, EpochStore
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.dirname(frankenpaxos_tpu_torch.__file__)


def _port_sources():
    for dirpath, _, filenames in os.walk(PACKAGE):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_imports_with_jax_and_reference_blocked():
    """In a fresh interpreter (this one has JAX loaded already), every
    module of the port imports with ``jax`` and ``frankenpaxos_tpu``
    blocked on ``sys.meta_path``."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys

        BLOCKED = ("jax", "jaxlib", "frankenpaxos_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import frankenpaxos_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            frankenpaxos_tpu_torch.__path__, "frankenpaxos_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print(" ".join(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = set(proc.stdout.split())
    assert {f"frankenpaxos_tpu_torch.{m}" for m in PATH_MODULES} <= imported


#: The modules of the ProxyLeader's vote path, of the MultiPaxos cluster,
#: of the EPaxos dependency-set plane and of the BPaxos watermark plane;
#: each must import with JAX and the JAX package blocked (test above) and
#: name neither.
PATH_MODULES = (
    "ops.quorum", "runtime.transport", "protocols.multipaxos.config",
    "protocols.multipaxos.quorum_tracker", "reconfig.epoch",
    "reconfig.tracker", "bench.tracker_lt", "convert",
    "runtime.actor", "runtime.sim_transport", "ops.value",
    "protocols.multipaxos.acceptor", "protocols.multipaxos.proxy_leader",
    "protocols.multipaxos.leader", "protocols.multipaxos.replica",
    "protocols.multipaxos.client", "protocols.multipaxos.harness",
    "bench.multipaxos_sim", "compact", "clienttable", "depgraph",
    "depgraph.zigzag", "ops.depset", "runs.depruns",
    "protocols.epaxos.instance_prefix_set", "protocols.epaxos.messages",
    "protocols.epaxos.device_deps", "protocols.epaxos.replica",
    "protocols.epaxos.client", "protocols.epaxos.harness",
    "bench.epaxos_sim", "bench.depset_lt", "ops.watermark",
    "utils.watermark", "sim", "sim.simulator",
    "protocols.simplebpaxos.messages", "protocols.simplebpaxos.roles",
    "protocols.simplebpaxos.replica", "protocols.simplebpaxos.harness",
    "protocols.simplegcbpaxos", "bench.bpaxos_sim",
)


def test_vote_path_modules_import_alone():
    """Each module of the vote path, imported ALONE (every module of the
    port dropped from ``sys.modules`` before it) with ``jax`` and
    ``frankenpaxos_tpu`` blocked, loads neither."""
    script = textwrap.dedent(f"""
        import importlib, sys

        BLOCKED = ("jax", "jaxlib", "frankenpaxos_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        for module in {PATH_MODULES!r}:
            for loaded in [m for m in sys.modules
                           if m.startswith("frankenpaxos_tpu_torch")]:
                del sys.modules[loaded]
            importlib.import_module("frankenpaxos_tpu_torch." + module)
            leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
            assert not leaked, (module, leaked)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_reference_imports_in_the_port():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "frankenpaxos_tpu"):
                    offenders.append(f"{path}:{node.lineno} {name}")
    assert not offenders, offenders


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = SimpleMajority(range(3)).write_spec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_state(1024, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.make_vote_board(1024, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.TpuQuorumChecker(spec, window=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.EpochSegmentedChecker([spec], [0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.MultiConfigQuorumChecker([spec])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.reshape_block(np.zeros((3, 4), np.uint8), (0, 1, 2), (0, 1))
    config = tracker_lt.make_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuQuorumTracker(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EpochQuorumTracker(EpochStore.from_members(("a", "b", "c"), f=1),
                           backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tracker_lt.run()
    for backends in ({"quorum_backend": "cuda"}, {"phase1_backend": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_multipaxos(f=1, **backends)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multipaxos_sim.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_epaxos(f=2, dep_backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_deps.to_batch([], 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        epaxos_sim.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        depset_lt.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_bpaxos(dep_backend="cuda")
    for backends in ({"dep_backend": "cuda"}, {"gc_backend": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_gc_bpaxos(**backends)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.quorum_watermark_vector(np.zeros((3, 2), np.int64), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bpaxos_sim.run()
    # Naming the CPU explicitly is the only way to the plain versions.
    assert tp.make_state(1024, 3, device="cpu").votes.device.type == "cpu"


def test_headline_refuses_off_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "frankenpaxos_tpu_torch.bench.headline"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["degraded"] is True
    assert "value" not in out and "vs_baseline" not in out


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: a
    ``meta`` tensor (neither CPU nor CUDA) must raise, never reach the
    plain version."""
    spec = SimpleMajority(range(3)).write_spec()
    pred = tq.make_predicate(*spec.as_arrays(), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tq.quorum_hit(torch.zeros((3, 64), dtype=torch.uint8,
                                  device="meta"), pred)
    board = tq.make_vote_board(256, 3, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tq.record_block(board, 0, 0, torch.zeros(
            (3, 64), dtype=torch.uint8, device="meta"), 0, pred)
    with pytest.raises(ValueError, match="meta"):
        tp.steady_state_step(tp.make_state(512, 3, device="meta"), 0,
                             block_size=256, predicate=pred)
    # Mixed devices are refused too.
    cpu_pred = tq.make_predicate(*spec.as_arrays(), device="cpu")
    with pytest.raises(ValueError):
        tq.quorum_hit(torch.zeros((3, 64), dtype=torch.uint8,
                                  device="meta"), cpu_pred)
    # The sparse, release, epoch and reshape wrappers too.
    lanes = torch.zeros((5, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tq.record_and_check(board, lanes, pred)
    with pytest.raises(ValueError, match="meta"):
        tq.release(board, torch.zeros(4, dtype=torch.int32, device="meta"),
                   torch.ones(4, dtype=torch.bool, device="meta"))
    planes = tq.make_multi_predicate(np.ones((2, 1, 3)), np.ones((2, 1)),
                                     np.ones(2, bool), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tq.check_batch_multi(
            torch.zeros((8, 3), dtype=torch.int32, device="meta"),
            torch.zeros(8, dtype=torch.int32, device="meta"), planes)
    with pytest.raises(ValueError, match="meta"):
        tq.record_and_check_epochs(
            board, lanes, torch.zeros(1, dtype=torch.int32, device="meta"),
            planes)
    with pytest.raises(ValueError, match="meta"):
        tq.reshape_columns(torch.zeros((3, 8), dtype=torch.uint8,
                                       device="meta"),
                           torch.zeros(4, dtype=torch.int32, device="meta"))
    # A CPU board with a CUDA-less mix is refused as well.
    with pytest.raises(ValueError):
        tq.record_and_check(tq.make_vote_board(256, 3, device="cpu"), lanes,
                            cpu_pred)
    meta = torch.zeros((8, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tv.safe_values(meta, meta)
    batch = td.DepSetBatch(
        torch.zeros((2, 3), dtype=torch.int32, device="meta"),
        torch.zeros((2, 3, 8), dtype=torch.uint8, device="meta"),
        torch.zeros((), dtype=torch.int32, device="meta"))
    for wrapper in (td.normalized, td.union_reduce, td.all_equal):
        with pytest.raises(ValueError, match="meta"):
            wrapper(batch)
    with pytest.raises(ValueError, match="meta"):
        td.conflict_max(meta[:, 0], batch)
    with pytest.raises(ValueError, match="meta"):
        tw.quorum_watermark(meta, 2)
    with pytest.raises(ValueError, match="meta"):
        tw.contiguous_prefix_length(meta)
    launches = [tq.quorum_hit, tq.record_block, tp.steady_state_step,
                tq.record_and_check, tq.release, tq.check_batch_multi,
                tq.record_and_check_epochs, tq.reshape_columns,
                tv.safe_values, td.normalized, td.union_reduce,
                td.conflict_max, td.all_equal, tw.quorum_watermark,
                tw.contiguous_prefix_length]
    assert [f.launches for f in launches] == [0] * len(launches)


def test_c_bindings_match_the_cuda_sources():
    """Every entry point in ``_build.SIGNATURES`` is defined in its
    source with as many parameters as its ctypes argtypes, so a binding
    cannot drift from the kernel while no compiler is at hand."""
    for name, entries in _build.SIGNATURES.items():
        with open(os.path.join(_build.CSRC, f"{name}.cu"),
                  encoding="utf-8") as f:
            source = f.read()
        for entry, argtypes in entries.items():
            m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                          source)
            assert m, (name, entry)
            params = [p for p in m.group(1).split(",") if p.strip()]
            assert len(params) == len(argtypes), (entry, params)
            pointer = [("*" in p) for p in params]
            assert pointer == [t is _build._P for t in argtypes], entry
    # Nothing is built at import time.
    assert not _build.library.cache_info().currsize


def test_build_target_tracks_the_sources():
    a = _build._target("quorum")
    assert a == _build._target("quorum")
    assert a != _build._target("pipeline")
    assert os.path.dirname(a) == _build.BUILD_DIR


def test_int32_arguments_are_range_checked():
    assert tq.int32(2**31 - 1) == 2**31 - 1
    with pytest.raises(OverflowError):
        tq.int32(2**31)
    checker = tq.TpuQuorumChecker(SimpleMajority(range(3)).write_spec(),
                                  window=64, device="cpu")
    with pytest.raises(OverflowError):
        checker.record_block(2**31, np.ones((3, 1), dtype=np.uint8))
