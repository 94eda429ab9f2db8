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
    geo_lt,
    libbench,
    multichip,
    multichip_board,
    multichip_lt,
    multipaxos_sim,
    pipeline as tp,
    pipeline_baseline as tpin,
    reconfig_sim,
    sim_core_ab,
    telemetry_overhead,
    tracker_lt,
)
from frankenpaxos_tpu_torch.geo import GeoQuorumTracker, ObjectEpochStore
from frankenpaxos_tpu_torch.mesh import Mesh, rank_device
from frankenpaxos_tpu_torch.ops import (
    _build,
    depset as td,
    quorum as tq,
    simwave as tsw,
    telemetry as ttel,
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
from frankenpaxos_tpu_torch.protocols.wpaxos.harness import make_wpaxos
from frankenpaxos_tpu_torch.quorums import SimpleMajority, ZoneGrid
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
#: of the EPaxos dependency-set plane, of the BPaxos watermark plane, of
#: the telemetry plane and its benches, of WPaxos over the geo simulator,
#: of the sharded drain (the mesh, the rank worker that spawned ranks
#: import, its bench and the lane router), of the sharded vote board
#: (its rank cases), of the WAL and the reconfiguration wire codecs
#: with the reconfigured cluster's bench, and of admission control and
#: the ingest fabric (the serving tier, the ingest plane, the routing
#: ladder, the TCP transport and the supernode); each must import with
#: JAX and the JAX package blocked (test above) and name neither.
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
    "protocols.simplegcbpaxos", "bench.bpaxos_sim", "ops.telemetry",
    "obs.telemetry", "bench.pipeline", "bench.pipeline_baseline",
    "bench.telemetry_overhead", "bench.libbench", "ops.simwave", "geo",
    "geo.topology", "geo.transport", "geo.epochs", "geo.rtt",
    "geo.quorum", "protocols.wpaxos", "protocols.wpaxos.config",
    "protocols.wpaxos.messages", "protocols.wpaxos.acceptor",
    "protocols.wpaxos.leader", "protocols.wpaxos.replica",
    "protocols.wpaxos.client", "protocols.wpaxos.harness",
    "bench.geo_lt", "bench.sim_core_ab", "mesh", "bench.multichip",
    "bench.multichip_lt", "ingest", "ingest.shard", "bench.multichip_board",
    "wal", "wal.records", "wal.log", "wal.faults", "wal.role", "reconfig",
    "reconfig.messages", "reconfig.wire", "runs.records",
    "bench.reconfig_sim", "serve", "serve.admission", "serve.lanes",
    "ingest.messages", "ingest.wire", "ingest.columns", "ingest.fan",
    "ingest.batcher", "runs.routing", "runs.client",
    "runtime.tcp_transport", "protocols.multipaxos.supernode",
    "bench.transport_lt",
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
        make_multipaxos(f=1, epoch_quorums=True, wal=True,
                        quorum_backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reconfig_sim.run()
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_state(1024, 3, telemetry=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttel.make_telemetry(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpin.make_state(1024, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry_overhead.run(smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        libbench.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsw.link_keep_mask_cuda(np.zeros(40, np.int32),
                                np.zeros(40, np.int32), np.ones((3, 3), bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GeoQuorumTracker(ObjectEpochStore(1, [0]), 0,
                         ZoneGrid([[0, 1, 2]]), backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_wpaxos(quorum_backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        geo_lt.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_core_ab.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip_lt.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device("cuda", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.RankWorld(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.dryrun(2)
    # The sharded vote board: a mesh on the card raises with no GPU; a
    # mesh made on the CPU (``device_type="cpu"``) is the only way to the
    # plain versions.
    card = Mesh(1, 1, 0, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuQuorumTracker(config, mesh=card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuQuorumTracker(config, pipelined=True, mesh=card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.TpuQuorumChecker(spec, window=1024, mesh=card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.EpochSegmentedChecker([spec], [0], mesh=card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.make_vote_board(1024, 3, mesh=card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GeoQuorumTracker(ObjectEpochStore(1, [0]), 0,
                         ZoneGrid([[0, 1, 2]]), backend="cuda", mesh=card)
    host = TpuQuorumTracker(config, mesh=Mesh(1, 1, 0, torch.device("cpu")))
    assert host.checker.board.votes.device.type == "cpu"
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
    # K14, the pinned K3 copy, K15, K16 and K17.
    with pytest.raises(ValueError, match="meta"):
        tp.steady_state_step(tp.make_state(512, 3, telemetry=True,
                                           device="meta"), 0,
                             block_size=256, predicate=pred)
    with pytest.raises(ValueError, match="meta"):
        tpin.steady_state_step(tpin.make_state(512, 3, device="meta"), 0,
                               block_size=256, predicate=pred)
    with pytest.raises(ValueError, match="meta"):
        tv.count_matching_replies(meta, torch.zeros(
            (8, 3), dtype=torch.bool, device="meta"))
    for wrapper in (td.union, td.intersect, td.equal):
        with pytest.raises(ValueError, match="meta"):
            wrapper(batch, batch)
    with pytest.raises(ValueError, match="meta"):
        td.size(batch)
    with pytest.raises(ValueError, match="meta"):
        td.compact(batch, np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="meta"):
        td.contains(batch, 0, 5)
    # K18.
    zone_ids = torch.zeros(40, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tsw.link_keep_mask_tensor(zone_ids, zone_ids, torch.ones(
            (3, 3), dtype=torch.bool, device="meta"))
    # K19-K21, on one shard of a mesh on the meta device.
    mesh = Mesh(1, 1, 0, torch.device("meta"))
    shard, _ = tp.make_sharded_state(mesh, 512, 256, 3)
    plan = tp.make_shard_plan(mesh, 256, pred)
    for wrapper in (tp.shard_vote_count, tp.shard_commit, tp.shard_fold):
        with pytest.raises(ValueError, match="meta"):
            wrapper(shard, 0, plan)
    # The pinned mesh form's K19-K21 copies.
    pinned, _ = tpin.make_sharded_state(mesh, 512, 256, 3)
    pinned_plan = tpin.make_shard_plan(mesh, 256, pred)
    for wrapper in (tpin.shard_vote_count, tpin.shard_commit,
                    tpin.shard_fold):
        with pytest.raises(ValueError, match="meta"):
            wrapper(pinned, 0, pinned_plan)
    # The sharded board's forms hand the local board to K2, K4 and K5.
    sharded_board = tq.make_vote_board(256, 3, mesh=mesh)
    with pytest.raises(ValueError, match="meta"):
        tq.record_block_sharded(sharded_board, mesh, 0, 0,
                                np.ones((3, 64), np.uint8), 0, pred)
    with pytest.raises(ValueError, match="meta"):
        tq.record_and_check_sharded(sharded_board, mesh, tq.pack_lanes(
            [1], [1], [0], [0], [True]), pred)
    with pytest.raises(ValueError, match="meta"):
        tq.release_sharded(sharded_board, mesh, [1], [True])
    launches = [tq.quorum_hit, tq.record_block, tp.steady_state_step,
                tq.record_and_check, tq.release, tq.check_batch_multi,
                tq.record_and_check_epochs, tq.reshape_columns,
                tv.safe_values, td.normalized, td.union_reduce,
                td.conflict_max, td.all_equal, tw.quorum_watermark,
                tw.contiguous_prefix_length, tp.telemetry_drain,
                tpin.steady_state_step, tv.count_matching_replies,
                td.union, td.intersect, td.compact, td.equal, td.size,
                td.contains, tsw.link_keep_mask_tensor,
                tp.shard_vote_count, tp.shard_commit, tp.shard_fold,
                tpin.shard_vote_count, tpin.shard_commit, tpin.shard_fold]
    assert [f.launches for f in launches] == [0] * len(launches)


def test_spawned_rank_worker_loads_no_jax():
    """The rank worker that a sharded run spawns (``bench/multichip.py``)
    starts from a fresh interpreter and loads the port alone: never
    ``jax`` nor the JAX package, though this process holds both -- also
    after it has run the sharded vote board's cases (a tracker replay,
    the pinned mesh form)."""
    with multichip.RankWorld(2, device_type="cpu") as world:
        assert world.backend == "gloo"
        for modules in world.call("modules", deadline_s=60):
            assert not {"jax", "jaxlib", "frankenpaxos_tpu"} & set(modules)
            assert "frankenpaxos_tpu_torch" in modules
        config = tracker_lt.make_config()
        drains = tracker_lt.make_stream(1 << 10, 3, drain=256)
        reports = multichip_board.same_on_every_rank(world.call(
            "tracker_replay", group=1, slot=2, config=config, window=1 << 10,
            pipelined=True, drains=drains))
        assert sum(map(len, reports)) == 1 << 10
        spec = SimpleMajority(range(3)).write_spec().as_arrays()
        world.call("pinned_drain", group=1, slot=2, window=512, block=128,
                   spec=spec, iters=3)
        for modules in world.call("modules", deadline_s=60):
            assert not {"jax", "jaxlib", "frankenpaxos_tpu"} & set(modules)
    with pytest.raises(ValueError, match="not in the port"):
        multichip._case("os:system")


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
