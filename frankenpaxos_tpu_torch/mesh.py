"""A ``(group, slot)`` mesh of ``torch.distributed`` ranks.

The port's twin of the JAX package's ``Mesh(devices.reshape(group,
slot), ("group", "slot"))``: every rank is one shard, ranks are laid out
row-major (rank ``r`` holds group shard ``r // slot_shards`` and slot
shard ``r % slot_shards``), and a psum over an axis becomes an
all-reduce SUM over that axis's subgroup -- the ranks that share the
other coordinate. A psum over an axis of size 1 is the identity, so no
collective runs for it. An axis split over the whole mesh (the sharded
vote board's slot columns) is split in rank order: rank ``r`` holds the
``r``-th piece, as JAX's ``PartitionSpec(("group", "slot"))`` places it.

The backend is chosen explicitly and printed by rank 0 when the world
starts: ``nccl`` when every rank has a card of its own, ``gloo`` on the
CPU or when ranks share one card (NCCL refuses two ranks on one GPU;
gloo's ``all_reduce`` takes CUDA tensors and reduces through the host).
A backend that fails to initialise raises; nothing falls back.

:func:`mesh_probe` is the twin of ``bench/device_probe.py::mesh_probe``:
a tiny all-reduce under a deadline that a bench checks before it runs.
"""

from __future__ import annotations

import dataclasses
import datetime
import sys
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

#: Seconds a collective may wait before it raises (and a rendezvous).
DEFAULT_TIMEOUT_S = 120.0
#: Seconds each of :func:`mesh_probe`'s all-reduces may take.
PROBE_DEADLINE_S = 30.0


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % cards``."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a mesh runs on 'cpu' or 'cuda', not "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for the plain versions")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(device: torch.device, world: int) -> str:
    """``nccl`` when each of the ``world`` ranks has a card of its own,
    ``gloo`` on the CPU or when ranks share a card."""
    if device.type == "cpu":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def init_world(rank: int, world: int, init_method: str, *,
               device_type: str = "cuda") -> tuple:
    """Join the default process group as ``rank`` of ``world`` through
    ``init_method`` (a ``file://`` or ``tcp://127.0.0.1:<port>`` URL).
    Returns ``(backend, device)``; raises when the backend does not come
    up."""
    device = rank_device(device_type, rank)
    backend = choose_backend(device, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # NCCL binds each rank to its own card (without ``device_id`` it
    # guesses the card from the rank); gloo takes no device.
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
        device_id=device if backend == "nccl" else None)
    if dist.get_backend() != backend:
        raise RuntimeError(f"asked for {backend}, got {dist.get_backend()}")
    if rank == 0:
        print(f"mesh world: {world} ranks, backend {backend}, rank 0 on "
              f"{device}", file=sys.stderr, flush=True)
    return backend, device


class SlotAxis(NamedTuple):
    """The slot axis as the telemetry updates see it: this rank's slot
    shard, the shard count, and the psum over the axis (in place)."""

    index: int
    size: int
    mesh: "Mesh"

    def psum(self, tensor: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum_slot(tensor)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``(group, slot)`` mesh and the subgroups
    its collectives run over. A mesh made by :func:`make_mesh` holds
    process groups; one made directly (``Mesh(g, s, rank, device)``)
    holds none and serves single-shard kernel calls, whose reductions
    then raise when an axis has more than one shard."""

    group_shards: int
    slot_shards: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group_pg: object = None   # ranks that share this rank's slot shard
    slot_pg: object = None    # ranks that share this rank's group shard
    mesh_pg: object = None    # every rank of the mesh

    @property
    def group_idx(self) -> int:
        return self.rank // self.slot_shards

    @property
    def slot_idx(self) -> int:
        return self.rank % self.slot_shards

    @property
    def size(self) -> int:
        return self.group_shards * self.slot_shards

    @property
    def slot_axis(self) -> SlotAxis:
        return SlotAxis(self.slot_idx, self.slot_shards, self)

    def _reduce(self, tensor: torch.Tensor, shards: int, pg,
                op=dist.ReduceOp.SUM, async_op: bool = False):
        if shards == 1:
            return None if async_op else tensor
        if pg is None:
            raise RuntimeError("this mesh holds no process groups: make it "
                               "with make_mesh")
        work = dist.all_reduce(tensor, op=op, group=pg, async_op=async_op)
        return work if async_op else tensor

    def _psum(self, tensor: torch.Tensor, shards: int, pg) -> torch.Tensor:
        return self._reduce(tensor, shards, pg)

    def psum_group(self, tensor: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM over the group axis, in place."""
        return self._psum(tensor, self.group_shards, self.group_pg)

    def psum_slot(self, tensor: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM over the slot axis, in place."""
        return self._psum(tensor, self.slot_shards, self.slot_pg)

    def psum_mesh(self, tensor: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM over the whole mesh, in place (the identity on
        a mesh of one rank)."""
        return self._reduce(tensor, self.size, self.mesh_pg)

    def psum_mesh_async(self, tensor: torch.Tensor):
        """:meth:`psum_mesh` without waiting: the work handle to
        ``wait()`` on before ``tensor`` is read, or None when nothing
        runs (a mesh of one rank)."""
        return self._reduce(tensor, self.size, self.mesh_pg, async_op=True)

    def pmax_mesh(self, tensor: torch.Tensor) -> torch.Tensor:
        """All-reduce MAX over the whole mesh, in place."""
        return self._reduce(tensor, self.size, self.mesh_pg,
                            op=dist.ReduceOp.MAX)

    def columns(self, window: int) -> tuple:
        """``(lo, hi)``: the slot columns ``[rank * w_local, (rank + 1) *
        w_local)`` of a ``window``-column axis that this rank holds when
        the axis is split over every rank of the mesh. Ranks are
        row-major ``(group, slot)``, the order of the reference's
        ``PartitionSpec(("group", "slot"))`` over
        ``devices.reshape(group, slot)``. Raises unless the mesh size
        divides ``window`` (the reference's words)."""
        if window % self.size:
            raise ValueError(f"window {window} must be a multiple of the "
                             f"mesh size {self.size}")
        w_local = window // self.size
        return self.rank * w_local, (self.rank + 1) * w_local

    def close(self) -> None:
        """Destroy the mesh's subgroups (collective over the mesh)."""
        for pg in (self.group_pg, self.slot_pg, self.mesh_pg):
            if pg is not None:
                dist.destroy_process_group(pg)
        self.group_pg = self.slot_pg = self.mesh_pg = None


def make_mesh(group_shards: int, slot_shards: int,
              device) -> Optional[Mesh]:
    """The ``group_shards x slot_shards`` mesh over the first ranks of
    the default process group, this rank's shard on ``device`` (what
    :func:`init_world` returned). Collective: every rank of the world
    calls it, and each makes every subgroup in the same order. Returns
    None on the ranks beyond the mesh."""
    if group_shards < 1 or slot_shards < 1:
        raise ValueError(f"mesh {group_shards}x{slot_shards}")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = group_shards * slot_shards
    if size > world:
        raise ValueError(f"a {group_shards}x{slot_shards} mesh needs "
                         f"{size} ranks, the world has {world}")
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)

    def family(shards: int, members) -> list:
        # An axis of one shard reduces nothing: no subgroup for it.
        return ([dist.new_group(members(k), timeout=timeout)
                 for k in range(size // shards)] if shards > 1 else [])

    groups = family(group_shards, lambda s: [g * slot_shards + s
                                             for g in range(group_shards)])
    slots = family(slot_shards, lambda g: [g * slot_shards + s
                                           for s in range(slot_shards)])
    whole = dist.new_group(list(range(size)), timeout=timeout)
    if rank >= size:
        return None
    return Mesh(group_shards, slot_shards, rank, torch.device(device),
                backend=dist.get_backend(),
                group_pg=groups[rank % slot_shards] if groups else None,
                slot_pg=slots[rank // slot_shards] if slots else None,
                mesh_pg=whole)


class MeshProbe(NamedTuple):
    """What :func:`mesh_probe` learned about the mesh."""

    backend: str
    ranks: int
    collective_ok: bool  # every all-reduce returned the right sum in time
    note: str


def mesh_probe(mesh: Mesh) -> MeshProbe:
    """A tiny all-reduce of ones over the whole mesh and over this rank's
    group and slot subgroups, each under a deadline of
    ``PROBE_DEADLINE_S``.
    Collective over the mesh. ``collective_ok=False`` (a wrong sum, an
    error, or a deadline passed) must stop a bench."""
    deadline = datetime.timedelta(seconds=PROBE_DEADLINE_S)
    checks = [("mesh", mesh.mesh_pg, mesh.size),
              ("group", mesh.group_pg, mesh.group_shards),
              ("slot", mesh.slot_pg, mesh.slot_shards)]
    for axis, pg, want in checks:
        if want == 1 and axis != "mesh":
            continue
        ones = torch.ones(1, dtype=torch.int32, device=mesh.device)
        try:
            work = dist.all_reduce(ones, group=pg, async_op=True)
            work.wait(timeout=deadline)
            got = int(ones.item())
        except RuntimeError as exc:
            return MeshProbe(mesh.backend, mesh.size, False,
                             f"{axis} all-reduce failed: {exc}")
        if got != want:
            return MeshProbe(mesh.backend, mesh.size, False,
                             f"{axis} all-reduce gave {got}, not {want}")
    return MeshProbe(mesh.backend, mesh.size, True,
                     f"{mesh.group_shards}x{mesh.slot_shards} mesh over "
                     f"{mesh.backend}: every all-reduce summed right")
