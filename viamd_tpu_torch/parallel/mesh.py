"""Device meshes over torch.distributed ranks.

Counterpart of viamd_tpu/parallel/mesh.py. The JAX package lays a `Mesh`
over the devices of one process; here every rank is a process with one
device, and a mesh is this rank's view of a grid of ranks:

- "frames": the data-parallel axis. Frames are independent; the Evaluator
  gives each rank of the axis its block of every chunk and sums the
  accumulators over the axis once at the end (eval/engine.py).
- "atoms": the intra-frame axis. The cell-list RDF splits its A cell rows
  over it and sums the int32 partials (ops/cuda_rdf.py::
  pair_dist_histogram_cl_sharded, `compile_script(atom_shard=)`).

Ranks are laid out row-major, as `np.array(devs).reshape(n // atoms,
atoms)` lays devices out in the JAX package. A mesh holds one process group
per line of each axis, made with `dist.new_group` by every rank in the same
order (a rank that skipped one would deadlock the others), and, for
objects on the host, a gloo group per line (the same group when the
backend is gloo).

The backend follows one rule, with no retry on another after a failure:
`nccl` when the ranks run on CUDA and each has a card of its own
(world <= torch.cuda.device_count()); `gloo` on the CPU and when ranks
share a card (NCCL refuses two ranks on one device). Rank r's device is
cuda:{r % device_count}, or the CPU when the caller asks for it.
`parallel/launch.py::spawn` starts the ranks and calls `init_rank`.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "backend_for",
    "current_mesh",
    "frames_mesh",
    "init_rank",
    "mesh_devices",
    "rank_device",
    "replicated",
    "shard_batch",
]

# this process's rank device (init_rank), its meshes by (n, atoms), and the
# mesh frames_mesh made or returned last (the compiler's atom_shard reads it)
_device: Optional[torch.device] = None
_meshes: dict = {}
_current = None


def backend_for(device_type: str, world: int) -> str:
    """nccl for CUDA ranks with a card each, gloo otherwise."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank `rank`'s device: cuda:{rank % device_count}, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"no mesh on device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: torch.cuda.is_available() is False")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_rank(rank: int, world: int, device_type: str, store, timeout: float) -> None:
    """Join the default process group as `rank` of `world` through `store`
    (a `dist.Store`), on this rank's device, with the backend of
    `backend_for`; collectives give up after `timeout` seconds."""
    global _device
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device.type, world), store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout),
    )
    _device = device


class Mesh:
    """This rank's view of a grid of ranks: axis names and sizes, its
    coordinates and device, a process group per axis (its line of the axis)
    and for the whole mesh, and their host (gloo) twins. Counts its
    collectives and, of those, the ones that make the host wait for the
    device (a gloo collective on CUDA tensors)."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple, device: torch.device,
                 backend: str, groups: dict, host_groups: dict):
        self.ranks = ranks  # the grid of global ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.rank = dist.get_rank()
        self.coords = dict(zip(axis_names, (int(c[0]) for c in np.nonzero(ranks == self.rank))))
        self.device = device
        self.backend = backend
        self.groups = groups  # axis name or None (the whole mesh) → group
        self.host_groups = host_groups
        self.collectives = 0
        self.host_waits = 0

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum `t` in place over this rank's line of `axis` (the whole mesh
        for None); returns it."""
        self.collectives += 1
        if t.is_cuda and self.backend == "gloo":
            self.host_waits += 1
        dist.all_reduce(t, group=self.groups[axis])
        return t

    def all_gather_object(self, obj, axis: str) -> list:
        """Every rank's `obj` along this rank's line of `axis`, in axis
        order, through the host group (pickled)."""
        self.collectives += 1
        out = [None] * self.shape[axis]
        dist.all_gather_object(out, obj, group=self.host_groups[axis])
        return out

    def broadcast_object(self, obj):
        """Mesh rank 0's `obj`, on every rank of the mesh (host group)."""
        self.collectives += 1
        box = [obj]
        dist.broadcast_object_list(box, src=int(self.ranks.flat[0]), group=self.host_groups[None])
        return box[0]


def _world() -> int:
    if not dist.is_initialized() or _device is None:
        raise RuntimeError("no rank here: start the ranks with "
                           "viamd_tpu_torch.parallel.launch.spawn (init_rank)")
    return dist.get_world_size()


def mesh_devices(n: Optional[int] = None) -> list:
    """The devices of ranks 0..n−1 (all ranks by default)."""
    world = _world()
    if n is not None and world < n:
        raise ValueError(f"need {n} devices, have {world}")
    return [rank_device(r, _device.type) for r in range(world if n is None else n)]


def frames_mesh(n_devices: Optional[int] = None, atoms: int = 1):
    """The ("frames",) mesh over ranks 0..n−1, or with `atoms` > 1 the
    ("frames", "atoms") mesh of shape (n // atoms, atoms). Every rank of the
    world must call it (it makes process groups); a rank outside the mesh
    gets None. The mesh becomes `current_mesh()`."""
    global _current
    world = _world()
    devs = mesh_devices(n_devices)
    n = len(devs)
    if atoms > 1 and n % atoms:
        raise ValueError(f"{n} devices not divisible by atoms={atoms}")
    key = (n, atoms)
    if key not in _meshes:
        _meshes[key] = _make_mesh(n, atoms, world)
    _current = _meshes[key]
    return _current


def _make_mesh(n: int, atoms: int, world: int):
    if atoms > 1:
        ranks, names = np.arange(n).reshape(n // atoms, atoms), ("frames", "atoms")
    else:
        ranks, names = np.arange(n), ("frames",)
    backend = dist.get_backend()
    # every line of every axis, then the whole mesh, on every rank in this
    # order; a rank keeps the groups of the lines it lies on
    lines = []
    for a, name in enumerate(names):
        moved = np.moveaxis(ranks, a, -1).reshape(-1, ranks.shape[a])
        lines += [(name, [int(r) for r in line]) for line in moved]
    lines.append((None, list(range(n))))
    me = dist.get_rank()
    groups, host_groups = {}, {}
    for name, members in lines:
        g = dist.new_group(members)
        h = g if backend == "gloo" else dist.new_group(members, backend="gloo")
        if me in members:
            groups[name], host_groups[name] = g, h
    if me >= n:
        return None
    return Mesh(ranks, names, _device, backend, groups, host_groups)


def current_mesh():
    """The mesh `frames_mesh` made or returned last in this rank, or None."""
    return _current


def shard_batch(mesh: Mesh, *arrays, axis_name: str = "frames"):
    """This rank's block of each array's leading axis over `axis_name`
    (the even split [k·n // s, (k+1)·n // s)), on the mesh's device."""
    k, s = mesh.axis_index(axis_name), mesh.shape[axis_name]
    out = tuple(
        torch.as_tensor(a[k * len(a) // s : (k + 1) * len(a) // s], device=mesh.device)
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


def replicated(mesh: Mesh, *arrays):
    """Each array as mesh rank 0 holds it, on every rank's device (a
    broadcast over the mesh; shapes and dtypes must agree)."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a).to(mesh.device).contiguous()
        mesh.collectives += 1
        dist.broadcast(t, src=int(mesh.ranks.flat[0]), group=mesh.groups[None])
        out.append(t)
    return tuple(out) if len(out) > 1 else out[0]
