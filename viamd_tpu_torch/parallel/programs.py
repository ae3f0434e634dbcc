"""Rank programs: what the ranks of `launch.spawn` run.

Each builds its mesh on its rank, drives one sharded path of the port and
returns numpy results (picklable, off the device), so that a caller — the
dry run, the tests, `chip_smoke.py` — holds them to a one-rank run or to
the JAX package. They live here, in a module that imports no JAX, because
a spawned rank imports the module of the function it runs.

    from viamd_tpu_torch.parallel import programs
    from viamd_tpu_torch.parallel.launch import spawn
    out = spawn(programs.evaluate, 2, "cpu", FLAGSHIP, 32, 6, 1)
"""

from __future__ import annotations

import dataclasses
import sys as _sys

import numpy as np
import torch
import torch.distributed as dist

from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.datagen import water_box
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.io.trajectory import InMemoryTrajectory
from viamd_tpu_torch.ops import cuda_rdf
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import pair_dist_histogram_atom_sharded
from viamd_tpu_torch.parallel.mesh import frames_mesh
from viamd_tpu_torch.script import compile_script

# the JAX package's flagship script (__graft_entry__.py::_flagship)
FLAGSHIP = (
    "s1 = residue(1:4);\n"
    "d1 = distance(1, 4);\n"
    "a1 = angle(1, 2, 3) in residues;\n"
    "r = rdf(element('O'), element('H'), 5.0);\n"
    "v = sdf(s1, element('H'), 4.0);\n"
    "{lin, plan, iso} = shape_weights(all);\n"
)


def sequence(*calls) -> list:
    """Run each (fn, args, kwargs) of `calls` in turn on this rank → their
    results: several programs in one launch."""
    return [fn(*args, **kw) for fn, args, kw in calls]


def reference_modules() -> list:
    """The modules of JAX or of the JAX package loaded in this rank."""
    return sorted(m for m in _sys.modules
                  if m in ("jax", "jaxlib", "viamd_tpu")
                  or m.startswith(("jax.", "jaxlib.", "viamd_tpu.")))


def mesh_layout() -> dict:
    """This rank's view of the world's meshes: the 1D mesh and the
    (world/2) × 2 one (coordinates, the ranks of its lines), `shard_batch`
    of arange(10) over each axis, `replicated` of a rank-dependent array,
    the errors of meshes the world cannot hold and of an atom_shard the
    current mesh does not have."""
    from viamd_tpu_torch.script import ScriptError

    world = dist.get_world_size()
    mesh1, mesh2 = frames_mesh(), frames_mesh(atoms=2)
    errors = []
    for kw in ({"n_devices": world + 1}, {"atoms": 3}):
        try:
            frames_mesh(**kw)
        except ValueError as e:
            errors.append(str(e))
    sys, _ = water_box(32, n_frames=1)
    try:
        compile_script("r = rdf(element('O'), element('O'), 3.0);", sys, mesh2.device,
                       atom_shard=("atoms", 3))
    except ScriptError as e:
        errors.append(str(e))
    from viamd_tpu_torch.parallel.mesh import replicated, shard_batch

    return {
        "shape": (mesh1.shape, mesh2.shape),
        "coords": (mesh1.coords, mesh2.coords),
        "lines": {axis: dist.get_process_group_ranks(g) for axis, g in mesh2.groups.items()},
        "shard": [shard_batch(mesh2, np.arange(10), axis_name=a).tolist()
                  for a in ("frames", "atoms")],
        "replicated": replicated(mesh1, np.full(3, 10 + mesh1.rank)).tolist(),
        "errors": errors,
    }


def atom_shard_mesh_errors() -> list:
    """The errors of an Evaluator given a script compiled with atom_shard
    on the world's (world/2) × 2 mesh: on the 1D mesh of the world, and on
    its own mesh with the shard axis as the frames axis. Both are raised
    before any frame is evaluated."""
    mesh2 = frames_mesh(atoms=2)
    sys, traj = water_box(32, n_frames=2)
    compiled = compile_script("r = rdf(element('O'), element('O'), 3.0);", sys,
                              mesh2.device, atom_shard=("atoms", 2))
    errors = []
    for mesh, axis in ((frames_mesh(), "frames"), (mesh2, "atoms")):
        try:
            Evaluator(compiled, traj, chunk=2, mesh=mesh, frames_axis=axis)
        except ValueError as e:
            errors.append(str(e))
    return errors


def fail_on(rank: int) -> int:
    """Raise on rank `rank` while every other rank waits in a collective
    (the launcher must end them)."""
    mesh = frames_mesh()
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    mesh.all_reduce(torch.ones(1, device=mesh.device))
    return mesh.rank


def triclinic_box(sys, traj, gamma: float = 60.0):
    """The water box re-described in a cell of the same lengths skewed to
    `gamma` degrees, every frame wrapped into it through its fractional
    coordinates (__graft_entry__.py's triclinic step) → (system, frames
    (F, n, 3) float32, the cell)."""
    L = float(np.diag(np.asarray(sys.cell.basis))[0])
    cell = UnitCell.from_lengths_angles(L, L, L, 90, 90, gamma)
    xyz, _ = traj.load_frames(list(range(traj.num_frames)))
    frac = np.mod(np.asarray(xyz, np.float64) / L, 1.0)
    wrapped = (frac @ np.asarray(cell.basis, np.float64)).astype(np.float32)
    sys_t = dataclasses.replace(
        sys, x=wrapped[0, :, 0], y=wrapped[0, :, 1], z=wrapped[0, :, 2], cell=cell,
    )
    return sys_t, wrapped, cell


def slab_histograms(x, idx_a, idx_b, basis, nbins: int, r_max: float, dims,
                    fractional: bool = False, radius: int = 1, splits=(2,)) -> dict:
    """`pair_dist_histogram_cl_sharded` on the world's ranks with the rows
    split `atoms` ways, for each `atoms` in `splits` (a frames × atoms mesh;
    the ranks of a frames row split the rows among them) → {atoms: (nbins,)
    histogram}. `idx_b` None: A against itself (the half stencil)."""
    out = {}
    for atoms in splits:
        mesh = frames_mesh(atoms=atoms)
        dev = mesh.device
        b = torch.as_tensor(basis, dtype=torch.float32, device=dev)
        ia = torch.as_tensor(idx_a, dtype=torch.int32, device=dev)
        ib = ia if idx_b is None else torch.as_tensor(idx_b, dtype=torch.int32, device=dev)
        h = cuda_rdf.pair_dist_histogram_cl_sharded(
            torch.as_tensor(x, device=dev), ia, ib, b, inv_basis_of(b), nbins, r_max,
            tuple(dims), mesh, "atoms", fractional=fractional, radius=radius,
        )
        out[atoms] = h.cpu().numpy()
    return out


def dense_histogram(x, w_a, w_b, basis, nbins: int, r_max: float) -> np.ndarray:
    """`pair_dist_histogram_atom_sharded` over every rank (one atoms line)."""
    mesh = frames_mesh(atoms=dist.get_world_size())
    dev = mesh.device
    b = torch.as_tensor(basis, dtype=torch.float32, device=dev)
    h = pair_dist_histogram_atom_sharded(
        torch.as_tensor(x, device=dev), torch.as_tensor(w_a, device=dev),
        torch.as_tensor(w_b, device=dev), b, inv_basis_of(b), nbins, r_max, mesh,
    )
    return h.cpu().numpy()


def evaluate(src: str, n_waters: int, n_frames: int, seed: int, chunk: int = 16,
             atoms: int = 1, atom_shard=None, frame_range=None, staged: bool = True,
             stop_after=None, resume: bool = False, triclinic: bool = False,
             session: bool = False, device=None) -> dict:
    """`src` over water_box(n_waters, n_frames, seed) (re-described in a
    60° cell with `triclinic`) on the world's ranks as a frames (× atoms)
    mesh, `compile_script(atom_shard=)` and `Evaluator(mesh=)` — through
    `Session.evaluate(mesh=)` with `session`. With `device`, the same run
    on one device and no mesh (the one-rank reference, in any process).
    `staged`: a DeviceTrajectory, else a host trajectory streamed through
    each rank's ChunkStream.
    `stop_after`: interrupt() says stop from its (stop_after+1)-th question;
    with `resume`, a second run then resumes from that result.
    → the result's arrays, frames, progress reports, launches and the
    mesh's collective counts."""
    mesh = None if device is not None else frames_mesh(atoms=atoms)
    dev = torch.device(device) if mesh is None else mesh.device
    sys, traj = water_box(n_waters, n_frames=n_frames, seed=seed)
    frames, cells = traj.load_frames(list(range(n_frames)))
    if triclinic:
        sys, frames, cell = triclinic_box(sys, traj)
        cells = np.broadcast_to(np.asarray(cell.basis, np.float32), (n_frames, 3, 3))
    if staged:
        traj = trajectory_from_numpy(frames, cells, dev)
    else:
        traj = InMemoryTrajectory(np.ascontiguousarray(frames), cell=sys.cell)
    asked, reports = [0], []

    def interrupt():
        asked[0] += 1
        return stop_after is not None and asked[0] > stop_after

    cuda_rdf.launches = 0
    collectives0 = 0 if mesh is None else mesh.collectives
    if session:
        from viamd_tpu_torch.app import Session

        s = Session(device=dev)
        s.system = sys
        s.set_trajectory(traj)
        s.set_script(src)
        res = s.evaluate(frame_range=frame_range, chunk=chunk, mesh=mesh,
                         progress=reports.append, interrupt=interrupt)
        compiled = s.compiled
    else:
        compiled = compile_script(src, sys, dev, atom_shard=atom_shard)
        ev = Evaluator(compiled, traj, chunk=chunk, mesh=mesh)
        res = ev.run(frame_range, reports.append, interrupt)
        if resume:
            res = ev.run(frame_range, reports.append, resume_from=res)
    return {
        "temporal": res.temporal,
        "distributions": res.distributions,
        "volumes": res.volumes,
        "frame_indices": np.asarray(res.frame_indices),
        "mask": res.frame_mask.words.copy(),
        "n_frames_done": res.n_frames_done,
        "interrupted": res.interrupted,
        "progress": reports,
        "asked": asked[0],
        "routes": list(compiled.routes),
        "launches": cuda_rdf.launches,
        "collectives": 0 if mesh is None else mesh.collectives - collectives0,
        "host_waits": 0 if mesh is None else mesh.host_waits,
        "coords": {} if mesh is None else dict(mesh.coords),
    }
