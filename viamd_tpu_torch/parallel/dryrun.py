"""Dry run of multi-device evaluation: every sharded path of the port on n
ranks.

    python -m viamd_tpu_torch.parallel.dryrun N [--device cpu]

Counterpart of `__graft_entry__.py::dryrun_multichip` (:135-292). It
spawns N ranks of its own (`launch.spawn`; on the card by default, where
ranks share one card when there are fewer cards than ranks) and runs the
six steps of the JAX package's dry run over the port, printing the same
"ok" lines: the flagship script frames-sharded; the atom-sharded dense
pair histogram; the slab-sharded cell-list histogram (on the card
csrc/pair_hist.cu, its rows split over the ranks); the 2D frames × atoms
mesh; dp × tp, `compile_script(atom_shard=("atoms", 2))` on
water_box(1500) under that mesh; a triclinic sharded evaluation. Each
step checks what it computed, and the slab-sharded histogram equals the
one-rank route bit for bit. A failed check or rank fails the run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from viamd_tpu_torch.parallel.launch import spawn

__all__ = ["dryrun_multichip"]

TIMEOUT = 900.0  # seconds for the whole run, every rank's step included


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the dry run on `n_devices` ranks of `device`; prints and returns
    its "ok" lines. On CUDA the libraries that the ranks' modules declare
    are built here first, so that the ranks only load them."""
    if torch.device(device).type == "cuda":
        from viamd_tpu_torch import cuda_build
        from viamd_tpu_torch.parallel import programs  # noqa: F401  (what the ranks run)

        cuda_build.build(m.LIBRARY for m in cuda_build.declared())
    lines = spawn(_dryrun_rank, n_devices, device, n_devices, timeout=TIMEOUT)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def _dryrun_rank(n: int) -> list:
    from viamd_tpu_torch.datagen import water_box
    from viamd_tpu_torch.eval import evaluate
    from viamd_tpu_torch.interop import trajectory_from_numpy
    from viamd_tpu_torch.io.trajectory import InMemoryTrajectory
    from viamd_tpu_torch.ops import cuda_rdf
    from viamd_tpu_torch.ops.neighbors import choose_grid_r
    from viamd_tpu_torch.ops.pbc import inv_basis_of
    from viamd_tpu_torch.ops.rdf import pair_dist_histogram_atom_sharded
    from viamd_tpu_torch.parallel import programs
    from viamd_tpu_torch.parallel.mesh import frames_mesh
    from viamd_tpu_torch.script import compile_script

    lines = []
    mesh = frames_mesh(n)
    dev = mesh.device
    sys, traj = water_box(32, n_frames=n, seed=1)
    compiled = compile_script(programs.FLAGSHIP, sys, dev)
    res = evaluate(compiled, traj, chunk=n, mesh=mesh)
    _check(res.n_frames_done == n, res.n_frames_done)
    for name in ("d1", "a1", "lin"):
        _check(np.isfinite(res.temporal[name]).all(), name)
    _check(res.distributions["r"].sum() >= 0 and res.volumes["v"].shape[0] > 0, "r, v")
    lines.append(f"dryrun_multichip({n}): ok — {res.n_frames_done} frames sharded "
                 f"over {mesh.size} devices ({mesh.backend}, {dev})")

    # intra-frame atom-axis sharding: the dense histogram's A rows
    amesh = frames_mesh(n, atoms=n)
    xyz, cells = traj.load_frames([0])
    x = torch.as_tensor(xyz[0], device=dev)
    basis = torch.as_tensor(cells[0], device=dev)
    inv = inv_basis_of(basis)
    w_o = torch.as_tensor((sys.element == 8).astype(np.float32), device=dev)
    hist = pair_dist_histogram_atom_sharded(x, w_o, w_o, basis, inv, 128, 5.0, amesh)
    _check(bool(torch.isfinite(hist).all()), "atom-sharded histogram")
    lines.append(f"dryrun_multichip({n}): atom-axis sharded pair histogram ok")

    # the slab-sharded cell-list kernel: each rank walks its cell rows
    idx_o = torch.as_tensor(np.nonzero(sys.element == 8)[0].astype(np.int32), device=dev)
    dims, _ = choose_grid_r(np.diag(cells[0]).astype(np.float64), 3.0, idx_o.shape[0], radius=1)
    if min(dims) >= 3:
        h2 = cuda_rdf.pair_dist_histogram_cl_sharded(
            x, idx_o, idx_o, basis, inv, 128, 3.0, dims, amesh)
        one = cuda_rdf.pair_dist_histogram_cl(x, idx_o, idx_o, basis, inv, 128, 3.0, dims)
        _check(torch.equal(h2, one), "slab-sharded histogram != one rank's")
        lines.append(f"dryrun_multichip({n}): slab-sharded cell-list kernel ok "
                     f"({dims[0]} rows over {n} ranks, equal to one rank's)")

    # the 2D frames × atoms mesh: frames over its frames axis
    if n % 2 == 0:
        mesh2 = frames_mesh(n, atoms=2)
        res2 = evaluate(compiled, traj, chunk=n // 2, mesh=mesh2)
        _check(res2.n_frames_done == n, res2.n_frames_done)
        _check(np.isfinite(res2.temporal["d1"]).all(), "d1")
        lines.append(f"dryrun_multichip({n}): 2D frames×atoms mesh "
                     f"({tuple(mesh2.shape.values())}) ok")

    # dp × tp: frames over the frames axis, the cell-list RDF's rows over
    # the atoms axis (a system of 4,096+ atoms takes the cell list)
    if n % 2 == 0:
        sys_tp, traj_tp = water_box(1500, n_frames=4, seed=2)
        frames_mesh(n, atoms=2)
        cs_tp = compile_script("r = rdf(element('O'), element('O'), 6.0);\n", sys_tp,
                               dev, atom_shard=("atoms", 2))
        _check(cs_tp.routes == ["rdf:cell_list"], cs_tp.routes)
        res_tp = evaluate(cs_tp, traj_tp, chunk=4, mesh=mesh2)
        _check(res_tp.n_frames_done == 4, res_tp.n_frames_done)
        h = res_tp.distributions["r"]
        _check(np.isfinite(h).all() and h.sum() > 0, "dp×tp r")
        lines.append(f"dryrun_multichip({n}): dp×tp step ok — frames sharded, RDF "
                     "cell rows split over the atoms axis")

    # a triclinic cell shards the same way (min-image and COM are basis-driven)
    sys_t, wrapped, cell_t = programs.triclinic_box(sys, traj)
    traj_t = (trajectory_from_numpy(wrapped, np.broadcast_to(cell_t.basis, (n, 3, 3)), dev)
              if dev.type == "cuda" else InMemoryTrajectory(wrapped, cell=cell_t))
    compiled_t = compile_script(
        "r = rdf(element('O'), element('O'), 5.0);\n"
        "v = sdf(residue(1:4), element('H'), 4.0);\n", sys_t, dev)
    res_t = evaluate(compiled_t, traj_t, chunk=n, mesh=mesh)
    _check(res_t.n_frames_done == n, res_t.n_frames_done)
    _check(np.isfinite(res_t.distributions["r"]).all(), "triclinic r")
    lines.append(f"dryrun_multichip({n}): triclinic cell sharded eval ok")
    return lines


def _check(ok, what) -> None:
    if not ok:
        raise AssertionError(f"dry run check failed: {what}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
