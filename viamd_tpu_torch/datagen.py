"""Synthetic system/trajectory generators (benchmarks + tests).

Counterpart of viamd_tpu.datagen. `water_box` is a numpy copy (the same
seed gives the same system and frames as the JAX package); for
`water_box_device` the frame noise is drawn on the device with a
`torch.Generator`, whose stream differs from JAX's threefry — compare the
two packages on shared numpy frames, not on these. `polyala_helix` is a
numpy copy too, `postprocess` included. `render_inputs` is the
molecule-render scene of the JAX package's benchmark for a system.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.core import elements as E
from viamd_tpu_torch.core.system import FLAG_WATER, System, build_system, postprocess
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.io.trajectory import DeviceTrajectory, InMemoryTrajectory


def water_box(
    n_waters: int,
    density_atoms_per_A3: float = 0.1,
    n_frames: int = 8,
    jitter: float = 0.15,
    seed: int = 0,
) -> tuple[System, InMemoryTrajectory]:
    """Grid-packed water box: 3·n_waters atoms, periodic cube.

    Residues = waters (SOL), elements assigned directly (no inference pass),
    masses/radii from element tables. Frames are the base configuration with
    gaussian jitter — enough structure for RDF/SDF/density kernels to produce
    meaningful output at benchmark scale.
    """
    rng = np.random.RandomState(seed)
    n_atoms = n_waters * 3
    volume = n_atoms / density_atoms_per_A3
    box = float(np.cbrt(volume))
    g = int(np.ceil(n_waters ** (1 / 3)))
    cell_w = box / g
    gg = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), -1).reshape(-1, 3)
    centers = (gg[:n_waters] + 0.5) * cell_w
    centers += rng.normal(scale=0.1 * cell_w, size=centers.shape)
    offs = np.array([[0.0, 0, 0], [0.9572, 0, 0], [-0.24, 0.9266, 0]])
    # random per-molecule rotation (vectorized, z-axis only for speed)
    th = rng.uniform(0, 2 * np.pi, n_waters)
    c, s = np.cos(th), np.sin(th)
    ox = offs[None, :, 0] * c[:, None] - offs[None, :, 1] * s[:, None]
    oy = offs[None, :, 0] * s[:, None] + offs[None, :, 1] * c[:, None]
    coords = np.empty((n_waters, 3, 3), np.float32)
    coords[:, :, 0] = centers[:, None, 0] + ox
    coords[:, :, 1] = centers[:, None, 1] + oy
    coords[:, :, 2] = centers[:, None, 2] + offs[None, :, 2]
    coords = coords.reshape(-1, 3)

    cell = UnitCell.orthorhombic(box, box, box)
    sys = build_system(
        coords=coords,
        atom_names=["OW", "HW1", "HW2"] * n_waters,
        res_names=["SOL"] * n_atoms,
        res_ids=np.repeat(np.arange(1, n_waters + 1), 3),
        elements_z=np.tile(np.array([8, 1, 1], np.int32), n_waters),
        cell=cell,
    )
    # direct postprocess (vectorized; skips name-based inference)
    sys.radius = E.VDW_RADII[sys.element].astype(np.float32)
    sys.mass = E.MASSES[sys.element].astype(np.float32)
    sys.flags[:] = FLAG_WATER
    # waters have known topology: O-H1, O-H2
    o = np.arange(0, n_atoms, 3, dtype=np.int32)
    sys.bonds = np.concatenate(
        [np.stack([o, o + 1], 1), np.stack([o, o + 2], 1)]
    )

    frames = coords[None] + rng.normal(
        scale=jitter, size=(n_frames, n_atoms, 3)
    ).astype(np.float32)
    traj = InMemoryTrajectory(frames.astype(np.float32), cell=cell)
    return sys, traj


def water_box_device(
    n_waters: int,
    n_frames: int,
    seed: int,
    device,
    density_atoms_per_A3: float = 0.1,
    jitter: float = 0.15,
) -> tuple[System, DeviceTrajectory]:
    """water_box with the frame stack generated on `device`.

    Only the (n, 3) base configuration is copied to the device; the
    (F, n, 3) stack is base + jitter · N(0, 1) drawn there with a
    `torch.Generator` seeded by `seed`. Cells are the box, every frame.
    """
    device = torch.device(device)
    sys, _ = water_box(
        n_waters,
        density_atoms_per_A3=density_atoms_per_A3,
        n_frames=1,
        jitter=0.0,
        seed=seed,
    )
    base = torch.as_tensor(sys.coords(), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stack = torch.randn(
        (n_frames, *base.shape), generator=gen, dtype=torch.float32,
        device=device,
    )
    stack.mul_(jitter).add_(base)  # in place: the stack is the big buffer
    cells = np.broadcast_to(
        sys.cell.basis.astype(np.float32), (n_frames, 3, 3)
    ).copy()
    return sys, DeviceTrajectory(stack, cells)


def polyala_helix(
    n_res: int = 64, n_frames: int = 16, seed: int = 0
) -> tuple[System, InMemoryTrajectory]:
    """Ideal poly-alanine α-helix (N/H/CA/HA/C/O/CB per residue) and
    jittered frames, aperiodic: the JAX package's stand-in for 1ALA-500
    (BASELINE config #1), the same seed giving the same coordinates,
    elements, residues and frames. `postprocess` infers radii, masses,
    flags, bonds and the backbone, as in the JAX package."""
    rng = np.random.RandomState(seed)
    template = [
        ("N", 7), ("H", 1), ("CA", 6), ("HA", 1), ("C", 6), ("O", 8),
        ("CB", 6),
    ]
    # helical parameters: rise 1.5 Å, 100° per residue, radius 2.3 Å
    names, zs, coords = [], [], []
    for r in range(n_res):
        phase = np.radians(100.0) * r
        base = np.array([2.3 * np.cos(phase), 2.3 * np.sin(phase), 1.5 * r])
        for k, (nm, z) in enumerate(template):
            names.append(nm)
            zs.append(z)
            local = np.array(
                [0.4 * np.cos(phase + k), 0.4 * np.sin(phase + k), 0.3 * k]
            )
            coords.append(base + local)
    coords = np.asarray(coords, np.float32)
    n = coords.shape[0]
    sys = build_system(
        coords=coords,
        atom_names=names,
        res_names=["ALA"] * n,
        res_ids=np.repeat(np.arange(1, n_res + 1), len(template)),
        elements_z=np.asarray(zs, np.int32),
        cell=UnitCell.none(),
    )
    sys = postprocess(sys)
    frames = coords[None] + rng.normal(scale=0.08, size=(n_frames, n, 3))
    return sys, InMemoryTrajectory(frames.astype(np.float32))


def render_inputs(sys: System, width: int, height: int,
                  eye_dir=(0.0, 0.0, 1.6), device=None) -> dict:
    """bench.py's molecule-render scene for `sys`: vdW radii, CPK colours
    and bonds, and a camera at box centre + eye_dir · box looking at the
    centre, perspective(45°, width/height, 1, 500) — dict(radii, colors,
    bonds, view, proj) of numpy arrays; with a `device`, radii, colours and
    bonds (int64) are tensors on it."""
    from viamd_tpu_torch.render.camera import look_at, perspective
    from viamd_tpu_torch.render.color import color_atoms_cpk

    box = np.asarray(sys.cell.extent(), np.float64)
    eye = box * 0.5 + np.asarray(eye_dir, np.float64) * box[2]
    d = dict(
        radii=sys.radius,
        colors=color_atoms_cpk(sys),
        bonds=sys.bonds,
        view=look_at(eye, box * 0.5, np.array([0.0, 1.0, 0.0])),
        proj=perspective(np.radians(45.0), width / height, 1.0, 500.0),
    )
    if device is not None:
        d["radii"] = torch.as_tensor(d["radii"], device=device)
        d["colors"] = torch.as_tensor(d["colors"], device=device)
        d["bonds"] = torch.as_tensor(d["bonds"], dtype=torch.int64, device=device)
    return d
