"""Gromacs .gro structure loader — numpy copy of viamd_tpu.io.gro.

Capability mirror of mdlib's md_gro.h (dispatched at
VIAMD src/loader.cpp:127; GRO is System-only, loader.cpp:62).
Coordinates are stored in nm in .gro and converted to Å (the framework's
internal unit, matching the reference's PDB-native convention).
"""

from __future__ import annotations

import numpy as np

from viamd_tpu_torch.core.system import System, build_system, postprocess
from viamd_tpu_torch.core.unitcell import UnitCell

NM_TO_ANGSTROM = 10.0


def parse_gro(text: str | bytes) -> System:
    if isinstance(text, bytes):
        text = text.decode("ascii", "replace")
    lines = text.splitlines()
    if len(lines) < 3:
        raise ValueError("GRO: truncated file")
    natoms = int(lines[1].strip())
    atom_lines = lines[2 : 2 + natoms]
    if len(atom_lines) < natoms:
        raise ValueError("GRO: fewer atom lines than declared")

    res_ids = np.empty(natoms, np.int32)
    res_names = []
    atom_names = []
    xyz = np.empty((natoms, 3), np.float32)
    vel = np.zeros((natoms, 3), np.float32)
    has_vel = False
    for i, ln in enumerate(atom_lines):
        res_ids[i] = int(ln[0:5])
        res_names.append(ln[5:10].strip())
        atom_names.append(ln[10:15].strip())
        xyz[i, 0] = float(ln[20:28])
        xyz[i, 1] = float(ln[28:36])
        xyz[i, 2] = float(ln[36:44])
        if len(ln) >= 68:
            try:
                vel[i, 0] = float(ln[44:52])
                vel[i, 1] = float(ln[52:60])
                vel[i, 2] = float(ln[60:68])
                has_vel = True
            except ValueError:
                pass
    xyz *= NM_TO_ANGSTROM
    vel *= NM_TO_ANGSTROM  # nm/ps → Å/ps

    cell = UnitCell.none()
    box_line = lines[2 + natoms].split() if len(lines) > 2 + natoms else []
    if box_line:
        v = [float(t) * NM_TO_ANGSTROM for t in box_line]
        if len(v) >= 9:
            # v1x v2y v3z v1y v1z v2x v2z v3x v3y
            basis = np.array(
                [
                    [v[0], v[3], v[4]],
                    [v[5], v[1], v[6]],
                    [v[7], v[8], v[2]],
                ],
                np.float32,
            )
            cell = UnitCell.from_basis(basis)
        elif len(v) >= 3:
            cell = UnitCell.orthorhombic(v[0], v[1], v[2])

    sys = build_system(
        coords=xyz,
        atom_names=atom_names,
        res_names=res_names,
        res_ids=res_ids,
        cell=cell,
        velocity=vel if has_vel else None,
    )
    return postprocess(sys)


def load_gro(path: str) -> System:
    with open(path, "r") as f:
        return parse_gro(f.read())
