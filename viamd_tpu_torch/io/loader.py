"""Loader dispatch: file extension → format loader — copy of
viamd_tpu.io.loader over the port's readers (every format but `vlx`).

Capability mirror of the reference's loader table
(VIAMD src/loader.cpp:22-113: pdb/gro/xyz/xmol/arc/cif/data/
lammpstrj/xtc/trr/dcd with System/Trajectory/MM flags, plus LAMMPS format
sniffing).
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Optional

from viamd_tpu_torch.core.system import System
from viamd_tpu_torch.io.trajectory import Trajectory


class LoaderFlags(enum.IntFlag):
    NONE = 0
    SYSTEM = 1
    TRAJECTORY = 2
    MM = 4
    QM = 8
    SUPPLEMENTAL = 16
    REQUIRES_DIALOGUE = 32


# extension → (loader name, flags) — mirrors loader.cpp:22-77
_TABLE: dict[str, tuple[str, LoaderFlags]] = {
    "pdb": ("Standard Protein Data Bank (pdb)", LoaderFlags.SYSTEM | LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "gro": ("Gromacs Structure (gro)", LoaderFlags.SYSTEM | LoaderFlags.MM),
    "xyz": ("xyz (xyz)", LoaderFlags.SYSTEM | LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "xmol": ("xyz (xmol)", LoaderFlags.SYSTEM | LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "arc": ("xyz (arc)", LoaderFlags.SYSTEM | LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "cif": ("PDBx/mmCIF (cif)", LoaderFlags.SYSTEM | LoaderFlags.MM),
    "data": ("LAMMPS (data)", LoaderFlags.SYSTEM | LoaderFlags.MM),
    "lammpstrj": ("LAMMPS Trajectory (lammpstrj)", LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "xtc": ("Gromacs Compressed Trajectory (xtc)", LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "trr": ("Gromacs Lossless Trajectory (trr)", LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "dcd": ("DCD Trajectory (dcd)", LoaderFlags.TRAJECTORY | LoaderFlags.MM),
    "vtraj": ("viamd_tpu packed trajectory cache", LoaderFlags.TRAJECTORY | LoaderFlags.MM),
}


@dataclass
class LoadResult:
    system: Optional[System] = None
    trajectory: Optional[Trajectory] = None
    flags: LoaderFlags = LoaderFlags.NONE


def loader_for_path(path: str) -> tuple[str, LoaderFlags]:
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    if ext not in _TABLE:
        return ("Undefined", LoaderFlags.REQUIRES_DIALOGUE)
    return _TABLE[ext]


def load_file(
    path: str, system: Optional[System] = None, ext: Optional[str] = None,
    cache: bool = True,
) -> LoadResult:
    """Load a system and/or trajectory from `path`.

    `system` provides atom-count context for trajectory-only formats
    (mirrors how the reference attaches trajectories to the loaded system,
    src/viamd.cpp:439-467).

    `cache`: compressed trajectory codecs (XTC/TRR) write a `.vtraj`
    sidecar on first load and reuse it when fresh — the reference's
    trajectory cache files (loader.cpp:118-121; disable with
    cache=False ≙ MD_TRAJECTORY_FLAG_DISABLE_CACHE_WRITE). Failures to
    write (read-only directories) silently fall back to direct reads.
    """
    ext = (ext or os.path.splitext(path)[1].lstrip(".")).lower()
    name, flags = _TABLE.get(ext, ("Undefined", LoaderFlags.NONE))
    res = LoadResult(flags=flags)

    if ext == "pdb":
        from viamd_tpu_torch.io.pdb import load_pdb

        res.system, res.trajectory = load_pdb(path)
    elif ext == "gro":
        from viamd_tpu_torch.io.gro import load_gro

        res.system = load_gro(path)
    elif ext in ("xyz", "xmol", "arc"):
        from viamd_tpu_torch.io.xyz import load_xyz

        res.system, res.trajectory = load_xyz(path)
    elif ext == "cif":
        from viamd_tpu_torch.io.mmcif import load_mmcif

        res.system = load_mmcif(path)
    elif ext == "data":
        from viamd_tpu_torch.io.lammps import load_lammps_data

        res.system = load_lammps_data(path)
    elif ext == "lammpstrj":
        from viamd_tpu_torch.io.lammps import load_lammps_trajectory

        res.trajectory = load_lammps_trajectory(path)
    elif ext == "xtc":
        from viamd_tpu_torch.io.xtc import XTCTrajectory

        res.trajectory = _with_sidecar_cache(path, XTCTrajectory, cache)
    elif ext == "trr":
        from viamd_tpu_torch.io.trr import TRRTrajectory

        res.trajectory = _with_sidecar_cache(path, TRRTrajectory, cache)
    elif ext == "dcd":
        from viamd_tpu_torch.io.dcd import DCDTrajectory

        res.trajectory = DCDTrajectory(path)
    elif ext == "vtraj":
        from viamd_tpu_torch.io.cache import PackedTrajectory

        res.trajectory = PackedTrajectory(path)
    else:
        raise ValueError(f"Unsupported file extension: .{ext} ({path})")

    # a file carrying its OWN system (e.g. a multi-model PDB) validates
    # against that system, not the caller's previous one — `system=` only
    # constrains standalone trajectory attachments
    check_sys = res.system if res.system is not None else system
    if (
        res.trajectory is not None
        and check_sys is not None
        and res.trajectory.num_atoms != check_sys.natoms
    ):
        raise ValueError(
            f"Trajectory atom count {res.trajectory.num_atoms} does not match "
            f"system atom count {check_sys.natoms}"
        )
    return res


def _with_sidecar_cache(path: str, reader_cls, cache: bool):
    """Use/refresh a `.vtraj` sidecar next to a compressed trajectory."""
    sidecar = path + ".vtraj"
    if cache and os.path.exists(sidecar):
        try:
            if os.path.getmtime(sidecar) >= os.path.getmtime(path):
                from viamd_tpu_torch.io.cache import PackedTrajectory

                return PackedTrajectory(sidecar)
        except OSError:
            pass
    traj = reader_cls(path)
    if cache:
        try:
            from viamd_tpu_torch.io.cache import PackedTrajectory, transcode

            transcode(traj, sidecar)
            return PackedTrajectory(sidecar)
        except OSError:
            pass  # read-only location — keep the direct reader
    return traj
