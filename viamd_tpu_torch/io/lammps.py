"""LAMMPS data-file + dump-trajectory loaders — numpy copy of
viamd_tpu.io.lammps (the dump reader also gives every frame's cell at
scan time).

Capability mirror of mdlib's md_lammps.h (dispatched at
VIAMD src/loader.cpp:89-99 with atom-format sniffing for data
files; lammpstrj → Trajectory|MM).

Data files: header counts + box bounds, `Masses` and `Atoms` sections with
style sniffing (atomic / full / molecular / charge) — the analog of
md_lammps_atom_format_from_file. Dump files: `ITEM:`-delimited frames with
per-column layouts (x/xs/xu variants, scaled & unwrapped handled).
"""

from __future__ import annotations

import numpy as np

from viamd_tpu_torch.core.system import System, build_system, postprocess
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.core import elements as E
from viamd_tpu_torch.io.trajectory import Trajectory


def sniff_atom_style(ncols: int, comment_style: str | None) -> str:
    """Guess the Atoms-section style (md_lammps_atom_format analog)."""
    if comment_style:
        return comment_style
    # id mol type q x y z | id type q x y z | id mol type x y z | id type x y z
    return {
        5: "atomic",  # id type x y z
        6: "molecular",  # id mol type x y z
        7: "full_or_charge",
        8: "full",  # id mol type q x y z (+ image flags start at 9)
    }.get(ncols, "atomic")


def load_lammps_data(path: str, atom_style: str | None = None) -> System:
    with open(path) as f:
        lines = f.readlines()

    counts = {"atoms": 0, "atom types": 0}
    bounds = {}
    tilt = (0.0, 0.0, 0.0)
    masses: dict[int, float] = {}
    atoms_raw: list[list[str]] = []
    style_comment = None

    i = 1  # first line is a comment/title
    n = len(lines)
    section = None
    while i < n:
        raw = lines[i]
        line = raw.split("#")[0].strip()
        comment = raw.split("#")[1].strip() if "#" in raw else ""
        if not line:
            i += 1
            continue
        lowered = line.lower()
        first_tok = line.split()[0]
        is_numeric = first_tok.lstrip("+-").replace(".", "", 1).isdigit()
        matched_header = False
        for key in counts:
            if lowered.endswith(key) and is_numeric:
                counts[key] = int(first_tok)
                matched_header = True
        for dim, lo_hi in (("x", "xlo xhi"), ("y", "ylo yhi"), ("z", "zlo zhi")):
            if lowered.endswith(lo_hi):
                p = line.split()
                bounds[dim] = (float(p[0]), float(p[1]))
                matched_header = True
        if lowered.endswith("xy xz yz"):
            p = line.split()
            tilt = (float(p[0]), float(p[1]), float(p[2]))
            matched_header = True
        if matched_header:
            i += 1
            continue
        first = line.split()[0]
        if first in (
            "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
            "Impropers", "Pair", "PairIJ", "Bond", "Angle", "Dihedral",
            "Improper", "Atom",
        ):
            section = line.split()[0]
            if section == "Atoms" and comment:
                style_comment = comment.split()[0]
            i += 1
            continue
        if section == "Masses":
            p = line.split()
            if len(p) < 2:
                raise ValueError(
                    f"LAMMPS data: malformed Masses line {i + 1}"
                )
            masses[int(p[0])] = float(p[1])
        elif section == "Atoms":
            atoms_raw.append(line.split())
        elif section == "Bonds":
            pass  # collected below via atoms_raw pass
        i += 1

    if not atoms_raw:
        raise ValueError("LAMMPS data: no Atoms section")
    ncols = len(atoms_raw[0])
    style = atom_style or sniff_atom_style(ncols, style_comment)

    natoms = len(atoms_raw)
    xyz = np.empty((natoms, 3), np.float32)
    type_ids = np.empty(natoms, np.int32)
    mol_ids = np.zeros(natoms, np.int32)
    order = np.empty(natoms, np.int64)
    def _row_error(k, p):
        raise ValueError(
            f"LAMMPS data: malformed Atoms row {k + 1} "
            f"({len(p)} fields for style '{style}')"
        )

    for k, p in enumerate(atoms_raw):
        # per-row minimum is the STYLE's requirement, not the first row's
        # width (rows may legally differ by the optional image flags)
        if len(p) < 5:
            _row_error(k, p)
        order[k] = int(p[0])
        if style in ("full", "molecular") or (
            style == "full_or_charge" and ncols >= 7 and "." not in p[2]
        ):
            mol_ids[k] = int(p[1])
            type_ids[k] = int(p[2])
            off = 4 if style == "full" or (style == "full_or_charge") else 3
        else:
            type_ids[k] = int(p[1])
            off = 3 if style == "charge" or (
                style == "full_or_charge" and "." in p[2]
            ) else 2
        if off + 3 > len(p):
            _row_error(k, p)
        xyz[k] = [float(p[off]), float(p[off + 1]), float(p[off + 2])]
    # sort by atom id
    sidx = np.argsort(order)
    xyz, type_ids, mol_ids = xyz[sidx], type_ids[sidx], mol_ids[sidx]

    # box
    cell = UnitCell.none()
    if bounds:
        lx = bounds.get("x", (0, 0))
        ly = bounds.get("y", (0, 0))
        lz = bounds.get("z", (0, 0))
        xy, xz, yz = tilt
        basis = np.array(
            [
                [lx[1] - lx[0], 0, 0],
                [xy, ly[1] - ly[0], 0],
                [xz, yz, lz[1] - lz[0]],
            ],
            np.float32,
        )
        cell = UnitCell.from_basis(basis)
        xyz -= np.array([lx[0], ly[0], lz[0]], np.float32)

    # infer elements from masses (nearest element mass)
    type_to_z = {}
    for t, m in masses.items():
        type_to_z[t] = int(np.argmin(np.abs(E.MASSES[1:] - m))) + 1
    zs = np.array([type_to_z.get(int(t), 0) for t in type_ids], np.int32)
    names = [
        E.SYMBOLS[z] if z else f"T{t}" for z, t in zip(zs, type_ids)
    ]
    res_ids = mol_ids if mol_ids.any() else np.ones(natoms, np.int32)
    sys = build_system(
        coords=xyz,
        atom_names=names,
        res_names=["MOL"] * natoms,
        res_ids=res_ids,
        elements_z=zs,
        cell=cell,
    )
    return postprocess(sys)


def _box(fr: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, (3, 3) float32 basis) of a dump frame's BOX BOUNDS rows."""
    rows = fr["box"]
    lo = np.array([float(r[0]) for r in rows])
    hi = np.array([float(r[1]) for r in rows])
    if fr.get("triclinic"):
        xy, xz, yz = (float(rows[0][2]), float(rows[1][2]), float(rows[2][2]))
        # LAMMPS stores bounding-box-extended bounds; recover cell
        lo[0] -= min(0.0, xy, xz, xy + xz)
        hi[0] -= max(0.0, xy, xz, xy + xz)
        lo[1] -= min(0.0, yz)
        hi[1] -= max(0.0, yz)
        basis = np.array(
            [
                [hi[0] - lo[0], 0, 0],
                [xy, hi[1] - lo[1], 0],
                [xz, yz, hi[2] - lo[2]],
            ],
            np.float32,
        )
    else:
        basis = np.diag((hi - lo).astype(np.float32))
    return lo, hi, basis


class LammpsDumpTrajectory(Trajectory):
    """`dump atom/custom` text trajectories (ITEM: blocks)."""

    def __init__(self, path: str):
        self.path = path
        self._frames: list[dict] = []
        self._scan()

    def _scan(self):
        self._f = open(self.path, "r")
        f = self._f
        natoms = 0
        times = []
        while True:
            pos = f.tell()
            line = f.readline()
            if not line:
                break
            if line.startswith("ITEM: TIMESTEP"):
                step = int(f.readline())
                frame = {"start": pos, "step": step}
                self._frames.append(frame)
                times.append(float(step))
            elif line.startswith("ITEM: NUMBER OF ATOMS"):
                natoms = int(f.readline())
                self._frames[-1]["natoms"] = natoms
            elif line.startswith("ITEM: BOX BOUNDS"):
                rows = [f.readline().split() for _ in range(3)]
                self._frames[-1]["box"] = rows
                self._frames[-1]["triclinic"] = "xy" in line
            elif line.startswith("ITEM: ATOMS"):
                self._frames[-1]["cols"] = line.split()[2:]
                self._frames[-1]["data"] = f.tell()
                for _ in range(self._frames[-1]["natoms"]):
                    f.readline()
        self._natoms = natoms
        self._times = np.asarray(times, np.float64)
        self._cells = np.zeros((len(self._frames), 3, 3), np.float32)
        for i, fr in enumerate(self._frames):
            if "box" in fr:
                self._cells[i] = UnitCell.from_basis(_box(fr)[2]).basis

    @property
    def cells(self):
        return self._cells

    @property
    def num_frames(self):
        return len(self._frames)

    @property
    def num_atoms(self):
        return self._natoms

    @property
    def frame_times(self):
        return self._times

    def load_frame(self, idx: int):
        fr = self._frames[int(idx)]
        f = self._f
        f.seek(fr["data"])
        cols = fr["cols"]
        col = {c: i for i, c in enumerate(cols)}
        n = fr["natoms"]
        data = np.empty((n, len(cols)), np.float64)
        for k in range(n):
            data[k] = [float(t) for t in f.readline().split()]
        if "id" in col:
            data = data[np.argsort(data[:, col["id"]], kind="stable")]
        lo, hi, basis = _box(fr)
        cell = UnitCell.from_basis(basis)

        ext = hi - lo
        xyz = np.empty((n, 3), np.float32)
        for ax, (plain, scaled, unwrapped, scaled_u) in enumerate(
            [("x", "xs", "xu", "xsu"), ("y", "ys", "yu", "ysu"), ("z", "zs", "zu", "zsu")]
        ):
            if plain in col:
                xyz[:, ax] = data[:, col[plain]] - lo[ax]
            elif unwrapped in col:
                xyz[:, ax] = data[:, col[unwrapped]] - lo[ax]
            elif scaled in col:
                xyz[:, ax] = data[:, col[scaled]] * ext[ax]
            elif scaled_u in col:
                xyz[:, ax] = data[:, col[scaled_u]] * ext[ax]
            else:
                raise ValueError(f"lammpstrj: no {plain} column")
        return xyz, cell


def load_lammps_trajectory(path: str) -> LammpsDumpTrajectory:
    return LammpsDumpTrajectory(path)
