"""XYZ / XMOL / Tinker ARC loader (system + trajectory) — numpy copy of
viamd_tpu.io.xyz.

Capability mirror of mdlib's md_xyz.h (dispatched at
VIAMD src/loader.cpp (xyz/xmol/arc extensions carry
System|Trajectory flags, loader.cpp:63-65)).

Supports:
- plain XYZ: `N\\ncomment\\nSym x y z` blocks, concatenated frames
- extended XMOL comment `Lattice="ax ay az bx by bz cx cy cz"` cells
- Tinker ARC: `idx Sym x y z [type [bonded...]]` with optional cell line
"""

from __future__ import annotations

import numpy as np

from viamd_tpu_torch.core.system import System, build_system, postprocess
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.core import elements as E
from viamd_tpu_torch.io.trajectory import InMemoryTrajectory


def _parse_lattice(comment: str) -> UnitCell:
    key = 'Lattice="'
    i = comment.find(key)
    if i < 0:
        return UnitCell.none()
    j = comment.find('"', i + len(key))
    try:
        v = [float(t) for t in comment[i + len(key) : j].split()]
        if len(v) == 9:
            return UnitCell.from_basis(np.array(v, np.float32).reshape(3, 3))
    except ValueError:
        pass
    return UnitCell.none()


def _is_cell_line(tokens: list[str]) -> bool:
    """Tinker ARC cell line: 6 floats (a b c alpha beta gamma)."""
    if len(tokens) != 6:
        return False
    try:
        [float(t) for t in tokens]
        return True
    except ValueError:
        return False


def parse_xyz(text: str | bytes) -> tuple[System, InMemoryTrajectory | None]:
    if isinstance(text, bytes):
        text = text.decode("ascii", "replace")
    lines = text.splitlines()
    pos = 0
    frames: list[np.ndarray] = []
    cells: list[np.ndarray] = []
    names: list[str] = []
    bonds: list[tuple[int, int]] = []
    first = True
    natoms = None

    while pos < len(lines):
        line = lines[pos].strip()
        if not line:
            pos += 1
            continue
        # header: first token is the atom count (ARC may append a title)
        try:
            natoms = int(line.split()[0])
        except ValueError:
            raise ValueError(f"XYZ: expected atom count at line {pos + 1}")
        is_arc = len(line.split()) > 1  # Tinker header has count + title
        pos += 1
        cell = UnitCell.none()
        if pos < len(lines):
            tokens = lines[pos].split()
            if is_arc and _is_cell_line(tokens):
                v = [float(t) for t in tokens]
                cell = UnitCell.from_lengths_angles(*v)
                pos += 1
            elif not is_arc:
                cell = _parse_lattice(lines[pos])
                pos += 1  # comment line
        if natoms < 0:
            raise ValueError(f"XYZ: negative atom count at line {pos}")
        if pos + natoms > len(lines):
            raise ValueError(
                f"XYZ: truncated frame — {natoms} atoms declared, "
                f"{len(lines) - pos} lines remain"
            )
        xyz = np.empty((natoms, 3), np.float32)
        for i in range(natoms):
            t = lines[pos + i].split()
            if len(t) < 4:
                raise ValueError(f"XYZ: malformed atom row at line {pos+i+1}")
            if t and t[0].isdigit() and len(t) >= 5:
                # Tinker ARC row: idx Sym x y z [type bonded...]
                sym = t[1]
                xyz[i] = [float(t[2]), float(t[3]), float(t[4])]
                if first:
                    names.append(sym)
                    for bt in t[6:]:
                        j = int(bt) - 1
                        if j > i:
                            bonds.append((i, j))
            else:
                sym = t[0]
                xyz[i] = [float(t[1]), float(t[2]), float(t[3])]
                if first:
                    names.append(sym)
        pos += natoms
        frames.append(xyz)
        cells.append(np.asarray(cell.basis, np.float32))
        first = False

    if not frames:
        raise ValueError("XYZ: no frames found")
    n = frames[0].shape[0]
    z = np.array([E.symbol_to_z(s) or E.infer_element(s) for s in names], np.int32)
    sys = build_system(
        coords=frames[0],
        atom_names=names,
        res_names=["UNL"] * n,
        res_ids=[1] * n,
        elements_z=z,
        cell=UnitCell.from_basis(cells[0]),
    )
    if bonds:
        sys.bonds = np.array(sorted(set(bonds)), np.int32)
    sys = postprocess(sys)
    traj = None
    if len(frames) > 1:
        traj = InMemoryTrajectory(np.stack(frames), cells=np.stack(cells))
    return sys, traj


def load_xyz(path: str) -> tuple[System, InMemoryTrajectory | None]:
    with open(path, "r") as f:
        return parse_xyz(f.read())
