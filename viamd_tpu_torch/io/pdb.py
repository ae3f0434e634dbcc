"""PDB loader (system + multi-MODEL trajectory) — numpy copy of
viamd_tpu.io.pdb; the multi-model coordinate pass runs in the port's copy
of the host parser (`csrc/host/fastparse.cpp`).

Capability mirror of mdlib's md_pdb.h loader (dispatched from
VIAMD src/loader.cpp:124-160; PDB carries both System and
Trajectory flags, loader.cpp:60-66).

Parsing is vectorized: ATOM/HETATM lines are packed into a fixed-width byte
matrix and columns are sliced with NumPy, so multi-thousand-frame PDB
trajectories load at memory bandwidth rather than Python-loop speed.
"""

from __future__ import annotations

import ctypes

import numpy as np

from viamd_tpu_torch.core.system import System, build_system, postprocess
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.cuda_build import Library
from viamd_tpu_torch.io.trajectory import InMemoryTrajectory


def _lines_to_matrix(lines: list[bytes], width: int = 80) -> np.ndarray:
    buf = np.zeros((len(lines), width), dtype=np.uint8)
    buf[:] = ord(" ")
    for i, ln in enumerate(lines):
        ln = ln[:width]
        buf[i, : len(ln)] = np.frombuffer(ln, np.uint8)
    return buf


def _col_str(mat: np.ndarray, beg: int, end: int) -> list[str]:
    """1-based inclusive column range → stripped strings."""
    sub = mat[:, beg - 1 : end]
    return [bytes(row).decode("ascii", "replace").strip() for row in sub]


def _col_float(mat: np.ndarray, beg: int, end: int) -> np.ndarray:
    sub = mat[:, beg - 1 : end]
    flat = sub.tobytes().decode("ascii", "replace")
    w = end - beg + 1
    vals = np.empty(mat.shape[0], np.float32)
    for i in range(mat.shape[0]):
        s = flat[i * w : (i + 1) * w].strip()
        vals[i] = float(s) if s else 0.0
    return vals


def _coords_fast(mat: np.ndarray) -> np.ndarray:
    """Parse x/y/z columns (31-54) quickly for coordinate-only frames."""
    n = mat.shape[0]
    out = np.empty((n, 3), np.float32)
    raw = mat[:, 30:54].tobytes().decode("ascii", "replace")
    for i in range(n):
        s = raw[i * 24 : (i + 1) * 24]
        out[i, 0] = float(s[0:8])
        out[i, 1] = float(s[8:16])
        out[i, 2] = float(s[16:24])
    return out


def parse_pdb(text: bytes | str) -> tuple[System, InMemoryTrajectory | None]:
    """Parse PDB text → (postprocessed System, trajectory if multi-MODEL)."""
    if isinstance(text, str):
        text = text.encode("ascii", "replace")
    lines = text.splitlines()

    cell = UnitCell.none()
    frames_atom_lines: list[list[bytes]] = []
    cur: list[bytes] = []
    in_model = False
    conect_lines: list[bytes] = []
    n_models = 0

    for ln in lines:
        rec = ln[:6]
        if rec.startswith(b"ATOM") or rec.startswith(b"HETATM"):
            cur.append(ln)
        elif rec.startswith(b"MODEL"):
            in_model = True
            n_models += 1
            if cur:
                frames_atom_lines.append(cur)
                cur = []
        elif rec.startswith(b"ENDMDL"):
            in_model = False
            if cur:
                frames_atom_lines.append(cur)
                cur = []
        elif rec.startswith(b"CRYST1"):
            try:
                s = ln.decode("ascii", "replace")
                a, b, c = float(s[6:15]), float(s[15:24]), float(s[24:33])
                al, be, ga = float(s[33:40]), float(s[40:47]), float(s[47:54])
                if not (a == 1.0 and b == 1.0 and c == 1.0):  # dummy cell
                    cell = UnitCell.from_lengths_angles(a, b, c, al, be, ga)
            except ValueError:
                pass
        elif rec.startswith(b"CONECT"):
            conect_lines.append(ln)
        elif rec.startswith(b"END") or rec.startswith(b"TER"):
            pass
    if cur:
        frames_atom_lines.append(cur)

    if not frames_atom_lines:
        raise ValueError("PDB: no ATOM/HETATM records found")

    first = _lines_to_matrix(frames_atom_lines[0])
    names = _col_str(first, 13, 16)
    resnames = _col_str(first, 18, 21)
    chains = _col_str(first, 22, 22)
    resseq = [int(s) if s else 0 for s in _col_str(first, 23, 26)]
    xyz = _coords_fast(first)
    occ = _col_float(first, 55, 60)
    bfac = _col_float(first, 61, 66)
    elem_sym = _col_str(first, 77, 78)

    from viamd_tpu_torch.core import elements as E

    z = np.array(
        [E.symbol_to_z(s) if s else 0 for s in elem_sym], np.int32
    )

    sys = build_system(
        coords=xyz,
        atom_names=names,
        res_names=resnames,
        res_ids=resseq,
        chain_ids=chains,
        elements_z=z,
        cell=cell,
        occupancy=occ,
        bfactor=bfac,
    )

    # CONECT bonds (serial numbers → 0-based; assume serial = 1-based order)
    serials = _col_str(first, 7, 11)
    serial_to_idx = {}
    for i, s in enumerate(serials):
        if s:
            try:
                serial_to_idx[int(s)] = i
            except ValueError:
                pass
    conect_pairs = []
    for ln in conect_lines:
        s = ln.decode("ascii", "replace")
        try:
            a0 = int(s[6:11])
        except ValueError:
            continue
        for beg in (11, 16, 21, 26):
            part = s[beg : beg + 5].strip()
            if part:
                try:
                    conect_pairs.append((a0, int(part)))
                except ValueError:
                    pass
    explicit_bonds = None
    if conect_pairs:
        pairs = [
            (serial_to_idx[a], serial_to_idx[b])
            for a, b in conect_pairs
            if a in serial_to_idx and b in serial_to_idx
        ]
        if pairs:
            arr = np.array(pairs, np.int32)
            lo = arr.min(axis=1)
            hi = arr.max(axis=1)
            explicit_bonds = np.unique(
                np.stack([lo, hi], axis=1), axis=0
            ).astype(np.int32)

    sys = postprocess(sys)
    if explicit_bonds is not None and explicit_bonds.size:
        allb = (
            np.concatenate([sys.bonds, explicit_bonds])
            if sys.nbonds
            else explicit_bonds
        )
        sys.bonds = np.unique(allb, axis=0)

    traj = None
    n = sys.natoms
    if len(frames_atom_lines) > 1:
        coords = _parse_frames_native(text, n, len(frames_atom_lines))
        if coords is None:
            coords = np.empty((len(frames_atom_lines), n, 3), np.float32)
            coords[0] = xyz
            for f, flines in enumerate(frames_atom_lines[1:], start=1):
                if len(flines) != n:
                    raise ValueError(
                        f"PDB MODEL {f + 1} has {len(flines)} atoms, "
                        f"expected {n}"
                    )
                coords[f] = _coords_fast(_lines_to_matrix(flines, width=56))
        traj = InMemoryTrajectory(coords, cell=cell)
    return sys, traj


LIBRARY = Library("vtt_fastparse", ("host/fastparse.cpp",), {
    "pdb_parse_coords": (ctypes.c_int32, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]),
})


def _parse_frames_native(text: bytes, natoms: int, nframes: int):
    """Multi-frame coordinate pass through the host parser
    (csrc/host/fastparse.cpp); None when the file does not parse there, so
    the Python pass names the fault. A failed build raises."""
    coords = np.empty((nframes, natoms, 3), np.float32)
    rc = LIBRARY.load().pdb_parse_coords(
        text, len(text), natoms, nframes,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return coords if rc == 0 else None


def load_pdb(path: str) -> tuple[System, InMemoryTrajectory | None]:
    with open(path, "rb") as f:
        return parse_pdb(f.read())


def write_pdb(
    sys: System,
    coords_frames: np.ndarray | None = None,
    mask=None,
) -> str:
    """Serialize a System (optionally multiple frames / an atom subset) to PDB.

    Mirrors the structure-export capability of the reference
    (VIAMD src/main.cpp:6066-6093: query-filtered subsets,
    all/current/range frames → pdb).
    """
    idx = (
        np.asarray(mask.indices() if hasattr(mask, "indices") else mask)
        if mask is not None
        else np.arange(sys.natoms)
    )
    out = []
    if sys.cell.is_periodic:
        a, b, c, al, be, ga = sys.cell.lengths_angles()
        out.append(
            f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}{al:7.2f}{be:7.2f}{ga:7.2f} P 1           1"
        )
    frames = (
        coords_frames
        if coords_frames is not None
        else sys.coords()[None, :, :]
    )
    if frames.ndim == 2:
        frames = frames[None]
    multi = frames.shape[0] > 1
    rnid = sys.atom_res_name_id()
    rid = sys.atom_res_id()
    from viamd_tpu_torch.core import elements as E

    for f in range(frames.shape[0]):
        if multi:
            out.append(f"MODEL     {f + 1:4d}")
        xyz = frames[f]
        for k, i in enumerate(idx):
            name = sys.atom_names[sys.atom_name_id[i]]
            if len(name) < 4:
                name = " " + name
            resn = sys.res_names[rnid[i]][:4]
            ch = (
                sys.chain_labels[sys.atom_chain_idx[i]][:1]
                if sys.atom_chain_idx[i] >= 0
                else " "
            ) or " "
            sym = E.SYMBOLS[sys.element[i]] if sys.element[i] else ""
            out.append(
                f"ATOM  {(k + 1) % 100000:5d} {name:<4.4s} "
                f"{resn:<3.3s} {ch:1.1s}{int(rid[i]) % 10000:4d}    "
                f"{xyz[i, 0]:8.3f}{xyz[i, 1]:8.3f}{xyz[i, 2]:8.3f}"
                f"{1.0:6.2f}{0.0:6.2f}          {sym:>2.2s}"
            )
        if multi:
            out.append("ENDMDL")
    out.append("END")
    return "\n".join(out) + "\n"
