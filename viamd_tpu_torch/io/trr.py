"""Gromacs TRR trajectory reader/writer.

Counterpart of viamd_tpu.io.trr (mdlib's md_trr.h): big-endian XDR frames
— header (magic 1993, version string, section sizes for box, positions,
velocities, forces, natoms, step, time, lambda), then the present sections
as float32 or float64. Coordinates nm → Å. The scan at open records each
frame's header and reads its box, so `cells` needs no coordinate read.
"""

from __future__ import annotations

import struct

import numpy as np

from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.io.trajectory import Trajectory

NM_TO_ANGSTROM = 10.0
_MAGIC = 1993


def _cell(box: np.ndarray | None) -> UnitCell:
    """The cell of a frame's box section (nm), as the JAX reader builds it."""
    if box is None:
        return UnitCell.none()
    return UnitCell.from_basis((box * NM_TO_ANGSTROM).astype(np.float32))


class TRRTrajectory(Trajectory):
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._scan()

    def _read_header(self, f):
        start = f.tell()
        raw = f.read(8)
        if len(raw) < 8:
            return None
        magic, _ = struct.unpack(">2i", raw)
        if magic != _MAGIC:
            raise ValueError(f"TRR: bad magic {magic} at offset {start}")
        # version string: two ints (len, len again) + bytes padded to 4
        (slen,) = struct.unpack(">i", f.read(4))
        (_slen2,) = struct.unpack(">i", f.read(4))
        f.read((slen + 3) & ~3)
        (
            ir_size, e_size, box_size, vir_size, pres_size, top_size,
            sym_size, x_size, v_size, f_size, natoms, step, nre,
        ) = struct.unpack(">13i", f.read(52))
        # detect double precision from box/x sizes
        if box_size:
            double = box_size == 9 * 8
        elif x_size:
            double = x_size == natoms * 3 * 8
        else:
            double = False
        if double:
            t, lam = struct.unpack(">2d", f.read(16))
        else:
            t, lam = struct.unpack(">2f", f.read(8))
        return dict(
            start=start,
            ir=ir_size, e=e_size, box=box_size, vir=vir_size,
            pres=pres_size, x=x_size, v=v_size, f=f_size,
            natoms=natoms, step=step, time=t, double=double,
            data=f.tell(),
        )

    def _box(self, f, h) -> np.ndarray | None:
        """The (3, 3) box section of frame `h` (nm), or None; reads from the
        frame's data start, leaving `f` after the box."""
        f.seek(h["data"] + h["ir"] + h["e"])
        if not h["box"]:
            return None
        fdt = np.dtype(">f8" if h["double"] else ">f4")
        raw = f.read(h["box"])
        if len(raw) != 9 * fdt.itemsize:
            raise ValueError(f"TRR: truncated box at offset {h['start']}")
        return np.frombuffer(raw, dtype=fdt).reshape(3, 3)

    def _scan(self):
        f = self._f
        f.seek(0)
        self._frames = []
        times, cells = [], []
        natoms = 0
        while True:
            try:
                h = self._read_header(f)
            except (struct.error, EOFError):
                break
            if h is None:
                break
            try:
                cell = _cell(self._box(f, h))
            except ValueError:  # a truncated last frame: counted, as in
                cell = UnitCell.none()  # the JAX reader, and fails to load
            natoms = h["natoms"]
            self._frames.append(h)
            times.append(h["time"])
            cells.append(np.asarray(cell.basis, np.float32))
            skip = (
                h["ir"] + h["e"] + h["box"] + h["vir"] + h["pres"]
                + h["x"] + h["v"] + h["f"]
            )
            f.seek(h["data"] + skip)
        self._natoms = natoms
        self._times = np.asarray(times, np.float64)
        self._cells = (np.stack(cells) if cells else np.zeros((0, 3, 3))).astype(np.float32)

    @property
    def num_frames(self):
        return len(self._frames)

    @property
    def num_atoms(self):
        return self._natoms

    @property
    def frame_times(self):
        return self._times

    @property
    def cells(self):
        return self._cells

    def load_frame(self, idx: int):
        h = self._frames[int(idx)]
        f = self._f
        cell = _cell(self._box(f, h))
        fdt = np.dtype(">f8" if h["double"] else ">f4")
        f.seek(h["vir"] + h["pres"], 1)
        if not h["x"]:
            raise ValueError("TRR frame has no coordinates")
        xyz = np.frombuffer(f.read(h["x"]), dtype=fdt).reshape(
            h["natoms"], 3
        )
        return (xyz * NM_TO_ANGSTROM).astype(np.float32), cell


def write_trr(
    path: str,
    coords: np.ndarray,
    cell: UnitCell | None = None,
    times: np.ndarray | None = None,
):
    """Write (F, n, 3) Å frames as single-precision TRR (fixture + export);
    the same bytes as viamd_tpu.io.trr.write_trr."""
    coords = np.asarray(coords, np.float64) / NM_TO_ANGSTROM
    F, n, _ = coords.shape
    box = (
        np.asarray(cell.basis, np.float64) / NM_TO_ANGSTROM
        if cell is not None and cell.is_periodic
        else None
    )
    with open(path, "wb") as f:
        for fr in range(F):
            ver = b"GMX_trn_file"
            slen = len(ver) + 1
            padded_len = (slen + 3) & ~3
            f.write(struct.pack(">2i", _MAGIC, 13))
            f.write(struct.pack(">2i", slen, len(ver)))
            f.write(ver + b"\0" * (padded_len - len(ver)))
            box_size = 36 if box is not None else 0
            x_size = n * 12
            f.write(
                struct.pack(
                    ">13i", 0, 0, box_size, 0, 0, 0, 0, x_size, 0, 0,
                    n, fr, 0,
                )
            )
            t = float(times[fr]) if times is not None else float(fr)
            f.write(struct.pack(">2f", t, 0.0))
            if box is not None:
                f.write(box.astype(">f4").tobytes())
            f.write(coords[fr].astype(">f4").tobytes())
