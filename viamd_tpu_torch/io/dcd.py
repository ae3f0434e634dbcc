"""CHARMM/NAMD DCD trajectory reader/writer.

Counterpart of viamd_tpu.io.dcd (mdlib's md_dcd.h): Fortran-unformatted
length-prefixed records, a 'CORD' header with frame count and flags (unit
cell, 4D, fixed atoms), a title record, the atom count, then per frame an
optional 6-double cell record and three float32 records (x, y, z).
Little/big endian and CHARMM/X-PLOR cell conventions. Frames sit at fixed
offsets → O(1) random access; the scan at open reads each frame's cell
record, so `cells` needs no coordinate read.
"""

from __future__ import annotations

import struct

import numpy as np

from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.io.trajectory import Trajectory


class DCDTrajectory(Trajectory):
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._parse_header()
        self._cells = np.zeros((self._nframes, 3, 3), np.float32)
        if self._has_cell:
            for i in range(self._nframes):
                self._f.seek(self._data_start + i * self._frame_bytes)
                self._cells[i] = self._read_cell(self._f).basis

    def _rec(self, f, endian):
        raw = f.read(4)
        if len(raw) < 4:
            raise EOFError
        (n,) = struct.unpack(endian + "i", raw)
        data = f.read(n)
        f.read(4)  # trailing length
        return data

    def _parse_header(self):
        f = self._f
        f.seek(0)
        head = f.read(8)
        if len(head) < 8:
            raise ValueError("DCD: truncated file")
        # detect endianness from the first record length (84)
        (n_le,) = struct.unpack("<i", head[:4])
        endian = "<" if n_le == 84 else ">"
        f.seek(0)
        hdr = self._rec(f, endian)
        if hdr[:4] != b"CORD":
            raise ValueError("DCD: missing CORD magic")
        ints = struct.unpack(endian + "20i", hdr[4:84])
        self.endian = endian
        nframes = ints[0]
        self._has_cell = ints[10] != 0
        self._charmm = ints[19] != 0
        self._four_d = self._charmm and ints[11] != 0
        # title + atom count
        self._rec(f, endian)  # titles
        natoms_rec = self._rec(f, endian)
        (self._natoms,) = struct.unpack(endian + "i", natoms_rec[:4])
        self._data_start = f.tell()
        # frame size: optional cell (6 doubles + 8 bytes framing) + 3 coord
        # records (+ optional 4th dim record)
        coord_rec = 4 + self._natoms * 4 + 4
        cell_rec = (4 + 48 + 4) if self._has_cell else 0
        ndim = 4 if self._four_d else 3
        self._frame_bytes = cell_rec + ndim * coord_rec
        # actual frame count from file size (headers lie sometimes)
        f.seek(0, 2)
        avail = (f.tell() - self._data_start) // self._frame_bytes
        self._nframes = int(min(nframes, avail) if nframes > 0 else avail)
        self._times = np.arange(self._nframes, dtype=np.float64)

    def _read_cell(self, f) -> UnitCell:
        """The cell record at `f`'s position (the frame's start)."""
        rec = self._rec(f, self.endian)
        vals = struct.unpack(self.endian + "6d", rec)
        a, gamma, b, beta, alpha, c = vals

        # CHARMM stores cosines of angles in [-1,1]; X-PLOR degrees
        def ang(v):
            if -1.0 <= v <= 1.0:
                return float(np.degrees(np.arccos(v)))
            return float(v)

        return UnitCell.from_lengths_angles(
            a, b, c, ang(alpha), ang(beta), ang(gamma)
        )

    @property
    def num_frames(self):
        return self._nframes

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
        f = self._f
        f.seek(self._data_start + int(idx) * self._frame_bytes)
        cell = self._read_cell(f) if self._has_cell else UnitCell.none()
        dt = np.dtype(self.endian + "f4")
        x = np.frombuffer(self._rec(f, self.endian), dtype=dt)
        y = np.frombuffer(self._rec(f, self.endian), dtype=dt)
        z = np.frombuffer(self._rec(f, self.endian), dtype=dt)
        xyz = np.stack(
            [x[: self._natoms], y[: self._natoms], z[: self._natoms]], axis=1
        ).astype(np.float32)
        return xyz, cell


def write_dcd(path: str, coords: np.ndarray, cell: UnitCell | None = None):
    """Write (F, n, 3) frames as a little-endian CHARMM DCD (fixture +
    export path); the same bytes as viamd_tpu.io.dcd.write_dcd."""
    coords = np.asarray(coords, np.float32)
    F, n, _ = coords.shape
    has_cell = cell is not None and cell.is_periodic

    def rec(payload: bytes) -> bytes:
        return struct.pack("<i", len(payload)) + payload + struct.pack("<i", len(payload))

    with open(path, "wb") as f:
        ints = [F, 0, 1, F, 0, 0, 0, 0, 0, 0]  # nframes, start, step...
        ints += [1 if has_cell else 0] + [0] * 8 + [1]  # charmm flag
        hdr = b"CORD" + struct.pack("<20i", *ints)
        f.write(rec(hdr))
        title = b"Created by viamd_tpu".ljust(80)
        f.write(rec(struct.pack("<i", 1) + title))
        f.write(rec(struct.pack("<i", n)))
        for fr in range(F):
            if has_cell:
                a, b, c, al, be, ga = cell.lengths_angles()
                f.write(
                    rec(
                        struct.pack(
                            "<6d",
                            a,
                            np.cos(np.radians(ga)),
                            b,
                            np.cos(np.radians(be)),
                            np.cos(np.radians(al)),
                            c,
                        )
                    )
                )
            for ax in range(3):
                f.write(rec(coords[fr, :, ax].astype("<f4").tobytes()))
