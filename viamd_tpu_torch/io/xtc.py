"""Gromacs XTC trajectory reader/writer (host C++ codec).

Counterpart of viamd_tpu.io.xtc (mdlib's md_xtc.h). Decoding runs in the
port's copy of the codec (`csrc/host/xtc.cpp`, built by
`viamd_tpu_torch.cuda_build`); the scan at open records each frame's byte
range, time and box, so frames are read by range (O(1) random access, no
read of the rest of the file) and `cells` needs no decode. nm → Å.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.cuda_build import Library
from viamd_tpu_torch.io.trajectory import Trajectory

NM_TO_ANGSTROM = 10.0

_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


LIBRARY = Library("vtt_xtc", ("host/xtc.cpp",), {
    "xtc_scan": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_int64, _i64p, _i64p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double), _f32p,
    ]),
    "xtc_read_frames": (ctypes.c_int32, [
        ctypes.c_char_p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int32, _f32p, _f32p,
    ]),
    "xtc_write_frames": (ctypes.c_int32, [
        ctypes.c_char_p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
    ]),
})


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class XTCTrajectory(Trajectory):
    def __init__(self, path: str, max_frames: int | None = None):
        self.path = path
        lib = LIBRARY.load()
        if max_frames is None:
            # a frame takes at least 56 bytes (header, box, atom count)
            max_frames = os.path.getsize(path) // 56 + 1
        offsets = np.zeros(max_frames, np.int64)
        ends = np.zeros(max_frames, np.int64)
        times = np.zeros(max_frames, np.float64)
        boxes = np.zeros((max_frames, 9), np.float32)
        natoms = ctypes.c_int32(0)
        n = lib.xtc_scan(
            path.encode(), max_frames, _ptr(offsets, _i64p), _ptr(ends, _i64p),
            ctypes.byref(natoms),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _ptr(boxes, _f32p),
        )
        if n <= 0:
            raise ValueError(
                f"XTC: no readable frames in '{path}'"
                if n == 0
                else f"XTC: failed to scan '{path}'"
            )
        self._offsets = offsets[:n].copy()
        self._ends = ends[:n].copy()
        self._times = times[:n].copy()
        self._cells = (boxes[:n].reshape(n, 3, 3) * NM_TO_ANGSTROM).astype(np.float32)
        self._natoms = int(natoms.value)

    @property
    def num_frames(self):
        return int(self._offsets.size)

    @property
    def num_atoms(self):
        return self._natoms

    @property
    def frame_times(self):
        return self._times

    @property
    def cells(self):
        return self._cells

    def _decode(self, indices, coords: np.ndarray) -> np.ndarray:
        """Decode frames `indices` into `coords` ((B, n, 3) float32, nm →
        Å in place); → (B, 9) float32 boxes in nm."""
        idx = np.asarray(list(indices), np.int64)
        offs = np.ascontiguousarray(self._offsets[idx])
        ends = np.ascontiguousarray(self._ends[idx])
        if coords.shape != (idx.size, self._natoms, 3) or coords.dtype != np.float32 \
                or not coords.flags.c_contiguous:
            raise ValueError(f"XTC: output must be C-contiguous float32 "
                             f"{(idx.size, self._natoms, 3)}")
        boxes = np.empty((idx.size, 9), np.float32)
        rc = LIBRARY.load().xtc_read_frames(
            self.path.encode(), _ptr(offs, _i64p), _ptr(ends, _i64p), idx.size,
            self._natoms, _ptr(coords, _f32p), _ptr(boxes, _f32p),
        )
        if rc != 0:
            raise ValueError(f"XTC: decode error {rc} in '{self.path}'")
        coords *= NM_TO_ANGSTROM
        return boxes

    def load_frames(self, indices):
        idx = list(indices)
        coords = np.empty((len(idx), self._natoms, 3), np.float32)
        boxes = self._decode(idx, coords)
        cells = (boxes.reshape(len(idx), 3, 3) * NM_TO_ANGSTROM).astype(np.float32)
        return coords, cells

    def load_frames_into(self, indices, out):
        self._decode(indices, out)

    def load_frame(self, idx: int):
        coords, cells = self.load_frames([int(idx)])
        return coords[0], UnitCell.from_basis(cells[0])


def write_xtc(
    path: str,
    coords: np.ndarray,  # (F, n, 3) Å
    cell: UnitCell | None = None,
    precision: float = 1000.0,
):
    """Write frames as XTC (tests and the export path); the same bytes as
    viamd_tpu.io.xtc.write_xtc."""
    lib = LIBRARY.load()
    coords = np.ascontiguousarray(
        np.asarray(coords, np.float32) / NM_TO_ANGSTROM
    )
    F, n, _ = coords.shape
    basis = (
        np.asarray(cell.basis, np.float32) / NM_TO_ANGSTROM
        if cell is not None and cell.is_periodic
        else np.zeros((3, 3), np.float32)
    )
    boxes = np.ascontiguousarray(
        np.broadcast_to(basis, (F, 3, 3)).reshape(F, 9).astype(np.float32)
    )
    rc = lib.xtc_write_frames(
        path.encode(), _ptr(coords, _f32p), _ptr(boxes, _f32p), F, n, precision,
    )
    if rc != 0:
        raise ValueError(f"XTC: write error {rc}")
