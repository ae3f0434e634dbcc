"""Packed trajectory cache (.vtraj): O(1) random access, mmap-backed.

Counterpart of viamd_tpu.io.cache, in the same layout and byte order, so a
cache written by either package opens in the other (the analog of mdlib's
sidecar trajectory cache files, VIAMD src/loader.cpp:118-121). Layout:

  header (64 B): magic 'VTRJ', version u32, natoms u64, nframes u64,
                 flags u64, reserved
  times:  (F,) float64
  cells:  (F, 3, 3) float32 row-vector bases
  coords: (F, n, 3) float32   ← frame-major: a contiguous frame range is
                                 one slice of the memmap
"""

from __future__ import annotations

import os
import struct

import numpy as np

from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.io.trajectory import Trajectory

MAGIC = b"VTRJ"
VERSION = 1
_HEADER = 64


def _header(f, natoms: int, nframes: int) -> None:
    f.write(MAGIC)
    f.write(struct.pack("<IQQQ", VERSION, natoms, nframes, 0))
    f.write(b"\0" * (_HEADER - f.tell()))


def write_cache(
    path: str,
    coords_iter,
    natoms: int,
    nframes: int,
    times: np.ndarray | None = None,
    cells: np.ndarray | None = None,
):
    """Write a cache from an iterable of ((n,3) f32, (3,3) basis) frames
    (or bare (n, 3) frames); the same bytes as viamd_tpu.io.cache."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _header(f, natoms, nframes)
        t = (
            np.asarray(times, np.float64)
            if times is not None
            else np.arange(nframes, dtype=np.float64)
        )
        f.write(t[:nframes].tobytes())
        if cells is not None:
            f.write(np.asarray(cells, np.float32)[:nframes].tobytes())
            for item in coords_iter:
                xyz = item[0] if isinstance(item, tuple) else item
                f.write(np.ascontiguousarray(xyz, np.float32).tobytes())
        else:
            cell_arr = np.zeros((nframes, 3, 3), np.float32)
            frames_data = []
            for k, item in enumerate(coords_iter):
                if isinstance(item, tuple):
                    xyz, basis = item
                    cell_arr[k] = np.asarray(basis, np.float32)
                else:
                    xyz = item
                frames_data.append(np.ascontiguousarray(xyz, np.float32))
            f.write(cell_arr.tobytes())
            for xyz in frames_data:
                f.write(xyz.tobytes())
    os.replace(tmp, path)


def transcode(traj: Trajectory, path: str, chunk: int = 64):
    """Transcode any Trajectory into a .vtraj cache, `chunk` frames a read;
    the cells come from the frames read (as the JAX package's)."""
    F, n = traj.num_frames, traj.num_atoms
    cells = np.zeros((F, 3, 3), np.float32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _header(f, n, F)
        f.write(np.asarray(traj.frame_times, np.float64)[:F].tobytes())
        cell_pos = f.tell()
        f.write(cells.tobytes())  # placeholder, rewritten below
        for beg in range(0, F, chunk):
            coords, cls = traj.load_frames(list(range(beg, min(beg + chunk, F))))
            cells[beg : beg + coords.shape[0]] = cls
            f.write(np.ascontiguousarray(coords, np.float32).tobytes())
        f.seek(cell_pos)
        f.write(cells.tobytes())
    os.replace(tmp, path)


class PackedTrajectory(Trajectory):
    """mmap-backed reader for .vtraj caches."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != MAGIC:
                raise ValueError(f"not a vtraj cache: {path}")
            version, natoms, nframes, _flags = struct.unpack(
                "<IQQQ", f.read(28)
            )
            if version != VERSION:
                raise ValueError(f"vtraj version {version} unsupported")
        self._natoms = int(natoms)
        self._nframes = int(nframes)
        # corrupt-header guard: the declared sizes must fit the file
        expect = (
            _HEADER
            + self._nframes * (8 + 36)
            + self._nframes * self._natoms * 12
        )
        actual = os.path.getsize(path)
        if self._natoms <= 0 or self._nframes <= 0 or expect > actual:
            raise ValueError(
                f"vtraj cache '{path}': header declares "
                f"{self._nframes}×{self._natoms} atoms "
                f"({expect} bytes) but the file has {actual}"
            )
        off_times = _HEADER
        off_cells = off_times + 8 * self._nframes
        off_coords = off_cells + 4 * 9 * self._nframes
        self._times = np.memmap(
            path, np.float64, "r", offset=off_times, shape=(self._nframes,)
        )
        self._cells = np.memmap(
            path, np.float32, "r", offset=off_cells,
            shape=(self._nframes, 3, 3),
        )
        self._coords = np.memmap(
            path, np.float32, "r", offset=off_coords,
            shape=(self._nframes, self._natoms, 3),
        )

    @property
    def num_frames(self):
        return self._nframes

    @property
    def num_atoms(self):
        return self._natoms

    @property
    def frame_times(self):
        return np.asarray(self._times)

    @property
    def cells(self):
        return np.asarray(self._cells)

    def load_frame(self, idx: int):
        return (
            np.asarray(self._coords[int(idx)]),
            UnitCell.from_basis(np.asarray(self._cells[int(idx)])),
        )

    def load_frames(self, indices):
        idx = np.asarray(indices, np.int64)
        return np.asarray(self._coords[idx]), np.asarray(self._cells[idx])

    def load_frames_into(self, indices, out):
        idx = np.asarray(indices, np.int64)
        beg = int(idx[0]) if idx.size else 0
        if idx.size and np.array_equal(idx, np.arange(beg, beg + idx.size)):
            np.copyto(out, self._coords[beg : beg + idx.size])  # one slice
        else:
            np.take(self._coords, idx, axis=0, out=out)
