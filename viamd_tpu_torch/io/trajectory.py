"""Trajectory containers.

Counterpart of viamd_tpu.io.trajectory (mdlib's md_trajectory_i: frame
count, atom count, frame times, random-access frames —
VIAMD src/viamd.cpp:439-516).

Every trajectory exposes `cells`, the (F, 3, 3) float32 cell bases of all
frames, known once the file is open (the readers take them from the frame
headers at scan time): the Evaluator fits its cell-list grids to them
before the first frame. `load_frames` gives host numpy batches,
`load_frames_into` writes a batch's coordinates into a caller's buffer
(the Evaluator's page-locked staging buffers).

`InMemoryTrajectory` holds numpy frames on the host (what generators and
loaders produce); `CachedTrajectory` is an LRU of single frames over
another trajectory (interactive playback). `DeviceTrajectory` holds the
whole (F, n, 3) float32 frame stack and the cell bases as tensors on one
explicit device; the Evaluator reads frames from it as zero-copy views.
`DeviceTrajectory.stage(traj, device)` moves any trajectory there in one
copy from page-locked memory.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from viamd_tpu_torch.core.unitcell import UnitCell


class Trajectory:
    """Random access to the frames of a fixed-size system."""

    @property
    def num_frames(self) -> int:
        raise NotImplementedError

    @property
    def num_atoms(self) -> int:
        raise NotImplementedError

    @property
    def frame_times(self) -> np.ndarray:
        """(num_frames,) float64 times in ps."""
        raise NotImplementedError

    @property
    def cells(self) -> np.ndarray:
        """(num_frames, 3, 3) float32 row-vector cell bases (zeros where a
        frame has no cell)."""
        raise NotImplementedError

    def load_frame(self, idx: int) -> tuple[np.ndarray, UnitCell]:
        """((n, 3) float32 coords, cell) of one frame."""
        raise NotImplementedError

    def load_frames(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        """((B, n, 3) float32 coords, (B, 3, 3) float32 cell bases).

        The default loops `load_frame`; readers with a batched path
        override it."""
        coords = np.empty((len(indices), self.num_atoms, 3), np.float32)
        cells = np.empty((len(indices), 3, 3), np.float32)
        for k, idx in enumerate(indices):
            xyz, cell = self.load_frame(int(idx))
            coords[k] = xyz
            cells[k] = np.asarray(cell.basis)
        return coords, cells

    def load_frames_into(self, indices: Sequence[int], out: np.ndarray) -> None:
        """Write the coordinates of `indices` into `out`, a (B, n, 3)
        float32 C-contiguous array: the values `load_frames` gives."""
        out[...] = self.load_frames(indices)[0]

    def cell_of(self, idx: int) -> UnitCell:
        return UnitCell.from_basis(self.cells[int(idx)])


class InMemoryTrajectory(Trajectory):
    """All frames resident on the host: (F, n, 3) float32 + per-frame cells."""

    def __init__(
        self,
        coords: np.ndarray,
        cells: Optional[np.ndarray] = None,
        times: Optional[np.ndarray] = None,
        cell: Optional[UnitCell] = None,
    ):
        coords = np.asarray(coords, np.float32)
        if coords.ndim != 3 or coords.shape[2] != 3:
            raise ValueError(f"coords must be (F, n, 3), got {coords.shape}")
        self._coords = coords
        f = coords.shape[0]
        if cells is None:
            basis = (
                np.asarray(cell.basis, np.float32)
                if cell is not None
                else np.zeros((3, 3), np.float32)
            )
            cells = np.broadcast_to(basis, (f, 3, 3)).copy()
        self._cells = np.asarray(cells, np.float32)
        self._times = (
            np.asarray(times, np.float64)
            if times is not None
            else np.arange(f, dtype=np.float64)
        )

    @property
    def num_frames(self) -> int:
        return self._coords.shape[0]

    @property
    def num_atoms(self) -> int:
        return self._coords.shape[1]

    @property
    def frame_times(self) -> np.ndarray:
        return self._times

    @property
    def cells(self) -> np.ndarray:
        return self._cells

    def load_frame(self, idx: int):
        return self._coords[idx], UnitCell.from_basis(self._cells[idx])

    def load_frames(self, indices):
        idx = np.asarray(indices, np.int64)
        return self._coords[idx], self._cells[idx]

    def load_frames_into(self, indices, out):
        np.take(self._coords, np.asarray(indices, np.int64), axis=0, out=out)


class CachedTrajectory(Trajectory):
    """LRU frame cache over another trajectory (interactive playback path;
    the 4-slot frame cache of VIAMD src/viamd.h:43,957-961)."""

    def __init__(self, inner: Trajectory, capacity: int = 4):
        self.inner = inner
        self.capacity = capacity
        self._lru: OrderedDict[int, tuple[np.ndarray, UnitCell]] = OrderedDict()

    @property
    def num_frames(self):
        return self.inner.num_frames

    @property
    def num_atoms(self):
        return self.inner.num_atoms

    @property
    def frame_times(self):
        return self.inner.frame_times

    @property
    def cells(self):
        return self.inner.cells

    def load_frame(self, idx: int):
        idx = int(idx)
        hit = self._lru.get(idx)
        if hit is not None:
            self._lru.move_to_end(idx)
            return hit
        val = self.inner.load_frame(idx)
        self._lru[idx] = val
        if len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return val

    def load_frames(self, indices):
        return self.inner.load_frames(indices)

    def load_frames_into(self, indices, out):
        self.inner.load_frames_into(indices, out)


class DeviceTrajectory(Trajectory):
    """Frames resident on one device: stack (F, n, 3) f32, cells (F, 3, 3).

    `stack` is a tensor (already on its device); `cells` may be numpy or a
    tensor and is moved to the stack's device. `stage(traj, device)` builds
    one from any trajectory.
    """

    def __init__(self, stack: torch.Tensor, cells, times=None):
        if stack.dtype != torch.float32 or stack.ndim != 3 or stack.shape[2] != 3:
            raise ValueError(
                f"stack must be (F, n, 3) float32, got {tuple(stack.shape)} "
                f"{stack.dtype}"
            )
        self.stack = stack
        if isinstance(cells, torch.Tensor):
            cells = cells.to(device=stack.device, dtype=torch.float32)
        else:
            cells = torch.as_tensor(np.array(cells, np.float32), device=stack.device)
        self._cells = cells.reshape(stack.shape[0], 3, 3)
        self._times = (
            np.asarray(times, np.float64)
            if times is not None
            else np.arange(stack.shape[0], dtype=np.float64)
        )

    @classmethod
    def stage(cls, inner: Trajectory, device="cuda") -> "DeviceTrajectory":
        """All of `inner`'s frames on `device` (the JAX package's
        `DeviceTrajectory(inner)`): the frames are loaded into one host
        buffer — page-locked for a CUDA device — and copied in one
        transfer, which the caller's stream orders before any later work.
        A CUDA device that cannot pin or copy raises."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        shape = (inner.num_frames, inner.num_atoms, 3)
        host = torch.empty(shape, dtype=torch.float32, pin_memory=device.type == "cuda")
        inner.load_frames_into(range(inner.num_frames), host.numpy())
        stack = host.to(device, non_blocking=True) if device.type == "cuda" else host
        cells = np.asarray(inner.cells, np.float32).reshape(-1, 3, 3)
        return cls(stack, cells, inner.frame_times)

    @property
    def device(self) -> torch.device:
        return self.stack.device

    @property
    def cells(self) -> torch.Tensor:
        """(F, 3, 3) float32 cell bases on the stack's device."""
        return self._cells

    @property
    def num_frames(self) -> int:
        return self.stack.shape[0]

    @property
    def num_atoms(self) -> int:
        return self.stack.shape[1]

    @property
    def frame_times(self) -> np.ndarray:
        return self._times

    def load_frame(self, idx: int):
        i = int(idx)
        return (self.stack[i].cpu().numpy(),
                UnitCell.from_basis(self.cells[i].cpu().numpy()))

    def load_frames(self, indices):
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=self.stack.device)
        return self.stack[idx].cpu().numpy(), self.cells[idx].cpu().numpy()

    def device_frame(self, idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(coords (n, 3), basis (3, 3)) views on the device."""
        i = int(idx)
        return self.stack[i], self.cells[i]


def frames_on(traj: Trajectory, indices: Sequence[int], device) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames `indices` of `traj` as (F, n, 3) and (F, 3, 3) float32 tensors
    on `device`: a DeviceTrajectory on that device is indexed where it
    lies, any other trajectory is loaded on the host and copied over."""
    dev = torch.device(device)
    if isinstance(traj, DeviceTrajectory) and traj.device.type == dev.type and (
        dev.index is None or traj.device.index == dev.index
    ):
        sel = torch.as_tensor(np.asarray(indices, np.int64), device=traj.device)
        return traj.stack[sel], traj.cells[sel]
    coords, cells = traj.load_frames(indices)
    return (
        torch.as_tensor(np.asarray(coords, np.float32), device=dev),
        torch.as_tensor(np.asarray(cells, np.float32), device=dev),
    )
