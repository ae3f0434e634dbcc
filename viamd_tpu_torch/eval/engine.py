"""Evaluation engine: drive a CompiledScript over a device trajectory.

Counterpart of viamd_tpu.eval.engine (md_script_eval_frame_range,
VIAMD src/main.cpp:959-1035). Frames are walked in chunks, one
`frame_fn` call per frame, all on the trajectory's device with no host
round trip: temporal values are stacked per chunk, distribution and volume
accumulators are summed over frames in float32 — within a chunk first, then
into the running total, the order the JAX package sums in. Results stay on
the device until first read. The trajectory's cells are read to the host
once, when the Evaluator is built, and the Evaluator keeps the script
bound to grids sized for the smallest perpendicular widths over all
frames (`CompiledScript.fitted`, its `script`), so a frame whose box
shrank loses no pair. The CompiledScript itself is not changed.

Not ported yet: the JAX engine's batch modes (unroll/vmap/dispatch) and
VIAMD_TPU_PROP_BARRIER — PyTorch runs eagerly, frame by frame — and
checkpoints, device meshes and result merging.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.io.trajectory import DeviceTrajectory
from viamd_tpu_torch.ops.neighbors import diagonal_cells, perpendicular_widths
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import rdf_normalize
from viamd_tpu_torch.script.compiler import CompiledScript, FittedScript
from viamd_tpu_torch.script.values import PropertyMeta


@dataclasses.dataclass
class EvalResult:
    """Evaluated properties over a frame range; tensors convert to numpy
    lazily (and once) on first access."""

    frame_indices: np.ndarray  # (F,) evaluated frame indices
    times: np.ndarray  # (F,) frame times
    frame_mask: Bitfield  # completed frames over the whole trajectory
    properties: list
    n_frames_done: int = 0
    _temporal_dev: list = dataclasses.field(default_factory=list)  # per chunk
    _dist_dev: dict = dataclasses.field(default_factory=dict)
    _vol_dev: dict = dataclasses.field(default_factory=dict)
    _temporal_np: Optional[dict] = None
    _dist_np: Optional[dict] = None
    _vol_np: Optional[dict] = None

    def _leaves(self) -> list:
        leaves = list(self._dist_dev.values()) + list(self._vol_dev.values())
        for chunk in self._temporal_dev:
            leaves += list(chunk.values())
        return leaves

    def force(self) -> float:
        """Wait for all device work behind this result; returns a checksum
        (the sum of every value)."""
        leaves = self._leaves()
        if not leaves:
            return 0.0
        if leaves[0].is_cuda:
            torch.cuda.synchronize(leaves[0].device)
        return float(sum(v.to(torch.float32).sum() for v in leaves))

    @property
    def temporal(self) -> dict:
        if self._temporal_np is None:
            out = {}
            if self._temporal_dev:
                for k in self._temporal_dev[0]:
                    v = torch.cat([c[k] for c in self._temporal_dev])
                    out[k] = v.reshape(v.shape[0], -1).cpu().numpy()
            self._temporal_np = out
        return self._temporal_np

    @property
    def distributions(self) -> dict:
        if self._dist_np is None:
            self._dist_np = {k: v.cpu().numpy() for k, v in self._dist_dev.items()}
        return self._dist_np

    @property
    def volumes(self) -> dict:
        if self._vol_np is None:
            self._vol_np = {k: v.cpu().numpy() for k, v in self._vol_dev.items()}
        return self._vol_np

    def property(self, name: str) -> PropertyMeta:
        for p in self.properties:
            if p.name == name:
                return p
        raise KeyError(name)

    def normalized_distribution(self, name: str, volume: float) -> np.ndarray:
        """g(r) for an rdf property."""
        p = self.property(name)
        return rdf_normalize(
            torch.as_tensor(self.distributions[name]),
            p.spec.count_a, p.spec.count_b, volume, p.spec.r_max,
            max(self.n_frames_done, 1),
        ).numpy()

    def normalized_volume(self, name: str) -> np.ndarray:
        """Mean per-frame per-structure occupancy grid for an sdf property."""
        p = self.property(name)
        denom = max(self.n_frames_done, 1) * max(p.spec.n_structures, 1)
        return self.volumes[name] / denom


class Evaluator:
    """Chunked evaluation of a compiled script over a DeviceTrajectory."""

    def __init__(self, compiled: CompiledScript, traj: DeviceTrajectory, chunk: int = 16):
        if not isinstance(traj, DeviceTrajectory):
            raise TypeError(
                "Evaluator needs a DeviceTrajectory "
                "(interop.trajectory_from_numpy(frames, cells, device))"
            )
        if traj.device != compiled.device:
            raise ValueError(
                f"trajectory on {traj.device}, script compiled for "
                f"{compiled.device}"
            )
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.compiled = compiled
        self.traj = traj
        self.chunk = chunk
        self._inv = inv_basis_of(traj.cells)  # (F, 3, 3), once
        # the cells, read from the device once: every cell-list grid is
        # sized for the smallest perpendicular widths over all frames, so
        # no frame's cells are narrower than the grid's reach
        cells = traj.cells.cpu().numpy()
        self.script: FittedScript = compiled.fitted(
            perpendicular_widths(cells).min(axis=0), bool(diagonal_cells(cells).all())
        )

    def run(self, frame_range: Optional[Iterable[int]] = None) -> EvalResult:
        traj = self.traj
        indices = (
            np.asarray(list(frame_range), np.int64)
            if frame_range is not None
            else np.arange(traj.num_frames, dtype=np.int64)
        )
        frame_fn = self.script.frame_fn
        frame_mask = Bitfield(traj.num_frames)
        t_chunks: list = []
        acc: Optional[dict] = None
        for beg in range(0, indices.size, self.chunk):
            chunk_idx = indices[beg : beg + self.chunk]
            rows, chunk_sum = [], None
            for fi in chunk_idx:
                x, basis = traj.device_frame(fi)
                t, a = frame_fn(x, basis, self._inv[int(fi)])
                rows.append(t)
                chunk_sum = (
                    a if chunk_sum is None
                    else {k: chunk_sum[k] + a[k] for k in a}
                )
                frame_mask.set_bit(int(fi))
            t_chunks.append({k: torch.stack([r[k] for r in rows]) for k in rows[0]})
            if acc is None:
                acc = {k: torch.zeros_like(v, dtype=torch.float32)
                       for k, v in chunk_sum.items()}
            acc = {k: acc[k] + chunk_sum[k] for k in acc}
        acc = acc or {}
        return EvalResult(
            frame_indices=indices,
            times=np.asarray(traj.frame_times)[indices],
            frame_mask=frame_mask,
            properties=self.compiled.properties,
            n_frames_done=int(indices.size),
            _temporal_dev=t_chunks,
            _dist_dev={k: v for k, v in acc.items() if v.ndim == 1},
            _vol_dev={k: v for k, v in acc.items() if v.ndim > 1},
        )
