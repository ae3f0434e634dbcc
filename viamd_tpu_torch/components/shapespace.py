"""Shapespace component: per-structure shape descriptors over the trajectory.

Port of viamd_tpu/components/shapespace.py (the reference's
src/components/shapespace/shapespace.cpp: filter → per-structure bitfields
(md_filter_evaluate :365), per frame per structure: PBC-aware COM →
deperiodize → 3×3 covariance → eigenvalues → (linear, planar, isotropic)
weights (:388-440) → barycentric scatter plot + XVG/CSV export).

The structures pack into padded (S, K) index / weight tables once (static
selections, script/filterlang.py); ops/covariance.shape_weights of every
structure runs over a batch of FRAME_BATCH frames at once on the
component's device (`torch.func.vmap` over the frames, as the JAX package
vmaps over the structures). `progress` and `interrupt` are polled once a batch (the JAX
package polls them once a frame).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from viamd_tpu_torch.app.events import EventType
from viamd_tpu_torch.io.trajectory import frames_on
from viamd_tpu_torch.ops import covariance as cov_ops
from viamd_tpu_torch.ops.pbc import inv_basis_of

FRAME_BATCH = 64  # frames a shape_weights call


class ShapespaceComponent:
    """Reads `session.system`, `.trajectory`, `.events` and
    `.stored_selections`; computes on `device`."""

    name = "shapespace"

    def __init__(self, session, *, device="cuda"):
        self.session = session
        self.device = torch.device(device)
        self.filter = "all"
        self._result: Optional[np.ndarray] = None  # (F, S, 3)
        session.events.subscribe(EventType.SYSTEM_INIT, self._invalidate)
        session.events.subscribe(EventType.TRAJECTORY_INIT, self._invalidate)

    def _invalidate(self, _ev=None):
        self._result = None

    def evaluate(
        self, filter_expr: Optional[str] = None, frame_range=None,
        progress=None, interrupt=None,
    ) -> np.ndarray:
        """(F, S, 3) (lin, plan, iso) weights per frame per structure."""
        from viamd_tpu_torch.script.filterlang import evaluate_filter_structures

        session = self.session
        dev = self.device
        if filter_expr is not None:
            self.filter = filter_expr
        sel = evaluate_filter_structures(
            self.filter, session.system, session.stored_selections, device=dev
        )
        if sel.n_structures == 0:
            raise ValueError(f"filter '{self.filter}' matches nothing")
        idx, w = sel.packed(session.system.mass)
        idx_t = torch.as_tensor(idx, dtype=torch.long, device=dev)
        w_t = torch.as_tensor(w, device=dev)

        def frame_weights(x, basis):  # (n, 3), (3, 3) → (S, 3)
            return cov_ops.shape_weights(x[idx_t], w_t, basis, inv_basis_of(basis))

        traj = session.trajectory
        if traj is None:
            frames = [0]
        else:
            frames = (
                list(frame_range)
                if frame_range is not None
                else list(range(traj.num_frames))
            )
        rows = []
        for b in range(0, len(frames), FRAME_BATCH):
            if interrupt is not None and interrupt():
                break
            batch = frames[b : b + FRAME_BATCH]
            if traj is None:
                sys = session.system
                x = torch.as_tensor(sys.coords()[None], device=dev)
                cells = torch.as_tensor(np.asarray(sys.cell.basis, np.float32)[None], device=dev)
            else:
                x, cells = frames_on(traj, batch, dev)
            rows.append(torch.func.vmap(frame_weights)(x, cells))
            if progress:
                progress(min(b + FRAME_BATCH, len(frames)) / len(frames))
        self._result = (
            torch.cat(rows).cpu().numpy() if rows
            else np.zeros((0, len(idx), 3), np.float32)
        )
        return self._result

    @property
    def result(self) -> Optional[np.ndarray]:
        return self._result

    def scatter_points(self) -> np.ndarray:
        """(F·S, 2) barycentric plot coordinates in the shape triangle
        (linear at (0,0), planar at (1,0), isotropic at (0.5, √3/2))."""
        if self._result is None:
            self.evaluate()
        w = self._result.reshape(-1, 3)
        corners = np.array(
            [[0.0, 0.0], [1.0, 0.0], [0.5, 0.8660254]], np.float32
        )
        return w @ corners

    def export_csv(self, path_or_buf):
        """Per-frame per-structure weights → CSV (the shapespace export)."""
        from viamd_tpu_torch.io.csv import write_csv

        if self._result is None:
            self.evaluate()
        F, S, _ = self._result.shape
        cols = [np.repeat(np.arange(F), S)]
        header = ["frame"]
        flat = self._result.reshape(F * S, 3)
        for name, c in zip(("lin", "plan", "iso"), flat.T):
            cols.append(c)
            header.append(name)
        write_csv(path_or_buf, np.stack(cols), header)

    def export_xvg(self, path_or_buf):
        """Per-frame per-structure weights → XVG (the reference exports
        both XVG and CSV from the shapespace window, shapespace.cpp)."""
        from viamd_tpu_torch.io.xvg import write_xvg

        if self._result is None:
            self.evaluate()
        F, S, _ = self._result.shape
        flat = self._result.reshape(F * S, 3)
        cols = np.concatenate(
            [np.repeat(np.arange(F), S)[None].astype(np.float64), flat.T]
        )
        write_xvg(
            path_or_buf, cols,
            title="shape space weights",
            xaxis="frame", yaxis="weight",
            legends=["lin", "plan", "iso"],
        )
