"""Ramachandran component: φ/ψ backbone-angle densities per residue class.

Port of viamd_tpu/components/ramachandran.py (the reference's
src/components/ramachandran/ramachandran.cpp: per-frame φ/ψ scatter into an
accumulation texture per residue class — general / glycine / proline /
pre-proline — blurred with a separable gaussian, :333-368, plus reference
iso-density contours from embedded tables).

The angles of every frame are one batch of ops/backbone.py on the
component's device (the trajectory precompute of viamd.cpp:487-525); the
density is an integer `torch.bincount` there (exact and order-free), blurred
with ops/density.gaussian_blur_3d and normalized. The canonical (favored /
allowed) maps are the same Top8000-derived tables the JAX package ships,
copied into this package (rama_ref_densities.npz ← density_*.inl) and read
through importlib.resources on this package; `iso_levels`,
`classification` and `select_in_plot` are host code, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from viamd_tpu_torch.app.events import EventType
from viamd_tpu_torch.io.trajectory import DeviceTrajectory, frames_on
from viamd_tpu_torch.ops import backbone as bb_ops
from viamd_tpu_torch.ops.density import gaussian_blur_3d
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import div_rn

ACC_RES = 128  # accumulation resolution (reference: 512² at display 1024²)
CLASSES = ("general", "glycine", "proline", "preproline")

# canonical iso thresholds (ramachandran.cpp:1071-1076): density ≥ favored
# ⇒ favored; ≥ allowed ⇒ allowed; else outlier. General uses the 99.95%
# contour, the other classes 99.80%; favored is the 98% contour for all.
REF_ISO_ALLOWED = (0.0005, 0.002, 0.002, 0.002)
REF_ISO_FAVORED = (0.02, 0.02, 0.02, 0.02)
_REF_KEYS = ("gen", "gly", "pro", "pre")
_ref_tables = None


def reference_density(res_class: str = "general") -> np.ndarray:
    """Canonical (180, 180) Top8000-derived reference density for a residue
    class — the embedded tables of density_gen.inl et al. (consumed at
    ramachandran.cpp:1215-1262). Row = φ bin, column = ψ bin, both spanning
    [-180°, 180°)."""
    global _ref_tables
    if _ref_tables is None:
        import importlib.resources as res

        with res.files("viamd_tpu_torch.components").joinpath(
            "rama_ref_densities.npz"
        ).open("rb") as f:
            data = np.load(f)
            _ref_tables = {k: data[k] for k in _REF_KEYS}
    return _ref_tables[_REF_KEYS[CLASSES.index(res_class)]]


def sample_reference_density(
    phi, psi, res_class: str = "general", degrees: bool = False
) -> np.ndarray:
    """Bilinear sample of the canonical density at (φ, ψ) (periodic)."""
    table = reference_density(res_class)
    phi = np.asarray(phi, np.float64)
    psi = np.asarray(psi, np.float64)
    if not degrees:
        phi, psi = np.degrees(phi), np.degrees(psi)
    dim = table.shape[0]
    # table layout: row (v) = φ, column (u) = ψ
    u = (psi + 180.0) / 360.0 * dim - 0.5
    v = (phi + 180.0) / 360.0 * dim - 0.5
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu, fv = u - u0, v - v0
    out = np.zeros(np.broadcast(phi, psi).shape, np.float64)
    for dv, wv in ((0, 1.0 - fv), (1, fv)):
        for du, wu in ((0, 1.0 - fu), (1, fu)):
            out += wv * wu * table[(v0 + dv) % dim, (u0 + du) % dim]
    return out


def classify_reference(
    phi, psi, res_class: str = "general", degrees: bool = False
) -> np.ndarray:
    """0 = outlier, 1 = allowed, 2 = favored vs the canonical contours."""
    k = CLASSES.index(res_class)
    d = sample_reference_density(phi, psi, res_class, degrees=degrees)
    return (
        (d >= REF_ISO_ALLOWED[k]).astype(np.int8)
        + (d >= REF_ISO_FAVORED[k]).astype(np.int8)
    )


class RamachandranComponent:
    """Reads `session.system`, `.trajectory`, `.events` and, when present,
    `.tasks`; computes on `device`."""

    name = "ramachandran"

    def __init__(self, session, *, device="cuda"):
        self.session = session
        self.device = torch.device(device)
        self._angles: Optional[tuple] = None  # (phi (F, nbb), psi (F, nbb)) tensors
        self._class_of: Optional[np.ndarray] = None  # (nbb,) class index
        session.events.subscribe(EventType.TRAJECTORY_INIT, self._invalidate)
        session.events.subscribe(EventType.SYSTEM_INIT, self._invalidate)

    def _invalidate(self, _ev=None):
        self._angles = None
        self._class_of = None

    # -- residue classes -----------------------------------------------------
    def _classify(self):
        sys = self.session.system
        bb = sys.backbone
        cls = np.zeros(bb.count, np.int32)
        names = [sys.res_names[sys.res_name_id[r]].upper() for r in bb.res_idx]
        for k, nm in enumerate(names):
            if nm == "GLY":
                cls[k] = 1
            elif nm == "PRO":
                cls[k] = 2
            elif k + 1 < len(names) and names[k + 1] == "PRO":
                cls[k] = 3
        self._class_of = cls

    # -- angles over the whole trajectory ------------------------------------
    def _frames(self, frame_range):
        """(coords (F, n, 3), cells (F, 3, 3)) tensors on the device: a
        DeviceTrajectory's frames where they lie, host frames loaded (on
        the task pool past 64 frames) and copied over."""
        session = self.session
        traj = session.trajectory
        if traj is None:
            sys = session.system
            coords = torch.as_tensor(sys.coords()[None], device=self.device)
            cells = torch.as_tensor(np.asarray(sys.cell.basis, np.float32)[None], device=self.device)
            return coords, cells
        idx = (
            list(frame_range)
            if frame_range is not None
            else list(range(traj.num_frames))
        )
        tasks = getattr(session, "tasks", None)
        if isinstance(traj, DeviceTrajectory) or tasks is None or len(idx) <= 64:
            return frames_on(traj, idx, self.device)
        # pool-parallel frame I/O: the trajectory-precompute range task of
        # viamd.cpp:487-525 partitioned across workers (task_system.cpp:75)
        h = tasks.enqueue_range(
            "Rama: load frames",
            lambda b, e, t: traj.load_frames(idx[b:e]),
            total=len(idx), grain=max(64, len(idx) // 8),
        )
        parts = h.wait()
        coords = np.concatenate([p[0] for p in parts], axis=0)
        cells = np.concatenate([p[1] for p in parts], axis=0)
        return (
            torch.as_tensor(np.asarray(coords, np.float32), device=self.device),
            torch.as_tensor(np.asarray(cells, np.float32), device=self.device),
        )

    def compute_angles(self, frame_range=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(φ, ψ) in radians, (F, nbb) tensors on the device — the backbone
        precompute. Every frame takes frame 0's cell, as in the JAX
        package."""
        sys = self.session.system
        if sys is None or sys.backbone is None:
            raise ValueError("no protein backbone in the loaded system")
        dev = self.device
        bb = sys.backbone
        vp, vn = bb_ops.make_backbone_validity(bb.ranges, bb.count)
        coords, cells = self._frames(frame_range)
        basis = cells[0]
        self._angles = bb_ops.backbone_angles_frames(
            coords,
            *(torch.as_tensor(a, device=dev) for a in (bb.atom_n, bb.atom_ca, bb.atom_c)),
            torch.as_tensor(vp, device=dev), torch.as_tensor(vn, device=dev),
            basis, inv_basis_of(basis),
        )
        if self._class_of is None:
            self._classify()
        return self._angles

    def angles(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._angles is None:
            self.compute_angles()
        return self._angles

    def _host_angles(self) -> tuple[np.ndarray, np.ndarray]:
        phi, psi = self.angles()
        return phi.cpu().numpy(), psi.cpu().numpy()

    # -- density maps --------------------------------------------------------
    def density(
        self, res_class: str = "general", blur_sigma: float = 1.5
    ) -> torch.Tensor:
        """(ACC_RES, ACC_RES) φ/ψ density for a residue class, a tensor on
        the device — the rama_rep_compute_density scatter + gaussian blur
        (:1277, :368). Row = ψ bin, column = φ bin."""
        phi, psi = self.angles()
        dev = self.device
        cls = CLASSES.index(res_class)
        sel = torch.as_tensor(self._class_of == cls, device=dev)
        p = phi[:, sel].reshape(-1)
        s = psi[:, sel].reshape(-1)
        # valid angles only (unset ends are exactly 0, 0): the masked-out
        # entries go to an extra bin past the grid and are dropped
        ok = (p != 0.0) | (s != 0.0)

        def bins(a):
            f = div_rn(a + math.pi, 2 * math.pi) * ACC_RES
            return f.long().clamp(0, ACC_RES - 1)

        n = ACC_RES * ACC_RES
        flat = torch.where(ok, bins(s) * ACC_RES + bins(p), torch.full_like(p, n, dtype=torch.long))
        grid = torch.bincount(flat, minlength=n + 1)[:n].reshape(ACC_RES, ACC_RES)
        grid = grid.to(torch.float32)
        if blur_sigma > 0:
            grid = gaussian_blur_3d(grid, blur_sigma)
        tot = grid.sum()
        return torch.where(tot > 0, grid / torch.where(tot > 0, tot, 1.0), grid)

    def iso_levels(self, density, fractions=(0.85, 0.5, 0.15)) -> list[float]:
        """Density levels enclosing the given probability mass (the
        iso-contour lines of the reference plots); `density` may be a
        tensor or an array."""
        density = np.asarray(torch.as_tensor(density).cpu())
        flat = np.sort(density.reshape(-1))[::-1]
        csum = np.cumsum(flat)
        total = csum[-1] if csum.size else 0.0
        out = []
        for f in fractions:
            k = np.searchsorted(csum, f * total)
            out.append(float(flat[min(k, flat.size - 1)]))
        return out

    def classification(self, frame: int = 0) -> np.ndarray:
        """Per-backbone-residue canonical classification at `frame`:
        0 = outlier, 1 = allowed, 2 = favored, -1 = undefined angles.
        Uses each residue's own class table (general/gly/pro/pre-pro) —
        the coloring the reference derives from its embedded densities."""
        phi, psi = self._host_angles()
        if self._class_of is None:
            self._classify()
        phi, psi = phi[frame], psi[frame]
        out = np.full(phi.shape, -1, np.int8)
        defined = (phi != 0.0) | (psi != 0.0)
        for k, name in enumerate(CLASSES):
            sel = (self._class_of == k) & defined
            if sel.any():
                out[sel] = classify_reference(phi[sel], psi[sel], name)
        return out

    def select_in_plot(
        self, phi_range, psi_range, frame: int | None = None,
        degrees: bool = True,
    ):
        """The plot's interactive selection (reference: click/drag in the
        Ramachandran window selects the residues whose (φ, ψ) fall in the
        box, ramachandran.cpp). Returns (residue_indices, atom_bitfield)
        for backbone residues inside [phi_lo, phi_hi] × [psi_lo, psi_hi]
        at `frame` (None → all frames, a residue matches if ANY frame
        does). Ranges in degrees by default; wrap-around ranges (lo > hi)
        are honored."""
        from viamd_tpu_torch.core.bitfield import Bitfield

        phi, psi = self._host_angles()
        if frame is not None:
            phi, psi = phi[frame : frame + 1], psi[frame : frame + 1]
        if degrees:
            phi = np.degrees(phi)
            psi = np.degrees(psi)

        def in_range(a, lo, hi):
            return (a >= lo) & (a <= hi) if lo <= hi else (a >= lo) | (a <= hi)

        ok = (
            in_range(phi, *phi_range)
            & in_range(psi, *psi_range)
            & np.isfinite(phi)
            & np.isfinite(psi)
        ).any(axis=0)
        sys = self.session.system
        bb = sys.backbone
        res = np.asarray(bb.res_idx)[ok]
        sel = np.isin(np.asarray(sys.atom_res_idx), res)
        return res, Bitfield.from_bools(sel)
