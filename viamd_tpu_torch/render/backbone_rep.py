"""Backbone tube / cartoon-lite representation geometry.

Port of viamd_tpu/render/backbone_rep.py: `backbone_tube` is a numpy copy
(host code); `current_ss_weights` runs ops/backbone.py on a torch device.

Capability rebuild of md_gl's RIBBONS / CARTOON draw types (reference:
draw-op types at VIAMD src/viamd.h:161-169, spline-extruded
backbone meshes in mdlib's GL shaders). The formulation: a Catmull-Rom
spline through the CA trace, sampled into a dense chain of sphere impostors
(capsule-chain tube) that renders through the same tiled ray-tracer —
no mesh extrusion. Cartoon mode widens the radius where the secondary
structure is helix/sheet (the visual read of ribbons) using the
per-residue (coil, helix, sheet) weights.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.core.system import System
from viamd_tpu_torch.ops import backbone as bb_ops
from viamd_tpu_torch.ops.pbc import inv_basis_of


def _catmull_rom(p0, p1, p2, p3, t):
    t = t[:, None]
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t
    )


def backbone_tube(
    sys: System,
    coords: np.ndarray,
    subdiv: int = 8,
    radius: float = 0.35,
    ss_weights: np.ndarray | None = None,
    cartoon: bool = False,
):
    """Spline-sample the CA trace → (positions (M,3), radii (M,), atom_src
    (M,) int32 nearest-CA atom indices for coloring/picking).

    ss_weights: optional (nbb, 3) (coil, helix, sheet) for cartoon widening.
    """
    bb = sys.backbone
    if bb is None:
        raise ValueError("system has no protein backbone")
    pos_out = []
    rad_out = []
    src_out = []
    ca = bb.atom_ca
    for beg, end in np.asarray(bb.ranges):
        idx = ca[beg:end]
        P = coords[idx]  # (k,3)
        k = P.shape[0]
        if k < 2:
            continue
        # pad endpoints for catmull-rom
        Ppad = np.concatenate([P[:1] * 2 - P[1:2], P, P[-1:] * 2 - P[-2:-1]])
        t = np.linspace(0.0, 1.0, subdiv, endpoint=False)
        for s in range(k - 1):
            pts = _catmull_rom(
                Ppad[s], Ppad[s + 1], Ppad[s + 2], Ppad[s + 3], t
            )
            pos_out.append(pts)
            src = idx[s] if True else 0
            src_out.append(np.full(subdiv, src, np.int32))
            if cartoon and ss_weights is not None:
                w = ss_weights[beg + s]
                widen = 1.0 + 2.0 * float(w[1]) + 2.5 * float(w[2])
            else:
                widen = 1.0
            rad_out.append(np.full(subdiv, radius * widen, np.float32))
        pos_out.append(P[-1:])
        rad_out.append(np.full(1, rad_out[-1][-1], np.float32))
        src_out.append(np.asarray([idx[-1]], np.int32))
    if not pos_out:
        raise ValueError("backbone ranges too short for a tube")
    return (
        np.concatenate(pos_out).astype(np.float32),
        np.concatenate(rad_out),
        np.concatenate(src_out),
    )


def current_ss_weights(sys: System, coords, *, device) -> torch.Tensor:
    """(nbb, 3) secondary-structure weights for one frame, a tensor on
    `device` (coords: numpy or a tensor, (n, 3))."""
    dev = torch.device(device)
    bb = sys.backbone
    vp, vn = bb_ops.make_backbone_validity(bb.ranges, bb.count)
    basis = torch.as_tensor(np.asarray(sys.cell.basis, np.float32), device=dev)
    x = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    idx = [torch.as_tensor(a, device=dev) for a in (bb.atom_n, bb.atom_ca, bb.atom_c)]
    vp_t, vn_t = (torch.as_tensor(v, device=dev) for v in (vp, vn))
    phi, psi = bb_ops.backbone_angles(x, *idx, vp_t, vn_t, basis, inv_basis_of(basis))
    return bb_ops.secondary_structure(phi, psi, vp_t & vn_t)
