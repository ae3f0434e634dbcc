"""Protein backbone analysis: φ/ψ dihedrals + secondary-structure inference.

Torch port of viamd_tpu/ops/backbone.py (md_util_backbone_angles_compute +
md_util_backbone_secondary_structure_infer; the reference's trajectory
precompute task, VIAMD src/viamd.cpp:487-525, and its Ramachandran
component's consumer, ramachandran.cpp:1277).

Inputs are the static backbone index arrays of core.system.Backbone as
tensors on the coordinates' device. Secondary structure is per-residue
(coil, helix, sheet) weights in [0, 1] from φ/ψ ellipse membership, plus the
box-filter temporal denoiser of secondary_structure_render_denoise
(src/viamd.cpp:346-414). The JAX `vmap` over frames is a leading frame
dimension here (`backbone_angles_frames`).
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.ops.geometry import bond_dihedral
from viamd_tpu_torch.ops.pbc import min_image
from viamd_tpu_torch.ops.rdf import div_rn


def backbone_angles(
    x: torch.Tensor,  # (n, 3) or (F, n, 3)
    atom_n: torch.Tensor,  # (nbb,) int
    atom_ca: torch.Tensor,
    atom_c: torch.Tensor,
    valid_prev: torch.Tensor,  # (nbb,) bool: has i-1 in the same chain range
    valid_next: torch.Tensor,  # (nbb,) bool
    basis: torch.Tensor,  # (3, 3), or (F, 3, 3) with a frame batch
    inv_basis: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(φ, ψ) in radians per backbone residue, (nbb,) or (F, nbb); invalid
    ends → 0. geometry.dihedral's arithmetic on the gathered atoms:

    φ_i = dihedral(C_{i-1}, N_i, CA_i, C_i)
    ψ_i = dihedral(N_i, CA_i, C_i, N_{i+1})
    """
    n_at, ca_at, c_at = (a.long() for a in (atom_n, atom_ca, atom_c))
    xn, xca, xc = (x[..., a, :] for a in (n_at, ca_at, c_at))
    xc_prev = torch.roll(xc, 1, dims=-2)
    xn_next = torch.roll(xn, -1, dims=-2)

    def bond(p, q):
        return min_image(q - p, basis, inv_basis)

    b_n_ca = bond(xn, xca)
    b_ca_c = bond(xca, xc)
    phi = bond_dihedral(bond(xc_prev, xn), b_n_ca, b_ca_c)
    psi = bond_dihedral(b_n_ca, b_ca_c, bond(xc, xn_next))
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    return torch.where(valid_prev, phi, zero), torch.where(valid_next, psi, zero)


def make_backbone_validity(ranges, nbb: int):
    """Host-side: (valid_prev, valid_next) bool arrays from Backbone.ranges."""
    vp = np.zeros(nbb, bool)
    vn = np.zeros(nbb, bool)
    for beg, end in np.asarray(ranges):
        vp[beg + 1 : end] = True
        vn[beg : end - 1] = True
    return vp, vn


# (φ0, ψ0, rφ, rψ) ellipse zones in degrees.
_HELIX_ZONE = (-80.0, -40.0, 50.0, 50.0)  # α-helix basin
_SHEET_ZONE = (-110.0, 130.0, 70.0, 60.0)  # β-sheet basin (ψ wraps ±180)


def _zone_weight(phi_deg, psi_deg, zone):
    p0, s0, rp, rs = zone
    dphi = phi_deg - p0
    # floor-mod, as jnp's % (torch's % on tensors is floor-mod too)
    dpsi = (psi_deg - s0 + 180.0) % 360.0 - 180.0  # wrap to (-180, 180]
    qp, qs = div_rn(dphi, rp), div_rn(dpsi, rs)
    r2 = qp * qp + qs * qs
    return torch.clamp(1.0 - r2, 0.0, 1.0)


def secondary_structure(
    phi: torch.Tensor, psi: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """(..., nbb, 3) soft (coil, helix, sheet) weights from φ/ψ (radians)."""
    rad2deg = 57.29577951308232
    phi_d = phi * rad2deg
    psi_d = psi * rad2deg
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    h = torch.where(valid, _zone_weight(phi_d, psi_d, _HELIX_ZONE), zero)
    s = torch.where(valid, _zone_weight(phi_d, psi_d, _SHEET_ZONE), zero)
    c = torch.clamp(1.0 - h - s, 0.0, 1.0)
    tot = (c + h + s).clamp_min(1e-30)
    return torch.stack([c / tot, h / tot, s / tot], dim=-1)


def ss_denoise_temporal(ss_frames: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Majority-vote (box-filter) temporal smoothing over the frame axis.

    ss_frames: (F, nbb, 3). Mirrors secondary_structure_render_denoise
    (src/viamd.cpp:346-414): flickering single-frame classifications are
    suppressed by averaging class weights over a centered window (edge
    frames repeated), through a cumulative sum as in the JAX package.
    """
    F = ss_frames.shape[0]
    r = window // 2
    pad = torch.cat(
        [ss_frames[:1].expand(r, -1, -1), ss_frames, ss_frames[-1:].expand(r, -1, -1)]
    )
    csum = torch.cumsum(torch.cat([torch.zeros_like(pad[:1]), pad]), dim=0)
    out = div_rn(csum[window:] - csum[:-window], float(window))
    return out[:F]


def backbone_angles_frames(
    coords: torch.Tensor,  # (F, n, 3)
    atom_n, atom_ca, atom_c,
    valid_prev, valid_next,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
):
    """(φ, ψ) over a frame batch → ((F, nbb), (F, nbb)); a (3, 3) basis
    serves every frame."""
    if basis.ndim == 2:
        basis = basis.expand(coords.shape[0], 3, 3)
        inv_basis = inv_basis.expand(coords.shape[0], 3, 3)
    return backbone_angles(
        coords, atom_n, atom_ca, atom_c, valid_prev, valid_next, basis, inv_basis
    )
