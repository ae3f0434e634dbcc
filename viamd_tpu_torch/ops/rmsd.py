"""Kabsch alignment on torch tensors.

Counterpart of viamd_tpu.ops.rmsd (the internal-reference-frame alignment
that SDF accumulation depends on: vis.sdf.matrices world→reference
transforms, VIAMD src/components/density_volume/
density_volume.cpp:180-204).

The rotation comes from the closed-form eigendecomposition of HᵀH with the
JAX package's rank-2-safe completion — not from an SVD — because that
completion decides which way degenerate (planar, collinear) structures
rotate, and the two packages must agree on it. Batched over leading dims.
"""

from __future__ import annotations

import torch

from viamd_tpu_torch.ops.com import com
from viamd_tpu_torch.ops.covariance import _unit, eigh3x3
from viamd_tpu_torch.ops.pbc import min_image


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def kabsch_rotation(
    p: torch.Tensor, q: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Proper rotation R (..., 3, 3) minimizing Σ w‖R p − q‖² (p, q
    centered; p, q: (..., k, 3), w: (..., k))."""
    H = (p * w.to(p.dtype)[..., None]).mT @ q
    lam, V = eigh3x3(H.mT @ H)  # descending; V columns = v_k
    s = torch.sqrt(lam.clamp_min(0.0))
    eps = 1e-12
    v0, v1 = V[..., :, 0], V[..., :, 1]
    ex, ey = _unit(0, v0), _unit(1, v0)

    def unit_or(u, alt):
        # normalize, falling back to `alt` when u degenerates: a rank-
        # deficient H (collinear / 2-atom structures) must still give a
        # proper rotation
        n = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        return torch.where(n > 1e-6, u / n.clamp_min(eps), alt)

    u0 = unit_or(_matvec(H, v0) / s[..., 0:1].clamp_min(eps), ex)
    # any vector ⟂ u0 serves as the degenerate-direction fallback
    a = torch.where(u0[..., 0:1].abs() < 0.9, ex, ey)
    alt1 = torch.linalg.cross(u0, a)
    alt1 = alt1 / torch.linalg.vector_norm(
        alt1, dim=-1, keepdim=True
    ).clamp_min(eps)
    u1r = _matvec(H, v1) / s[..., 1:2].clamp_min(eps)
    u1r = u1r - (u1r * u0).sum(-1, keepdim=True) * u0
    u1 = unit_or(u1r, alt1)
    u2 = torch.linalg.cross(u0, u1)
    v2 = torch.linalg.cross(v0, v1)
    # R = Σ_k v_k u_kᵀ: maximizes tr(R H), det(R) = +1 by construction
    return (
        v0[..., :, None] * u0[..., None, :]
        + v1[..., :, None] * u1[..., None, :]
        + v2[..., :, None] * u2[..., None, :]
    )


def align_frame(
    x: torch.Tensor,
    w: torch.Tensor,
    ref_centered: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, center): world→reference transform of a weighted structure.

    x: (..., k, 3) current coords; ref_centered: (..., k, 3) reference coords
    centered on their COM. The structure is made whole about its PBC-aware
    COM first. Apply as x_ref = R @ (deperiodize(x) − center).
    """
    c = com(x, w, basis, inv_basis)
    p = min_image(x - c[..., None, :], basis, inv_basis)
    return kabsch_rotation(p, ref_centered, w), c


def rmsd(
    p: torch.Tensor, q: torch.Tensor, w: torch.Tensor, align: bool = True
) -> torch.Tensor:
    """Weighted RMSD between point sets p, q (..., k, 3) with weights
    (..., k), after optimal (Kabsch) superposition when `align`. Batched:
    S structures padded to k atoms with zero weights give (S,)."""
    w = w.to(p.dtype)
    wsum = w.sum(-1).clamp_min(1e-30)[..., None]
    pc = p - ((p * w[..., None]).sum(-2) / wsum)[..., None, :]
    qc = q - ((q * w[..., None]).sum(-2) / wsum)[..., None, :]
    if align:
        R = kabsch_rotation(pc, qc, w)
        pc = pc @ R.mT
    d = pc - qc
    return torch.sqrt(((d * d).sum(-1) * w).sum(-1) / wsum[..., 0])
