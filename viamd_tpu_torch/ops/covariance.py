"""3×3 covariance / gyration analysis: closed-form eigen and shape weights.

Counterpart of viamd_tpu.ops.covariance (mdlib's mat3_covariance_matrix +
mat3_eigen, VIAMD src/main.cpp:1100-1103, and
md_util_shape_weights, src/components/shapespace/shapespace.cpp:429).

The eigensolver is the same closed-form trigonometric method as the JAX
package's (Smith's algorithm, eigenvalues descending, eigenvectors from
cross products with the same degenerate-case fallbacks), so degenerate
structures resolve to the same axes in both packages. Every function is
batched over leading dims.
"""

from __future__ import annotations

import torch

from viamd_tpu_torch.ops.com import com
from viamd_tpu_torch.ops.pbc import min_image


def covariance_matrix(
    x: torch.Tensor,
    weights: torch.Tensor,
    center: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Weighted 3×3 covariance of min-image displacements about `center`.

    x: (..., n, 3), weights: (..., n), center: (..., 3) → (..., 3, 3)."""
    w = weights.to(x.dtype)[..., None]
    d = min_image(x - center[..., None, :], basis, inv_basis)
    wsum = w.sum(dim=(-2, -1)).clamp_min(1e-30)[..., None, None]
    return ((d * w).mT @ d) / wsum


def _unit(axis: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros_like(like)
    # fill_, not `e[..., axis] = 1.0`: on CUDA that assignment copies a
    # host scalar and waits for the device
    e.select(-1, axis).fill_(1.0)
    return e


def eigh3x3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns (eigvals (..., 3) DESCENDING, eigvecs (..., 3, 3) with
    eigvecs[..., :, k] the k-th eigenvector).
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = A.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    B = A - q * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    detB = torch.linalg.det(B)
    # the guard stays in normal f32 range: subnormals flush to zero on some
    # devices, which would turn scalar matrices into 0/0
    r = (detB / (2.0 * p**3).clamp_min(1e-30)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    q0 = q[..., 0, 0]
    l0 = q0 + 2.0 * p * torch.cos(phi)
    l2 = q0 + 2.0 * p * torch.cos(phi + 2.0943951023931953)  # + 2π/3
    l1 = 3.0 * q0 - l0 - l2
    vals = torch.stack([l0, l1, l2], dim=-1)

    def eigvec(lam):
        # v ∝ the largest cross product of two rows of (A − λI)
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = torch.linalg.cross(r0, r1)
        c02 = torch.linalg.cross(r0, r2)
        c12 = torch.linalg.cross(r1, r2)
        n01 = (c01 * c01).sum(-1, keepdim=True)
        n02 = (c02 * c02).sum(-1, keepdim=True)
        n12 = (c12 * c12).sum(-1, keepdim=True)
        best = torch.where(
            n01 >= torch.maximum(n02, n12),
            c01,
            torch.where(n02 >= n12, c02, c12),
        )
        nrm = torch.sqrt((best * best).sum(-1, keepdim=True).clamp_min(1e-30))
        v = best / nrm
        # fully degenerate (spherical) fallback: unit x
        degen = (nrm < 1e-12).to(A.dtype)
        return v * (1.0 - degen) + _unit(0, v) * degen

    v0 = eigvec(l0)
    v2 = eigvec(l2)
    # orthogonalize v2 against v0; v1 completes the right-handed frame
    v2 = v2 - (v2 * v0).sum(-1, keepdim=True) * v0
    n2 = torch.sqrt((v2 * v2).sum(-1, keepdim=True).clamp_min(1e-30))
    is_bad = (n2 < 1e-12).to(A.dtype)
    # v2 collapsed onto v0 (λ0 ≈ λ2, a sphere): take any axis ⟂ v0
    alt = torch.linalg.cross(v0, _unit(2, v0))
    altn = torch.sqrt((alt * alt).sum(-1, keepdim=True).clamp_min(1e-30))
    alt2 = torch.linalg.cross(v0, _unit(1, v0))
    alt2n = torch.sqrt((alt2 * alt2).sum(-1, keepdim=True).clamp_min(1e-30))
    alt = torch.where(altn > 0.1, alt / altn, alt2 / alt2n)
    v2 = (
        v2 / torch.where(n2 < 1e-12, torch.ones_like(n2), n2) * (1.0 - is_bad)
        + alt * is_bad
    )
    v1 = torch.linalg.cross(v2, v0)
    return vals, torch.stack([v0, v1, v2], dim=-1)


def shape_weights(
    x: torch.Tensor,
    weights: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """(linear, planar, isotropic) barycentric shape weights → (..., 3).

    From the descending gyration-tensor eigenvalues λ0 ≥ λ1 ≥ λ2:
    linear = (λ0 − λ1)/λ0, planar = (λ1 − λ2)/λ0, isotropic = λ2/λ0.
    """
    c = com(x, weights, basis, inv_basis)
    C = covariance_matrix(x, weights, c, basis, inv_basis)
    vals, _ = eigh3x3(C)
    l0 = vals[..., 0].clamp_min(1e-30)
    return torch.stack(
        [
            (vals[..., 0] - vals[..., 1]) / l0,
            (vals[..., 1] - vals[..., 2]) / l0,
            vals[..., 2] / l0,
        ],
        dim=-1,
    )


def principal_axes(
    x: torch.Tensor,
    weights: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(com (..., 3), eigvals descending (..., 3), eigvecs (..., 3, 3) as
    columns) of the weighted gyration tensor."""
    c = com(x, weights, basis, inv_basis)
    C = covariance_matrix(x, weights, c, basis, inv_basis)
    vals, vecs = eigh3x3(C)
    return c, vals, vecs


def gyration_radius(
    x: torch.Tensor,
    weights: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """sqrt(trace) of the weighted gyration tensor → (...)."""
    c = com(x, weights, basis, inv_basis)
    C = covariance_matrix(x, weights, c, basis, inv_basis)
    return torch.sqrt(C.diagonal(dim1=-2, dim2=-1).sum(-1).clamp_min(0.0))
