"""Geometric observables: distances, angles, dihedrals (PBC-aware).

Counterpart of viamd_tpu.ops.geometry (the procedures behind the VIAMD
script builtins distance/angle/dihedral, md_script.h procedure table).
Atoms are gathered by static index tensors that the compiler builds once;
each function returns one value per index tuple.
"""

from __future__ import annotations

import torch

from viamd_tpu_torch.ops.pbc import min_image


def distance(
    x: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Min-image distances between paired index lists: (k,)."""
    d = min_image(x[idx_a] - x[idx_b], basis, inv_basis)
    return torch.sqrt((d * d).sum(-1).clamp_min(0.0))


def angle(
    x: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    idx_c: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Angle a-b-c in radians (vertex b): (k,)."""
    v1 = min_image(x[idx_a] - x[idx_b], basis, inv_basis)
    v2 = min_image(x[idx_c] - x[idx_b], basis, inv_basis)
    num = (v1 * v2).sum(-1)
    den = torch.sqrt(((v1 * v1).sum(-1) * (v2 * v2).sum(-1)).clamp_min(1e-30))
    return torch.arccos(torch.clamp(num / den, -1.0, 1.0))


def dihedral(
    x: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    idx_c: torch.Tensor,
    idx_d: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Signed dihedral a-b-c-d in radians (-π, π]: (k,), in the atan2 form
    (the backbone φ/ψ convention)."""
    b1 = min_image(x[idx_b] - x[idx_a], basis, inv_basis)
    b2 = min_image(x[idx_c] - x[idx_b], basis, inv_basis)
    b3 = min_image(x[idx_d] - x[idx_c], basis, inv_basis)
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2n = b2 / torch.sqrt((b2 * b2).sum(-1, keepdim=True).clamp_min(1e-30))
    m1 = torch.linalg.cross(n1, b2n)
    return torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1))
