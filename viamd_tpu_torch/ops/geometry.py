"""Geometric observables: distances, angles, dihedrals, set distances and
the `within` mask (PBC-aware).

Counterpart of viamd_tpu.ops.geometry (the procedures behind the VIAMD
script builtins distance/distance_min/distance_max/angle/dihedral,
md_script.h procedure table) and of the JAX compiler's per-frame `within`
mask (viamd_tpu/script/compiler.py:678-709). Atoms are gathered by static
index tensors that the compiler builds once; the all-pairs reductions are
tiled so that a tile holds at most `max_pairs` pairs, and never wait on
the device.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.ops.com import com
from viamd_tpu_torch.ops.pbc import min_image
from viamd_tpu_torch.ops.rdf import min_image_sq, sqrt_rn

MAX_PAIRS = 1 << 24  # pairs in one tile of an all-pairs reduction


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
    return vector_angle(v1, v2)


def vector_angle(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Angle between (..., 3) vectors in radians."""
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
    return bond_dihedral(b1, b2, b3)


def bond_dihedral(b1: torch.Tensor, b2: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Signed dihedral of consecutive (..., 3) bond vectors, radians."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2n = b2 / torch.sqrt((b2 * b2).sum(-1, keepdim=True).clamp_min(1e-30))
    m1 = torch.linalg.cross(n1, b2n)
    return torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1))


def _pair_d2(xa: torch.Tensor, xb: torch.Tensor, basis, inv_basis) -> torch.Tensor:
    """(na, nb) squared min-image distances, component by component."""
    d = [xa[:, None, k] - xb[None, :, k] for k in range(3)]
    return min_image_sq(d, basis, inv_basis)


def distance_min_max(
    x: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
    max_pairs: int = MAX_PAIRS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, max) min-image distance over the pairs of two atom sets.

    The sets are gathered by `idx_a` (na,) and `idx_b` (nb,); `mask_a` and
    `mask_b` (bool, at those positions) drop atoms for this frame — a
    dynamic selection passes every atom and its per-frame mask. As in the
    JAX package's dense all-pairs form, an atom in both sets pairs with
    itself (distance 0), and no pair at all gives (inf, -inf). Tiled on the
    A side; the squared distances are reduced and the two results rooted
    once, correctly rounded (`sqrt_rn`).
    """
    na, nb = int(idx_a.shape[0]), int(idx_b.shape[0])
    inf = float("inf")
    if na == 0 or nb == 0:
        return x.new_full((), inf), x.new_full((), -inf)
    xa, xb = x[idx_a], x[idx_b]
    tile = max(1, min(na, max_pairs // nb))
    lo = hi = None
    for i0 in range(0, na, tile):
        d2 = _pair_d2(xa[i0 : i0 + tile], xb, basis, inv_basis)
        if mask_a is None and mask_b is None:
            t_lo, t_hi = d2.amin(), d2.amax()
        else:
            ok = torch.ones_like(d2, dtype=torch.bool)
            if mask_a is not None:
                ok = ok & mask_a[i0 : i0 + tile, None]
            if mask_b is not None:
                ok = ok & mask_b[None, :]
            t_lo = torch.where(ok, d2, inf).amin()
            t_hi = torch.where(ok, d2, -inf).amax()
        lo = t_lo if lo is None else torch.minimum(lo, t_lo)
        hi = t_hi if hi is None else torch.maximum(hi, t_hi)
    dmax = torch.where(hi >= 0, sqrt_rn(hi.clamp_min(0.0)), hi)
    return sqrt_rn(lo), dmax


def within_mask(
    x: torch.Tensor,
    idx_t: torch.Tensor,
    cutoff: float,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    max_pairs: int = MAX_PAIRS,
) -> torch.Tensor:
    """(n,) bool: atoms whose squared min-image distance to some atom of
    `idx_t` (m,) is at most cutoff² (float32, as the JAX package compares),
    on this frame. Tiled over the query axis."""
    xt = x[idx_t]
    n, m = int(x.shape[0]), int(idx_t.shape[0])
    cut2 = float(np.float32(cutoff * cutoff))
    chunk = max(1, max_pairs // max(m, 1))
    d2 = torch.cat([
        _pair_d2(x[q0 : q0 + chunk], xt, basis, inv_basis).amin(dim=1)
        for q0 in range(0, n, chunk)
    ])
    return d2 <= cut2


def com_distance(
    x: torch.Tensor,
    w_a: torch.Tensor,
    w_b: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Min-image distance between the COMs of two weighted sets."""
    d = min_image(com(x, w_a, basis, inv_basis) - com(x, w_b, basis, inv_basis),
                  basis, inv_basis)
    return torch.sqrt((d * d).sum().clamp_min(0.0))
