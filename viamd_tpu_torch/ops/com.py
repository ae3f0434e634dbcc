"""Center of mass, PBC-aware (circular mean), on torch tensors.

Counterpart of viamd_tpu.ops.com (mdlib's md_util_com_compute, used at
VIAMD src/components/shapespace/shapespace.cpp:425).

Each fractional coordinate maps to an angle on the unit circle; the weighted
mean of (cos, sin) maps back through atan2, so the COM does not depend on
which periodic image each atom sits on. Aperiodic cells (zero basis) take the
plain weighted mean.
"""

from __future__ import annotations

import math

import torch

from viamd_tpu_torch.ops.density import scaled_fixed_point_sum
from viamd_tpu_torch.ops.pbc import _pbc_mask, cellmul


def com(
    x: torch.Tensor,
    weights: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Weighted PBC-aware center of mass.

    x: (..., n, 3); weights: (..., n) — zero-weight atoms are excluded.
    Returns (..., 3). S packed structures, `com(x[idx], w)` with idx and w
    (S, k) and zero weights on the padding, give (S, 3) — the batched form
    of the JAX compiler's vmapped `com` (compiler.py:1298-1305).
    """
    w = weights.to(x.dtype)[..., None]
    wsum = w.sum(dim=-2).clamp_min(1e-30)
    mean = (x * w).sum(dim=-2) / wsum
    theta = cellmul(x, inv_basis) * (2.0 * math.pi)
    c = (torch.cos(theta) * w).sum(dim=-2) / wsum
    s = (torch.sin(theta) * w).sum(dim=-2) / wsum
    frac = torch.atan2(-s, -c) / (2.0 * math.pi) + 0.5  # in [0, 1)
    m = _pbc_mask(basis)
    return cellmul(frac, basis) * m + mean * (1.0 - m)


def centroid(
    x: torch.Tensor, mask: torch.Tensor, basis: torch.Tensor, inv_basis: torch.Tensor
) -> torch.Tensor:
    """Unweighted PBC-aware centroid over a 0/1 mask."""
    return com(x, mask, basis, inv_basis)


def com_segments(
    x: torch.Tensor,
    weights: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Per-segment PBC-aware COM: segment_ids (n,) in [0, num_segments)
    → (num_segments, 3). The same bits for any order of the atoms, on the
    CPU and on the card: each of the four segment sums (w, x·w, cos·w,
    sin·w) runs in fixed point (`density.scaled_fixed_point_sum`: the terms
    scaled by one power of two into (−1, 1), added exactly in int64, the
    sum rounded to float32 once), where a float `index_add_` adds in
    thread order on CUDA."""
    seg = segment_ids.to(torch.int64)
    cols = torch.arange(3, dtype=torch.int64, device=x.device)
    flat3 = (seg[:, None] * 3 + cols).reshape(-1)

    def seg_sum3(v):  # (n, 3) → (num_segments, 3)
        return scaled_fixed_point_sum(3 * num_segments, flat3, v.reshape(-1)).reshape(
            num_segments, 3)

    w = weights.to(x.dtype)
    wsum = scaled_fixed_point_sum(num_segments, seg, w).clamp_min(1e-30)[:, None]
    mean = seg_sum3(x * w[:, None]) / wsum
    theta = cellmul(x, inv_basis) * (2.0 * math.pi)
    c = seg_sum3(torch.cos(theta) * w[:, None]) / wsum
    s = seg_sum3(torch.sin(theta) * w[:, None]) / wsum
    frac = torch.atan2(-s, -c) / (2.0 * math.pi) + 0.5
    m = _pbc_mask(basis)
    return cellmul(frac, basis) * m + mean * (1.0 - m)
