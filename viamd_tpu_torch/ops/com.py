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
    → (num_segments, 3). Segment sums by `index_add_`."""

    def seg_sum(v):
        out = torch.zeros((num_segments, *v.shape[1:]), dtype=v.dtype, device=v.device)
        return out.index_add_(0, segment_ids, v)

    w = weights.to(x.dtype)
    wsum = seg_sum(w).clamp_min(1e-30)[:, None]
    mean = seg_sum(x * w[:, None]) / wsum
    theta = cellmul(x, inv_basis) * (2.0 * math.pi)
    c = seg_sum(torch.cos(theta) * w[:, None]) / wsum
    s = seg_sum(torch.sin(theta) * w[:, None]) / wsum
    frac = torch.atan2(-s, -c) / (2.0 * math.pi) + 0.5
    m = _pbc_mask(basis)
    return cellmul(frac, basis) * m + mean * (1.0 - m)
