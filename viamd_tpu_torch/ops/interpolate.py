"""PBC-aware coordinate interpolation between trajectory frames, on torch
tensors.

Counterpart of viamd_tpu.ops.interpolate (md_util_interpolate_linear /
md_util_interpolate_cubic_spline: the playback hot loop interpolates atom
positions between 2 or 4 cached frames with PBC unwrapping, VIAMD
src/viamd.cpp:1846-1895; modes nearest / linear / cubic at src/viamd.h).

Each neighbour frame is first unwrapped onto the image nearest the anchor
frame (min-image deltas), then blended; cubic is a Catmull-Rom spline with
optional tension. The unit-cell basis interpolates linearly alongside. The
arithmetic is the JAX package's, term for term.
"""

from __future__ import annotations

import torch

from viamd_tpu_torch.ops.pbc import min_image


def interpolate_linear(
    x0: torch.Tensor,
    x1: torch.Tensor,
    t: float,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """x(t) between consecutive frames, PBC-unwrapped toward x0."""
    d = min_image(x1 - x0, basis, inv_basis)
    return x0 + d * t


def interpolate_cubic(
    xm1: torch.Tensor,
    x0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    t: float,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    tension: float = 0.5,
) -> torch.Tensor:
    """Catmull-Rom (4-frame) spline at parameter t ∈ [0, 1] between x0 and
    x1. Neighbours unwrap onto x0's periodic image chain, so atoms crossing
    the boundary interpolate smoothly instead of teleporting."""
    p1 = x0
    p0 = x0 + min_image(xm1 - x0, basis, inv_basis)
    p2 = x0 + min_image(x1 - x0, basis, inv_basis)
    p3 = p2 + min_image(x2 - x1, basis, inv_basis)
    m1 = (p2 - p0) * tension
    m2 = (p3 - p1) * tension
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00 * p1 + h10 * m1 + h01 * p2 + h11 * m2


def interpolate_cell(b0: torch.Tensor, b1: torch.Tensor, t) -> torch.Tensor:
    return b0 + (b1 - b0) * t
