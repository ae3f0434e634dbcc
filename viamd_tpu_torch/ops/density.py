"""Density-volume accumulation: trilinear point splatting into 3D grids.

Counterpart of viamd_tpu.ops.density (volume-property accumulation,
VIAMD src/components/density_volume/density_volume.cpp:272-285).

Each point adds its weight to the 8 voxels around it with trilinear weights,
through one scatter-add. The JAX package computes the same sums as a
tent-function matmul because a TPU has no fast scatter-add. The scatter sums
in fixed point (each contribution rounded to a multiple of 2^-bits, the sums
in int64) on every device: a float `index_add_` on CUDA adds with atomics in
whatever order the threads run, so two runs over the same frames would
differ in the last bits, while int64 adds are exact in any order. The grid
lies within one float32 rounding of the exact sum of the (rounded)
contributions, and the CPU runs the same arithmetic as the card.
"""

from __future__ import annotations

import torch

from viamd_tpu_torch.ops.neighbors import device_ints

# the 8 trilinear corners as (ox, oy, oz) ∈ {0, 1}³
_CORNERS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))


def splat_trilinear(
    pts: torch.Tensor,  # (n, 3) positions in grid space
    weights: torch.Tensor,  # (n,)
    dims: tuple[int, int, int],
    origin: torch.Tensor,  # (3,) world position of voxel (0,0,0) corner
    voxel: torch.Tensor,  # (3,) voxel extent per axis
) -> torch.Tensor:
    """Trilinear splat → (dx, dy, dz) float32 grid.

    Voxel centers sit at origin + (i + ½)·voxel. Corners outside the grid,
    and points with non-finite coordinates, contribute nothing. The
    fixed-point sum needs |weights| < 2 (the SDF's target weights are 0 or
    1).
    """
    dx, dy, dz = dims
    g = (pts - origin) / voxel - 0.5  # voxel-center coordinates
    w = weights.to(torch.float32)
    finite = torch.isfinite(g).all(dim=-1)
    g = torch.where(finite[:, None], g, torch.full_like(g, -2.0))
    w = torch.where(finite, w, torch.zeros_like(w))
    g0 = torch.floor(g)
    f = g - g0
    i0 = g0.to(torch.int64)
    offs = device_ints(_CORNERS, pts.device)  # (8, 3)
    idx3 = i0[None, :, :] + offs[:, None, :]  # (8, n, 3)
    dims_t = device_ints(tuple(dims), pts.device)
    inb = ((idx3 >= 0) & (idx3 < dims_t)).all(dim=-1)  # (8, n)
    tent = torch.where(offs[:, None, :] == 1, f[None], 1.0 - f[None])  # (8,n,3)
    wts = tent[..., 0] * tent[..., 1] * tent[..., 2] * w[None, :]
    flat = (idx3[..., 0] * dy + idx3[..., 1]) * dz + idx3[..., 2]
    flat = torch.where(inb, flat, torch.zeros_like(flat))
    wts = torch.where(inb, wts, torch.zeros_like(wts))
    grid = fixed_point_sum(dx * dy * dz, flat.reshape(-1), wts.reshape(-1))
    return grid.reshape(dx, dy, dz)


# finest fixed-point step of the splat sum: 2^-40
_FIXED_BITS = 40


def fixed_point_sum(n: int, flat: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(n,) float32 sums of `wts` (|wts| < 2) by index `flat`, the same for
    any order of the terms: each term rounded to a multiple of 2^-bits,
    summed exactly in int64, the sum rounded to float32 once. No sum can
    pass twice the term count, so with 2^bits · count < 2^62 none
    overflows."""
    bits = min(_FIXED_BITS, 62 - max(flat.numel(), 1).bit_length())
    q = torch.mul(wts, 2.0**bits).round_().to(torch.int64)
    acc = torch.zeros(n, dtype=torch.int64, device=flat.device).index_add_(0, flat, q)
    return acc.to(torch.float64).mul_(2.0**-bits).to(torch.float32)

