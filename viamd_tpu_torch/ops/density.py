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

Also here, for the volume view: `splat_nearest`, `gaussian_blur_3d` (a
zero-padded separable windowed sum, the JAX form, no convolution library)
and `splat_color_volume` (four trilinear splats, the blur, the Shepard
division). Weights of any size go through `scaled_fixed_point_sum`, which
scales them by a power of two below 1 first.
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



def pow2_exponent(w: torch.Tensor) -> torch.Tensor:
    """Int32 scalar e with max |w| < 2^e (0 for all-zero or empty w), on
    w's device, without a host wait."""
    m = w.abs().amax() if w.numel() else torch.zeros((), device=w.device)
    return torch.frexp(m.to(torch.float32)).exponent.to(torch.int32)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 for int32 e in [−126, 127], exactly (built from its
    bits)."""
    return torch.bitwise_left_shift(e.to(torch.int32) + 127, 23).view(torch.float32)


def scaled_fixed_point_sum(n: int, flat: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """`fixed_point_sum` for weights of any size: the terms scaled by 2^−e
    (max |wts| < 2^e) into (−1, 1), summed, scaled back. Scaling by a power
    of two is exact, so the result is again the same in any order."""
    e = pow2_exponent(wts)
    return fixed_point_sum(n, flat, wts * pow2(-e)) * pow2(e)


def splat_nearest(
    pts: torch.Tensor,
    weights: torch.Tensor,
    dims: tuple[int, int, int],
    origin: torch.Tensor,
    voxel: torch.Tensor,
) -> torch.Tensor:
    """Nearest-voxel splat → (dx, dy, dz) float32 grid: each point adds its
    weight to the voxel floor((p − origin) / voxel); points outside the
    grid add nothing."""
    dx, dy, dz = dims
    idx3 = torch.floor((pts - origin) / voxel).to(torch.int64)
    dims_t = device_ints(tuple(dims), pts.device)
    inb = ((idx3 >= 0) & (idx3 < dims_t)).all(dim=-1)
    idx3 = torch.minimum(torch.clamp_min(idx3, 0), dims_t - 1)
    flat = (idx3[:, 0] * dy + idx3[:, 1]) * dz + idx3[:, 2]
    w = weights.to(torch.float32)
    w = torch.where(inb, w, torch.zeros_like(w))
    return scaled_fixed_point_sum(dx * dy * dz, flat, w).reshape(dx, dy, dz)


def gaussian_blur_3d(grid: torch.Tensor, sigma_voxels: float, radius: int = 0) -> torch.Tensor:
    """Separable gaussian blur of a grid along each of its axes (the
    Shepard smoothing of splat_color.comp; also the density volume's blur):
    a normalized kernel of 2r + 1 taps (r = radius, or round(3σ) at least
    1), the grid zero-padded by r on each side of the axis as jnp.pad
    does, the taps summed in order."""
    if sigma_voxels <= 0:
        return grid
    r = radius or max(1, int(3.0 * sigma_voxels + 0.5))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=grid.device)
    k = torch.exp(-0.5 * (t / sigma_voxels) ** 2)
    k = k / k.sum()
    for ax in range(grid.ndim):
        g = grid.movedim(ax, -1)
        n = g.shape[-1]
        padded = torch.nn.functional.pad(g, (r, r))
        out = padded[..., 0:n] * k[0]
        for i in range(1, 2 * r + 1):
            out = out + padded[..., i : i + n] * k[i]
        grid = out.movedim(-1, ax)
    return grid.contiguous()


def splat_color_volume(
    pts, colors, weights, dims, origin, voxel, blur_sigma: float = 0.0
):
    """Shepard-weighted colour volume from coloured points → ((dx, dy, dz,
    3) RGB, (dx, dy, dz) weight density): trilinear splats of w and of
    w·r, w·g, w·b, the optional blur of all four (which keeps the Shepard
    average), then rgb = Σ w·c / max(Σ w, 1e-12) (splat_color.comp, the
    colour volume of the colvol ray-marcher). All four splats share one
    power-of-two scale, so weights of any size sum in fixed point."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=pts.device)
    cols = torch.as_tensor(colors, dtype=torch.float32, device=pts.device)
    terms = [w] + [w * cols[:, i] for i in range(3)]
    e = pow2_exponent(torch.stack(terms))
    down, up = pow2(-e), pow2(e)
    den, *chans = (splat_trilinear(pts, t * down, dims, origin, voxel) * up
                   for t in terms)
    if blur_sigma > 0:
        den = gaussian_blur_3d(den, blur_sigma)
        chans = [gaussian_blur_3d(c, blur_sigma) for c in chans]
    rgb = torch.stack(chans, dim=-1) / torch.clamp_min(den, 1e-12)[..., None]
    return rgb, den
