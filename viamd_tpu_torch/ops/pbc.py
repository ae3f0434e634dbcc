"""Periodic-boundary-condition primitives on torch tensors.

Counterpart of viamd_tpu.ops.pbc (mdlib's md_util PBC family: min-image,
wrap, deperiodize — VIAMD src/viamd.cpp:1846-1895,
src/components/shapespace/shapespace.cpp:425).

Every function takes coordinates in Å plus a (3, 3) row-vector cell basis and
its inverse (batched over leading dims where the shapes broadcast). A basis
of zeros means "no PBC": the functions then reduce to identity/Euclidean
math through the same arithmetic, so one code path serves both.
"""

from __future__ import annotations

import itertools

import torch


def cellmul(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 3) row vectors times a (..., 3, 3) basis."""
    return v @ m


def inv_basis_of(basis: torch.Tensor) -> torch.Tensor:
    """Inverse of a (possibly zero = aperiodic) cell basis, batched over
    leading dims; zeros for a zero basis. Uses `inv_ex`, which never waits
    on the device to check for singular input (the zero case is masked)."""
    det = torch.linalg.det(basis)
    ok = (det.abs() > 1e-12)[..., None, None]
    eye = torch.eye(3, dtype=basis.dtype, device=basis.device).expand_as(basis)
    inv = torch.linalg.inv_ex(torch.where(ok, basis, eye)).inverse
    # contiguous: the CUDA solver returns column-major results
    return torch.where(ok, inv, torch.zeros_like(basis)).contiguous()


def min_image_exact(
    d: torch.Tensor, basis: torch.Tensor, inv_basis: torch.Tensor
) -> torch.Tensor:
    """Exact minimum-image displacement for arbitrary (skewed) cells: the
    single-round image, then the shortest of it and its 26 lattice
    neighbours (the first strictly shorter candidate wins, in the JAX
    package's order)."""
    base = min_image(d, basis, inv_basis)
    best = base
    best_n = (base * base).sum(-1, keepdim=True)
    for s in itertools.product((-1.0, 0.0, 1.0), repeat=3):
        if s == (0.0, 0.0, 0.0):
            continue
        cand = base + (s[0] * basis[..., 0, :] + s[1] * basis[..., 1, :]
                       + s[2] * basis[..., 2, :])
        n = (cand * cand).sum(-1, keepdim=True)
        best = torch.where(n < best_n, cand, best)
        best_n = torch.minimum(n, best_n)
    return best


def _pbc_mask(basis: torch.Tensor) -> torch.Tensor:
    """1.0 if the cell is periodic (any nonzero basis entry) else 0.0."""
    return (basis.abs().sum() > 0).to(basis.dtype)


def min_image(
    d: torch.Tensor, basis: torch.Tensor, inv_basis: torch.Tensor
) -> torch.Tensor:
    """Minimum-image displacement vectors (single fractional round).

    Exact for orthorhombic cells and for triclinic cells whose skew is below
    half the box (the assumption mdlib's SIMD path makes). `torch.round`
    rounds half to even, as `jnp.round` does.
    """
    f = cellmul(d, inv_basis)
    f = f - torch.round(f)
    return cellmul(f, basis) + d * (1.0 - _pbc_mask(basis))


def wrap(
    x: torch.Tensor, basis: torch.Tensor, inv_basis: torch.Tensor
) -> torch.Tensor:
    """Wrap positions into the primary cell [0, 1) in fractional space."""
    f = cellmul(x, inv_basis)
    f = f - torch.floor(f)
    return cellmul(f, basis) + x * (1.0 - _pbc_mask(basis))


def deperiodize(
    x: torch.Tensor,
    ref: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Shift each position by whole lattice vectors to lie nearest `ref`."""
    return ref + min_image(x - ref, basis, inv_basis)


def unwrap_frames(
    coords: torch.Tensor, basis: torch.Tensor, inv_basis: torch.Tensor
) -> torch.Tensor:
    """Remove wrap jumps along the frame axis of (F, n, 3) trajectories:
    frame f keeps each atom on frame f−1's periodic image (a cumulative sum
    of per-step minimum-image increments)."""
    wrapped = min_image(coords[1:] - coords[:-1], basis, inv_basis)
    out0 = coords[:1]
    return torch.cat([out0, out0 + torch.cumsum(wrapped, dim=0)], dim=0)


def pair_displacements(
    xa: torch.Tensor, xb: torch.Tensor, basis: torch.Tensor, inv_basis: torch.Tensor
) -> torch.Tensor:
    """All-pairs min-image displacements (na, nb, 3)."""
    return min_image(xa[:, None, :] - xb[None, :, :], basis, inv_basis)


def pair_distances(
    xa: torch.Tensor, xb: torch.Tensor, basis: torch.Tensor, inv_basis: torch.Tensor
) -> torch.Tensor:
    """All-pairs min-image distances (na, nb)."""
    d = pair_displacements(xa, xb, basis, inv_basis)
    return torch.sqrt((d * d).sum(-1).clamp_min(0.0))


def recenter_frame(
    x: torch.Tensor,
    sel_weights: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """Recenter a frame on a selection (VIAMD src/viamd.cpp:2162-2313):
    translate so the selection's PBC-aware COM sits at the box centre, then
    wrap whole segments (molecules) about their own COM."""
    from viamd_tpu_torch.ops.com import com, com_segments

    c = com(x, sel_weights, basis, inv_basis)
    center = 0.5 * (basis[0] + basis[1] + basis[2])
    shifted = x + (center - c) * _pbc_mask(basis)
    seg_com = com_segments(
        shifted, torch.ones_like(x[:, 0]), segment_ids, num_segments,
        basis, inv_basis,
    )
    ref = seg_com[segment_ids]
    return ref + min_image(shifted - ref, basis, inv_basis)
