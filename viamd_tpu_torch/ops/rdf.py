"""Radial distribution function (RDF): stencils, normalization and the
plain all-pairs histogram.

Counterpart of viamd_tpu.ops.rdf (the `rdf(sel_a, sel_b, cutoff)` script
builtin's accumulation; default script
`r = rdf(element('C'), element('H'), 10.0)`, VIAMD src/main.cpp:528).

`pair_dist_histogram_scatter_idx` is the plain PyTorch version of the
cell-list pair-histogram kernel (ops/cuda_rdf.py, csrc/pair_hist.cu): the
same histogram over all A×B pairs, tiled on the A side. It is the reference
the kernel is held to, and the route a CPU tensor takes. `rdf_frames` sums
it over a batch of frames.
"""

from __future__ import annotations

import math

import torch

from viamd_tpu_torch.ops.pbc import _pbc_mask


def stencil_offsets(radius: int, symmetric: bool = False) -> list:
    """Cell-offset stencil. `symmetric`: self-cell first + the lexicographic
    upper half — each unordered cell pair once (the JAX kernel's half
    stencil, which the CUDA kernel also walks when A == B)."""
    offs = [
        (ox, oy, oz)
        for ox in range(-radius, radius + 1)
        for oy in range(-radius, radius + 1)
        for oz in range(-radius, radius + 1)
    ]
    if not symmetric:
        return offs
    return [(0, 0, 0)] + [o for o in offs if o > (0, 0, 0)]


def min_image_dist(
    xa: torch.Tensor,
    xb: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """(na, nb) minimum-image distances |min_image(xa_i − xb_j)|.

    Written component by component (`min_image_sq`), in exactly the order of
    operations of csrc/pair_hist.cu (which is compiled without FMA
    contraction): the kernel and this plain version then compute
    bit-identical distances, so no pair crosses a bin edge or r_max in one
    and not the other. The arithmetic is ops.pbc.min_image's single
    fractional round.
    """
    d = [xa[:, None, k] - xb[None, :, k] for k in range(3)]
    return sqrt_rn(min_image_sq(d, basis, inv_basis))


def min_image_sq(d: list, basis: torch.Tensor, inv_basis: torch.Tensor) -> torch.Tensor:
    """|min_image(d)|² of displacements given as three broadcastable
    component tensors, in csrc/pair_hist.cu's order of operations."""
    f = [
        d[0] * inv_basis[0, k] + d[1] * inv_basis[1, k] + d[2] * inv_basis[2, k]
        for k in range(3)
    ]
    f = [fk - torch.round(fk) for fk in f]
    keep = 1.0 - _pbc_mask(basis)  # 1 for an aperiodic (zero) basis
    o = [
        f[0] * basis[0, k] + f[1] * basis[1, k] + f[2] * basis[2, k]
        + d[k] * keep
        for k in range(3)
    ]
    return o[0] * o[0] + o[1] * o[1] + o[2] * o[2]


def sqrt_rn(s: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of s ≥ 0, as CUDA's sqrtf computes it.

    PyTorch's CPU sqrt is not correctly rounded (in float32 about 0.5% of
    results are one ulp off, and which ones varies with the thread that
    computes them), and a one-ulp difference moves a pair across a bin edge.
    So: take the root within an ulp, then pick among it and its two float32
    neighbours by comparing s with the squared midpoints, which float64
    holds exactly (a sum of two float32 values, halved, squared)."""
    y = torch.sqrt(s.to(torch.float64)).to(torch.float32)
    lo = torch.nextafter(y, torch.zeros_like(y))
    hi = torch.nextafter(y, torch.full_like(y, float("inf")))
    y64, s64 = y.to(torch.float64), s.to(torch.float64)
    m_lo = (y64 + lo.to(torch.float64)) * 0.5
    m_hi = (y64 + hi.to(torch.float64)) * 0.5
    return torch.where(s64 < m_lo * m_lo, lo, torch.where(s64 > m_hi * m_hi, hi, y))


def div_rn(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b for a Python number b, correctly rounded on every device: on
    CUDA, PyTorch divides by a Python number as a multiplication by its
    reciprocal, so the divisor goes in as a 0-dim tensor on a's device (a
    fill, no copy from the host)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def pair_dist_histogram_scatter_idx(
    x: torch.Tensor,
    idx_a: torch.Tensor,  # (na,) global indices of the A selection
    idx_b: torch.Tensor,  # (nb,) global indices of the B selection
    w_a: torch.Tensor,  # (na,) weights at idx_a
    w_b: torch.Tensor,  # (nb,) weights at idx_b
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    nbins: int,
    r_max: float,
    max_pairs: int = 1 << 23,
) -> torch.Tensor:
    """All-pairs min-image A→B distance histogram over [0, r_max) → (nbins,)
    f32.

    Pair (i, j) adds w_a[i]·w_b[j] to bin int(dist·nbins/r_max) when
    dist < r_max; pairs with equal global ids (self pairs of overlapping
    selections) are skipped; a distance that rounds onto bin `nbins` is
    dropped, as in the JAX package. Both (i, j) and (j, i) count when both
    selections cover them. Tiled on the A side so a tile holds at most
    `max_pairs` pairs. Every pair of a tile goes into one `index_add_`: a
    boolean selection of the counted pairs would make the host wait for
    the device once per tile. The pairs it does not count go to a scratch
    slot of their B atom's own, past the bins, so they neither count nor
    pile onto one address.
    """
    na, nb = int(idx_a.shape[0]), int(idx_b.shape[0])
    if na == 0 or nb == 0:
        return torch.zeros(nbins, dtype=torch.float32, device=x.device)
    hist = torch.zeros(nbins + nb, dtype=torch.float32, device=x.device)
    scratch = torch.arange(nbins, nbins + nb, device=x.device)
    xa, xb = x[idx_a], x[idx_b]
    wa, wb = w_a.to(torch.float32), w_b.to(torch.float32)
    inv_bin = float(torch.tensor(nbins / r_max, dtype=torch.float32))
    tile = max(1, min(na, max_pairs // nb))
    for i0 in range(0, na, tile):
        dist = min_image_dist(xa[i0 : i0 + tile], xb, basis, inv_basis)
        take = (dist < r_max) & (idx_a[i0 : i0 + tile, None] != idx_b[None, :])
        # dist < r_max keeps the product finite and below nbins + 1
        bins = torch.where(take, dist * inv_bin, 0.0).to(torch.int64)
        slot = torch.where(take & (bins < nbins), bins, scratch)
        w = wa[i0 : i0 + tile, None] * wb[None, :]
        hist.index_add_(0, slot.reshape(-1), w.reshape(-1))
    return hist[:nbins]


def pair_dist_histogram_atom_sharded(
    x: torch.Tensor,
    w_a: torch.Tensor,  # (n,) A weights over all atoms
    w_b: torch.Tensor,  # (n,) B weights over all atoms
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    nbins: int,
    r_max: float,
    mesh,  # parallel.mesh.Mesh holding `axis`
    axis: str = "atoms",
) -> torch.Tensor:
    """Atom-axis sharded weighted pair histogram → (nbins,) f32, the same on
    every rank of the mesh axis `axis`.

    Counterpart of viamd_tpu.ops.rdf.pair_dist_histogram_atom_sharded (plain
    code there too): rank k of the axis takes the A rows [k·n // s,
    (k+1)·n // s) against every atom through
    `pair_dist_histogram_scatter_idx` (self pairs skipped by global id), and
    the float32 partials are summed over the axis — in another order than
    one rank's sum, so equal to it within float32 rounding. Every rank of the
    axis must call it together."""
    n = x.shape[0]
    k, s = mesh.axis_index(axis), mesh.shape[axis]
    lo, hi = k * n // s, (k + 1) * n // s
    ids = torch.arange(n, dtype=torch.int32, device=x.device)
    hist = pair_dist_histogram_scatter_idx(
        x, ids[lo:hi], ids, w_a[lo:hi], w_b, basis, inv_basis, nbins, r_max
    )
    return mesh.all_reduce(hist, axis)


def pair_dist_histogram_dynamic(
    x: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    w_a: torch.Tensor,
    w_b: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    nbins: int,
    r_max: float,
) -> torch.Tensor:
    """One frame's histogram of a dynamic selection's rdf, normalised by the
    frame's own pair count: `pair_dist_histogram_scatter_idx` with this
    frame's 0/1 weights (a dynamic side passes every atom and its per-frame
    mask), divided by max(Σw_a · Σw_b, 1) — the JAX compiler's per-frame
    normalisation (viamd_tpu/script/compiler.py:1374-1400), computed on the
    device."""
    hist = pair_dist_histogram_scatter_idx(
        x, idx_a, idx_b, w_a, w_b, basis, inv_basis, nbins, r_max
    )
    pairs = w_a.to(torch.float32).sum() * w_b.to(torch.float32).sum()
    return hist / pairs.clamp_min(1.0)


def rdf_frames(
    coords: torch.Tensor,  # (F, n, 3)
    w_a: torch.Tensor,  # (n,) dense A weights
    w_b: torch.Tensor,  # (n,) dense B weights
    basis: torch.Tensor,  # (3, 3), or (F, 3, 3) one a frame
    inv_basis: torch.Tensor,
    nbins: int,
    r_max: float,
) -> torch.Tensor:
    """Weighted pair histogram summed over a batch of frames → (nbins,) f32.

    Counterpart of viamd_tpu.ops.rdf.rdf_frames (a vmap of its dense
    pair_dist_histogram, summed). Each frame goes through
    `pair_dist_histogram_scatter_idx` over the atoms whose weight is not 0
    (pair (i, j) adds w_a[i]·w_b[j]; i = j skipped), and the frames' histograms
    are added in frame order. A (3, 3) basis serves every frame. The JAX
    function bins by comparing each distance with the bin edges, this one by
    int(dist·nbins/r_max), so a distance within rounding of an edge can fall
    in the neighbouring bin."""
    idx_a = torch.nonzero(w_a).flatten()
    idx_b = torch.nonzero(w_b).flatten()
    wa, wb = w_a[idx_a], w_b[idx_b]
    hist = torch.zeros(nbins, dtype=torch.float32, device=coords.device)
    for f in range(coords.shape[0]):
        b, ib = (basis, inv_basis) if basis.ndim == 2 else (basis[f], inv_basis[f])
        hist = hist + pair_dist_histogram_scatter_idx(
            coords[f], idx_a, idx_b, wa, wb, b, ib, nbins, r_max
        )
    return hist


def rdf_normalize(
    hist: torch.Tensor,
    count_a: float,
    count_b: float,
    volume: float,
    r_max: float,
    n_frames: int,
) -> torch.Tensor:
    """Accumulated pair histogram → g(r).

    g(r_k) = H_k / (F · N_a · ρ_b · V_shell(k)) with ρ_b = N_b / V; an
    aperiodic system (volume 0) gets a shell-normalized relative density.
    """
    nbins = hist.shape[-1]
    dr = r_max / nbins
    r_lo = torch.arange(nbins, dtype=torch.float32, device=hist.device) * dr
    shell = 4.0 / 3.0 * math.pi * ((r_lo + dr) ** 3 - r_lo**3)
    vol = max(float(volume), 0.0)
    rho_b = count_b / max(vol, 1e-30) if vol > 0 else 1.0
    denom = max(n_frames, 1) * max(count_a, 1e-30) * rho_b * shell
    return hist / denom
