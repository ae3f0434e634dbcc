"""Plain reference of the analysis script the configurations run:

    r = rdf(element('O'), element('O'), 10.0);
    v = sdf(residue(1:64), element('H'), 5.0);
    {lin, plan, iso} = shape_weights(all);

over a periodic water box, frame by frame, in plain PyTorch. It imports
nothing of the program and takes nothing the program made: it reads the
benchmark's own inputs (portbench/inputs.py). Its arithmetic is a frozen
copy of the plain versions the port's kernels are held to (the minimum
image in csrc/pair_hist.cu's order, the PBC-aware centre of mass, the
closed-form 3x3 eigensolver and Kabsch rotation, the trilinear splat's
fixed-point sum), with no capacity, route or cell-walk of the program:

- r: every ordered O–O pair (i ≠ j) within r_max, found through a cell
  list of cells at least r_max wide, binned as int(d · nbins / r_max);
- v: per frame and structure, the structure's centre and rotation onto its
  reference coordinates, every H within reach mapped into that frame and
  splatted into the 64³ grid spanning ±extent;
- lin, plan, iso: the barycentric weights of the mass-weighted gyration
  tensor of all atoms about their PBC-aware centre of mass.

`dtype` runs the per-element arithmetic in another precision (the control
runs bfloat16); sums are float64 either way.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from portbench.inputs import WaterBox

RDF_BINS = 128
SDF_DIMS = 64


# -- periodic geometry ------------------------------------------------------------


def min_image(d, basis, inv):
    """Minimum-image displacements (one fractional round; exact for an
    orthorhombic cell)."""
    f = d @ inv
    return (f - torch.round(f)) @ basis


def sqrt_rn(s):
    """Correctly rounded square root (CUDA's sqrtf) for float32; the plain
    root in any other precision."""
    if s.dtype != torch.float32:
        return torch.sqrt(s)
    y = torch.sqrt(s.to(torch.float64)).to(torch.float32)
    lo = torch.nextafter(y, torch.zeros_like(y))
    hi = torch.nextafter(y, torch.full_like(y, float("inf")))
    y64, s64 = y.to(torch.float64), s.to(torch.float64)
    m_lo = (y64 + lo.to(torch.float64)) * 0.5
    m_hi = (y64 + hi.to(torch.float64)) * 0.5
    return torch.where(s64 < m_lo * m_lo, lo, torch.where(s64 > m_hi * m_hi, hi, y))


def com(x, w, basis, inv):
    """Weighted PBC-aware centre of mass (the circular mean of each
    fractional coordinate) of x (..., n, 3) with weights (..., n)."""
    w = w.to(x.dtype)[..., None]
    wsum = w.sum(dim=-2).clamp_min(1e-30)
    theta = (x @ inv) * (2.0 * math.pi)
    c = (torch.cos(theta) * w).sum(dim=-2) / wsum
    s = (torch.sin(theta) * w).sum(dim=-2) / wsum
    frac = torch.atan2(-s, -c) / (2.0 * math.pi) + 0.5
    return frac @ basis


# -- the closed-form 3x3 eigensolver and Kabsch rotation ----------------------------


def _unit(axis: int, like):
    e = torch.zeros_like(like)
    e.select(-1, axis).fill_(1.0)
    return e


def eigh3x3(A):
    """Eigenvalues (descending) and eigenvectors (columns) of symmetric
    (..., 3, 3) matrices, by Smith's trigonometric method."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = A.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    B = A - q * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    detB = torch.linalg.det(B.float()).to(A.dtype)
    r = (detB / (2.0 * p**3).clamp_min(1e-30)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    q0 = q[..., 0, 0]
    l0 = q0 + 2.0 * p * torch.cos(phi)
    l2 = q0 + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    l1 = 3.0 * q0 - l0 - l2
    vals = torch.stack([l0, l1, l2], dim=-1)

    def eigvec(lam):
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01, c02, c12 = (torch.linalg.cross(a, b) for a, b in ((r0, r1), (r0, r2), (r1, r2)))
        n01, n02, n12 = ((c * c).sum(-1, keepdim=True) for c in (c01, c02, c12))
        best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                           torch.where(n02 >= n12, c02, c12))
        nrm = torch.sqrt((best * best).sum(-1, keepdim=True).clamp_min(1e-30))
        degen = (nrm < 1e-12).to(A.dtype)
        return best / nrm * (1.0 - degen) + _unit(0, best) * degen

    v0, v2 = eigvec(l0), eigvec(l2)
    v2 = v2 - (v2 * v0).sum(-1, keepdim=True) * v0
    n2 = torch.sqrt((v2 * v2).sum(-1, keepdim=True).clamp_min(1e-30))
    is_bad = (n2 < 1e-12).to(A.dtype)
    alt = torch.linalg.cross(v0, _unit(2, v0))
    altn = torch.sqrt((alt * alt).sum(-1, keepdim=True).clamp_min(1e-30))
    alt2 = torch.linalg.cross(v0, _unit(1, v0))
    alt2n = torch.sqrt((alt2 * alt2).sum(-1, keepdim=True).clamp_min(1e-30))
    alt = torch.where(altn > 0.1, alt / altn, alt2 / alt2n)
    v2 = v2 / torch.where(n2 < 1e-12, torch.ones_like(n2), n2) * (1.0 - is_bad) + alt * is_bad
    v1 = torch.linalg.cross(v2, v0)
    return vals, torch.stack([v0, v1, v2], dim=-1)


def kabsch_rotation(p, q, w):
    """Proper rotation R minimizing Σ w‖R p − q‖² of centred p, q (..., k, 3)."""
    H = (p * w.to(p.dtype)[..., None]).mT @ q
    lam, V = eigh3x3(H.mT @ H)
    s = torch.sqrt(lam.clamp_min(0.0))
    eps = 1e-12
    v0, v1 = V[..., :, 0], V[..., :, 1]
    ex, ey = _unit(0, v0), _unit(1, v0)

    def unit_or(u, alt):
        n = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        return torch.where(n > 1e-6, u / n.clamp_min(eps), alt)

    def matvec(M, v):
        return (M @ v[..., None])[..., 0]

    u0 = unit_or(matvec(H, v0) / s[..., 0:1].clamp_min(eps), ex)
    a = torch.where(u0[..., 0:1].abs() < 0.9, ex, ey)
    alt1 = torch.linalg.cross(u0, a)
    alt1 = alt1 / torch.linalg.vector_norm(alt1, dim=-1, keepdim=True).clamp_min(eps)
    u1r = matvec(H, v1) / s[..., 1:2].clamp_min(eps)
    u1r = u1r - (u1r * u0).sum(-1, keepdim=True) * u0
    u1 = unit_or(u1r, alt1)
    u2 = torch.linalg.cross(u0, u1)
    v2 = torch.linalg.cross(v0, v1)
    return (v0[..., :, None] * u0[..., None, :] + v1[..., :, None] * u1[..., None, :]
            + v2[..., :, None] * u2[..., None, :])


def align(x, w, ref_centered, basis, inv):
    """(R, centre): the world → reference transform of weighted structures
    x (S, k, 3) onto their centred reference coordinates."""
    c = com(x, w, basis, inv)
    p = min_image(x - c[..., None, :], basis, inv)
    return kabsch_rotation(p, ref_centered, w), c


# -- the three properties -------------------------------------------------------


def rdf_hist(x, basis, inv, r_max: float, nbins: int = RDF_BINS, block: int = 8,
             pairs_max: int = 1 << 25):
    """(nbins,) float64 counts of the ordered pairs (i ≠ j) of x (n, 3)
    within r_max in an orthorhombic periodic box, binned as
    int(d · nbins / r_max), and the number of unordered pairs within r_max.

    Pairs come from a cell list of cells at least r_max wide (at least 3 a
    side): each cell against itself and its 13 half-stencil neighbours, in
    tiles of `block` × `block` atoms (a cell's atoms in blocks of `block`),
    a pair of distinct blocks counting in both orders. A distance is the
    minimum image of the difference, each component rounded as the pair
    kernel rounds it."""
    dev = x.device
    if bool((basis - torch.diag(torch.diagonal(basis))).any()):
        raise ValueError("rdf_hist takes an orthorhombic box")
    edge = [float(v) for v in torch.diagonal(basis)]
    inv_d = [float(v) for v in torch.diagonal(inv)]
    n_c = int(min(edge) // r_max)
    if n_c < 3:
        raise ValueError(f"box {min(edge)} under three cutoffs {r_max}")
    C = n_c**3
    frac = x @ inv
    c3 = ((frac - torch.floor(frac)) * n_c).long().clamp_(0, n_c - 1)
    cid = (c3[:, 0] * n_c + c3[:, 1]) * n_c + c3[:, 2]
    order = torch.argsort(cid)
    counts = torch.bincount(cid, minlength=C)
    # each cell's atoms in blocks: block k of cell c holds its atoms
    # k·block … (k+1)·block − 1
    nblk = (counts + block - 1) // block
    max_blk = int(nblk.max())
    blk_start = torch.cumsum(nblk, 0) - nblk
    n_blocks = int(nblk.sum())
    rank = torch.arange(x.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[cid[order]]
    blocks = torch.full((n_blocks + 1, block), -1, dtype=torch.long, device=dev)  # last: empty
    blocks[blk_start[cid[order]] + rank // block, rank % block] = order
    k = torch.arange(max_blk, device=dev)
    cell_blocks = torch.where(k[None, :] < nblk[:, None], blk_start[:, None] + k[None, :], n_blocks)
    xs = torch.cat([x, torch.zeros((1, 3), dtype=x.dtype, device=dev)])  # atom -1 → a pad row
    comp = [xs[blocks, j] for j in range(3)]  # (n_blocks + 1, block) per axis
    inv_bin = torch.tensor(nbins / r_max, dtype=torch.float32).to(x.dtype).item()
    root = torch.sqrt if x.is_cuda else sqrt_rn  # CUDA's sqrt is correctly rounded
    hist = torch.zeros(nbins + 1, dtype=torch.float64, device=dev)
    pairs = torch.zeros((), dtype=torch.float64, device=dev)
    ci = torch.arange(C, device=dev)
    cxyz = torch.stack([ci // (n_c * n_c), (ci // n_c) % n_c, ci % n_c], -1)
    offsets = [(0, 0, 0)] + [o for o in itertools.product((-1, 0, 1), repeat=3)
                             if o > (0, 0, 0)]
    tri = torch.triu(torch.ones(max_blk, max_blk, dtype=torch.bool, device=dev), 1)
    diag = torch.eye(max_blk, dtype=torch.bool, device=dev)

    def tiles(ba, bb, weight, self_pairs):
        nonlocal hist, pairs
        step = max(1, pairs_max // (block * block))
        for p0 in range(0, ba.shape[0], step):
            a, b = ba[p0:p0 + step], bb[p0:p0 + step]
            d2 = None
            for j in range(3):
                f = (comp[j][a][:, :, None] - comp[j][b][:, None, :]) * inv_d[j]
                o = (f - torch.round(f)) * edge[j]
                d2 = o * o if d2 is None else d2 + o * o
            dist = root(d2)
            take = (blocks[a][:, :, None] >= 0) & (blocks[b][:, None, :] >= 0) & (dist < r_max)
            if self_pairs:
                take &= blocks[a][:, :, None] != blocks[b][:, None, :]
            bins = torch.where(take, (dist * inv_bin).int().clamp_(max=nbins), nbins)
            hist += weight * torch.bincount(bins.reshape(-1), minlength=nbins + 1)[:nbins + 1]
            pairs += take.sum() * (weight / 2.0)

    for off in offsets:
        nb3 = (cxyz + torch.tensor(off, device=dev)) % n_c
        nb = (nb3[:, 0] * n_c + nb3[:, 1]) * n_c + nb3[:, 2]
        A = cell_blocks[:, :, None].expand(C, max_blk, max_blk)
        B = cell_blocks[nb][:, None, :].expand(C, max_blk, max_blk)
        live = (A < n_blocks) & (B < n_blocks)
        if off == (0, 0, 0):
            tiles(A[live & diag], B[live & diag], 1.0, True)
            tiles(A[live & tri], B[live & tri], 2.0, False)
        else:
            tiles(A[live], B[live], 2.0, False)
    return hist[:nbins], int(pairs)


def splat(p, w, dims: int, extent: float):
    """(dims³,) float64 trilinear splat of points p (m, 3) with weights w
    into the grid spanning ±extent (voxel centres at −extent + (i + ½)·h);
    corners outside the grid are dropped."""
    voxel_w = 2.0 * extent / dims
    g = (p - (-extent)) / voxel_w - 0.5
    g0 = torch.floor(g)
    f = g - g0
    i0 = g0.long()
    out = torch.zeros(dims**3, dtype=torch.float64, device=p.device)
    for corner in range(8):
        o = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1], device=p.device)
        idx = i0 + o
        tent = torch.where(o == 1, f, 1.0 - f)
        wt = (tent[:, 0] * tent[:, 1] * tent[:, 2] * w).double()
        inb = ((idx >= 0) & (idx < dims)).all(-1)
        flat = (idx[:, 0] * dims + idx[:, 1]) * dims + idx[:, 2]
        out.index_add_(0, flat[inb], wt[inb])
    return out


class Structures:
    """The SDF's reference structures: one per residue of the range, atoms
    weighted by mass, reference coordinates the base configuration's,
    centred on their centre of mass."""

    def __init__(self, wb: WaterBox, residues: range, device, dtype):
        idx = np.stack([np.arange(3 * (r - 1), 3 * r) for r in residues])  # (S, 3)
        w = wb.masses()[idx]
        ref = wb.coords[idx].astype(np.float32)
        wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
        centers = (ref * w[..., None]).sum(axis=1, keepdims=True) / wsum[..., None]
        self.idx = torch.as_tensor(idx, device=device)
        self.w = torch.as_tensor(w, dtype=dtype, device=device)
        self.ref = torch.as_tensor(ref - centers, dtype=dtype, device=device)


def sdf_grid(x, st: Structures, targets, extent: float, basis, inv, dims: int = SDF_DIMS):
    """(dims³,) float64 SDF grid of one frame, summed over the structures:
    every target within √3·(extent + ½ voxel) of a structure's centre,
    mapped into its reference frame and splatted (weight 1)."""
    R, c = align(x[st.idx], st.w, st.ref, basis, inv)
    xt = x[targets]
    sup = math.sqrt(3.0) * (extent + 0.5 * 2.0 * extent / dims) + 1e-3
    d = min_image(xt[None, :, :] - c[:, None, :], basis, inv)  # (S, n_t, 3)
    s_i, t_i = torch.nonzero((d * d).sum(-1) < sup * sup, as_tuple=True)
    p = (d[s_i, t_i][:, None, :] @ R[s_i].mT)[:, 0, :]
    return splat(p, torch.ones_like(p[:, 0]), dims, extent)


def shape_weights(x, w, basis, inv):
    """(linear, planar, isotropic) of the weighted gyration tensor of x."""
    c = com(x, w, basis, inv)
    d = min_image(x - c, basis, inv)
    wd = w.to(x.dtype)[:, None]
    C = ((d * wd).mT @ d) / wd.sum().clamp_min(1e-30)
    vals, _ = eigh3x3(C)
    l0 = vals[0].clamp_min(1e-30)
    return torch.stack([(vals[0] - vals[1]) / l0, (vals[1] - vals[2]) / l0, vals[2] / l0])


def cell_tensors(wb: WaterBox, device, dtype):
    """The box basis and its inverse as the program's frames carry them:
    the float32 basis, its inverse solved in float32."""
    basis = torch.as_tensor(wb.basis, device=device)
    inv = torch.linalg.inv_ex(basis).inverse.contiguous()
    return basis.to(dtype), inv.to(dtype)


def evaluate(wb: WaterBox, stack: torch.Tensor, config: dict, dtype=torch.float32,
             rdf: bool = True) -> dict:
    """The script's properties over every frame of `stack` (F, n, 3):
    {"r": (128,) counts of ordered O–O pairs summed over frames, "v": (64³,)
    summed over frames, "lin", "plan", "iso": (F,)}, in float64 on the
    stack's device."""
    dev = stack.device
    basis, inv = cell_tensors(wb, dev, dtype)
    o_idx = torch.as_tensor(np.nonzero(wb.z == 8)[0], device=dev)
    h_idx = torch.as_tensor(np.nonzero(wb.z == 1)[0], device=dev)
    masses = torch.as_tensor(wb.masses(), dtype=dtype, device=dev)
    st = Structures(wb, range(1, 65), dev, dtype)
    F = stack.shape[0]
    r = torch.zeros(RDF_BINS, dtype=torch.float64, device=dev)
    v = torch.zeros(SDF_DIMS**3, dtype=torch.float64, device=dev)
    shape = torch.zeros((F, 3), dtype=torch.float64, device=dev)
    for f in range(F):
        x = stack[f].to(dtype)
        if rdf:
            r += rdf_hist(x[o_idx], basis, inv, 10.0)[0]
        v += sdf_grid(x, st, h_idx, 5.0, basis, inv)
        shape[f] = shape_weights(x, masses, basis, inv).double()
    return {"r": r, "v": v.reshape(SDF_DIMS, SDF_DIMS, SDF_DIMS), "lin": shape[:, 0],
            "plan": shape[:, 1], "iso": shape[:, 2]}


def compare(got: dict, want: dict) -> dict:
    """The numbers `correct` is decided on, for one result: the histogram's
    and the volume's relative L1 gaps (Σ|got − want| ÷ Σ want) and the
    largest gap of a shape weight over the frames."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).reshape(-1)

    def gaps(a, b):  # a result of another size is as far off as can be
        a, b = t(a), b.cpu().reshape(-1)
        return (a - b).abs() if a.shape == b.shape else torch.tensor([math.inf])

    def rel_l1(a, b):
        return float(gaps(a, b).sum() / b.cpu().abs().sum().clamp_min(1e-300))

    shape = max(float(gaps(got[k], want[k]).max()) for k in ("lin", "plan", "iso"))
    return {"r_rel_l1": rel_l1(got["r"], want["r"]), "v_rel_l1": rel_l1(got["v"], want["v"]),
            "shape_max_abs": shape}
