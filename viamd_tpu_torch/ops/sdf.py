"""Spatial distribution function (SDF) accumulation on torch tensors.

Counterpart of viamd_tpu.ops.sdf (the `sdf(ref_sel, target_sel, extent)`
script builtin: VOLUME properties accumulated in the internal reference
frame of each structure, consumed by density_volume.cpp:180-285).

Per frame and per reference structure s:
1. make s whole about its PBC-aware COM and Kabsch-align it to its static
   reference coordinates → rotation R_s, center c_s (ops.rmsd.align_frame);
2. map each target atom t into the reference frame:
   p = R_s · min_image(x_t − c_s);
3. trilinear-splat the targets with |p|∞ < extent + ½ voxel into the
   (D, D, D) grid.

The three routes of the JAX package, with its capacity cuts kept in its
order:
- `sdf_accumulate` (dense, small or aperiodic systems): every target
  against every structure, nothing dropped;
- `sdf_accumulate_pairs` (few structures over many targets, no cell
  list): per structure the first `pair_cap` in-ball targets in
  target-index order, then globally the first `compact_cap` in-support
  slots in slot order;
- `sdf_accumulate_cl` (many structures): the targets' cell list, read
  through the JAX package's (S, S3, cap) slot layout — per structure the
  S3 stencil cells around its centre, per cell the first `cl_capacity`
  targets in cell order (ascending target index), so a cell holding more
  drops the rest — then globally the first `compact_cap` in-support slots
  in slot order.
`sdf_frames` sums the dense route over a batch of frames.
Ranks are int32 cumsums and the compaction a scatter, in place of the
JAX package's triangle-matmul rank select. The host-side sizers, stencils
and `make_structure_inputs` are numpy copies.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.core.tracing import section
from viamd_tpu_torch.ops.density import splat_trilinear
from viamd_tpu_torch.ops.neighbors import (
    build_cell_list,
    candidate_cells,
    cell3_of_points,
    choose_grid_r,
    frac_coords,
)
from viamd_tpu_torch.ops.pbc import min_image
from viamd_tpu_torch.ops.rmsd import align_frame


def sdf_reference_frames(
    x: torch.Tensor,  # (n, 3) frame coords
    struct_idx: torch.Tensor,  # (S, K) padded atom indices per structure
    struct_w: torch.Tensor,  # (S, K) weights (0 for padding)
    ref_centered: torch.Tensor,  # (S, K, 3) static centered reference coords
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-structure (R (S, 3, 3), center (S, 3)) world→reference transforms."""
    return align_frame(x[struct_idx], struct_w, ref_centered, basis, inv_basis)


def compact_first(m: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions of the first `cap` set entries of each row of `m`.

    m: (..., n) bool. Returns (src (..., cap) int64, keep (..., cap) bool):
    src[..., j] is the index of the (j+1)-th set entry where keep[..., j];
    elsewhere src is 0 and keep False. Built from an int32 inclusive cumsum
    and a scatter, with no host round trip (no `nonzero`)."""
    n = m.shape[-1]
    rank = torch.cumsum(m.to(torch.int32), dim=-1, dtype=torch.int32)
    dest = torch.where(m & (rank <= cap), rank - 1, cap).to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=m.device).expand_as(dest)
    src = torch.zeros(
        (*m.shape[:-1], cap + 1), dtype=torch.int64, device=m.device
    ).scatter_(-1, dest, pos)[..., :cap]
    slots = torch.arange(cap, dtype=torch.int32, device=m.device)
    keep = slots < rank[..., -1:]
    return src, keep


def _compact_support(pf, wf, extent: float, voxel_w: float, compact_cap):
    """Pre-splat compaction: keep the first `compact_cap` slots (in slot
    order) whose tent support touches the grid (|p|∞ < extent + ½ voxel);
    a no-op when the cap does not cut the slot count."""
    n_slots = pf.shape[0]
    if compact_cap is None or compact_cap >= n_slots:
        return pf, wf
    sup = extent + 0.5 * voxel_w
    m = (wf > 0.0) & (pf.abs().amax(dim=-1) < sup)
    src, keep = compact_first(m, compact_cap)
    return pf[src], torch.where(keep, wf[src], torch.zeros_like(wf[src]))


def _grid_frame(extent: float, dims: int, device):
    """(origin, voxel, voxel width) of the (dims³) grid spanning ±extent."""
    voxel_w = 2.0 * extent / dims
    origin = torch.full((3,), -extent, dtype=torch.float32, device=device)
    voxel = torch.full((3,), voxel_w, dtype=torch.float32, device=device)
    return origin, voxel, voxel_w


def sdf_accumulate_pairs(
    x: torch.Tensor,
    target_w: torch.Tensor,  # (n,) dense target weights
    struct_idx: torch.Tensor,  # (S, K)
    struct_w: torch.Tensor,  # (S, K)
    ref_centered: torch.Tensor,  # (S, K, 3)
    extent: float,
    dims: int,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    idx_t: torch.Tensor,  # (n_t,) target indices
    pair_cap: int,  # per-structure candidate capacity
    compact_cap: "int | None" = None,  # global pre-splat compaction
) -> torch.Tensor:
    """One frame's SDF grid (dims, dims, dims) for few structures over many
    targets: a direct (S, n_t) coverage-ball test, per-structure compaction
    to `pair_cap` candidates, optional global compaction, then the splat.

    Coverage: a target mapping into the ±extent cube (+½-voxel tent
    support) lies within √3·(extent + ½ voxel) of the structure COM.
    """
    n_t, S = int(idx_t.shape[0]), int(struct_idx.shape[0])
    if n_t == 0 or S == 0:
        return torch.zeros((dims, dims, dims), dtype=torch.float32, device=x.device)
    with section("sdf.frames"):
        R, c = sdf_reference_frames(
            x, struct_idx, struct_w, ref_centered, basis, inv_basis
        )
    with section("sdf.cover"):
        xt = x[idx_t]
        twt = target_w[idx_t]
        origin, voxel, voxel_w = _grid_frame(extent, dims, x.device)
        sup = 1.7320508 * (extent + 0.5 * voxel_w) + 1e-4
        # (S, n_t) min-image distance² in the JAX package's form: cartesian
        # difference minus the rounded fractional shift mapped back
        d = xt[None, :, :] - c[:, None, :]
        dd = d - torch.round(d @ inv_basis) @ basis
        m = (twt[None, :] > 0.0) & ((dd * dd).sum(-1) < sup * sup)
    with section("sdf.compact"):
        src, keep = compact_first(m, pair_cap)  # (S, C)
        w = torch.where(keep, twt[src], torch.zeros_like(twt[src]))
        p = min_image(xt[src] - c[:, None, :], basis, inv_basis) @ R.mT
        pf, wf = _compact_support(
            p.reshape(-1, 3), w.reshape(-1), extent, voxel_w, compact_cap
        )
    with section("sdf.splat"):
        return splat_trilinear(pf, wf, (dims, dims, dims), origin, voxel)


def sdf_accumulate(
    x: torch.Tensor,
    target_w: torch.Tensor,  # (n,) dense target weights
    struct_idx: torch.Tensor,  # (S, K)
    struct_w: torch.Tensor,  # (S, K)
    ref_centered: torch.Tensor,  # (S, K, 3)
    extent: float,
    dims: int,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    idx_t: torch.Tensor,  # (n_t,) target indices
    max_points: int = 1 << 22,
) -> torch.Tensor:
    """One frame's SDF grid (dims, dims, dims), summed over structures:
    every target mapped into every structure's frame (the dense route).

    Only the targets are gathered (the JAX package splats all n atoms with
    weight 0 off the target). Structures go in chunks of at most
    `max_points` (structure, target) points a splat."""
    n_t, S = int(idx_t.shape[0]), int(struct_idx.shape[0])
    origin, voxel, _ = _grid_frame(extent, dims, x.device)
    grid = torch.zeros((dims, dims, dims), dtype=torch.float32, device=x.device)
    if n_t == 0 or S == 0:
        return grid
    xt, twt = x[idx_t], target_w[idx_t]
    R, c = sdf_reference_frames(
        x, struct_idx, struct_w, ref_centered, basis, inv_basis
    )
    chunk = max(1, max_points // n_t)
    for s0 in range(0, S, chunk):
        d = min_image(xt[None, :, :] - c[s0 : s0 + chunk, None, :], basis, inv_basis)
        p = d @ R[s0 : s0 + chunk].mT  # into each reference frame
        grid += splat_trilinear(
            p.reshape(-1, 3), twt.repeat(p.shape[0]), (dims, dims, dims),
            origin, voxel,
        )
    return grid


def sdf_frames(
    coords: torch.Tensor,  # (F, n, 3)
    target_w: torch.Tensor,  # (n,) dense target weights
    struct_idx: torch.Tensor,  # (S, K)
    struct_w: torch.Tensor,  # (S, K)
    ref_centered: torch.Tensor,  # (S, K, 3)
    extent: float,
    dims: int,
    basis: torch.Tensor,  # (3, 3), or (F, 3, 3) one a frame
    inv_basis: torch.Tensor,
) -> torch.Tensor:
    """SDF grid summed over a batch of frames → (dims, dims, dims).

    Counterpart of viamd_tpu.ops.sdf.sdf_frames (a vmap of its dense
    sdf_accumulate, summed): `sdf_accumulate` on each frame over the atoms
    whose target weight is not 0, the frames' grids added in frame order. A
    (3, 3) basis serves every frame."""
    idx_t = torch.nonzero(target_w).flatten()
    grid = torch.zeros((dims, dims, dims), dtype=torch.float32, device=coords.device)
    for f in range(coords.shape[0]):
        b, ib = (basis, inv_basis) if basis.ndim == 2 else (basis[f], inv_basis[f])
        grid = grid + sdf_accumulate(
            coords[f], target_w, struct_idx, struct_w, ref_centered, extent, dims, b, ib,
            idx_t,
        )
    return grid


def sdf_accumulate_cl(
    x: torch.Tensor,
    target_w: torch.Tensor,  # (n,) dense target weights
    struct_idx: torch.Tensor,  # (S, K)
    struct_w: torch.Tensor,  # (S, K)
    ref_centered: torch.Tensor,  # (S, K, 3)
    extent: float,
    dims: int,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    idx_t: torch.Tensor,  # (n_t,) target indices
    cl_dims: tuple,  # target cell grid
    cl_capacity: int,  # targets read per cell
    stencil: torch.Tensor,  # (S3, 3) int cell offsets covering the √3·extent ball
    compact_cap: "int | None" = None,  # global pre-splat compaction
    fractional: bool = False,  # bin in fractional space (triclinic cells)
) -> torch.Tensor:
    """One frame's SDF grid (dims, dims, dims) for many structures, through
    a cell list of the targets (viamd_tpu's `sdf_accumulate_cl` with
    `idx_t`).

    Coverage: a target mapping into the ±extent cube lies within √3·extent
    of the structure centre; `stencil` (make_sdf_stencil /
    make_sdf_stencil_triclinic for this frame's cell widths) covers that
    ball. Each structure reads the first `cl_capacity` targets of each of
    its S3 stencil cells — the (S, S3·cl_capacity) slots of the JAX
    package's layout — then the in-support slots are compacted to
    `compact_cap` and splatted. Orthorhombic cells bin the cartesian
    targets on the diagonal of `basis`; `fractional` bins `x · inv_basis`
    on a unit box and takes the fractional single-round min-image."""
    n_t, S = int(idx_t.shape[0]), int(struct_idx.shape[0])
    origin, voxel, voxel_w = _grid_frame(extent, dims, x.device)
    if n_t == 0 or S == 0:
        return torch.zeros((dims, dims, dims), dtype=torch.float32, device=x.device)
    xt, twt = x[idx_t], target_w[idx_t]
    if fractional:
        xt_b = frac_coords(xt, inv_basis)
        box_bins = torch.ones(3, dtype=torch.float32, device=x.device)
        Rb, cb = basis, inv_basis
    else:
        box = torch.diagonal(basis)
        xt_b, box_bins = xt, box
        Rb, cb = torch.diag(box), torch.diag(1.0 / box)
    cl = build_cell_list(xt_b, box_bins, cl_dims)
    R, c = sdf_reference_frames(x, struct_idx, struct_w, ref_centered, Rb, cb)
    c_b = frac_coords(c, inv_basis) if fractional else c
    cells = candidate_cells(cell3_of_points(c_b, box_bins, cl_dims), stencil, cl_dims)
    st = cl.cell_start[cells].to(torch.int64)  # (S, S3)
    cnt = cl.cell_start[cells + 1].to(torch.int64) - st
    slot = torch.arange(cl_capacity, dtype=torch.int64, device=x.device)
    pos = (st[..., None] + slot).reshape(S, -1)  # (S, S3·cap)
    ok = (slot < cnt[..., None]).reshape(S, -1)
    xs4 = torch.cat([xt_b, twt[:, None]], dim=1)[cl.order]  # cell order
    cd = xs4[pos.clamp_max(n_t - 1)]  # (S, C, 4): one gather
    if fractional:
        f = cd[..., :3] - c_b[:, None, :]
        d = (f - torch.round(f)) @ basis
    else:
        d = cd[..., :3] - c[:, None, :]
        d = d - box * torch.round(d / box)
    p = d @ R.mT
    w = torch.where(ok, cd[..., 3], torch.zeros_like(cd[..., 3]))
    pf, wf = _compact_support(
        p.reshape(-1, 3), w.reshape(-1), extent, voxel_w, compact_cap
    )
    return splat_trilinear(pf, wf, (dims, dims, dims), origin, voxel)


def make_sdf_stencil(extent: float, cell_w: np.ndarray) -> np.ndarray:
    """Host-side pruned cell-offset stencil covering the √3·extent ball on
    an orthorhombic grid of cell widths `cell_w`."""
    w = float(np.min(cell_w))
    D = 1.7320508 * extent
    rc = int(np.ceil(D / w)) + 1
    offs = []
    for i in range(-rc, rc + 1):
        for j in range(-rc, rc + 1):
            for k in range(-rc, rc + 1):
                md = sum(max(abs(o) - 1, 0) ** 2 for o in (i, j, k))
                if md * w * w <= D * D:
                    offs.append((i, j, k))
    return np.asarray(offs, np.int32)


def make_sdf_stencil_triclinic(
    extent: float, basis: np.ndarray, dims: tuple
) -> np.ndarray:
    """Pruned fractional-space cell-offset stencil covering the √3·extent
    ball for a triclinic cell (the lattice-plane spacings of `basis`)."""
    inv = np.linalg.inv(np.asarray(basis, np.float64))
    return make_sdf_stencil_spacing(extent, 1.0 / np.linalg.norm(inv, axis=0), dims)


def make_sdf_stencil_spacing(
    extent: float, spacing: np.ndarray, dims: tuple
) -> np.ndarray:
    """make_sdf_stencil_triclinic from the perpendicular widths `spacing`.
    Reach per fractional axis i: ceil(D / spacing_i · dims_i) + 1; pruned by
    the per-axis lower bound |cart(f)| ≥ |f_i|·spacing_i, safe for any
    skew."""
    spacing = np.asarray(spacing, np.float64)
    D = 1.7320508 * extent
    dims = np.asarray(dims, np.int64)
    rc = np.ceil(D / spacing * dims).astype(int) + 1
    offs = []
    for i in range(-rc[0], rc[0] + 1):
        for j in range(-rc[1], rc[1] + 1):
            for k in range(-rc[2], rc[2] + 1):
                dmin = max(
                    max(abs(o) - 1, 0) / dims[ax] * spacing[ax]
                    for ax, o in enumerate((i, j, k))
                )
                if dmin <= D:
                    offs.append((i, j, k))
    return np.asarray(offs, np.int32)


def sdf_cell_grid(
    widths: np.ndarray, extent: float, frac0: np.ndarray, fractional: bool
) -> tuple:
    """Host-side grid of the cell-list route (JAX compiler.py:1630-1687)
    for cells whose perpendicular widths are at least `widths` (3,):
    (cl_dims, cl_capacity, stencil (S3, 3)).

    Cells at least √3·extent across (choose_grid_r / choose_grid_triclinic
    at radius 1); a Poisson capacity with a 3.5σ tail, floored by the
    frame-0 largest cell occupancy × 1.5 + 8 so a clustered target
    selection is not dropped (`frac0`: (n_t, 3) frame-0 target positions in
    box units); the pruned stencil for cells of those widths, in fractional
    space when `fractional`. The route needs the stencil's span to fit
    min(cl_dims)."""
    widths = np.asarray(widths, np.float64)
    dims, cap = choose_grid_r(widths, 1.7320508 * extent, len(frac0), radius=1, tail=3.5)
    if fractional:
        stencil = make_sdf_stencil_spacing(extent, widths, dims)
    else:
        stencil = make_sdf_stencil(extent, widths / np.array(dims))
    if len(frac0):
        d = np.asarray(dims)
        cell3 = np.minimum(np.floor(np.mod(frac0, 1.0) * d).astype(np.int64), d - 1)
        flat = (cell3[:, 0] * dims[1] + cell3[:, 1]) * dims[2] + cell3[:, 2]
        cap = max(cap, int(1.5 * int(np.bincount(flat).max())) + 8)
    return dims, cap, stencil


def sdf_pair_capacity(
    n_structures: int,
    n_targets: int,
    box: "np.ndarray",
    extent: float,
    dims: int,
    tail: float = 5.0,
    per_struct_count: "int | None" = None,
) -> int:
    """Host-side per-structure candidate capacity for the pairs route.

    Uniform floor: expected in-ball count = bulk target density ×
    coverage-ball volume; `per_struct_count` (frame-0 measured MAX
    in-ball count over structures) floors clustered selections with
    1.5× + tail·√count drift margin. Snapped to 128 lanes.
    """
    import math

    b = np.asarray(box, np.float64)
    vol = float(np.prod(b))
    voxel_w = 2.0 * extent / dims
    sup = 1.7320508 * (extent + 0.5 * voxel_w)
    lam = (
        n_targets / max(vol, 1e-30) * (4.0 / 3.0) * math.pi * sup**3
        if vol > 0
        else float(n_targets)
    )
    cap = int(math.ceil(lam + tail * math.sqrt(max(lam, 1.0)) + 8.0))
    if per_struct_count is not None:
        cnt = int(per_struct_count)
        cap = max(
            cap,
            int(math.ceil(1.5 * cnt + tail * math.sqrt(max(cnt, 1.0)))),
        )
    cap = min(cap, max(int(n_targets), 1))
    return -(-cap // 128) * 128


def sdf_frame0_ball_count(
    target_xyz: "np.ndarray",  # (n_t, 3) frame-0 target coords
    x0: "np.ndarray",
    struct_idx: "np.ndarray",
    struct_w: "np.ndarray",
    box: "np.ndarray",
    extent: float,
    dims: int,
    basis: "np.ndarray | None" = None,
) -> int:
    """Frame-0 measured MAX per-structure in-coverage-ball target count
    (host NumPy, chunked over structures) — sizes sdf_pair_capacity for
    clustered target selections. `basis` switches the min-image to the
    triclinic fractional round."""
    w = np.asarray(struct_w, np.float64)
    idx = np.asarray(struct_idx)
    xs = np.asarray(x0, np.float64)[idx]  # (S, K, 3)
    com = (xs * w[..., None]).sum(1) / np.maximum(
        w.sum(1, keepdims=True), 1e-30
    )
    voxel_w = 2.0 * extent / dims
    sup = 1.7320508 * (extent + 0.5 * voxel_w) + 1e-4
    t = np.asarray(target_xyz, np.float64)
    mimg = _host_min_image(box, basis)
    best = 0
    for s0 in range(0, com.shape[0], 8):
        d = mimg(t[None, :, :] - com[s0 : s0 + 8, None, :])
        cnt = (np.sum(d * d, axis=-1) < sup * sup).sum(axis=1)
        best = max(best, int(cnt.max()) if cnt.size else 0)
    return best


def _host_min_image(box, basis):
    """float64 host min-image of the sizers: the fractional single round
    with a `basis`, else per axis on an orthorhombic `box` (identity when
    any extent is 0)."""
    if basis is not None:
        B = np.asarray(basis, np.float64)
        inv = np.linalg.inv(B)

        def mimg(d):
            f = d @ inv
            return (f - np.round(f)) @ B

        return mimg
    b = np.asarray(box, np.float64)
    if np.all(b > 0):
        return lambda d: d - b * np.round(d / b)
    return lambda d: d


def sdf_compact_capacity(
    n_structures: int,
    n_targets: int,
    box: "np.ndarray",
    extent: float,
    dims: int,
    tail: float = 5.0,
    support_count: "int | None" = None,
) -> int:
    """Host-side sizing of the pre-splat compaction capacity.

    Uniform floor: expected in-support count = S · bulk target density ·
    support-cube volume; one GLOBAL cap (unlike the per-cell caps) so
    relative fluctuation is tiny — a 5σ tail puts the whole-frame
    overflow probability ~3e-7 while still cutting the headline slot
    count ~25×.

    The bulk-density assumption UNDERESTIMATES clustered targets (e.g.
    `sdf(ref, within(6, ref), 6)` concentrates every target near the
    structures), so when `support_count` — the frame-0 MEASURED
    in-support point count from sdf_frame0_support_count — is given,
    the capacity is also floored by 1.5× it + tail·√count margin for
    frame-to-frame variation. Snapped up to 512; the kernel disables
    compaction entirely when the cap reaches the slot count, so a
    pathological estimate degrades to the exact uncompacted path.
    """
    import math

    b = np.asarray(box, np.float64)
    vol = float(np.prod(b))
    side = 2.0 * extent + 2.0 * extent / dims  # cube + tent support
    lam = n_structures * n_targets / max(vol, 1e-30) * side**3
    cap = int(math.ceil(lam + tail * math.sqrt(max(lam, 1.0))))
    if support_count is not None:
        cnt = int(support_count)
        data_cap = int(
            math.ceil(1.5 * cnt + tail * math.sqrt(max(cnt, 1.0)))
        )
        cap = max(cap, data_cap)
    return -(-cap // 512) * 512


def sdf_frame0_support_count(
    target_xyz: "np.ndarray",  # (n_t, 3) frame-0 target coords
    x0: "np.ndarray",  # (n, 3) frame-0 coords
    struct_idx: "np.ndarray",  # (S, K)
    struct_w: "np.ndarray",  # (S, K)
    ref_centered: "np.ndarray",  # (S, K, 3)
    box: "np.ndarray",
    extent: float,
    dims: int,
    basis: "np.ndarray | None" = None,
) -> int:
    """Exact frame-0 count of (structure, target) pairs inside the
    ±(extent + ½·voxel) support cube — host-side NumPy Kabsch, used to
    size the compaction capacity for clustered target selections. `basis`
    switches the min-image to the triclinic fractional round.

    The rotation-convention ambiguity is resolved defensively: both
    R and Rᵀ orientations are counted and the larger taken (a capacity
    bound only needs to be ≥ the true count).
    """
    _mimg = _host_min_image(box, basis)
    t = np.asarray(target_xyz, np.float64)
    if not len(t):
        return 0
    sup = extent + extent / dims
    total = 0
    for s in range(struct_idx.shape[0]):
        ix = np.asarray(struct_idx[s])
        ws = np.asarray(struct_w[s], np.float64)
        P = np.asarray(x0, np.float64)[ix]
        # deperiodize about the first atom, then weighted center
        P = P[0] + _mimg(P - P[0])
        c = (P * ws[:, None]).sum(0) / max(ws.sum(), 1e-30)
        Pc = (P - c) * (ws[:, None] > 0)
        ref = np.asarray(ref_centered[s], np.float64)
        H = (Pc * ws[:, None]).T @ ref
        U, _, Vt = np.linalg.svd(H)
        Rm = (U @ Vt).T
        if np.linalg.det(Rm) < 0:
            U[:, -1] *= -1
            Rm = (U @ Vt).T
        d = _mimg(t - c)
        total += max(
            int(np.sum(np.max(np.abs(d @ R_.T), axis=1) < sup))
            for R_ in (Rm, Rm.T)
        )
    return total


def make_structure_inputs(
    indices_per_structure: list,
    masses: "np.ndarray | None",
    ref_coords: "np.ndarray",  # (n, 3) topology/frame-0 coords
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side packing: list of index arrays → padded (S,K) inputs.

    Returns (struct_idx, struct_w, ref_centered) with K = max structure size.
    Padding entries reuse index 0 with weight 0 (gather-safe).
    """
    S = len(indices_per_structure)
    K = max(len(ix) for ix in indices_per_structure)
    idx = np.zeros((S, K), np.int32)
    w = np.zeros((S, K), np.float32)
    for s, ix in enumerate(indices_per_structure):
        idx[s, : len(ix)] = ix
        if masses is not None:
            w[s, : len(ix)] = np.asarray(masses)[ix]
        else:
            w[s, : len(ix)] = 1.0
    ref = np.asarray(ref_coords, np.float32)[idx]  # (S,K,3)
    wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
    centers = (ref * w[..., None]).sum(axis=1, keepdims=True) / wsum[..., None]
    ref_centered = (ref - centers) * (w[..., None] > 0)
    return idx, w, ref_centered
