"""Cell-list pair-distance histogram: the CUDA kernel's wrapper and its
plain PyTorch versions.

Counterpart of viamd_tpu/ops/pallas_rdf.py (`pair_dist_histogram_pl`, whose
Pallas kernel `_hist_kernel` is replaced by csrc/pair_hist.cu).

`pair_dist_histogram_cl` is the cell-list route the compiler takes for
large periodic systems: cartesian cells on an orthorhombic box, fractional
cells (and the kernel's general 3x3 min-image) on a triclinic one; cells
at least r_max wide and a stencil of ±1 cell, or, in a box under 3 cutoffs
across, at least r_max/2 wide and ±2 cells (`radius`, as the TPU kernel's).
On a CUDA tensor it builds the CSR cell lists (`cell_lists`,
ops/neighbors.py) and launches the kernel, through the half stencil when
one index tensor serves both sides; on a CPU tensor it computes the same
histogram with the all-pairs plain version, `pair_dist_histogram_scatter_idx`
(ops/rdf.py, imported here), which stays the specification. Any other
device raises. `pair_hist_cells_plain` walks exactly the kernel's pairs on
the kernel's inputs, to count its work and to test the walk on the CPU. The
kernel counts every pair (no capacity drops), so it is held exactly to both.

Both walks take a window of A cell rows (`rows=(lo, hi)` over the leading
cell axis; B stays whole): `pair_dist_histogram_cl_sharded`, the
counterpart of the TPU kernel's slab-sharded mode
(`pair_dist_histogram_pl_sharded`), gives each rank of a mesh axis its
even share of the rows and sums the int32 partials over the axis.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from viamd_tpu_torch.cuda_build import Library, check_tensor as _check
from viamd_tpu_torch.ops.neighbors import build_cell_list, frac_coords
from viamd_tpu_torch.ops.rdf import (
    min_image_sq,
    pair_dist_histogram_scatter_idx,
    sqrt_rn,
    stencil_offsets,
)

__all__ = [
    "cell_lists",
    "launches",
    "pair_dist_histogram_cl",
    "pair_dist_histogram_cl_sharded",
    "pair_dist_histogram_scatter_idx",
    "slab_rows",
    "pair_hist_cells",
    "pair_hist_cells_plain",
    "sqrt_reject_bound",
]

# kernel launches since import (reset freely by callers that count a run)
launches = 0

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
LIBRARY = Library("pair_hist", ("pair_hist.cu",), {
    "pair_hist_launch": (_i, [_p] * 8 + [_i] * 4 + [_f] * 3 + [_i] * 4 + [_p, _p]),
    "pair_hist_max_bins": (_i, []),
})


def sqrt_reject_bound(r_max: float) -> float:
    """The kernel's s_hi: the largest float32 s whose correctly rounded sqrt
    is below float32(r_max), so every float32 s > s_hi has sqrtf(s) >= r_max.

    In float64: with p the float32 just below r = float32(r_max), sqrt(s)
    rounds below r exactly when s < m², m = (p + r) / 2. m has 25
    significant bits and m² at most 50, so both are exact, and no float32
    equals m²."""
    r = np.float32(r_max)
    p = np.nextafter(r, np.float32(0.0))
    m2 = ((np.float64(p) + np.float64(r)) * 0.5) ** 2
    s = np.float32(m2)
    if np.float64(s) >= m2:
        s = np.nextafter(s, np.float32(0.0))
    return float(s)


def _check_symmetric(xa, ida, a_start, xb, idb, b_start, symmetric):
    if symmetric and not (xb is xa and idb is ida and b_start is a_start):
        raise ValueError("symmetric=True walks one cell list for both sides: "
                         "pass the same xa, ida, a_start as xb, idb, b_start")


def _check_radius(radius, dims):
    if radius not in (1, 2):
        raise ValueError(f"radius must be 1 or 2, got {radius}")
    if min(dims) < 2 * radius + 1:
        raise ValueError(f"a radius-{radius} stencil needs min(dims) >= "
                         f"{2 * radius + 1}, got {dims}")


def _window(rows, dims) -> tuple[int, int]:
    """The A rows [lo, hi) of the leading cell axis; the whole grid when
    `rows` is None."""
    lo, hi = (0, dims[0]) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo <= hi <= dims[0]:
        raise ValueError(f"rows {rows} outside [0, {dims[0]}]")
    return lo, hi


def slab_rows(k: int, n: int, dx: int) -> tuple[int, int]:
    """Rank k's rows of n over a leading cell axis of dx rows: the even
    split [k·dx // n, (k+1)·dx // n)."""
    return k * dx // n, (k + 1) * dx // n


def pair_hist_cells(
    xa: torch.Tensor,  # (na, 3) f32, A atoms in cell order
    ida: torch.Tensor,  # (na,) int32 global ids
    a_start: torch.Tensor,  # (ncells+1,) int32 CSR offsets
    xb: torch.Tensor,
    idb: torch.Tensor,
    b_start: torch.Tensor,
    basis: torch.Tensor,  # (3, 3) f32
    inv_basis: torch.Tensor,  # (3, 3) f32
    dims: tuple,
    nbins: int,
    r_max: float,
    symmetric: bool = False,  # B is A's own cell list: the half stencil
    radius: int = 1,  # stencil reach in cells: 1 or 2
    rows: tuple | None = None,  # A cell rows [lo, hi) of dims[0]; all by default
) -> torch.Tensor:
    """Launch csrc/pair_hist.cu on CSR cell lists → (nbins,) f32 counts."""
    return _pair_hist_counts(xa, ida, a_start, xb, idb, b_start, basis, inv_basis,
                             dims, nbins, r_max, symmetric, radius, rows).to(torch.float32)


def _pair_hist_counts(xa, ida, a_start, xb, idb, b_start, basis, inv_basis, dims,
                      nbins, r_max, symmetric, radius, rows) -> torch.Tensor:
    """`pair_hist_cells` → the kernel's (nbins,) int32 counts. An empty
    window launches nothing."""
    global launches
    _check_symmetric(xa, ida, a_start, xb, idb, b_start, symmetric)
    dev = xa.device
    if dev.type != "cuda":
        raise ValueError(f"pair_hist_cells needs CUDA tensors, got {dev}")
    _check_radius(radius, dims)
    lo, hi = _window(rows, dims)
    lib = LIBRARY.load()
    if not 0 < nbins <= lib.pair_hist_max_bins():
        raise ValueError(f"nbins {nbins} outside (0, {lib.pair_hist_max_bins()}]")
    ncells = dims[0] * dims[1] * dims[2]
    na, nb = xa.shape[0], xb.shape[0]
    _check(xa, "xa", torch.float32, (na, 3), dev)
    _check(ida, "ida", torch.int32, (na,), dev)
    _check(a_start, "a_start", torch.int32, (ncells + 1,), dev)
    _check(xb, "xb", torch.float32, (nb, 3), dev)
    _check(idb, "idb", torch.int32, (nb,), dev)
    _check(b_start, "b_start", torch.int32, (ncells + 1,), dev)
    _check(basis, "basis", torch.float32, (3, 3), dev)
    _check(inv_basis, "inv_basis", torch.float32, (3, 3), dev)
    hist = torch.zeros(nbins, dtype=torch.int32, device=dev)
    if lo == hi:
        return hist
    inv_bin = float(torch.tensor(nbins / r_max, dtype=torch.float32))
    err = lib.pair_hist_launch(
        xa.data_ptr(), ida.data_ptr(), a_start.data_ptr(),
        xb.data_ptr(), idb.data_ptr(), b_start.data_ptr(),
        basis.data_ptr(), inv_basis.data_ptr(),
        dims[0], dims[1], dims[2], nbins, r_max, inv_bin,
        sqrt_reject_bound(r_max), int(symmetric), radius, lo, hi,
        hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pair_hist kernel launch failed: CUDA error {err}")
    launches += 1
    return hist


def pair_hist_cells_plain(
    xa: torch.Tensor,
    ida: torch.Tensor,
    a_start: torch.Tensor,
    xb: torch.Tensor,
    idb: torch.Tensor,
    b_start: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    dims: tuple,
    nbins: int,
    r_max: float,
    symmetric: bool = False,
    radius: int = 1,
    work: dict | None = None,
    rows: tuple | None = None,
) -> torch.Tensor:
    """`pair_hist_cells` in plain PyTorch: the kernel's walk, pair for pair,
    on any device → (nbins,) f32 counts.

    Each A atom against the cells of the stencil of `radius` around its
    cell: with `symmetric`, the self cell's atoms after it in CSR order and
    the upper offsets, each unordered pair counted twice; else every cell,
    pairs of equal ids skipped. Distances as `min_image_dist` computes them,
    the sqrt only where |o|² <= sqrt_reject_bound(r_max). `rows=(lo, hi)`
    walks only the A atoms of the cell rows [lo, hi) of dims[0]. `work`,
    when given, receives the walk's counts: "pairs" (candidates walked) and
    "sqrt" (candidates past the reject)."""
    return _walk_counts(xa, ida, a_start, xb, idb, b_start, basis, inv_basis, dims,
                        nbins, r_max, symmetric, radius, rows, work).to(torch.float32)


def _walk_counts(xa, ida, a_start, xb, idb, b_start, basis, inv_basis, dims,
                 nbins, r_max, symmetric, radius, rows, work=None) -> torch.Tensor:
    """`pair_hist_cells_plain` → (nbins,) int64 counts."""
    _check_symmetric(xa, ida, a_start, xb, idb, b_start, symmetric)
    _check_radius(radius, dims)
    lo, hi = _window(rows, dims)
    dev = xa.device
    yz = dims[1] * dims[2]
    a_st, b_st = a_start.long(), b_start.long()
    if rows is None:  # no wait on the device for the whole grid
        a0, na = 0, xa.shape[0]
    else:
        a0 = int(a_st[lo * yz])
        na = int(a_st[hi * yz]) - a0
    atoms = torch.arange(a0, a0 + na, device=dev)  # the window's A atoms
    cell = torch.repeat_interleave(
        torch.arange(lo * yz, hi * yz, device=dev),
        a_st[lo * yz + 1 : hi * yz + 1] - a_st[lo * yz : hi * yz], output_size=na,
    )
    rank = atoms - a_st[cell]  # index in its cell
    c3 = (cell // yz, (cell // dims[2]) % dims[1], cell % dims[2])
    s_hi = sqrt_reject_bound(r_max)
    inv_bin = float(torch.tensor(nbins / r_max, dtype=torch.float32))
    counts = torch.zeros(nbins, dtype=torch.int64, device=dev)
    pairs = sqrts = 0
    for o in stencil_offsets(radius, symmetric):
        nx, ny, nz = ((c3[k] + o[k]) % dims[k] for k in range(3))
        nc = (nx * dims[1] + ny) * dims[2] + nz
        b_lo, n = b_st[nc], b_st[nc + 1] - b_st[nc]
        if symmetric and o == (0, 0, 0):
            b_lo, n = b_lo + rank + 1, n - rank - 1
        total = int(n.sum())
        pairs += total
        pl = torch.repeat_interleave(torch.arange(na, device=dev), n, output_size=total)
        pj = b_lo[pl] + torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[pl]
        pi = atoms[pl]
        if not symmetric:
            distinct = ida[pi] != idb[pj]
            pi, pj = pi[distinct], pj[distinct]
        s = min_image_sq([xa[pi, k] - xb[pj, k] for k in range(3)], basis, inv_basis)
        s = s[s <= s_hi]
        sqrts += s.shape[0]
        dist = sqrt_rn(s)
        bins = (dist * inv_bin).to(torch.int64)
        bins = bins[(dist < r_max) & (bins < nbins)]
        counts.index_add_(0, bins, torch.ones_like(bins))
    if work is not None:
        work.update(pairs=pairs, sqrt=sqrts)
    return counts * 2 if symmetric else counts


def cell_lists(
    x: torch.Tensor,  # (n, 3) frame coordinates
    idx: torch.Tensor,  # (m,) int32 global indices
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    dims: tuple,
    fractional: bool = False,
) -> tuple:
    """The CSR cell list of atoms `idx`, as `pair_dist_histogram_cl` builds
    it for the kernel: (positions (m, 3), ids (m,), cell_start (ncells+1,))
    in cell order. Cartesian cells on the diagonal of `basis`, or, with
    `fractional`, cells of `x · inv_basis` on a unit box."""
    xs = x[idx]
    if fractional:
        cl = build_cell_list(frac_coords(xs, inv_basis), torch.ones(3, device=x.device), dims)
    else:
        cl = build_cell_list(xs, torch.diagonal(basis), dims)
    return xs[cl.order].contiguous(), idx[cl.order].contiguous(), cl.cell_start


def pair_dist_histogram_cl(
    x: torch.Tensor,  # (n, 3) f32 frame coordinates
    idx_a: torch.Tensor,  # (na,) int32 global indices of the A selection
    idx_b: torch.Tensor,  # (nb,) int32 global indices of the B selection
    basis: torch.Tensor,  # (3, 3) basis: diagonal unless `fractional`
    inv_basis: torch.Tensor,
    nbins: int,
    r_max: float,
    dims: tuple,  # cell grid: cells >= r_max / radius wide
    fractional: bool = False,  # bin in fractional space (triclinic cells)
    radius: int = 1,  # stencil reach in cells, min(dims) >= 2·radius + 1
) -> torch.Tensor:
    """A→B min-image pair-distance histogram (nbins,) f32 through a cell
    list: the kernel on CUDA, the plain version on the CPU.

    Orthorhombic cells are binned in cartesian space on the diagonal of
    `basis`; with `fractional`, any cell is binned on the fractional
    coordinates `x · inv_basis` and the kernel takes its general 3x3
    min-image. `dims` must keep every cell at least r_max / radius across,
    in this frame's basis (the perpendicular widths / dims >= r_max /
    radius): the kernel walks ±radius cells.

    Each index tensor must hold distinct ids (the compiler passes a mask's
    `indices()`). When `idx_b is idx_a` the kernel skips the pairs of an
    atom with itself by position in its cell, where the specification skips
    equal ids: with a repeated id the two would differ."""
    _check_radius(radius, dims)
    if x.device.type == "cpu":
        ones_a = torch.ones(idx_a.shape[0], dtype=torch.float32)
        ones_b = torch.ones(idx_b.shape[0], dtype=torch.float32)
        return pair_dist_histogram_scatter_idx(
            x, idx_a, idx_b, ones_a, ones_b, basis, inv_basis, nbins, r_max
        )
    if x.device.type != "cuda":
        raise ValueError(f"no pair histogram route for device {x.device}")
    return _cl_counts(x, idx_a, idx_b, basis, inv_basis, nbins, r_max, dims,
                      fractional, radius, None).to(torch.float32)


def _cl_counts(x, idx_a, idx_b, basis, inv_basis, nbins, r_max, dims, fractional,
               radius, rows) -> torch.Tensor:
    """The cell lists of A and B, walked over A's cell rows `rows` (all for
    None) → (nbins,) int32 counts: the kernel on CUDA, its plain walk on the
    CPU."""
    if idx_a.shape[0] == 0 or idx_b.shape[0] == 0:
        return torch.zeros(nbins, dtype=torch.int32, device=x.device)
    basis, inv_basis = basis.contiguous(), inv_basis.contiguous()
    a = cell_lists(x, idx_a, basis, inv_basis, dims, fractional)
    # one cell list and the half stencil serve both sides when the caller
    # passes one index tensor for both (comparing contents here would wait
    # on the device)
    symmetric = idx_b is idx_a
    b = a if symmetric else cell_lists(x, idx_b, basis, inv_basis, dims, fractional)
    walk = _pair_hist_counts if x.device.type == "cuda" else _walk_counts
    return walk(*a, *b, basis, inv_basis, dims, nbins, r_max, symmetric, radius,
                rows).to(torch.int32)


def pair_dist_histogram_cl_sharded(
    x: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    nbins: int,
    r_max: float,
    dims: tuple,
    mesh,  # parallel.mesh.Mesh holding `axis`
    axis: str = "atoms",
    fractional: bool = False,
    radius: int = 1,
) -> torch.Tensor:
    """`pair_dist_histogram_cl` with its A cell rows split over the ranks of
    the mesh axis `axis` → (nbins,) f32, the same on every rank of it.

    The counterpart of viamd_tpu/ops/pallas_rdf.py::
    pair_dist_histogram_pl_sharded. Every rank builds the whole (replicated)
    cell lists, walks the A atoms of its rows, `slab_rows(k, n, dims[0])`,
    against all of B — the kernel on CUDA, `pair_hist_cells_plain` on the
    CPU — and the int32 partials are summed over the axis before they turn
    into float32, so the result equals the whole grid's bit for bit. The
    JAX package's window rule (w = max(⌈dx/n⌉, 2r+1) rows a device) served
    the TPU's rolled B-plane windows; the even split keeps every rank busy
    at 5 rows over 4 ranks. Every rank of the axis must call this together:
    the sum is a collective, and on a gloo group it makes the host wait."""
    _check_radius(radius, dims)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair histogram route for device {x.device}")
    rows = slab_rows(mesh.axis_index(axis), mesh.shape[axis], dims[0])
    counts = _cl_counts(x, idx_a, idx_b, basis, inv_basis, nbins, r_max, dims,
                        fractional, radius, rows)
    return mesh.all_reduce(counts, axis).to(torch.float32)
