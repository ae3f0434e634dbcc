"""Cell lists for cutoff-limited pair kernels, on torch tensors.

Counterpart of viamd_tpu.ops.neighbors. The host-side grid sizers
(`choose_grid`, `choose_grid_r`, `choose_grid_triclinic`) are numpy copies;
`perpendicular_widths` gives the per-frame widths every grid is sized from.
`build_cell_list` is a CSR cell list: atoms sorted stably by cell id (atom
index breaks ties) plus `cell_start (ncells+1,)`. The JAX package instead
builds a fixed-capacity (ncells, K) slot table, because a TPU kernel reads
cells as dense tiles; a GPU kernel reads a cell's atoms by offset, so
nothing is padded and nothing is dropped.

Triclinic cells are binned in fractional space: the cell list of
`frac_coords(x, inv_basis)` on a unit box (`box = ones`), as the JAX
package's `sdf_accumulate_cl` and triclinic RDF do.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def device_ints(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 tensor of `values` (nested tuples of ints) on `device`, made
    once: a tensor made from host data on each frame is a copy from
    pageable memory, which waits for the device's queue to drain. Callers
    must not write to it."""
    return torch.tensor(values, dtype=torch.int64, device=device)


@dataclass(frozen=True)
class CellList:
    order: torch.Tensor  # (n,) int64 atom indices sorted by cell (stable)
    cell_start: torch.Tensor  # (ncells+1,) int32 offsets into `order`
    dims: tuple


def choose_grid(box: np.ndarray, cutoff: float, n_atoms: int) -> tuple:
    """Host-side sizing: (dims (3,), capacity). Cell width ≥ cutoff/2."""
    box = np.asarray(box, np.float64)
    target = max(cutoff / 2.0, 1e-3)
    dims = np.maximum(np.floor(box / target).astype(int), 1)
    dims = np.minimum(dims, 128)  # cap table size
    ncells = int(dims.prod())
    mean = n_atoms / ncells
    capacity = int(np.ceil(max(mean * 3.0, 4.0)))
    return tuple(int(d) for d in dims), capacity


def choose_grid_r(
    box: np.ndarray, cutoff: float, n_atoms: int, radius: int = 1,
    tail: float = 4.5,
) -> tuple:
    """Host-side sizing with Poisson-tail capacity: (dims, capacity).

    Cell width ≥ cutoff/radius (radius = stencil reach in cells). Capacity
    λ + 4.5√λ + 2 covers the Poisson occupancy tail to ~+4.5σ — at high
    per-cell occupancy (radius=1 → λ ≈ 30+ at liquid density) this is far
    tighter than the 3λ rule and roughly doubles pair-slot fill in the
    cell-pair kernels, while keeping the overflow-drop probability at the
    same (negligible) level as the 3λ rule had at λ ≈ 4.
    """
    box = np.asarray(box, np.float64)
    target = max(cutoff / max(radius, 1), 1e-3)
    dims = np.maximum(np.floor(box / target).astype(int), 1)
    dims = np.minimum(dims, 128)
    ncells = int(dims.prod())
    lam = n_atoms / ncells
    capacity = int(np.ceil(lam + tail * np.sqrt(lam) + 2.0))
    return tuple(int(d) for d in dims), capacity


def choose_grid_triclinic(
    basis: np.ndarray, cutoff: float, n_atoms: int, radius: int = 1,
    tail: float = 4.5,
) -> tuple:
    """Host-side sizing for a TRICLINIC cell grid: (dims, capacity).

    Cells are uniform in FRACTIONAL space; the stencil-coverage
    condition uses the lattice-plane spacings: two points within
    `cutoff` differ in fractional axis i by at most cutoff·|inv[:, i]|,
    so radius-r coverage needs dims_i ≤ r·spacing_i/cutoff with
    spacing_i = 1/|inv[:, i]| (the perpendicular width of the cell
    along axis i). Same Poisson-tail capacity as choose_grid_r.
    """
    b = np.asarray(basis, np.float64)
    inv = np.linalg.inv(b)
    spacing = 1.0 / np.linalg.norm(inv, axis=0)  # (3,)
    dims = np.maximum(
        np.floor(radius * spacing / max(cutoff, 1e-6)).astype(int), 1
    )
    dims = np.minimum(dims, 128)
    ncells = int(dims.prod())
    lam = n_atoms / ncells
    capacity = int(np.ceil(lam + tail * np.sqrt(lam) + 2.0))
    return tuple(int(d) for d in dims), capacity


def perpendicular_widths(cells: np.ndarray) -> np.ndarray:
    """(F, 3) float64 perpendicular widths of (F, 3, 3) row-vector cell
    bases: the diagonal of an orthorhombic basis, 1/|inv[:, i]| (the
    distance between the lattice planes of axis i) of a triclinic one, 0
    for an aperiodic (zero) one. A grid of dims_i ≤ width_i / reach cells
    keeps every cell at least `reach` wide across axis i."""
    b = np.asarray(cells, np.float64).reshape(-1, 3, 3)
    out = np.zeros((b.shape[0], 3))
    ortho = diagonal_cells(b)
    out[ortho] = np.einsum("fii->fi", b)[ortho]
    tri = ~ortho & (np.abs(np.linalg.det(b)) > 1e-12)
    if tri.any():
        inv = np.linalg.inv(b[tri])
        out[tri] = 1.0 / np.linalg.norm(inv, axis=1)
    return out


def diagonal_cells(cells: np.ndarray) -> np.ndarray:
    """(F,) True where a (F, 3, 3) cell basis has no off-diagonal entry."""
    b = np.asarray(cells).reshape(-1, 3, 3)
    return ~(b * (1 - np.eye(3))).any(axis=(1, 2))


def frac_coords(x: torch.Tensor, inv_basis: torch.Tensor) -> torch.Tensor:
    """(n, 3) fractional coordinates x · inv_basis, written out per
    component (the same float operations on every device)."""
    return torch.stack([
        x[:, 0] * inv_basis[0, k] + x[:, 1] * inv_basis[1, k]
        + x[:, 2] * inv_basis[2, k]
        for k in range(3)
    ], dim=1)


def cell3_of_points(pts: torch.Tensor, box: torch.Tensor, dims: tuple) -> torch.Tensor:
    """(Q, 3) int64 cell coordinates of query points (viamd_tpu's
    `cell3_of_points`): wrapped into [0, 1) of `box`, clamped to the grid."""
    dims_t = device_ints(tuple(dims), pts.device)
    frac = pts / box
    frac = frac - torch.floor(frac)
    c3 = (frac * dims_t.to(pts.dtype)).to(torch.int64)
    return torch.minimum(c3.clamp_min(0), dims_t - 1)


def candidate_cells(cell3: torch.Tensor, offsets: torch.Tensor, dims: tuple) -> torch.Tensor:
    """(Q, S3) flat ids of the cells at `offsets` (S3, 3) around each query
    cell `cell3` (Q, 3), wrapped periodically (viamd_tpu's
    `candidate_cells`, with the stencil passed in)."""
    dims_t = device_ints(tuple(dims), cell3.device)
    c = torch.remainder(cell3[:, None, :] + offsets[None, :, :].to(torch.int64), dims_t)
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]


def cell_ids(x: torch.Tensor, box: torch.Tensor, dims: tuple) -> torch.Tensor:
    """(n,) int64 cell id of each atom on an orthorhombic grid.

    Coordinates are wrapped into [0, box) first (jittered trajectories push
    atoms out of the box, as viamd_tpu/ops/pallas_rdf.py:517-520 handles),
    then binned with the same float ops as the JAX package's
    build_cell_list, so both packages put every atom in the same cell."""
    dims_t = device_ints(tuple(dims), x.device)
    xw = x - box * torch.floor(x / box)
    frac = xw / box
    frac = frac - torch.floor(frac)
    c3 = (frac * dims_t.to(x.dtype)).to(torch.int64)
    c3 = torch.minimum(c3.clamp_min(0), dims_t - 1)
    return (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]


def build_cell_list(x: torch.Tensor, box: torch.Tensor, dims: tuple) -> CellList:
    """CSR cell list of one frame's atoms on an orthorhombic `dims` grid
    (`x` fractional and `box` ones: a triclinic grid).

    `cell_start` comes from a scatter-add count + cumsum: `torch.bincount`
    would size its output from the data, which makes the host wait for the
    device on every frame."""
    ncells = int(np.prod(dims))
    cid = cell_ids(x, box, dims)
    order = torch.sort(cid, stable=True).indices
    counts = torch.zeros(ncells, dtype=torch.int32, device=x.device)
    counts.index_add_(0, cid, torch.ones_like(cid, dtype=torch.int32))
    cell_start = torch.zeros(ncells + 1, dtype=torch.int32, device=x.device)
    cell_start[1:] = torch.cumsum(counts, 0)
    return CellList(order=order, cell_start=cell_start, dims=tuple(dims))
