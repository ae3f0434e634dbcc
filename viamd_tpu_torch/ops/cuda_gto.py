"""GTO grids: the CUDA kernel's wrapper (csrc/gto.cu) and the plain mirror
of its screen.

Counterpart of the XLA fusion of viamd_tpu/ops/gto.py::eval_gto inside the
`lax.scan`s of eval_gto_grid, density_grid and transition_density_grid
(not a Pallas kernel). ops/gto.py routes a CUDA device here and a CPU
device to its plain version, `primitive_matrix` over `grid_points` (and
`_contract` for ψ). Two launches:

    psi_grid   ψ = Σ_k φ_k·c_k of one coefficient column over a whole
               (nx, ny, nz) grid, one launch, no Φ in device memory;
    phi_rows   rows c0 … c0 + n − 1 of the (P, K) primitive matrix Φ, the
               voxels in z-fastest order, for Φ @ C (torch.matmul).

The primitive table is `prim_table`: (K, 8) float32, per primitive the
centre, α, the ψ coefficient (0 for Φ) and the powers packed as
l | m << 4 | n << 8 in the bits of a float. The grid is `grid_block`: 15
float32 values, origin (3, grid frame), voxel (3), orientation (3x3,
row-major, world = R @ p; the identity when axis-aligned).

Both launches skip, per block, the primitives that add exactly 0 at every
voxel of the block (the note in csrc/gto.cu). `screen_keep` is that
screen in plain PyTorch, on the voxel groups `brick_voxels` (a ψ block's
4×8×8 brick) or `row_tiles` (a Φ block's 32 rows) give; the tests hold it
to the plain arithmetic, and chip_smoke.py counts the kernel's kept pairs
with it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from viamd_tpu_torch.cuda_build import build_info, check_tensor as _check, load_library

__all__ = [
    "BRICK",
    "CUTOFF",
    "LIBRARY",
    "ROWS",
    "brick_voxels",
    "grid_block",
    "launches",
    "load_kernel",
    "phi_rows",
    "prim_table",
    "psi_grid",
    "row_tiles",
    "screen_keep",
]

BRICK = (4, 8, 8)  # a ψ block's voxels in x, y, z (z fastest): one a thread
ROWS = 32  # a Φ block's rows
CUTOFF = 40.0  # α·r² at and above which a primitive adds 0

# kernel launches since import (reset freely by callers that count a run)
launches = 0

# (library name, sources in csrc/) for cuda_build
LIBRARY = ("gto", ("gto.cu",))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library(*LIBRARY)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gto_psi_launch.argtypes = [vp, ci, vp, ci, ci, ci, ci, vp, vp]
        lib.gto_psi_launch.restype = ci
        lib.gto_phi_launch.argtypes = [vp, ci, vp, ci, ci, ci, ci, ctypes.c_longlong, ci,
                                       vp, vp]
        lib.gto_phi_launch.restype = ci
        _lib = lib
    return _lib


def load_kernel() -> float:
    """Build (first call) and load the kernel library; returns the build
    seconds, 0 when an earlier build was reused."""
    _library()
    return build_info[LIBRARY[0]]["seconds"]


def prim_table(centers: torch.Tensor, exponents: torch.Tensor, lmn: torch.Tensor,
               coeffs: torch.Tensor | None = None) -> torch.Tensor:
    """(K, 8) float32 kernel table on the tensors' device: cx cy cz α |
    coefficient, lmn bits, 0, 0."""
    K = exponents.shape[0]
    c = torch.zeros_like(exponents) if coeffs is None else coeffs
    vals = torch.cat([centers, exponents[:, None], c[:, None]], 1).contiguous()
    tab = torch.zeros((K, 8), dtype=torch.int32, device=exponents.device)
    tab[:, :5] = vals.view(torch.int32)  # bits moved, never rounded
    tab[:, 5] = lmn[:, 0] | (lmn[:, 1] << 4) | (lmn[:, 2] << 8)
    return tab.view(torch.float32)


def grid_block(origin, voxel, orientation) -> tuple[ctypes.Array, int]:
    """(the kernel's 15 float32 grid values, 1 when oriented) from arrays
    or tensors, rounded to float32 as ops/gto.py::grid_points rounds them."""
    r = np.eye(3, dtype=np.float32) if orientation is None else orientation
    vals = np.concatenate([np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32)
                           .reshape(-1) for a in (origin, voxel, r)])
    return (ctypes.c_float * 15)(*vals.tolist()), int(orientation is not None)


def _finish(err: int) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"gto kernel launch failed: CUDA error {err}")
    launches += 1


def psi_grid(table: torch.Tensor, grid: tuple, dims) -> torch.Tensor:
    """One launch of the ψ kernel → (nx, ny, nz) float32 on the table's
    CUDA device."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the gto kernel runs on CUDA tensors, not {dev}")
    K = table.shape[0]
    _check(table, "table", torch.float32, (K, 8), dev)
    nx, ny, nz = (int(d) for d in dims)
    lib = _library()
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    gp, oriented = grid
    err = lib.gto_psi_launch(table.data_ptr(), K, ctypes.cast(gp, ctypes.c_void_p), oriented,
                             nx, ny, nz, out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    _finish(err)
    return out


def phi_rows(table: torch.Tensor, grid: tuple, dims, c0: int, n: int) -> torch.Tensor:
    """One launch of the Φ kernel → (n, K) float32: Φ of voxels c0 … c0 +
    n − 1 (z fastest) on the table's CUDA device."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the gto kernel runs on CUDA tensors, not {dev}")
    K = table.shape[0]
    _check(table, "table", torch.float32, (K, 8), dev)
    nx, ny, nz = (int(d) for d in dims)
    if not 0 <= c0 <= c0 + n <= nx * ny * nz:
        raise ValueError(f"rows {c0}..{c0 + n} outside a grid of {nx * ny * nz} voxels")
    lib = _library()
    out = torch.empty((n, K), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    gp, oriented = grid
    err = lib.gto_phi_launch(table.data_ptr(), K, ctypes.cast(gp, ctypes.c_void_p), oriented,
                             nx, ny, nz, int(c0), int(n), out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    _finish(err)
    return out


def brick_voxels(dims, device="cpu") -> torch.Tensor:
    """(blocks, 256) int64 z-fastest voxel index of each thread of each ψ
    block, −1 where the brick overhangs the grid: the kernel's mapping."""
    nx, ny, nz = (int(d) for d in dims)
    bx, by, bz = BRICK
    nbx, nby, nbz = -(-nx // bx), -(-ny // by), -(-nz // bz)
    b = torch.arange(nbx * nby * nbz, device=device)[:, None]
    t = torch.arange(bx * by * bz, device=device)[None, :]
    ix = (b // (nby * nbz)) * bx + t // (by * bz)
    iy = ((b // nbz) % nby) * by + (t // bz) % by
    iz = (b % nbz) * bz + t % bz
    inside = (ix < nx) & (iy < ny) & (iz < nz)
    return torch.where(inside, (ix * ny + iy) * nz + iz, torch.full_like(ix, -1))


def row_tiles(c0: int, n: int, device="cpu") -> torch.Tensor:
    """(blocks, 32) int64 voxel index of each row of each Φ block of rows
    c0 … c0 + n − 1, −1 past the last row: the kernel's tiling."""
    r = torch.arange(-(-n // ROWS) * ROWS, device=device).reshape(-1, ROWS)
    return torch.where(r < n, c0 + r, torch.full_like(r, -1))


def screen_keep(points: torch.Tensor, groups: torch.Tensor, centers: torch.Tensor,
                exponents: torch.Tensor) -> torch.Tensor:
    """(G, K) bool: False where primitive k adds exactly 0 at every voxel
    of group g, the kernel's test in its float32 operations. points: (P,
    3) voxel centres (`grid_points`); groups: (G, V) voxel indices, −1 for
    none (`brick_voxels`, `row_tiles`)."""
    valid = (groups >= 0)[..., None]
    p = points[groups.clamp_min(0)]  # (G, V, 3)
    inf = torch.full_like(p, float("inf"))
    lo = torch.where(valid, p, inf).amin(1)[:, None, :]  # (G, 1, 3)
    hi = torch.where(valid, p, -inf).amax(1)[:, None, :]
    c = centers[None, :, :]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    gap = torch.where(c < lo, lo - c, torch.where(c > hi, c - hi, zero))  # (G, K, 3)
    gx, gy, gz = gap[..., 0], gap[..., 1], gap[..., 2]
    d2 = gx * gx + gy * gy + gz * gz
    return ~(exponents[None, :] * d2 >= CUTOFF)
