"""GTO grids: the CUDA kernel's wrapper (csrc/gto.cu) and the plain
mirrors of its screen and of its density walk.

Counterpart of the XLA fusion of viamd_tpu/ops/gto.py::eval_gto inside the
`lax.scan`s of eval_gto_grid, density_grid and transition_density_grid
(not a Pallas kernel). ops/gto.py routes a CUDA device here and a CPU
device to its plain version, `primitive_matrix` over `grid_points` (and
`_contract` or `Φ @ C`). Two launches, one a grid each; neither writes the
primitive matrix Φ to device memory:

    psi_grid   ψ = Σ_k φ_k·c_k of one coefficient column;
    rho_grid   ρ = Σ_m w_m·(ΦA)_m·(ΦB)_m over the columns of A and B
               (B = A when None): the electron density (A = the occupied
               columns, w = the occupations) and a transition density
               (A = C_occ·T, B = C_virt, w = 1).

The primitive table is `prim_table`: (K, 8) float32, per primitive the
centre, α, the ψ coefficient (0 for ρ) and the powers packed as
l | m << 4 | n << 8 in the bits of a float. The grid is `grid_block`: 15
float32 values, origin (3, grid frame), voxel (3), orientation (3x3,
row-major, world = R @ p; the identity when axis-aligned).

Both launches skip, per brick of voxels (4×8×8 for ψ, 4×4×4 for ρ), the
primitives that add exactly 0 at every voxel of the brick (the note in
csrc/gto.cu). `screen_keep` is that screen in plain PyTorch, on the voxel
groups `brick_voxels` gives (BRICK, RHO_BRICK); the tests hold it to the
plain arithmetic, and chip_smoke.py counts the kernel's kept pairs with
it. `rho_grid_plain`
walks the bricks as the ρ kernel does (kept primitives only, the columns
padded by `padded_columns` and taken in passes of `RHO_PASS`), on the
arguments `rho_grid` takes, on any device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from viamd_tpu_torch.cuda_build import Library, check_tensor as _check

__all__ = [
    "BRICK",
    "COLS",
    "CUTOFF",
    "LIBRARY",
    "MAX_PRIMITIVES",
    "RHO_BRICK",
    "RHO_PASS",
    "brick_voxels",
    "grid_block",
    "launches",
    "padded_columns",
    "prim_table",
    "psi_grid",
    "rho_grid",
    "rho_grid_plain",
    "screen_keep",
]

BRICK = (4, 8, 8)  # a ψ block's voxels in x, y, z (z fastest): one a thread
RHO_BRICK = (4, 4, 4)  # a ρ block's voxels: four threads each
CUTOFF = 40.0  # α·r² at and above which a primitive adds 0
COLS = 16  # ρ's columns are padded with zeros to a multiple of this (a warp's)
RHO_PASS = {False: 256, True: 128}  # ρ columns a pass: density, transition (two products)
MAX_PRIMITIVES = 65535  # ρ's kept list holds 2-byte indices

# kernel launches since import (reset freely by callers that count a run)
launches = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("gto", ("gto.cu",), {
    "gto_psi_launch": (_i, [_p, _i, _p, _i, _i, _i, _i, _p, _p]),
    "gto_rho_launch": (_i, [_p, _i, _p, _p, _p, _i, _p, _i, _i, _i, _i, _p, _p]),
})


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
    lib = LIBRARY.load()
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    gp, oriented = grid
    err = lib.gto_psi_launch(table.data_ptr(), K, ctypes.cast(gp, ctypes.c_void_p), oriented,
                             nx, ny, nz, out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    _finish(err)
    return out


def padded_columns(A: torch.Tensor, B: torch.Tensor | None, w: torch.Tensor) -> tuple:
    """(A, B, w) with zero columns (and zero weights) appended up to a
    multiple of COLS columns, as the ρ kernel takes them; they add exactly
    0. The tensors themselves when M is a multiple already."""
    M = A.shape[1]
    Mp = -(-M // COLS) * COLS
    if Mp == M:
        return A, B, w

    def pad(x):
        out = x.new_zeros((*x.shape[:-1], Mp))
        out[..., :M] = x
        return out

    return pad(A), None if B is None else pad(B), pad(w)


def _rho_args(table: torch.Tensor, A: torch.Tensor, B: torch.Tensor | None, w: torch.Tensor,
              dev: torch.device) -> tuple:
    K = table.shape[0]
    if K > MAX_PRIMITIVES:
        raise ValueError(f"the gto ρ kernel takes at most {MAX_PRIMITIVES} primitives, not {K}")
    _check(table, "table", torch.float32, (K, 8), dev)
    M = A.shape[1] if A.ndim == 2 else -1
    _check(A, "A", torch.float32, (K, M), dev)
    if B is not None:
        _check(B, "B", torch.float32, (K, M), dev)
    _check(w, "w", torch.float32, (M,), dev)
    return padded_columns(A, B, w)


def rho_grid(table: torch.Tensor, A: torch.Tensor, B: torch.Tensor | None, w: torch.Tensor,
             grid: tuple, dims) -> torch.Tensor:
    """One launch of the ρ kernel → (nx, ny, nz) float32 on the table's
    CUDA device: ρ = Σ_m w_m·(ΦA)_m·(ΦB)_m, B = A when None. A, B: (K, M)
    contiguous float32, w: (M,)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the gto kernel runs on CUDA tensors, not {dev}")
    A, B, w = _rho_args(table, A, B, w, dev)
    nx, ny, nz = (int(d) for d in dims)
    lib = LIBRARY.load()
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    gp, oriented = grid
    err = lib.gto_rho_launch(table.data_ptr(), table.shape[0], A.data_ptr(),
                             None if B is None else B.data_ptr(), w.data_ptr(), A.shape[1],
                             ctypes.cast(gp, ctypes.c_void_p), oriented, nx, ny, nz,
                             out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _finish(err)
    return out


def rho_grid_plain(table: torch.Tensor, A: torch.Tensor, B: torch.Tensor | None,
                   w: torch.Tensor, grid: tuple, dims) -> torch.Tensor:
    """The ρ kernel's walk in plain PyTorch on the table's device, on
    rho_grid's arguments: per brick, `screen_keep`'s kept primitives only,
    φ by ops/gto.py::primitive_matrix, the padded columns in passes of
    RHO_PASS, ρ summed pass by pass. Equal to the unscreened plain version
    within float32 rounding (the products of the dropped pairs are exact
    zeros); the kernel's sums run in another order."""
    from viamd_tpu_torch.ops.gto import grid_points, primitive_matrix

    dev = table.device
    A, B, w = _rho_args(table, A, B, w, dev)
    centers, alphas = table[:, :3], table[:, 3]
    bits = table.view(torch.int32)[:, 5]
    lmn = torch.stack([bits & 15, (bits >> 4) & 15, bits >> 8], 1)
    gp, oriented = grid
    vals = np.frombuffer(gp, np.float32)
    pts = grid_points(vals[:3], vals[3:6], dims, vals[6:].reshape(3, 3) if oriented else None,
                      device=dev)
    groups = brick_voxels(dims, device=dev, brick=RHO_BRICK)
    keep = screen_keep(pts, groups, centers, alphas)
    width = RHO_PASS[B is not None]
    out = torch.zeros(pts.shape[0], dtype=torch.float32, device=dev)
    for g in range(groups.shape[0]):
        ks = torch.nonzero(keep[g])[:, 0]
        if ks.numel() == 0:  # no primitive reaches the brick
            continue
        vox = groups[g][groups[g] >= 0]
        phi = primitive_matrix(pts[vox], centers[ks], alphas[ks], lmn[ks])
        rho = torch.zeros(vox.shape[0], dtype=torch.float32, device=dev)
        for c0 in range(0, A.shape[1], width):
            a = phi @ A[ks, c0 : c0 + width]
            b = a if B is None else phi @ B[ks, c0 : c0 + width]
            rho = rho + (a * b * w[None, c0 : c0 + width]).sum(1)
        out[vox] = rho
    return out.reshape(*(int(d) for d in dims))


def brick_voxels(dims, device="cpu", brick=BRICK) -> torch.Tensor:
    """(blocks, bx·by·bz) int64 z-fastest voxel index of each voxel of each
    block's brick, −1 where the brick overhangs the grid: the kernel's
    mapping (BRICK for ψ, RHO_BRICK for ρ)."""
    nx, ny, nz = (int(d) for d in dims)
    bx, by, bz = brick
    nbx, nby, nbz = -(-nx // bx), -(-ny // by), -(-nz // bz)
    b = torch.arange(nbx * nby * nbz, device=device)[:, None]
    t = torch.arange(bx * by * bz, device=device)[None, :]
    ix = (b // (nby * nbz)) * bx + t // (by * bz)
    iy = ((b // nbz) % nby) * by + (t // bz) % by
    iz = (b % nbz) * bz + t % bz
    inside = (ix < nx) & (iy < ny) & (iz < nz)
    return torch.where(inside, (ix * ny + iy) * nz + iz, torch.full_like(ix, -1))


def screen_keep(points: torch.Tensor, groups: torch.Tensor, centers: torch.Tensor,
                exponents: torch.Tensor) -> torch.Tensor:
    """(G, K) bool: False where primitive k adds exactly 0 at every voxel
    of group g, the kernel's test in its float32 operations. points: (P,
    3) voxel centres (`grid_points`); groups: (G, V) voxel indices, −1 for
    none (`brick_voxels`)."""
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
