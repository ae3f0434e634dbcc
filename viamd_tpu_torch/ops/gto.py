"""Gaussian-type-orbital (GTO) grid evaluation.

Torch port of viamd_tpu/ops/gto.py (mdlib's md_gto.h: MO, NTO and
electron-density evaluation on voxel grids, VIAMD
src/components/veloxchem/veloxchem.cpp:1044-1108).

Primitives are cartesian gaussians  φ(r) = c · (x-X)^l (y-Y)^m (z-Z)^n ·
exp(-α|r-R|²), with the contraction, normalization and MO coefficient folded
into c. For P points and K primitives the plain version builds the (P, K)
primitive matrix Φ elementwise (`primitive_matrix`) and contracts it
against coefficient columns: Σ φ·c for one orbital (`_contract`), `Φ @ C`
(torch.matmul, float32 — TF32 stays off, as PyTorch leaves it) for many.

The grid functions route by device. On a CUDA device they run
csrc/gto.cu (ops/cuda_gto.py), which screens out, per brick of voxels
(4×8×8 for ψ, 4×4×4 for ρ), the primitives that add exactly 0 there, and
never writes Φ to device memory:
- `eval_gto_grid` (one orbital: the HOMO, NTO and orbital-view grids) is
  one ψ launch over the whole grid;
- `density_grid` is one ρ launch, ρ = Σ_m occ_m·(ΦC)_m², over the
  occupied columns;
- `transition_density_grid` is one ρ launch, ρ = Σ_a (Φ·C_occ·T)_a·
  (Φ·C_virt)_a, after the small product C_occ·T (torch.matmul, K × nocc ×
  nvirt) on the device.
On a CPU device they take the plain version over chunks of `chunk`
voxels (CHUNK, 8,192, as in the JAX package), with an exact tail instead
of a padded last chunk; `chunk` is the plain version's alone.
Any other device raises. `density_grid` drops columns whose occupation is
exactly 0 before the contraction: they add exactly 0 to ρ. `eval_gto`, at
arbitrary points, is the plain version on every device.

`attribute_grid_to_atoms` computes what the JAX one-hot matmul computes: the
first atom minimizing |r − x_a| − r_a for each voxel (`torch.argmin`, ties to
the lower index as `jnp.argmin`; the root correctly rounded on every device,
`ops/rdf.py::sqrt_rn`), then a per-atom sum in fixed point
(`ops/density.py::scaled_fixed_point_sum`), the same in any order of the
terms, so two CUDA runs give the same bits.

`overlap_matrix` and `normalization` are host numpy, copies of the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.ops import cuda_gto
from viamd_tpu_torch.ops.density import scaled_fixed_point_sum
from viamd_tpu_torch.ops.rdf import sqrt_rn

CHUNK = 8192  # voxels a Φ of the plain version, as in the JAX package


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                           dtype=torch.float32, device=device)


def _ipow(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """base**exp for small non-negative integer exp, the JAX package's
    branch-free square-and-select in its order of products."""
    out = torch.ones_like(base)
    b = base
    e = exp
    for _ in range(3):  # exp ≤ 4 fits in 3 bits
        out = torch.where((e & 1) == 1, out * b, out)
        b = b * b
        e = e >> 1
    return out


def primitive_matrix(points, centers, exponents, lmn, cutoff: float = 40.0) -> torch.Tensor:
    """(P, K) primitive values φ_k(p) without coefficients; contributions
    with α·r² ≥ cutoff are 0."""
    d = points[:, None, :] - centers[None, :, :]  # (P, K, 3)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r2 = dx * dx + dy * dy + dz * dz
    ar2 = exponents[None, :] * r2
    ang = _ipow(dx, lmn[None, :, 0]) * _ipow(dy, lmn[None, :, 1]) * _ipow(dz, lmn[None, :, 2])
    rad = torch.where(ar2 < cutoff, torch.exp(-ar2), torch.zeros_like(ar2))
    return ang * rad


def _contract(phi: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    if coeffs.ndim == 1:
        return (phi * coeffs[None, :]).sum(1)
    return phi @ coeffs


def eval_gto(points, centers, exponents, coeffs, lmn, cutoff: float = 40.0, *, device):
    """ψ at each point on `device`: (P,) for (K,) coeffs, (P, M) for (K, M)."""
    b = _Basis(centers, exponents, lmn, device)
    phi = primitive_matrix(_f32(points, device), b.centers, b.exponents, b.lmn, cutoff)
    return _contract(phi, _f32(coeffs, device))


def grid_points(origin, voxel, dims, orientation=None, *, device):
    """(P, 3) world-space voxel centers, z fastest. `orientation` (3, 3)
    columns are the grid axes: world = orientation @ (origin + (i + ½)·
    voxel), with origin in the grid frame (the OBB export grids); None =
    axis-aligned. The product is written out, world_j = p_x R_j0 + p_y R_j1
    + p_z R_j2 (as the JAX package expands it), so csrc/gto.cu computes the
    same centres."""
    nx, ny, nz = (int(d) for d in dims)
    P = nx * ny * nz
    ii = torch.arange(P, dtype=torch.int64, device=device)
    iz = ii % nz
    iy = (ii // nz) % ny
    ix = ii // (ny * nz)
    idx = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
    pts = _f32(origin, device)[None, :] + (idx + 0.5) * _f32(voxel, device)[None, :]
    if orientation is not None:
        r = _f32(orientation, "cpu").numpy()
        pts = torch.stack([pts[:, 0] * float(r[j, 0]) + pts[:, 1] * float(r[j, 1])
                           + pts[:, 2] * float(r[j, 2]) for j in range(3)], dim=-1)
    return pts


class _Basis:
    """The primitive arrays of one grid call as tensors on the device."""

    def __init__(self, centers, exponents, lmn, device):
        self.centers = _f32(centers, device)
        self.exponents = _f32(exponents, device)
        self.lmn = torch.as_tensor(np.asarray(lmn) if not torch.is_tensor(lmn) else lmn,
                                   dtype=torch.int32, device=device)

    def phi(self, block):
        return primitive_matrix(block, self.centers, self.exponents, self.lmn)


def _kernel_route(dev: torch.device) -> bool:
    """True for the kernel (a CUDA device), False for the plain version
    (the CPU); any other device raises."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no GTO grid for device {dev}")
    return dev.type == "cuda"


def _over_chunks(fn, origin, voxel, dims, orientation, chunk: int, device) -> torch.Tensor:
    """fn(points of one chunk) → (n,) values, over the grid's voxels in
    chunks (the last one shorter) → (nx, ny, nz)."""
    pts = grid_points(origin, voxel, dims, orientation, device=device)
    out = torch.empty(pts.shape[0], dtype=torch.float32, device=device)
    for c0 in range(0, pts.shape[0], chunk):
        out[c0 : c0 + chunk] = fn(pts[c0 : c0 + chunk])
    return out.reshape(*(int(d) for d in dims))


def eval_gto_grid(centers, exponents, coeffs, lmn, origin, voxel, dims, chunk: int = CHUNK,
                  orientation=None, *, device) -> torch.Tensor:
    """One orbital ((K,) coeffs) on a voxel grid → (nx, ny, nz) tensor on
    `device`, the input of the volume ray-marcher (the orbital windows).
    `orientation` rotates the grid into world space (OBB exports). On CUDA
    one ψ launch of csrc/gto.cu; on the CPU the plain version in chunks of
    `chunk` voxels."""
    dev = torch.device(device)
    basis = _Basis(centers, exponents, lmn, dev)
    c = _f32(coeffs, dev)
    if _kernel_route(dev):
        table = cuda_gto.prim_table(basis.centers, basis.exponents, basis.lmn, c)
        return cuda_gto.psi_grid(table, cuda_gto.grid_block(origin, voxel, orientation), dims)
    return _over_chunks(lambda b: _contract(basis.phi(b), c), origin, voxel, dims,
                        orientation, chunk, dev)


def density_grid(centers, exponents, mo_coeffs, lmn, origin, voxel, dims, occupations=None,
                 chunk: int = CHUNK, orientation=None, *, device) -> torch.Tensor:
    """Electron density ρ = Σ_mo occ·ψ_mo² on a grid (the electron-density
    window). mo_coeffs: (K, M); occupations: (M,) host values (2 each when
    None). Columns of occupation exactly 0 are left out of the product.
    On CUDA one ρ launch of csrc/gto.cu; on the CPU the plain version,
    Φ @ C in chunks of `chunk` voxels."""
    dev = torch.device(device)
    C = _f32(mo_coeffs, dev)
    if occupations is None:
        occ = np.full(C.shape[1], 2.0, np.float32)
    else:
        occ = np.asarray(occupations.cpu() if torch.is_tensor(occupations) else occupations,
                         np.float32).reshape(-1)
    keep = np.flatnonzero(occ != 0)
    if keep.size < C.shape[1]:
        C = C[:, torch.as_tensor(keep, device=dev)]
        occ = occ[keep]
    occ_t = torch.as_tensor(occ, device=dev)
    basis = _Basis(centers, exponents, lmn, dev)
    if _kernel_route(dev):
        table = cuda_gto.prim_table(basis.centers, basis.exponents, basis.lmn)
        return cuda_gto.rho_grid(table, C.contiguous(), None, occ_t,
                                 cuda_gto.grid_block(origin, voxel, orientation), dims)

    def rho(block):
        psi = basis.phi(block) @ C
        return (psi * psi * occ_t[None, :]).sum(1)

    return _over_chunks(rho, origin, voxel, dims, orientation, chunk, dev)


def transition_density_grid(centers, exponents, C_occ, C_virt, T, lmn, origin, voxel, dims,
                            chunk: int = CHUNK, orientation=None, *, device) -> torch.Tensor:
    """One-particle transition density ρ_T(r) = Σ_ia T_ia ψ_i(r) ψ_a(r) on a
    grid (the transition analysis window). C_occ: (K, nocc), C_virt:
    (K, nvirt) primitive-expanded MOs, T: (nocc, nvirt) amplitudes. On
    CUDA one ρ launch of csrc/gto.cu on A = C_occ·T and B = C_virt; on the
    CPU the plain version, (Φ @ C_occ) @ T · (Φ @ C_virt) in chunks of
    `chunk` voxels."""
    dev = torch.device(device)
    Co, Cv, Tt = _f32(C_occ, dev), _f32(C_virt, dev), _f32(T, dev)
    basis = _Basis(centers, exponents, lmn, dev)
    if _kernel_route(dev):
        table = cuda_gto.prim_table(basis.centers, basis.exponents, basis.lmn)
        ones = torch.ones(Cv.shape[1], dtype=torch.float32, device=dev)
        return cuda_gto.rho_grid(table, Co @ Tt, Cv.contiguous(), ones,
                                 cuda_gto.grid_block(origin, voxel, orientation), dims)

    def rho_t(block):
        phi = basis.phi(block)
        return ((phi @ Co) @ Tt * (phi @ Cv)).sum(1)

    return _over_chunks(rho_t, origin, voxel, dims, orientation, chunk, dev)


def grid_winners(grid_shape, origin, voxel, atom_xyz, radii=None, chunk: int = CHUNK, *,
                 device) -> torch.Tensor:
    """(P,) int64 index of the atom minimizing |r − x_a| − r_a at each voxel
    center (additively weighted Voronoi; the first such atom on ties)."""
    xyz = _f32(atom_xyz, device)
    r_a = (torch.zeros(xyz.shape[0], device=device) if radii is None
           else _f32(radii, device))
    pts = grid_points(origin, voxel, grid_shape, device=device)
    win = torch.empty(pts.shape[0], dtype=torch.int64, device=device)
    for c0 in range(0, pts.shape[0], chunk):
        p = pts[c0 : c0 + chunk]
        dx = p[:, 0:1] - xyz[None, :, 0]
        dy = p[:, 1:2] - xyz[None, :, 1]
        dz = p[:, 2:3] - xyz[None, :, 2]
        d = sqrt_rn(dx * dx + dy * dy + dz * dz) - r_a[None, :]
        win[c0 : c0 + chunk] = torch.argmin(d, dim=1)
    return win


def attribute_grid_to_atoms(grid, origin, voxel, atom_xyz, radii=None, chunk: int = CHUNK, *,
                            device) -> torch.Tensor:
    """Per-atom integral of a density grid by nearest-atom segmentation →
    (na,) charges (voxel volume folded in) on `device` — md_gto's
    segment-and-attribute step (veloxchem.cpp:6888-6898)."""
    g = _f32(grid, device)
    v = _f32(voxel, device)
    vals = g.reshape(-1) * (v[0] * v[1] * v[2])
    win = grid_winners(g.shape, origin, voxel, atom_xyz, radii, chunk, device=device)
    na = int(np.shape(atom_xyz)[0])
    return scaled_fixed_point_sum(na, win, vals)


def overlap_matrix(shells) -> np.ndarray:
    """Analytic overlap matrix of a contracted cartesian GTO basis →
    (nbasis_cart, nbasis_cart), host float64 — copy of the JAX package's
    (the md_vlx_scf_overlap_matrix_data stand-in): the Gaussian-product
    closed form S = ∏_d S1d, normalization as in `normalization`."""
    from math import comb

    centers, exps, lmns, bidx, cn = [], [], [], [], []
    b = 0
    _CART_L = {
        0: [(0, 0, 0)],
        1: [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
        2: [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
            (0, 0, 2)],
        3: [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
            (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)],
    }
    for sh in shells:
        for l, m, n in _CART_L[int(sh.angular)]:
            for a, c in zip(
                np.asarray(sh.exponents, np.float64),
                np.asarray(sh.contraction, np.float64),
            ):
                centers.append(np.asarray(sh.center, np.float64))
                exps.append(float(a))
                lmns.append((l, m, n))
                bidx.append(b)
                cn.append(float(c) * normalization(float(a), l, m, n))
            b += 1
    K = len(exps)
    nb = b
    A = np.asarray(centers)  # (K, 3)
    al = np.asarray(exps)  # (K,)
    L = np.asarray(lmns)  # (K, 3)
    cw = np.asarray(cn)
    bidx = np.asarray(bidx)

    def df_odd(k):  # (k−1)!! for even k ≥ 0
        out = 1.0
        for i in range(k - 1, 0, -2):
            out *= i
        return out

    lmax = int(L.max())
    Ctab = np.zeros((lmax + 1, lmax + 1))
    for lt in range(lmax + 1):
        for it in range(lt + 1):
            Ctab[lt, it] = comb(lt, it)
    g = al[:, None] + al[None, :]  # (K, K)
    mu = al[:, None] * al[None, :] / g
    P = (al[:, None, None] * A[:, None, :] + al[None, :, None] *
         A[None, :, :]) / g[:, :, None]
    AB2 = ((A[:, None, :] - A[None, :, :]) ** 2).sum(-1)
    pref = (np.pi / g) ** 1.5 * np.exp(-mu * AB2)
    PA = P - A[:, None, :]  # (K, K, 3)
    PB = P - A[None, :, :]
    inv2g = 1.0 / (2.0 * g)
    S = np.array(pref)
    for d in range(3):
        s1 = np.zeros_like(g)
        l1 = L[:, d][:, None]
        l2 = L[:, d][None, :]
        for i in range(lmax + 1):
            for j in range(lmax + 1):
                if (i + j) % 2 == 1:
                    continue
                ok = (l1 >= i) & (l2 >= j)
                c1 = Ctab[np.maximum(l1, i), i]
                c2 = Ctab[np.maximum(l2, j), j]
                term = np.where(
                    ok,
                    c1 * c2
                    * PA[:, :, d] ** np.maximum(l1 - i, 0)
                    * PB[:, :, d] ** np.maximum(l2 - j, 0)
                    * df_odd(i + j) * inv2g ** ((i + j) // 2),
                    0.0,
                )
                s1 = s1 + term
        S = S * s1
    Sw = S * cw[:, None] * cw[None, :]
    out = np.zeros((nb, nb))
    np.add.at(out, (bidx[:, None].repeat(K, 1), bidx[None, :].repeat(K, 0)),
              Sw)
    return out


def normalization(alpha: float, l: int, m: int, n: int) -> float:
    """Cartesian GTO normalization constant (host-side helper)."""
    from math import pi, sqrt

    def df(k):  # (2k-1)!!
        out = 1
        for i in range(3, 2 * k, 2):
            out *= i
        return out

    L = l + m + n
    pref = (2 * alpha / pi) ** 0.75 * (4 * alpha) ** (L / 2)
    return pref / sqrt(df(l) * df(m) * df(n))
