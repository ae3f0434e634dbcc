"""csrc/gto.cu's design on the CPU: its exact screen, its voxel mapping and
the routing of ops/gto.py's grid functions; on the card, the kernel
against its plain version (ops/gto.py::primitive_matrix). The density
mode's own tests are tests/test_torch_gto_density.py.

The tests marked `requires_cuda` import nothing of the JAX package, so they
collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_gto_kernel.py

Tolerances.
- The screen (ops/cuda_gto.py::screen_keep): none. Every pair it skips
  must have α·r² ≥ 40 in primitive_matrix's float32 operations, so the
  screened sum equals the unscreened one bit for bit.
- On the card, ψ mode against the plain contraction: |Δψ| ≤
  2·K·2⁻²⁴·Σ_k |φ_k·c_k| at each voxel, the sum of both orders' float32
  error bounds (the terms φ_k·c_k are the same: the same operations, and
  expf is what torch.exp calls there; only the order of the sum differs).
  ρ mode against the plain Φ @ C: within 2·(2K + M + 8)·2⁻²⁴·Σ_m |w_m|·
  (|Φ||A|)_m·(|Φ||B|)_m at each voxel (csrc/gto.cu's note).
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.ops import cuda_gto as CG
from viamd_tpu_torch.ops import gto as TG

U = 2.0**-24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _basis(seed, K=60, spread=6.0, M=1):
    """Primitives with α from 0.05 to 3,000 (6-31G's range and beyond),
    centres inside and around the grid, powers up to 4 in total."""
    rng = np.random.RandomState(seed)
    centers = (rng.randn(K, 3) * spread).astype(np.float32)
    alphas = np.exp(rng.uniform(np.log(0.05), np.log(3000.0), K)).astype(np.float32)
    lmn = rng.randint(0, 3, (K, 3)).astype(np.int32)
    lmn[lmn.sum(1) > 4] = [2, 0, 2]
    C = rng.randn(K, M).astype(np.float32)
    return centers, alphas, lmn, C


def _geometry(seed, dims, oriented):
    rng = np.random.RandomState(seed)
    R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32) if oriented else None
    origin = (-0.5 * np.asarray(dims) * 0.3 + rng.uniform(-1, 1, 3)).astype(np.float32)
    voxel = rng.uniform(0.2, 0.4, 3).astype(np.float32)
    return origin, voxel, R


def _edge_of_cutoff(points, groups, alphas, seed):
    """Centres a hair either side of the cutoff radius sqrt(40/α) beyond a
    group's extreme voxel along one axis (so the gap to the group's box is
    that voxel's own difference): the screen's edge, where α·r² lands
    within a few ulps of 40."""
    rng = np.random.RandomState(seed)
    K = alphas.shape[0]
    g = rng.randint(0, groups.shape[0], K)
    out = np.empty((K, 3), np.float32)
    for k in range(K):
        p = points[groups[g[k]][groups[g[k]] >= 0]].numpy().astype(np.float64)
        axis, sgn = rng.randint(3), rng.choice([-1.0, 1.0])
        v = p[np.argmax(sgn * p[:, axis])]
        r = np.sqrt(40.0 / float(alphas[k])) * (1.0 + rng.uniform(-3e-7, 3e-7))
        out[k] = v
        out[k, axis] = v[axis] + sgn * r
    return out


def _ar2(points, centers, alphas):
    """α·r² in primitive_matrix's float32 operations, (P, K)."""
    d = points[:, None, :] - centers[None, :, :]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return alphas[None, :] * (dx * dx + dy * dy + dz * dz)


CASES = [
    ("bricks", (13, 10, 17), False, "random"),
    ("bricks", (9, 24, 7), True, "random"),
    ("bricks", (12, 16, 16), False, "edge"),
    ("bricks", (14, 12, 10), True, "edge"),
    ("rho_bricks", (11, 9, 13), False, "random"),
    ("rho_bricks", (10, 7, 15), True, "edge"),
]


@pytest.mark.parametrize("groups_of,dims,oriented,centres", CASES)
def test_screen_is_exact(groups_of, dims, oriented, centres):
    """Every (voxel, primitive) pair the screen skips has α·r² ≥ 40 under
    primitive_matrix's arithmetic, so the screened sum is the unscreened
    one; and the screen skips a real share of the pairs."""
    seed = len(CASES) + dims[0]
    origin, voxel, R = _geometry(seed, dims, oriented)
    pts = TG.grid_points(origin, voxel, dims, R, device="cpu")
    P = pts.shape[0]
    groups = CG.brick_voxels(dims, brick=CG.BRICK if groups_of == "bricks" else CG.RHO_BRICK)
    centers, alphas, lmn, C = _basis(seed, spread=0.3 * max(dims))
    if centres == "edge":
        centers = _edge_of_cutoff(pts, groups, alphas, seed)
    ct, at = torch.as_tensor(centers), torch.as_tensor(alphas)
    keep = CG.screen_keep(pts, groups, ct, at)  # (G, K)
    phi = TG.primitive_matrix(pts, ct, at, torch.as_tensor(lmn))
    ar2 = _ar2(pts, ct, at)
    vox = groups.clamp_min(0)
    skipped = (~keep)[:, None, :] & (groups >= 0)[:, :, None]  # (G, V, K)
    assert bool((ar2[vox][skipped] >= 40.0).all())
    assert not bool(phi[vox][skipped].any())
    c = torch.as_tensor(C[:, 0])
    psi = TG._contract(phi, c)
    kept = torch.zeros((P, centers.shape[0]), dtype=torch.bool)
    for g in range(groups.shape[0]):
        v = groups[g][groups[g] >= 0]
        kept[v] = keep[g]
    assert torch.equal(TG._contract(torch.where(kept, phi, torch.zeros_like(phi)), c)[vox[groups >= 0]],
                       psi[vox[groups >= 0]])
    share = float(skipped.sum()) / float(((groups >= 0).sum()) * centers.shape[0])
    assert share > 0.05, share


def test_screen_empty_and_point_groups():
    """A one-voxel group keeps exactly the primitives whose α·r² < 40
    there (the box is the point); a primitive on the box keeps."""
    pts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    groups = torch.tensor([[0, -1], [1, -1]])
    centers = torch.tensor([[0.0, 0.0, 6.3], [0.0, 0.0, 6.4], [1.0, 2.0, 3.0]])
    alphas = torch.tensor([1.0, 1.0, 3000.0])
    keep = CG.screen_keep(pts, groups, centers, alphas)
    want = _ar2(pts, centers, alphas) < 40.0
    assert torch.equal(keep, want)


@pytest.mark.parametrize("brick", ["psi", "rho"])
@pytest.mark.parametrize("dims", [(4, 8, 8), (5, 9, 3), (17, 1, 30), (1, 1, 1)])
def test_bricks_cover_each_voxel_once(dims, brick):
    shape = CG.BRICK if brick == "psi" else CG.RHO_BRICK
    b = CG.brick_voxels(dims, brick=shape)
    assert b.shape[1] == int(np.prod(shape))
    v = b[b >= 0]
    assert torch.equal(torch.sort(v).values, torch.arange(int(np.prod(dims))))
    # each brick is compact: its voxels span at most the brick in each axis
    nx, ny, nz = dims
    for g in b[: min(b.shape[0], 20)]:
        g = g[g >= 0]
        ix, iy, iz = g // (ny * nz), (g // nz) % ny, g % nz
        for a, n in zip((ix, iy, iz), shape):
            assert int(a.max() - a.min()) < n


def test_prim_table_moves_bits():
    centers, alphas, lmn, C = _basis(3, K=7)
    lmn[0] = [4, 0, 0]
    lmn[1] = [0, 3, 1]
    tab = CG.prim_table(torch.as_tensor(centers), torch.as_tensor(alphas),
                        torch.as_tensor(lmn), torch.as_tensor(C[:, 0]))
    assert tab.shape == (7, 8) and tab.dtype == torch.float32 and tab.is_contiguous()
    assert torch.equal(tab[:, :3], torch.as_tensor(centers))
    assert torch.equal(tab[:, 3], torch.as_tensor(alphas))
    assert torch.equal(tab[:, 4], torch.as_tensor(C[:, 0]))
    bits = tab.view(torch.int32)[:, 5]
    assert torch.equal(bits, torch.as_tensor(lmn[:, 0] | lmn[:, 1] << 4 | lmn[:, 2] << 8))
    assert not CG.prim_table(torch.as_tensor(centers), torch.as_tensor(alphas),
                             torch.as_tensor(lmn))[:, 4].any()


def test_grid_block():
    o, v = np.array([1.5, -2, 3], np.float64), np.array([0.1, 0.2, 0.3])
    R = np.linalg.qr(np.random.RandomState(0).randn(3, 3))[0]
    vals, oriented = CG.grid_block(o, v, R)
    got = np.frombuffer(vals, np.float32)
    want = np.concatenate([o, v, R.reshape(-1)]).astype(np.float32)
    assert oriented == 1 and np.array_equal(got, want)
    vals, oriented = CG.grid_block(o, v, None)
    assert oriented == 0 and np.array_equal(np.frombuffer(vals, np.float32)[6:],
                                            np.eye(3, dtype=np.float32).reshape(-1))


def _refuse(*a, **k):
    raise AssertionError("a CPU grid reached the CUDA kernel")


def test_cpu_takes_the_plain_version(monkeypatch):
    """On the CPU the three grid functions build Φ with primitive_matrix
    and never reach the kernel's wrappers."""
    monkeypatch.setattr(CG, "psi_grid", _refuse)
    monkeypatch.setattr(CG, "rho_grid", _refuse)
    builds = []
    real = TG.primitive_matrix

    def counted(*a, **k):
        builds.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TG, "primitive_matrix", counted)
    centers, alphas, lmn, C = _basis(4, K=20, M=4)
    geo = dict(origin=np.array([-3.0, -3, -3], np.float32),
               voxel=np.array([0.5, 0.5, 0.5], np.float32), dims=(6, 5, 7), device="cpu")
    g = TG.eval_gto_grid(centers, alphas, C[:, 0], lmn, chunk=64, **geo)
    assert g.shape == (6, 5, 7) and len(builds) == -(-210 // 64)
    TG.density_grid(centers, alphas, C, lmn, chunk=100, **geo)
    TG.transition_density_grid(centers, alphas, C[:, :2], C[:, 2:], np.eye(2, 2, dtype=np.float32),
                               lmn, **geo)
    assert len(builds) == 4 + 3 + 1


def test_other_devices_raise():
    centers, alphas, lmn, C = _basis(5, K=4)
    geo = dict(origin=np.zeros(3), voxel=np.ones(3), dims=(2, 2, 2), device="meta")
    for fn in (lambda: TG.eval_gto_grid(centers, alphas, C[:, 0], lmn, **geo),
               lambda: TG.density_grid(centers, alphas, C, lmn, **geo),
               lambda: TG.transition_density_grid(centers, alphas, C, C, np.eye(1), lmn, **geo)):
        with pytest.raises(ValueError, match="device"):
            fn()


def test_wrappers_reject_cpu_tensors():
    centers, alphas, lmn, C = _basis(6, K=4)
    tab = CG.prim_table(torch.as_tensor(centers), torch.as_tensor(alphas), torch.as_tensor(lmn))
    grid = CG.grid_block(np.zeros(3), np.ones(3), None)
    with pytest.raises(ValueError, match="CUDA"):
        CG.psi_grid(tab, grid, (2, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        CG.rho_grid(tab, torch.as_tensor(C), None, torch.ones(1), grid, (2, 2, 2))


# -- on the card: the kernel against its plain version -------------------------


def _card_case(seed, dims, oriented, K=200, M=6):
    centers, alphas, lmn, C = _basis(seed, K=K, spread=0.3 * max(dims), M=M)
    origin, voxel, R = _geometry(seed, dims, oriented)
    return centers, alphas, lmn, C, origin, voxel, R


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dims,oriented", [((21, 18, 23), True), ((16, 16, 16), False)])
def test_psi_grid_within_its_bound(cuda, dims, oriented):
    centers, alphas, lmn, C, origin, voxel, R = _card_case(12, dims, oriented)
    b = TG._Basis(centers, alphas, lmn, cuda)
    c = torch.as_tensor(C[:, 0], device=cuda)
    tab = CG.prim_table(b.centers, b.exponents, b.lmn, c)
    got = CG.psi_grid(tab, CG.grid_block(origin, voxel, R), dims).reshape(-1)
    pts = TG.grid_points(origin, voxel, dims, R, device=cuda)
    phi = TG.primitive_matrix(pts, b.centers, b.exponents, b.lmn)
    want = TG._contract(phi, c)
    mag = (phi * c[None, :]).abs().sum(1)
    assert bool(((got - want).abs() <= 2 * centers.shape[0] * U * mag).all())
    # the routed grid function is this launch, and runs no primitive_matrix
    launches = CG.launches
    g = TG.eval_gto_grid(centers, alphas, C[:, 0], lmn, origin, voxel, dims, orientation=R,
                         device=cuda)
    assert CG.launches == launches + 1 and torch.equal(g.reshape(-1), got)


@pytest.mark.requires_cuda
def test_density_and_transition_on_the_kernel(cuda, monkeypatch):
    """density_grid and transition_density_grid on CUDA are one ρ launch
    each, build no Φ, and hold the plain Φ @ C within ρ's float32 bound at
    every voxel and within 1e-6 of the largest value."""
    dims = (19, 17, 22)
    centers, alphas, lmn, C, origin, voxel, R = _card_case(13, dims, True)
    T = np.random.RandomState(14).randn(2, 4).astype(np.float32)
    occ = np.array([2.0, 2.0, 1.0, 0.0, 0.5, 2.0], np.float32)
    b = TG._Basis(centers, alphas, lmn, cuda)
    pts = TG.grid_points(origin, voxel, dims, R, device=cuda)
    phi = TG.primitive_matrix(pts, b.centers, b.exponents, b.lmn)
    K = centers.shape[0]
    keep = torch.as_tensor(np.flatnonzero(occ), device=cuda)
    Cd = torch.as_tensor(C, device=cuda)[:, keep]
    w = torch.as_tensor(occ[occ != 0], device=cuda)
    psi = phi @ Cd
    rho_want = (psi * psi * w[None, :]).sum(1)
    mag = ((phi.abs() @ Cd.abs()) ** 2 * w[None, :]).sum(1)
    builds = []
    real = TG.primitive_matrix
    monkeypatch.setattr(TG, "primitive_matrix", lambda *a, **k: builds.append(1) or real(*a, **k))
    launches = CG.launches
    rho = TG.density_grid(centers, alphas, C, lmn, origin, voxel, dims, occupations=occ,
                          orientation=R, device=cuda).reshape(-1)
    assert CG.launches == launches + 1 and not builds
    assert bool(((rho - rho_want).abs() <= 2 * (2 * K + Cd.shape[1] + 8) * U * mag).all())
    assert float((rho - rho_want).abs().max()) <= 1e-6 * float(rho_want.abs().max())
    Ct = torch.as_tensor(C, device=cuda)
    Tt = torch.as_tensor(T, device=cuda)
    rt_want = ((phi @ Ct[:, :2]) @ Tt * (phi @ Ct[:, 2:])).sum(1)
    rt_mag = (((phi.abs() @ Ct[:, :2].abs()) @ Tt.abs()) * (phi.abs() @ Ct[:, 2:].abs())).sum(1)
    rt = TG.transition_density_grid(centers, alphas, C[:, :2], C[:, 2:], T, lmn, origin, voxel,
                                    dims, orientation=R, device=cuda).reshape(-1)
    assert CG.launches == launches + 2 and not builds
    assert bool(((rt - rt_want).abs() <= 2 * (2 * K + 2 + 4 + 8) * U * rt_mag).all())
    assert float((rt - rt_want).abs().max()) <= 1e-6 * float(rt_want.abs().max())
