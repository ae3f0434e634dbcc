"""The density mode of csrc/gto.cu (ops/cuda_gto.py::rho_grid): ρ = Σ_m
w_m·(ΦA)_m·(ΦB)_m, one launch a grid, no Φ in device memory.

On the CPU: density_grid and transition_density_grid against the JAX
package's; the kernel's walk in plain PyTorch (`rho_grid_plain`: ρ's 4×4×4
bricks, kept primitives only, the padded columns in passes) against the
unscreened plain version; ops/gto.py's CUDA branch run on the CPU with the
walk in the kernel's place, against the JAX package (this covers the fold
A = C_occ·T of the transition density). On the card (`requires_cuda`): the
kernel against the plain version.

The tests marked `requires_cuda` import nothing of the JAX package, so they
collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_gto_density.py

Tolerances.
- Against the JAX package: 2e-6 of the grid's largest |value|, as
  tests/test_torch_gto.py holds the grids (XLA fuses the Φ build and rounds
  its exp and its sums in another order than torch's CPU kernels). The
  fold A = C_occ·T reorders the transition density's products; measured
  within the same 2e-6.
- ρ against the plain Φ @ C (the walk on the CPU, the kernel on the card):
  |Δρ| ≤ 2·(2K + M + 8)·2⁻²⁴·Σ_m |w_m|·(|Φ||A|)_m·(|Φ||B|)_m at each voxel,
  both versions' first-order float32 error bound (the sums over K
  primitives and over M columns, in different orders); for the transition
  density against the unfolded (Φ C_occ) T (tests/test_torch_gto_kernel.py),
  nocc more terms. On the card also within 1e-5 of the largest |value|
  (chip_smoke.py's QM_RTOL).
- Where no primitive reaches a brick, ρ is exactly 0 on both sides.
- Two kernel runs: bit for bit (no atomics).
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.ops import cuda_gto as CG
from viamd_tpu_torch.ops import gto as TG

U = 2.0**-24
GRID_RTOL = 2e-6
QM_RTOL = 1e-5  # chip_smoke.py's [qm] tolerance


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _basis(seed, K=48, spread=1.5, M=6):
    """Primitives with α from 0.05 to 3,000, centres inside and around the
    grid, powers up to 4 in total, and M coefficient columns."""
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
    voxel = rng.uniform(0.2, 0.3, 3).astype(np.float32)
    origin = (-0.5 * np.asarray(dims) * voxel + rng.uniform(-0.3, 0.3, 3)).astype(np.float32)
    return dict(origin=origin, voxel=voxel, dims=dims, orientation=R)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plain(basis_np, A, B, w, geo):
    """The unscreened plain ρ over the whole grid on the CPU, and its
    float32 bound's Σ_m |w_m|·(|Φ||A|)_m·(|Φ||B|)_m."""
    b = TG._Basis(*basis_np, "cpu")
    pts = TG.grid_points(geo["origin"], geo["voxel"], geo["dims"], geo["orientation"],
                         device="cpu")
    phi = b.phi(pts)
    a, pa = phi @ A, phi.abs() @ A.abs()
    bb, pb = (a, pa) if B is None else (phi @ B, phi.abs() @ B.abs())
    return (a * bb * w[None, :]).sum(1), (pa * pb * w.abs()[None, :]).sum(1)


def _walk(basis_np, A, B, w, geo):
    b = TG._Basis(*basis_np, "cpu")
    table = CG.prim_table(b.centers, b.exponents, b.lmn)
    grid = CG.grid_block(geo["origin"], geo["voxel"], geo["orientation"])
    return CG.rho_grid_plain(table, A, B, w, grid, geo["dims"]).reshape(-1)


def _within(got, want, mag, terms):
    d = (got - want).abs()
    assert bool((d <= 2 * terms * U * mag).all()), float((d / (2 * terms * U * mag)).max())


# -- the CPU route against the JAX package --------------------------------


def _jax_density(centers, alphas, C, lmn, occ, geo):
    import jax.numpy as jnp

    from viamd_tpu.ops import gto as JG

    R = geo["orientation"]
    return np.asarray(JG.density_grid(
        jnp.asarray(centers), jnp.asarray(alphas), jnp.asarray(C), jnp.asarray(lmn),
        jnp.asarray(geo["origin"]), jnp.asarray(geo["voxel"]), geo["dims"],
        occupations=jnp.asarray(occ), orientation=None if R is None else jnp.asarray(R)))


def _jax_transition(centers, alphas, Co, Cv, T, lmn, geo):
    import jax.numpy as jnp

    from viamd_tpu.ops import gto as JG

    R = geo["orientation"]
    return np.asarray(JG.transition_density_grid(
        jnp.asarray(centers), jnp.asarray(alphas), jnp.asarray(Co), jnp.asarray(Cv),
        jnp.asarray(T), jnp.asarray(lmn), jnp.asarray(geo["origin"]),
        jnp.asarray(geo["voxel"]), geo["dims"],
        orientation=None if R is None else jnp.asarray(R)))


OCC = np.array([2.0, 2.0, 1.0, 0.0, 0.5, 2.0], np.float32)


@pytest.mark.parametrize("oriented", [False, True])
def test_density_grid_cpu_matches_jax(oriented):
    centers, alphas, lmn, C = _basis(1)
    geo = _geometry(2, (22, 19, 24), oriented)
    want = _jax_density(centers, alphas, C, lmn, OCC, geo)
    got = TG.density_grid(centers, alphas, C, lmn, occupations=OCC, device="cpu", **geo)
    assert got.shape == geo["dims"] and _rel(got, want) <= GRID_RTOL


@pytest.mark.parametrize("oriented", [False, True])
def test_transition_density_grid_cpu_matches_jax(oriented):
    centers, alphas, lmn, C = _basis(3, M=7)
    T = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    geo = _geometry(5, (20, 23, 18), oriented)
    want = _jax_transition(centers, alphas, C[:, :3], C[:, 3:], T, lmn, geo)
    got = TG.transition_density_grid(centers, alphas, C[:, :3], C[:, 3:], T, lmn,
                                     device="cpu", **geo)
    assert got.shape == geo["dims"] and _rel(got, want) <= GRID_RTOL


# -- ops/gto.py's CUDA branch with the kernel's walk in its place ----------


@pytest.fixture
def walk_route(monkeypatch):
    """ops/gto.py takes its kernel branch on the CPU, and rho_grid is the
    kernel's walk in plain PyTorch; returns the list of its calls' (A, B, w)."""
    calls = []

    def rho_grid(table, A, B, w, grid, dims):
        calls.append((A, B, w))
        return CG.rho_grid_plain(table, A, B, w, grid, dims)

    monkeypatch.setattr(TG, "_kernel_route", lambda dev: True)
    monkeypatch.setattr(CG, "rho_grid", rho_grid)
    monkeypatch.setattr(CG, "psi_grid", lambda *a: pytest.fail("no ψ launch expected"))
    return calls


@pytest.mark.parametrize("oriented", [False, True])
def test_kernel_branch_density_matches_jax(walk_route, oriented):
    """One ρ call on the occupied columns only, their occupations as w."""
    centers, alphas, lmn, C = _basis(6)
    geo = _geometry(7, (21, 18, 23), oriented)
    want = _jax_density(centers, alphas, C, lmn, OCC, geo)
    got = TG.density_grid(centers, alphas, C, lmn, occupations=OCC, device="cpu", **geo)
    (A, B, w), = walk_route
    keep = np.flatnonzero(OCC)
    assert B is None and torch.equal(A, torch.as_tensor(C[:, keep]))
    assert torch.equal(w, torch.as_tensor(OCC[keep]))
    assert _rel(got, want) <= GRID_RTOL


@pytest.mark.parametrize("oriented", [False, True])
def test_kernel_branch_transition_matches_jax(walk_route, oriented):
    """One ρ call on A = C_occ·T, B = C_virt, w = 1."""
    centers, alphas, lmn, C = _basis(8, M=7)
    T = np.random.RandomState(9).randn(3, 4).astype(np.float32)
    geo = _geometry(10, (19, 22, 20), oriented)
    want = _jax_transition(centers, alphas, C[:, :3], C[:, 3:], T, lmn, geo)
    got = TG.transition_density_grid(centers, alphas, C[:, :3], C[:, 3:], T, lmn,
                                     device="cpu", **geo)
    (A, B, w), = walk_route
    assert torch.equal(A, torch.as_tensor(C[:, :3]) @ torch.as_tensor(T))
    assert torch.equal(B, torch.as_tensor(C[:, 3:])) and torch.equal(w, torch.ones(4))
    assert _rel(got, want) <= GRID_RTOL


def test_kernel_branch_all_occupations_zero(walk_route):
    centers, alphas, lmn, C = _basis(11)
    geo = _geometry(12, (9, 8, 10), False)
    got = TG.density_grid(centers, alphas, C, lmn, occupations=np.zeros(6), device="cpu", **geo)
    (A, _, w), = walk_route
    assert A.shape == (48, 0) and w.shape == (0,)
    assert got.shape == geo["dims"] and not got.any()


# -- the kernel's walk against the unscreened plain version ---------------


@pytest.mark.parametrize(
    "M,two,oriented",
    [(1, False, False), (70, False, True), (150, False, False), (270, False, True),
     (70, True, False), (150, True, True)],
)
def test_brick_walk_matches_unscreened(M, two, oriented):
    """The walk over ρ's bricks with kept primitives only, columns padded
    and in passes (density 256 a pass, transition 128: M = 270 and 150 take
    two), against Φ @ C over every primitive."""
    rng = np.random.RandomState(M + two)
    centers, alphas, lmn, C = _basis(13 + M, K=40, M=2 * M if two else M)
    basis_np = (centers, alphas, lmn)
    A = torch.as_tensor(C[:, :M]).contiguous()
    B = torch.as_tensor(C[:, M:]).contiguous() if two else None
    w = torch.ones(M) if two else torch.as_tensor(rng.uniform(0, 2, M).astype(np.float32))
    geo = _geometry(14, (13, 10, 17), oriented)
    want, mag = _plain(basis_np, A, B, w, geo)
    got = _walk(basis_np, A, B, w, geo)
    _within(got, want, mag, 2 * 40 + M + 8)
    assert float(want.abs().max()) > 0


def test_brick_walk_empty_bricks_are_zero():
    """Primitives near one corner only: the far bricks keep none, and ρ is
    exactly 0 there, as the plain version's (every φ is 0)."""
    centers, alphas, lmn, C = _basis(15, K=12, M=3)
    geo = _geometry(16, (16, 12, 12), False)
    centers = (geo["origin"] + np.float32(0.3)).astype(np.float32) + 0.2 * centers
    alphas = np.full_like(alphas, 20.0)  # reach sqrt(40/20) = 1.4 < the grid's 4.0 × 3.0 × 3.0
    basis_np = (centers, alphas, lmn)
    A, w = torch.as_tensor(C), torch.full((3,), 2.0)
    b = TG._Basis(*basis_np, "cpu")
    pts = TG.grid_points(geo["origin"], geo["voxel"], geo["dims"], None, device="cpu")
    groups = CG.brick_voxels(geo["dims"], brick=CG.RHO_BRICK)
    keep = CG.screen_keep(pts, groups, b.centers, b.exponents)
    empty = ~keep.any(1)
    assert 0 < int(empty.sum()) < groups.shape[0]
    want, mag = _plain(basis_np, A, None, w, geo)
    got = _walk(basis_np, A, None, w, geo)
    vox = groups[empty]
    vox = vox[vox >= 0]
    assert not got[vox].any() and not want[vox].any()
    _within(got, want, mag, 2 * 12 + 3 + 8)


def test_padded_columns():
    A, B, w = torch.randn(5, 70), torch.randn(5, 70), torch.rand(70)
    Ap, Bp, wp = CG.padded_columns(A, B, w)
    assert Ap.shape == (5, 80) and Bp.shape == (5, 80) and wp.shape == (80,)
    assert torch.equal(Ap[:, :70], A) and not Ap[:, 70:].any() and not wp[70:].any()
    assert torch.equal(Bp[:, :70], B) and torch.equal(wp[:70], w)
    A16 = torch.randn(5, 32)
    Aq, Bq, wq = CG.padded_columns(A16, None, w[:32])
    assert Aq is A16 and Bq is None


def test_rho_inputs_are_checked():
    """rho_grid refuses CPU tensors; both take only what the kernel takes."""
    centers, alphas, lmn, C = _basis(17, K=4, M=3)
    b = TG._Basis(centers, alphas, lmn, "cpu")
    tab = CG.prim_table(b.centers, b.exponents, b.lmn)
    grid = CG.grid_block(np.zeros(3), np.ones(3), None)
    A, w = torch.as_tensor(C), torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        CG.rho_grid(tab, A, None, w, grid, (2, 2, 2))
    with pytest.raises(ValueError, match="shape"):
        CG.rho_grid_plain(tab, A[:3], None, w, grid, (2, 2, 2))
    with pytest.raises(ValueError, match="shape"):
        CG.rho_grid_plain(tab, A, A[:, :2], w, grid, (2, 2, 2))
    with pytest.raises(ValueError, match="shape"):
        CG.rho_grid_plain(tab, A, None, w[:2], grid, (2, 2, 2))
    with pytest.raises(TypeError, match="dtype"):
        CG.rho_grid_plain(tab, A.double(), None, w, grid, (2, 2, 2))
    with pytest.raises(ValueError, match="contiguous"):
        CG.rho_grid_plain(tab, torch.as_tensor(C.T.copy()).T, None, w, grid, (2, 2, 2))
    big = torch.zeros((CG.MAX_PRIMITIVES + 1, 8))
    with pytest.raises(ValueError, match="at most"):
        CG.rho_grid_plain(big, torch.zeros((CG.MAX_PRIMITIVES + 1, 1)), None, torch.ones(1),
                          grid, (2, 2, 2))


# -- on the card: the kernel against its plain version -------------------------


def _card(basis_np, A, B, w, geo, dev):
    b = TG._Basis(*basis_np, dev)
    table = CG.prim_table(b.centers, b.exponents, b.lmn)
    grid = CG.grid_block(geo["origin"], geo["voxel"], geo["orientation"])
    t = lambda x: None if x is None else x.to(dev)  # noqa: E731
    return CG.rho_grid(table, t(A), t(B), t(w), grid, geo["dims"]).reshape(-1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "dims,oriented,K,M,two",
    [((21, 18, 23), True, 200, 140, False), ((16, 16, 16), False, 200, 1, False),
     ((13, 10, 17), True, 150, 270, False), ((19, 17, 22), True, 200, 70, True),
     ((9, 24, 7), False, 64, 150, True), ((12, 12, 12), False, 5000, 20, False)],
)
def test_rho_kernel_within_its_bound(cuda, dims, oriented, K, M, two):
    """Tail bricks (no dimension a multiple of 4 in most cases), oriented
    grids, M across passes, the transition mode, and 5,000 primitives (the
    kept list past 48 KB of shared memory): within ρ's float32 bound of the
    unscreened plain version on the card, one launch a call, two runs bit
    for bit."""
    rng = np.random.RandomState(K + M)
    centers, alphas, lmn, C = _basis(K + M, K=K, spread=0.1 * max(dims),
                                     M=2 * M if two else M)
    basis_np = (centers, alphas, lmn)
    A = torch.as_tensor(C[:, :M]).contiguous().to(cuda)
    B = torch.as_tensor(C[:, M:]).contiguous().to(cuda) if two else None
    w = torch.ones(M) if two else torch.as_tensor(rng.uniform(0, 2, M).astype(np.float32))
    w = w.to(cuda)
    geo = _geometry(K, dims, oriented)
    n0 = CG.launches
    got = _card(basis_np, A, B, w, geo, cuda)
    again = _card(basis_np, A, B, w, geo, cuda)
    assert CG.launches == n0 + 2 and torch.equal(got, again)
    b = TG._Basis(*basis_np, cuda)
    pts = TG.grid_points(geo["origin"], geo["voxel"], dims, geo["orientation"], device=cuda)
    phi = b.phi(pts)
    a, pa = phi @ A, phi.abs() @ A.abs()
    bb, pb = (a, pa) if B is None else (phi @ B, phi.abs() @ B.abs())
    want = (a * bb * w[None, :]).sum(1)
    mag = (pa * pb * w.abs()[None, :]).sum(1)
    _within(got, want, mag, 2 * K + M + 8)
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= QM_RTOL * float(want.abs().max())


@pytest.mark.requires_cuda
def test_rho_kernel_empty_bricks_and_no_columns(cuda):
    """Bricks that no primitive reaches are exactly 0; no occupied column
    gives a grid of zeros, in one launch."""
    centers, alphas, lmn, C = _basis(15, K=12, M=3)
    geo = _geometry(16, (16, 12, 12), False)
    centers = (geo["origin"] + np.float32(0.3)).astype(np.float32) + 0.2 * centers
    alphas = np.full_like(alphas, 20.0)
    basis_np = (centers, alphas, lmn)
    got = _card(basis_np, torch.as_tensor(C), None, torch.full((3,), 2.0), geo, cuda)
    want = _walk(basis_np, torch.as_tensor(C), None, torch.full((3,), 2.0), geo)
    assert torch.equal(got.cpu() == 0, want == 0)
    n0 = CG.launches
    zero = TG.density_grid(centers, alphas, C, lmn, occupations=np.zeros(3), device=cuda, **geo)
    assert CG.launches == n0 + 1 and not zero.any()
