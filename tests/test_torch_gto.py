"""The port's GTO grids (viamd_tpu_torch/ops/gto.py) and density topology
(ops/topo.py) against viamd_tpu's on the same seeded numpy inputs; the
oracles are TestGTO and TestTopology (tests/test_ops.py) and
TestChargeTransfer::test_attribution (tests/test_app.py).

The JAX package is imported inside the tests that use it, so the tests
marked `requires_cuda` collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_gto.py

Tolerances.
- Grids (eval_gto, eval_gto_grid, density_grid, transition_density_grid):
  2e-6 of the grid's largest |value|. XLA fuses the JAX package's Φ build
  and rounds its exp and its sums over K in another order than torch's CPU
  kernels; measured up to 4.3e-7 of the largest value on these inputs.
  _ipow is exact (the same products in the same order).
- Voxel centres: 4 ulps of the largest coordinate (the JAX cellmul
  contracts a·b + c on the CPU, the port's is a matmul; measured 1 ulp).
- attribute_grid_to_atoms: the same winners; charges within 1e-6 of the
  largest (the JAX package sums float32 one-hot products per chunk, the
  port in fixed point; measured 8.4e-8).
- overlap_matrix, normalization, critical points and the bond graph:
  exact (numpy copies on the same float64 grid).
- On the card, against the port on the CPU: grids within 1e-5 of the
  largest |value| (CUDA's expf and cuBLAS's sum order against the CPU's);
  winners equal (every distance is a product, a sum and a correctly
  rounded root, the same on both devices); charges within 1e-6 relative;
  two CUDA runs bit-equal.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.io.vlx import Shell, shells_from_label
from viamd_tpu_torch.ops import gto as TG
from viamd_tpu_torch.ops import topo as TT

GRID_RTOL = 2e-6
CUDA_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _basis(seed=0, K=40, M=5):
    """Random primitives up to l + m + n = 4, and M coefficient columns."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(K, 3).astype(np.float32)
    alphas = rng.uniform(0.3, 2.0, K).astype(np.float32)
    lmn = rng.randint(0, 3, (K, 3)).astype(np.int32)
    lmn[lmn.sum(1) > 4] = [1, 1, 2]
    C = rng.randn(K, M).astype(np.float32)
    return centers, alphas, lmn, C


GEOM = dict(origin=np.array([-4.0, -4.5, -3.8], np.float32),
            voxel=np.array([0.4, 0.35, 0.45], np.float32), dims=(20, 18, 22))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jnp(*arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def test_ipow_exact():
    from viamd_tpu.ops import gto as JG

    rng = np.random.RandomState(1)
    base = rng.randn(64, 5).astype(np.float32) * 3
    exp = np.tile(np.arange(5, dtype=np.int32), (64, 1))
    want = np.asarray(JG._ipow(*_jnp(base, exp)))
    got = TG._ipow(torch.as_tensor(base), torch.as_tensor(exp)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("multi", [False, True])
def test_eval_gto(multi):
    from viamd_tpu.ops import gto as JG

    centers, alphas, lmn, C = _basis()
    rng = np.random.RandomState(2)
    pts = (rng.randn(300, 3) * 2).astype(np.float32)
    # a point on a centre and one far away (ar2 over the cutoff)
    pts[0] = centers[3]
    pts[1] = [40.0, 0.0, 0.0]
    coeffs = C if multi else C[:, 0]
    want = np.asarray(JG.eval_gto(*_jnp(pts, centers, alphas, coeffs, lmn)))
    got = TG.eval_gto(pts, centers, alphas, coeffs, lmn, device="cpu").numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= GRID_RTOL
    assert not np.any(got[1]) and not np.any(want[1])


@pytest.mark.parametrize("oriented", [False, True])
def test_grid_points(oriented):
    from viamd_tpu.ops import gto as JG

    R = None
    if oriented:
        R = np.linalg.qr(np.random.RandomState(3).randn(3, 3))[0].astype(np.float32)
    o, v, dims = GEOM["origin"], GEOM["voxel"], GEOM["dims"]
    want = np.asarray(JG.grid_points(*_jnp(o, v), dims, None if R is None else _jnp(R)[0]))
    got = TG.grid_points(o, v, dims, R, device="cpu").numpy()
    assert got.shape == want.shape == (np.prod(dims), 3)
    tol = 4 * np.finfo(np.float32).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= (tol if oriented else 0.0)


@pytest.mark.parametrize("oriented", [False, True])
def test_eval_gto_grid(oriented):
    """An exact tail (the port's) against the JAX package's padded chunks."""
    from viamd_tpu.ops import gto as JG

    centers, alphas, lmn, C = _basis()
    R = np.linalg.qr(np.random.RandomState(4).randn(3, 3))[0].astype(np.float32) \
        if oriented else None
    o, v, dims = GEOM["origin"], GEOM["voxel"], GEOM["dims"]
    want = np.asarray(JG.eval_gto_grid(*_jnp(centers, alphas, C[:, 1], lmn, o, v), dims,
                                       chunk=1024,
                                       orientation=None if R is None else _jnp(R)[0]))
    got = TG.eval_gto_grid(centers, alphas, C[:, 1], lmn, o, v, dims, chunk=1000,
                           orientation=R, device="cpu")
    assert got.shape == dims and got.dtype == torch.float32
    assert _rel(got, want) <= GRID_RTOL


@pytest.mark.parametrize("occ", [None, (2.0, 2.0, 1.0, 0.0, 0.0), (0.0,) * 5])
def test_density_grid(occ):
    """Occupation-0 columns leave the product (the port drops them, the JAX
    package adds 0 · ψ²); all-zero occupations give a zero grid."""
    from viamd_tpu.ops import gto as JG

    centers, alphas, lmn, C = _basis(5)
    o, v, dims = GEOM["origin"], GEOM["voxel"], GEOM["dims"]
    occ_np = None if occ is None else np.asarray(occ, np.float32)
    want = np.asarray(JG.density_grid(*_jnp(centers, alphas, C, lmn, o, v), dims,
                                      occupations=occ_np, chunk=1024))
    got = TG.density_grid(centers, alphas, C, lmn, o, v, dims, occupations=occ_np,
                          chunk=777, device="cpu").numpy()
    if occ == (0.0,) * 5:
        assert not got.any() and not want.any()
        return
    assert (got >= 0).all()
    assert _rel(got, want) <= GRID_RTOL


def test_transition_density_grid():
    from viamd_tpu.ops import gto as JG

    centers, alphas, lmn, C = _basis(6)
    T = np.random.RandomState(7).randn(2, 3).astype(np.float32)
    o, v, dims = GEOM["origin"], GEOM["voxel"], GEOM["dims"]
    want = np.asarray(JG.transition_density_grid(
        *_jnp(centers, alphas, C[:, :2], C[:, 2:]), T, _jnp(lmn)[0], *_jnp(o, v), dims,
        chunk=1024))
    got = TG.transition_density_grid(centers, alphas, C[:, :2], C[:, 2:], T, lmn, o, v, dims,
                                     chunk=1024, device="cpu").numpy()
    assert _rel(got, want) <= GRID_RTOL


def _attribution_inputs(seed=8):
    rng = np.random.RandomState(seed)
    grid = rng.rand(*GEOM["dims"]).astype(np.float32) ** 4
    atoms = rng.uniform(-3, 3, (6, 3)).astype(np.float32)
    radii = rng.uniform(0, 1, 6).astype(np.float32)
    return grid, atoms, radii


@pytest.mark.parametrize("with_radii", [False, True])
def test_attribute_grid_to_atoms(with_radii):
    import jax.numpy as jnp

    from viamd_tpu.ops import gto as JG

    grid, atoms, radii = _attribution_inputs()
    r = radii if with_radii else None
    o, v = GEOM["origin"], GEOM["voxel"]
    want = np.asarray(JG.attribute_grid_to_atoms(
        *_jnp(grid, o, v, atoms), radii=None if r is None else jnp.asarray(r), chunk=1024))
    got = TG.attribute_grid_to_atoms(grid, o, v, atoms, r, chunk=1000, device="cpu").numpy()
    assert got.shape == (6,)
    assert _rel(got, want) <= 1e-6
    # the winners: each atom's charge is the sum over its own voxels
    win = TG.grid_winners(grid.shape, o, v, atoms, r, device="cpu").numpy()
    vol = np.float32(v[0] * v[1] * v[2])
    per = np.bincount(win, weights=grid.reshape(-1).astype(np.float64) * vol, minlength=6)
    np.testing.assert_allclose(got, per, rtol=1e-6)


def test_attribution_ties_and_radii():
    """tests/test_app.py::TestChargeTransfer::test_attribution, and voxels
    equidistant from two atoms (x = 3.5 between atoms at 1.5 and 5.5) go
    to the first atom in both packages."""
    import jax.numpy as jnp

    from viamd_tpu.ops import gto as JG

    grid = np.ones((8, 8, 8), np.float32)
    for atoms in ([[2.0, 4.0, 4.0], [6.0, 4.0, 4.0]], [[1.5, 4.0, 4.0], [5.5, 4.0, 4.0]]):
        atoms = np.asarray(atoms, np.float32)
        for radii in (None, np.array([0.0, 2.5], np.float32)):
            want = np.asarray(JG.attribute_grid_to_atoms(
                jnp.asarray(grid), jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32),
                jnp.asarray(atoms), radii=None if radii is None else jnp.asarray(radii)))
            got = TG.attribute_grid_to_atoms(grid, np.zeros(3), np.ones(3), atoms, radii,
                                             device="cpu").numpy()
            np.testing.assert_array_equal(got, want)
            assert got.sum() == 512.0
    # the tie plane (x index 3) is atom 0's
    win = TG.grid_winners((8, 8, 8), np.zeros(3), np.ones(3),
                          np.array([[1.5, 4, 4], [5.5, 4, 4]], np.float32), device="cpu")
    assert int((win.reshape(8, 8, 8)[3] == 0).sum()) == 64


def _test_shells():
    a, b, d = 0.7, 0.7, 1.4
    return [
        Shell(np.array([0, 0, 0], np.float32), 0, np.array([a], np.float32),
              np.array([1.0], np.float32)),
        Shell(np.array([d, 0, 0], np.float32), 0, np.array([b], np.float32),
              np.array([1.0], np.float32)),
        Shell(np.zeros(3, np.float32), 1, np.array([0.9], np.float32),
              np.array([1.0], np.float32)),
        Shell(np.zeros(3, np.float32), 2, np.array([1.3], np.float32),
              np.array([1.0], np.float32)),
        Shell(np.array([0.3, -0.2, 0.5], np.float32), 3, np.array([0.8, 0.25], np.float32),
              np.array([0.6, 0.5], np.float32)),
    ]


@pytest.mark.parametrize("which", ["TestGTO", "6-31G water"])
def test_overlap_matrix_and_normalization_exact(which):
    from viamd_tpu.io import vlx as JV
    from viamd_tpu.ops import gto as JG

    if which == "TestGTO":
        shells = _test_shells()
    else:
        coords = np.array([[0.0, 0.0, 0.226], [0.0, 1.443, -0.904], [0.0, -1.443, -0.904]])
        shells = shells_from_label("6-31G", coords, np.array([8, 1, 1]))
    jshells = [JV.Shell(s.center, s.angular, s.exponents, s.contraction) for s in shells]
    got = TG.overlap_matrix(shells)
    np.testing.assert_array_equal(got, JG.overlap_matrix(jshells))
    np.testing.assert_allclose(np.diag(got)[:2], 1.0, atol=1e-6)
    for alpha in (0.13, 0.8, 5.4, 71.6):
        for lmn in ((0, 0, 0), (1, 0, 0), (2, 1, 0), (1, 1, 1), (0, 0, 3), (2, 2, 0)):
            assert TG.normalization(alpha, *lmn) == JG.normalization(alpha, *lmn)


def _two_blobs(D=24):
    ax = np.arange(D) + 0.5
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = np.exp(-((X - 8.2) ** 2 + (Y - 12.1) ** 2 + (Z - 11.8) ** 2) / 16.0)
    g += np.exp(-((X - 16.3) ** 2 + (Y - 12.1) ** 2 + (Z - 11.8) ** 2) / 16.0)
    return g.astype(np.float32)


def _density_of_h4():
    """A port density grid with maxima, saddles and plateaus: four s
    shells on a square."""
    pts = np.array([[0, 0, 0], [2.6, 0, 0], [0, 2.6, 0], [2.6, 2.6, 0]], np.float32)
    C = np.array([[1.0], [1.0], [1.0], [1.0]], np.float32) * 0.5
    return TG.density_grid(pts, np.full(4, 1.0, np.float32), C, np.zeros((4, 3), np.int32),
                           np.array([-4.0, -4.0, -4.0], np.float32),
                           np.full(3, 10.6 / 24, np.float32), (24, 24, 24),
                           device="cpu").numpy()


@pytest.mark.parametrize("grid_of", ["two blobs", "H4 density"])
def test_topology_exact(grid_of):
    from viamd_tpu.ops import topo as JT

    g = _two_blobs() if grid_of == "two blobs" else _density_of_h4()
    origin, vox = np.array([-1.0, 0.5, 2.0]), np.array([0.5, 0.5, 0.25])
    got = TT.critical_points(g, origin, vox, min_value=1e-3)
    want = JT.critical_points(g, origin, vox, min_value=1e-3)
    assert [(p.kind, p.index, p.value) for p in got] == \
        [(p.kind, p.index, p.value) for p in want]
    assert all(np.array_equal(a.position, b.position) for a, b in zip(got, want))
    assert sum(p.kind == "max" for p in got) >= 2
    for frac in (0.1, 0.5):
        assert TT.bond_graph(got, g, origin, vox, threshold_frac=frac) == \
            JT.bond_graph(want, g, origin, vox, threshold_frac=frac)
    assert TT.bond_graph(got, g, origin, vox, threshold_frac=0.1)


# -- on the card, against the port on the CPU ---------------------------------


@pytest.mark.requires_cuda
def test_grids_cuda_match_cpu(cuda):
    centers, alphas, lmn, C = _basis(9)
    o, v, dims = GEOM["origin"], GEOM["voxel"], GEOM["dims"]
    R = np.linalg.qr(np.random.RandomState(10).randn(3, 3))[0].astype(np.float32)
    T = np.random.RandomState(11).randn(2, 3).astype(np.float32)
    occ = np.array([2.0, 2.0, 1.0, 0.0, 0.5], np.float32)
    for fn in (
        lambda d: TG.eval_gto_grid(centers, alphas, C[:, 0], lmn, o, v, dims,
                                   orientation=R, device=d),
        lambda d: TG.density_grid(centers, alphas, C, lmn, o, v, dims, occupations=occ,
                                  chunk=1000, device=d),
        lambda d: TG.transition_density_grid(centers, alphas, C[:, :2], C[:, 2:], T, lmn,
                                             o, v, dims, device=d),
    ):
        want = fn("cpu").numpy()
        got = fn(cuda).cpu().numpy()
        assert _rel(got, want) <= CUDA_RTOL


@pytest.mark.requires_cuda
def test_attribution_cuda_match_cpu_and_repeat(cuda):
    grid, atoms, radii = _attribution_inputs(12)
    o, v = GEOM["origin"], GEOM["voxel"]
    w_cpu = TG.grid_winners(grid.shape, o, v, atoms, radii, device="cpu")
    w_gpu = TG.grid_winners(grid.shape, o, v, atoms, radii, device=cuda)
    assert torch.equal(w_gpu.cpu(), w_cpu)
    q_cpu = TG.attribute_grid_to_atoms(grid, o, v, atoms, radii, device="cpu").numpy()
    q1 = TG.attribute_grid_to_atoms(grid, o, v, atoms, radii, device=cuda).cpu().numpy()
    q2 = TG.attribute_grid_to_atoms(grid, o, v, atoms, radii, device=cuda).cpu().numpy()
    np.testing.assert_array_equal(q1, q2)
    assert _rel(q1, q_cpu) <= 1e-6
