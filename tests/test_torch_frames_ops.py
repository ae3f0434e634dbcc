"""The port's frame-batch accumulators, ops/rdf.py::rdf_frames and
ops/sdf.py::sdf_frames, against viamd_tpu's on the same seeded numpy frames.

Tolerances.
- rdf_frames: totals equal; each bin within 2 counts of the JAX
  histogram. The JAX function bins by comparing each distance with the
  bin edges (its dense compare-CDF pair_dist_histogram), the port by
  int(dist·nbins/r_max) over a min-image computed in another order, so a
  distance within rounding of an edge can land in the neighbouring bin
  (ROADMAP "Bin edges"); the count moves, the total does not. Measured:
  equal bin for bin on these frames.
- sdf_frames: rtol 1e-5 and atol 2e-5 of the largest |value|, as
  tests/test_torch_sdf.py holds the single-frame routes: each point goes
  through the Kabsch rotation and the min-image, which both packages
  compute to ~1e-7 relative but not bit for bit, and a position error δ
  moves a tent weight by δ / voxel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viamd_tpu.ops import rdf as j_rdf
from viamd_tpu.ops import sdf as j_sdf
from viamd_tpu_torch.ops import rdf as t_rdf
from viamd_tpu_torch.ops import sdf as t_sdf

# a 5-atom molecule with well-separated principal extents (test_torch_sdf.py's)
_MOLECULE = np.array(
    [[-1.9, 0.1, 0.0], [2.1, -0.1, 0.1], [0.1, -1.0, 0.0], [0.0, 1.1, -0.1],
     [0.0, 0.0, 0.55]]
)


def _cells(L, F, seed, per_frame):
    """(F, 3, 3) bases and inverses: the cube L, or a box breathing ±3% per
    frame when `per_frame`; (3, 3) when not."""
    if not per_frame:
        b = np.diag([L] * 3).astype(np.float32)
        return b, np.diag(1.0 / np.diag(b)).astype(np.float32)
    s = 1.0 + 0.03 * np.random.RandomState(seed).uniform(-1, 1, (F, 3))
    b = np.stack([np.diag(L * si) for si in s]).astype(np.float32)
    inv = np.stack([np.diag(1.0 / np.diag(bi)) for bi in b]).astype(np.float32)
    return b, inv


def _assert_hist_close(got, want, per_bin):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert want.sum() > 0
    assert got.sum() == want.sum(), (got.sum(), want.sum())
    assert np.abs(got - want).max() <= per_bin, np.abs(got - want).max()


@pytest.mark.parametrize(
    "weights,per_frame",
    [("ones", False), ("ones", True), ("overlap", False), ("weighted", True)],
)
def test_rdf_frames_matches_jax(weights, per_frame):
    """TestRDF::test_ideal_gas_gr's frames (5 × 400 atoms uniform in a 20 Å
    cube, 20 bins to 8 Å), with overlapping A ≠ B selections, integer
    weights and a basis a frame."""
    rng = np.random.RandomState(0)
    L, F, n, nbins, r_max = 20.0, 5, 400, 20, 8.0
    x = rng.uniform(0, L, (F, n, 3)).astype(np.float32)
    w_a = np.ones(n, np.float32)
    w_b = np.ones(n, np.float32)
    if weights == "overlap":
        w_a[1::2] = 0.0
        w_b[::3] = 0.0
    elif weights == "weighted":
        w_a = rng.randint(0, 3, n).astype(np.float32)
        w_b = rng.randint(0, 3, n).astype(np.float32)
    basis, inv = _cells(L, F, 1, per_frame)
    want = j_rdf.rdf_frames(jnp.asarray(x), jnp.asarray(w_a), jnp.asarray(w_b),
                            jnp.asarray(basis), jnp.asarray(inv), nbins, r_max, tile=128)
    t = torch.as_tensor
    got = t_rdf.rdf_frames(t(x), t(w_a), t(w_b), t(basis), t(inv), nbins, r_max)
    assert got.shape == (nbins,) and got.dtype == torch.float32
    _assert_hist_close(got.numpy(), np.asarray(want), per_bin=2)


def test_rdf_frames_is_the_sum_of_frames():
    """The batch equals the per-frame route summed in frame order, bit for
    bit, and an empty selection gives zeros."""
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.uniform(0, 15, (3, 200, 3)).astype(np.float32))
    basis = torch.diag(torch.tensor([15.0, 15.0, 15.0]))
    inv = torch.diag(torch.tensor([1 / 15.0] * 3))
    w = torch.ones(200)
    ids = torch.arange(200)
    want = torch.zeros(16)
    for f in range(3):
        want = want + t_rdf.pair_dist_histogram_scatter_idx(x[f], ids, ids, w, w, basis, inv,
                                                            16, 6.0)
    assert torch.equal(t_rdf.rdf_frames(x, w, w, basis, inv, 16, 6.0), want)
    assert not t_rdf.rdf_frames(x, torch.zeros(200), w, basis, inv, 16, 6.0).any()


def _sdf_frames_case(L, n, n_struct, F, seed):
    """F frames of n atoms in an L-cube: the first 5·n_struct atoms form
    whole molecules (reference coordinates from frame 0, later frames
    jittered 0.1 Å), half the atoms are targets."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(0, L, (n, 3))
    for i in range(n_struct):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        x0[i * 5 : i * 5 + 5] = x0[i * 5] + _MOLECULE @ q.T
    x0 = x0.astype(np.float32)
    xs = np.stack([x0 + rng.normal(scale=0.1, size=x0.shape) for _ in range(F)]).astype(
        np.float32)
    structs = [np.arange(i * 5, i * 5 + 5, dtype=np.int32) for i in range(n_struct)]
    idx, w, refc = t_sdf.make_structure_inputs(structs, np.ones(n, np.float32), x0)
    tw = (rng.rand(n) < 0.5).astype(np.float32)
    return xs, tw, idx, w, refc


@pytest.mark.parametrize("per_frame", [False, True])
def test_sdf_frames_matches_jax(per_frame):
    L, F, extent, dims = 24.0, 3, 5.0, 16
    xs, tw, idx, w, refc = _sdf_frames_case(L, 400, 4, F, 5)
    basis, inv = _cells(L, F, 2, per_frame)
    want = np.asarray(j_sdf.sdf_frames(
        jnp.asarray(xs), jnp.asarray(tw), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(refc),
        extent, dims, jnp.asarray(basis), jnp.asarray(inv)))
    t = torch.as_tensor
    got = t_sdf.sdf_frames(t(xs), t(tw), t(idx).long(), t(w), t(refc), extent, dims,
                           t(basis), t(inv)).numpy()
    assert got.shape == (dims, dims, dims) and want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5 * float(np.abs(want).max()))
