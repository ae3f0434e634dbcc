"""SDF path of the port against viamd_tpu on the CPU: the trilinear splat,
the per-structure reference frames, the pairs route with its two capacity
cuts (per-structure `pair_cap`, global `compact_cap`) and the copied sizers.

Tolerances. The splat alone: rtol 1e-5 and atol 1e-6 · max|grid| (float32
sums taken in a different order: the JAX package's tent matmul vs the port's
scatter-add). The whole pairs route: rtol 1e-5 and atol 2e-5 · max|grid|:
there each point first goes through the Kabsch rotation and the min-image,
which both packages compute to ~1e-7 relative but not bit-identically, and a
position error δ moves a tent weight by δ / voxel (~1e-6 per point at
8 Å and 0.6 Å voxels, summed over the points of a voxel). Where a capacity
binds, the same points must be dropped: a different choice would move whole
points (errors ~1, not ~1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viamd_tpu.ops import density as j_density
from viamd_tpu.ops import sdf as j_sdf
from viamd_tpu_torch.ops import density as t_density
from viamd_tpu_torch.ops import sdf as t_sdf


ROUTE_ATOL = 2e-5  # × max|grid|, see the module docstring


def _close_grid(got, want, atol_rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=atol_rel * float(np.abs(want).max())
    )


@pytest.mark.parametrize("dims", [(16, 16, 16), (8, 12, 10)])
def test_splat_trilinear_matches_jax(dims):
    rng = np.random.RandomState(1)
    n = 3000
    origin = np.float32([-5.0, -6.0, -4.0])
    voxel = np.float32([0.625, 0.5, 0.8])
    # inside, straddling and outside the grid, plus non-finite points
    pts = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    pts[:5] = [np.nan, 0, 0]
    pts[5:8] = [np.inf, 1.0, -1.0]
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    want = j_density.splat_trilinear(
        jnp.asarray(pts), jnp.asarray(w), dims, jnp.asarray(origin),
        jnp.asarray(voxel),
    )
    got = t_density.splat_trilinear(
        torch.as_tensor(pts), torch.as_tensor(w), dims,
        torch.as_tensor(origin), torch.as_tensor(voxel),
    )
    _close_grid(got, want)
    assert np.isfinite(got.numpy()).all() and got.sum() > 0


def test_compact_first_keeps_the_first_set_entries():
    rng = np.random.RandomState(2)
    m = rng.rand(5, 300) < 0.3
    m[3] = False  # a row with nothing set
    for cap in (7, 64, 400):
        src, keep = t_sdf.compact_first(torch.as_tensor(m), cap)
        for r in range(5):
            pos = np.nonzero(m[r])[0][:cap]
            k = keep[r].numpy()
            assert k.sum() == len(pos) and k[: len(pos)].all()
            np.testing.assert_array_equal(src[r].numpy()[: len(pos)], pos)


# a 5-atom molecule with well-separated principal extents: its Kabsch
# rotation is well conditioned, so both packages find it to ~1e-6
_MOLECULE = np.array(
    [[-1.9, 0.1, 0.0], [2.1, -0.1, 0.1], [0.1, -1.0, 0.0], [0.0, 1.1, -0.1],
     [0.0, 0.0, 0.55]]
)


def _sdf_case(L, n, n_struct, seed, tw_frac=0.5):
    """n atoms in an L-cube; the first 5·n_struct form whole molecules
    (those near a face stick out of the box), the reference structures,
    with reference coordinates from frame 0. Returns frame 1 (frame 0 +
    0.1 Å jitter) and the inputs; a random `tw_frac` of atoms are targets."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(0, L, (n, 3))
    for i in range(n_struct):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        x0[i * 5 : i * 5 + 5] = x0[i * 5] + _MOLECULE @ q.T
    x0 = x0.astype(np.float32)
    x = (x0 + rng.normal(scale=0.1, size=x0.shape)).astype(np.float32)
    structs = [
        np.arange(i * 5, i * 5 + 5, dtype=np.int32) for i in range(n_struct)
    ]
    # unit weights keep HᵀH's spectrum narrow: the closed-form Kabsch is
    # then accurate to ~1e-7 in float32 in both packages (heavy-atom
    # weights spread it, and both drift from the exact rotation by ~1e-4)
    masses = np.ones(n, np.float32)
    idx, w, refc = t_sdf.make_structure_inputs(structs, masses, x0)
    tw = (rng.rand(n) < tw_frac).astype(np.float32)
    idx_t = np.nonzero(tw)[0].astype(np.int32)
    basis = np.diag([L] * 3).astype(np.float32)
    inv = np.diag([1.0 / L] * 3).astype(np.float32)
    return x, tw, idx, w, refc, idx_t, basis, inv, structs, masses, x0


def test_structure_inputs_and_reference_frames_match_jax():
    x, tw, idx, w, refc, idx_t, basis, inv, structs, masses, x0 = _sdf_case(
        24.0, 600, 6, 3
    )
    j_idx, j_w, j_refc = j_sdf.make_structure_inputs(structs, masses, x0)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(w, j_w)
    np.testing.assert_array_equal(refc, j_refc)
    jR, jc = j_sdf.sdf_reference_frames(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(refc),
        jnp.asarray(basis), jnp.asarray(inv),
    )
    tR, tc = t_sdf.sdf_reference_frames(
        torch.as_tensor(x), torch.as_tensor(idx).long(), torch.as_tensor(w),
        torch.as_tensor(refc), torch.as_tensor(basis), torch.as_tensor(inv),
    )
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def test_sizers_are_copies():
    x, tw, idx, w, refc, idx_t, basis, inv, *_ = _sdf_case(24.0, 600, 4, 4)
    box = np.diag(basis).copy()
    args = (x[idx_t], x, idx, w, box, 5.0, 16)
    assert t_sdf.sdf_frame0_ball_count(*args) == j_sdf.sdf_frame0_ball_count(*args)
    sargs = (x[idx_t], x, idx, w, refc, box, 5.0, 16)
    assert t_sdf.sdf_frame0_support_count(*sargs) == j_sdf.sdf_frame0_support_count(*sargs)
    for fn in ("sdf_pair_capacity", "sdf_compact_capacity"):
        assert getattr(t_sdf, fn)(4, idx_t.size, box, 5.0, 16) == getattr(
            j_sdf, fn
        )(4, idx_t.size, box, 5.0, 16)


def _pairs_both(case, extent, dims, pair_cap, compact_cap):
    x, tw, idx, w, refc, idx_t, basis, inv, *_ = case
    jpairs = jax.jit(
        lambda *a: j_sdf.sdf_accumulate_pairs(
            *a[:5], extent, dims, *a[5:], pair_cap, compact_cap=compact_cap
        )
    )
    want = jpairs(
        jnp.asarray(x), jnp.asarray(tw), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(refc), jnp.asarray(basis), jnp.asarray(inv),
        jnp.asarray(idx_t),
    )
    t = torch.as_tensor
    got = t_sdf.sdf_accumulate_pairs(
        t(x), t(tw), t(idx).long(), t(w), t(refc), extent, dims, t(basis),
        t(inv), t(idx_t).long(), pair_cap, compact_cap=compact_cap,
    )
    return got.numpy(), np.asarray(want)


def _sized_caps(case, extent, dims):
    x, tw, idx, w, refc, idx_t, basis, inv, structs, *_ = case
    box = np.diag(basis).copy()
    cnt0 = t_sdf.sdf_frame0_ball_count(x[idx_t], x, idx, w, box, extent, dims)
    pair_cap = t_sdf.sdf_pair_capacity(
        len(structs), idx_t.size, box, extent, dims, per_struct_count=cnt0
    )
    sup0 = t_sdf.sdf_frame0_support_count(
        x[idx_t], x, idx, w, refc, box, extent, dims
    )
    compact_cap = t_sdf.sdf_compact_capacity(
        len(structs), idx_t.size, box, extent, dims, support_count=sup0
    )
    return pair_cap, compact_cap


@pytest.mark.parametrize(
    "caps",
    ["sized", "sized_no_compaction", "pair_cap_binds", "compact_cap_binds"],
)
def test_pairs_route_matches_jax(caps):
    case = _sdf_case(24.0, 600, 4, 11)
    extent, dims = 5.0, 16
    pair_cap, compact_cap = _sized_caps(case, extent, dims)
    if caps == "sized_no_compaction":
        compact_cap = None
    elif caps == "pair_cap_binds":
        pair_cap, compact_cap = 16, None  # < the ~40 in-ball targets
    elif caps == "compact_cap_binds":
        compact_cap = 40  # < the ~150 in-support points
    got, want = _pairs_both(case, extent, dims, pair_cap, compact_cap)
    _close_grid(got, want, atol_rel=ROUTE_ATOL)
    assert got.sum() > 0
    if caps.endswith("binds"):
        full, _ = _pairs_both(case, extent, dims, *_sized_caps(case, extent, dims))
        assert got.sum() < full.sum() - 1e-3  # the cap really dropped points


def test_pairs_route_saturated_blocks():
    """test_pairs_rank_select_saturated_blocks' case: every target inside
    every structure's ball (whole 128-lane blocks of the JAX rank select
    saturate), cap == n — nothing may be dropped or duplicated."""
    case = _sdf_case(8.0, 640, 3, 5, tw_frac=1.1)
    got, want = _pairs_both(case, 8.0, 8, 640, None)
    _close_grid(got, want, atol_rel=ROUTE_ATOL)
    assert got.sum() > 0


def test_fixed_point_sum_is_order_free():
    """The splat's fixed-point sum: the same float32 grid for any order of
    the terms, equal to the exactly rounded float64 sum where every term is
    a multiple of its step, and within one step per term otherwise."""
    rng = np.random.RandomState(4)
    n, m = 50, 20_000
    flat = rng.randint(0, n, m)
    wts = rng.uniform(0.0, 1.0, m).astype(np.float32)
    got = t_density.fixed_point_sum(n, torch.as_tensor(flat), torch.as_tensor(wts))
    perm = rng.permutation(m)
    again = t_density.fixed_point_sum(n, torch.as_tensor(flat[perm]), torch.as_tensor(wts[perm]))
    assert torch.equal(got, again) and got.dtype == torch.float32
    exact = np.zeros(n)
    np.add.at(exact, flat, wts.astype(np.float64))
    bits = min(40, 62 - m.bit_length())
    step = np.bincount(flat, minlength=n) * 2.0**-bits  # one step a term
    assert (np.abs(got.numpy() - exact) <= step + 1e-7 * exact).all()
    coarse = (np.round(wts * 2.0**bits) / 2.0**bits).astype(np.float64)
    want = np.zeros(n)
    np.add.at(want, flat, coarse)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
