"""RDF pair histogram of the port: CSR cell list, the plain all-pairs
version against viamd_tpu (its scatter reference and its Pallas kernel in
interpret mode), and the CUDA kernel against the plain version.

The JAX package is imported inside the parity tests only, so the tests
marked `requires_cuda` collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_rdf.py

Tolerances: histograms are integer counts. Against the JAX package: totals
equal; each bin within 1 count of its scatter reference and within 2 of its
Pallas kernel (fp32 rounding moves a pair across a bin edge when the two
compute a distance in a different order; the Pallas kernel also subtracts
pre-shifted coordinates). Kernel against the plain versions, and the
kernel's walk (`pair_hist_cells_plain`) against the all-pairs version:
identical — all compute every distance with the same float operations in
the same order, and a pair's distance has the same bits both ways round.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.ops import cuda_rdf
from viamd_tpu_torch.ops.neighbors import build_cell_list, cell_ids, choose_grid_r
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import (
    min_image_dist,
    pair_dist_histogram_scatter_idx,
    rdf_normalize,
    sqrt_rn,
    stencil_offsets,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _box_case(L, n, seed, spill=0.0):
    """n atoms uniform in an orthorhombic box of edges L (one number for a
    cube); `spill` pushes some outside [0, L)."""
    rng = np.random.RandomState(seed)
    L = np.broadcast_to(np.asarray(L, np.float64), (3,))
    x = rng.uniform(-spill, L + spill, (n, 3)).astype(np.float32)
    basis = np.diag(L).astype(np.float32)
    inv = np.diag(1.0 / L).astype(np.float32)
    return x, basis, inv


def _selections(n, kind):
    if kind == "same":
        ia = np.arange(n, dtype=np.int32)
        return ia, ia
    # overlapping A≠B (TestPallasRDF's selections): ids 4, 10, … in both
    return (
        np.arange(0, n, 2, dtype=np.int32),
        np.arange(1, n, 3, dtype=np.int32),
    )


def _plain(x, ia, ib, basis, inv, nbins, r_max, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return pair_dist_histogram_scatter_idx(
        t(x), t(ia), t(ib),
        torch.ones(len(ia), device=device), torch.ones(len(ib), device=device),
        t(basis), t(inv), nbins, r_max,
    )


def _cells(x, idx, basis, dims, device="cpu"):
    """CSR cell list of the atoms `idx` of x, as pair_dist_histogram_cl
    builds it: (x, ids, cell_start) in cell order."""
    xs = torch.as_tensor(x, device=device)[torch.as_tensor(idx, device=device).long()]
    ids = torch.as_tensor(idx, device=device)
    box = torch.as_tensor(np.diag(basis).copy(), device=device)
    cl = build_cell_list(xs, box, dims)
    return xs[cl.order].contiguous(), ids[cl.order].contiguous(), cl.cell_start


def _walk(fn, x, ia, ib, basis, inv, dims, nbins, r_max, device="cpu"):
    """fn (pair_hist_cells or its plain walk) on the cell lists of ia and
    ib; one list and the half stencil when they are the same array."""
    a = _cells(x, ia, basis, dims, device)
    b = a if ib is ia else _cells(x, ib, basis, dims, device)
    t = lambda m: torch.as_tensor(m, device=device)  # noqa: E731
    return fn(*a, *b, t(basis), t(inv), dims, nbins, r_max, ib is ia)


def _assert_hist_close(got, want, per_bin):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.sum() == want.sum(), (got.sum(), want.sum())
    assert np.abs(got - want).max() <= per_bin, np.abs(got - want).max()
    assert want.sum() > 0


# -- cell list ------------------------------------------------------------


def test_sqrt_rn_is_correctly_rounded():
    rng = np.random.RandomState(0)
    s = np.concatenate([
        rng.uniform(0, 400, 400_000), rng.uniform(0, 1e-4, 50_000),
        [0.0, 1.0, 2.0, 100.0, 2.0**-126, 3e38],
    ]).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(torch.as_tensor(s)).numpy(), np.sqrt(s))


@pytest.mark.parametrize("L, n, seed", [(26.0, 500, 0), (31.0, 2000, 1)])
def test_cell_list_matches_numpy_bincount(L, n, seed):
    x, basis, _ = _box_case(L, n, seed, spill=1.5)
    dims, _ = choose_grid_r(np.diag(basis), 5.0, n, radius=1)
    cl = build_cell_list(torch.as_tensor(x), torch.as_tensor(np.diag(basis).copy()), dims)
    # numpy reference: wrap, bin, count, stable sort
    xw = np.mod(x.astype(np.float64), L)
    c3 = np.minimum((xw / L * np.array(dims)).astype(np.int64), np.array(dims) - 1)
    cid = (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]
    counts = np.bincount(cid, minlength=int(np.prod(dims)))
    np.testing.assert_array_equal(
        cl.cell_start.numpy(), np.concatenate([[0], np.cumsum(counts)])
    )
    np.testing.assert_array_equal(cl.order.numpy(), np.argsort(cid, kind="stable"))


def test_cell_ids_match_jax_build_cell_list():
    import jax.numpy as jnp

    from viamd_tpu.ops.neighbors import build_cell_list as j_build

    L, n = 26.0, 700
    x, basis, _ = _box_case(L, n, 3, spill=2.0)
    box = np.diag(basis).copy()
    dims, cap = choose_grid_r(box, 5.0, n, radius=1)
    # the JAX kernel path wraps into [0, box) before build_cell_list
    xw = jnp.asarray(x) - jnp.asarray(box) * jnp.floor(jnp.asarray(x) / box)
    want = np.asarray(j_build(xw, jnp.asarray(box), dims, 4 * cap).cell_of_atom)
    got = cell_ids(torch.as_tensor(x), torch.as_tensor(box), dims).numpy()
    np.testing.assert_array_equal(got, want)


# -- plain version against the JAX package ---------------------------------


@pytest.mark.parametrize("kind", ["same", "overlap"])
@pytest.mark.parametrize("r_max", [5.0, 9.0])
def test_plain_matches_jax_scatter_idx(kind, r_max):
    import jax.numpy as jnp

    from viamd_tpu.ops.rdf import pair_dist_histogram_scatter_idx as j_hist

    x, basis, inv = _box_case(22.0, 600, 4, spill=1.0)
    ia, ib = _selections(600, kind)
    want = j_hist(
        jnp.asarray(x), jnp.asarray(ia), jnp.asarray(ib),
        jnp.ones(len(ia)), jnp.ones(len(ib)),
        jnp.asarray(basis), jnp.asarray(inv), 128, r_max,
    )
    got = _plain(x, ia, ib, basis, inv, 128, r_max)
    _assert_hist_close(got.numpy(), np.asarray(want), per_bin=1)


@pytest.mark.parametrize("kind", ["same", "overlap"])
def test_plain_matches_pallas_interpret(kind):
    """TestPallasRDF's size (L 26 Å, n 500, radius 1): the caps of the
    Pallas kernel do not bind there."""
    import jax.numpy as jnp

    from viamd_tpu.ops.pallas_rdf import pair_dist_histogram_pl

    L, n, r_max = 26.0, 500, 5.0
    x, basis, inv = _box_case(L, n, 7)
    ia, ib = _selections(n, kind)
    dims, cap = choose_grid_r(np.array([L] * 3), r_max, n, radius=1)
    want = pair_dist_histogram_pl(
        jnp.asarray(x), jnp.asarray(ia), jnp.asarray(ib),
        jnp.asarray([L, L, L], jnp.float32), 128, r_max,
        dims, cap, cap, radius=1, symmetric=(kind == "same"),
        interpret=True, bin_mode="mxu",
    )
    got = _plain(x, ia, ib, basis, inv, 128, r_max)
    _assert_hist_close(got.numpy(), np.asarray(want), per_bin=2)


def test_cl_route_on_cpu_is_the_plain_version():
    x, basis, inv = _box_case(26.0, 500, 8, spill=0.5)
    ia, ib = _selections(500, "overlap")
    t = torch.as_tensor
    before = cuda_rdf.launches
    got = cuda_rdf.pair_dist_histogram_cl(
        t(x), t(ia), t(ib), t(basis), t(inv), 128, 5.0, (5, 5, 5)
    )
    np.testing.assert_array_equal(
        got.numpy(), _plain(x, ia, ib, basis, inv, 128, 5.0).numpy()
    )
    assert cuda_rdf.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the kernel wrapper: CPU tensors raise."""
    z3 = torch.zeros((4, 3))
    zi = torch.zeros(4, dtype=torch.int32)
    starts = torch.zeros(28, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rdf.pair_hist_cells(
            z3, zi, starts, z3, zi, starts, torch.eye(3), torch.eye(3),
            (3, 3, 3), 128, 5.0,
        )


def test_stencil_and_normalize_match_jax():
    import jax.numpy as jnp

    from viamd_tpu.ops import rdf as j_rdf

    for radius in (1, 2):
        for sym in (False, True):
            assert stencil_offsets(radius, sym) == j_rdf.stencil_offsets(radius, sym)
    h = np.random.RandomState(9).poisson(50.0, 128).astype(np.float32)
    want = j_rdf.rdf_normalize(jnp.asarray(h), 120.0, 90.0, 8000.0, 10.0, 4)
    got = rdf_normalize(torch.as_tensor(h), 120.0, 90.0, 8000.0, 10.0, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- the kernel's walk in plain torch (pair_hist_cells_plain) -------------------


def _walk_case(name):
    """(x, basis, inv, dims, r_max, nbins) of the kernel-walk cases."""
    if name == "aniso":  # an axis of exactly 3 cells: the half stencil's wrap
        x, basis, inv = _box_case((15.6, 20.4, 31.2), 500, 12, spill=0.5)
        return x, basis, inv, (3, 4, 6), 5.0, 128
    if name == "sparse":  # mostly empty and one-atom cells
        x, basis, inv = _box_case(60.0, 60, 13)
        return x, basis, inv, (6, 6, 6), 10.0, 128
    if name == "dense":  # ~74 atoms a cell; each cell neighbours all 27
        x, basis, inv = _box_case(33.0, 2000, 17, spill=0.5)
        return x, basis, inv, (3, 3, 3), 10.0, 128
    x, basis, inv = _box_case(25.0, 400, 14, spill=4.0 if name == "spill" else 0.0)
    if name == "duplicate":  # atoms at one position, different ids: bin 0
        x[1::9] = x[0::9][: x[1::9].shape[0]]
    nbins = {"nbins1": 1, "nbins4096": 4096}.get(name, 128)
    return x, basis, inv, (5, 5, 5), 5.0, nbins


@pytest.mark.parametrize("kind", ["same", "overlap"])
@pytest.mark.parametrize(
    "case",
    ["cubic", "aniso", "spill", "sparse", "dense", "duplicate", "nbins1", "nbins4096"],
)
def test_cells_plain_matches_all_pairs(case, kind):
    """The kernel's walk (half stencil for one list, full stencil and the id
    test for two) equals the all-pairs specification bin for bin."""
    x, basis, inv, dims, r_max, nbins = _walk_case(case)
    ia, ib = _selections(x.shape[0], kind)
    assert choose_grid_r(np.diag(basis), r_max, len(ia))[0] == dims
    work = {}

    def plain_walk(*args):
        return cuda_rdf.pair_hist_cells_plain(*args, work=work)

    got = _walk(plain_walk, x, ia, ib, basis, inv, dims, nbins, r_max)
    want = _plain(x, ia, ib, basis, inv, nbins, r_max)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.sum() > 0
    if kind == "same":  # every unordered pair of distinct atoms, once
        a = _cells(x, ia, basis, dims)[2]
        occ = (a[1:] - a[:-1]).double().reshape(dims)
        near = sum(torch.roll(occ, o, (0, 1, 2)) for o in stencil_offsets(1))
        assert work["pairs"] == (int((occ * near).sum()) - len(ia)) // 2
        if case == "duplicate":
            assert want[0] > 0
    m = 2 if kind == "same" else 1  # counts per pair the walk bins
    assert want.sum() <= m * work["sqrt"] <= m * work["pairs"]


@pytest.mark.parametrize("r_max", [5.0, 10.0, 12.5, 0.3])
def test_sqrt_reject_bound(r_max):
    """No float32 |o|² above s_hi has a correctly rounded sqrt below r_max,
    and every one at or below it does: the reject changes no bin."""
    s_hi = np.float32(cuda_rdf.sqrt_reject_bound(r_max))
    r = np.float32(r_max)
    centre = np.float32(np.float64(r) ** 2).view(np.int32)
    s = (centre + np.arange(-(1 << 16), 1 << 16, dtype=np.int32)).view(np.float32)
    root = sqrt_rn(torch.as_tensor(s)).numpy()
    above = s > s_hi
    assert above.any() and (~above).any()
    assert (root[above] >= r).all()
    assert (root[~above] < r).all()


@pytest.mark.parametrize("L", [26.0, (15.6, 20.4, 31.2)])
def test_orthorhombic_arithmetic_keeps_the_bits(L):
    """A diagonal basis and its inv_basis_of pass the kernel's orthorhombic
    test (off-diagonals exactly 0, periodic), and the per-axis form it then
    takes, f = d·I_kk; f −= round(f); o = f·B_kk, gives min_image_dist's
    bits: spilled atoms several boxes out, zero and half-box displacements."""
    x, basis, _ = _box_case(L, 300, 15, spill=60.0)
    edge = np.diag(basis)
    x[:4] = [np.zeros(3), edge / 2, -edge / 2, edge]
    b = torch.as_tensor(basis)
    inv = inv_basis_of(b)
    off = ~torch.eye(3, dtype=torch.bool)
    assert bool((b[off] == 0).all() and (inv[off] == 0).all() and (b != 0).any())
    xt = torch.as_tensor(x)
    d = xt[:, None, :] - xt[None, :, :]
    f = d * torch.diagonal(inv)
    o = (f - torch.round(f)) * torch.diagonal(b)
    got = sqrt_rn(o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] + o[..., 2] * o[..., 2])
    want = min_image_dist(xt, xt, b, inv)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_symmetric_needs_one_cell_list():
    z3 = torch.zeros((4, 3))
    zi = torch.zeros(4, dtype=torch.int32)
    starts = torch.zeros(28, dtype=torch.int32)
    for fn in (cuda_rdf.pair_hist_cells, cuda_rdf.pair_hist_cells_plain):
        with pytest.raises(ValueError, match="symmetric"):
            fn(z3, zi, starts, z3.clone(), zi, starts, torch.eye(3), torch.eye(3),
               (3, 3, 3), 128, 5.0, True)


# -- the CUDA kernel (needs the card) ----------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "L, n, r_max, kind, spill, nbins",
    [
        (26.0, 500, 5.0, "same", 0.0, 128),
        (26.0, 500, 5.0, "overlap", 1.0, 128),
        (44.8, 9000, 10.0, "same", 0.5, 128),
        (60.0, 300, 10.0, "overlap", 0.0, 128),  # mostly empty cells
        (60.0, 300, 10.0, "same", 0.0, 128),  # empty A cells
        ((15.6, 20.4, 31.2), 700, 5.0, "same", 0.5, 128),  # dims (3, 4, 6)
        ((15.6, 20.4, 31.2), 700, 5.0, "overlap", 0.5, 128),
        (26.0, 500, 5.0, "same", 0.0, 4096),
        (26.0, 500, 5.0, "overlap", 0.0, 1),
        (33.0, 40000, 10.0, "same", 0.5, 128),  # dense: chunked A and B
        (33.0, 60000, 10.0, "overlap", 0.5, 128),
    ],
)
def test_kernel_matches_plain(cuda, L, n, r_max, kind, spill, nbins):
    """Through the route (half stencil when one index tensor serves both
    sides) against the all-pairs version, and on prebuilt cell lists
    against the kernel's walk in plain torch: equal bin for bin."""
    x, basis, inv = _box_case(L, n, 11, spill=spill)
    ia, ib = _selections(n, kind)
    dims, _ = choose_grid_r(np.diag(basis), r_max, n, radius=1)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    ia_t = t(ia)
    ib_t = ia_t if kind == "same" else t(ib)
    before = cuda_rdf.launches
    got = cuda_rdf.pair_dist_histogram_cl(
        t(x), ia_t, ib_t, t(basis), t(inv), nbins, r_max, dims
    )
    torch.cuda.synchronize()
    assert cuda_rdf.launches == before + 1
    want = _plain(x, ia, ib, basis, inv, nbins, r_max, device=cuda)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert want.sum() > 0
    got = _walk(cuda_rdf.pair_hist_cells, x, ia, ib, basis, inv, dims, nbins, r_max, cuda)
    want = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ib, basis, inv, dims, nbins, r_max, cuda)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if L == 60.0:
        a_start = _cells(x, ia, basis, dims)[2]
        assert bool((a_start[1:] == a_start[:-1]).any())
    if L == 33.0:
        # the kernel's chunk loops run more than once: a cell holds more A
        # atoms than a block's 256 threads × 2, and each of the at most 16
        # parts of a cell's stencil atoms is longer than one 1,024-atom
        # staging pass
        occ = lambda idx: np.diff(_cells(x, idx, basis, dims)[2].numpy()).reshape(dims)  # noqa: E731
        occ_b = occ(ib)
        stencil = stencil_offsets(1, symmetric=kind == "same")
        part_b = sum(np.roll(occ_b, [-k for k in o], (0, 1, 2)) for o in stencil)
        assert occ(ia).min() > 2 * 256 and part_b.min() // 16 > 1024


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["same", "overlap"])
def test_kernel_general_basis_matches_walk(cuda, kind):
    """A skewed basis takes the kernel's general 3x3 path; on the same cell
    lists it equals the plain walk bin for bin."""
    x, basis, _ = _box_case(26.0, 500, 16, spill=1.0)
    basis[1, 0] = 3.0
    inv = np.linalg.inv(basis.astype(np.float64)).astype(np.float32)
    ia, ib = _selections(500, kind)
    if kind == "same":
        ib = ia
    args = (x, ia, ib, basis, inv, (5, 5, 5), 128, 5.0, cuda)
    got = _walk(cuda_rdf.pair_hist_cells, *args)
    want = _walk(cuda_rdf.pair_hist_cells_plain, *args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert want.sum() > 0


@pytest.mark.requires_cuda
def test_kernel_wrapper_checks_inputs(cuda):
    z3 = torch.zeros((4, 3), device=cuda)
    zi = torch.zeros(4, dtype=torch.int32, device=cuda)
    starts = torch.zeros(28, dtype=torch.int32, device=cuda)
    eye = torch.eye(3, device=cuda)
    with pytest.raises(TypeError):
        cuda_rdf.pair_hist_cells(
            z3, zi.long(), starts, z3, zi, starts, eye, eye, (3, 3, 3), 128, 5.0
        )
    with pytest.raises(ValueError):
        cuda_rdf.pair_hist_cells(
            z3, zi, starts, z3, zi, starts, eye, eye, (2, 3, 3), 128, 5.0
        )
    with pytest.raises(ValueError, match="symmetric"):
        cuda_rdf.pair_hist_cells(
            z3, zi, starts, z3.clone(), zi, starts, eye, eye, (3, 3, 3), 128, 5.0, True
        )
