"""The RDF routes of the port beyond the orthorhombic cell list: the
triclinic cell list (fractional cells, the kernel's general min-image), the
radius-2 cell list of boxes under 3 cutoffs across (cells half the cutoff
wide, ±2 cells), the dense all-pairs route (aperiodic, small), the route
names against the JAX compiler's conditions, and the grid the Evaluator
sizes for boxes that shrink (a frame-0 grid loses pairs there).

The JAX package is imported inside the parity tests only, so the tests
marked `requires_cuda` collect on a machine with a GPU and no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_rdf_routes.py

Tolerances. The kernel's walk (`pair_hist_cells_plain`) and the kernel
against the all-pairs version: identical (the same float operations in the
same order; a pair's distance has the same bits both ways round). Against
the JAX package's histogram functions: totals equal, each bin within 1
count of its dense scatter (2 when A == B, where each pair counts twice)
and within 2 of its Pallas kernel (float order moves a pair across a bin
edge). Whole scripts against the JAX Evaluator:
tests/test_torch_slice.py's tolerance (totals within 1e-3 relative, bins
within 2 + 1e-3 relative), since the JAX package's CPU cell-list routes
drop atoms past their per-cell capacities.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.core.system import build_system
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.ops import cuda_rdf
from viamd_tpu_torch.ops.neighbors import choose_grid, choose_grid_r, choose_grid_triclinic
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import pair_dist_histogram_scatter_idx
from viamd_tpu_torch.script import compile_script

NBINS = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rotation():
    """TestPallasRDF::test_triclinic_matches_dense's rigid rotation: every
    basis entry becomes nonzero."""
    th, ph = 0.37, 0.21
    rz = np.array([[np.cos(th), np.sin(th), 0], [-np.sin(th), np.cos(th), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(ph), np.sin(ph)], [0, -np.sin(ph), np.cos(ph)]])
    return rz @ rx


def _tri_basis(lengths, angles):
    b = np.asarray(UnitCell.from_lengths_angles(*lengths, *angles).basis, np.float64)
    return (b @ _rotation()).astype(np.float32)


def _inv(basis, device="cpu"):
    """inv_basis_of, as the compiler and the Evaluator compute it (for a
    (F, 3, 3) stack, batched as the Evaluator does)."""
    return inv_basis_of(torch.as_tensor(basis, device=device)).cpu().numpy()


def _atoms(basis, n, seed, spill=0.0):
    """n atoms uniform in the cell (fractional coordinates in [-spill,
    1 + spill))."""
    rng = np.random.RandomState(seed)
    f = rng.uniform(-spill, 1.0 + spill, (n, 3))
    return (f @ basis.astype(np.float64)).astype(np.float32)


# the walk cases: (basis, n, r_max)
CASES = {
    # TestPallasRDF::test_triclinic_matches_dense's cell: dims (5, 4, 5)
    "rotated": (lambda: _tri_basis((30, 28, 26), (80, 95, 60)), 500, 5.0),
    # one axis of exactly 3 cells: the half stencil's wrap
    "three_wide": (lambda: _tri_basis((34, 30, 17.5), (75, 100, 65)), 900, 5.0),
    # a rhombic dodecahedron, the production cell
    "rhombic": (lambda: (22.0 * np.array(
        [[1, 0, 0], [0, 1, 0], [0.5, 0.5, 0.5 ** 0.5]])).astype(np.float32), 700, 5.0),
}


def _selections(n, kind):
    if kind == "same":
        ia = np.arange(n, dtype=np.int32)
        return ia, ia
    return np.arange(0, n, 2, dtype=np.int32), np.arange(1, n, 3, dtype=np.int32)


def _all_pairs(x, ia, ib, basis, inv, r_max, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return pair_dist_histogram_scatter_idx(
        t(x), t(ia), t(ib), torch.ones(len(ia), device=device),
        torch.ones(len(ib), device=device), t(basis), t(inv), NBINS, r_max,
    )


def _walk(fn, x, ia, ib, basis, inv, dims, r_max, device="cpu", work=None,
          fractional=True, radius=1):
    """`fn` (the kernel or its walk) on the cell lists the route builds
    (fractional by default)."""
    t = lambda m: torch.as_tensor(m, device=device)  # noqa: E731
    cells = lambda idx: cuda_rdf.cell_lists(  # noqa: E731
        t(x), t(idx), t(basis), t(inv), dims, fractional)
    a = cells(ia)
    b = a if ib is ia else cells(ib)
    kw = {} if work is None else {"work": work}
    return fn(*a, *b, t(basis), t(inv), dims, NBINS, r_max, ib is ia, radius, **kw)


def _close(got, want, per_bin):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.sum() == want.sum() > 0, (got.sum(), want.sum())
    assert np.abs(got - want).max() <= per_bin, np.abs(got - want).max()


def _close_script(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.sum() > 0 and abs(got.sum() - want.sum()) <= 1e-3 * want.sum()
    assert (np.abs(got - want) <= 2 + 1e-3 * want).all(), np.abs(got - want).max()


# -- the triclinic cell list -------------------------------------------------


@pytest.mark.parametrize("kind", ["same", "overlap"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_on_fractional_cells_matches_all_pairs(case, kind):
    """The kernel's walk over fractional cell lists (half stencil for one
    list, full stencil and the id test for two) equals the all-pairs
    specification bin for bin, with atoms spilled outside the cell."""
    make, n, r_max = CASES[case]
    basis = make()
    inv = _inv(basis)
    x = _atoms(basis, n, 21, spill=0.3)
    ia, ib = _selections(n, kind)
    dims, _ = choose_grid_triclinic(basis, r_max, len(ia))
    assert min(dims) >= 3 and (case != "three_wide" or min(dims) == 3), dims
    work = {}
    got = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ib, basis, inv, dims, r_max,
                work=work)
    want = _all_pairs(x, ia, ib, basis, inv, r_max)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.sum() > 0 and work["pairs"] >= want.sum() / (2 if kind == "same" else 1)
    # the route on the CPU is the all-pairs version itself
    route = cuda_rdf.pair_dist_histogram_cl(
        *(torch.as_tensor(a) for a in (x, ia, ia if kind == "same" else ib, basis, inv)),
        NBINS, r_max, dims, fractional=True,
    )
    np.testing.assert_array_equal(route.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["same", "overlap"])
def test_triclinic_matches_jax(kind):
    """TestPallasRDF::test_triclinic_matches_dense's cell and atoms, the
    port's plain version against the JAX package's dense scatter and, for
    A == B, its triclinic Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    from viamd_tpu.ops import rdf as j_rdf
    from viamd_tpu.ops.pallas_rdf import pair_dist_histogram_pl

    make, n, r_max = CASES["rotated"]
    basis = make()
    inv = _inv(basis)
    x = _atoms(basis, n, 5)
    ia, ib = _selections(n, kind)
    got = _all_pairs(x, ia, ib, basis, inv, r_max).numpy()
    j = lambda a: jnp.asarray(a)  # noqa: E731
    want = j_rdf.pair_dist_histogram_scatter_idx(
        j(x), j(ia), j(ib), jnp.ones(len(ia)), jnp.ones(len(ib)), j(basis), j(inv),
        NBINS, r_max,
    )
    _close(got, want, per_bin=1)
    if kind == "same":
        dims, cap = choose_grid_triclinic(basis, r_max, n)
        want_pl = pair_dist_histogram_pl(
            j(x), j(ia), j(ia), j(np.diag(basis).copy()), NBINS, r_max, dims, cap, cap,
            radius=1, symmetric=True, interpret=True, basis=j(basis),
        )
        _close(got, want_pl, per_bin=2)


# -- routes through the compiler ---------------------------------------------


def _system(x, basis, z=8):
    """A port System of `x` (all element `z`, one residue each) in a cell."""
    n = len(x)
    return build_system(
        coords=x, atom_names=["A"] * n, res_names=["RES"] * n,
        res_ids=np.arange(1, n + 1), elements_z=np.full(n, z, np.int32),
        cell=UnitCell.from_basis(basis),
    )


def _scene(name):
    """(x0 (n, 3), basis, cutoff) of the route cases."""
    if name == "ortho":  # cell list: a 34.8 Å box, dims (3, 3, 3) at 10 Å
        b = np.diag([34.8] * 3).astype(np.float32)
        return _atoms(b, 4200, 1), b, 10.0
    if name == "triclinic":  # cell list in fractional space
        b = _tri_basis((38, 36, 34), (80, 95, 60))
        return _atoms(b, 4200, 2), b, 8.0
    if name == "triclinic_small_box":  # n ≥ 4096 but under 3 cutoffs across
        b = _tri_basis((30, 28, 26), (80, 95, 60))
        return _atoms(b, 4200, 3), b, 8.0
    if name == "radius2":  # a 27.6 Å box under 3 cutoffs: radius 2, dims 5
        b = np.diag([27.6] * 3).astype(np.float32)
        return _atoms(b, 4200, 4), b, 10.0
    if name == "small":  # n < 4096
        b = np.diag([20.0] * 3).astype(np.float32)
        return _atoms(b, 800, 5), b, 6.0
    b = np.diag([25.0] * 3).astype(np.float32)  # aperiodic: the cell dropped
    return _atoms(b, 600, 6), np.zeros((3, 3), np.float32), 6.0


def _jax_route(x, basis, cutoff):
    """The JAX compiler's RDF route for these conditions
    (viamd_tpu/script/compiler.py:1412-1451), in the port's names."""
    from viamd_tpu.core.unitcell import UnitCell as JCell
    from viamd_tpu.ops.neighbors import choose_grid, choose_grid_r
    from viamd_tpu.ops.neighbors import choose_grid_triclinic as j_tri

    cell, n = JCell.from_basis(basis), len(x)
    if cell.is_periodic and not cell.is_orthorhombic and n >= 4096:
        dims, _ = j_tri(np.asarray(cell.basis, np.float64), cutoff, n, radius=1)
        return "rdf:cell_list_triclinic" if min(dims) >= 3 else "rdf:dense"
    if cell.is_orthorhombic and n >= 4096:
        dims, _ = choose_grid_r(cell.extent(), cutoff, n, radius=1)
        if min(dims) >= 3:
            return "rdf:cell_list"
        dims, _ = choose_grid(cell.extent(), cutoff, n)
        return "rdf:cell_list_r2" if min(dims) >= 5 else "rdf:dense"
    return "rdf:dense"


ROUTES = {
    "ortho": "rdf:cell_list",
    "triclinic": "rdf:cell_list_triclinic",
    "triclinic_small_box": "rdf:dense",
    "radius2": "rdf:cell_list_r2",
    "small": "rdf:dense",
    "aperiodic": "rdf:dense",
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_names_follow_jax_conditions(name):
    x, basis, cutoff = _scene(name)
    ct = compile_script(f"r = rdf(all, all, {cutoff});", _system(x, basis), "cpu")
    assert ct.routes == [ROUTES[name]] == [_jax_route(x, basis, cutoff)]
    if ROUTES[name].startswith("rdf:cell_list"):
        radius = ct.grids[0].radius
        assert radius == (2 if name == "radius2" else 1)
        assert min(ct.grids[0].dims) >= 2 * radius + 1


@pytest.mark.parametrize("name", ["triclinic", "small", "aperiodic"])
def test_script_matches_jax(name):
    """The whole `rdf` through both compilers and Evaluators, two frames
    (the second jittered by 0.1 Å)."""
    from viamd_tpu.core.system import build_system as j_build
    from viamd_tpu.core.unitcell import UnitCell as JCell
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io.trajectory import InMemoryTrajectory
    from viamd_tpu.script import compile_script as j_compile

    x, basis, cutoff = _scene(name)
    rng = np.random.RandomState(9)
    frames = np.stack([x, x + rng.normal(scale=0.1, size=x.shape)]).astype(np.float32)
    cells = np.broadcast_to(basis, (2, 3, 3)).copy()
    src = f"r = rdf(all, element('O'), {cutoff});"
    n = len(x)
    sys_j = j_build(
        coords=x, atom_names=["A"] * n, res_names=["RES"] * n,
        res_ids=np.arange(1, n + 1), elements_z=np.where(np.arange(n) % 3, 8, 6),
        cell=JCell.from_basis(basis),
    )
    from tests._torch_parity import port_system

    ct = compile_script(src, port_system(sys_j), "cpu")
    assert ct.routes == [ROUTES[name]]
    rt = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu")).run()
    cj = j_compile(src, sys_j)
    rj = JEvaluator(cj, InMemoryTrajectory(frames, cells), chunk=2, batch_mode="map").run()
    _close_script(rt.distributions["r"], rj.distributions["r"])
    assert ct.property("r").spec.count_a == cj.property("r").spec.count_a
    assert ct.property("r").spec.count_b == cj.property("r").spec.count_b


def test_radius2_box_goes_dense():
    """A 27.6 Å box at a 10 Å cutoff (under 3 cutoffs across): the route is
    the radius-2 cell list, as the JAX compiler's. Its CPU histogram (the
    all-pairs version) against the JAX package's all-pairs histogram of the
    same frame (the JAX radius-2 CPU route takes minutes on the CPU), and
    the kernel's radius-2 walk on the route's grid against it, exactly."""
    import jax.numpy as jnp

    from viamd_tpu.ops import rdf as j_rdf

    x, basis, cutoff = _scene("radius2")
    assert _jax_route(x, basis, cutoff) == "rdf:cell_list_r2"
    ct = compile_script(f"r = rdf(all, all, {cutoff});", _system(x, basis), "cpu")
    assert ct.routes == ["rdf:cell_list_r2"] and ct.grids[0].dims == (5, 5, 5)
    _, acc = ct.frame_fn(*(torch.as_tensor(a) for a in (x, basis, _inv(basis))))
    ia = np.arange(len(x), dtype=np.int32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    want = j_rdf.pair_dist_histogram_scatter_idx(
        j(x), j(ia), j(ia), jnp.ones(len(ia)), jnp.ones(len(ia)), j(basis),
        j(_inv(basis)), NBINS, cutoff,
    )
    _close(acc["r"].numpy(), want, per_bin=2)  # A == B: a pair counts twice
    walk = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ia, basis, _inv(basis),
                 (5, 5, 5), cutoff, fractional=False, radius=2)
    np.testing.assert_array_equal(walk.numpy(), acc["r"].numpy())


# the radius-2 walk cases: (basis, n, r_max, selections); cells >= r_max / 2
R2_CASES = {
    # exactly 5 cells an axis: the half stencil's wrap covers each axis once
    "ortho_five": (lambda: np.diag([26.0, 27.5, 29.0]).astype(np.float32), 700, 10.0),
    # 5 x 6 x 7 cells
    "ortho_wide": (lambda: np.diag([25.5, 31.0, 36.0]).astype(np.float32), 900, 10.0),
    # fractional cells (skewed frames of an orthorhombic system)
    "fractional": (lambda: _tri_basis((34, 30, 28), (80, 95, 70)), 800, 10.0),
}


@pytest.mark.parametrize("kind", ["same", "overlap"])
@pytest.mark.parametrize("case", sorted(R2_CASES))
def test_radius2_walk_matches_all_pairs(case, kind):
    """The kernel's radius-2 walk (125 cells, or the self cell and 62 upper
    offsets for one list) equals the all-pairs specification bin for bin,
    with atoms spilled outside the cell; at radius 1 the same grid loses
    pairs."""
    make, n, r_max = R2_CASES[case]
    basis = make()
    inv = _inv(basis)
    x = _atoms(basis, n, 41, spill=0.3)
    ia, ib = _selections(n, kind)
    fractional = case == "fractional"
    if fractional:
        dims, _ = choose_grid_triclinic(basis, r_max, len(ia), radius=2)
    else:
        dims, _ = choose_grid(np.diag(basis), r_max, len(ia))
    assert min(dims) == 5 and (case != "ortho_wide" or dims == (5, 6, 7)), dims
    work = {}
    got = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ib, basis, inv, dims, r_max,
                work=work, fractional=fractional, radius=2)
    want = _all_pairs(x, ia, ib, basis, inv, r_max)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.sum() > 0 and work["pairs"] >= want.sum() / (2 if kind == "same" else 1)
    short = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ib, basis, inv, dims, r_max,
                  fractional=fractional, radius=1)
    assert short.sum() < want.sum()
    route = cuda_rdf.pair_dist_histogram_cl(
        *(torch.as_tensor(a) for a in (x, ia, ia if kind == "same" else ib, basis, inv)),
        NBINS, r_max, dims, fractional=fractional, radius=2,
    )
    np.testing.assert_array_equal(route.numpy(), want.numpy())


def test_radius_checks():
    """A radius-2 stencil needs 5 cells an axis (distinct cells, each
    unordered cell pair once); radii other than 1 and 2 raise."""
    x = torch.zeros(4, 3)
    ia = torch.arange(4, dtype=torch.int32)
    b = torch.eye(3) * 20.0
    with pytest.raises(ValueError, match="needs min"):
        cuda_rdf.pair_dist_histogram_cl(x, ia, ia, b, b / 400.0, NBINS, 8.0, (4, 5, 5), radius=2)
    a = cuda_rdf.cell_lists(x, ia, b, b / 400.0, (5, 5, 4))
    with pytest.raises(ValueError, match="needs min"):
        cuda_rdf.pair_hist_cells_plain(*a, *a, b, b / 400.0, (5, 5, 4), NBINS, 8.0, True, 2)
    with pytest.raises(ValueError, match="radius must be"):
        cuda_rdf.pair_dist_histogram_cl(x, ia, ia, b, b / 400.0, NBINS, 8.0, (7, 7, 7), radius=3)


# -- grids that hold for every frame ------------------------------------------


def _breathing(kind, scales, n=6000, seed=7):
    """A trajectory whose frame f is frame 0's fractional coordinates in the
    cell scaled by scales[f]: (system, frames, cells)."""
    if kind == "ortho":
        b0 = np.diag([30.0] * 3).astype(np.float32)
    else:
        b0 = _tri_basis((30.75, 30.75, 30.75), (85, 95, 80))
    f = np.random.RandomState(seed).uniform(0, 1, (n, 3))
    cells = np.stack([b0 * np.float32(s) for s in scales])
    frames = np.stack([(f @ c.astype(np.float64)).astype(np.float32) for c in cells])
    return _system(frames[0], cells[0]), frames, cells


@pytest.mark.parametrize("kind", ["ortho", "triclinic"])
def test_evaluator_grid_holds_for_a_shrunk_frame(kind):
    """A shrinking box: frame 1's box is 2% smaller than frame 0's. On frame 0's
    grid the kernel's walk loses pairs of frame 1; on the grid the Evaluator
    sizes from the smallest frame it equals the all-pairs histogram."""
    r_max = 5.0
    sys_, frames, cells = _breathing(kind, [1.0, 0.98])
    ct = compile_script(f"r = rdf(all, all, {r_max});", sys_, "cpu")
    route = "rdf:cell_list" if kind == "ortho" else "rdf:cell_list_triclinic"
    assert ct.routes == [route]
    dims0 = ct.grids[0].dims
    ev = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu"))
    dims = ev.script.grids[0].dims
    assert ev.script.routes == ct.routes == [route] and ct.grids[0].dims == dims0
    assert dims != dims0 and all(d <= d0 for d, d0 in zip(dims, dims0))
    basis, x, inv = cells[1], frames[1], _inv(cells)[1]
    ia = np.arange(len(x), dtype=np.int32)
    want = _all_pairs(x, ia, ia, basis, inv, r_max)
    got = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ia, basis, inv, dims, r_max)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    lost = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ia, basis, inv, dims0, r_max)
    assert lost.sum() < want.sum()  # the frame-0 grid drops pairs
    # the CPU route is all-pairs on every frame
    res = ev.run()
    total = want + _all_pairs(frames[0], ia, ia, cells[0], _inv(cells)[0], r_max)
    np.testing.assert_array_equal(res.distributions["r"], total.numpy())


def test_evaluator_sends_a_grid_that_no_longer_fits_to_dense():
    """A 15.6 Å box at 5 Å holds 3 cells an axis; a frame 5% smaller holds
    2, so that trajectory takes the radius-2 grid (5 cells at least 2.5 Å
    wide, its walk exact on the small frame), and one with a 12 Å frame,
    under 5 such cells, the dense route. Each Evaluator keeps its own
    grids; the compiled script keeps the system's."""
    sys_, frames, cells = _breathing("ortho", [0.52, 0.494, 0.4], n=4200)
    ct = compile_script("r = rdf(all, all, 5.0);", sys_, "cpu")
    assert ct.routes == ["rdf:cell_list"] and ct.grids[0].dims == (3, 3, 3)
    traj = lambda k: trajectory_from_numpy(frames[:k], cells[:k], "cpu")  # noqa: E731
    ev_r2 = Evaluator(ct, traj(2))
    ev = Evaluator(ct, traj(3))
    ev0 = Evaluator(ct, traj(1))
    g = ev_r2.script.grids[0]
    assert ev_r2.script.routes == ["rdf:cell_list_r2"] and (g.dims, g.radius) == ((5, 5, 5), 2)
    assert ev.script.routes == ["rdf:dense"]
    assert ev0.script.routes == ct.routes == ["rdf:cell_list"]
    res = ev.run()
    assert ev.script.routes == ["rdf:dense"] and res.distributions["r"].sum() > 0
    ia = np.arange(frames.shape[1], dtype=np.int32)
    inv = _inv(cells)[1]
    walk = _walk(cuda_rdf.pair_hist_cells_plain, frames[1], ia, ia, cells[1], inv,
                 g.dims, 5.0, fractional=False, radius=2)
    want = _all_pairs(frames[1], ia, ia, cells[1], inv, 5.0)
    np.testing.assert_array_equal(walk.numpy(), want.numpy())


def test_evaluator_bins_skewed_frames_in_fractional_space():
    """A system cell that is orthorhombic with frames whose basis is
    skewed: the site bins in fractional space for that trajectory (the
    diagonal alone would misplace atoms)."""
    sys_, frames, cells = _breathing("ortho", [1.0, 1.0], n=4200)
    cells[1, 1, 0] = 3.0
    ct = compile_script("r = rdf(all, all, 5.0);", sys_, "cpu")
    assert ct.routes == ["rdf:cell_list"]
    ev = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu"))
    assert ev.script.routes == ["rdf:cell_list_triclinic"] and ev.script.grids[0].fractional


# -- on the card -------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["same", "overlap"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_triclinic_kernel_matches_plain(cuda, case, kind):
    """Through the route (fractional cells, half stencil when one index
    tensor serves both sides) against the all-pairs version, and on prebuilt
    fractional cell lists against the kernel's walk: equal bin for bin."""
    make, n, r_max = CASES[case]
    basis = make()
    inv = _inv(basis)
    x = _atoms(basis, n, 31, spill=0.3)
    ia, ib = _selections(n, kind)
    dims, _ = choose_grid_triclinic(basis, r_max, len(ia))
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    ia_t = t(ia)
    ib_t = ia_t if kind == "same" else t(ib)
    before = cuda_rdf.launches
    got = cuda_rdf.pair_dist_histogram_cl(
        t(x), ia_t, ib_t, t(basis), t(inv), NBINS, r_max, dims, fractional=True
    )
    torch.cuda.synchronize()
    assert cuda_rdf.launches == before + 1
    want = _all_pairs(x, ia, ib, basis, inv, r_max, device=cuda)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert want.sum() > 0
    got = _walk(cuda_rdf.pair_hist_cells, x, ia, ib, basis, inv, dims, r_max, cuda)
    want = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ib, basis, inv, dims, r_max, cuda)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["ortho", "triclinic"])
def test_breathing_box_on_the_card(cuda, kind):
    """Boxes from 0.98 to 1.02 of frame 0's: the Evaluator's grid comes from
    the smallest, and every frame's histogram through the kernel equals the
    all-pairs version on the card."""
    scales = [1.0, 1.02, 0.98, 1.01, 0.99]
    sys_, frames, cells = _breathing(kind, scales)
    ct = compile_script("r = rdf(all, all, 5.0);", sys_, cuda)
    traj = trajectory_from_numpy(frames, cells, cuda)
    before = cuda_rdf.launches
    res = Evaluator(ct, traj).run()
    assert cuda_rdf.launches - before == len(scales)
    ia = np.arange(frames.shape[1], dtype=np.int32)
    inv = _inv(cells, cuda)
    total = sum(
        _all_pairs(frames[f], ia, ia, cells[f], inv[f], 5.0, cuda)
        for f in range(len(scales))
    )
    np.testing.assert_array_equal(res.distributions["r"], total.cpu().numpy())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["same", "overlap"])
@pytest.mark.parametrize("case", sorted(R2_CASES))
def test_radius2_kernel_matches_plain(cuda, case, kind):
    """The radius-2 stencil through the route against the all-pairs
    version, and on prebuilt cell lists against the kernel's walk: equal
    bin for bin."""
    make, n, r_max = R2_CASES[case]
    basis = make()
    inv = _inv(basis)
    x = _atoms(basis, n, 43, spill=0.3)
    ia, ib = _selections(n, kind)
    fractional = case == "fractional"
    if fractional:
        dims, _ = choose_grid_triclinic(basis, r_max, len(ia), radius=2)
    else:
        dims, _ = choose_grid(np.diag(basis), r_max, len(ia))
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    ia_t = t(ia)
    ib_t = ia_t if kind == "same" else t(ib)
    before = cuda_rdf.launches
    got = cuda_rdf.pair_dist_histogram_cl(
        t(x), ia_t, ib_t, t(basis), t(inv), NBINS, r_max, dims,
        fractional=fractional, radius=2,
    )
    torch.cuda.synchronize()
    assert cuda_rdf.launches == before + 1
    want = _all_pairs(x, ia, ib, basis, inv, r_max, device=cuda)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert want.sum() > 0
    kw = dict(fractional=fractional, radius=2)
    got = _walk(cuda_rdf.pair_hist_cells, x, ia, ib, basis, inv, dims, r_max, cuda, **kw)
    want = _walk(cuda_rdf.pair_hist_cells_plain, x, ia, ib, basis, inv, dims, r_max, cuda, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.requires_cuda
def test_radius2_route_on_the_card_matches_cpu(cuda):
    """The 27.6 Å box at 10 Å through the compiler: the radius-2 kernel on
    CUDA equals the CPU route (all pairs) bin for bin."""
    x, basis, cutoff = _scene("radius2")
    out = {}
    for dev in ("cpu", cuda):
        ct = compile_script(f"r = rdf(all, all, {cutoff});", _system(x, basis), dev)
        assert ct.routes == ["rdf:cell_list_r2"]
        before = cuda_rdf.launches
        _, acc = ct.frame_fn(*(torch.as_tensor(a, device=dev) for a in (x, basis, _inv(basis))))
        assert cuda_rdf.launches == before + (dev != "cpu")
        out[str(dev)] = acc["r"].cpu().numpy()
    np.testing.assert_array_equal(out[str(cuda)], out["cpu"])
    assert out["cpu"].sum() > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["small", "aperiodic", "triclinic_small_box"])
def test_dense_route_on_the_card_matches_cpu(cuda, name):
    """The dense route's histogram on CUDA equals the CPU's bin for bin
    (the same float operations; no host wait per tile), through the
    compiler and at a tile size that splits the A side."""
    x, basis, cutoff = _scene(name)
    out = {}
    for dev in ("cpu", cuda):
        ct = compile_script(f"r = rdf(all, all, {cutoff});", _system(x, basis), dev)
        assert ct.routes == ["rdf:dense"]
        _, acc = ct.frame_fn(*(torch.as_tensor(a, device=dev) for a in (x, basis, _inv(basis))))
        ia = np.arange(len(x), dtype=np.int32)
        tiled = pair_dist_histogram_scatter_idx(
            *(torch.as_tensor(a, device=dev) for a in (x, ia, ia)),
            torch.ones(len(x), device=dev), torch.ones(len(x), device=dev),
            *(torch.as_tensor(a, device=dev) for a in (basis, _inv(basis))),
            NBINS, cutoff, max_pairs=len(x) * 37,
        )
        np.testing.assert_array_equal(tiled.cpu().numpy(), acc["r"].cpu().numpy())
        out[str(dev)] = acc["r"].cpu().numpy()
    np.testing.assert_array_equal(out[str(cuda)], out["cpu"])
    assert out["cpu"].sum() > 0
