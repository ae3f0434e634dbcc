"""The SDF routes of the port beyond the orthorhombic pairs route, against
viamd_tpu on the CPU: the cell-list route (orthorhombic and triclinic, with
its cell capacities), the dense route (orthorhombic, triclinic,
aperiodic), the pairs route on a triclinic cell, the copied sizers and
stencils, and the routes the compiler picks.

The JAX package is imported inside the parity tests only, so the tests
marked `requires_cuda` collect on a machine with a GPU and no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_sdf_routes.py

Tolerances, as tests/test_torch_sdf.py states them for the pairs route:
rtol 1e-5 and atol 2e-5 · max|grid| (each point goes through a Kabsch
rotation and a min-image that both packages compute to ~1e-7 relative but
not bit for bit; a position error δ moves a tent weight by δ / voxel).
Where a capacity binds, the same points must be dropped (a different choice
would move whole points). Whole scripts against the JAX Evaluator: rtol
1e-4, atol 1e-5 · max (tests/test_torch_slice.py: heavy-atom weights,
summed over frames), 1e-4 · max in a triclinic cell (the 3x3 min-image
rounds differently per point). CUDA against the CPU: rtol 1e-4, atol
2e-5 · max, as against the JAX package (the card's Kabsch and min-image
round differently; a triclinic voxel read 1.05e-5 · max off on the H100).
"""

import dataclasses

import numpy as np
import pytest
import torch

from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.ops import sdf as t_sdf
from viamd_tpu_torch.ops.neighbors import (
    choose_grid,
    choose_grid_triclinic,
    perpendicular_widths,
)
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.script import compile_script

ROUTE_ATOL = 2e-5  # × max|grid|, see the module docstring
EXTENT, DIMS = 5.0, 16

# a 5-atom molecule with well-separated principal extents (test_torch_sdf)
_MOLECULE = np.array(
    [[-1.9, 0.1, 0.0], [2.1, -0.1, 0.1], [0.1, -1.0, 0.0], [0.0, 1.1, -0.1],
     [0.0, 0.0, 0.55]]
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cell(name):
    if name == "ortho":
        return np.diag([24.0] * 3).astype(np.float32)
    if name == "triclinic":  # test_celllist_triclinic_matches_dense's 60° cell
        return np.asarray(UnitCell.from_lengths_angles(26, 26, 26, 90, 90, 60).basis)
    return np.zeros((3, 3), np.float32)  # aperiodic


def _case(name, n=700, n_struct=4, seed=7, tw_frac=0.5):
    """n atoms uniform in the cell (a 24 Å cube when aperiodic); the first
    5·n_struct form whole molecules, the reference structures (reference
    coordinates from frame 0, unit weights). Returns frame 1 (frame 0 +
    0.1 Å jitter) and the inputs as numpy arrays in a dict."""
    rng = np.random.RandomState(seed)
    basis = _cell(name)
    b = basis if basis.any() else np.diag([24.0] * 3)
    x0 = rng.uniform(0, 1, (n, 3)) @ np.asarray(b, np.float64)
    for i in range(n_struct):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        x0[i * 5 : i * 5 + 5] = x0[i * 5] + _MOLECULE @ q.T
    x0 = x0.astype(np.float32)
    x = (x0 + rng.normal(scale=0.1, size=x0.shape)).astype(np.float32)
    structs = [np.arange(i * 5, i * 5 + 5, dtype=np.int32) for i in range(n_struct)]
    idx, w, refc = t_sdf.make_structure_inputs(structs, np.ones(n, np.float32), x0)
    tw = (rng.rand(n) < tw_frac).astype(np.float32)
    inv = inv_basis_of(torch.as_tensor(basis)).numpy()
    return dict(x=x, tw=tw, idx=idx, w=w, refc=refc, idx_t=np.nonzero(tw)[0],
                basis=basis, inv=inv, x0=x0, n_struct=n_struct)


def _port(fn, c, *extra, device="cpu", **kw):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return fn(
        t(c["x"]), t(c["tw"]), t(c["idx"]).long(), t(c["w"]), t(c["refc"]),
        EXTENT, DIMS, t(c["basis"]), t(c["inv"]), t(c["idx_t"]).long(), *extra, **kw,
    ).cpu().numpy()


def _jax_args(c):
    import jax.numpy as jnp

    return [jnp.asarray(c[k]) for k in ("x", "tw", "idx", "w", "refc")]


def _close(got, want, atol_rel=ROUTE_ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol_rel * float(np.abs(want).max()))


def _cl_grid(c):
    """A cell-list grid both packages take (and the card test): cells of
    half the √3·extent reach, as JAX's test_celllist_matches_dense sizes
    them, and the pruned stencil over ±2 cells. → (dims, capacity,
    stencil, fractional)."""
    n_t = c["idx_t"].size
    reach = 1.7320508 * EXTENT
    if not c["basis"][~np.eye(3, dtype=bool)].any():
        box = np.diag(c["basis"]).astype(np.float64)
        dims, cap = choose_grid(box, reach, n_t)
        return dims, cap, t_sdf.make_sdf_stencil(EXTENT, box / np.array(dims)), False
    dims, cap = choose_grid_triclinic(c["basis"], reach, n_t, radius=2)
    return dims, cap, t_sdf.make_sdf_stencil_triclinic(EXTENT, c["basis"], dims), True


# -- copies of host code -----------------------------------------------------


def test_stencils_are_copies():
    from viamd_tpu.ops import sdf as j_sdf

    for extent, w in ((5.0, np.array([4.8, 4.8, 4.8])), (3.0, np.array([5.5, 6.0, 7.1])),
                      (8.0, np.array([9.0, 9.0, 8.0]))):
        np.testing.assert_array_equal(
            t_sdf.make_sdf_stencil(extent, w), j_sdf.make_sdf_stencil(extent, w)
        )
    for lengths_angles, dims in (((26, 26, 26, 90, 90, 60), (3, 3, 3)),
                                 ((40, 35, 30, 80, 95, 70), (5, 4, 4))):
        b = np.asarray(UnitCell.from_lengths_angles(*lengths_angles).basis)
        for extent in (4.0, 5.0):
            np.testing.assert_array_equal(
                t_sdf.make_sdf_stencil_triclinic(extent, b, dims),
                j_sdf.make_sdf_stencil_triclinic(extent, b, dims),
            )


def test_sizers_with_basis_are_copies():
    from viamd_tpu.ops import sdf as j_sdf

    c = _case("triclinic")
    box = np.full(3, abs(np.linalg.det(c["basis"].astype(np.float64))) ** (1 / 3))
    xt = c["x"][c["idx_t"]]
    args = (xt, c["x"], c["idx"], c["w"], box, EXTENT, DIMS)
    assert t_sdf.sdf_frame0_ball_count(*args, basis=c["basis"]) == \
        j_sdf.sdf_frame0_ball_count(*args, basis=c["basis"]) > 0
    sargs = (xt, c["x"], c["idx"], c["w"], c["refc"], box, EXTENT, DIMS)
    assert t_sdf.sdf_frame0_support_count(*sargs, basis=c["basis"]) == \
        j_sdf.sdf_frame0_support_count(*sargs, basis=c["basis"]) > 0


@pytest.mark.parametrize("name", ["ortho", "triclinic"])
def test_cell_grid_matches_jax_sizing(name):
    """sdf_cell_grid against the JAX compiler's sizing of the same grid
    (compiler.py:1644-1685: choose_grid_r / choose_grid_triclinic at 3.5σ,
    the frame-0 occupancy floor, the pruned stencil)."""
    from viamd_tpu.ops import sdf as j_sdf
    from viamd_tpu.ops.neighbors import choose_grid_r, choose_grid_triclinic

    c = _case(name, n=3000)
    basis = c["basis"].astype(np.float64)
    xt0 = c["x0"][c["idx_t"]]
    reach = 1.7320508 * EXTENT
    if name == "ortho":
        box = np.diag(c["basis"])
        dims, cap = choose_grid_r(box, reach, xt0.shape[0], radius=1, tail=3.5)
        f0 = np.mod(xt0 / box, 1.0)
        stencil = j_sdf.make_sdf_stencil(EXTENT, box / np.array(dims))
    else:
        dims, cap = choose_grid_triclinic(basis, reach, xt0.shape[0], radius=1, tail=3.5)
        f0 = np.mod(xt0 @ np.linalg.inv(basis), 1.0)
        stencil = j_sdf.make_sdf_stencil_triclinic(EXTENT, basis, dims)
    cell3 = np.minimum(np.floor(f0 * np.array(dims)).astype(np.int64), np.array(dims) - 1)
    occ0 = np.bincount((cell3[:, 0] * dims[1] + cell3[:, 1]) * dims[2] + cell3[:, 2]).max()
    frac0 = xt0 / np.diag(c["basis"]) if name == "ortho" else xt0 @ np.linalg.inv(basis)
    got = t_sdf.sdf_cell_grid(perpendicular_widths(basis)[0], EXTENT, frac0, name != "ortho")
    assert got[0] == dims and got[1] == max(cap, int(1.5 * occ0) + 8)
    np.testing.assert_array_equal(got[2], stencil)


# -- the cell-list route -------------------------------------------------------


@pytest.mark.parametrize("caps", ["sized", "cell_cap_binds", "compact_cap_binds"])
@pytest.mark.parametrize("name", ["ortho", "triclinic"])
def test_celllist_matches_jax(name, caps):
    """After test_celllist_matches_dense / test_celllist_triclinic_matches_dense:
    the same grid, capacity and stencil through both packages, and the
    unbounded result against the JAX package's dense route."""
    import jax.numpy as jnp

    from viamd_tpu.ops import sdf as j_sdf

    c = _case(name, n=600 if name == "ortho" else 700)
    dims, cap, stencil, tri = _cl_grid(c)
    assert int(stencil.max() - stencil.min()) + 1 <= min(dims)
    box = np.full(3, abs(np.linalg.det(c["basis"].astype(np.float64))) ** (1 / 3))
    sup0 = t_sdf.sdf_frame0_support_count(
        c["x"][c["idx_t"]], c["x"], c["idx"], c["w"], c["refc"], box, EXTENT, DIMS,
        basis=c["basis"] if tri else None,
    )
    compact = t_sdf.sdf_compact_capacity(c["n_struct"], c["idx_t"].size, box, EXTENT,
                                         DIMS, support_count=sup0)
    if caps == "cell_cap_binds":
        cap = 3
    elif caps == "compact_cap_binds":
        compact = 40
    want = j_sdf.sdf_accumulate_cl(
        *_jax_args(c), EXTENT, DIMS, jnp.asarray(np.diag(c["basis"]).copy()), dims, cap,
        stencil, idx_t=jnp.asarray(c["idx_t"]), compact_cap=compact,
        basis=jnp.asarray(c["basis"]) if tri else None,
    )
    got = _port(t_sdf.sdf_accumulate_cl, c, dims, cap, torch.as_tensor(stencil),
                compact_cap=compact, fractional=tri)
    _close(got, want)
    dense = _port(t_sdf.sdf_accumulate, c)
    if caps == "sized":
        # every in-support point is read: the dense route's grid
        jdense = j_sdf.sdf_accumulate(*_jax_args(c), EXTENT, DIMS,
                                      jnp.asarray(c["basis"]), jnp.asarray(c["inv"]))
        _close(got, jdense)
        _close(got, dense)
    else:
        assert got.sum() < dense.sum() - 1e-3  # the cap really dropped points


# -- the dense route, the pairs route on a triclinic cell ----------------------


@pytest.mark.parametrize("name", ["ortho", "triclinic", "aperiodic"])
def test_dense_matches_jax(name):
    import jax.numpy as jnp

    from viamd_tpu.ops import sdf as j_sdf

    c = _case(name, n=500, n_struct=6)
    want = j_sdf.sdf_accumulate(*_jax_args(c), EXTENT, DIMS, jnp.asarray(c["basis"]),
                                jnp.asarray(c["inv"]))
    # a chunk of 3 structures at a time: the chunked sum
    got = _port(t_sdf.sdf_accumulate, c, max_points=3 * c["idx_t"].size)
    _close(got, want)


def test_pairs_route_triclinic_matches_jax():
    """The pairs route on the 60° cell, capacities sized on the cube of
    equal volume with the triclinic min-image (JAX compiler.py:1585-1620)."""
    import jax.numpy as jnp

    from viamd_tpu.ops import sdf as j_sdf

    c = _case("triclinic")
    box = np.full(3, abs(np.linalg.det(c["basis"].astype(np.float64))) ** (1 / 3))
    xt = c["x"][c["idx_t"]]
    cnt0 = t_sdf.sdf_frame0_ball_count(xt, c["x"], c["idx"], c["w"], box, EXTENT, DIMS,
                                       basis=c["basis"])
    pair_cap = t_sdf.sdf_pair_capacity(c["n_struct"], xt.shape[0], box, EXTENT, DIMS,
                                       per_struct_count=cnt0)
    sup0 = t_sdf.sdf_frame0_support_count(xt, c["x"], c["idx"], c["w"], c["refc"], box,
                                          EXTENT, DIMS, basis=c["basis"])
    compact = t_sdf.sdf_compact_capacity(c["n_struct"], xt.shape[0], box, EXTENT, DIMS,
                                         support_count=sup0)
    want = j_sdf.sdf_accumulate_pairs(
        *_jax_args(c), EXTENT, DIMS, jnp.asarray(c["basis"]), jnp.asarray(c["inv"]),
        jnp.asarray(c["idx_t"]), pair_cap, compact_cap=compact,
    )
    got = _port(t_sdf.sdf_accumulate_pairs, c, pair_cap, compact_cap=compact)
    _close(got, want)
    _close(got, _port(t_sdf.sdf_accumulate, c))  # nothing dropped at these caps


# -- routes through the compiler ---------------------------------------------


def _water_in(basis_rows, n_waters, seed=5, n_frames=2):
    """water_box(n_waters) moved into another cell of the same volume:
    each water's O keeps its fractional coordinates and its atoms their
    offsets from it. → (JAX System, frames, cells)."""
    from viamd_tpu.core.unitcell import UnitCell as JCell
    from viamd_tpu.datagen import water_box as j_water_box

    sys_j, traj = j_water_box(n_waters, n_frames=n_frames, seed=seed)
    L = float(sys_j.cell.basis[0, 0])
    b = np.asarray(basis_rows, np.float64)
    b = b * (L**3 / abs(np.linalg.det(b))) ** (1 / 3)

    def move(x):
        o = x[0::3].astype(np.float64)
        new_o = (o / L) @ b
        return (x.astype(np.float64) + np.repeat(new_o - o, 3, axis=0)).astype(np.float32)

    frames = np.stack([move(f) for f in traj.load_frames(range(n_frames))[0]])
    x0 = move(sys_j.coords())
    sys_j = dataclasses.replace(sys_j, x=x0[:, 0].copy(), y=x0[:, 1].copy(),
                                z=x0[:, 2].copy(), cell=JCell.from_basis(b.astype(np.float32)))
    cells = np.broadcast_to(np.asarray(sys_j.cell.basis), (n_frames, 3, 3)).copy()
    return sys_j, frames, cells


RHOMBIC = [[1, 0, 0], [0, 1, 0], [0.5, 0.5, 0.5 ** 0.5]]


def _jax_sdf_route(sys_j, n_structs, n_t):
    """The JAX compiler's sdf route (compiler.py:1578-1687) in the port's
    names."""
    big = sys_j.cell.is_periodic and sys_j.natoms >= 8192
    if big and 0 < n_structs * n_t <= 150_000_000:
        return "sdf:pairs"
    return "sdf:cell_list" if big else "sdf:dense"


@pytest.fixture(scope="module")
def big_cl():
    """21,600 atoms, 7,200 structures over all atoms: S·n_t = 1.56e8, the
    cell-list route (compiled once; its host sizing takes ~25 s)."""
    from tests._torch_parity import port_system
    from viamd_tpu.datagen import water_box as j_water_box

    sys_j, _ = j_water_box(7200, n_frames=1, seed=1)
    src = "v = sdf(residue(1:7200), all, 3.13);"
    return sys_j, compile_script(src, port_system(sys_j), "cpu")


def test_cell_list_route_is_taken(big_cl):
    sys_j, ct = big_cl
    assert ct.routes == [_jax_sdf_route(sys_j, 7200, 21600)] == ["sdf:cell_list"]
    grid = ct.grids[0]
    assert grid.dims == (11, 11, 11) and not grid.dense


def test_sdf_grid_follows_the_smallest_frame(big_cl):
    """A second frame 2% smaller: the Evaluator sizes its grid for it
    (cells still √3·extent across, 10 an axis instead of 11, the stencil
    and capacity resized); a trajectory of frame 0 alone keeps 11, and the
    compiled script keeps the system's grid."""
    sys_j, ct = big_cl
    b0 = np.asarray(sys_j.cell.basis)
    x0 = sys_j.coords()
    frames = np.stack([x0, x0 * np.float32(0.98)])
    cells = np.stack([b0, b0 * np.float32(0.98)])
    ev = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu"))
    grid = ev.script.grids[0]
    assert grid.dims == (10, 10, 10) and ev.script.routes == ["sdf:cell_list"]
    widths = perpendicular_widths(cells).min(axis=0)
    assert (widths / np.array(grid.dims) >= 1.7320508 * 3.13).all()
    frac0 = x0 / np.diag(b0)
    dims, cap, stencil = t_sdf.sdf_cell_grid(widths, 3.13, frac0, False)
    assert grid.capacity == cap and torch.equal(grid.stencil, torch.as_tensor(stencil).long())
    ev0 = Evaluator(ct, trajectory_from_numpy(frames[:1], cells[:1], "cpu"))
    assert ev0.script.grids[0].dims == ct.grids[0].dims == (11, 11, 11)


@pytest.mark.parametrize("orthorhombic", [True, False])
def test_sdf_grid_of_a_zero_cell_frame_is_dense(big_cl, orthorhombic):
    """A trajectory with an aperiodic (zero) cell among its frames: the
    smallest widths are 0, and the cell-list site takes the dense route
    (cartesian or fractional binning alike) instead of sizing a stencil
    for cells of no width."""
    sys_j, ct = big_cl
    b0 = np.asarray(sys_j.cell.basis)
    x0 = sys_j.coords()
    if orthorhombic:
        cells = np.stack([b0, np.zeros((3, 3), np.float32)])
        ev = Evaluator(ct, trajectory_from_numpy(np.stack([x0, x0]), cells, "cpu"))
        assert ev.script.routes == ["sdf:dense"] and ev.script.grids[0].dense
    grid = ct.grid_sites[0].grid(np.array([0.0, 60.0, 60.0]), orthorhombic)
    assert grid.route == "sdf:dense"
    assert ct.routes == ["sdf:cell_list"]


@pytest.mark.parametrize("name", ["small", "aperiodic", "ortho_pairs", "triclinic_pairs"])
def test_routes_follow_jax_conditions(name):
    from tests._torch_parity import port_system
    from viamd_tpu.datagen import polyala_helix as j_polyala
    from viamd_tpu.datagen import water_box as j_water_box

    if name == "small":
        sys_j, _ = j_water_box(300, n_frames=1, seed=0)
    elif name == "aperiodic":
        sys_j, _ = j_polyala(64, 1)
    elif name == "ortho_pairs":
        sys_j, _ = j_water_box(3000, n_frames=1, seed=0)
    else:
        sys_j, _, _ = _water_in(RHOMBIC, 3000, n_frames=1)
    ct = compile_script("v = sdf(residue(1:8), element('H'), 4.0);", port_system(sys_j), "cpu")
    n_t = int((sys_j.element == 1).sum())
    assert ct.routes == [_jax_sdf_route(sys_j, 8, n_t)]
    assert ct.routes == [{"small": "sdf:dense", "aperiodic": "sdf:dense"}.get(name, "sdf:pairs")]


@pytest.mark.parametrize("name", ["dense", "triclinic_pairs"])
def test_script_matches_jax(name):
    """`sdf` through both compilers and Evaluators over two frames: the
    dense route on a 900-atom box, the pairs route on 9,000 atoms in a
    rhombic dodecahedron."""
    from tests._torch_parity import port_system
    from viamd_tpu.datagen import water_box as j_water_box
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io.trajectory import InMemoryTrajectory
    from viamd_tpu.script import compile_script as j_compile

    if name == "dense":
        sys_j, traj = j_water_box(300, n_frames=2, seed=4)
        frames, cells = traj.load_frames([0, 1])
    else:
        sys_j, frames, cells = _water_in(RHOMBIC, 3000)
    src = "v = sdf(residue(1:8), element('H'), 4.0);"
    ct = compile_script(src, port_system(sys_j), "cpu")
    assert ct.routes == ["sdf:dense" if name == "dense" else "sdf:pairs"]
    got = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu")).run().volumes["v"]
    cj = j_compile(src, sys_j)
    want = JEvaluator(cj, InMemoryTrajectory(frames, cells), chunk=2,
                      batch_mode="map").run().volumes["v"]
    assert got.sum() > 0
    # in the triclinic cell both packages round each point's 3x3
    # min-image products differently, and heavy-atom Kabsch weights drift
    # (ROADMAP queue 3): a few tent weights near the support edge move by
    # up to 5e-5 of the grid's maximum
    atol = (1e-5 if name == "dense" else 1e-4) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


# -- on the card -------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", ["cell_list", "dense", "pairs"])
@pytest.mark.parametrize("name", ["ortho", "triclinic"])
def test_routes_on_the_card_match_cpu(cuda, name, route):
    c = _case(name, n=3000, n_struct=24)
    if route == "cell_list":
        dims, cap, stencil, tri = _cl_grid(c)
        extra = (dims, cap, torch.as_tensor(stencil))
        kw = dict(compact_cap=4096, fractional=tri)
        fn = t_sdf.sdf_accumulate_cl
    elif route == "pairs":
        fn, extra, kw = t_sdf.sdf_accumulate_pairs, (1024,), dict(compact_cap=8192)
    else:
        fn, extra, kw = t_sdf.sdf_accumulate, (), {}
    out = {}
    for dev in ("cpu", cuda):
        ex = tuple(e.to(dev) if isinstance(e, torch.Tensor) else e for e in extra)
        out[str(dev)] = _port(fn, c, *ex, device=dev, **kw)
    want = out["cpu"]
    assert want.sum() > 0
    np.testing.assert_allclose(out[str(cuda)], want, rtol=1e-4,
                               atol=ROUTE_ATOL * np.abs(want).max())
