"""The headline script end to end: viamd_tpu (JAX, CPU) against
viamd_tpu_torch (CPU) on the same seeded numpy frames.

    r = rdf(element('O'), element('O'), 10.0);
    v = sdf(residue(1:64), element('H'), 5.0);
    {lin, plan, iso} = shape_weights(all);

on water_box(3_000): 9,000 atoms, a 44.8 Å box, 4×4×4 RDF cells — large
enough that both compilers take the cell-list RDF route and the SDF pairs
route.

Tolerances:
- r: totals within 1e-3 relative, bins within 2 counts + 1e-3 relative.
  The JAX package's CPU cell-list route drops atoms past its per-cell
  capacities (the port counts every pair) and computes distances in another
  float order (pairs move across bin edges).
- v: rtol 1e-4, atol 1e-5 · max (float32 Kabsch + splat, summed over
  frames).
- lin/plan/iso: atol 1e-5.
"""

import numpy as np
import pytest
import torch

from tests._torch_parity import port_system
from viamd_tpu_torch.datagen import water_box, water_box_device
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.script import ScriptError, compile_script

HEADLINE = (
    "r = rdf(element('O'), element('O'), 10.0);\n"
    "v = sdf(residue(1:64), element('H'), 5.0);\n"
    "{lin, plan, iso} = shape_weights(all);\n"
)


@pytest.fixture(scope="module")
def slice_results():
    from viamd_tpu.datagen import water_box as j_water_box
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io.trajectory import InMemoryTrajectory
    from viamd_tpu.script import compile_script as j_compile

    sys_j, traj_j = j_water_box(3_000, n_frames=4, seed=5)
    frames, cells = traj_j.load_frames(range(4))
    cj = j_compile(HEADLINE, sys_j)
    rj = JEvaluator(
        cj, InMemoryTrajectory(frames, cells), chunk=4, batch_mode="map"
    ).run()
    ct = compile_script(HEADLINE, port_system(sys_j), "cpu")
    rt = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu"), chunk=3).run()
    return sys_j, cj, rj, ct, rt


def test_routes(slice_results):
    sys_j, cj, _, ct, _ = slice_results
    assert ct.routes == ["rdf:cell_list", "sdf:pairs"]
    # the JAX compiler's conditions for the same two routes
    # (compiler.py:1435-1451, 1578-1584)
    from viamd_tpu.ops.neighbors import choose_grid_r

    n_o = int((sys_j.element == 8).sum())
    dims, _ = choose_grid_r(sys_j.cell.extent(), 10.0, n_o, radius=1)
    assert sys_j.cell.is_orthorhombic and sys_j.natoms >= 8192
    assert dims == (4, 4, 4)
    assert 64 * int((sys_j.element == 1).sum()) <= 150_000_000


def test_properties_match(slice_results):
    _, cj, _, ct, _ = slice_results
    key = lambda p: (p.name, p.kind, p.dim, p.unit)  # noqa: E731
    assert sorted(map(key, ct.properties)) == sorted(map(key, cj.properties))
    for name in ("r", "v"):
        sj, st = cj.property(name).spec, ct.property(name).spec
        for f in ("kind", "nbins", "r_max", "count_a", "count_b", "dims",
                  "extent", "n_structures"):
            assert getattr(st, f) == getattr(sj, f), (name, f)


def test_rdf_matches(slice_results):
    _, _, rj, _, rt = slice_results
    hj = np.asarray(rj.distributions["r"], np.float64)
    ht = np.asarray(rt.distributions["r"], np.float64)
    assert ht.shape == (128,) and ht.sum() > 0
    assert abs(ht.sum() - hj.sum()) <= 1e-3 * hj.sum()
    assert (np.abs(ht - hj) <= 2 + 1e-3 * hj).all(), np.abs(ht - hj).max()
    volume = float(np.prod(np.diag(np.asarray(slice_results[0].cell.basis))))
    gj = rj.normalized_distribution("r", volume)
    gt = rt.normalized_distribution("r", volume)
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=2e-3 * np.abs(gj).max())


def test_sdf_matches(slice_results):
    _, _, rj, _, rt = slice_results
    vj, vt = rj.volumes["v"], rt.volumes["v"]
    assert vt.shape == (64, 64, 64) and vt.sum() > 0
    np.testing.assert_allclose(vt, vj, rtol=1e-4, atol=1e-5 * np.abs(vj).max())
    np.testing.assert_allclose(
        rt.normalized_volume("v"), rj.normalized_volume("v"),
        rtol=1e-4, atol=1e-5 * np.abs(vj).max(),
    )


def test_shape_weights_match(slice_results):
    _, _, rj, _, rt = slice_results
    assert rt.n_frames_done == rj.n_frames_done == 4
    np.testing.assert_array_equal(rt.frame_indices, np.arange(4))
    for k in ("lin", "plan", "iso"):
        assert rt.temporal[k].shape == (4, 1)
        np.testing.assert_allclose(rt.temporal[k], rj.temporal[k], atol=1e-5)
    total = rt.temporal["lin"] + rt.temporal["plan"] + rt.temporal["iso"]
    np.testing.assert_allclose(total, 1.0, atol=1e-5)


def test_frame_range_sums_to_whole(slice_results):
    """run() over two disjoint ranges accumulates to the whole run."""
    sys_j, _, _, ct, rt = slice_results
    from viamd_tpu.datagen import water_box as j_water_box

    _, traj_j = j_water_box(3_000, n_frames=4, seed=5)
    frames, cells = traj_j.load_frames(range(4))
    ev = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu"), chunk=2)
    a, b = ev.run(range(0, 3)), ev.run([3])
    assert a.n_frames_done == 3 and b.n_frames_done == 1
    assert a.frame_mask.popcount() == 3 and b.frame_mask.test_bit(3)
    np.testing.assert_allclose(
        a.distributions["r"] + b.distributions["r"], rt.distributions["r"]
    )
    np.testing.assert_allclose(
        np.concatenate([a.temporal["iso"], b.temporal["iso"]]),
        rt.temporal["iso"],
    )
    assert np.isclose(a.force() + b.force(), rt.force(), rtol=1e-5)


def test_water_box_is_a_copy():
    from viamd_tpu.datagen import water_box as j_water_box

    sj, tj = j_water_box(500, n_frames=2, seed=3)
    st, tt = water_box(500, n_frames=2, seed=3)
    np.testing.assert_array_equal(st.coords(), sj.coords())
    np.testing.assert_array_equal(tt.load_frames([0, 1])[0], tj.load_frames([0, 1])[0])
    np.testing.assert_array_equal(st.mass, sj.mass)
    np.testing.assert_array_equal(st.res_offsets, sj.res_offsets)
    np.testing.assert_array_equal(st.cell.basis, sj.cell.basis)


def test_water_box_device_is_seeded():
    s1, t1 = water_box_device(200, n_frames=3, seed=4, device="cpu")
    _, t2 = water_box_device(200, n_frames=3, seed=4, device="cpu")
    _, t3 = water_box_device(200, n_frames=3, seed=5, device="cpu")
    assert t1.stack.shape == (3, 600, 3) and t1.stack.dtype == torch.float32
    assert torch.equal(t1.stack, t2.stack) and not torch.equal(t1.stack, t3.stack)
    jitter = (t1.stack - torch.as_tensor(s1.coords())).std().item()
    assert 0.13 < jitter < 0.17  # the 0.15 Å default
    assert t1.cells.shape == (3, 3, 3)


def test_interop_roundtrip_keeps_topology(slice_results):
    sys_j = slice_results[0]
    st = port_system(sys_j)
    np.testing.assert_array_equal(st.coords(), sys_j.coords())
    np.testing.assert_array_equal(st.element, sys_j.element)
    np.testing.assert_array_equal(st.res_offsets, sys_j.res_offsets)
    assert st.res_names.labels == sys_j.res_names.labels
    assert st.cell.kind == sys_j.cell.kind


@pytest.mark.parametrize(
    "src, match",
    [
        ("t = import('table.txt');", "import: unsupported file"),
        ("t = import(element('Qq'));", "unknown element"),
        ("s = element('O') and 3;", "expected an atom selection"),
        ("r = rdf(element('Qq'), element('O'), 3.0);", "unknown element|not yet ported"),
        ("q = nothing(1);", "unknown function"),
    ],
)
def test_unported_builtins_raise(src, match):
    """Compile errors of builtins: `import` of a file it has no reader for,
    and an argument's error before the call's, as in the JAX package.
    Every builtin compiles (tests/test_torch_script_lang.py)."""
    sys_, _ = water_box(100, n_frames=1, seed=0)  # 300 atoms: small box
    with pytest.raises(ScriptError, match=match):
        compile_script(src, sys_, "cpu")


def test_unported_routes_raise():
    """The routes that raised before the dense and radius-2 boxes were
    ported now compile (tests/test_torch_rdf_routes.py and
    test_torch_sdf_routes.py hold their values), and so does the rdf of a
    dynamic selection (tests/test_torch_dynamic.py)."""
    sys_, _ = water_box(100, n_frames=1, seed=0)  # n < 4096 → dense RDF
    c = compile_script("r = rdf(element('O'), element('O'), 5.0);", sys_, "cpu")
    assert c.routes == ["rdf:dense"]
    c = compile_script("v = sdf(residue(1:4), element('H'), 5.0);", sys_, "cpu")
    assert c.routes == ["sdf:dense"]
    # 4,200 atoms at twice the density: a 27.6 Å box, under 3 cutoffs,
    # the radius-2 cell list
    big, _ = water_box(1_400, density_atoms_per_A3=0.2, n_frames=1, seed=0)
    c = compile_script("r = rdf(element('O'), element('O'), 10.0);", big, "cpu")
    assert c.routes == ["rdf:cell_list_r2"]
    c = compile_script("r = rdf(within(3.0, element('O')), element('O'), 5.0);", sys_, "cpu")
    assert c.routes == ["rdf:dynamic"]


def test_selection_subscripts_match_jax():
    from viamd_tpu.datagen import water_box as j_water_box
    from viamd_tpu.script import compile_script as j_compile

    src = "s = residue(1:10)[3:5]; t = residue(2:6)[2]; o = element('O');"
    sys_j, _ = j_water_box(100, n_frames=1, seed=0)
    cj = j_compile(src, sys_j)
    ct = compile_script(src, port_system(sys_j), "cpu")
    assert sorted(ct.selections) == sorted(cj.selections) == ["o", "s", "t"]
    for k in ("s", "t", "o"):
        a, b = ct.selections[k], cj.selections[k]
        assert a.mask.count == b.mask.count
        np.testing.assert_array_equal(a.mask.words, b.mask.words)
        assert len(a.structures) == len(b.structures)
        for x, y in zip(a.structures, b.structures):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ScriptError, match="subscript not supported here"):
        compile_script("x = 3; y = x[1];", port_system(sys_j), "cpu")
