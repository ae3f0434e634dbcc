"""Geometry builtins of the port in their atom-index form (`distance`,
`angle`, `dihedral`), the poly-alanine generator, and the BASELINE config
#1 and #5 scripts end to end, against viamd_tpu on the CPU.

The JAX package is imported inside the parity tests only, so the test
marked `requires_cuda` collects on a machine with a GPU and no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_geometry.py

Tolerances. Distances: atol 1e-5 Å; angles and dihedrals: atol 1e-4 rad
(1e-4·57.3 deg through the compiler): float32 min-image products and
arccos/atan2 of sums taken in another order. RDF histograms through whole
scripts: tests/test_torch_slice.py's (totals within 1e-3 relative, bins
within 2 + 1e-3 relative); shape weights: atol 1e-5.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.datagen import polyala_helix, water_box
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.ops import geometry as t_geom
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.script import ScriptError, compile_script

CONFIG1 = "d1 = distance(10, 30);\nr = rdf(element('C'), element('H'), 10.0);\n"
CONFIG5 = (
    "d1 = distance(1, 4);\n"
    "a1 = angle(1, 2, 3);\n"
    "r = rdf(element('O'), element('O'), 10.0);\n"
    "{lin, plan, iso} = shape_weights(all);\n"
)


def _cell(name):
    if name == "ortho":
        return np.diag([14.0, 15.0, 16.0]).astype(np.float32)
    if name == "triclinic":
        return np.array([[15, 0, 0], [4, 14, 0], [-3, 2, 16]], np.float32)
    return np.zeros((3, 3), np.float32)


@pytest.mark.parametrize("name", ["ortho", "triclinic", "aperiodic"])
def test_geometry_ops_match_jax(name):
    import jax.numpy as jnp

    from viamd_tpu.ops import geometry as j_geom

    rng = np.random.RandomState(3)
    basis = _cell(name)
    x = rng.uniform(-2.0, 18.0, (200, 3)).astype(np.float32)
    idx = [rng.randint(0, 200, 64) for _ in range(4)]
    inv = inv_basis_of(torch.as_tensor(basis)).numpy()
    t = [torch.as_tensor(a) for a in (x, *idx, basis, inv)]
    j = [jnp.asarray(a) for a in (x, *idx, basis, inv)]
    for fn, k, atol in (("distance", 2, 1e-5), ("angle", 3, 1e-4), ("dihedral", 4, 1e-4)):
        got = getattr(t_geom, fn)(t[0], *t[1 : 1 + k], t[5], t[6]).numpy()
        want = np.asarray(getattr(j_geom, fn)(j[0], *j[1 : 1 + k], j[5], j[6]))
        assert got.shape == want.shape == (64,) and np.isfinite(got).all()
        if fn == "angle":  # away from 0 and π, where arccos loses digits
            keep = np.abs(np.cos(want)) < 0.999
            got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, atol=atol)


def test_polyala_helix_is_a_copy():
    from viamd_tpu.datagen import polyala_helix as j_polyala

    sj, tj = j_polyala(12, n_frames=3, seed=2)
    st, tt = polyala_helix(12, n_frames=3, seed=2)
    np.testing.assert_array_equal(st.coords(), sj.coords())
    np.testing.assert_array_equal(st.element, sj.element)
    np.testing.assert_array_equal(st.res_offsets, sj.res_offsets)
    np.testing.assert_array_equal(st.res_id, sj.res_id)
    assert st.res_names.labels == sj.res_names.labels
    assert st.atom_names.labels == sj.atom_names.labels
    np.testing.assert_array_equal(st.mass, sj.mass)
    np.testing.assert_array_equal(st.radius, sj.radius)
    assert not st.cell.is_periodic and not sj.cell.is_periodic
    np.testing.assert_array_equal(tt.load_frames([0, 1, 2])[0], tj.load_frames([0, 1, 2])[0])


def _both(src, sys_j, frames, cells):
    """(port CompiledScript, port EvalResult, JAX CompiledScript, JAX
    EvalResult) of `src` on the CPU."""
    from tests._torch_parity import port_system
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io.trajectory import InMemoryTrajectory
    from viamd_tpu.script import compile_script as j_compile

    ct = compile_script(src, port_system(sys_j), "cpu")
    rt = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu"), chunk=4).run()
    cj = j_compile(src, sys_j)
    rj = JEvaluator(cj, InMemoryTrajectory(frames, cells), chunk=len(frames),
                    batch_mode="map").run()
    return ct, rt, cj, rj


def _close_hist(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.sum() > 0 and abs(got.sum() - want.sum()) <= 1e-3 * want.sum()
    assert (np.abs(got - want) <= 2 + 1e-3 * want).all(), np.abs(got - want).max()


def test_config1_script_matches_jax():
    """BASELINE config #1 (tools/bench_configs.py:63-90): the reference's
    default script on the poly-alanine helix, aperiodic, 448 atoms."""
    from viamd_tpu.datagen import polyala_helix as j_polyala

    sys_j, traj = j_polyala(64, n_frames=12)
    frames, cells = traj.load_frames(range(12))
    ct, rt, cj, rj = _both(CONFIG1, sys_j, frames, cells)
    assert ct.routes == ["rdf:dense"]
    key = lambda p: (p.name, p.kind, p.dim, p.unit)  # noqa: E731
    assert sorted(map(key, ct.properties)) == sorted(map(key, cj.properties))
    assert ct.visualization["lines"] == cj.visualization["lines"] == [(9, 29)]
    assert rt.temporal["d1"].shape == (12, 1)
    np.testing.assert_allclose(rt.temporal["d1"], rj.temporal["d1"], atol=1e-5)
    _close_hist(rt.distributions["r"], rj.distributions["r"])
    spec_t, spec_j = ct.property("r").spec, cj.property("r").spec
    assert (spec_t.count_a, spec_t.count_b) == (spec_j.count_a, spec_j.count_b) == (192.0, 128.0)


def test_angle_and_dihedral_builtins_match_jax():
    from viamd_tpu.datagen import polyala_helix as j_polyala

    src = ("a = angle(1, 3, 5);\nt = dihedral(1, 3, 5, 8);\n"
           "u = dihedral(5, 8, 10, 12);\nd = distance(3, 400);\n")
    sys_j, traj = j_polyala(64, n_frames=6, seed=4)
    frames, cells = traj.load_frames(range(6))
    ct, rt, cj, rj = _both(src, sys_j, frames, cells)
    for k in ("a", "t", "u"):
        assert ct.property(k).unit == "deg"
        np.testing.assert_allclose(rt.temporal[k], rj.temporal[k], atol=1e-4 * 57.3)
    np.testing.assert_allclose(rt.temporal["d"], rj.temporal["d"], atol=1e-5)
    for k in ("angles", "dihedrals", "lines"):
        assert ct.visualization[k] == cj.visualization[k]


def test_config5_script_matches_jax():
    """BASELINE config #5's script (tools/bench_configs.py:160-170) on a
    4,200-atom water box: distance and angle, the cell-list RDF, shape
    weights."""
    from viamd_tpu.datagen import water_box as j_water_box

    sys_j, traj = j_water_box(1400, n_frames=3, seed=6)
    frames, cells = traj.load_frames(range(3))
    ct, rt, cj, rj = _both(CONFIG5, sys_j, frames, cells)
    assert ct.routes == ["rdf:cell_list"]
    np.testing.assert_allclose(rt.temporal["d1"], rj.temporal["d1"], atol=1e-5)
    np.testing.assert_allclose(rt.temporal["a1"], rj.temporal["a1"], atol=1e-4 * 57.3)
    _close_hist(rt.distributions["r"], rj.distributions["r"])
    for k in ("lin", "plan", "iso"):
        np.testing.assert_allclose(rt.temporal[k], rj.temporal[k], atol=1e-5)


@pytest.mark.parametrize(
    "src, match",
    [
        ("d = distance(element('O'), 'H');", "expected an atom index, selection, or position"),
        ("a = angle(residue(1), 2, 3) in residues;", "inside 'in' must be used by a mappable"),
        ("t = dihedral(1, 2, 3, 9) in residue(1);", "relative atom index 9 out of range"),
        ("a = angle(1, 2);", "expected 3 atom indices"),
        ("d = distance(1, 2, 3);", r"distance\(a, b\)"),
        ("d = distance(0, 5);", "out of range"),
        ("d = distance(1, 301);", "out of range"),
    ],
)
def test_other_forms_raise(src, match):
    sys_, _ = water_box(100, n_frames=1, seed=0)  # 300 atoms
    with pytest.raises(ScriptError, match=match):
        compile_script(src, sys_, "cpu")


@pytest.mark.requires_cuda
def test_config1_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys_, traj = polyala_helix(64, n_frames=20)
    frames, cells = traj.load_frames(range(20))
    out = {}
    for dev in ("cpu", "cuda"):
        ct = compile_script(CONFIG1, sys_, dev)
        out[dev] = Evaluator(ct, trajectory_from_numpy(frames, cells, dev)).run()
    np.testing.assert_array_equal(out["cuda"].distributions["r"], out["cpu"].distributions["r"])
    np.testing.assert_allclose(out["cuda"].temporal["d1"], out["cpu"].temporal["d1"], atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["ortho", "triclinic", "aperiodic"])
def test_geometry_ops_on_the_card_match_cpu(name):
    """distance, angle and dihedral on CUDA against the CPU on the same
    inputs, at this file's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.RandomState(5)
    basis = _cell(name)
    x = rng.uniform(-2.0, 18.0, (200, 3)).astype(np.float32)
    idx = [rng.randint(0, 200, 64) for _ in range(4)]
    inv = inv_basis_of(torch.as_tensor(basis)).numpy()
    out = {}
    for dev in ("cpu", "cuda"):
        t = [torch.as_tensor(a, device=dev) for a in (x, *idx, basis, inv)]
        out[dev] = [getattr(t_geom, fn)(t[0], *t[1 : 1 + k], t[5], t[6]).cpu().numpy()
                    for fn, k in (("distance", 2), ("angle", 3), ("dihedral", 4))]
    for got, want, atol in zip(out["cuda"], out["cpu"], (1e-5, 1e-4, 1e-4)):
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.requires_cuda
def test_config5_on_the_card_matches_cpu():
    """BASELINE config #5's script on a 4,200-atom box: `d1`, `a1` (deg),
    `r` (the cell-list kernel on the card, all pairs on the CPU) and the
    shape weights on CUDA against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys_, traj = water_box(1400, n_frames=4, seed=6)
    frames, cells = traj.load_frames(range(4))
    out = {}
    for dev in ("cpu", "cuda"):
        ct = compile_script(CONFIG5, sys_, dev)
        assert ct.routes == ["rdf:cell_list"]
        out[dev] = Evaluator(ct, trajectory_from_numpy(frames, cells, dev)).run()
    got, want = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(got.distributions["r"], want.distributions["r"])
    np.testing.assert_allclose(got.temporal["d1"], want.temporal["d1"], atol=1e-5)
    np.testing.assert_allclose(got.temporal["a1"], want.temporal["a1"], atol=1e-4 * 57.3)
    for k in ("lin", "plan", "iso"):
        np.testing.assert_allclose(got.temporal[k], want.temporal[k], atol=1e-5)
