"""The VIAMD script language in the port against viamd_tpu on the CPU:
operators, `in` and mapping, subscripts of values, array literals, every
geometry and math builtin, the ops under them, the builtin registry, and
the reference's default script on the poly-alanine helix.

The JAX package is imported inside the parity tests only, so the tests
marked `requires_cuda` collect on a machine with a GPU and no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_script_lang.py

Oracles: TestCompile and TestEvaluate (tests/test_script.py:163, :362),
TestPBC, TestCOM, TestGeometry and TestKabschRMSD (tests/test_ops.py:22,
:82, :170, :769).

Tolerances (float32 in both packages, sums and products taken in another
order, FMA contraction on the JAX CPU backend only):
- counts, selections, RDF bins, comparisons: exact;
- distances, COMs, positions, distance_min/max: rtol 1e-5, atol 1e-4 Å (a
  gathered sum in the port, a dense one over every atom in JAX);
- angles and dihedrals: 1e-4 rad (5.73e-3 deg);
- rmsd, plane, shape weights of mass-weighted structures, and the SDF
  volume: 1e-3 — the closed-form float32 3x3 eigen solve drifts ~1e-4 and
  drifts differently in the two packages (ROADMAP queue 3);
- math of equal inputs: rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.datagen import polyala_helix
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.ops import com as t_com
from viamd_tpu_torch.ops import covariance as t_cov
from viamd_tpu_torch.ops import geometry as t_geom
from viamd_tpu_torch.ops import pbc as t_pbc
from viamd_tpu_torch.ops import rmsd as t_rmsd
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.script import ScriptError, compile_script
from viamd_tpu_torch.script.compiler import BUILTINS, NOT_PORTED, NULLARY

DEFAULT = (
    's1 = resname("ALA")[2:8];\n'
    "d1 = distance(10,30);\n"
    'a1 = angle(2,1,3) in resname("ALA");\n'
    "r = rdf(element('C'), element('H'), 10.0);\n"
    "v = sdf(s1, element('H'), 10.0);\n"
    "{lin,plan,iso} = shape_weights(all);\n"
)

# one script over the language: (name, kind) → tolerance class below
LANG = """
d1 = distance(10, 30);
dd = distance(1, 3) in residues;
dc = distance(com(residue(1)), com(residue(5)));
dp = distance(5, residue(3));
dv = distance(vec3(1.0, 2.0, 3.0), 7);
a1 = angle(2, 1, 3) in resname('ALA');
ap = angle(residue(1), residue(2), 30);
ac = angle(com(residue(2)), 9, vec3(0.0, 0.0, 0.0));
h1 = dihedral(1, 3, 5, 7) in residues;
hp = dihedral(1, 2, 3, residue(4));
c1 = com(residue(1:3));
c2 = com(element('C')) in residues;
c3 = com() in residue(2);
c4 = com(all);
cx = com(residue(2))[1];
m1 = distance_min(residue(1), residue(3));
m2 = distance_max(residue(1), residue(3) or residue(1));
m3 = distance_min(residue(1:2), residue(2:3));
pr = distance_pair(residue(1), residue(2));
n1 = count(element('C'));
n2 = count(all) in residue(1);
n3 = count(backbone);
pl = plane(residue(1:4));
rm = rmsd(residue(1:4));
rr = rmsd(all) in residues;
{l1, p1, i1} = shape_weights(residue(2:5));
{l2, p2, i2} = shape_weights(all) in residues;
ss = shape_weights(resname('ALA'));
o1 = d1 + 1.5;
o2 = 2 * d1 - dd;
o3 = d1 / 4;
o4 = d1 > 5.0;
o5 = dd <= 1.6;
o6 = -d1;
o7 = dd[2:4];
o8 = dd[3];
o9 = (d1 == d1) + (d1 != d1);
o10 = {d1, d1 * 2.0};
o11 = 3 - {1.0, 2.0} * 2;
o12 = {1, 2, 3}[2];
o13 = {1.5, 2.5, 3.5}[2:3];
o14 = 7 / 2 + 1;
o15 = 2 < 3;
o16 = -{1.0, 2.0};
o17 = c1[2:3] * 2;
o18 = {2.0, 3.0, 4.0} + c1;
"""

MATH = """
v = vec3(0.3, 0.5, 2.0);
u = vec4(0.1, 0.2, 0.3, 0.4);
w = vec2(1.0, -2.0);
f01 = sqrt(v); f02 = cbrt(v - 1.0); f03 = abs(-v); f04 = floor(v * 3.0); f05 = ceil(v * 3.0);
f06 = cos(v); f07 = sin(v); f08 = tan(v); f09 = asin(v * 0.4); f10 = acos(v * 0.4);
f11 = atan(v); f12 = log(v); f13 = exp(v); f14 = log2(v); f15 = exp2(v); f16 = log10(v);
f17 = pow(v, 2); f18 = pow(2, v); f19 = atan2(v, 0.7); f20 = atan2(1.0, v); f21 = mul(v, 3);
f22 = dot(v, {1.0, 2.0, 3.0}); f23 = cross(v, vec3(0.0, 1.0, 0.0)); f24 = cross(w, {3.0, 4.0});
f25 = dot(u, u); f26 = mul(2, v); f27 = pow(v, v);
g01 = sqrt(2.0); g02 = cbrt(-8.0); g03 = abs(-2.5); g04 = floor(2.7); g05 = exp(1.0);
g06 = pow(2.0, 0.5); g07 = atan2(1.0, 2.0); g08 = mul(2.5, 4.0); g09 = log10(1000.0);
g10 = sqrt({4.0, 9.0}); g11 = cos(0.25);
"""

# tolerance class of each name in LANG (atol in its unit): default 1e-4 Å
ANGLES = {"a1", "ap", "ac", "h1", "hp"}
KABSCH = {"pl", "rm", "rr", "l1", "p1", "i1", "l2", "p2", "i2", "ss"}
EXACT = {"n1", "n2", "n3", "o4", "o5", "o9", "o11", "o12", "o13", "o14", "o15", "o16"}


def _jax_run(src, sys_j, frames, cells):
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io.trajectory import InMemoryTrajectory
    from viamd_tpu.script import compile_script as j_compile

    cj = j_compile(src, sys_j)
    return cj, JEvaluator(cj, InMemoryTrajectory(frames, cells), chunk=len(frames),
                          batch_mode="map").run()


def _port_run(src, sys_t, frames, cells, device="cpu"):
    ct = compile_script(src, sys_t, device)
    return ct, Evaluator(ct, trajectory_from_numpy(frames, cells, device), chunk=5).run()


def _same_meta(ct, cj):
    key = lambda p: (p.name, p.kind, p.dim, p.unit)  # noqa: E731
    assert sorted(map(key, ct.properties)) == sorted(map(key, cj.properties))
    for p in cj.properties:
        q = ct.property(p.name)
        assert (q.structures is None) == (p.structures is None), p.name
        for a, b in zip(q.structures or [], p.structures or []):
            np.testing.assert_array_equal(a, b)


def _cell(name):
    if name == "ortho":
        return np.diag([14.0, 15.0, 16.0]).astype(np.float32)
    if name == "triclinic":
        return np.array([[15, 0, 0], [4, 14, 0], [-3, 2, 16]], np.float32)
    return np.zeros((3, 3), np.float32)


@pytest.fixture(scope="module")
def helix():
    from tests._torch_parity import port_system
    from viamd_tpu.datagen import polyala_helix as j_polyala

    sys_j, traj = j_polyala(16, n_frames=8, seed=1)
    frames, cells = traj.load_frames(range(8))
    return sys_j, port_system(sys_j), frames, cells


# -- ops ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ortho", "triclinic", "aperiodic"])
def test_ops_match_jax(name):
    """The new ops on the same inputs: pbc, com, covariance, rmsd and
    geometry (distance_min_max against the JAX dense masked form)."""
    import jax.numpy as jnp

    from viamd_tpu.ops import com as j_com
    from viamd_tpu.ops import covariance as j_cov
    from viamd_tpu.ops import geometry as j_geom
    from viamd_tpu.ops import pbc as j_pbc
    from viamd_tpu.ops import rmsd as j_rmsd

    rng = np.random.RandomState(7)
    B = _cell(name)
    Iv = inv_basis_of(torch.as_tensor(B)).numpy()
    x = rng.uniform(-2.0, 18.0, (120, 3)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    close = lambda g, w, **kw: np.testing.assert_allclose(  # noqa: E731
        np.asarray(g), np.asarray(w), **kw)
    args = (B, Iv)
    d = rng.uniform(-20, 20, (200, 3)).astype(np.float32)
    close(t_pbc.min_image_exact(t(d), t(B), t(Iv)), j_pbc.min_image_exact(d, *args), atol=1e-4)
    traj = np.cumsum(rng.normal(scale=3.0, size=(5, 40, 3)), 0).astype(np.float32)
    close(t_pbc.unwrap_frames(t(traj), t(B), t(Iv)), j_pbc.unwrap_frames(traj, *args), atol=1e-4)
    close(t_pbc.pair_distances(t(x[:30]), t(x[30:70]), t(B), t(Iv)),
          j_pbc.pair_distances(x[:30], x[30:70], *args), rtol=1e-5, atol=1e-4)
    seg = np.repeat(np.arange(40), 3)
    w = rng.uniform(1.0, 16.0, 120).astype(np.float32)
    close(t_com.com_segments(t(x), t(w), t(seg), 40, t(B), t(Iv)),
          j_com.com_segments(x, w, seg, 40, *args), atol=1e-4)
    close(t_com.centroid(t(x), t(w > 8), t(B), t(Iv)),
          j_com.centroid(x, jnp.asarray(w > 8), *args), atol=1e-4)
    close(t_pbc.recenter_frame(t(x), t(w > 8), t(seg), 40, t(B), t(Iv)),
          j_pbc.recenter_frame(x, jnp.asarray(w > 8), seg, 40, *args), atol=1e-4)
    idx = rng.randint(0, 120, (6, 9))
    wi = w[idx] * (rng.rand(6, 9) > 0.2)
    want = [j_com.com(x[i], wi[k], *args) for k, i in enumerate(idx)]
    close(t_com.com(t(x)[t(idx)], t(wi), t(B), t(Iv)), want, atol=1e-4)
    cm, vals, vecs = t_cov.principal_axes(t(x), t(w), t(B), t(Iv))
    jcm, jvals, jvecs = j_cov.principal_axes(x, w, *args)
    close(cm, jcm, atol=1e-4)
    close(vals, jvals, rtol=1e-3)
    close(np.abs(vecs.numpy()), np.abs(np.asarray(jvecs)), atol=1e-3)
    close(t_cov.gyration_radius(t(x), t(w), t(B), t(Iv)), j_cov.gyration_radius(x, w, *args),
          rtol=1e-5)
    # rmsd: batched over 6 structures against the JAX loop; an exact
    # rotation aligns to ~0 (TestKabschRMSD)
    p = rng.normal(size=(6, 9, 3)).astype(np.float32)
    q = (p + rng.normal(scale=0.3, size=p.shape)).astype(np.float32)
    want = [j_rmsd.rmsd(p[k], q[k], wi[k] + 1.0) for k in range(6)]
    close(t_rmsd.rmsd(t(p), t(q), t(wi + 1.0)), want, atol=1e-3)
    close(t_rmsd.rmsd(t(p), t(q), t(wi + 1.0), align=False),
          [j_rmsd.rmsd(p[k], q[k], wi[k] + 1.0, align=False) for k in range(6)], rtol=1e-5)
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    assert float(t_rmsd.rmsd(t(p[0] @ R.T), t(p[0]), torch.ones(9))) < 1e-3
    # distance_min_max over gathered sets (tiled small) against the dense
    # masked all-pairs form; overlapping sets pair an atom with itself
    ia, ib = np.arange(0, 50), np.arange(40, 120, 2)
    ma, mb = np.zeros(120, np.float32), np.zeros(120, np.float32)
    ma[ia], mb[ib] = 1, 1
    jlo, jhi = j_geom.distance_min_max(x, ma, mb, *args)
    lo, hi = t_geom.distance_min_max(t(x), t(ia), t(ib), t(B), t(Iv), max_pairs=300)
    assert float(lo) == 0.0 == float(jlo)
    close(hi, jhi, rtol=1e-5, atol=1e-4)
    ib2 = np.arange(60, 120, 3)
    mb[:] = 0
    mb[ib2] = 1
    keep_a = rng.rand(50) > 0.5
    ma[:] = 0
    ma[ia[keep_a]] = 1
    jlo, jhi = j_geom.distance_min_max(x, ma, mb, *args)
    lo, hi = t_geom.distance_min_max(t(x), t(ia), t(ib2), t(B), t(Iv),
                                     mask_a=t(keep_a), max_pairs=64)
    close([lo, hi], [jlo, jhi], rtol=1e-5, atol=1e-4)
    lo, hi = t_geom.distance_min_max(t(x), t(ia), t(ib2), t(B), t(Iv),
                                     mask_a=t(np.zeros(50, bool)))
    assert float(lo) == np.inf and float(hi) == -np.inf
    close(t_geom.com_distance(t(x), t(ma * w), t(mb * w), t(B), t(Iv)),
          j_geom.com_distance(x, ma * w, mb * w, *args), rtol=1e-5, atol=1e-4)


# -- registry ---------------------------------------------------------------------


EXAMPLES = {
    "all": "all", "atoms": "atoms", "residues": "residues", "chains": "chains",
    "water": "water", "ion": "ion", "protein": "protein", "nucleic": "nucleic",
    "backbone": "backbone", "sidechain": "sidechain", "hetero": "hetero",
    "element": "element('C')", "name": "name('CA')", "type": "type('C*')",
    "label": "label('N')", "resname": "resname('ALA')", "resid": "resid(2:3)",
    "residue": "residue(1)", "chain": "chain(1)", "atom": "atom(1:3)",
    "within": "within(3.0, residue(1))", "x": "x(0.0:3.0)", "y": "y(:2.0)",
    "z": "z(1.0:)", "count": "count(element('C'))",
    "distance": "distance(1, 9)", "distance_min": "distance_min(residue(1), residue(2))",
    "distance_max": "distance_max(residue(1), residue(2))",
    "distance_pair": "distance_pair(residue(1), residue(2))",
    "angle": "angle(1, 2, 3)", "dihedral": "dihedral(1, 2, 3, 4)", "com": "com(residue(1))",
    "plane": "plane(residue(1:2))", "rmsd": "rmsd(residue(1:2))",
    "shape_weights": "shape_weights(all)", "rdf": "rdf(element('C'), element('H'), 8.0)",
    "sdf": "sdf(residue(1:2), element('H'), 5.0)",
    **{f: f"{f}(0.5)" for f in ("sqrt", "cbrt", "abs", "floor", "ceil", "cos", "sin", "tan",
                                "asin", "acos", "atan", "log", "exp", "log2", "exp2", "log10")},
    "pow": "pow(distance(1, 2), 2)", "atan2": "atan2(distance(1, 2), 1.0)",
    "dot": "dot(com(all), com(all))", "cross": "cross(com(all), vec3(0.0, 0.0, 1.0))",
    "vec2": "vec2(1, 2)", "vec3": "vec3(1, 2, 3)", "vec4": "vec4(1, 2, 3, 4)",
    "mul": "mul(distance(1, 2), 3)",
}


def test_every_builtin_compiles():
    """Every name the JAX compiler registers is a builtin or nullary of the
    port and compiles (`NOT_PORTED` is empty since `import` reads its
    tables through the port's io/; tests/test_torch_stream.py holds its
    values to the JAX compiler's)."""
    from viamd_tpu.script.compiler import BUILTINS as J_BUILTINS, NULLARY as J_NULLARY

    jax_names = set(J_BUILTINS) | set(J_NULLARY)
    assert NOT_PORTED == frozenset() and "import" in BUILTINS
    assert set(BUILTINS) | set(NULLARY) == jax_names
    assert set(EXAMPLES) == jax_names - {"import"}
    sys_, _ = polyala_helix(4, n_frames=1)
    src = "".join(f"v_{k} = {e};\n" for k, e in EXAMPLES.items())
    cs = compile_script(src, sys_, "cpu")
    assert len(cs.selections) + len(cs.properties) == len(EXAMPLES)
    with pytest.raises(ScriptError, match="import: unsupported file 'table.txt'"):
        compile_script("t = import('table.txt');", sys_, "cpu")


# -- scripts ------------------------------------------------------------------------


def test_language_script_matches_jax(helix):
    """Operators, `in` and mapping, subscripts, array literals and the
    geometry builtins in every argument form, over 8 frames."""
    sys_j, sys_t, frames, cells = helix
    cj, rj = _jax_run(LANG, sys_j, frames, cells)
    ct, rt = _port_run(LANG, sys_t, frames, cells)
    _same_meta(ct, cj)
    assert ct.warnings == cj.warnings
    for k in ("lines", "angles", "dihedrals"):
        assert ct.visualization[k] == cj.visualization[k], k
    assert set(rt.temporal) == set(rj.temporal)
    for k, want in rj.temporal.items():
        got, want = rt.temporal[k], np.asarray(want).reshape(rt.temporal[k].shape)
        assert np.isfinite(got).all(), k
        if k in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k in ANGLES:
            np.testing.assert_allclose(got, want, atol=1e-4 * 57.29577951308232, err_msg=k)
        elif k in KABSCH:
            np.testing.assert_allclose(got, want, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=k)
    assert rt.temporal["dd"].shape == (8, 16) and rt.temporal["a1"].shape == (8, 16)
    assert rt.temporal["c2"].shape == (8, 48) and rt.temporal["rr"].shape == (8, 16)
    assert rt.temporal["o7"].shape == (8, 3) and rt.temporal["pr"].shape == (8, 49)
    assert ct.property("a1").structures is not None


def test_frames_reuse_the_first_walk():
    """Every selection, index tensor and device constant is made on the
    first walk (compile): later frames add nothing to the compiler's
    caches, so they copy nothing from the host."""
    from viamd_tpu_torch.script import parser as P
    from viamd_tpu_torch.script.compiler import _Compiler

    sys_, traj = polyala_helix(16, n_frames=3, seed=1)
    frames, _ = traj.load_frames(range(3))
    src = LANG + MATH + DEFAULT + ("w = count(within(3.0, residue(2)) or x(0.0:2.0));\n"
                                   "cz = com();\n")
    comp = _Compiler(sys_, torch.device("cpu"))
    cs = comp.compile(P.parse(src), src)
    sizes = (len(comp.value_cache), len(comp.static_cache), len(comp._memo))
    basis = torch.zeros(3, 3)
    for f in frames:
        cs.frame_fn(torch.as_tensor(f), basis, basis)
    assert (len(comp.value_cache), len(comp.static_cache), len(comp._memo)) == sizes


def test_math_matches_jax(helix):
    """Every math builtin, on per-frame values (torch) and on numbers
    (numpy), of equal inputs: rtol 1e-6."""
    sys_j, sys_t, frames, cells = helix
    cj, rj = _jax_run(MATH, sys_j, frames[:2], cells[:2])
    ct, rt = _port_run(MATH, sys_t, frames[:2], cells[:2])
    _same_meta(ct, cj)
    assert len(rt.temporal) == len(rj.temporal) == 41
    for k, want in rj.temporal.items():
        got = rt.temporal[k]
        np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_reference_default_script_matches_jax(helix):
    """VIAMD's default script (src/main.cpp:513-530; Session.load_demo) on
    the port's own polyala_helix(16, 8 frames), postprocess included,
    against the JAX package's: the systems are identical, r bin for bin,
    d1 1e-4 Å, a1 1e-4 rad, the shape weights and v 1e-3."""
    from viamd_tpu.datagen import polyala_helix as j_polyala

    sys_j, _ = j_polyala(16, n_frames=8, seed=1)
    sys_t, traj = polyala_helix(16, n_frames=8, seed=1)
    np.testing.assert_array_equal(sys_t.bonds, sys_j.bonds)
    np.testing.assert_array_equal(sys_t.flags, sys_j.flags)
    np.testing.assert_array_equal(sys_t.backbone.atom_ca, sys_j.backbone.atom_ca)
    frames, cells = traj.load_frames(range(8))
    cj, rj = _jax_run(DEFAULT, sys_j, frames, cells)
    ct, rt = _port_run(DEFAULT, sys_t, frames, cells)
    assert ct.routes == ["rdf:dense", "sdf:dense"]
    _same_meta(ct, cj)
    assert ct.selections["s1"].n_structures == 7
    np.testing.assert_array_equal(rt.distributions["r"], rj.distributions["r"])
    np.testing.assert_allclose(rt.temporal["d1"], rj.temporal["d1"], atol=1e-4)
    assert rt.temporal["a1"].shape == (8, 16)
    np.testing.assert_allclose(rt.temporal["a1"], rj.temporal["a1"], atol=1e-4 * 57.3)
    for k in ("lin", "plan", "iso"):
        np.testing.assert_allclose(rt.temporal[k], rj.temporal[k], atol=1e-3)
    v, vj = rt.volumes["v"], np.asarray(rj.volumes["v"])
    assert v.sum() > 0
    np.testing.assert_allclose(v, vj, rtol=1e-3, atol=1e-3 * vj.max())


@pytest.mark.parametrize("src", [
    "d = distance(1, 2) + element('C');",
    "d = distance(1, 2) in residue(99);",
    "a = angle(9, 1, 2) in residue(1);",
    "a = angle(1, residue(1), 2) in residues;",
    "t = dihedral(1, 2, 3, 'O');",
    "d = distance(1, 2, 3);",
    "p = distance_pair(all, element('Qq'));",
    "m = distance_min(residue(1), element('Qq'));",
    "c = com(element('Xx'));",
    "v = vec3(1, 2);",
    "s = sqrt(element('C'));",
    "s = sqrt(1, 2);",
    "x = 3; y = x[1];",
    "x = -element('C');",
    "x = 'a' + 1;",
    "{a, b} = distance(1, 2);",
    "v = {1.0, element('C')};",
    "p = pow(2, -1);",
    "d = dot(1, 2);",
    "c = cross(vec4(1, 2, 3, 4), vec4(1, 2, 3, 4));",
])
def test_errors_match_jax(helix, src):
    """Scripts the JAX compiler rejects with a ScriptError: the port rejects
    them with the same located message."""
    from viamd_tpu.script import compile_script as j_compile
    from viamd_tpu.script.parser import ScriptError as JScriptError

    sys_j, sys_t, _, _ = helix
    with pytest.raises(JScriptError) as ej:
        j_compile(src, sys_j)
    with pytest.raises(ScriptError) as et:
        compile_script(src, sys_t, "cpu")
    assert (et.value.line, et.value.col) == (ej.value.line, ej.value.col)
    if "cross" not in src and "dot" not in src:
        assert str(et.value) == str(ej.value)


def test_distance_pair_cap():
    """distance_pair holds at most 65,536 pairs (JAX compiler.py:1229)."""
    from viamd_tpu_torch.datagen import water_box

    sys_, _ = water_box(100, n_frames=1, seed=0)  # 300 atoms: 90,000 pairs
    with pytest.raises(ScriptError, match="300×300 pairs is too many"):
        compile_script("p = distance_pair(all, all);", sys_, "cpu")
    cs = compile_script("p = distance_pair(all, residue(1:72));", sys_, "cpu")
    assert cs.property("p").dim == 300 * 216


# -- on the card ------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["ortho", "triclinic", "aperiodic"])
def test_ops_on_the_card_match_cpu(name):
    """distance_min_max, the within mask, rmsd, the batched com and
    principal_axes on CUDA against the CPU, at this file's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.RandomState(4)
    B = _cell(name)
    x = rng.uniform(-2.0, 18.0, (3000, 3)).astype(np.float32)
    idx = rng.randint(0, 3000, (50, 7))
    w = rng.uniform(1, 16, (50, 7)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        b = t(B)
        inv = inv_basis_of(b)
        lo_hi = t_geom.distance_min_max(t(x), t(np.arange(100)), t(np.arange(200, 3000)),
                                        b, inv, max_pairs=1 << 16)
        out[dev] = [
            torch.stack(lo_hi),
            t_geom.within_mask(t(x), t(np.arange(0, 3000, 97)), 3.5, b, inv),
            t_rmsd.rmsd(t(x)[t(idx)], t(x + 0.1)[t(idx)], t(w)),
            t_com.com(t(x)[t(idx)], t(w), b, inv),
            t_cov.principal_axes(t(x), t(np.ones(3000, np.float32)), b, inv)[0],
        ]
    got = [v.cpu().numpy() for v in out["cuda"]]
    want = [v.cpu().numpy() for v in out["cpu"]]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-3)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-4)


@pytest.mark.requires_cuda
def test_language_on_the_card_matches_cpu():
    """The language and math scripts on CUDA against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys_t, traj = polyala_helix(16, n_frames=6, seed=1)
    frames, cells = traj.load_frames(range(6))
    for src in (LANG, MATH, DEFAULT):
        _, got = _port_run(src, sys_t, frames, cells, "cuda")
        _, want = _port_run(src, sys_t, frames, cells, "cpu")
        for k, v in want.temporal.items():
            tol = 1e-4 * 57.3 if k in ANGLES else 1e-3
            np.testing.assert_allclose(got.temporal[k], v, rtol=1e-5, atol=tol, err_msg=k)
        for k, v in want.distributions.items():
            np.testing.assert_array_equal(got.distributions[k], v)
