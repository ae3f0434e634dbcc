"""Dynamic selections in the port against viamd_tpu on the CPU: `within`,
`x`/`y`/`z`, their boolean combinations, the consumers that re-evaluate
them on every frame (count, com, positions, distance_min/max, rdf), the
static-context rule, the warnings, filter queries with `coords=`, and a
differential fuzz of generated scripts.

Oracles: TestDynamicProperties and TestDynamicFilter
(tests/test_script.py:652, :791), tests/test_script_fuzz.py.

Tolerances: counts and masks exact (both packages compare float32 d² with
float32 cutoff², and the float64 numpy counts agree away from the cutoff,
which these frames keep clear of); distance_min/max and COMs rtol 1e-5,
atol 1e-4 Å; the per-frame-normalised dynamic RDF rtol 1e-6 (float32
divisions summed over frames in another order); fuzzed values rtol 1e-4,
atol 1e-3; rtol 0.1, atol 1e-2 in scripts with rmsd, plane or
shape_weights of arbitrary atom sets, where the float32 closed-form eigen
solve of both packages loses digits (see the fuzz; ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.script import ScriptError, compile_script
from viamd_tpu_torch.script.filterlang import evaluate_filter

DYNAMIC = """
c = count(within(3.5, residue(1)));
b = count(within(3.5, residue(1)) and element('O'));
nn = count(not within(3.5, residue(1)));
nx = count(x(0.0:10.0));
ny = count(y(:5.0) or z(15.0:));
nz = count(within(5.0, residue(2)) and not x(:10.0));
k = count(within(3.5, residue(1))) in residue(1:10);
d = distance_min(within(3.0, residue(1)), residue(2));
e = distance_max(within(3.0, residue(1)), residue(2));
f = distance_min(within(4.0, residue(5)), within(4.0, residue(6)));
p = com(within(5.0, residue(3)));
q = distance(within(4.0, residue(1)), 100);
a = angle(within(4.0, residue(1)), 1, residue(9));
s = count(within(2.0, residues(atom(4))));
"""


def _both(src, sys_j, frames, cells):
    from tests._torch_parity import port_system
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io.trajectory import InMemoryTrajectory
    from viamd_tpu.script import compile_script as j_compile

    cj = j_compile(src, sys_j)
    rj = JEvaluator(cj, InMemoryTrajectory(frames, cells), chunk=len(frames),
                    batch_mode="map").run()
    ct = compile_script(src, port_system(sys_j), "cpu")
    rt = Evaluator(ct, trajectory_from_numpy(frames, cells, "cpu"), chunk=2).run()
    return cj, rj, ct, rt


def _numpy_within_count(x, tgt, cut, box):
    d = x[:, None, :].astype(np.float64) - x[None, tgt, :]
    if box is not None:
        d -= np.round(d / box) * box
    return int((np.sqrt((d ** 2).sum(-1)).min(axis=1) <= cut).sum())


def test_dynamic_properties_match_jax(water):
    """Per-frame counts, set distances, COMs and positions of dynamic
    selections over the water fixture's 5 frames: exact counts against the
    JAX package and a float64 numpy count; the counts vary by frame."""
    sys_j, traj = water
    frames, cells = traj.load_frames(range(traj.num_frames))
    cj, rj, ct, rt = _both(DYNAMIC, sys_j, frames, cells)
    assert ct.warnings == cj.warnings == []
    for k in ("c", "b", "nn", "nx", "ny", "nz", "k", "s"):
        np.testing.assert_array_equal(rt.temporal[k], np.asarray(rj.temporal[k]), err_msg=k)
    for k in ("d", "e", "f", "p", "q"):
        np.testing.assert_allclose(rt.temporal[k], np.asarray(rj.temporal[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(rt.temporal["a"], np.asarray(rj.temporal["a"]), atol=1e-4 * 57.3)
    box = np.asarray(sys_j.cell.extent(), np.float64)
    want = [_numpy_within_count(f, np.arange(3), 3.5, box) for f in frames]
    np.testing.assert_array_equal(rt.temporal["c"][:, 0], want)
    assert len(set(want)) > 1
    np.testing.assert_array_equal(rt.temporal["c"][:, 0] + rt.temporal["nn"][:, 0], 192)
    nx = [int(((f[:, 0] >= 0.0) & (f[:, 0] <= 10.0)).sum()) for f in frames]
    np.testing.assert_array_equal(rt.temporal["nx"][:, 0], nx)


def test_within_on_other_cells_matches_jax():
    """The reference mask's other host path (the float64 chunked pass, for
    triclinic and aperiodic cells) and the per-frame mask on those cells."""
    from viamd_tpu.core.system import build_system, postprocess
    from viamd_tpu.core.unitcell import UnitCell
    from viamd_tpu.datagen import polyala_helix as j_polyala

    rng = np.random.RandomState(2)
    B = np.array([[18, 0, 0], [5, 17, 0], [-4, 3, 19]], np.float32)
    n = 300
    x = (rng.rand(n, 3) @ B).astype(np.float32)
    sys_tri = postprocess(build_system(
        coords=x, atom_names=["OW", "HW1", "HW2"] * 100, res_names=["SOL"] * n,
        res_ids=np.repeat(np.arange(1, 101), 3), cell=UnitCell.from_basis(B)))
    frames = (x[None] + rng.normal(scale=0.3, size=(4, n, 3))).astype(np.float32)
    cells = np.broadcast_to(B, (4, 3, 3)).copy()
    src = ("c = count(within(4.0, residue(1:3)));\n"
           "d = distance_min(within(5.0, residue(4)), residue(9));\n"
           "w = within(6.0, residue(2));\n")
    cj, rj, ct, rt = _both(src, sys_tri, frames, cells)
    from tests.test_torch_selections import _same_selection

    _same_selection(ct.selections["w"], cj.selections["w"])
    np.testing.assert_array_equal(rt.temporal["c"], np.asarray(rj.temporal["c"]))
    np.testing.assert_allclose(rt.temporal["d"], np.asarray(rj.temporal["d"]), rtol=1e-5, atol=1e-4)
    # aperiodic: the Session demo (TestDynamicProperties' fallback oracle)
    sys_a, traj_a = j_polyala(8, n_frames=6)
    fa, ca = traj_a.load_frames(range(6))
    cj, rj, ct, rt = _both("c = count(within(4.0, residue(1)));", sys_a, fa, ca)
    tgt = np.arange(sys_a.res_offsets[0], sys_a.res_offsets[1])
    want = [_numpy_within_count(f, tgt, 4.0, None) for f in fa]
    np.testing.assert_array_equal(rt.temporal["c"][:, 0], want)
    np.testing.assert_array_equal(rt.temporal["c"], np.asarray(rj.temporal["c"]))


def test_dynamic_rdf_matches_jax(water):
    """rdf of a dynamic side: per-frame normalised, spec counts 1; an x range
    covering the box equals the static rdf after normalisation."""
    sys_j, traj = water
    frames, cells = traj.load_frames(range(traj.num_frames))
    src = ("r = rdf(within(6.0, residue(1)), element('O'), 6.0);\n"
           "s = rdf(x(-100.0:100.0), element('O'), 6.0);\n"
           "t = rdf(all, element('O'), 6.0);\n"
           "u = rdf(element('H'), within(5.0, residue(3)) or residue(7), 5.0);\n")
    cj, rj, ct, rt = _both(src, sys_j, frames, cells)
    assert ct.routes == ["rdf:dynamic", "rdf:dynamic", "rdf:dense", "rdf:dynamic"]
    for k in ("r", "s", "u"):
        spec = ct.property(k).spec
        assert (spec.count_a, spec.count_b) == (1.0, 1.0)
        np.testing.assert_allclose(rt.distributions[k], np.asarray(rj.distributions[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
        assert rt.distributions[k].sum() > 0
    vol = float(np.prod(sys_j.cell.extent()))
    g_d = rt.normalized_distribution("s", vol)
    g_s = rt.normalized_distribution("t", vol)
    np.testing.assert_allclose(g_d, g_s, rtol=1e-3, atol=1e-4)


def test_context_rules_and_warnings_match_jax(ala_system):
    """A dynamic `in` context is a typed error; static-only consumers of a
    dynamic selection warn (reference frame), as does a dynamic `within`
    target; the same texts as the JAX package."""
    from tests._torch_parity import port_system
    from viamd_tpu.script import compile_script as j_compile
    from viamd_tpu.script.parser import ScriptError as JScriptError

    st = port_system(ala_system)
    for src in ("a = com(all) in within(5.0, resname('ALA'));",
                "a = count(all) in x(0.0:10.0);",
                "a = count(all) in resname('GLY');"):
        with pytest.raises(JScriptError) as ej:
            j_compile(src, ala_system)
        with pytest.raises(ScriptError, match="static|matches nothing") as et:
            compile_script(src, st, "cpu")
        assert str(et.value) == str(ej.value)
    src = ("r = rmsd(within(5.0, resname('ALA')));\n"
           "p = plane(within(5.0, residue(1)));\n"
           "w = within(2.0, within(3.0, residue(1)));\n"
           "c = count(w);\n"
           "v = sdf(residue(1:2), within(5.0, residue(3)), 4.0);\n"
           "s = shape_weights(within(5.0, residue(1)));\n"
           "q = distance_pair(residue(1), within(3.0, residue(2)));\n"
           "m = com(within(3.0, residue(4))) in residues;\n"
           "d = distance(w, 3);\n")
    cj = j_compile(src, ala_system)
    ct = compile_script(src, st, "cpu")
    assert any("reference frame" in w for w in ct.warnings)
    assert ct.warnings == cj.warnings
    assert len(ct.warnings) == 9


def test_filters_follow_coords_like_jax(ala_system):
    """TestDynamicFilter: `coords=` re-evaluates dynamic selections on the
    given frame."""
    from tests._torch_parity import port_system
    from viamd_tpu.script import evaluate_filter as j_filter

    st = port_system(ala_system)
    far = ala_system.coords().copy()
    far[1:] += 100.0
    for expr in ("within(2.0, atom(1))", "x(0.0:10.0) and not within(2.0, atom(3))",
                 "within(5.0, residue(2)) or name('CA')"):
        for coords in (None, far):
            m_t, dyn_t = evaluate_filter(expr, st, coords=coords, device="cpu")
            m_j, dyn_j = j_filter(expr, ala_system, coords=coords)
            assert dyn_t and dyn_j
            np.testing.assert_array_equal(m_t.words, m_j.words)
    m2, _ = evaluate_filter("within(2.0, atom(1))", st, coords=far, device="cpu")
    m1, _ = evaluate_filter("within(2.0, atom(1))", st, device="cpu")
    assert m2.popcount() == 1 < m1.popcount()


# -- differential fuzz ---------------------------------------------------------------

SELS = ["all", "protein", "backbone", "element('C')", "residue(1:2)", "resname('ALA')",
        "within(3.0, residue(2))", "x(0.0:20.0)", "atom(1:5)", "name('CA')",
        "residues(atom(3))", "sidechain", "atoms(2, 4)"]
# rmsd, plane and shape_weights are left out: on arbitrary atom sets their
# float32 eigen solve loses digits in both packages (see _agree_on_frame0);
# test_torch_script_lang.py holds them on whole residues
VALS = ["distance(1, 7)", "distance(com(SEL), 5)", "angle(1, 2, 3)", "count(SEL)",
        "distance_min(SEL, SEL)", "distance_max(SEL, SEL)", "com(SEL)[2]",
        "dihedral(1, 2, 3, SEL)", "angle(SEL, 3, 9)", "2.5",
        "distance(1, 2) in residues", "count(SEL) in residue(2)",
        "com(SEL) in residues", "distance(SEL, com(SEL))"]
OPS = [" + ", " - ", " * ", " / ", " > ", " <= ", " == "]


def _sel_expr(rng, depth=0):
    r = rng.rand()
    if depth > 2 or r < 0.5:
        return rng.choice(SELS)
    if r < 0.8:
        return f"{_sel_expr(rng, depth + 1)} {rng.choice(['and', 'or'])} {_sel_expr(rng, depth + 1)}"
    return f"not {_sel_expr(rng, depth + 1)}"


def _val_expr(rng, depth=0):
    r = rng.rand()
    if depth > 2 or r < 0.45:
        v = rng.choice(VALS)
        while "SEL" in v:
            v = v.replace("SEL", _sel_expr(rng), 1)
        return v
    if r < 0.8:
        return f"({_val_expr(rng, depth + 1)}){rng.choice(OPS)}({_val_expr(rng, depth + 1)})"
    return f"{rng.choice(['sqrt', 'abs', 'cos', '-'])}({_val_expr(rng, depth + 1)})"


def _typed_script(rng):
    return "\n".join(f"v{i} = {_val_expr(rng)};" for i in range(rng.randint(1, 4)))


def _agree_on_frame0(src, sys_j, sys_t, x0):
    """"error" when both raise a ScriptError with one message, "compiled"
    when both compile and agree on frame 0, `x0`. The JAX package may raise a non-typed
    exception (its BinOp lets a shape mismatch through); the port then
    raises a ScriptError there."""
    import jax.numpy as jnp

    from viamd_tpu.script import compile_script as j_compile
    from viamd_tpu.script.parser import ScriptError as JScriptError

    try:
        cj, je = j_compile(src, sys_j), None
    except Exception as e:  # noqa: BLE001 — compared below
        cj, je = None, e
    try:
        ct, te = compile_script(src, sys_t, "cpu"), None
    except Exception as e:  # noqa: BLE001
        ct, te = None, e
    if je is not None or te is not None:
        assert je is not None and te is not None, (src, je, te)
        if isinstance(je, JScriptError):
            assert isinstance(te, ScriptError), (src, je, te)
            assert str(te) == str(je), src
        elif not isinstance(te, ScriptError):
            assert type(te) is type(je), (src, je, te)
        return "error"
    key = lambda p: (p.name, p.kind, p.dim, p.unit)  # noqa: E731
    assert sorted(map(key, ct.properties)) == sorted(map(key, cj.properties)), src
    assert ct.warnings == cj.warnings, src
    basis = np.asarray(sys_j.cell.basis, np.float32)
    inv = np.asarray(sys_j.cell.inv_basis, np.float32)
    tj, aj = cj.frame_fn(jnp.asarray(x0), jnp.asarray(basis), jnp.asarray(inv))
    tt, at = ct.frame_fn(*(torch.as_tensor(a) for a in (x0, basis, inv)))
    # both packages take the closed-form float32 eigen solve of a mass-
    # weighted 3x3 tensor, which on an arbitrary elongated atom set loses
    # digits: HᵀH squares the condition number. rmsd(element('C')) on this
    # frame: float64 0.53317, the port 0.53320, the JAX package 0.57464
    # (singular values 2732 / 48 / 15) — ROADMAP queue 3
    fragile = any(f in src for f in ("rmsd", "plane", "shape_weights"))
    rtol, atol = (0.1, 1e-2) if fragile else (1e-4, 1e-3)
    for k in tj:
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(tj[k]), rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=f"{k} of {src!r}")
    for k in aj:
        want = np.asarray(aj[k])
        np.testing.assert_allclose(at[k].numpy(), want, rtol=1e-4,
                                   atol=1e-3 * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"{k} of {src!r}")
    return "compiled"


def test_fuzzed_scripts_agree_with_jax(ala_system):
    """200 scripts of tests/test_script_fuzz.py::_rand_script and 100
    typed ones (selections, dynamic selections, geometry, operators, `in`):
    each raises a ScriptError in both packages or compiles in both and
    agrees on frame 0 — the reference coordinates jittered by 0.3 Å (on the
    reference frame itself an rmsd is float32 noise about 0)."""
    from tests._torch_parity import port_system
    from tests.test_script_fuzz import _rand_script

    st = port_system(ala_system)
    x0 = (ala_system.coords() + np.random.RandomState(3).normal(
        scale=0.3, size=(ala_system.natoms, 3))).astype(np.float32)
    outcomes = {"error": 0, "compiled": 0}
    rng = np.random.RandomState(17)
    for _ in range(200):
        outcomes[_agree_on_frame0(_rand_script(rng), ala_system, st, x0)] += 1
    assert outcomes["error"] > 100 and outcomes["compiled"] > 5, outcomes
    typed = {"error": 0, "compiled": 0}
    rng = np.random.RandomState(18)
    for _ in range(100):
        typed[_agree_on_frame0(_typed_script(rng), ala_system, st, x0)] += 1
    assert typed["compiled"] > 50, typed


# -- on the card ----------------------------------------------------------------------


@pytest.mark.requires_cuda
def test_dynamic_on_the_card_matches_cpu():
    """The dynamic script and a dynamic rdf on CUDA against the CPU: counts
    exact, set distances and COMs 1e-4 Å, the rdf rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from viamd_tpu_torch.datagen import water_box

    sys_, traj = water_box(400, n_frames=4, seed=1)
    frames, cells = traj.load_frames(range(4))
    src = DYNAMIC + "r = rdf(within(6.0, residue(1)), element('O'), 6.0);\n"
    out = {}
    for dev in ("cpu", "cuda"):
        ct = compile_script(src, sys_, dev)
        out[dev] = Evaluator(ct, trajectory_from_numpy(frames, cells, dev)).run()
    got, want = out["cuda"], out["cpu"]
    for k, v in want.temporal.items():
        if k in ("c", "b", "nn", "nx", "ny", "nz", "k", "s"):
            np.testing.assert_array_equal(got.temporal[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got.temporal[k], v, rtol=1e-5, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got.distributions["r"], want.distributions["r"], rtol=1e-6)
