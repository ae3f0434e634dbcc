"""Selections and topology of the port against viamd_tpu on the CPU: every
selection nullary and function, `in` clipping, `identifiers=`, filter
queries, and `postprocess` (element, radius and mass inference, residue
flags, bonds, backbone) with the bond search's three cell forms.

Oracles: TestSelections (tests/test_script.py:63) and TestSystemBuild
(tests/test_core.py:105). Everything compared here is host data, so every
comparison is exact: masks, structures, levels, dynamic flags, flags,
elements, masses, radii, sorted bond pairs and backbone arrays. Values on
frame 0 (`identifiers=`): counts exact, COMs within 1e-4 Å (a gathered sum
in the port, a dense one in the JAX package).
"""

import numpy as np
import pytest

from tests._torch_parity import port_system
from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.script import ScriptError, compile_script
from viamd_tpu_torch.script.filterlang import evaluate_filter, evaluate_filter_structures

SELECTIONS = """
s_all = all; s_atoms = atoms; s_res = residues; s_ch = chains;
s_w = water; s_ion = ion; s_p = protein; s_n = nucleic;
s_bb = backbone; s_sc = sidechain; s_h = hetero;
e1 = element('C'); e2 = element('C', 'N'); e3 = element(8); e4 = element('Carbon');
n1 = name('CA'); n2 = type('C*'); n3 = label('N', 'O'); n4 = name('ow', 'H?');
r1 = resname('ALA'); r2 = resname('GLY'); r3 = resname('S*', 'NA');
i1 = resid(2); i2 = resid(2:3); i3 = resid(:2); i4 = resid(3:);
q1 = residue(1:2); q2 = residue(4); q3 = residue(2, 4); q4 = residue(3:);
c1 = chain('A'); c2 = chain(2); c3 = chain(1:2); c4 = chain('?');
a1 = atom(1:3); a2 = atom(5, 7); a3 = atom(18:);
p1 = atoms(1:3); p2 = atoms(name('CA')); p3 = atoms(2, element('O'));
u1 = residues(name('CA')); u2 = residues(); u3 = residues(2:3); u4 = residues(atom(7), 1);
h1 = chains(atom(1)); h2 = chains(); h3 = chains('B', atom(20));
l1 = element('C') and backbone; l2 = element('C') or element('N'); l3 = not element('O');
x1 = residue(1:3)[2:3]; x2 = resname('ALA')[2]; x3 = residues[:2];
t1 = atom(2) in residue(1:3); t2 = all in residue(2); t3 = element('C') in residues;
t4 = residues in chain(1); t5 = (not element('C')) in residue(2); t6 = atoms in residue(1);
t7 = chains in residue(1:2); t8 = resname('ALA') in atom(1:7); t9 = residues(atom(3)) in residue(1:2);
"""


def _same_selection(got, want, name=""):
    assert got.mask.count == want.mask.count, name
    np.testing.assert_array_equal(got.mask.words, want.mask.words, err_msg=name)
    assert (got.level, got.dynamic) == (want.level, want.dynamic), name
    assert (got.mask_fn is None) == (want.mask_fn is None), name
    assert len(got.structures) == len(want.structures), name
    for a, b in zip(got.structures, want.structures):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _mixed_arrays():
    """A system with every residue class: amino acids in chain A, DNA in
    chain B, waters, an ion and a ligand — coordinates a random walk of
    ~1.45 Å steps (bonded neighbours), molecules apart."""
    residues = [
        ("ALA", "A", 1, ["N", "CA", "C", "O", "CB"]),
        ("GLY", "A", 2, ["N", "CA", "C", "O"]),
        ("ALA", "A", 3, ["N", "CA", "C", "OT1", "CB"]),
        ("DA", "B", 1, ["P", "O5'", "C5'"]),
        ("SOL", "W", 1, ["OW", "HW1", "HW2"]),
        ("SOL", "W", 2, ["OW", "HW1", "HW2"]),
        ("NA", "I", 1, ["NA"]),
        ("LIG", "L", 1, ["C1", "C2", "O1"]),
    ]
    rng = np.random.RandomState(11)
    names, rnames, rids, chains, coords = [], [], [], [], []
    pos = np.array([2.0, 2.0, 2.0])
    for k, (rn, ch, rid, ats) in enumerate(residues):
        if k in (3, 4, 5, 6, 7):  # a new molecule: jump away
            pos = pos + np.array([5.0, 3.0, 2.0])
        for a in ats:
            step = rng.normal(size=3)
            pos = pos + 1.45 * step / np.linalg.norm(step)
            names.append(a)
            rnames.append(rn)
            rids.append(rid)
            chains.append(ch)
            coords.append(pos.copy())
    return dict(coords=np.asarray(coords, np.float32), atom_names=names,
                res_names=rnames, res_ids=np.asarray(rids), chain_ids=chains)


def _cells(name, coords):
    """(3, 3) basis: none, a box around the walk, a skewed cell, a box
    under 3 bond cutoffs across (the bond search's brute-force form)."""
    span = coords.max(0) - coords.min(0)
    if name == "none":
        return np.zeros((3, 3), np.float32)
    if name == "ortho":
        return np.diag(span + 1.0).astype(np.float32)
    if name == "triclinic":
        L = float(span.max() + 2.0)
        return np.array([[L, 0, 0], [0.3 * L, L, 0], [-0.2 * L, 0.25 * L, L]], np.float32)
    return np.diag([7.0, 7.5, 8.0]).astype(np.float32)


def _build_both(arrays, basis):
    from viamd_tpu.core.system import build_system as j_build
    from viamd_tpu.core.unitcell import UnitCell as JCell
    from viamd_tpu_torch.core.system import build_system as t_build
    from viamd_tpu_torch.core.unitcell import UnitCell as TCell

    sj = j_build(**arrays, cell=JCell.from_basis(basis))
    st = t_build(**arrays, cell=TCell.from_basis(basis))
    return sj, st


@pytest.mark.parametrize("cell", ["none", "ortho", "triclinic", "small"])
def test_postprocess_matches_jax(cell):
    """Raw systems built from the same arrays in both packages, then each
    package's `postprocess`: every inferred field is identical."""
    from viamd_tpu.core.system import postprocess as j_post
    from viamd_tpu_torch.core.system import postprocess as t_post

    arrays = _mixed_arrays()
    coords = arrays["coords"]
    if cell == "small":  # wrap the walk into the small box
        arrays = dict(arrays, coords=np.mod(coords, np.diag(_cells(cell, coords))))
    sj, st = _build_both(arrays, _cells(cell, coords))
    sj, st = j_post(sj), t_post(st)
    for f in ("element", "radius", "mass", "flags", "res_offsets", "chain_offsets"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f), err_msg=f)
    assert st.nbonds > 10
    np.testing.assert_array_equal(np.sort(st.bonds, axis=0), np.sort(sj.bonds, axis=0))
    np.testing.assert_array_equal(st.bonds, sj.bonds)
    assert (st.backbone is None) == (sj.backbone is None)
    for f in ("res_idx", "atom_n", "atom_ca", "atom_c", "atom_o", "ranges"):
        np.testing.assert_array_equal(getattr(st.backbone, f), getattr(sj.backbone, f))
    # the TestSystemBuild facts, in the port
    assert st.backbone.count == 3 and st.element[0] == 7 and st.mass[0] > 14.0


def test_postprocess_water_and_wraparound_match_jax(water):
    """The water fixture (64 waters, bonds inferred across a periodic box)
    and a molecule straddling a 60° triclinic boundary (TestSystemBuild)."""
    from viamd_tpu.core.system import build_system as j_build, postprocess as j_post
    from viamd_tpu.core.unitcell import UnitCell as JCell
    from viamd_tpu.ops.bonds import infer_covalent_bonds as j_bonds
    from viamd_tpu_torch.core.system import build_system as t_build, postprocess as t_post
    from viamd_tpu_torch.core.unitcell import UnitCell as TCell
    from viamd_tpu_torch.ops.bonds import infer_covalent_bonds as t_bonds

    sj, _ = water
    raw = dict(coords=sj.coords(), atom_names=["OW", "HW1", "HW2"] * 64,
               res_names=["SOL"] * 192, res_ids=np.repeat(np.arange(1, 65), 3))
    st = t_post(t_build(**raw, cell=TCell.from_basis(sj.cell.basis)))
    sj2 = j_post(j_build(**raw, cell=JCell.from_basis(sj.cell.basis)))
    assert st.nbonds == sj2.nbonds == 128
    np.testing.assert_array_equal(st.bonds, sj2.bonds)
    np.testing.assert_array_equal(st.flags, sj2.flags)
    jc = JCell.from_lengths_angles(20, 20, 20, 90, 90, 60)
    tc = TCell.from_lengths_angles(20, 20, 20, 90, 90, 60)
    B = np.asarray(tc.basis, np.float64)
    o = np.array([0.3, 0.3, 0.3])
    h = o - 0.96 * B[0] / np.linalg.norm(B[0]) + B[0]
    x = np.stack([o, h]).astype(np.float32)
    z = np.array([8, 1])
    np.testing.assert_array_equal(t_bonds(x, z, tc), j_bonds(x, z, jc))
    assert t_bonds(x, z, tc).tolist() == [[0, 1]]


@pytest.fixture(scope="module")
def mixed_systems():
    from viamd_tpu.core.system import postprocess as j_post
    from viamd_tpu_torch.core.system import postprocess as t_post

    arrays = _mixed_arrays()
    sj, st = _build_both(arrays, _cells("ortho", arrays["coords"]))
    return j_post(sj), t_post(st)


def test_every_selection_matches_jax(mixed_systems):
    """One script binding every selection nullary and function (and their
    clipping inside `in`) on the mixed system: the port's selections are
    the JAX package's, structure for structure."""
    from viamd_tpu.script import compile_script as j_compile

    sj, st = mixed_systems
    cj = j_compile(SELECTIONS, sj)
    ct = compile_script(SELECTIONS, st, "cpu")
    assert sorted(ct.selections) == sorted(cj.selections)
    assert len(ct.selections) > 60
    for k in cj.selections:
        _same_selection(ct.selections[k], cj.selections[k], k)
    # the flag sets are not empty on this system
    for k in ("s_w", "s_ion", "s_p", "s_n", "s_bb", "s_sc", "s_h"):
        assert ct.selections[k].mask.popcount() > 0, k


def test_selection_errors_match_jax(mixed_systems):
    from viamd_tpu.script import compile_script as j_compile
    from viamd_tpu.script.parser import ScriptError as JScriptError

    sj, st = mixed_systems
    for src in ("s = element('Qq');", "s = residue(99);", "s = resid(1.5);",
                "s = atom(0);", "s = residue(1:2)[5];", "s = residue(1:2)[3:];",
                "s = name(3);", "s = within(2.0);", "s = x(1);",
                "s = element('C') in within(2.0, atom(1));",
                "s = element('C') in resname('XYZ');",
                "s = element('C') and 3;", "s = not 2;"):
        with pytest.raises(JScriptError) as ej:
            j_compile(src, sj)
        with pytest.raises(ScriptError) as et:
            compile_script(src, st, "cpu")
        assert str(et.value) == str(ej.value), src


def test_identifiers_inject_selections(ala_system):
    """`identifiers=` (main.cpp:860-863) against TestCompile's oracle:
    stored selections are script identifiers."""
    import jax.numpy as jnp

    from viamd_tpu.core.bitfield import Bitfield as JBitfield
    from viamd_tpu.script import compile_script as j_compile

    src = "c = count(mysel); s = mysel and element('C'); d = com(mysel); o = count(other);"
    ids_j = {"mysel": JBitfield.from_range(20, 0, 5), "other": JBitfield.from_indices(20, [3, 9])}
    ids_t = {"mysel": Bitfield.from_range(20, 0, 5), "other": Bitfield.from_indices(20, [3, 9])}
    st = port_system(ala_system)
    cj = j_compile(src, ala_system, identifiers=ids_j)
    ct = compile_script(src, st, "cpu", identifiers=ids_t)
    _same_selection(ct.selections["s"], cj.selections["s"])
    x0 = ala_system.coords()
    basis = np.asarray(ala_system.cell.basis, np.float32)
    inv = np.asarray(ala_system.cell.inv_basis, np.float32)
    tj, _ = cj.frame_fn(jnp.asarray(x0), jnp.asarray(basis), jnp.asarray(inv))
    tt, _ = ct.frame_fn(*(__import__("torch").as_tensor(a) for a in (x0, basis, inv)))
    assert float(tt["c"][0]) == float(tj["c"][0]) == 5.0
    assert float(tt["o"][0]) == 2.0
    np.testing.assert_allclose(tt["d"].numpy(), np.asarray(tj["d"]), atol=1e-4)
    with pytest.raises(ScriptError, match="undefined identifier 'mysel'"):
        compile_script(src, st, "cpu")


@pytest.mark.parametrize("expr", [
    "element('C')", "element('C') and backbone", "element('C') or element('N')",
    "not element('H')", 'name("CA")', 'resname("ALA")', 'resname("GLY")',
    "resid(2)", "residue(1:2)", "atoms(1:3)", "residues(name('CA'))",
    "residues()", "chains(atom(1))", "name('C*')", "within(2.0, name('CA'))",
])
def test_filters_match_jax(ala_system, expr):
    """evaluate_filter / evaluate_filter_structures on the TestSelections
    expressions: the same masks, structures and dynamic flags."""
    from viamd_tpu.script.filterlang import evaluate_filter_structures as j_filter

    st = port_system(ala_system)
    _same_selection(evaluate_filter_structures(expr, st, device="cpu"),
                    j_filter(expr, ala_system), expr)
    mask, dyn = evaluate_filter(expr, st, device="cpu")
    assert dyn == expr.startswith("within")


def test_filter_errors(ala_system):
    st = port_system(ala_system)
    for bad in ("bogus('X')", "distance(1,2)", "a = 1; b = 2;"):
        with pytest.raises(ScriptError):
            evaluate_filter(bad, st, device="cpu")


def test_filter_injects_identifiers(ala_system):
    """Stored selections reach filters too (the JAX filter ignores its
    `identifiers`: it never binds them, compiler.py:245 runs only in
    `_run`)."""
    st = port_system(ala_system)
    mask, _ = evaluate_filter("mine and element('C')", st,
                              {"mine": Bitfield.from_range(20, 0, 10)}, device="cpu")
    assert mask.indices().tolist() == [1, 2, 4, 6, 7, 9]
