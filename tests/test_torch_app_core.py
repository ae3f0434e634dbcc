"""The port's frame interpolation (ops/interpolate.py), selection utilities
(core/selection_utils.py), tracing (core/tracing.py) and per-segment COM
(ops/com.py::com_segments) against viamd_tpu on seeded numpy data. The
oracles are TestInterpolate (tests/test_ops.py), TestSelectionUtils
(tests/test_app.py), TestTracing (tests/test_core.py) and TestCom
(tests/test_ops.py).

Tolerances.
- Interpolated coordinates and the interpolated cell: 1e-5 absolute
  (float32; the same operations in the same order on both sides).
- Selections, script suggestions and atom ranges: exact.
- com_segments: within 1e-4 of the JAX package's float32 `segment_sum`
  (coordinates up to ~20 Å; the port sums in fixed point and rounds once,
  the JAX package in float32), and bit for bit the same under any
  permutation of the atoms (with their segment ids), which a float
  `index_add_` (the parent's sum, in input order) is not.

The JAX package and the tests package are imported inside the tests that
use them, so the tests marked `requires_cuda` collect on a machine that has
a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_app_core.py
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.core import selection_utils as PS
from viamd_tpu_torch.core import tracing as PT
from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.ops import com as PC
from viamd_tpu_torch.ops import interpolate as PI
from viamd_tpu_torch.ops.pbc import inv_basis_of

CELLS = {
    "ortho": np.diag([18.0, 21.0, 24.0]),
    "triclinic": np.array([[18.0, 0, 0], [4.0, 20.0, 0], [-3.0, 5.0, 22.0]]),
    "none": np.zeros((3, 3)),
}


def _cell(name):
    B = CELLS[name].astype(np.float32)
    return B, inv_basis_of(torch.as_tensor(B)).numpy()


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0])
def test_interpolate_matches_jax(cell, t):
    from viamd_tpu.ops import interpolate as JI

    rng = np.random.RandomState(3)
    B, Iv = _cell(cell)
    frames = [rng.uniform(-2.0, 22.0, (60, 3)).astype(np.float32)]
    for _ in range(3):  # steps that cross the boundary now and then
        frames.append((frames[-1] + rng.normal(scale=3.0, size=(60, 3))).astype(np.float32))
    xm1, x0, x1, x2 = frames
    lin = PI.interpolate_linear(_t(x0), _t(x1), t, _t(B), _t(Iv))
    np.testing.assert_allclose(lin.numpy(), JI.interpolate_linear(x0, x1, t, B, Iv), atol=1e-5)
    cub = PI.interpolate_cubic(_t(xm1), _t(x0), _t(x1), _t(x2), t, _t(B), _t(Iv))
    np.testing.assert_allclose(
        cub.numpy(), JI.interpolate_cubic(xm1, x0, x1, x2, t, B, Iv), atol=1e-5)
    b1 = B * 1.03
    np.testing.assert_allclose(PI.interpolate_cell(_t(B), _t(b1), t).numpy(),
                               JI.interpolate_cell(B, b1, t), atol=1e-5)


def test_interpolate_endpoints():
    """TestInterpolate: a boundary crossing blends through the image; the
    spline passes through its knots."""
    B, Iv = _cell("none")
    box = torch.diag(torch.full((3,), 10.0))
    inv = inv_basis_of(box)
    mid = PI.interpolate_linear(_t([[9.9, 0, 0]]).float(), _t([[0.3, 0, 0]]).float(), 0.5,
                                box, inv)
    np.testing.assert_allclose(mid[0, 0].item(), 10.1, atol=1e-4)
    f = [torch.full((1, 3), v) for v in (0.0, 1.0, 2.0, 3.0)]
    for t, want in ((0.0, 1.0), (1.0, 2.0)):
        got = PI.interpolate_cubic(*f, t, _t(B), _t(Iv))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.fixture(scope="module")
def systems():
    """The ALA fixture (six residues) and a periodic water box, in both
    packages."""
    from tests._torch_parity import port_system
    from tests.conftest import make_ala_pdb, make_water_box
    from viamd_tpu.io.pdb import parse_pdb

    ala, _ = parse_pdb(make_ala_pdb(6))
    water, traj = make_water_box(n_waters=40, box=12.0, n_frames=1)
    return {"ala": (ala, port_system(ala)),
            "water": (water, port_system(water), np.asarray(traj.load_frame(0)[0]))}


@pytest.mark.parametrize("expr", ["name('CA')", "atom(1)", "residue(2:3)", "element('O')"])
def test_grow_by_bonds_matches_jax(systems, expr):
    from viamd_tpu.core import selection_utils as JS
    from viamd_tpu.script import evaluate_filter

    jsys, psys = systems["ala"]
    mask, _ = evaluate_filter(expr, jsys)
    pmask = Bitfield.from_bools(mask.to_bools())
    for steps in (1, 2, 5):
        want = JS.grow_by_bonds(mask, jsys.bonds, steps).to_bools()
        got = PS.grow_by_bonds(pmask, psys.bonds, steps).to_bools()
        np.testing.assert_array_equal(got, want)
    assert PS.grow_by_bonds(pmask, psys.bonds[:0]).to_bools().sum() == mask.popcount()


@pytest.mark.parametrize("case", ["ala", "water_periodic", "water_triclinic"])
def test_grow_by_radius_matches_jax(systems, case):
    from viamd_tpu.core import selection_utils as JS
    from viamd_tpu.core.unitcell import UnitCell as JCell
    from viamd_tpu_torch.core.unitcell import UnitCell as PCell

    if case == "ala":
        jsys, psys = systems["ala"]
        x, jcell, pcell = jsys.coords(), None, None
    else:
        jsys, psys, x = systems["water"]
        basis = np.diag([12.0] * 3) if case == "water_periodic" else np.array(
            [[12.0, 0, 0], [3.0, 12.0, 0], [1.0, 2.0, 12.0]])
        jcell, pcell = JCell.from_basis(basis), PCell.from_basis(basis)
    rng = np.random.RandomState(5)
    for k in (1, 4):
        sel = np.zeros(jsys.natoms, bool)
        sel[rng.choice(jsys.natoms, k, replace=False)] = True
        for radius in (1.5, 3.0):
            from viamd_tpu.core.bitfield import Bitfield as JB

            want = JS.grow_by_radius(JB.from_bools(sel), x, radius, jcell).to_bools()
            got = PS.grow_by_radius(Bitfield.from_bools(sel), x, radius, pcell).to_bools()
            np.testing.assert_array_equal(got, want)
            assert got.sum() > k or radius < 3.0


@pytest.mark.parametrize("expr", ["residue(2:3)", "residue(1) or residue(4:6)", "element('N')",
                                  "atom(1:3) or atom(8) or atom(11:12)", "resname('ALA')"])
def test_selection_suggestions_match_jax(systems, expr):
    """TestSelectionUtils::test_selection_to_script_roundtrip and
    test_atom_ranges_compact: the same suggestions, and each reproduces
    the selection through the port's filter."""
    from viamd_tpu.core import selection_utils as JS
    from viamd_tpu.script import evaluate_filter
    from viamd_tpu_torch.script import evaluate_filter as p_filter

    jsys, psys = systems["ala"]
    mask, _ = evaluate_filter(expr, jsys)
    pmask = Bitfield.from_bools(mask.to_bools())
    got = PS.selection_suggestions(psys, pmask)
    assert got == JS.selection_suggestions(jsys, mask)
    assert PS.atom_ranges_script(pmask) == JS.atom_ranges_script(mask)
    for sug in got:
        if sug.startswith(("atom", "residue")):
            assert p_filter(sug, psys, device="cpu")[0] == pmask, sug
    assert PS.atom_ranges_script(Bitfield.from_indices(50, [0, 1, 2, 7, 10, 11])) == \
        "atom(1:3, 8, 11:12)"
    assert PS.atom_ranges_script(Bitfield(5)) == "atom(0:0)"


def test_tracing_sections_nest():
    """TestTracing::test_sections_nest, and a report whose columns the JAX
    tracer has (section, calls) read the same."""
    from viamd_tpu.core.tracing import Tracer as JTracer

    reports = []
    for tr in (PT.Tracer(), JTracer()):
        tr.enabled = True
        with tr.section("outer"):
            with tr.section("inner"):
                pass
            with tr.section("inner"):
                pass
        stats = tr.stats()
        assert stats["outer"].calls == 1 and stats["outer/inner"].calls == 2
        assert stats["outer"].total_s >= stats["outer/inner"].max_s
        reports.append([ln.split()[:2] for ln in tr.report().splitlines()])
        tr.reset()
        assert tr.stats() == {}
    assert reports[0] == reports[1]
    tr = PT.Tracer()
    tr.enabled = False
    with tr.section("off"):
        pass
    assert tr.stats() == {}


def _segments(n_seg=12, per=40, seed=0):
    rng = np.random.RandomState(seed)
    seg = np.repeat(np.arange(n_seg), per)
    x = rng.uniform(-2.0, 20.0, (seg.size, 3)).astype(np.float32)
    w = rng.uniform(0.5, 16.0, seg.size).astype(np.float32)
    return x, w, seg


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_com_segments_matches_jax(cell):
    from viamd_tpu.ops import com as JC

    B, Iv = _cell(cell)
    x, w, seg = _segments()
    got = PC.com_segments(_t(x), _t(w), _t(seg), 12, _t(B), _t(Iv))
    want = JC.com_segments(x, w, seg, 12, B, Iv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # TestCom::test_segments
    box = torch.diag(torch.full((3,), 10.0))
    inv = inv_basis_of(box)
    xs = _t([[1.0, 1, 1], [2.0, 1, 1], [5.0, 5, 5], [6.0, 5, 5]]).float()
    out = PC.com_segments(xs, torch.ones(4), _t([0, 0, 1, 1]), 2, box, inv).numpy()
    np.testing.assert_allclose(out, [[1.5, 1, 1], [5.5, 5, 5]], atol=1e-4)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_com_segments_order_free(cell):
    """Permuting the atoms together with their segment ids gives the same
    bits (a float index_add_ sums in input order on the CPU and in thread
    order on the card, so its last bits follow the order)."""
    B, Iv = _cell(cell)
    x, w, seg = _segments(seed=1)
    base = PC.com_segments(_t(x), _t(w), _t(seg), 12, _t(B), _t(Iv))
    rng = np.random.RandomState(2)
    for _ in range(4):
        p = rng.permutation(seg.size)
        got = PC.com_segments(_t(x[p]), _t(w[p]), _t(seg[p]), 12, _t(B), _t(Iv))
        assert torch.equal(got, base)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_com_segments_order_free_on_card(cell):
    """On the card too: any permutation of the atoms gives the same bits,
    and so do repeated runs, and they equal the CPU's within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's atomics are what this checks")
    B, Iv = _cell(cell)
    x, w, seg = _segments(n_seg=2000, per=30, seed=3)

    def run(p, dev):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
        return PC.com_segments(t(x[p]), t(w[p]), t(seg[p]), 2000, t(B), t(Iv))

    ident = np.arange(seg.size)
    base = run(ident, "cuda")
    rng = np.random.RandomState(4)
    for p in [ident] * 2 + [rng.permutation(seg.size) for _ in range(3)]:
        assert torch.equal(run(p, "cuda"), base)
    np.testing.assert_allclose(base.cpu().numpy(), run(ident, "cpu").numpy(), atol=1e-5)
