"""The port's VeloxChem component (viamd_tpu_torch/components/veloxchem.py)
against viamd_tpu's on the same QMData (built by the JAX package, carried
across with interop.qmdata_from_numpy): every method that TestVeloxchem,
TestVeloxchemSpectroscopy, TestVolumeExport, TestChargeTransfer
(tests/test_app.py) and TestRepresentationInfo (tests/test_io_formats.py)
cover, on their H2/H4/O fixtures.

Tolerances.
- Grids (orbital, density in every spin mode, NTO, transition,
  attachment/detachment): 2e-6 of the largest |value|, as
  tests/test_torch_gto.py (the JAX package's XLA-fused Φ build and sums
  against torch's CPU kernels). The OBB export grids: 1e-5. Their voxel
  centres go through the orientation, where the JAX cellmul contracts
  a·b + c and the port's matmul does not, so a centre moves by an ulp and
  ψ by |∇ψ| times that (measured up to 2.7e-6 of the largest value in the
  raw MetaImage payload), and the cube text keeps 6 significant digits
  (3.3e-6 read back).
  Exported headers and atoms: equal byte for byte.
- Grid charges (charge_transfer method="grid"): 1e-5 of the largest
  (the grids' rounding, then a float32 one-hot sum in JAX against the
  port's fixed-point sum). The transition matrix from them: 1e-5.
- Host numpy (NTOs, Mulliken charges and their matrix, spectra,
  vibrations, optimization, summary, representation catalog, Sankey SVG
  from the same charges, coordinate playback): exact.
- render_orbital: tests/test_torch_volume.py's bounds, unjittered;
  render_topology: tests/test_torch_overlay.py's (both through
  tests/test_torch_density_volume.py's helpers).
"""

import dataclasses
import types

import numpy as np
import pytest

from tests.test_torch_density_volume import (  # noqa: F401  (fixtures)
    hold_overlay,
    hold_volume,
    one_thread,
    unjittered,
)
from tests.test_torch_vlx import qm_fields
from viamd_tpu_torch.app.events import EventBus
from viamd_tpu_torch.components import VeloxchemComponent
from viamd_tpu_torch.components import veloxchem as TVC
from viamd_tpu_torch.interop import qmdata_from_numpy

GRID_RTOL = 2e-6
OBB_RTOL = 1e-5


def _rel(got, want):
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(np.abs(got).max())


def _pair(jqm, session=None, jsession=None):
    """(port component, JAX component) each holding its package's QMData."""
    from viamd_tpu.components.veloxchem import VeloxchemComponent as JVC

    t = VeloxchemComponent(session, device="cpu")
    j = JVC(jsession)
    t.load(qmdata_from_numpy(qm_fields(jqm)))
    j.load(jqm)
    return t, j


def _h2_like(d=1.4, alpha=0.5, excited=False):
    """TestVeloxchem._h2_like / _h2_excited."""
    from viamd_tpu.io.vlx import ExcitedStates, QMData, Shell

    shells = [Shell(np.array([x, 0, 0], np.float32), 0, np.array([alpha], np.float32),
                    np.array([1.0], np.float32)) for x in (0.0, d)]
    qm = QMData.from_arrays([[0, 0, 0], [d, 0, 0]], [1, 1], shells,
                            np.array([[0.7, 0.7], [0.7, -0.7]], np.float32),
                            mo_occupations=np.array([2.0, 0.0], np.float32))
    if excited:
        qm.excited = ExcitedStates(
            energies_ev=np.array([10.0]), oscillator_strengths=np.array([0.5]),
            rotatory_strengths=np.array([-2.0]),
            transition_dms=np.array([[[1.0]]], np.float32))
    return qm


def _h4(excited=True):
    """TestVolumeExport._diag_h4 with a p shell on each end and a 2×2
    excited state."""
    from viamd_tpu.io.vlx import ExcitedStates, QMData, Shell

    pts = np.stack([np.linspace(0, 9.0, 4)] * 2 + [np.zeros(4)], 1)
    shells = [Shell(p.astype(np.float32), 0, np.array([0.6], np.float32),
                    np.array([1.0], np.float32)) for p in pts]
    shells += [Shell(pts[i].astype(np.float32), 1, np.array([0.9, 0.3], np.float32),
                     np.array([0.6, 0.5], np.float32)) for i in (0, 3)]
    nb = 4 + 6
    C = np.linalg.qr(np.random.RandomState(0).randn(nb, nb))[0].astype(np.float32)
    kw = dict(mo_occupations=np.array([2, 2] + [0] * (nb - 2), np.float32),
              mo_energies=np.linspace(-1.0, 1.0, nb))
    if excited:
        T = np.random.RandomState(1).randn(2, 2, nb - 2).astype(np.float32)
        kw["excited"] = ExcitedStates(
            energies_ev=np.array([4.0, 5.5]), oscillator_strengths=np.array([0.3, 0.1]),
            rotatory_strengths=np.array([1.0, -2.0]), transition_dms=T,
            electric_tdms=np.ones((2, 3)), magnetic_tdms=-np.ones((2, 3)))
    return QMData.from_arrays(pts, [1, 1, 1, 1], shells, C, **kw)


def test_orbital_and_density_grids():
    t, j = _pair(_h2_like())
    for mo in (0, 1):
        g, o, v = t.orbital_grid(mo, dims=20)
        jg, jo, jv = j.orbital_grid(mo, dims=20)
        assert g.shape == (20, 20, 20) and _rel(g, jg) <= GRID_RTOL
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(v, jv)
    g1 = t.orbital_grid(1, dims=20)[0]
    assert float(g1.min()) < 0 < float(g1.max())  # the antibonding node
    rho = t.density_grid(dims=24, n_occupied=1)[0]
    assert _rel(rho, j.density_grid(dims=24, n_occupied=1)[0]) <= GRID_RTOL
    assert float(rho[12, 12, 12]) > float(rho[0, 0, 0])
    vd, jvd = t.orbital_scene_volume(1, dims=16, iso=0.2), j.orbital_scene_volume(1, dims=16,
                                                                                  iso=0.2)
    assert vd.keys() == jvd.keys()
    assert _rel(vd["grid"], jvd["grid"]) <= GRID_RTOL
    np.testing.assert_array_equal(vd["model"], jvd["model"])
    np.testing.assert_allclose(vd["iso_values"], jvd["iso_values"], rtol=GRID_RTOL)
    assert vd["iso_colors"] == jvd["iso_colors"]


@pytest.mark.parametrize("spin", ["total", "alpha", "beta", "difference"])
def test_spin_densities(spin):
    """TestVolumeExport::test_unrestricted_spin_densities: unrestricted and
    restricted, one dims-24 grid each."""
    from viamd_tpu.io.vlx import QMData, Shell

    shells = [Shell(np.zeros(3, np.float32), 0, np.array([0.8], np.float32),
                    np.array([1.0], np.float32))]
    for qm in (
        QMData.from_arrays([[0, 0, 0]], [1], shells, np.eye(1, dtype=np.float32),
                           mo_occupations=np.array([1.0], np.float32),
                           beta_coeffs=np.eye(1, dtype=np.float32),
                           beta_occupations=np.array([0.0])),
        QMData.from_arrays([[0, 0, 0]], [2], shells, np.eye(1, dtype=np.float32),
                           mo_occupations=np.array([2.0], np.float32)),
    ):
        t, j = _pair(qm)
        g = t.density_grid(dims=24, spin=spin)[0]
        want = j.density_grid(dims=24, spin=spin)[0]
        if not np.abs(want).max():
            assert not g.abs().max()
        else:
            assert _rel(g, want) <= GRID_RTOL


def test_excited_state_grids_and_ntos():
    t, j = _pair(_h4())
    for a, b in zip(t.ntos(1), j.ntos(1)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.nto_grid(1, pair=1, dims=16), j.nto_grid(1, pair=1, dims=16)):
        assert _rel(a, b) <= GRID_RTOL
    g, o, v = t.transition_density_grid(0, dims=16)
    assert _rel(g, j.transition_density_grid(0, dims=16)[0]) <= GRID_RTOL
    for a, b in zip(t.attachment_detachment_grids(0, dims=16),
                    j.attachment_detachment_grids(0, dims=16)):
        assert _rel(a, b) <= GRID_RTOL
    for a, b in zip(t.attachment_detachment_ao(1), j.attachment_detachment_ao(1)):
        np.testing.assert_array_equal(a, b)
    assert t.transition_analysis(1, top=5) == j.transition_analysis(1, top=5)
    # TestVeloxchem::test_transition_density_equals_product on the pure pair
    t2, _ = _pair(_h2_like(excited=True))
    td = t2.transition_density_grid(0, dims=20)[0]
    g0, g1 = t2.orbital_grid(0, dims=20)[0], t2.orbital_grid(1, dims=20)[0]
    assert float((td - g0 * g1).abs().max()) <= 1e-5


@pytest.mark.parametrize("method", ["mulliken", "grid"])
def test_charge_transfer(method, tmp_path):
    t, j = _pair(_h4())
    groups = [[0, 1], [2], [3]]
    got = t.charge_transfer(1, groups, dims=20, method=method)
    want = j.charge_transfer(1, groups, dims=20, method=method)
    assert got.keys() == want.keys()
    for k in got:
        if method == "mulliken":
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert _rel(got[k], want[k]) <= 1e-5, k
    # the H2 symmetric case (TestChargeTransfer::test_charge_transfer_h2)
    t2, _ = _pair(_h2_like(excited=True))
    ct = t2.charge_transfer(0, [[0], [1]], dims=32, method=method)
    assert abs(ct["hole_charges"][0] / ct["hole_charges"].sum() - 0.5) < 0.02
    assert abs(ct["matrix"][0, 0] - 0.5) < 0.02
    if method == "mulliken":
        p = tmp_path / "d.svg"
        svg = t.transition_diagram_svg(1, groups, labels=["a", "b", "c"], path=str(p))
        assert svg == j.transition_diagram_svg(1, groups, labels=["a", "b", "c"])
        assert p.read_text() == svg and svg.startswith("<svg")


def test_transition_matrix_and_sankey():
    from viamd_tpu.components import veloxchem as JVC

    for h, p in (([1.0, 0.0], [0.0, 1.0]), ([1.0, 0.0], [0.7, 0.3]),
                 ([0.6, 0.4, 0.0], [0.4, 0.3, 0.3]), ([0, 0], [0, 0])):
        m = TVC.compute_transition_matrix(h, p)
        np.testing.assert_array_equal(m, JVC.compute_transition_matrix(h, p))
        assert TVC.sankey_svg(m, h, p, size=(320, 200)) == JVC.sankey_svg(m, h, p,
                                                                            size=(320, 200))


def test_topology_and_render(unjittered, one_thread):
    """TestVeloxchem::test_topology_and_render: the same critical points and
    edges from grids within rounding, and the graph rendered."""
    t, j = _pair(_h2_like(d=2.6, alpha=1.0))
    pts, edges = t.topology(dims=32, min_value=1e-3, threshold_frac=0.1)
    jpts, jedges = j.topology(dims=32, min_value=1e-3, threshold_frac=0.1)
    assert [(p.kind, p.index) for p in pts] == [(p.kind, p.index) for p in jpts]
    assert edges == jedges and sum(p.kind == "max" for p in pts) == 2
    got = t.render_topology(dims=32, width=96, height=96, points=pts, edges=edges,
                            sphere_radius=0.6)
    want = j.render_topology(dims=32, width=96, height=96, points=jpts, edges=jedges,
                             sphere_radius=0.6)
    hold_overlay(got, want)
    covered = got[0][..., 3] > 0
    assert int(covered.sum()) > 20
    assert set(got[2][got[2] >= 0].tolist()) & {i for i, p in enumerate(pts) if p.kind == "max"}


def test_render_orbital(unjittered, one_thread):
    t, j = _pair(_h2_like())
    got = t.render_orbital(1, dims=24, width=48, height=48)
    want = j.render_orbital(1, dims=24, width=48, height=48)
    hold_volume(got, want, unjittered[-1])
    assert float(got[0][..., 3].max()) > 0


def _export_files(comp, d, source, fmt, **kw):
    d.mkdir()
    return comp.export_volume(str(d / f"x.{fmt}"), source=source, fmt=fmt,
                              resolution="low", **kw)


@pytest.mark.parametrize("source", ["mo", "nto", "transition_density", "attachment",
                                    "detachment", "electron_density"])
def test_export_volume(tmp_path, source):
    from viamd_tpu.app.export import read_cube

    t, j = _pair(_h4())
    kw = dict(state=1) if source != "mo" else dict(use_magnitude=True)
    for fmt in ("cube", "mhd"):
        got = _export_files(t, tmp_path / f"p{fmt}", source, fmt, **kw)
        want = _export_files(j, tmp_path / f"j{fmt}", source, fmt, **kw)
        assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want]
        if fmt == "cube":
            a, b = open(got[0]).read().splitlines(), open(want[0]).read().splitlines()
            assert a[:10] == b[:10]  # header, 3 axes, 4 atoms
            ga, gb = read_cube(got[0])[0], read_cube(want[0])[0]
        else:
            for x, y in zip(got[::2], want[::2]):  # .mhd header, .xyz atoms
                assert open(x, "rb").read() == open(y, "rb").read()
            ga, gb = np.fromfile(got[1], np.float32), np.fromfile(want[1], np.float32)
        assert ga.size > 500 and _rel(ga, gb) <= OBB_RTOL
        if source == "mo":
            assert (ga >= 0).all()


def test_obb_geometry_and_oriented_grid():
    t, j = _pair(_h4(excited=False))
    for args in ((4.0,), (4.0, False), (8.0, True, 3.0)):
        for a, b in zip(t.obb_geometry(*args), j.obb_geometry(*args)):
            np.testing.assert_array_equal(a, b)
    R, lo, voxel, dims = t.obb_geometry(4.0)
    assert abs(abs(R[:, 0] @ [2**-0.5, 2**-0.5, 0]) - 1.0) < 1e-6
    assert all(d % 8 == 0 and 8 <= d <= 512 for d in dims)


def test_spectroscopy_equal():
    """TestVeloxchemSpectroscopy's surfaces and the broadened spectra of
    TestVeloxchem, host numpy in both packages: equal."""
    from viamd_tpu.components import veloxchem as JVC
    from viamd_tpu.io.vlx import (
        ExcitedStates, OptimizationData, QMData, ResponseSamples, ScfHistory, Shell,
        VibrationalData,
    )

    for u in ("ev", "nm", "cm-1", "au"):
        assert TVC.convert_value_from_au(0.25, u) == JVC.convert_value_from_au(0.25, u)
        assert TVC.convert_value_to_au(0.25, u) == JVC.convert_value_to_au(0.25, u)
    shells = [Shell(np.zeros(3, np.float32), 0, np.array([0.5], np.float32),
                    np.array([1.0], np.float32))]
    modes = np.zeros((2, 1, 3))
    modes[0, 0], modes[1, 0] = [1.0, 0, 0], [0, 1.0, 0]
    qm = QMData.from_arrays(
        [[0, 0, 0]], [8], shells, np.array([[1.0]], np.float32),
        mo_occupations=np.array([2.0], np.float32),
        excited=ExcitedStates(energies_ev=np.array([5.0, 6.5]),
                              oscillator_strengths=np.array([0.5, 0.1]),
                              rotatory_strengths=np.array([-3.0, 1.0])),
        vib=VibrationalData(frequencies=np.array([1000.0, 1600.0]),
                            ir_intensities=np.array([5.0, 2.0]), normal_modes=modes,
                            raman_activities=np.array([[7.0, 1.0], [3.0, 4.0]]),
                            external_frequencies=np.array([0.0, 0.0856])),
        opt=OptimizationData(energies=np.array([-74.0, -74.5, -74.4]),
                             coordinates=np.zeros((3, 1, 3)) + np.arange(3)[:, None, None]),
        scf_history=ScfHistory(energies=np.array([-74.0, -74.9, -74.96]),
                               gradient_norms=np.array([1.0, 0.1, 1e-4])),
        tpa_trans_linear=np.array([2.0, 1.0]), tpa_trans_circular=np.array([1.0, 3.0]),
        rsp_type="tpa_transition", basis_label="STO-3G", dft_label="B3LYP",
        molecular_charge=1.0, spin_multiplicity=2, nuclear_repulsion=9.19,
    )
    t, j = _pair(qm)
    x = np.array([4.0, 5.0, 6.0])
    calls = [
        ("absorption_spectrum", (), dict(broadening_ev=0.4)),
        ("absorption_spectrum", (), dict(shape="gaussian")),
        ("ecd_spectrum", (), {}),
        ("absorption_spectrum_eps", (), dict(x=x, fwhm_ev=0.2)),
        ("absorption_spectrum_eps", (), dict(x_unit="nm", shape="gaussian")),
        ("ecd_spectrum_eps", (), dict(x=x)),
        ("ecd_spectrum_eps", (), dict(shape="gaussian", x_unit="cm-1")),
        ("tpa_spectrum", (), dict(x=x)),
        ("tpa_spectrum", (), dict(circular=True)),
        ("ir_spectrum", (), dict(x=np.array([1000.0]), fwhm_cm=20.0)),
        ("ir_spectrum", (), dict(shape="gaussian", freq_scaling=0.5)),
        ("raman_spectrum", (1,), dict(x=np.array([1000.0, 1600.0]))),
        ("normal_mode_displacement", (0, np.pi / 2), dict(amplitude=2.0)),
        ("scf_convergence", (), {}),
        ("optimization_profile", (), {}),
        ("optimization_coordinates", (99,), {}),
        ("summary", (), {}),
    ]
    for name, args, kw in calls:
        a, b = getattr(t, name)(*args, **kw), getattr(j, name)(*args, **kw)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), name
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])) or a[k] == b[k], name
        else:
            for x1, x2 in zip(a if isinstance(a, tuple) else (a,),
                              b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(x1, x2, err_msg=name)
    s = t.summary()
    assert s["num_alpha_electrons"] == 4 and s["num_beta_electrons"] == 3
    # CPP runs return the sampled spectra (TestVeloxchemSpectroscopy::test_cpp_sampled_spectra)
    freqs = np.linspace(0.05, 0.5, 16)
    qm.rsp_samples = ResponseSamples(frequencies_au=freqs, sigma=np.arange(16.0),
                                     delta_epsilons=-np.arange(16.0),
                                     optical_rotations=np.arange(16.0) * 2,
                                     tpa_cross_sections=np.ones(16))
    t, j = _pair(qm)
    for name in ("absorption_spectrum_eps", "ecd_spectrum_eps", "ord_spectrum",
                 "tpa_spectrum"):
        for x1, x2 in zip(getattr(t, name)(x_unit="au"), getattr(j, name)(x_unit="au")):
            np.testing.assert_array_equal(x1, x2)


def test_coordinate_override_playback():
    """TestVeloxchemSpectroscopy::test_coordinate_override_playback over a
    SimpleNamespace session of each package."""
    from tests._torch_parity import port_system
    from tests.conftest import make_ala_pdb
    from viamd_tpu.app.events import EventBus as JBus
    from viamd_tpu.io.pdb import parse_pdb
    from viamd_tpu.io.vlx import BOHR_PER_ANGSTROM, OptimizationData, QMData, Shell
    from viamd_tpu.io.vlx import VibrationalData

    sys_j, _ = parse_pdb(make_ala_pdb(6))
    na = sys_j.natoms
    base = sys_j.coords() * BOHR_PER_ANGSTROM
    modes = np.zeros((1, na, 3))
    modes[0, :, 2] = 1.0
    qm = QMData.from_arrays(
        base, np.full(na, 1, np.int32),
        [Shell(np.zeros(3, np.float32), 0, np.array([0.5], np.float32),
               np.array([1.0], np.float32))],
        np.eye(1, dtype=np.float32),
        opt=OptimizationData(energies=np.array([-1.0, -1.2]),
                             coordinates=np.stack([base, base + [1.0, 0, 0]])),
        vib=VibrationalData(frequencies=np.array([100.0]), normal_modes=modes))
    seen = []
    tb, jb = EventBus(), JBus()
    tb.subscribe("system_state_changed", lambda ev: seen.append(ev.type))
    ts = types.SimpleNamespace(system=port_system(sys_j), events=tb, coord_override=None)
    js = types.SimpleNamespace(system=sys_j, events=jb, coord_override=None)
    t, j = _pair(qm, ts, js)
    for fn, args in (("apply_optimization_step", (1,)),
                     ("apply_normal_mode", (0, np.pi / 2, 2.0))):
        getattr(t, fn)(*args)
        getattr(j, fn)(*args)
        np.testing.assert_array_equal(ts.coord_override, js.coord_override)
    t.clear_coordinate_override()
    assert ts.coord_override is None and len(seen) == 3
    t.load(qmdata_from_numpy(dict(qm_fields(qm), atom_coords=base[:1],
                                  atom_numbers=np.ones(1, np.int32),
                                  vib=dict(frequencies=np.array([100.0]),
                                           normal_modes=np.zeros((1, 1, 3))))))
    with pytest.raises(ValueError, match="does not match"):
        t.apply_normal_mode(0, 0.0)


def test_representation_info(tmp_path):
    """TestRepresentationInfo on its checkpoint, and the H4 catalog."""
    pytest.importorskip("h5py")
    from tests.test_torch_vlx import write_checkpoint
    from viamd_tpu.io.vlx import load_vlx_h5

    p = write_checkpoint(tmp_path / "info.h5", "representation info")
    for jqm in (load_vlx_h5(p), _h4()):
        t, j = _pair(jqm)
        a, b = t.representation_info(), j.representation_info()
        assert t.representation_info() is a  # cached per QMData
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert repr(da) == repr(db)
    assert a.alpha.homo_idx == 1 and len(a.dipole_moments) == 4
