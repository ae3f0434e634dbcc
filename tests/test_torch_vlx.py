"""The port's VeloxChem data (viamd_tpu_torch/io/vlx.py, io/basis.py,
core/vlog.py) and `interop.qmdata_from_numpy` against viamd_tpu's: the
basis library, `shells_from_label`, and `load_vlx_h5` on the checkpoint
layouts that TestVlxH5, TestVlxRealSchema, TestBasisLibrary and
TestRepresentationInfo write (tests/test_io_formats.py), written here with
raw h5py.

Tolerances: none. The modules are numpy copies, so the tables, the shells,
every QMData field, the primitive expansion and the overlap matrix must be
equal (dtype included).
"""

import dataclasses

import numpy as np
import pytest

from viamd_tpu_torch.core import vlog as tvlog
from viamd_tpu_torch.interop import qmdata_from_numpy
from viamd_tpu_torch.io import basis as TB
from viamd_tpu_torch.io import vlx as TV

_SECTIONS = ("excited", "vib", "opt", "scf_history", "rsp_samples")


def qm_fields(qm) -> dict:
    """A QMData of either package → the numpy field dict that
    interop.qmdata_from_numpy takes."""
    out = {}
    for f in dataclasses.fields(qm):
        v = getattr(qm, f.name)
        if f.name == "_prims":
            continue
        if f.name == "shells":
            v = [(s.center, s.angular, s.exponents, s.contraction) for s in v]
        elif f.name in _SECTIONS and v is not None:
            v = {k.name: getattr(v, k.name) for k in dataclasses.fields(v)}
        out[f.name] = v
    return out


def _equal(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (a is None) == (b is None) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def assert_same_qm(port, jax_qm):
    a, b = qm_fields(port), qm_fields(jax_qm)
    assert a.keys() == b.keys()
    for k in a:
        assert _equal(a[k], b[k]), k
    for x, y in zip(port._expand(), jax_qm._expand()):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert port.n_occupied == jax_qm.n_occupied and port.scf_type == jax_qm.scf_type
    np.testing.assert_array_equal(port.ao_to_atom_idx(), jax_qm.ao_to_atom_idx())


# -- checkpoint layouts (tests/test_io_formats.py) ----------------------------

WATER = np.array([[0.0, 0.0, 0.226], [0.0, 1.443, -0.904], [0.0, -1.443, -0.904]])


def write_h2_basis_groups(f):  # TestVlxH5::test_h5_roundtrip_and_orbital_eval
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.4]], np.float32)
    f["atom_coordinates"] = coords
    f["nuclear_charges"] = np.array([1, 1], np.int32)
    f["alpha_orbitals"] = np.array([[0.7, 0.7], [0.7, -0.7]], np.float32)
    f["alpha_energies"] = np.array([-0.6, 0.2], np.float32)
    g = f.create_group("basis")
    for i in range(2):
        sg = g.create_group(str(i))
        sg["center"] = coords[i]
        sg["angular"] = 0
        sg["exponents"] = np.array([1.3, 0.3], np.float32)
        sg["coefficients"] = np.array([0.5, 0.6], np.float32)


def write_full_sections(f):  # TestVlxH5::test_h5_vib_opt_scf_sections
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.4]], np.float32)
    f["atom_coordinates"] = coords
    f["nuclear_charges"] = np.array([1, 1], np.int32)
    f["alpha_orbitals"] = np.eye(2, dtype=np.float32)
    f["beta_orbitals"] = np.eye(2, dtype=np.float32) * 0.5
    f["beta_occupations"] = np.array([1.0, 0.0])
    g = f.create_group("basis")
    for i in range(2):
        sg = g.create_group(str(i))
        sg["center"] = coords[i]
        sg["angular"] = 0
        sg["exponents"] = np.array([1.3], np.float32)
        sg["coefficients"] = np.array([1.0], np.float32)
    v = f.create_group("vib")
    v["frequencies"] = np.array([4400.0])
    v["ir_intensities"] = np.array([0.5])
    v["normal_modes"] = np.array([[[0, 0, 1.0], [0, 0, -1.0]]])
    v["raman_activities"] = np.array([[12.0]])
    v["external_frequencies"] = np.array([0.0])
    o = f.create_group("opt")
    o["energies"] = np.array([-1.0, -1.1])
    o["coordinates"] = np.stack([coords, coords * 1.1])
    s = f.create_group("scf")
    sh = s.create_group("history")
    sh["energies"] = np.array([-1.0, -1.05, -1.1])
    sh["gradient_norms"] = np.array([0.5, 0.05, 1e-5])
    r = f.create_group("rsp")
    r["frequencies"] = np.linspace(0.1, 0.3, 4)
    r["sigma"] = np.arange(4.0)
    f["molecular_charge"] = 0.0
    f["spin_multiplicity"] = 1
    f["nuclear_repulsion"] = 0.714
    f["dft_func_label"] = np.bytes_("HF")


def write_real_schema(f, with_rsp=True):  # TestVlxRealSchema._write
    rng = np.random.RandomState(5)
    f["atom_coordinates"] = WATER
    f["nuclear_charges"] = np.array([8.0, 1.0, 1.0])
    f["basis_set"] = np.bytes_("STO-3G")
    scf = f.create_group("scf")
    scf["alpha_orbitals"] = rng.randn(7, 7)
    scf["alpha_energies"] = np.linspace(-20.0, 2.0, 7)
    scf["alpha_occupations"] = np.array([2.0] * 5 + [0.0] * 2)
    if with_rsp:
        rsp = f.create_group("rsp")
        rsp["eigenvalues"] = np.array([0.3, 0.35, 0.4])
        rsp["oscillator_strengths"] = np.array([0.01, 0.2, 0.0])
        rsp["rotatory_strengths"] = np.array([0.0, -1.2, 3.4])
        rsp["eigenvectors"] = rng.randn(3, 10)
        rsp["electric_transition_dipoles"] = rng.randn(3, 3)
        rsp["magnetic_transition_dipoles"] = rng.randn(3, 3)


def write_mo_writer_layout(f):  # test_parse_molecularorbitals_writer_layout
    rng = np.random.RandomState(11)
    f.create_dataset("alpha_orbitals", data=rng.randn(7, 7))
    f.create_dataset("alpha_energies", data=np.linspace(-20.0, 2.0, 7))
    f.create_dataset("alpha_occupations", data=np.array([2.0] * 5 + [0.0] * 2))
    f.create_dataset("beta_orbitals", data=rng.randn(7, 7))
    f.create_dataset("beta_energies", data=np.linspace(-19.0, 2.5, 7))
    f.create_dataset("nuclear_charges", data=np.array([8.0, 1.0, 1.0]))
    f.create_dataset("basis_set", data=np.bytes_("STO-3G"))
    f.create_dataset("atom_coordinates", data=WATER)


def write_c_alpha_spellings(f):  # TestVlxRealSchema: C_alpha / E_alpha spellings
    rng = np.random.RandomState(12)
    f.create_dataset("C_alpha", data=rng.randn(7, 7))
    f.create_dataset("E_alpha", data=np.linspace(-20.0, 2.0, 7))
    f.create_dataset("nuclear_charges", data=np.array([8.0, 1.0, 1.0]))
    f.create_dataset("basis_set", data=np.bytes_("STO-3G"))
    f.create_dataset("atom_coordinates", data=WATER)
    f.create_dataset("molecular_charge", data=0.0)


def write_fesp(f):  # TestBasisLibrary::test_checkpoint_with_s_p_fe
    f["atom_coordinates"] = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.8], [3.4, 0.0, -1.2]])
    f["nuclear_charges"] = np.array([26.0, 16.0, 15.0])
    f["basis_set"] = np.bytes_("STO-3G")
    scf = f.create_group("scf")
    scf["alpha_orbitals"] = np.random.RandomState(7).randn(37, 37)
    scf["alpha_energies"] = np.linspace(-260.0, 3.0, 37)
    scf["alpha_occupations"] = np.array([2.0] * 28 + [0.0] * 9)


def write_water_631g(f):  # TestBasisLibrary::test_checkpoint_631g_water
    f["atom_coordinates"] = WATER
    f["nuclear_charges"] = np.array([8.0, 1.0, 1.0])
    f["basis_set"] = np.bytes_("6-31G")
    scf = f.create_group("scf")
    scf["alpha_orbitals"] = np.random.RandomState(3).randn(13, 13)
    scf["alpha_energies"] = np.linspace(-20.0, 2.0, 13)
    scf["alpha_occupations"] = np.array([2.0] * 5 + [0.0] * 8)


def write_rep_info(f):  # TestRepresentationInfo._qm_h5
    rng = np.random.RandomState(11)
    f["atom_coordinates"] = WATER
    f["nuclear_charges"] = np.array([8.0, 1.0, 1.0])
    f["basis_set"] = np.bytes_("STO-3G")
    f["ground_state_dipole"] = np.array([0.0, 0.0, 0.7])
    ap = f.create_group("atom_properties")
    ap["resp_charges"] = np.array([-0.7, 0.35, 0.35])
    scf = f.create_group("scf")
    scf["alpha_orbitals"] = rng.randn(7, 7)
    scf["alpha_energies"] = np.linspace(-20.0, 2.0, 7)
    scf["alpha_occupations"] = np.array([2.0] * 5 + [0.0] * 2)
    rsp = f.create_group("rsp")
    rsp["eigenvalues"] = np.array([0.3, 0.35])
    rsp["oscillator_strengths"] = np.array([0.01, 0.2])
    rsp["eigenvectors"] = rng.randn(2, 10)


LAYOUTS = {
    "h2 basis groups": write_h2_basis_groups,
    "vib/opt/scf sections": write_full_sections,
    "real schema": write_real_schema,
    "real schema, no rsp": lambda f: write_real_schema(f, with_rsp=False),
    "MolecularOrbitals writer": write_mo_writer_layout,
    "C_alpha spellings": write_c_alpha_spellings,
    "Fe-S-P STO-3G": write_fesp,
    "6-31G water": write_water_631g,
    "representation info": write_rep_info,
}


def write_checkpoint(path, layout: str) -> str:
    import h5py

    with h5py.File(path, "w") as f:
        LAYOUTS[layout](f)
    return str(path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_load_vlx_h5_equal(tmp_path, layout):
    pytest.importorskip("h5py")
    from viamd_tpu.io import vlx as JV

    p = write_checkpoint(tmp_path / "qm.h5", layout)
    port, jax_qm = TV.load_vlx_h5(p), JV.load_vlx_h5(p)
    assert_same_qm(port, jax_qm)
    # the weights carried across: the JAX QMData's fields as numpy arrays
    assert_same_qm(qmdata_from_numpy(qm_fields(jax_qm)), jax_qm)
    np.testing.assert_array_equal(port.overlap_matrix(), jax_qm.overlap_matrix())


def test_unrecognized_layout_raises(tmp_path):
    h5py = pytest.importorskip("h5py")
    p = tmp_path / "bad.h5"
    with h5py.File(p, "w") as f:
        f["something"] = np.zeros(3)
    with pytest.raises(ValueError, match="unrecognized"):
        TV.load_vlx_h5(str(p))


def test_basis_tables_equal():
    from viamd_tpu.io import basis as JB
    from viamd_tpu.io import vlx as JV

    want, got = JB.builtin_library(), TB.builtin_library()
    assert _equal(got, want)
    assert TB.STO3G_PROVENANCE == JB.STO3G_PROVENANCE
    assert _equal(TB.sto3g_table(), JB.sto3g_table())
    assert set(TV.BASIS_LIBRARY) == set(JV.BASIS_LIBRARY) == {"STO-3G", "6-31G"}
    # the 6-31G table, byte for byte
    for z, shells in want["6-31G"].items():
        for (l1, e1, c1), (l2, e2, c2) in zip(shells, got["6-31G"][z]):
            assert l1 == l2
            assert np.asarray(e1).tobytes() == np.asarray(e2).tobytes()
            assert np.asarray(c1).tobytes() == np.asarray(c2).tobytes()


@pytest.mark.parametrize("label,numbers", [
    ("STO-3G", list(range(1, 37))),
    ("6-31G", [1, 6, 7, 8, 1, 8]),
])
def test_shells_from_label_equal(label, numbers):
    from viamd_tpu.io import vlx as JV

    rng = np.random.RandomState(len(numbers))
    coords = rng.randn(len(numbers), 3) * 3
    tvlog._dedup.clear()
    got = TV.shells_from_label(label, coords, np.asarray(numbers))
    want = JV.shells_from_label(label, coords, np.asarray(numbers))
    assert _equal([(s.center, s.angular, s.exponents, s.contraction) for s in got],
                  [(s.center, s.angular, s.exponents, s.contraction) for s in want])
    with pytest.raises(ValueError):
        TV.shells_from_label(label, np.zeros((1, 3)), np.array([54]))


def test_polyalanine_631g_size():
    """The size the chip run evaluates: polyala_helix(8) in 6-31G has 392
    cartesian basis functions over 944 primitives."""
    from viamd_tpu_torch.datagen import polyala_helix

    sys_, traj = polyala_helix(8, n_frames=1)
    x = traj.load_frames([0])[0][0] * TV.BOHR_PER_ANGSTROM
    shells = TV.shells_from_label("6-31G", x, sys_.element)
    qm = TV.QMData.from_arrays(x, sys_.element, shells, np.zeros((392, 1), np.float32))
    assert sys_.natoms == 56 and qm._expand()[0].shape == (944, 3)
    assert int(sys_.element.sum()) == 280


def test_approximate_sto3g_rows_warn():
    """tests/test_io_formats.py::TestBasisLibrary::test_approximate_sto3g_rows_warn
    through the port's own log."""
    got = []

    def sink(level, msg):
        got.append(msg)

    tvlog._dedup.clear()
    tvlog.register_sink(sink)
    try:
        TV.shells_from_label("STO-3G", np.zeros((2, 3)), np.array([26, 8]))
    finally:
        tvlog.unregister_sink(sink)
    assert any("Z=26" in m and "slater-rules" in m for m in got), got
    assert not any("Z=8" in m for m in got)


def test_qmdata_from_numpy_sections():
    """Every section survives the hand-over, copied (not shared)."""
    fields = dict(
        atom_coords=np.zeros((1, 3), np.float32), atom_numbers=np.array([8], np.int32),
        shells=[(np.zeros(3, np.float32), 0, np.array([0.5], np.float32),
                 np.array([1.0], np.float32))],
        mo_coeffs=np.eye(1, dtype=np.float32),
        mo_occupations=np.array([2.0], np.float32),
        excited=dict(energies_ev=np.array([5.0]), oscillator_strengths=np.array([0.5]),
                     transition_dms=np.ones((1, 1, 1), np.float32)),
        vib=dict(frequencies=np.array([100.0]), normal_modes=np.zeros((1, 1, 3))),
        opt=dict(energies=np.array([-1.0, -1.2]), opt_type="irc", irc_ts_index=1),
        scf_history=dict(energies=np.array([-1.0]), gradient_norms=np.array([0.1])),
        rsp_samples=dict(frequencies_au=np.array([0.1]), sigma=np.array([1.0])),
        atom_properties={"q": np.array([0.5])},
        rsp_type="cpp", basis_label="STO-3G", spin_multiplicity=1,
    )
    qm = qmdata_from_numpy(fields)
    assert isinstance(qm.excited, TV.ExcitedStates) and qm.excited.n_states == 1
    assert qm.vib.n_modes == 1 and qm.opt.n_steps == 2 and qm.opt.opt_type == "irc"
    assert qm.scf_history.energies[0] == -1.0 and qm.rsp_samples.sigma[0] == 1.0
    assert qm.atom_properties["q"][0] == 0.5 and qm.rsp_type == "cpp"
    assert qm.beta_coeffs is None and qm.overlap is None
    fields["mo_coeffs"][0, 0] = 7.0
    assert qm.mo_coeffs[0, 0] == 1.0
    with pytest.raises(KeyError):
        qmdata_from_numpy({"atom_coords": np.zeros((1, 3))})
