"""The port's .via workspace (viamd_tpu_torch/app/workspace.py) against
viamd_tpu's: the same session state saved by both packages gives the same
bytes, each package loads the other's file into the same state, and the
reference dialect's fixture loads in the port. The oracles are
tests/test_app.py TestWorkspace and TestReferenceViaFormat.

Tolerance: none. The format is text written by the same code, so the
files are byte-equal and every value read back is equal (the camera goes
through a quaternion and %f text on both sides alike).
"""

import numpy as np
import pytest

from tests.conftest import make_ala_pdb
from viamd_tpu_torch.app import Session
from viamd_tpu_torch.app import workspace as PW
from viamd_tpu_torch.core.bitfield import Bitfield


@pytest.fixture
def sessions(tmp_path):
    """A port session (CPU) and a JAX session over the same ALA file."""
    from viamd_tpu.app import Session as JSession

    pdb = tmp_path / "ala.pdb"
    pdb.write_text(make_ala_pdb(6, n_models=10))
    p, j = Session(num_workers=2, device="cpu"), JSession(num_workers=2)
    for s in (p, j):
        s.load(str(pdb))
    yield p, j
    p.shutdown()
    j.shutdown()


def _dress(s, camera_cls):
    """The state the JAX tests save: script, stored selections, reps,
    playback, render settings, user bonds, camera."""
    s.set_script("d1 = distance(1, 6);\nr = rdf(element('C'), element('O'), 8.0);")
    s.store_selection("first5", s.select("atom(1:5)"))
    s.store_selection("sel A", s.select("element('N')"))
    s.add_representation(name="lico", filter="element('C')", type="licorice")
    s.add_representation(name="glow", filter="all", type="spacefill", color_mapping="uniform",
                         uniform_color=(0.0, 0.0, 1.0, 1.0), radius_scale=1.6, alpha=0.35)
    s.add_representation(name="ss", filter="all", type="cartoon",
                         color_mapping="secondary_structure", saturation=0.5)
    s.frame = 3.25
    s.fps = 24.0
    s.interpolation = "cubic"
    s.visuals = {"ssao_enabled": False, "dof_focus_scale": 3.5}
    s.add_user_bonds([(0, 12), (3, 20)])
    s.camera = camera_cls(
        eye=np.array([5.0, 6.0, 30.0], np.float32),
        center=np.array([5.0, 6.0, 2.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32),
        fovy=0.9,
    )


def _state(s):
    reps = [(r.name, r.filter, r.type, r.color_mapping, r.enabled, r.alpha, r.radius_scale,
             tuple(float(v) for v in r.uniform_color)) for r in s.representations]
    return dict(
        natoms=s.system.natoms, frames=s.num_frames, frame=s.frame, fps=s.fps,
        interpolation=s.interpolation, visuals=dict(s.visuals), script=s.script_text,
        selections={k: v.indices().tolist() for k, v in s.stored_selections.items()},
        reps=reps, bonds=sorted(map(tuple, s.system.bonds.tolist())),
        user_bonds=[tuple(b) for b in s.user_bonds], compiled=s.compiled is not None,
        camera=tuple(np.round(np.concatenate([s.camera.eye, s.camera.center, s.camera.up]), 4)),
        fovy=round(float(s.camera.fovy), 6),
    )


def test_bytes_equal_and_cross_load(sessions, tmp_path):
    """TestWorkspace::test_roundtrip and TestReferenceViaFormat::
    test_roundtrip_reference_dialect across the packages."""
    from viamd_tpu.app import Session as JSession
    from viamd_tpu.render.camera import Camera as JCamera
    from viamd_tpu_torch.render.camera import Camera as PCamera

    p, j = sessions
    _dress(p, PCamera)
    _dress(j, JCamera)
    pv, jv = tmp_path / "p.via", tmp_path / "j.via"
    p.save_workspace(str(pv))
    j.save_workspace(str(jv))
    assert pv.read_bytes() == jv.read_bytes()
    text = pv.read_text()
    for frag in ("Label=sel A", 'Text="""', "Interpolation=2", "atoms=0,12", "Orientation=",
                 "Frame=3.250000"):
        assert frag in text
    want = _state(p)
    assert want == _state(j)
    p2, j2 = Session(num_workers=1, device="cpu"), JSession(num_workers=1)
    try:
        p2.load_workspace(str(jv))  # the JAX package's file in the port
        j2.load_workspace(str(pv))  # and the port's in the JAX package
        got_p, got_j = _state(p2), _state(j2)
        assert got_p == got_j
        for k in ("natoms", "frames", "frame", "fps", "interpolation", "script", "selections",
                  "compiled", "fovy"):
            assert got_p[k] == want[k], k
        assert want["visuals"].items() <= got_p["visuals"].items()  # + the written defaults
        assert [r[:5] for r in got_p["reps"]] == [r[:5] for r in want["reps"]]
        assert set(want["user_bonds"]) <= set(got_p["bonds"])
        np.testing.assert_allclose(got_p["camera"], want["camera"], atol=1e-3)
        # and the round trip writes the same file again
        p2.save_workspace(str(tmp_path / "p2.via"))
        j2.save_workspace(str(tmp_path / "j2.via"))
        assert (tmp_path / "p2.via").read_bytes() == (tmp_path / "j2.via").read_bytes()
    finally:
        p2.shutdown()
        j2.shutdown()


def test_reference_fixture_loads(tmp_path):
    """TestReferenceViaFormat::test_reference_fixture_loads in the port: the
    reference writer's dialect (banner, %f floats, fenced Script, Label +
    Mask, repeated UserBonds atoms=)."""
    from tests.test_app import TestReferenceViaFormat

    pdb = tmp_path / "m.pdb"
    pdb.write_text(make_ala_pdb(6, n_models=4))
    mask = PW.serialize_mask(Bitfield.from_indices(30, [0, 2, 4]))
    via = tmp_path / "ref.via"
    via.write_text(TestReferenceViaFormat()._fixture_text("m.pdb", mask))
    s = Session(num_workers=1, device="cpu")
    try:
        s.load_workspace(str(via))
        assert s.system.natoms == 30 and s.num_frames == 4
        assert (s.frame, s.fps, s.interpolation) == (2.0, 30.0, "cubic")
        assert s.visuals["ssao_intensity"] == 2.5 and s.visuals["dof_enabled"] is True
        np.testing.assert_allclose(s.camera.eye, [10, 20, 42], atol=1e-4)
        np.testing.assert_allclose(s.camera.center, [10, 20, 20], atol=1e-4)
        rep = s.representations[0]
        assert (rep.type, rep.color_mapping) == ("licorice", "secondary_structure")
        assert abs(rep.alpha - 0.75) < 1e-6 and abs(rep.radius_scale - 1.5) < 1e-6
        assert s.script_text == "d1 = distance(1, 6);\na1 = angle(2, 1, 3);"
        assert s.compiled is not None
        assert s.stored_selections["picked"].indices().tolist() == [0, 2, 4]
        assert [0, 7] in s.system.bonds.tolist() and [1, 9] in s.system.bonds.tolist()
    finally:
        s.shutdown()


def test_masks_and_parser_match_jax():
    """TestReferenceViaFormat::test_write_bitfield_wrapper_accepted, and
    the mask wire format and the parser against the JAX package's."""
    import base64

    from viamd_tpu.app import workspace as JW
    from viamd_tpu.core.bitfield import Bitfield as JBitfield

    for n, idx in ((100, [1, 50, 99]), (7, []), (33, list(range(33)))):
        bf, jbf = Bitfield.from_indices(n, idx), JBitfield.from_indices(n, idx)
        raw = PW.serialize_mask(bf)
        assert raw == JW.serialize_mask(jbf)
        for arg in (raw, "###" + raw + "###", jbf.to_base64()):
            got = PW.deserialize_mask(arg)
            assert got is not None and got.indices().tolist() == idx
    assert PW.deserialize_mask("###not-base64!###") is None
    assert PW.deserialize_mask(base64.b64encode(b"????????").decode()) is None
    text = ('# banner\n[Files]\nMoleculeFile=a.pdb\n[Script]\nText="""x = 1;\ny = 2;"""\n'
            "[UserBonds]\natoms=0,1\natoms=2,3\n[Broken]\nno equals\n")
    got = [(name, list(e.pairs)) for name, e in PW.parse_workspace(text)]
    assert got == [(name, list(e.pairs)) for name, e in JW.parse_workspace(text)]
    for q in ([0.0, 0.0, 0.0, 1.0], [0.1, 0.7, -0.2, 0.6]):
        pos = [1.0, 2.0, 3.0]
        np.testing.assert_array_equal(np.concatenate(PW._lookat_from_quat(pos, q, 7.0)),
                                      np.concatenate(JW._lookat_from_quat(pos, q, 7.0)))
