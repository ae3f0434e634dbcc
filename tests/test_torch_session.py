"""The port's Session (viamd_tpu_torch/app/session.py) against viamd_tpu's,
both opening the same seeded files on the CPU: the ALA fixture
(tests/conftest.py::make_ala_pdb, 6 residues × 10 models), the demo
(`load_demo`) and a periodic water box written as a .gro. The oracles are
tests/test_app.py TestSession, TestSelectionUtils, TestVelocities,
TestPlaybackModes, TestMovieRendering and TestBackboneReps.

The JAX package is imported inside the tests that use it, so the tests
marked `requires_cuda` collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_session.py

Tolerances.
- Selections, stored selections, script suggestions, picks-to-selections:
  exact. Coordinates (nearest, linear, cubic) and velocities: 1e-5
  absolute; recentred coordinates: 1e-4 (a circular mean through atan2).
- Evaluated properties: temporal values 1e-4 absolute; the demo script's
  rdf by tests/test_torch_slice.py's bound (a bin within 2 counts + 1e-3
  relative); its sdf by its sum (1e-5 relative) and every voxel within
  1e-3 of the largest: each residue's reference frame is a float32
  closed-form Kabsch that agrees with the JAX one to 1e-5
  (tests/test_torch_sdf.py), and a 1e-5 rotation moves a point 10 Å out
  by 1e-4 Å, ~3e-4 of a 0.31 Å voxel's trilinear weights (measured:
  2.3e-4 of the largest voxel).
- Raw sphere renders (spacefill, licorice): tests/test_torch_render.py's
  bounds against the XLA engine on the pixels that are decided, with the
  undecided ones counted (under 1% of the frame) and rgb held to that
  file's water-scene limits (`XLA_RGB`).
- Cartoon (the triangle raster): tests/test_torch_triangles.py's bounds
  (picks equal, depth 1e-5 relative, rgba 1e-5 at every decided pixel,
  under 1% undecided), on a scene where no tile holds 64 candidates (the
  JAX raster's cap).
- Overlays (the box, the script's geometry and text) against the JAX
  session: tests/test_torch_overlay.py's bounds on the pixels that are
  decided, with the undecided ones counted (under 1% of the frame). A
  pixel is undecided where a sphere of the molecules or of the overlay is
  within rounding of another's depth or of its silhouette
  (tests/test_torch_render.py::_unambiguous over both sets together) or an
  overlay triangle's edge or depth tie passes through it
  (tests/test_torch_triangles.py::_undecided). Every decided pixel has the
  same pick and coverage, the same alpha, depth within 5e-4 relative and
  rgb within 1e-2, at most 1% of them above 6e-3 (the port packs colours
  to 8 bits, the JAX XLA engine does not). The scenes are ones the JAX
  raster draws whole: from farther away or at a larger frame its XLA
  engine drops some spheres of a close molecule or of the box's 0.1 Å
  lines at any tile capacity, which this bound does not let pass. As an
  extra, the session's frame equals its raw frame depth-composited with
  the port's overlay queue render, exactly.
- Composites that mix rasters (outline, transparent pass,
  accumulation, motion blur, TAA): tests/test_torch_overlay.py's bounds —
  at most 1% of pixels differ in pick or coverage at silhouettes, the rest
  have the same alpha and rgb within 1e-2, at most 1% of them above 6e-3.
  A TAA frame reprojects its neighbours, so a silhouette pixel's rounding
  reaches 5×5 pixels around it: the same bounds at 3% of the pixels.
- Postprocessed frames: tests/test_torch_postprocess.py's end-to-end
  bounds (1e-3 at 97% of pixels and 1e-3 in the mean).
- The in-scene volume (unjittered in both packages, under 256² so the JAX
  package ray-marches too), each package's volume pass given the same
  opaque frame: tests/test_torch_volume.py's bounds at every pixel the
  march decides, under 2% undecided. The JAX march runs op by op
  (`jax.disable_jit()`): jitted by XLA on the CPU, the march of the SDF
  through its rotated reference frame differs from its own op-by-op
  evaluation by up to 3.8e-2 at 530 of 6,912 pixels (without a scene
  depth; the port agrees with the op-by-op march to 6e-8), while an
  axis-aligned model agrees to 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

from viamd_tpu_torch.app import Session

W, H = 96, 72
PICK_SHARE = 0.01


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ala_file(tmp_path, n_res=6, n_models=10):
    from tests.conftest import make_ala_pdb

    p = tmp_path / "ala.pdb"
    p.write_text(make_ala_pdb(n_res, n_models=n_models))
    return str(p)


def _water_files(tmp_path, n_waters=24, n_frames=4):
    """A periodic water box as a .gro (the port's writer) and its frames:
    (gro path, (F, n, 3) frames, (3, 3) basis)."""
    from chip_smoke import write_gro
    from viamd_tpu_torch.datagen import water_box

    sys_, traj = water_box(n_waters, n_frames=n_frames, seed=4)
    frames, _ = traj.load_frames(range(n_frames))
    gro = str(tmp_path / "water.gro")
    write_gro(gro, sys_, frames[0])
    return gro, np.asarray(frames, np.float32), np.asarray(sys_.cell.basis, np.float32)


class Pair:
    """A port session on the CPU and a JAX session, driven alike. The JAX
    session's sphere raster (the XLA engine on the CPU) gets a tile
    capacity of 256, so that it drops no candidate: these scenes need up to
    128 (tests/test_torch_render.py::_xla_capacity, which hold_raster
    checks), its default is 64; the port has no capacity."""

    def __init__(self, monkeypatch):
        from viamd_tpu.app import Session as JSession
        from viamd_tpu.render import raster as JR

        monkeypatch.setattr(JR, "RasterSettings", functools.partial(JR.RasterSettings,
                                                                    capacity=256))

        self.p = Session(num_workers=2, device="cpu")
        self.j = JSession(num_workers=2)

    def __iter__(self):
        return iter((self.p, self.j))

    def each(self, fn):
        return fn(self.p), fn(self.j)

    def shutdown(self):
        self.p.shutdown()
        self.j.shutdown()


def _zoom(pair, scale):
    """Both sessions' cameras moved `scale` of the way to the centre (the
    same numbers in both), so the molecule fills the frame."""
    import dataclasses

    for s in pair:
        c = s.camera
        eye = np.asarray(c.center + (np.asarray(c.eye, np.float64) - c.center) * scale,
                         np.float32)
        s.camera = dataclasses.replace(c, eye=eye)


@pytest.fixture
def ala(tmp_path, monkeypatch):
    s = Pair(monkeypatch)
    path = _ala_file(tmp_path)
    s.each(lambda x: x.load(path))
    _zoom(s, 0.6)
    yield s
    s.shutdown()


@pytest.fixture
def water(tmp_path, monkeypatch):
    """The water box in both packages: the .gro opened by each, its frames
    attached as an in-memory trajectory of each package."""
    from viamd_tpu.io.trajectory import InMemoryTrajectory as JTraj
    from viamd_tpu_torch.io.trajectory import InMemoryTrajectory as PTraj

    gro, frames, basis = _water_files(tmp_path)
    s = Pair(monkeypatch)
    s.each(lambda x: x.load(gro))
    cells = np.broadcast_to(basis, (frames.shape[0], 3, 3)).copy()
    s.p.set_trajectory(PTraj(frames, cells))
    s.j.set_trajectory(JTraj(frames, cells))
    yield s
    s.shutdown()


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _outs(out):
    return tuple(_np(a) for a in out)


# -- load, selections, script ----------------------------------------------------------


def test_load_select_grow_store(ala):
    """TestSession::test_load_and_select, TestSelectionUtils: the same
    system, selections, grown selections and script suggestions."""
    p, j = ala
    assert p.system.natoms == j.system.natoms == 30
    assert p.num_frames == j.num_frames == 10
    assert p.files == j.files
    for expr in ("element('C')", "name('CA')", "residue(2:3)", "atom(1:5) or atom(9)"):
        pm, jm = ala.each(lambda s: s.select(expr))
        assert np.array_equal(pm.to_bools(), jm.to_bools())
        assert p.selection_to_script() == j.selection_to_script()
    ala.each(lambda s: s.select("name('CA')"))
    for kw in (dict(by="bonds", steps=1), dict(by="bonds", steps=3),
               dict(by="radius", radius=3.0), dict(by="instance")):
        pm, jm = ala.each(lambda s: s.grow_selection(**kw))
        assert np.array_equal(pm.to_bools(), jm.to_bools()), kw
    ala.each(lambda s: s.store_selection("carbons", s.select("element('C')")))
    assert np.array_equal(p.stored_selections["carbons"].to_bools(),
                          j.stored_selections["carbons"].to_bools())
    with pytest.raises(ValueError):
        p.grow_selection(by="nothing")


def test_fingerprint_recompile_and_evaluate(ala, tmp_path):
    """TestSession::test_script_eval, test_recompile_on_selection_change,
    test_recompile_on_system_change, test_script_error_reported."""
    p, j = ala
    for s in ala:
        s.store_selection("grp", s.select("element('C')"))
        s.set_script("d1 = distance(1, 6);\nn = count(grp);\na = angle(1, 2, 3);")
    rp, rj = ala.each(lambda s: s.evaluate(chunk=4))
    assert rp.n_frames_done == rj.n_frames_done == 10
    for k in ("d1", "n", "a"):
        np.testing.assert_allclose(rp.temporal[k], np.asarray(rj.temporal[k]).reshape(10, -1),
                                   atol=1e-4)
    fp = p._compiled_fp
    ala.each(lambda s: s.store_selection("grp", s.select("element('N')")))
    rp2, rj2 = ala.each(lambda s: s.evaluate(chunk=4))
    assert p._compiled_fp != fp
    assert float(rp2.temporal["n"][0, 0]) == float(np.asarray(rj2.temporal["n"]).ravel()[0]) == 6.0
    small = str(tmp_path / "small.pdb")
    from tests.conftest import make_ala_pdb

    open(small, "w").write(make_ala_pdb(2, n_models=3))
    for s in ala:
        s.set_script("n = count(element('C'));")
        s.load(small)
    rp3, rj3 = ala.each(lambda s: s.evaluate(chunk=2))
    assert float(rp3.temporal["n"][0, 0]) == float(np.asarray(rj3.temporal["n"]).ravel()[0]) == 6.0
    assert rp3.fingerprint != rp2.fingerprint
    ala.each(lambda s: s.set_script("d1 = distance(1, 99999);"))
    assert not p.compile_script() and not j.compile_script()
    assert p.script_errors and j.script_errors


def test_stage_async_and_tick(ala):
    """TestSession::test_stage_to_device, test_async_eval, test_tick."""
    from viamd_tpu_torch.app.events import EventType
    from viamd_tpu_torch.io.trajectory import DeviceTrajectory

    p, j = ala
    p.set_script("d1 = distance(1, 6);")
    r0 = p.evaluate(chunk=4)
    assert p.stage_to_device(max_bytes=1) is False
    assert p.stage_to_device() is True and isinstance(p.trajectory, DeviceTrajectory)
    assert p.stage_to_device() is True
    r1 = p.evaluate(chunk=4)
    assert np.array_equal(r1.temporal["d1"], r0.temporal["d1"])
    h = p.evaluate_async(chunk=4)
    assert np.array_equal(h.wait().temporal["d1"], r0.temporal["d1"])
    p.set_frame(2.5)
    j.set_frame(2.5)
    np.testing.assert_allclose(p.current_coords(), j.current_coords(), atol=1e-5)
    got = []
    p.events.subscribe(EventType.FRAME_TICK, lambda ev: got.append(1))
    p.tick()
    assert got == [1]


def test_demo_default_script(monkeypatch):
    """TestSession::test_load_demo_default_script: the reference's default
    script over the demo, the properties against the JAX package's."""
    s = Pair(monkeypatch)
    try:
        s.each(lambda x: x.load_demo(n_res=12, n_frames=6))
        assert not s.p.script_errors and s.p.script_text == s.j.script_text
        rp, rj = s.each(lambda x: x.evaluate(chunk=3))
        assert rp.n_frames_done == 6
        assert set(rp.temporal) == {"d1", "a1", "lin", "plan", "iso"}
        for k in rp.temporal:
            np.testing.assert_allclose(rp.temporal[k],
                                       np.asarray(rj.temporal[k]).reshape(6, -1), atol=1e-4)
        hp, hj = rp.distributions["r"].astype(np.float64), np.asarray(rj.distributions["r"])
        assert (np.abs(hp - hj) <= 2 + 1e-3 * hj).all()
        vp, vj = rp.volumes["v"], np.asarray(rj.volumes["v"], np.float64)
        assert abs(vp.sum() - vj.sum()) <= 1e-5 * vj.sum()
        np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-3 * np.abs(vj).max())
    finally:
        s.shutdown()


def test_attach_is_load_demos_sequence():
    """`Session.attach` leaves a session as the attach sequence `load_demo`
    ran before the call existed: the system and its name, the camera fitted
    to it, an empty selection and highlight, the default representation,
    SYSTEM_INIT, then the trajectory; and `load_demo` now gives that state."""
    from viamd_tpu_torch.app.events import EventType
    from viamd_tpu_torch.app.session import Representation
    from viamd_tpu_torch.core.bitfield import Bitfield
    from viamd_tpu_torch.datagen import polyala_helix
    from viamd_tpu_torch.render import camera as cam_mod

    def logged():
        s = Session(device="cpu")
        log = []
        for ev in (EventType.SYSTEM_INIT, EventType.TRAJECTORY_INIT):
            s.events.subscribe(ev, lambda e, ev=ev: log.append(ev))
        return s, log

    sys_, traj = polyala_helix(n_res=6, n_frames=3)
    old, old_log = logged()
    old.system = sys_
    old.files["system"] = "<demo:polyala>"
    old.camera = cam_mod.compute_optimal_view(*sys_.aabb())
    old.selection = Bitfield(sys_.natoms)
    old.highlight = Bitfield(sys_.natoms)
    old.representations.append(Representation())
    old._update_representations()
    old.events.broadcast(EventType.SYSTEM_INIT, old)
    old.set_trajectory(traj)
    new, new_log = logged()
    assert new.attach(sys_, traj, name="<demo:polyala>") is new
    demo = Session(device="cpu").load_demo(n_res=6, n_frames=3)
    assert new_log == old_log == [EventType.SYSTEM_INIT, EventType.TRAJECTORY_INIT]
    for s in (new, demo):
        assert s.files == old.files
        for k in ("eye", "center", "up", "fovy", "znear", "zfar"):
            np.testing.assert_array_equal(getattr(s.camera, k), getattr(old.camera, k))
        assert s.selection.popcount() == s.highlight.popcount() == 0
        assert len(s.selection.to_bools()) == sys_.natoms
        assert [(r.type, r.filter, r.color_mapping) for r in s.representations] == [
            (r.type, r.filter, r.color_mapping) for r in old.representations]
        np.testing.assert_array_equal(s.representations[0].mask.to_bools(),
                                      old.representations[0].mask.to_bools())
        assert s.num_frames == old.num_frames == 3
        s.set_frame(1.5)
        old.set_frame(1.5)
        np.testing.assert_array_equal(s.current_coords(), old.current_coords())
    assert new.system is sys_ and not new.script_text
    for s in (old, new, demo):
        s.shutdown()


# -- frames ----------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["nearest", "linear", "cubic"])
def test_current_coords(ala, mode):
    """TestSession::test_interpolated_coords, TestPlaybackModes."""
    for f in (0.0, 2.5, 3.25, 9.0):
        for s in ala:
            s.interpolation = mode
            s.set_frame(f)
        got, want = ala.each(lambda s: s.current_coords())
        assert got.dtype == np.float32 and got.shape == (30, 3)
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert torch.equal(ala.p.device_coords(), torch.as_tensor(got))


def test_velocities_and_cell(ala):
    """TestVelocities::test_finite_difference."""
    for f in (0.0, 3.0, 6.6, 9.0):
        ala.each(lambda s: s.set_frame(f))
        got, want = ala.each(lambda s: s.current_velocities(0.5))
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert ala.p.current_cell().is_periodic == ala.j.current_cell().is_periodic


def test_recenter(water):
    """Recentring on the waters: the same frames as the JAX package's,
    interpolated or not, and the same bits on every call."""
    p, j = water
    for s in water:
        s.recenter("resname('SOL')")
    for f in (0.0, 1.5, 3.0):
        water.each(lambda s: s.set_frame(f))
        got, want = water.each(lambda s: s.current_coords())
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert np.array_equal(got, p.current_coords())
    water.each(lambda s: s.recenter(None))
    got, want = water.each(lambda s: s.current_coords())
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.requires_cuda
def test_recenter_on_card_bit_equal(cuda, tmp_path):
    """On the card the recentred frame is the same bits call after call
    (com_segments sums in fixed point, where a float index_add_ adds in
    thread order), and within 1e-4 of the CPU's."""
    from viamd_tpu_torch.io.trajectory import InMemoryTrajectory

    gro, frames, basis = _water_files(tmp_path, n_waters=4000, n_frames=3)
    cells = np.broadcast_to(basis, (3, 3, 3)).copy()
    out = {}
    for dev in ("cpu", "cuda"):
        s = Session(num_workers=1, device=dev)
        try:
            s.load(gro)
            s.set_trajectory(InMemoryTrajectory(frames, cells))
            s.recenter("resname('SOL')")
            s.set_frame(1.5)
            a = s.device_coords()
            b = s.device_coords()
            assert a.device.type == dev and torch.equal(a, b)
            out[dev] = a.cpu().numpy()
        finally:
            s.shutdown()
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-4)


# -- renders ---------------------------------------------------------------------------


def _sphere_scene(s, rep, jitter=(0.0, 0.0), width=W, height=H):
    """The scene the port session draws for one sphere representation, as
    tests/test_torch_render.py's scene dict (for its undecided pixels)."""
    cols = s._rep_colors(rep, None, True)[0].cpu().numpy()
    cam = s._camera()
    return dict(
        positions=s.current_coords(),
        radii=np.where(cols[:, 3] > 0, s.system.radius, 0.0).astype(np.float32) * 1.0,
        colors=cols, bonds=None if rep.type == "spacefill" else s.system.bonds,
        view=cam.view_matrix(), proj=cam.proj_matrix(width, height, jitter), W=width,
        H=height, rep=rep.type,
    )


def hold_raster(p, got, want, rep_index=0):
    from tests.test_torch_render import XLA_RGB, _assert_matches, _xla_capacity

    rep = p.representations[rep_index]
    sc = _sphere_scene(p, rep)
    assert _xla_capacity(sc) <= 256  # the JAX session's XLA engine drops nothing (Pair)
    key = {"spacefill": "water_spacefill", "licorice": "water_licorice",
           "ballstick": "water_ballstick"}[rep.type]
    _assert_matches(_outs(got), _outs(want), sc, *XLA_RGB[key], tight=6e-3)


def hold_composite(got, want, share=PICK_SHARE, check_pick=True):
    """tests/test_torch_overlay.py's bounds (module docstring)."""
    img, dep, pick = _outs(got)
    jimg, jdep, jpick = _outs(want)
    assert img.shape == jimg.shape and img.dtype == np.float32
    off = np.isfinite(dep) != np.isfinite(jdep)
    if check_pick:
        off |= pick != jpick
    assert off.sum() <= share * off.size, off.sum()
    same = ~off
    assert np.array_equal(img[same][:, 3], jimg[same][:, 3])
    err = np.abs(img[same] - jimg[same]).max(-1)
    assert err.max() <= 1e-2 and (err > 6e-3).sum() <= share * off.size, err.max()
    return off


def hold_image(got, want, share=PICK_SHARE):
    """hold_composite on images alone (no depth or picks)."""
    img, jimg = _np(got), _np(want)
    assert img.shape == jimg.shape and np.isfinite(img).all()
    err = np.abs(img - jimg).max(-1)
    off = err > 1e-2
    assert off.sum() <= share * off.size, off.sum()
    assert (err > 6e-3).sum() <= 2 * share * off.size


@pytest.mark.parametrize("rep", ["spacefill", "licorice", "ballstick"])
def test_render_raw(ala, rep, one_thread):
    """TestSession::test_render_and_pick for each sphere representation
    (the thin licorice seen from closer, so that hits cover a tenth of the
    frame)."""
    p, j = ala
    if rep != "spacefill":
        _zoom(ala, 0.5)
    for s in ala:
        s.representations[0].type = rep
        s.set_frame(2.5)
    got, want = ala.each(lambda s: s.render(W, H))
    assert all(torch.is_tensor(a) and a.device.type == "cpu" for a in got)
    assert got[0].shape == (H, W, 4) and got[2].dtype == torch.int32
    hold_raster(p, got, want)
    # picking reports atom ids
    assert (got[2] >= 0).sum() > 0 and int(got[2].max()) < p.system.natoms


def test_render_postprocessed(ala, one_thread):
    """TestSession::test_render_postprocessed: the chain on the composite,
    the gbuffer outputs unchanged."""
    p, j = ala
    raw = p.render(W, H)
    got, want = ala.each(lambda s: s.render(W, H, postprocess=True))
    assert torch.equal(got[1], raw[1]) and torch.equal(got[2], raw[2])
    out, jout = _np(got[0]), _np(want[0])
    assert np.array_equal(out[..., 3], np.ones((H, W), np.float32))
    err = np.abs(out - jout).max(-1)
    assert (err <= 1e-3).mean() >= 0.97 and err.mean() <= 1e-3


def test_selection_outline_and_transparent_rep(ala, one_thread):
    """TestSession::test_selection_visuals and test_transparent_rep: the
    desaturation and outline of a selection, a highlight, and a
    transparent rep blended over the opaque one."""
    p, j = ala
    ala.each(lambda s: s.select("element('C')"))
    got, want = ala.each(lambda s: s.render(W, H))
    hold_raster(p, *ala.each(lambda s: s.render(W, H, show_selection=False)))
    hold_composite(got, want)
    outline = np.abs(_np(got[0])[..., :3] - [1.0, 0.6, 0.1]).sum(-1) < 1e-6
    joutline = np.abs(_np(want[0])[..., :3] - [1.0, 0.6, 0.1]).sum(-1) < 1e-6
    assert outline.sum() > 10 and (outline != joutline).sum() <= PICK_SHARE * outline.size
    for s in ala:
        s.highlight = s.select("residue(3)")
        s.select("element('N')")
        s.add_representation(name="glow", filter="all", type="spacefill",
                             color_mapping="uniform", uniform_color=(0, 0, 1, 1),
                             radius_scale=1.6, alpha=0.35)
    got, want = ala.each(lambda s: s.render(W, H))
    hold_composite(got, want)
    hi = np.abs(_np(got[0])[..., :3] - [1.0, 0.85, 0.3]).sum(-1) < 1e-6
    assert hi.sum() > 5


def test_render_cartoon_and_overlay(monkeypatch, one_thread):
    """TestBackboneReps::test_tube_and_cartoon_render on the demo helix:
    the cartoon through the triangle raster, the tube through the sphere
    raster; TestOverlay::test_render_with_box_and_vis: the script's
    geometry and text over the spacefill (hold_overlay_pass)."""
    import tests.test_torch_triangles as tt
    from viamd_tpu_torch.render.backbone_rep import current_ss_weights
    from viamd_tpu_torch.render.ribbon_mesh import ribbon_mesh
    from viamd_tpu_torch.render.triangles import view_transform

    s = Pair(monkeypatch)
    try:
        s.each(lambda x: x.load_demo(n_res=3, n_frames=4))
        _zoom(s, 0.6)
        cw, ch = 128, 96
        for x in s:
            x.representations[0].type = "cartoon"
            x.representations[0].color_mapping = "secondary_structure"
        got, want = s.each(lambda x: x.render(cw, ch))
        p = s.p
        x = p.current_coords()
        ss = current_ss_weights(p.system, x, device="cpu").numpy()
        tris, src = ribbon_mesh(p.system, x, ss_weights=ss, cartoon=True)
        tv = view_transform(tris, p.camera.view_matrix(), device="cpu").numpy()
        sc = dict(tris=tv, W=cw, H=ch)
        proj = p.camera.proj_matrix(cw, ch)
        monkeypatch.setattr(tt, "_proj", lambda _w, _h: proj)
        assert tt._tile_counts(sc).max() < tt.JAX_CAP
        und = tt._undecided(sc)
        assert und.mean() <= tt.UNDECIDED_SHARE
        tt._hold(_outs(got), _outs(want), und)
        assert (_np(got[2]) >= 0).sum() > 0.1 * cw * ch
        for x in s:
            x.representations[0].type = "tube"
        got, want = s.each(lambda x: x.render(cw, ch))
        hold_composite(got, want)
        assert int(got[2].max()) < p.system.natoms
        # the script's geometry from the session's own camera, which the JAX
        # raster draws whole (module docstring)
        _zoom(s, 1 / 0.6)
        for x in s:
            x.representations[0].type = "spacefill"
            x.representations[0].color_mapping = "cpk"
            x.set_script("d1 = distance(1, 10);\na1 = angle(2, 1, 3);\nd2 = dihedral(1, 2, 3, 4);")
            assert not x.script_errors
        hold_overlay(s, cw, ch, lambda q: q.add_script_visualization(
            p.compiled.visualization, p.current_coords()), show_script_vis=True)
    finally:
        s.shutdown()


def hold_overlay(pair, width, height, fill, **render_kw):
    """The port session's frame with an overlay against the JAX session's,
    at tests/test_torch_overlay.py's bounds on the decided pixels (module
    docstring); then hold_overlay_pass. `fill` puts the session's overlay
    into a port OverlayQueue, for the undecided pixels."""
    import tests.test_torch_triangles as tt
    from tests.test_torch_render import _unambiguous, _view_space
    from viamd_tpu_torch.render.overlay import OverlayQueue

    p = pair.p
    got, want = pair.each(lambda s: s.render(width, height, **render_kw))
    q = OverlayQueue()
    fill(q)
    pos, rad, col, _ = q.primitives()
    sc = _sphere_scene(p, p.representations[0], width=width, height=height)
    assert sc["rep"] == "spacefill"
    sc.update(positions=np.concatenate([sc["positions"], pos]).astype(np.float32),
              radii=np.concatenate([sc["radii"], rad]).astype(np.float32),
              colors=np.concatenate([sc["colors"], col]).astype(np.float32))
    und = ~_unambiguous(*_view_space(sc), sc["proj"], width, height)
    if q._tris:
        view = np.asarray(sc["view"], np.float32)
        tv = np.stack(q._tris).astype(np.float32) @ view[:3, :3].T + view[:3, 3]
        with pytest.MonkeyPatch.context() as m:
            m.setattr(tt, "_proj", lambda _w, _h: sc["proj"])
            und |= tt._undecided(dict(tris=tv, W=width, H=height))
    assert und.sum() <= PICK_SHARE * und.size, und.sum()
    img, dep, pick = _outs(got)
    jimg, jdep, jpick = _outs(want)
    ok = ~und
    np.testing.assert_array_equal(pick[ok], jpick[ok])
    np.testing.assert_array_equal(np.isfinite(dep[ok]), np.isfinite(jdep[ok]))
    np.testing.assert_array_equal(img[ok][:, 3], jimg[ok][:, 3])
    hit = ok & np.isfinite(jdep)
    assert (np.abs(dep[hit] - jdep[hit]) <= 5e-4 * jdep[hit]).all()
    err = np.abs(img[ok][:, :3] - jimg[ok][:, :3]).max(-1)
    assert err.max() <= 1e-2 and (err > 6e-3).sum() <= PICK_SHARE * err.size, err.max()
    hold_overlay_pass(p, width, height, q, **render_kw)


def hold_overlay_pass(p, width, height, q, **render_kw):
    """The session's frame with an overlay is its raw frame depth-composited
    with the overlay queue `q`'s render."""
    img, dep, pick = p.render(width, height, **render_kw)
    raw = p.render(width, height)
    o_img, o_dep, o_pick = q.render(p.camera.view_matrix(), p.camera.proj_matrix(width, height),
                                    width, height, device="cpu")
    closer = o_dep < raw[1]
    assert torch.equal(img, torch.where(closer[..., None], o_img, raw[0]))
    assert torch.equal(pick, torch.where(closer, o_pick, raw[2]))
    assert torch.equal(dep, torch.minimum(raw[1], o_dep))
    assert int(closer.sum()) > 20


def test_render_box_overlay(water, one_thread):
    """TestOverlay::test_render_with_box_and_vis's box: the periodic box's
    edges over the spacefill water, against the JAX session, seen from a
    camera 1.3 box lengths from the centre (the session's own, 2.4 box
    lengths away, makes the box's lines thinner than a pixel, and the JAX
    XLA engine draws 147 of their 276 pixels)."""
    from viamd_tpu.render.camera import Camera as JCamera
    from viamd_tpu_torch.render.camera import Camera

    p = water.p
    basis = np.asarray(p.system.cell.basis, np.float32)
    c = basis.sum(0) / 2
    eye = c + np.float32([0.7, 0.5, 1.3 * basis[0, 0]])
    for s, cam in zip(water, (Camera, JCamera)):
        s.camera = cam(eye=eye, center=c, up=np.float32([0, 1, 0]), fovy=0.75)
    hold_overlay(water, W, H, lambda q: q.add_box(basis), show_box=True)


def test_render_inscene_volume(water, one_thread, monkeypatch):
    """The SDF of the water box ray-marched into the scene, unjittered in
    both packages: the volume pass (`_render_volume_inscene`) of each
    package given the same opaque frame (the JAX session's) is held to
    tests/test_torch_volume.py's bounds; so is an explicit {grid, model}
    scene volume (`_composite_scene_volume`, the orbital path); and
    render(volume=...) is the raw frame through that pass."""
    import jax

    from tests.test_torch_density_volume import hold_volume
    from viamd_tpu.render import volume as JV
    from viamd_tpu_torch.render import cuda_volume
    from viamd_tpu_torch.render import volume as PV

    monkeypatch.setattr(JV, "VolumeRenderSettings",
                        functools.partial(JV.VolumeRenderSettings, jitter=False))
    monkeypatch.setattr(PV, "VolumeRenderSettings",
                        functools.partial(PV.VolumeRenderSettings, jitter=False))
    marches = []
    render = cuda_volume.render

    def recorded(grid, tf, cvol, rays, march, jitter=None, scene_depth=None, rays_out=None):
        table = cuda_volume.ray_setup(rays, None, scene_depth, device=grid.device)
        und = []
        cuda_volume.march_plain(grid, tf, cvol, table, rays.width, rays.height, march,
                                undecided=und)
        marches.append(und[0].cpu().numpy())
        return render(grid, tf, cvol, rays, march, jitter, scene_depth, rays_out)

    monkeypatch.setattr(cuda_volume, "render", recorded)
    p, j = water
    for s in water:
        s.set_script("v = sdf(residue(1:6), element('H'), 4.0);")
        s.evaluate(chunk=2)
    # the same inputs: the JAX grid and reference frames (the SDF's own
    # parity is tests/test_torch_sdf.py's), the JAX session's opaque frame
    p.eval_result._vol_dev["v"] = torch.as_tensor(np.array(j.eval_result.volumes["v"]))
    p.eval_result._vol_np = None
    frames = np.asarray(j.components["density_volume"].reference_frames("v"))
    for x in water:
        monkeypatch.setattr(x.components["density_volume"], "reference_frames",
                            lambda *a, **k: frames)
    jimg, jdep, _ = (np.array(a) for a in j.render(W, H))
    base, depth = torch.as_tensor(jimg), torch.as_tensor(jdep)
    ax = np.linspace(-1.0, 1.0, 20)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = (np.exp(-6.0 * ((X - 0.3) ** 2 + Y ** 2 + Z ** 2))
         - np.exp(-6.0 * ((X + 0.3) ** 2 + Y ** 2 + Z ** 2))).astype(np.float32)  # two lobes
    model = np.eye(4, dtype=np.float32)
    model[:3, :3] *= 10.0
    model[:3, 3] = 1.0
    for vol in ("v", {"grid": g, "model": model}):
        got = p._render_volume_inscene(vol, base, depth, W, H, (0.0, 0.0))
        with jax.disable_jit():  # the JAX march op by op (module docstring)
            want = j._render_volume_inscene(vol, jimg, jdep, W, H, (0.0, 0.0))
        hold_volume((got, jdep), (want, jdep), marches[-1])
        assert (got.numpy() != jimg).any()
    img, dep, _ = p.render(W, H, volume="v")
    raw = p.render(W, H)
    assert torch.equal(img, p._render_volume_inscene("v", raw[0], raw[1], W, H, (0.0, 0.0)))
    assert torch.equal(dep, raw[1])


def test_render_accumulated(ala, one_thread):
    """TestSession::test_render_accumulated: the Halton-jittered average."""
    got, want = ala.each(lambda s: s.render_accumulated(W, H, samples=4))
    hold_composite(got, want, share=2 * PICK_SHARE)
    img = _np(got[0])
    edge = ((img[..., 3] > 0.01) & (img[..., 3] < 0.99)).sum()
    assert edge > 0 and got[0].dtype == torch.float32


@pytest.mark.parametrize("mode", ["plain", "motion_blur", "taa"])
def test_render_frames(ala, mode, one_thread):
    """TestMovieRendering: frames yielded at fractional positions, with
    motion blur, and with the velocity-reprojected TAA under a moving
    camera."""
    from viamd_tpu_torch.render import camera as cam_mod

    kw = dict(motion_blur=mode == "motion_blur", taa=mode == "taa")
    gens = ala.each(lambda s: s.render_frames([0, 1.5, 3, 3.5], W, H, **kw))
    share = 3 * PICK_SHARE if mode == "taa" else PICK_SHARE
    for k in range(4):
        if mode == "taa" and k:
            for s in ala:  # an orbit: camera motion enters the velocities
                s.camera = cam_mod.trackball_rotate(s.camera, 0.02, 0.01)
        (fp, img), (fj, jimg) = next(gens[0]), next(gens[1])
        assert fp == fj and torch.is_tensor(img) and img.shape == (H, W, 4)
        hold_image(img, jimg, share=share)


def test_select_at_and_rect(ala, one_thread):
    """TestSession::test_select_at_and_rect: the same atom under a decided
    pixel, its residue, the rect, and the add / remove modes."""
    p, j = ala
    _, _, pick = p.render(W, H)
    _, _, jpick = j.render(W, H)
    pick = pick.numpy()
    agree = (pick >= 0) & (pick == np.asarray(jpick))
    ys, xs = np.nonzero(agree)
    y, x = int(ys[len(ys) // 2]), int(xs[len(ys) // 2])
    assert p.pick(x, y, W, H) == j.pick(x, y, W, H) == pick[y, x]
    for level in ("atom", "residue", "chain", "instance"):
        pm, jm = ala.each(lambda s: s.select_at(x, y, level, W, H))
        assert np.array_equal(pm.to_bools(), jm.to_bools()), level
    pm, jm = ala.each(lambda s: s.select_rect(0, 0, W - 1, H - 1, W, H))
    assert pm.popcount() == np.unique(pick[pick >= 0]).size
    assert abs(pm.popcount() - jm.popcount()) <= 1
    before = p.selection.popcount()
    p.select_at(x, y, "atom", W, H, mode="remove")
    assert p.selection.popcount() == before - 1
    p.select_at(x, y, "atom", W, H, mode="add")
    assert p.selection.popcount() == before
    with pytest.raises(ValueError):
        p.select_at(x, y, "molecule", W, H)
