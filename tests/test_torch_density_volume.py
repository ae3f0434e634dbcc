"""The port's density-volume and dataset components
(viamd_tpu_torch/components/density_volume.py, dataset.py) against
viamd_tpu's on a SimpleNamespace session over each package's own objects
built from the same numpy data; the oracle is TestComponents
(tests/test_app.py), at 48×48 (under 256², so the JAX package ray-marches
too: it switches to shear-warp from 256² on, the port never does). Also
the sdf_by_name repair: a volume property's vis.sdf payload recovered by
name after a checkpoint round trip.

Tolerances.
- Volume renders (`render`, clip, scene depth, composite), unjittered (the
  two packages' jitter streams differ; the tests make both settings
  unjittered): those of tests/test_torch_volume.py — rgba within 1e-4 and
  depth within 4e-6 relative at every decided pixel, within 1e-5 at 97%
  of them, under 2% undecided (a march within rounding of an iso value or
  an alpha threshold). The grids are the two packages' SDF volumes, which
  agree to float32 rounding.
- Reference structures (`render_references`): the overlay bounds of
  tests/test_torch_overlay.py (≤ 1% of pixels differ in pick or coverage
  at silhouettes; elsewhere alpha equal, rgb within 1e-2).
- reference_frames: 2e-5 (the float32 closed-form Kabsch on both sides).
- The vis.sdf payload, the summary, the remapped elements, radii, masses
  and bonds: exact.
"""

import types

import numpy as np
import pytest
import torch

from tests._torch_parity import port_system
from tests.conftest import make_ala_pdb, make_water_box
from viamd_tpu_torch.app.events import EventBus
from viamd_tpu_torch.components import DatasetComponent, DensityVolumeComponent
from viamd_tpu_torch.eval import Evaluator, load_checkpoint, save_checkpoint
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.io.trajectory import InMemoryTrajectory
from viamd_tpu_torch.render import cuda_volume
from viamd_tpu_torch.render import volume as PV
from viamd_tpu_torch.script import compile_script

SCRIPT = "v = sdf(residue(1:4), element('H'), 4.0);"
W = H = 48
PICK_SHARE = 0.01


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def unjittered(monkeypatch):
    """Both packages' VolumeRenderSettings default to no jitter, and each
    port march is recorded with the pixels it left undecided."""
    import functools

    from viamd_tpu.render import volume as JV

    monkeypatch.setattr(JV, "VolumeRenderSettings",
                        functools.partial(JV.VolumeRenderSettings, jitter=False))
    monkeypatch.setattr(PV, "VolumeRenderSettings",
                        functools.partial(PV.VolumeRenderSettings, jitter=False))
    marches = []
    render = cuda_volume.render

    def recorded(grid, tf, cvol, rays, march, jitter=None, scene_depth=None, rays_out=None):
        assert jitter is None
        table = cuda_volume.ray_setup(rays, None, scene_depth, device=grid.device)
        und = []
        cuda_volume.march_plain(grid, tf, cvol, table, rays.width, rays.height, march,
                                undecided=und)
        marches.append(und[0].cpu().numpy())
        return render(grid, tf, cvol, rays, march, jitter, scene_depth, rays_out)

    monkeypatch.setattr(cuda_volume, "render", recorded)
    return marches


def hold_volume(got, want, und, rgba_tol=1e-4, depth_rtol=4e-6, strict=1e-5):
    """tests/test_torch_volume.py's bounds on one (rgba, depth) pair."""
    got_i, got_d = (np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in got)
    want_i, want_d = (np.asarray(a) for a in want)
    assert got_i.shape == want_i.shape and got_d.shape == want_d.shape
    assert np.isfinite(got_i).all()
    e = np.abs(got_i - want_i).max(-1)
    fin = np.isfinite(got_d) & np.isfinite(want_d)
    rel = np.zeros_like(got_d)
    diff = np.abs(np.where(fin, got_d, 0) - np.where(fin, want_d, 0))
    np.divide(diff, np.abs(want_d), where=fin, out=rel)
    bad = (e > rgba_tol) | (np.isfinite(got_d) != np.isfinite(want_d)) | (rel > depth_rtol)
    dec = ~und
    assert not (bad & dec).any(), (e[bad & dec], rel[bad & dec])
    assert (e[dec] <= strict).mean() >= 0.97
    assert und.mean() <= 0.02


def hold_overlay(got, want):
    """tests/test_torch_overlay.py's bounds on (rgba, depth[, pick])."""
    img, dep = (t.cpu().numpy() for t in got[:2])
    jimg, jdep = (np.asarray(a) for a in want[:2])
    off = np.isfinite(dep) != np.isfinite(jdep)
    if len(got) > 2:
        off |= got[2].cpu().numpy() != np.asarray(want[2])
    assert off.sum() <= PICK_SHARE * off.size
    same = ~off
    assert np.array_equal(img[same][:, 3], jimg[same][:, 3])
    err = np.abs(img[same] - jimg[same]).max(-1)
    assert err.max() <= 1e-2 and (err > 6e-3).sum() <= PICK_SHARE * off.size
    assert np.isfinite(dep).any()


class _Both:
    """The water fixture evaluated by both packages, and a density-volume
    component of each over a SimpleNamespace session."""

    def __init__(self):
        from viamd_tpu.app.events import EventBus as JBus
        from viamd_tpu.components.density_volume import DensityVolumeComponent as JDV
        from viamd_tpu.eval import Evaluator as JEvaluator
        from viamd_tpu.script import compile_script as j_compile

        sys_j, traj_j = make_water_box()
        frames, cells = traj_j.load_frames(list(range(traj_j.num_frames)))
        self.frames = frames
        self.cj = j_compile(SCRIPT, sys_j)
        self.rj = JEvaluator(self.cj, traj_j, chunk=5).run()
        sys_t = port_system(sys_j)
        self.ct = compile_script(SCRIPT, sys_t, "cpu")
        self.rt = Evaluator(self.ct, trajectory_from_numpy(frames, cells, "cpu"), chunk=5).run()
        self.sj = self.session(sys_j, traj_j, self.cj, self.rj, JBus())
        self.st = self.session(sys_t, InMemoryTrajectory(frames, cells), self.ct, self.rt,
                               EventBus())
        self.jdv = JDV(self.sj)
        self.tdv = DensityVolumeComponent(self.st, device="cpu")

    def session(self, sys_, traj, compiled, res, events):
        frames = self.frames
        return types.SimpleNamespace(system=sys_, trajectory=traj, compiled=compiled,
                                     eval_result=res, events=events,
                                     current_coords=lambda: frames[0])


@pytest.fixture(scope="module")
def both():
    return _Both()


def _same_payload(a, b):
    assert a.keys() == b.keys() == {"extent", "structures", "struct_idx", "struct_w",
                                    "ref_centered"}
    assert a["extent"] == b["extent"] == 4.0
    assert len(a["structures"]) == len(b["structures"]) == 4
    for x, y in zip(a["structures"], b["structures"]):
        np.testing.assert_array_equal(x, y)
    for k in ("struct_idx", "struct_w", "ref_centered"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_sdf_vis_and_reference_frames(both):
    assert both.tdv.volume_properties() == both.jdv.volume_properties() == ["v"]
    _same_payload(both.tdv.sdf_vis("v"), both.jdv.sdf_vis("v"))
    got = both.tdv.reference_frames("v", frame=0)
    want = both.jdv.reference_frames("v", frame=0)
    assert got.shape == (4, 4, 4)
    np.testing.assert_allclose(got, want, atol=2e-5)
    with pytest.raises(KeyError):
        both.tdv.sdf_vis("nope")


def test_sdf_by_name_after_checkpoint(both, tmp_path):
    """A checkpoint-restored result has no spec.vis: the payload comes back
    by name from the session's compiled script (`visualization
    ["sdf_by_name"]`, a dict in both packages)."""
    from viamd_tpu.components.density_volume import DensityVolumeComponent as JDV
    from viamd_tpu.eval.engine import load_checkpoint as j_load
    from viamd_tpu.eval.engine import save_checkpoint as j_save

    save_checkpoint(both.rt, str(tmp_path / "port.npz"))
    j_save(both.rj, str(tmp_path / "jax.npz"))
    rt, rj = load_checkpoint(str(tmp_path / "port.npz")), j_load(str(tmp_path / "jax.npz"))
    assert rt.property("v").spec.vis is None and rj.property("v").spec.vis is None
    assert isinstance(both.ct.visualization["sdf_by_name"], dict)
    assert isinstance(both.ct.visualization["sdf"], list)
    tdv = DensityVolumeComponent(both.session(both.st.system, both.st.trajectory, both.ct, rt,
                                              EventBus()), device="cpu")
    from viamd_tpu.app.events import EventBus as JBus

    jdv = JDV(both.session(both.sj.system, both.sj.trajectory, both.cj, rj, JBus()))
    _same_payload(tdv.sdf_vis("v"), jdv.sdf_vis("v"))
    # the restored result renders as the live one does
    np.testing.assert_array_equal(rt.normalized_volume("v"), both.rt.normalized_volume("v"))


@pytest.mark.parametrize("case", ["plain", "clip", "isos", "blur"])
def test_render_matches_jax(both, unjittered, one_thread, case):
    for dv in (both.tdv, both.jdv):
        dv.clip_min, dv.clip_max = ((0.55, 0.0, 0.0), (1.0, 1.0, 1.0)) if case == "clip" \
            else ((0.0,) * 3, (1.0,) * 3)
        dv.iso_values, dv.iso_colors = (), ()
        if case == "isos":
            dv.set_isosurfaces((0.2, 0.5))
        dv.blur_sigma = 1.0 if case == "blur" else 0.0
    try:
        got = both.tdv.render(width=W, height=H)
        want = both.jdv.render(width=W, height=H)
        hold_volume(got, want, unjittered[-1])
        assert float(got[0][..., 3].sum()) > 0
    finally:
        for dv in (both.tdv, both.jdv):
            dv.clip_min, dv.clip_max = (0.0,) * 3, (1.0,) * 3
            dv.iso_values, dv.iso_colors, dv.blur_sigma = (), (), 0.0


def test_references_scene_depth_and_composite(both, unjittered, one_thread):
    """TestComponents::test_density_volume_inscene_clip_and_composite at the
    component surface: the references, the scene-depth clamp and the OVER
    composite."""
    got_ref = both.tdv.render_references("v", frame=0, width=W, height=H)
    want_ref = both.jdv.render_references("v", frame=0, width=W, height=H)
    hold_overlay(got_ref, want_ref)
    full = both.tdv.render(width=W, height=H)
    clamped = both.tdv.render(width=W, height=H, scene_depth=got_ref[1])
    hold_volume(clamped, both.jdv.render(width=W, height=H, scene_depth=got_ref[1].numpy()),
                unjittered[-1])
    assert float(clamped[0][..., 3].sum()) < float(full[0][..., 3].sum()) - 1e-3
    comp = both.tdv.render_composite("v", frame=0, width=W, height=H)
    want = both.jdv.render_composite("v", frame=0, width=W, height=H)
    assert comp.shape == (H, W, 4) and bool(torch.isfinite(comp).all())
    assert int((comp[..., 3] > 0.5).sum()) > 10
    # composites agree where the two reference renders do
    ref_off = np.isfinite(got_ref[1].numpy()) != np.isfinite(np.asarray(want_ref[1]))
    e = np.abs(comp.numpy() - want).max(-1)
    assert (e[~ref_off] <= 1e-2).mean() >= 0.99


# -- dataset (TestComponents::test_dataset_summary, ::test_dataset_remap) -------


def _dataset_sessions(tmp_path):
    from viamd_tpu.app.events import EventBus as JBus
    from viamd_tpu.components.dataset import DatasetComponent as JDS
    from viamd_tpu.io.pdb import parse_pdb

    p = tmp_path / "ala.pdb"
    p.write_text(make_ala_pdb(6, n_models=10))
    sys_j, _ = parse_pdb(p.read_text())
    sys_t = port_system(sys_j)

    def sess(sys_, bus):
        return types.SimpleNamespace(system=sys_, files={"system": str(p)}, num_frames=10,
                                     stored_selections={}, events=bus)

    tb, jb = EventBus(), JBus()
    return (DatasetComponent(sess(sys_t, tb), device="cpu"), JDS(sess(sys_j, jb)), tb, jb)


def test_dataset_summary(tmp_path):
    tds, jds, _, _ = _dataset_sessions(tmp_path)
    got = tds.summary()
    assert got == jds.summary()
    assert got["atoms"] == 30 and got["residues"] == 6 and got["frames"] == 10
    assert got["elements"]["C"] == 18


@pytest.mark.parametrize("expr,symbol", [("name('CB')", "S"), ("residue(2:3)", "N")])
def test_dataset_remap(tmp_path, expr, symbol):
    tds, jds, tb, jb = _dataset_sessions(tmp_path)
    seen = []
    tb.subscribe("system_init", lambda ev: seen.append(ev.payload))
    n = tds.remap_element(expr, symbol)
    assert n == jds.remap_element(expr, symbol)
    st, sj = tds.session.system, jds.session.system
    for f in ("element", "radius", "mass", "bonds"):
        got, want = np.asarray(getattr(st, f)), np.asarray(getattr(sj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert len(seen) == 1
    if expr == "name('CB')":
        assert n == 6 and (st.element == 16).sum() == 6
    with pytest.raises(ValueError):
        tds.remap_element("all", "Xx")
