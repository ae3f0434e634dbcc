"""The postprocess chain of the port (render/hbao.py, render/fxaa.py,
render/postprocess.py) against viamd_tpu on seeded numpy frames, and the
render slice end to end: render_molecules → postprocess.execute in both
packages on a small water box.

Tolerances.
- HBAO, its blur, the tonemaps, ssao, normals and linear depth: 1e-5
  absolute on values in [0, 1] (float32; the JAX package's CPU backend
  contracts a·b + c into FMAs, the port does not; HBAO's mip fetch and
  pow(ao, 6) stay within that on these frames).
- FXAA 3.11: 1e-5 on the same input. Its span test `edge_horz >=
  edge_vert` is an exact tie wherever the centre is a local luma extremum,
  so its decisions hang on the luma's last bit: the port rounds the luma
  as the JAX backend does (render/fxaa.py::_luma), and on identical input
  the two agree to 1e-5. After the AO pass and the tonemap, whose last bits
  differ between the packages, ties break differently at a few pixels, so
  the whole chain is held to 1e-5 with FXAA off, and with FXAA on to 1e-5
  at 97% of pixels.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.render import fxaa as PF
from viamd_tpu_torch.render import hbao as PH
from viamd_tpu_torch.render import postprocess as PP
from viamd_tpu_torch.render.raster import RasterSettings, render_molecules

H, W = 48, 64


def _frame(seed=0):
    rng = np.random.RandomState(seed)
    rgba = rng.rand(H, W, 4).astype(np.float32)
    rgba[..., 3] = rng.rand(H, W) > 0.3
    depth = rng.uniform(5, 20, (H, W)).astype(np.float32)
    depth[:6] = np.inf  # background rows
    return rgba, depth


def _step_depth():
    """test_hbao_flat_step_background's frame: a closer box on a plane."""
    d = np.full((H, W), 10.0, np.float32)
    d[12:36, 20:44] = 6.0
    d[:4] = np.inf
    return d


def _proj(ortho=False):
    from viamd_tpu_torch.render.camera import Camera, orthographic

    if ortho:
        return orthographic(-10, 10, -10, 10, 0.1, 50.0)
    c = Camera(eye=np.array([0, 0, 20.0]), center=np.zeros(3),
               up=np.array([0, 1, 0.0]))
    return c.proj_matrix(W, H)


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("frame", ["noise", "step"])
def test_hbao(ortho, frame):
    from viamd_tpu.render import hbao as JH

    d = _frame()[1] if frame == "noise" else _step_depth()
    proj = _proj(ortho)
    _close(PH.view_normals(torch.as_tensor(d), proj, ortho), JH.view_normals(d, proj, ortho))
    for blur in (False, True):
        got = PH.hbao(torch.as_tensor(d), proj, ortho=ortho, blur=blur)
        _close(got, JH.hbao(d, proj, ortho=ortho, blur=blur))
    got = PH.hbao(torch.as_tensor(d), proj, ortho=ortho, intensity=2.0, radius=3.0, bias=0.3)
    _close(got, JH.hbao(d, proj, ortho=ortho, intensity=2.0, radius=3.0, bias=0.3))
    if frame == "step" and not ortho:
        ao = got.numpy()
        assert ao[2, 2] == 1.0 and ao[10, 32] < ao[24, 32]  # background; occluded ring


def test_hbao_blur():
    from viamd_tpu.render import hbao as JH

    rng = np.random.RandomState(1)
    ao = rng.rand(H, W).astype(np.float32)
    d = _step_depth()
    for sharp in (0.5, 4.0 / np.sqrt(6.0)):
        got = PH.hbao_blur(torch.as_tensor(ao), torch.as_tensor(d), sharpness=sharp, z_max=40.0)
        _close(got, JH.hbao_blur(ao, d, sharpness=sharp, z_max=40.0))


@pytest.mark.parametrize("image", ["noise", "edge", "rgba", "flat"])
def test_fxaa311(image):
    from viamd_tpu.render import fxaa as JF

    if image == "noise":
        x = _frame(2)[0][..., :3]
    elif image == "edge":
        x = np.zeros((H, W, 3), np.float32)
        x[:, 30:] = 1.0
        x[20:, :10] = 0.5
    elif image == "rgba":
        x = _frame(3)[0]
    else:
        x = np.full((H, W, 3), 0.5, np.float32)
    got = PF.fxaa311(torch.as_tensor(x))
    assert got.shape == x.shape
    _close(got, JF.fxaa311(x))
    if image == "flat":  # the early exit returns the input exactly
        np.testing.assert_array_equal(got.numpy(), x)
    for kw in (dict(subpix=0.75), dict(edge_threshold=0.25, edge_threshold_min=0.02)):
        _close(PF.fxaa311(torch.as_tensor(x), **kw), JF.fxaa311(x, **kw))


@pytest.mark.parametrize("name", ["passthrough", "exposure_gamma", "aces", "uncharted2", "hejl_dawson"])
def test_tonemaps(name):
    from viamd_tpu.render import postprocess as JP

    x = np.concatenate([_frame(4)[0][..., :3] * 4.0, np.zeros((1, W, 3), np.float32)])
    got = PP.TONEMAPS[name](torch.as_tensor(x))
    _close(got, JP.TONEMAPS[name](x))
    assert torch.isfinite(got).all()


def test_depth_utilities():
    from viamd_tpu.render import postprocess as JP

    d = _frame()[1]
    proj = _proj()
    _close(PP.ssao(torch.as_tensor(d)), JP.ssao(d))
    _close(PP.ssao(torch.as_tensor(d), 0.5, radius_px=4, n_samples=6), JP.ssao(d, 0.5, radius_px=4, n_samples=6))
    _close(PP.normals_from_depth(torch.as_tensor(d), proj), JP.normals_from_depth(d, proj))
    _close(PP.linearize_depth(torch.as_tensor(d), 1.0, 30.0), JP.linearize_depth(d, 1.0, 30.0))


def _execute_both(rgba, depth, proj, **kw):
    from viamd_tpu.render import postprocess as JP

    want = np.asarray(JP.execute(rgba, depth, JP.PostprocessSettings(**kw), proj=proj))
    got = PP.execute(torch.as_tensor(rgba), torch.as_tensor(depth),
                     PP.PostprocessSettings(**kw), proj=proj)
    return got.numpy(), want


@pytest.mark.parametrize("ao", ["hbao", "ssao", "off"])
def test_execute(ao):
    rgba, depth = _frame(5)
    proj = _proj() if ao == "hbao" else None
    kw = dict(enable_ssao=ao != "off")
    got, want = _execute_both(rgba, depth, proj, enable_fxaa=False, **kw)
    _close(got, want)
    got, want = _execute_both(rgba, depth, proj, **kw)  # the defaults
    assert got.shape == (H, W, 3) and (got >= 0).all() and (got <= 1).all()
    assert (np.abs(got - want).max(-1) <= 1e-5).mean() >= 0.97
    # FXAA is the chain's last pass: the same image, fed to both FXAAs
    pre, _ = _execute_both(rgba, depth, proj, enable_fxaa=False, **kw)
    np.testing.assert_array_equal(PF.fxaa311(torch.as_tensor(pre)).clamp(0, 1).numpy(), got)


def test_execute_settings():
    from viamd_tpu.render import postprocess as JP

    rgba, depth = _frame(6)
    for kw in (dict(tonemap="exposure_gamma", exposure=1.5, gamma=2.0),
               dict(tonemap="uncharted2", background=(0.2, 0.1, 0.0)),
               dict(ssao_intensity=3.0, ssao_radius=2.0, ssao_bias=0.2)):
        got, want = _execute_both(rgba, depth, _proj(), enable_fxaa=False, **kw)
        _close(got, want)
    assert PP.PostprocessSettings() == PP.PostprocessSettings(**{
        k: getattr(JP.PostprocessSettings(), k) for k in PP.PostprocessSettings.__dataclass_fields__
    })
    # the passes that once raised run now: sharpen and motion blur to 1e-5
    # (no hash), the bokeh DOF within its random phase (its per-pixel sin
    # hash rounds apart, tests/test_torch_postprocess_passes.py)
    vel = np.zeros((H, W, 2), np.float32)
    vel[10:30, 20:40] = (5.0, -2.0)
    for kw in (dict(enable_sharpen=True), dict(enable_motion_blur=True)):
        want = np.asarray(JP.execute(rgba, depth, JP.PostprocessSettings(enable_fxaa=False, **kw),
                                     velocity=vel))
        got = PP.execute(torch.as_tensor(rgba), torch.as_tensor(depth),
                         PP.PostprocessSettings(enable_fxaa=False, **kw), velocity=vel)
        _close(got, want)
    kw = dict(enable_dof=True, dof_max_blur=4.0, enable_fxaa=False)
    want = np.asarray(JP.execute(rgba, depth, JP.PostprocessSettings(**kw)))
    got = PP.execute(torch.as_tensor(rgba), torch.as_tensor(depth), PP.PostprocessSettings(**kw))
    assert np.abs(got.numpy() - want).mean() < 5e-3 and abs(got.numpy().mean() - want.mean()) < 5e-4


@pytest.mark.parametrize("rep", ["spacefill", "licorice"])
def test_slice_end_to_end(rep):
    """render_molecules → execute (HBAO, ACES, compose, FXAA) in both
    packages on water_box(200) at 128×96. The raster is held as in
    tests/test_torch_render.py; the finished frames agree to 1e-3 at 97% of
    pixels and to 1e-3 in the mean: the raster's rgb differs most on thin
    capsules seen nearly edge-on (ill-conditioned hits, see that module),
    and those pixels spread through HBAO's radius and FXAA's ties."""
    from tests.test_torch_render import XLA_RGB, _assert_matches, _jax, _water, _xla_capacity
    from viamd_tpu.render import postprocess as JP

    sc = _water(rep)
    want = _jax(sc, engine="xla", capacity=_xla_capacity(sc))
    s = RasterSettings(width=sc["W"], height=sc["H"], rep=rep)
    img, dep, pick = render_molecules(sc["positions"], sc["radii"], sc["colors"],
                                      sc["view"], sc["proj"], s, sc["bonds"], device="cpu")
    _assert_matches((img.numpy(), dep.numpy(), pick.numpy()), want, sc,
                    *XLA_RGB[f"water_{rep}"], tight=6e-3)
    out = PP.execute(img, dep, PP.PostprocessSettings(), proj=sc["proj"]).numpy()
    jout = np.asarray(JP.execute(want[0], want[1], JP.PostprocessSettings(), proj=sc["proj"]))
    err = np.abs(out - jout).max(-1)
    assert out.shape == (sc["H"], sc["W"], 3) and np.isfinite(out).all()
    assert (err <= 1e-3).mean() >= 0.97 and err.mean() <= 1e-3
    fg = pick.numpy() >= 0
    assert fg.mean() > 0.1 and not np.allclose(out[fg], out[~fg].mean(0))
