"""The port's volume view (render/volume.py, render/cuda_volume.py,
render/colormap.py, ops/histogram.py and ops/density.py's splats and blur)
against viamd_tpu on the same seeded numpy inputs; the oracles are
TestVolumeRender, TestColorVolume and TestVolumeClipAndDepth
(tests/test_render.py).

The JAX package is imported inside the tests that use it, so the tests
marked `requires_cuda` collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_volume.py

Tolerances.
- Volume renders, unjittered (the two packages' jitter streams differ):
  rgba within 1e-5 at 97% of the decided pixels and within 1e-4 at every
  one; depth (the ray parameter, ~29 here) within 4e-6 relative, and +inf
  at the same pixels. The JAX package's CPU backend contracts a·b + c into
  FMAs in the unprojection, the trilinear weights and the compositing, the
  port does not (so that the CUDA kernel, built with -fmad=false, equals
  its plain version), and the ~64 composited samples carry those roundings
  into the last digits. A pixel is "undecided" when its march came within
  rounding of a decision (`march_plain(undecided=...)`: a sample within
  1e-4·max|grid| of an iso value, alpha within 1e-5 of 0.995 or 0.5, t1 −
  t0 within 1e-5 of its scale): there one rounding may add or drop a
  whole iso layer or move the depth by a step. Undecided pixels are
  counted, not compared, and must stay under 2% of the frame.
- The JAX clip/depth scene (znear 0.1, zfar 200, eye 38 from the volume):
  the unprojection at NDC z = −1 and 0 sums terms of ~190 that cancel to
  ~1, so one rounding moves a ray's t by ~1e-5 relative; held to 2e-3 on
  rgba and 2e-4 relative on depth.
  Both packages take the same float32 LU inverse (`volume.inv44`); with
  numpy's, errors there grew 10×.
- Histograms: the JAX compare-CDF differences its cumulative sums, so each
  of its bins is off by up to a few ulps of the total: held to 8 ulps of
  the total. Segment sums and splats: 1e-6 relative to the largest value
  (the port sums in fixed point, the JAX package in float32). The blur:
  1e-6. The colour volume: rgb 1e-5 where the density passes 1e-4 of its
  largest value (elsewhere the Shepard ratio divides roundings), the
  density 1e-5 of its largest value.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.ops import density as PD
from viamd_tpu_torch.ops import histogram as PHI
from viamd_tpu_torch.render import colormap as PCM
from viamd_tpu_torch.render import cuda_volume as CV
from viamd_tpu_torch.render import volume as PV
from viamd_tpu_torch.render.camera import Camera, look_at, perspective

W = H = 48
D = 24


@pytest.fixture
def one_thread():
    """One intra-op thread: the march runs thousands of small ops, and
    several threads per op only contend on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _grid(n=D):
    """TestVolumeClipAndDepth's two-Gaussian field on n³ points."""
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    g = np.exp(-4 * ((X - 0.2) ** 2 + Y**2 + Z**2)) + 0.7 * np.exp(
        -6 * (X**2 + (Y + 0.4) ** 2 + (Z - 0.3) ** 2)
    )
    return g.astype(np.float32)


def _camera():
    """TestVolumeRender's camera (znear 0.1, zfar 10), a little off axis,
    on the unit cube about the origin."""
    cam = Camera(eye=np.array([0.4, 0.5, 3.0]), center=np.zeros(3),
                 up=np.array([0.0, 1, 0]), znear=0.1, zfar=10.0)
    return PV.model_matrix_from_extent(0.5), cam.view_matrix(), cam.proj_matrix(W, H)


def _scene_depth(view, proj):
    """A partial +inf depth map: a disc at view depth 2.9 (inside the
    volume), a band at 1.0 (in front of it), +inf elsewhere."""
    yy, xx = np.mgrid[0:H, 0:W]
    d = np.full((H, W), np.inf, np.float32)
    d[(yy - 24) ** 2 + (xx - 20) ** 2 < 100] = 2.9
    d[:, 40:44] = 1.0
    return d


def _renders(grid, tf, model, view, proj, kw, cvol=None, sd=None):
    """→ (port rgba, port depth, undecided, JAX rgba, JAX depth), numpy."""
    from viamd_tpu.render import volume as JV

    js = JV.VolumeRenderSettings(width=W, height=H, jitter=False, **kw)
    ji, jd = JV.render_volume(grid, tf, model, view, proj, js, color_volume=cvol,
                              scene_depth=sd)
    ps = PV.VolumeRenderSettings(width=W, height=H, jitter=False, **kw)
    pi, pd = PV.render_volume(grid, tf, model, view, proj, ps, color_volume=cvol,
                              scene_depth=sd, device="cpu")
    g = torch.as_tensor(grid)
    cv = None if cvol is None else torch.as_tensor(cvol)
    rays = PV.ray_setup(PV.ray_params(g.shape, model, view, proj, ps), None, sd, device="cpu")
    und = []
    qi, qd = CV.march_plain(g, torch.as_tensor(tf), cv, rays, W, H,
                            PV.march_params(g.shape, ps, cv is not None), undecided=und)
    assert torch.equal(qi, pi) and torch.equal(qd, pd)  # render_volume is the plain march
    return pi.numpy(), pd.numpy(), und[0].numpy(), np.asarray(ji), np.asarray(jd)


def _hold(got_i, got_d, und, want_i, want_d, rgba_tol=1e-4, depth_rtol=4e-6, strict=1e-5):
    assert got_i.shape == (H, W, 4) and got_d.shape == (H, W)
    assert np.isfinite(got_i).all()
    e = np.abs(got_i - want_i).max(-1)
    fin = np.isfinite(got_d) & np.isfinite(want_d)
    same_inf = np.isfinite(got_d) == np.isfinite(want_d)
    rel = np.zeros_like(got_d)
    np.divide(np.abs(got_d - want_d, where=fin, out=np.zeros_like(got_d)),
              np.abs(want_d), where=fin, out=rel)
    bad = (e > rgba_tol) | ~same_inf | (rel > depth_rtol)
    dec = ~und
    print(f"rgba max err {e.max():.3g} (decided {e[dec].max():.3g}), depth max rel err "
          f"{rel.max():.3g}, undecided {int(und.sum())}, off at decided {int((bad & dec).sum())}")
    assert not (bad & dec).any(), (e[bad & dec], rel[bad & dec])
    assert (e[dec] <= strict).mean() >= 0.97
    assert und.mean() <= 0.02
    assert want_i[..., 3].sum() > 1.0  # the volume is in view


_ISO2 = dict(enable_iso=True, iso_values=(0.3, 0.7),
             iso_colors=((1.0, 0.6, 0.2, 0.5), (0.2, 0.5, 0.9, 0.8)))
CASES = {
    "dvr": dict(),
    "iso_only": dict(enable_dvr=False, enable_iso=True, iso_values=(0.5,),
                     iso_colors=((0.2, 0.9, 0.2, 1.0),)),
    "dvr_2iso": _ISO2,
    "color_volume": dict(),
    "clip": dict(clip_min=(0.45, 0.0, 0.1), clip_max=(1.0, 0.9, 1.0)),
    "scene_depth": _ISO2,
    "background": dict(background=(0.1, 0.2, 0.3, 0.6), value_range=(0.1, 1.4),
                       light_dir=(0.2, -0.5, 0.8), ambient=0.3, specular=0.5,
                       shininess=16.0, **_ISO2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_volume_matches_jax(case, one_thread):
    grid = _grid()
    tf = PCM.transfer_function("viridis", alpha_scale=0.6)
    model, view, proj = _camera()
    cvol = sd = None
    if case == "color_volume":
        cvol = np.random.RandomState(1).rand(16, 12, 20, 3).astype(np.float32)
    if case == "scene_depth":
        sd = _scene_depth(view, proj)
    gi, gd, und, wi, wd = _renders(grid, tf, model, view, proj, CASES[case], cvol, sd)
    _hold(gi, gd, und, wi, wd)
    if case == "dvr":  # TestVolumeRender's golden properties
        assert gi[24, 24, 3] > 0.5 and np.isfinite(gd[24, 24])
        assert gi[0, 0, 3] < 1e-3 and np.isinf(gd[0, 0])
    if case == "scene_depth":  # the band in front of the volume hides it
        assert np.abs(gi[:, 40:44]).max() == 0 and np.isinf(gd[:, 40:44]).all()
        full, _ = PV.render_volume(grid, tf, model, view, proj,
                                   PV.VolumeRenderSettings(width=W, height=H, jitter=False, **_ISO2),
                                   device="cpu")
        assert gi[..., 3].sum() < full[..., 3].sum().item()
    if case == "background":
        empty = gi[..., 3] == 0
        assert empty.any() and np.allclose(gi[empty, :3], np.float32(0.6) * np.array([0.1, 0.2, 0.3]))


def test_render_volume_ill_conditioned_scene(one_thread):
    """TestVolumeClipAndDepth's scene, DVR + clip sub-box (see the module
    note on its conditioning)."""
    grid = _grid()
    tf = PCM.transfer_function("viridis", alpha_scale=0.6)
    tf[0, 3] = 0.0
    model = PV.model_matrix_from_extent(10.0)
    view = look_at(np.array([3.0, 5.0, 38.0]), np.zeros(3), np.array([0, 1, 0.0]))
    proj = perspective(np.radians(40), 1.0, 0.1, 200.0)
    kw = dict(clip_min=(0.45, 0.0, 0.1), clip_max=(1.0, 0.9, 1.0))
    gi, gd, und, wi, wd = _renders(grid, tf, model, view, proj, kw)
    _hold(gi, gd, und, wi, wd, rgba_tol=2e-3, depth_rtol=2e-4, strict=2e-3)


def test_jitter_is_seeded(one_thread):
    """Jitter comes from a torch.Generator seeded by `seed` (the JAX
    stream differs): the same seed gives the same frame, another seed
    another, and a caller's generator in the same state the same."""
    grid = _grid(16)
    tf = PCM.transfer_function("viridis", alpha_scale=0.6)
    model, view, proj = _camera()
    s = PV.VolumeRenderSettings(width=32, height=24, **_ISO2)

    def render(**kw):
        return PV.render_volume(grid, tf, model, view, proj, s, device="cpu", **kw)

    a, ad = render(seed=3)
    b, bd = render(seed=3)
    c, _ = render(seed=4)
    g, gd = render(generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.equal(ad, bd) and torch.equal(a, g) and torch.equal(ad, gd)
    assert not torch.equal(a, c)
    s0 = PV.VolumeRenderSettings(width=32, height=24, jitter=False, **_ISO2)
    flat, _ = PV.render_volume(grid, tf, model, view, proj, s0, device="cpu")
    assert not torch.equal(a, flat)
    # jitter moves samples within a step: the image stays close on average
    assert (a - flat).abs().mean() < 0.02


def test_ray_box_and_model_matrix():
    from viamd_tpu.render import volume as JV

    rng = np.random.RandomState(0)
    o = rng.uniform(-2, 3, (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d[:5, 0] = 0.0  # axis-parallel rays: the 1e-12 guard
    for lo, hi in ((0.0, 1.0), ((0.1, 0.0, 0.2), (0.9, 0.8, 1.0))):
        jt0, jt1 = JV.ray_box(o, d, np.asarray(lo, np.float32), np.asarray(hi, np.float32))
        pt0, pt1 = PV.ray_box(torch.as_tensor(o), torch.as_tensor(d), lo, hi)
        np.testing.assert_allclose(pt0.numpy(), np.asarray(jt0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pt1.numpy(), np.asarray(jt1), rtol=1e-6, atol=1e-6)
        assert ((pt1 > pt0).numpy() == (np.asarray(jt1) > np.asarray(jt0))).all()
    t0, t1 = PV.ray_box(torch.tensor([[0.5, 0.5, -1.0], [2.0, 2.0, -1.0]]),
                        torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]))
    assert t1[0] > t0[0] and t1[1] < t0[1]  # TestVolumeRender.test_ray_box
    for ext, c in ((0.5, None), (10.0, (1.0, -2.0, 3.0)), (np.array([1.0, 2.0, 3.0]), None)):
        np.testing.assert_array_equal(PV.model_matrix_from_extent(ext, c),
                                      JV.model_matrix_from_extent(ext, c))
    m = np.asarray(perspective(np.radians(40), 1.0, 0.1, 200.0) @ look_at(
        np.array([3.0, 5.0, 38.0]), np.zeros(3), np.array([0, 1, 0.0])), np.float32)
    import jax.numpy as jnp

    np.testing.assert_array_equal(PV.inv44(m), np.asarray(jnp.linalg.inv(jnp.asarray(m))))


def test_colormaps_and_transfer_functions():
    from viamd_tpu.render import colormap as JCM

    assert PCM.colormap_names() == JCM.colormap_names()
    for name in PCM.colormap_names():
        np.testing.assert_array_equal(PCM.colormap(name, 37), JCM.colormap(name, 37))
    for ramp in ("linear", "quadratic", "constant", "smooth"):
        np.testing.assert_array_equal(PCM.transfer_function("plasma", 64, 0.7, ramp),
                                      JCM.transfer_function("plasma", 64, 0.7, ramp))
    with pytest.raises(ValueError):
        PCM.transfer_function(alpha_ramp="cubic")


def test_histograms():
    from viamd_tpu.ops import histogram as JH

    rng = np.random.RandomState(2)
    v = rng.uniform(-0.5, 5.5, 5000).astype(np.float32)
    w = rng.uniform(0, 3, 5000).astype(np.float32)
    for vmin, vmax in ((0.0, 5.0), (1.0, 1.5)):
        want = np.asarray(JH.histogram_cdf(v, w, 40, vmin, vmax))
        got = PHI.histogram_cdf(torch.as_tensor(v), torch.as_tensor(w), 40, vmin, vmax).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * np.spacing(np.float32(want.sum())))
    ids = rng.randint(-3, 70, 3000).astype(np.int32)
    wi = rng.normal(size=3000).astype(np.float32)
    want = np.asarray(JH.histogram_bins(ids, wi, 64))
    got = PHI.histogram_bins(torch.as_tensor(ids), torch.as_tensor(wi), 64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    ids = rng.randint(0, 4096, 20000).astype(np.int32)
    want = np.asarray(JH.histogram_segment(ids, w.repeat(4), 4096))
    got = PHI.histogram_segment(torch.as_tensor(ids), torch.as_tensor(w.repeat(4)), 4096).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want.max())
    h = rng.uniform(0, 10, 100).astype(np.float32)
    for n in (7, 64, 200):
        want = np.asarray(JH.resample_histogram(h, n))
        got = PHI.resample_histogram(torch.as_tensor(h), n).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want.max())
        np.testing.assert_allclose(got.sum(), h.sum(), rtol=1e-5)  # conservative


def test_splat_nearest_and_blur():
    import jax.numpy as jnp

    from viamd_tpu.ops import density as JD

    rng = np.random.RandomState(3)
    pts = rng.uniform(-1.0, 11.0, (4000, 3)).astype(np.float32)
    wts = rng.uniform(0, 5, 4000).astype(np.float32)
    dims, origin, voxel = (12, 10, 8), np.zeros(3, np.float32), np.array([0.9, 1.0, 1.2], np.float32)
    want = np.asarray(JD.splat_nearest(jnp.asarray(pts), jnp.asarray(wts), dims,
                                       jnp.asarray(origin), jnp.asarray(voxel)))
    got = PD.splat_nearest(torch.as_tensor(pts), torch.as_tensor(wts), dims,
                           torch.as_tensor(origin), torch.as_tensor(voxel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want.max())
    assert got.sum() < wts.sum()  # points outside the grid add nothing
    for sigma, radius in ((1.0, 0), (0.7, 2), (0.0, 0)):
        want_b = np.asarray(JD.gaussian_blur_3d(jnp.asarray(want), sigma, radius))
        got_b = PD.gaussian_blur_3d(torch.as_tensor(want.copy()), sigma, radius).numpy()
        np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=1e-6 * want.max())


def test_splat_color_volume():
    """TestColorVolume.test_shepard_splat's clusters, against the JAX
    splat (tent matmuls) with and without the blur."""
    import jax.numpy as jnp

    from viamd_tpu.ops import density as JD

    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.normal(0.25, 0.04, (300, 3)), rng.normal(0.75, 0.04, (300, 3))])
    pts = pts.astype(np.float32)
    cols = np.concatenate([np.tile([1.0, 0, 0], (300, 1)), np.tile([0, 0, 1.0], (300, 1))])
    cols = cols.astype(np.float32)
    wts = rng.uniform(0.5, 3.0, 600).astype(np.float32)  # past the fixed-point sum's 2
    n = 32
    for blur in (1.0, 0.0):
        jr, jd = JD.splat_color_volume(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(wts),
                                       (n, n, n), jnp.zeros(3), jnp.full(3, 1.0 / n), blur_sigma=blur)
        pr, pd = PD.splat_color_volume(torch.as_tensor(pts), torch.as_tensor(cols),
                                       torch.as_tensor(wts), (n, n, n), torch.zeros(3),
                                       torch.full((3,), 1.0 / n), blur_sigma=blur)
        jr, jd, pr, pd = np.asarray(jr), np.asarray(jd), pr.numpy(), pd.numpy()
        np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-5 * jd.max())
        dense = jd > 1e-4 * jd.max()
        np.testing.assert_allclose(pr[dense], jr[dense], rtol=0, atol=1e-5)
        if blur:
            assert pr[8, 8, 8, 0] > 0.9 and pr[8, 8, 8, 2] < 0.05 and pr[24, 24, 24, 2] > 0.9


# -- the CUDA kernel (needs the card) ---------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["dvr_2iso", "color_volume", "clip_background", "iso_only",
                                  "scene_depth", "scene_depth_45x37"])
def test_kernel_matches_plain(cuda, case):
    """csrc/volume.cu against its plain version (ray_setup + march_plain)
    on the card, with the same jitter: the ray table it writes to
    `rays_out` equal to ray_setup's word for word, rgba within 1e-5
    (powf against torch.pow), depth equal, at every pixel outside the
    undecided ones; one launch per render_volume. The scene-depth cases
    clamp some rays' exit, the second at a frame of partial 8×4 tiles."""
    w, h = (45, 37) if case == "scene_depth_45x37" else (W, H)
    grid = torch.as_tensor(_grid(32 if w == W else 30), device=cuda)
    tf = torch.as_tensor(PCM.transfer_function("viridis", alpha_scale=0.6), device=cuda)
    model, view, proj = _camera()
    cvol = sd = None
    kw = dict(CASES["dvr_2iso"])
    if case.startswith("scene_depth"):
        proj = Camera(eye=np.array([0.4, 0.5, 3.0]), center=np.zeros(3), up=np.array([0.0, 1, 0]),
                      znear=0.1, zfar=10.0).proj_matrix(w, h)
        sd = torch.as_tensor(_scene_depth(view, proj)[:h, :w], device=cuda).contiguous()
    if case == "color_volume":
        cvol = torch.as_tensor(np.random.RandomState(1).rand(16, 12, 20, 3).astype(np.float32),
                               device=cuda)
    elif case == "clip_background":
        kw = dict(CASES["background"], clip_min=(0.1, 0.0, 0.2), clip_max=(0.9, 0.8, 1.0))
    elif case == "iso_only":
        kw = dict(CASES["iso_only"])
    s = PV.VolumeRenderSettings(width=w, height=h, **kw)
    params = PV.march_params(grid.shape, s, cvol is not None)
    rp = PV.ray_params(grid.shape, model, view, proj, s)
    jit = torch.rand(w * h, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    table = torch.full((len(CV.RAY_FIELDS), w * h), float("nan"), device=cuda)
    before = CV.launches
    img, dep = CV.render(grid, tf, cvol, rp, params, jit, sd, rays_out=table)
    torch.cuda.synchronize()
    assert CV.launches == before + 1
    rays = PV.ray_setup(rp, jit, sd, device=cuda)
    assert torch.equal(table.view(torch.int32), rays.view(torch.int32))
    if sd is not None:  # the scene depth clamps the exit of some rays
        t1 = CV.RAY_FIELDS.index("t1")
        assert bool((rays[t1] < PV.ray_setup(rp, jit, None, device=cuda)[t1]).any())
    und = []
    pimg, pdep = CV.march_plain(grid, tf, cvol, rays, w, h, params, undecided=und)
    dec = ~und[0]
    assert (img - pimg).abs().amax(-1)[dec].max().item() <= 1e-5
    assert torch.equal(torch.isinf(dep), torch.isinf(pdep))
    fin = torch.isfinite(dep) & dec
    assert torch.equal(dep[fin], pdep[fin])
    assert img[..., 3].sum().item() > 1.0
    out, _ = PV.render_volume(grid, tf, model, view, proj, s, seed=2, color_volume=cvol,
                              scene_depth=sd, device=cuda)
    assert CV.launches == before + 2 and torch.isfinite(out).all()


@pytest.mark.requires_cuda
def test_kernel_wrapper_checks_inputs(cuda):
    grid = torch.zeros((8, 8, 8), device=cuda)
    tf = torch.zeros((16, 4), device=cuda)
    eye = np.eye(4, dtype=np.float32)
    s = PV.VolumeRenderSettings(width=4, height=4, enable_iso=True, iso_values=(0.1,) * 9,
                                iso_colors=((1, 1, 1, 1),) * 9)
    rp = PV.ray_params(grid.shape, eye, eye, eye, s)
    params = PV.march_params(grid.shape, s, False)
    with pytest.raises(ValueError, match="at most"):
        CV.render(grid, tf, None, rp, params)
    s = PV.VolumeRenderSettings(width=4, height=4)
    params = PV.march_params(grid.shape, s, False)
    with pytest.raises(TypeError):
        CV.render(grid.double(), tf, None, rp, params)
    with pytest.raises(ValueError):
        CV.render(grid, tf, None, rp, params, jitter=torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):
        CV.render(grid, tf, None, rp, params, rays_out=torch.zeros((len(CV.RAY_FIELDS), 8),
                                                                    device=cuda))
    with pytest.raises(ValueError, match="nsteps"):
        CV.render(grid, tf, None, rp._replace(nsteps=3), params)
    with pytest.raises(ValueError):
        CV.render(grid, tf, None, rp, params, scene_depth=torch.zeros((4, 5), device=cuda))
    with pytest.raises(TypeError):
        CV.render(grid, tf, None, rp, params, jitter=torch.zeros(16, device=cuda,
                                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match="on cpu"):
        CV.render(grid, tf.cpu(), None, rp, params)  # no CUDA launch on a CPU tensor
    with pytest.raises(ValueError, match="colour volume"):
        CV.render(grid, tf, None, rp, PV.march_params(grid.shape, s, True))
    before = CV.launches
    img, dep = CV.render(grid, tf, None, rp, params)  # a zero transfer function: an empty frame
    torch.cuda.synchronize()
    assert CV.launches == before + 1
    assert torch.equal(img, torch.zeros_like(img)) and torch.isinf(dep).all()


@pytest.mark.requires_cuda
def test_volume_ops_are_run_to_run_exact(cuda):
    """Histograms, splats and the blur on CUDA: two runs equal bit for bit
    (fixed-point sums, no float atomics), and equal to the CPU where the
    arithmetic is the same (the integer sums)."""
    rng = np.random.RandomState(4)
    v = torch.as_tensor(rng.uniform(0, 5, 200_000).astype(np.float32), device=cuda)
    w = torch.as_tensor(rng.uniform(0, 3, 200_000).astype(np.float32), device=cuda)
    ids = torch.as_tensor(rng.randint(-1, 70_000, 200_000), device=cuda)
    pts = torch.as_tensor(rng.uniform(0, 1, (200_000, 3)).astype(np.float32), device=cuda)
    cols = torch.as_tensor(rng.rand(200_000, 3).astype(np.float32), device=cuda)
    dims, origin, voxel = (48, 48, 48), torch.zeros(3, device=cuda), torch.full((3,), 1 / 48, device=cuda)
    fns = [
        lambda: PHI.histogram_cdf(v, w, 128, 0.0, 5.0),
        lambda: PHI.histogram_bins(ids, w, 128),
        lambda: PHI.histogram_segment(ids, w, 70_000),
        lambda: PD.splat_nearest(pts, w, dims, origin, voxel),
        lambda: PD.gaussian_blur_3d(PD.splat_nearest(pts, w, dims, origin, voxel), 1.0),
        lambda: PD.splat_color_volume(pts, cols, w, dims, origin, voxel, blur_sigma=1.0)[0],
    ]
    for fn in fns:
        a, b = fn(), fn()
        assert torch.equal(a, b)
    cpu = PHI.histogram_segment(ids.cpu(), w.cpu(), 70_000)
    assert torch.equal(cpu, PHI.histogram_segment(ids, w, 70_000).cpu())
