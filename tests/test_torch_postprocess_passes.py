"""The rest of the port's postprocess chain against viamd_tpu on seeded
numpy frames: bokeh depth of field (render/bokeh.py), motion blur,
`velocity_image`, `velocity_dilate`, sharpen, the cheap `fxaa` and
`depth_of_field`, static accumulation (render/postprocess.py), the
velocity-reprojected TAA (render/taa.py), `execute` with every pass on, and
the TAA history carried across (interop.py). The oracles are
TestPostprocess, TestHighFidelityPasses and TestTAA (tests/test_render.py).

Tolerances.
- Passes without a sin hash (motion blur, sharpen, the cheap FXAA and DOF,
  clip_aabb, the TAA resolve without its motion half, accumulation): 1e-5
  absolute (float32; the JAX package's CPU backend contracts a·b + c into
  FMAs, the port does not). Index picks (velocity_dilate,
  closest_fragment_velocity, velocity_image) are exact.
- The sin hash fract(sin(x·12.9898 + y·78.233)·43758.5453) is a per-pixel
  pseudo-random number that turns one rounding of its argument into
  another random value. The port rounds the argument in plain float32 and
  takes a correctly rounded sine (the same on the CPU and the card); the
  JAX package's jitted passes fuse the multiply into the add and turn the
  division by the height into a multiplication, so their phases differ
  from the port's at many pixels. So: the hash itself against the JAX
  hash evaluated op by op, 1e-5 at 97% of pixels (XLA's float32 sine is
  off the correctly rounded one at ~1% of them); bokeh with both packages
  given the same hash and no dither, 1e-5 at every pixel; the passes as
  they are (bokeh, the TAA's motion half, `execute` with the DOF) by what
  a random phase leaves unchanged: their mean |difference| from the JAX
  output under half the JAX output's own change when its phase
  moves (time + 1e-3), and image means within 5e-4.
- `execute` with every pass but the DOF (no hash): 1e-5 at every pixel
  with FXAA off; with FXAA on at 95% of pixels, since FXAA's span test
  ties exactly at local luma extrema (tests/test_torch_postprocess.py).
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch import interop
from viamd_tpu_torch.render import bokeh as PB
from viamd_tpu_torch.render import postprocess as PP
from viamd_tpu_torch.render import taa as PT

H, W = 48, 64


def _frame(seed=0, h=H, w=W):
    """A smooth-ish rgb frame with edges, and a depth buffer with a near
    box, a far plane and +inf background rows."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    rgb = np.stack([0.5 + 0.4 * np.sin(6 * xx + seed), 0.5 + 0.4 * np.cos(5 * yy),
                    0.3 + 0.2 * xx * yy], -1)
    rgb = rgb + 0.05 * rng.rand(h, w, 3)
    rgb[h // 3 : h // 2, w // 4 : w // 2] = (1.0, 0.9, 0.2)
    depth = np.full((h, w), 14.0) + 2.0 * xx
    depth[h // 4 : 3 * h // 4, w // 3 : 2 * w // 3] = 6.0 + rng.rand()
    depth[:4] = np.inf
    return rgb.astype(np.float32), depth.astype(np.float32)


def _velocity(seed=0, h=H, w=W, scale=6.0):
    rng = np.random.RandomState(seed)
    v = np.zeros((h, w, 2), np.float32)
    v[10:30, 20:40] = rng.normal(0, scale, 2)
    v[30:40, 5:15] = rng.normal(0, scale, (10, 10, 2))
    return v


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _mostly(got, want, share=0.97, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    e = np.abs(got - np.asarray(want))
    e = e.max(-1) if e.ndim == 3 else e
    assert (e <= atol).mean() >= share, (e <= atol).mean()


def _like_another_phase(got, want, other):
    """got differs from want by less than half of what moving the
    JAX hash's phase changes (other: the JAX output at time + 1e-3)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want, other = np.asarray(want), np.asarray(other)
    err, phase = np.abs(got - want).mean(), np.abs(other - want).mean()
    print(f"mean |port - JAX| {err:.3g}, mean |JAX - JAX(phase + 1e-3)| {phase:.3g}")
    assert err < 0.5 * phase
    assert abs(got.mean() - want.mean()) < 5e-4


def test_glsl_hash():
    """The hash against the JAX one evaluated op by op."""
    from viamd_tpu.render import bokeh as JB

    u = np.broadcast_to((np.arange(128, dtype=np.float32)[None, :] + 0.5) / 128, (96, 128))
    v = np.broadcast_to((np.arange(96, dtype=np.float32)[:, None] + 0.5) / 96, (96, 128))
    for t in (0.0, 0.375):
        want = np.asarray(JB._glsl_rand(u + np.float32(t), v + np.float32(t)))
        got = PB._glsl_rand(torch.as_tensor(u + np.float32(t)), torch.as_tensor(v + np.float32(t)))
        _mostly(got, want)
    assert PB._radius_schedule() == JB._radius_schedule() and len(PB._radius_schedule()) == 73
    assert PB._radius_schedule(5.0) == JB._radius_schedule(5.0)


@pytest.mark.parametrize("focus", [(10.0, 10.0), (6.5, 4.0)])
def test_bokeh_same_hash(focus, monkeypatch):
    """Both packages given the same phase table, no dither: every pixel."""
    import jax
    import jax.numpy as jnp

    from viamd_tpu.render import bokeh as JB

    rgb, depth = _frame(1)
    u = torch.arange(W, dtype=torch.float32)[None, :].add(0.5).div(W).expand(H, W)
    v = torch.arange(H, dtype=torch.float32)[:, None].add(0.5).div(H).expand(H, W)
    table = PB._glsl_rand(u, v)
    monkeypatch.setattr(PB, "_glsl_rand", lambda x, y: table)
    monkeypatch.setattr(JB, "_glsl_rand", lambda x, y: jnp.asarray(table.numpy()))
    jax.clear_caches()
    try:
        kw = dict(focus_depth=focus[0], focus_scale=focus[1], dither=False, max_blur=5.0)
        want = JB.bokeh_dof(rgb, depth, **kw)
        got = PB.bokeh_dof(torch.as_tensor(rgb), torch.as_tensor(depth), **kw)
    finally:
        jax.clear_caches()
    _close(got, want)
    assert not np.allclose(got.numpy(), rgb, atol=1e-3)  # it blurs


def test_bokeh_as_is():
    from viamd_tpu.render import bokeh as JB

    rgb, depth = _frame(2)
    rgba = np.concatenate([rgb, np.ones((H, W, 1), np.float32) * 0.5], -1)
    for kw in (dict(time=0.25), dict(dither=False)):
        want = JB.bokeh_dof(rgba, depth, max_blur=6.0, **kw)
        other = JB.bokeh_dof(rgba, depth, max_blur=6.0, **dict(kw, time=kw.get("time", 0.0) + 1e-3))
        got = PB.bokeh_dof(torch.as_tensor(rgba), torch.as_tensor(depth), max_blur=6.0, **kw)
        assert got.shape == (H, W, 4) and torch.equal(got[..., 3], torch.as_tensor(rgba[..., 3]))
        _like_another_phase(got[..., :3], np.asarray(want)[..., :3], np.asarray(other)[..., :3])
    # the in-focus early exit passes the input through
    d = np.full((H, W), 10.0, np.float32)
    out = PB.bokeh_dof(torch.as_tensor(rgb), torch.as_tensor(d), dither=False)
    assert torch.equal(out, torch.as_tensor(rgb))


def test_motion_blur_and_velocity():
    import jax.numpy as jnp

    from viamd_tpu.render import postprocess as JP

    # TestPostprocess's moving line, then a frame with mixed velocities
    line = np.zeros((40, 40, 3), np.float32)
    line[:, 20, :] = 1.0
    vel = np.zeros((40, 40, 2), np.float32)
    vel[..., 0] = 12.0
    got = PP.motion_blur(torch.as_tensor(line), torch.as_tensor(vel))
    _close(got, JP.motion_blur(jnp.asarray(line), jnp.asarray(vel)))
    assert got[20, 20, 0] < 1.0 and got[20, 24, 0] > 0.02 and got[24, 20, 0] > got[2, 2, 0]
    still = PP.motion_blur(torch.as_tensor(line), torch.zeros((40, 40, 2)))
    _close(still, line)
    rgb, _ = _frame(3)
    v = _velocity(3)
    for kw in (dict(), dict(scale=0.5, n_taps=5, tile=8)):
        _close(PP.motion_blur(torch.as_tensor(rgb), torch.as_tensor(v), **kw),
               JP.motion_blur(jnp.asarray(rgb), jnp.asarray(v), **kw))
    for tile in (20, 8, 7):
        want = np.asarray(JP.velocity_dilate(jnp.asarray(v), tile=tile))
        np.testing.assert_array_equal(PP.velocity_dilate(torch.as_tensor(v), tile=tile).numpy(), want)
    rng = np.random.RandomState(4)
    pick = rng.randint(-1, 30, (H, W)).astype(np.int32)
    cur, prev = rng.normal(size=(30, 2)).astype(np.float32), rng.normal(size=(30, 2)).astype(np.float32)
    np.testing.assert_array_equal(PP.velocity_image(pick, cur, prev).numpy(),
                                  JP.velocity_image(pick, cur, prev))


def test_sharpen_cheap_fxaa_dof_accumulate():
    import jax.numpy as jnp

    from viamd_tpu.render import postprocess as JP

    rgb, depth = _frame(5)
    t = torch.as_tensor(rgb)
    _close(PP.sharpen(t), JP.sharpen(jnp.asarray(rgb)))
    _close(PP.sharpen(t, 0.8), JP.sharpen(jnp.asarray(rgb), 0.8))
    _close(PP.fxaa(t), JP.fxaa(jnp.asarray(rgb)))
    edge = np.zeros((16, 16, 3), np.float32)
    edge[:, 8:] = 1.0
    out = PP.fxaa(torch.as_tensor(edge))
    assert 0.05 < out[8, 8, 0] < 0.95 or 0.05 < out[8, 7, 0] < 0.95
    for kw in (dict(focus_depth=10.0), dict(focus_depth=6.0, focus_scale=0.2, max_radius=3)):
        _close(PP.depth_of_field(t, torch.as_tensor(depth), **kw),
               JP.depth_of_field(jnp.asarray(rgb), jnp.asarray(depth), **kw))
    # static accumulation: the same converging average
    rng = np.random.RandomState(6)
    js, ps = JP.TAAState(), PP.TAAState()
    for _ in range(6):
        noisy = (rgb + rng.normal(scale=0.1, size=rgb.shape)).astype(np.float32)
        want = JP.taa_accumulate(js, noisy, alpha=0.2)
        got = PP.taa_accumulate(ps, torch.as_tensor(noisy), alpha=0.2)
        _close(got, want)
    assert ps.count == js.count == 6


def test_taa_parts():
    import jax.numpy as jnp

    from viamd_tpu.render import taa as JT

    rng = np.random.RandomState(7)
    cmin = rng.rand(H, W, 3).astype(np.float32)
    cmax = cmin + rng.rand(H, W, 3).astype(np.float32)
    p = (cmin + cmax) / 2
    q = rng.uniform(-1, 3, (H, W, 3)).astype(np.float32)
    _close(PT.clip_aabb(*(torch.as_tensor(a) for a in (cmin, cmax, p, q))),
           JT.clip_aabb(cmin, cmax, p, q), atol=1e-6)
    _, depth = _frame(7)
    depth[20, 30] = 2.0
    v = _velocity(7)
    v[20, 30] = (7.0, -3.0)
    got_v, got_d = PT.closest_fragment_velocity(torch.as_tensor(depth), torch.as_tensor(v))
    want_v, want_d = JT.closest_fragment_velocity(jnp.asarray(depth), jnp.asarray(v))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert (got_v[19:22, 29:32] == torch.tensor([7.0, -3.0])).all()
    rgb, _ = _frame(8)
    for yy, xx in ((np.full((H, W), 3.25, np.float32), np.full((H, W), W - 1.0, np.float32)),
                   (rng.uniform(-3, H + 3, (H, W)).astype(np.float32),
                    rng.uniform(-3, W + 3, (H, W)).astype(np.float32))):
        _close(PT._sample_bilinear(torch.as_tensor(rgb), torch.as_tensor(yy), torch.as_tensor(xx)),
               JT._sample_bilinear(jnp.asarray(rgb), jnp.asarray(yy), jnp.asarray(xx)))


@pytest.mark.parametrize("motion", [False, True])
def test_taa_resolve(motion):
    from viamd_tpu.render import taa as JT

    rgb, depth = _frame(9)
    hist, _ = _frame(10)
    v = _velocity(9)
    kw = dict(jitter_px=(0.3, -0.2), motion_blur=motion, motion_scale=1.5, time_seed=0.25)
    jb, js = JT.taa_resolve(rgb, hist, v, depth, **kw)
    pb, ps = PT.taa_resolve(torch.as_tensor(rgb), torch.as_tensor(hist), torch.as_tensor(v),
                            torch.as_tensor(depth), **kw)
    _close(pb, jb)
    if motion:
        _, other = JT.taa_resolve(rgb, hist, v, depth, **dict(kw, time_seed=0.25 + 1e-3))
        _like_another_phase(ps, js, other)
        assert not torch.equal(ps, pb)
    else:
        assert torch.equal(ps, pb)


def test_taa_reprojector_and_interop():
    """TestTAA's moving square through both reprojectors; after 4 frames
    the JAX history is carried into a port reprojector, which goes on in
    step with the JAX one."""
    from viamd_tpu.render import postprocess as JP
    from viamd_tpu.render import taa as JT

    seq = []
    for k in range(8):
        rgb = np.zeros((48, 48, 3), np.float32)
        vel = np.zeros((48, 48, 2), np.float32)
        depth = np.full((48, 48), np.inf, np.float32)
        x0 = 6 + k * 3
        rgb[19:29, x0 : x0 + 10] = 1.0
        vel[19:29, x0 : x0 + 10, 0] = 3.0
        depth[19:29, x0 : x0 + 10] = 5.0
        seq.append((rgb, vel, depth))
    jr, pr = JT.TAAReprojector(), PT.TAAReprojector()
    acc = JP.TAAState()
    for k, (rgb, vel, depth) in enumerate(seq):
        jit = (0.25 * (k % 2), -0.125 * (k % 3))
        want = jr.step(rgb, vel, depth, jitter_px=jit)
        got = pr.step(torch.as_tensor(rgb), torch.as_tensor(vel), torch.as_tensor(depth), jitter_px=jit)
        _close(got, want)
        acc_out = JP.taa_accumulate(acc, rgb, alpha=0.1)
        if k == 3:
            carried = interop.taa_state_from_numpy(jr.history, jr.frame, "cpu")
            carried_acc = PP.TAAState(torch.as_tensor(np.asarray(acc.history)), acc.count)
        elif k > 3:
            _close(carried.step(torch.as_tensor(rgb), torch.as_tensor(vel), torch.as_tensor(depth),
                                jitter_px=jit), want)
            _close(PP.taa_accumulate(carried_acc, torch.as_tensor(rgb), alpha=0.1), acc_out)
    assert pr.frame == jr.frame == 8 and carried.frame == 8
    band = np.s_[19:29, 6:25]
    assert float(np.abs(got.numpy()[band] - seq[-1][0][band]).mean()) < 0.25 * float(
        np.abs(np.asarray(acc_out)[band] - seq[-1][0][band]).mean())


@pytest.mark.parametrize("dof", [False, True])
def test_execute_every_pass(dof):
    """AO (HBAO), motion blur, bokeh DOF, ACES, compose, FXAA, sharpen."""
    from viamd_tpu.render import camera as JC
    from viamd_tpu.render import postprocess as JP

    rgb, depth = _frame(11)
    rgba = np.concatenate([rgb, (np.random.RandomState(11).rand(H, W, 1) > 0.2).astype(np.float32)], -1)
    v = _velocity(11)
    cam = JC.Camera(eye=np.array([0, 0, 20.0]), center=np.zeros(3), up=np.array([0, 1, 0.0]))
    proj = np.asarray(cam.proj_matrix(W, H))
    kw = dict(enable_dof=dof, dof_max_blur=5.0, focus_depth=8.0, enable_motion_blur=True,
              motion_blur_scale=0.8, enable_sharpen=True)
    for fxaa in (False, True):
        s = dict(kw, enable_fxaa=fxaa)
        want = np.asarray(JP.execute(rgba, depth, JP.PostprocessSettings(**s), velocity=v, proj=proj))
        got = PP.execute(torch.as_tensor(rgba), torch.as_tensor(depth), PP.PostprocessSettings(**s),
                         velocity=torch.as_tensor(v), proj=proj)
        assert got.shape == (H, W, 3) and torch.isfinite(got).all()
        assert (got >= 0).all() and (got <= 1).all()
        if not dof:
            _mostly(got, want, share=0.95 if fxaa else 1.0)
        elif not fxaa:
            # the DOF's phase moved as the JAX bokeh's `time` moves it
            rgb_jax = JP.execute(rgba, depth, JP.PostprocessSettings(**dict(s, enable_dof=False)),
                                 velocity=v, proj=proj)
            assert np.abs(np.asarray(rgb_jax) - want).mean() > 1e-3  # the DOF acts
            d = np.abs(got.numpy() - want)
            print(f"execute with DOF: mean |port - JAX| {d.mean():.3g}, max {d.max():.3g}")
            assert d.mean() < 5e-3 and abs(got.numpy().mean() - want.mean()) < 5e-4
    base = PP.execute(torch.as_tensor(rgba), torch.as_tensor(depth), PP.PostprocessSettings(),
                      proj=proj)
    assert not torch.allclose(base, got, atol=1e-3)  # the passes change the frame
