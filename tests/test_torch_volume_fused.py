"""The volume frame as one kernel (csrc/volume.cu via
render/cuda_volume.py::render), on the CPU: the trilinear samplers the
kernel mirrors against the JAX package's at grid sizes that are odd and
degenerate, the parameter block that `render_volume` hands the kernel,
and `render_volume` as ray_setup + march_plain.

The samplers: within 2e-6 of viamd_tpu's on values in [0, 1) (the JAX
CPU backend may contract a·b + c into FMAs, the port does not). The
parameter block: the float32 inverses equal `inv44`'s, the view row, the
clip box, the frame size and step count as packed; the table ray_setup
builds from it is consistent (t0 ≥ 0, hit where t1 > t0, dt·nsteps
within rounding of t1 − t0, unit view directions, the jitter row). The
kernel itself is held to the plain version on the card by the tests
marked `requires_cuda` in tests/test_torch_volume.py.
"""

import numpy as np
import pytest
import torch
from test_torch_volume import CASES, H, W, _camera, _grid, _scene_depth

from viamd_tpu_torch.render import colormap as PCM
from viamd_tpu_torch.render import cuda_volume as CV
from viamd_tpu_torch.render import volume as PV
from viamd_tpu_torch.render.camera import look_at, perspective


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dims", [(24, 17, 30), (1, 1, 1), (3, 130, 2), (8, 8, 8), (5, 9, 7, 3)],
                         ids=["24x17x30", "1x1x1", "3x130x2", "8x8x8", "colour_5x9x7"])
def test_trilinear_sampler_matches_jax(dims):
    """The port's trilinear sample (the kernel's corner order, weights and
    row-major clamp-to-edge indexing) against viamd_tpu's at random points
    in and around the unit cube, so that every axis clamps at both ends."""
    from viamd_tpu.render import volume as JV

    rng = np.random.RandomState(sum(dims))
    vol = rng.rand(*dims).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, (4000, 3)).astype(np.float32)
    t = torch.as_tensor(pts)
    px, py, pz = t[:, 0], t[:, 1], t[:, 2]
    if len(dims) == 3:
        got = PV._sample_trilinear(torch.as_tensor(vol), px, py, pz).numpy()
        want = np.asarray(JV._sample_trilinear(vol, pts))
    else:
        got = torch.stack(PV._sample_trilinear_c(torch.as_tensor(vol), px, py, pz), 1).numpy()
        want = np.asarray(JV._sample_trilinear_c(vol, pts))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # corners: a point at each voxel centre samples that voxel exactly
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in dims[:3]], indexing="ij"), -1)
    idx = idx.reshape(-1, 3)
    c = torch.as_tensor(((idx + 0.5) / np.asarray(dims[:3])).astype(np.float32))
    args = (torch.as_tensor(vol), c[:, 0], c[:, 1], c[:, 2])
    at = (PV._sample_trilinear(*args) if len(dims) == 3
          else torch.stack(PV._sample_trilinear_c(*args), 1)).numpy()
    np.testing.assert_allclose(at, vol[idx[:, 0], idx[:, 1], idx[:, 2]], rtol=0, atol=1e-6)


def _ill_conditioned():
    """TestVolumeClipAndDepth's camera (znear 0.1, zfar 200, eye 38 from a
    volume of extent 10) with its clip sub-box."""
    model = PV.model_matrix_from_extent(10.0)
    view = look_at(np.array([3.0, 5.0, 38.0]), np.zeros(3), np.array([0, 1, 0.0]))
    proj = perspective(np.radians(40), 1.0, 0.1, 200.0)
    return model, view, proj, dict(clip_min=(0.45, 0.0, 0.1), clip_max=(1.0, 0.9, 1.0))


@pytest.mark.parametrize("case", [*CASES, "ill_conditioned"])
def test_ray_setup_from_parameter_block(case):
    """ray_params packs what the kernel reads — the float32 inverses of
    proj @ view and of the model (`inv44`), row 2 of the view matrix, the
    clip box, the frame size and the step count — and ray_setup on that
    block gives a consistent table with jitter (and the scene depth where
    the case has one)."""
    if case == "ill_conditioned":
        model, view, proj, kw = _ill_conditioned()
    else:
        (model, view, proj), kw = _camera(), CASES[case]
    sd = _scene_depth(view, proj) if case == "scene_depth" else None
    s = PV.VolumeRenderSettings(width=W, height=H, **kw)
    jit = torch.as_tensor(np.random.RandomState(7).rand(W * H).astype(np.float32))
    shape = (24, 24, 24)
    rp = PV.ray_params(shape, model, view, proj, s)
    f32 = np.float32
    assert (rp.width, rp.height, rp.nsteps) == (W, H, 48)
    np.testing.assert_array_equal(np.asarray(rp.inv_vp, f32).reshape(4, 4),
                                  PV.inv44(np.asarray(proj, f32) @ np.asarray(view, f32)))
    np.testing.assert_array_equal(np.asarray(rp.inv_model, f32).reshape(4, 4),
                                  PV.inv44(np.asarray(model, f32)))
    assert rp.view_z == tuple(float(v) for v in np.asarray(view, f32)[2])
    for got, want in ((rp.clip_min, s.clip_min), (rp.clip_max, s.clip_max)):
        assert got == tuple(float(v) for v in np.broadcast_to(np.asarray(want, f32), (3,)))
    table = PV.ray_setup(rp, jit, sd, device="cpu")
    assert table.shape == (len(CV.RAY_FIELDS), W * H) and table.dtype == torch.float32
    F = dict(zip(CV.RAY_FIELDS, table))
    hit = F["hit"] > 0
    assert torch.equal(hit, F["t1"] > F["t0"]) and bool(hit.any())
    assert bool((F["t0"] >= 0).all()) and torch.equal(F["jit"], jit)
    assert bool((F["dt"][~hit] == 0).all())
    span = (F["t1"] - F["t0"])[hit]
    assert torch.allclose(F["dt"][hit] * rp.nsteps, span, rtol=1e-6, atol=0)
    vlen = (F["vx"] ** 2 + F["vy"] ** 2 + F["vz"] ** 2).sqrt()
    assert torch.allclose(vlen, torch.ones_like(vlen), atol=1e-6)
    if sd is not None:  # the scene depth clamps the exit of some rays
        free = PV.ray_setup(rp, jit, None, device="cpu")
        assert bool((F["t1"] < free[CV.RAY_FIELDS.index("t1")]).any())


def test_render_volume_is_the_plain_version(one_thread):
    """render_volume on the CPU is ray_setup + march_plain on the same
    parameter block and jitter draw, exactly, with scene depth and a
    colour volume; `render`'s rays_out receives ray_setup's table."""
    grid = _grid(16)
    tf = PCM.transfer_function("viridis", alpha_scale=0.6)
    model, view, proj = _camera()
    sd = _scene_depth(view, proj)
    cvol = np.random.RandomState(1).rand(8, 6, 10, 3).astype(np.float32)
    s = PV.VolumeRenderSettings(width=W, height=H, **CASES["dvr_2iso"])
    img, dep = PV.render_volume(grid, tf, model, view, proj, s, seed=4, color_volume=cvol,
                                scene_depth=sd, device="cpu")
    g, t, cv = torch.as_tensor(grid), torch.as_tensor(tf), torch.as_tensor(cvol)
    rp = PV.ray_params(g.shape, model, view, proj, s)
    mp = PV.march_params(g.shape, s, True)
    jit = torch.rand(W * H, generator=torch.Generator().manual_seed(4))
    rays = PV.ray_setup(rp, jit, sd, device="cpu")
    want_i, want_d = CV.march_plain(g, t, cv, rays, W, H, mp)
    assert torch.equal(img, want_i) and torch.equal(dep, want_d)
    table = torch.empty_like(rays)
    got_i, got_d = CV.render(g, t, cv, rp, mp, jit, torch.as_tensor(sd), rays_out=table)
    assert torch.equal(got_i, img) and torch.equal(got_d, dep)
    assert torch.equal(table.view(torch.int32), rays.view(torch.int32))
    assert np.isfinite(img.numpy()).all() and float(img[..., 3].sum()) > 1.0
