"""csrc/hbao.cu (render/cuda_hbao.py) against the plain version of
render/hbao.py.

On the CPU: the pieces of the kernel's indexing that Python builds or
mirrors — the `__constant__` table image against `_jitter_tables()` and
`_phase_tables` at every pixel phase, the coarse-level fetch (texel
(y >> m, x >> m) of levels at their own sizes, filled with the kernel's
clamped 2×2 reads) against `_mip_stack`, and the wrapper's input checks.

On the card (`requires_cuda`; nothing of the JAX package is imported, so
these collect on a machine with a GPU and no JAX):
    python -m pytest --noconftest -m requires_cuda tests/test_torch_hbao_kernel.py

Tolerances.
- The mips: none. The kernel sums each 2×2 block in the order PyTorch's
  CUDA mean reduces it, (a00 + a10) + (a01 + a11), then scales by 1/4.
- The AO, against `hbao_plain` on the card: none outside the pixels a tie
  can move. The kernel's float32 operations are the plain version's, in
  its order, with PyTorch's own contraction of linalg.cross (an FMA) and
  its order of vector_norm and of the mean written out, and the same
  libdevice log2f, exp2f, rsqrtf and powf. Only round(mip_offset + bias)
  decides: a sample whose offset + bias lies within 1e-5 of k + 0.5
  (k = 0 … 3) could fetch the neighbouring level if log2f rounded apart,
  and with the blur that would move every pixel within 3 of it along x and
  y. Those pixels (`cuda_hbao.tie_pixels`, which chip_smoke's [hbao]
  phase holds the kernel to as well) are counted and printed, not
  compared, and must stay under 1% of the frame. Measured on an H100 (PyTorch 2.11.0+cu128): equal
  bit for bit at every pixel of every case, the 6,418 tie-reachable pixels
  of the 1080p water view included.
"""

import warnings

import numpy as np
import pytest
import torch

from viamd_tpu_torch.render import cuda_hbao as CH
from viamd_tpu_torch.render import hbao as PH


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _proj(width, height, ortho=False):
    from viamd_tpu_torch.render.camera import Camera, orthographic

    if ortho:
        return orthographic(-10, 10, -10 * height / width, 10 * height / width, 0.1, 50.0)
    c = Camera(eye=np.array([0, 0, 20.0]), center=np.zeros(3), up=np.array([0, 1, 0.0]))
    return c.proj_matrix(width, height)


def _depth(height, width, seed=0):
    """Steps, slopes and noise in 5–20, a band of +inf rows and an inf
    block: every clamp of the normals and the mips sees an edge."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:height, 0:width]
    d = 8.0 + 0.05 * x + 0.08 * y + rng.uniform(0, 1.5, (height, width))
    d[(x // 7 + y // 5) % 3 == 0] += 6.0
    d[: max(height // 8, 1)] = np.inf
    d[height // 2:, : width // 4] = np.inf
    return d.astype(np.float32)


# -- CPU: the kernel's indexing --------------------------------------------------------

PHASES = list(range(16))
MIP_SIZES = [(37, 53), (5, 3), (48, 64), (1, 1), (2, 9), (135, 240)]


def _fetch_mirror(d: torch.Tensor) -> torch.Tensor:
    """csrc/hbao.cu's reading of the pyramid in plain PyTorch: levels 1–4
    at their own sizes (`level_shapes`), each texel the 2×2 mean of rows 2i
    and min(2i + 1, h − 1) and columns likewise of the level below, packed
    into one flat scratch; pixel (y, x) of level m reads texel
    (y >> m, x >> m). → the (5, H, W) stack it sees."""
    H, W = d.shape
    shapes = CH.level_shapes(H, W)
    flat, cur = [], d
    for h, w in shapes:
        hp, wp = cur.shape
        ya = 2 * torch.arange(h)
        yb = torch.clamp(ya + 1, max=hp - 1)
        xa = 2 * torch.arange(w)
        xb = torch.clamp(xa + 1, max=wp - 1)
        cur = ((cur[ya][:, xa] + cur[yb][:, xa]) + (cur[ya][:, xb] + cur[yb][:, xb])) * 0.25
        flat.append(cur.reshape(-1))
    flat = torch.cat(flat)
    offs = np.cumsum([0] + [h * w for h, w in shapes])
    y = torch.arange(H)[:, None]
    x = torch.arange(W)[None, :]
    stack = [d]
    for m, (h, w) in enumerate(shapes, start=1):
        stack.append(flat[int(offs[m - 1]) + (y >> m) * w + (x >> m)])
    return torch.stack(stack)


def _bad_inputs():
    d = torch.zeros((6, 8))
    return {
        "depth_float64": (d.double(), None, TypeError),
        "depth_not_contiguous": (torch.zeros((8, 6)).t(), None, ValueError),
        "depth_3d": (d[None], None, ValueError),
        "depth_empty": (torch.zeros((0, 8)), None, ValueError),
        "depth_on_cpu": (d, None, ValueError),
        "normals_float64": (d, torch.zeros((6, 8, 3), dtype=torch.float64), TypeError),
        "normals_shape": (d, torch.zeros((6, 8, 4)), ValueError),
        "normals_not_contiguous": (d, torch.zeros((3, 6, 8)).permute(1, 2, 0), ValueError),
    }


@pytest.mark.parametrize("phase", PHASES)
def test_table_image(phase):
    """The flattened __constant__ image: c_samples[phase][i] = (dx, dy,
    weight, mip bias), then c_wsum[phase]."""
    ty, tx = divmod(phase, 4)
    img = CH.table_image()
    assert img.dtype == np.float32 and img.size == 16 * 16 * 4 + 16
    samples, wsum = img[: 16 * 16 * 4].reshape(16, 16, 4), img[16 * 16 * 4:]
    dirs, wgts, mips, wsum_t = PH._jitter_tables()
    for i in range(16):
        want = (dirs[i, ty, tx, 0], dirs[i, ty, tx, 1], wgts[i, ty, tx], mips[i, ty, tx])
        assert np.array_equal(samples[phase, i], np.array(want, np.float32))
    assert wsum[phase] == wsum_t[ty, tx]
    # and what `_phase_tables` gathers at every pixel of that phase
    per_sample, wsum_px = PH._phase_tables(9, 11, "cpu")
    for y in range(ty, 9, 4):
        for x in range(tx, 11, 4):
            assert float(wsum_px[y, x]) == float(wsum[phase])
            for i, (d_i, w_i, m_i) in enumerate(per_sample):
                got = (float(d_i[y, x, 0]), float(d_i[y, x, 1]), float(w_i[y, x]),
                       float(m_i[y, x]))
                assert got == tuple(float(v) for v in samples[phase, i])


@pytest.mark.parametrize("H,W", MIP_SIZES)
def test_mip_fetch(H, W):
    d = PH._finite_or(torch.as_tensor(_depth(H, W)), 1e8)
    levels = PH._mip_levels(d)
    assert [tuple(lv.shape) for lv in levels] == CH.level_shapes(H, W)
    stack = PH._mip_stack(d)
    mirror = _fetch_mirror(d)
    # the same texel at every pixel of every level (the 2×2 sums in the
    # kernel's order round as the CPU's mean may not: to 2 ulps)
    torch.testing.assert_close(mirror, stack, rtol=2.4e-7, atol=0)
    # the fetch itself is exact: the plain levels read at (y >> m, x >> m)
    y, x = torch.arange(H)[:, None], torch.arange(W)[None, :]
    for m, lv in enumerate(levels, start=1):
        assert torch.equal(lv[y >> m, x >> m], stack[m])


@pytest.mark.parametrize("depth,normals,err", list(_bad_inputs().values()),
                         ids=list(_bad_inputs()))
def test_wrapper_rejects(depth, normals, err):
    with pytest.raises(err):
        CH.check_inputs(depth, normals)
    launches = CH.launches
    with pytest.raises(err):  # raised before anything is built or launched
        CH.hbao(depth, normals, info=(1.0, 1.0, 0.0, 0.0), proj_scl=1.0, z_max=100.0,
                ortho=False, intensity=6.0, radius=6.0, bias=0.1, sharpness=1.0)
    assert CH.launches == launches


@pytest.mark.parametrize("intensity,mode", [(6.0, 5), (0.0, 0), (-1.0, 0), (1.0, 1), (2.0, 2),
                                            (3.0, 3), (0.5, 4), (4.5, 5)])
def test_pow_mode(intensity, mode):
    """torch.pow(t, e)'s dispatch on the card, which the kernel follows."""
    assert CH.pow_mode(intensity)[0] == mode


def test_cpu_depth_takes_the_plain_version():
    d = torch.as_tensor(_depth(37, 53))
    proj = _proj(53, 37)
    launches = CH.launches
    for kw in (dict(), dict(ortho=True, blur=False), dict(intensity=2.0, radius=3.0, bias=0.3)):
        p = _proj(53, 37, kw.get("ortho", False))
        assert torch.equal(PH.hbao(d, p, **kw), PH.hbao_plain(d, p, **kw))
    n = PH.view_normals(d, proj)
    assert torch.equal(PH.hbao(d, proj, normals=n), PH.hbao_plain(d, proj))
    assert CH.launches == launches


# -- the card ----------------------------------------------------------------------------


def _water_view(dev, width=1920, height=1080):
    """A 1080p view of a 20,000-water box (bench.py's camera): the render
    path's depth buffer, +inf around the box."""
    from viamd_tpu_torch import datagen
    from viamd_tpu_torch.render.raster import RasterSettings, render_molecules

    sys_, traj = datagen.water_box_device(20_000, n_frames=1, seed=7, device=dev)
    sc = datagen.render_inputs(sys_, width, height, device=dev)
    _, depth, _ = render_molecules(traj.device_frame(0)[0], sc["radii"], sc["colors"],
                                   sc["view"], sc["proj"],
                                   RasterSettings(width=width, height=height), device=dev)
    return depth.contiguous(), sc["proj"]


CARD_CASES = (
    [("water_1080p", False, True, False, {}),
     ("water_1080p", True, False, True, dict(intensity=2.0, radius=3.0, bias=0.3))]
    + [(size, ortho, blur, normals, {})
       for size in ("37x53", "5x3") for ortho in (False, True)
       for blur in (True, False) for normals in (False, True)]
    + [("37x53", False, True, False, dict(intensity=kw, radius=r, bias=b))
       for kw, r, b in ((4.5, 2.0, 0.0), (0.5, 9.0, 0.6), (1.0, 6.0, 0.1), (3.0, 1.0, 1.0))]
)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("size,ortho,blur,normals,kw", CARD_CASES)
def test_kernel_matches_plain(cuda, size, ortho, blur, normals, kw):
    if size == "water_1080p":
        depth, proj = _water_view(cuda)
        if ortho:
            proj = _proj(1920, 1080, ortho=True)
    else:
        H, W = (int(v) for v in size.split("x"))
        depth, proj = torch.as_tensor(_depth(H, W), device=cuda), _proj(W, H, ortho)
    assert bool(torch.isinf(depth).any())
    n = PH.view_normals(depth, proj, ortho) if normals else None
    before = CH.launches
    got = PH.hbao(depth, proj, ortho=ortho, blur=blur, normals=n, **kw)
    torch.cuda.synchronize()
    assert CH.launches == before + (4 if blur else 2)
    want = PH.hbao_plain(depth, proj, ortho=ortho, blur=blur, normals=n, **kw)
    tie = CH.tie_pixels(depth, proj, ortho=ortho, radius=kw.get("radius", 6.0), blur=blur)
    apart = got != want
    print(f"{size} ortho={ortho} blur={blur} normals={normals} {kw}: {int(apart.sum())} "
          f"pixels apart (max |diff| {float((got - want).abs().max()):.3g}), "
          f"{int((apart & tie).sum())} of them among {int(tie.sum())} tie-reachable")
    assert not bool((apart & ~tie).any())
    assert float(tie.float().mean()) < 0.01
    assert bool(((got >= 0) & (got <= 1)).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("size", ["1080x1920", "37x53", "5x3", "1x1", "2x9"])
def test_mips_equal_plain(cuda, size):
    H, W = (int(v) for v in size.split("x"))
    depth = torch.as_tensor(_depth(H, W), device=cuda)
    got = CH.mips(depth)
    want = torch.cat([lv.reshape(-1) for lv in PH._mip_levels(PH._finite_or(depth, 1e8))])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
def test_frame_waits_on_nothing(cuda):
    """No synchronizing call inside `hbao` on the card once its tables are
    loaded, and `postprocess.execute`'s AO stage is the kernel's launches."""
    from viamd_tpu_torch.render import postprocess as PP

    depth, proj = _water_view(cuda)
    PH.hbao(depth, proj)  # loads the tables
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            PH.hbao(depth, proj)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = [f"{w.filename}:{w.lineno} {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert not waits, waits
    rgba = torch.rand((*depth.shape, 4), device=cuda)
    before = CH.launches
    PP.execute(rgba, depth, PP.PostprocessSettings(), proj=proj)
    torch.cuda.synchronize()
    assert CH.launches == before + 4


@pytest.mark.requires_cuda
def test_wrapper_rejects_on_the_card(cuda):
    d = torch.as_tensor(_depth(6, 8), device=cuda)
    kw = dict(info=(1.0, 1.0, 0.0, 0.0), proj_scl=1.0, z_max=100.0, ortho=False,
              intensity=6.0, radius=6.0, bias=0.1, sharpness=1.0)
    with pytest.raises(TypeError):
        CH.hbao(d.double(), **kw)
    with pytest.raises(ValueError):
        CH.hbao(torch.as_tensor(_depth(8, 6), device=cuda).t(), **kw)
    with pytest.raises(ValueError, match="on cpu"):
        CH.hbao(d, torch.zeros((6, 8, 3)), **kw)
    with pytest.raises(ValueError):
        CH.hbao(d, torch.zeros((6, 8, 2), device=cuda), **kw)
    before = CH.launches
    out = CH.hbao(d, **kw)
    torch.cuda.synchronize()
    assert CH.launches == before + 4 and out.shape == (6, 8) and bool(torch.isfinite(out).all())
