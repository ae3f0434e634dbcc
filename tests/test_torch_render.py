"""The molecule raster of the port (render/raster.py, render/cuda_raster.py)
against viamd_tpu (its Pallas kernel in interpret mode and its XLA engine,
on scenes where their capacities cannot bind) and against a brute-force
ray cast over every primitive (no binning, no capacity on either side).

The JAX package is imported inside the tests that use it, so the tests
marked `requires_cuda` collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_render.py

Tolerances.
- Brute force: the numpy float32 ray cast below repeats the plain version's
  arithmetic operation for operation over ALL primitives in id order, so
  pick, alpha and depth must be identical at every pixel: any pixel a tile
  list missed would show.
- Against the JAX package: its CPU backend contracts a·b + c into FMAs (the
  port does not, so that the CUDA kernel, built with -fmad=false, equals
  its plain version), and the ray tests cancel (dc² − |d|²(|c|² − r²)), so
  t keeps only ~2⁻²⁴/√(disc/dc²) of relative precision and, at a
  silhouette, one rounding decides hit or miss. Pixels whose float64
  geometry lies within rounding of a decision (|disc| ≤ 1e-6 of its
  scale, a capsule hit within 1e-5 of an axial end, or two atoms' hits
  within 1e-5 in t) are "undecided" and must stay under 1% of the frame.
  On every other pixel picks and alpha are equal. Depth: within 5e-4
  relative, and 99% of hits within 5e-5 (thin capsules and small spheres
  seen from afar have disc/dc² ~ 1e-5, so ~3e-5 is what one rounding
  leaves). rgb, per scene (PALLAS_RGB, XLA_RGB): a largest error and a
  largest share of pixels above 1e-4 (Pallas: the same 8-bit colour
  packing) or above 6e-3 (XLA: float colours; the JAX tests' own bound),
  each set just above this file's own readings, which the tests print
  (`pytest -s`) and PERF.md records. The errors are not zero because the
  normal follows t and the specular slope 0.35·48·(n·h)^47 ≈ 17 amplifies
  its rounding at a highlight on an ill-conditioned hit.
  test_limits_catch_shading_faults shows that shading faults fail them.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from viamd_tpu_torch.datagen import render_inputs, water_box
from viamd_tpu_torch.render import cuda_raster
from viamd_tpu_torch.render import raster as raster_mod
from viamd_tpu_torch.render.raster import (
    RasterSettings,
    _tile_boxes,
    bin_primitives,
    build_scene,
    render_molecules,
    render_scene,
)

TILE = 16
F32 = np.float32


@pytest.fixture
def one_thread():
    """One intra-op thread for tests that run thousands of ops on small
    tensors: several threads per op only contend when other processes share
    the cores (a 128×96 plain ray cast takes ~10× longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# -- scenes (numpy, seeded) ---------------------------------------------------


def _camera(eye, W, H, jitter=(0.0, 0.0)):
    from viamd_tpu_torch.render.camera import Camera

    cam = Camera(eye=np.asarray(eye, np.float64), center=np.zeros(3),
                 up=np.array([0.0, 1.0, 0.0]))
    return cam.view_matrix(), cam.proj_matrix(W, H, jitter)


def _spheres250(jitter=False):
    """test_pallas_engine_matches_xla's scene (view space, identity view)."""
    rng = np.random.RandomState(7)
    n = 250
    cen = rng.uniform(-10, 10, (n, 3)).astype(F32)
    cen[:, 2] -= 25
    rad = rng.uniform(0.5, 2.0, n).astype(F32)
    col = rng.rand(n, 4).astype(F32)
    proj = np.eye(4, dtype=F32)
    proj[0, 0] = 1.2
    proj[1, 1] = 1.6
    if jitter:
        proj[0, 2], proj[1, 2] = 0.3 * 2 / 176, -0.4 * 2 / 128
    return dict(positions=cen, radii=rad, colors=col, bonds=None,
                view=np.eye(4, dtype=F32), proj=proj, W=176, H=128,
                rep="spacefill")


def _licorice40(size=192):
    """test_pallas_capsules_match_xla's scene, at 192×192 by default: at its
    own 96×96 a home tile holds 17 capsule samples against the Pallas
    path's automatic capacity of 16."""
    rng = np.random.RandomState(3)
    n = 40
    pos = rng.uniform(-4, 4, (n, 3)).astype(F32)
    view, proj = _camera([0.0, 0, 10.0], size, size)
    return dict(positions=pos, radii=np.full(n, 0.6, F32),
                colors=rng.rand(n, 4).astype(F32),
                bonds=np.array([[i, i + 1] for i in range(0, n - 1, 2)], np.int32),
                view=view, proj=proj, W=size, H=size, rep="licorice")


def _water(rep, eye_dir=(0.0, 0.0, 1.6)):
    """tests/_torch_parity.py::water_render_inputs(200, 5, 128, 96), built
    here from the port's datagen, so the tests on the card need no JAX."""
    sys, traj = water_box(200, n_frames=1, seed=5)
    d = dict(render_inputs(sys, 128, 96, eye_dir), positions=traj.load_frames([0])[0][0])
    return dict(d, W=128, H=96, rep=rep,
                bonds=None if rep == "spacefill" else d["bonds"])


# -- running both packages ------------------------------------------------------


def _port(sc, device="cpu", **kw):
    s = RasterSettings(width=sc["W"], height=sc["H"], rep=sc["rep"], **kw)
    out = render_molecules(sc["positions"], sc["radii"], sc["colors"],
                           sc["view"], sc["proj"], s, sc["bonds"], device=device)
    assert out[0].dtype == torch.float32 and out[2].dtype == torch.int32
    return tuple(t.cpu().numpy() for t in out)


def _jax(sc, **kw):
    from viamd_tpu.render import raster as R

    s = R.RasterSettings(width=sc["W"], height=sc["H"], rep=sc["rep"], **kw)
    out = R.render_molecules(sc["positions"], sc["radii"], sc["colors"],
                             sc["view"], sc["proj"], s, bonds=sc["bonds"])
    return tuple(np.asarray(v) for v in out)


def _view_space(sc):
    """(sph (n, 4), cyl (m, 8)) float32 numpy: the port's view-space
    primitives of a scene (render/raster.py::build_scene)."""
    s = RasterSettings(width=sc["W"], height=sc["H"], rep=sc["rep"])
    scene = build_scene(sc["positions"], sc["radii"], sc["colors"], sc["view"],
                        sc["proj"], s, sc["bonds"], device="cpu")
    return scene.sph.numpy(), scene.cyl.numpy(), scene.cyl_ci[:, 1].numpy()


def _rays(proj, W, H, dtype):
    """Per-pixel ray slopes (dx, dy), (H, W), as the kernel computes them."""
    p = np.asarray(proj, F32)
    px = np.arange(W, dtype=F32)
    py = np.arange(H, dtype=F32)
    dx = ((px + F32(0.5)) * F32(2.0 / W) - F32(1.0) + p[0, 2]) * (F32(1.0) / p[0, 0])
    dy = ((py + F32(0.5)) * F32(2.0 / H) - F32(1.0) + p[1, 2]) * (F32(1.0) / p[1, 1])
    dx, dy = np.meshgrid(dx, dy)
    return dx.astype(dtype), dy.astype(dtype)


def _brute_f32(sph, cyl, owner, proj, W, H):
    """Nearest hit over ALL primitives, float32, the plain version's
    arithmetic and order (spheres, then half-capsules, each in id order;
    spheres drawn only with the centre in front, view depth > 1e-6, JAX's
    rule) → (pick, depth)."""
    dx, dy = _rays(proj, W, H, F32)
    dd = dx * dx + dy * dy + F32(1.0)
    inv_dd = F32(1.0) / dd
    bt = np.full((H, W), F32(1e30))
    bid = np.full((H, W), -1, np.int32)
    for i, (cx, cy, cz, r) in enumerate(sph):
        if not -cz > F32(1e-6):
            continue
        cc = cx * cx + cy * cy + cz * cz - r * r
        dc = dx * cx + dy * cy - cz
        disc = dc * dc - dd * cc
        t = (dc - np.sqrt(np.maximum(disc, F32(0.0)))) * inv_dd
        ok = (disc > 0) & (t > F32(1e-6)) & (t < bt)
        bt = np.where(ok, t, bt)
        bid = np.where(ok, i, bid)
    for k, (qx, qy, qz, ax, ay, az, ln, rr) in enumerate(cyl):
        pa = qx * ax + qy * ay + qz * az
        cc2 = qx * qx + qy * qy + qz * qz - pa * pa - rr * rr
        da = dx * ax + dy * ay - az
        dp = dx * qx + dy * qy - qz
        A = np.maximum(dd - da * da, F32(1e-9))
        Bq = dp - da * pa
        disc = Bq * Bq - A * cc2
        t = (Bq - np.sqrt(np.maximum(disc, F32(0.0)))) / A
        sax = t * da - pa
        ok = (disc > 0) & (t > F32(1e-6)) & (t < bt) & (sax >= 0) & (sax <= ln)
        bt = np.where(ok, t, bt)
        bid = np.where(ok, owner[k], bid)
    return bid, np.where(bid >= 0, bt, F32(np.inf))


def _unambiguous(sph, cyl, owner, proj, W, H):
    """(H, W) bool: the decided pixels, whose float64 nearest hit is not
    within rounding of a decision (see the module docstring)."""
    dx, dy = _rays(proj, W, H, np.float64)
    dd = dx * dx + dy * dy + 1.0
    best = np.full((H, W), np.inf)
    best_id = np.full((H, W), -1)
    second = np.full((H, W), np.inf)  # nearest hit of another atom
    graze = np.full((H, W), np.inf)  # nearest near-decision primitive

    def visit(t, hit, near, atom):
        nonlocal best, best_id, second, graze
        graze = np.where(near, np.minimum(graze, t), graze)
        t = np.where(hit, t, np.inf)
        closer = t < best
        other = best_id != atom
        second = np.where(closer & other, best, np.where(~closer & other, np.minimum(second, t), second))
        best_id = np.where(closer, atom, best_id)
        best = np.where(closer, t, best)

    for i, (cx, cy, cz, r) in enumerate(sph.astype(np.float64)):
        if not -cz > 1e-6:
            continue
        cc = cx * cx + cy * cy + cz * cz - r * r
        dc = dx * cx + dy * cy - cz
        disc = dc * dc - dd * cc
        t = (dc - np.sqrt(np.maximum(disc, 0.0))) / dd
        scale = np.maximum(dc * dc, dd * abs(cc))
        visit(t, (disc > 0) & (t > 1e-6), (t > 1e-6) & (np.abs(disc) <= 1e-6 * scale), i)
    for k, (qx, qy, qz, ax, ay, az, ln, rr) in enumerate(cyl.astype(np.float64)):
        pa = qx * ax + qy * ay + qz * az
        cc2 = qx * qx + qy * qy + qz * qz - pa * pa - rr * rr
        da = dx * ax + dy * ay - az
        dp = dx * qx + dy * qy - qz
        A = np.maximum(dd - da * da, 1e-9)
        Bq = dp - da * pa
        disc = Bq * Bq - A * cc2
        t = (Bq - np.sqrt(np.maximum(disc, 0.0))) / A
        sax = t * da - pa
        inside = (disc > 0) & (t > 1e-6)
        tol = 1e-5 * max(ln, rr)
        axial = (t > 1e-6) & (sax >= -tol) & (sax <= ln + tol)  # the finite part
        near = axial & (
            (np.abs(disc) <= 1e-6 * np.maximum(Bq * Bq, A * abs(cc2)))
            | (inside & ((np.abs(sax) <= tol) | (np.abs(sax - ln) <= tol)))
        )
        visit(t, inside & (sax >= 0) & (sax <= ln), near, owner[k])
    tie = np.isfinite(second) & (second <= best * (1 + 1e-5))
    grazing = np.isfinite(graze) & (graze <= best * (1 + 1e-5))
    return ~(tie | grazing)


def _assert_matches(got, want, sc, rgb_max, rgb_share, tight):
    """Hold the port's image to the JAX package's on the decided pixels;
    returns the rgb readings (largest error, share above `tight`)."""
    sph, cyl, owner = _view_space(sc)
    ok = _unambiguous(sph, cyl, owner, sc["proj"], sc["W"], sc["H"])
    assert ok.mean() >= 0.99, f"{(~ok).sum()} undecided pixels"
    img, dep, pick = got
    jimg, jdep, jpick = want
    np.testing.assert_array_equal(pick[ok], jpick[ok])
    np.testing.assert_array_equal(img[ok][:, 3], jimg[ok][:, 3])
    hit = ok & np.isfinite(jdep)
    assert (np.isfinite(dep) == np.isfinite(jdep))[ok].all()
    rel = np.abs(dep[hit] - jdep[hit]) / jdep[hit]
    assert rel.max() <= 5e-4 and np.quantile(rel, 0.99) <= 5e-5
    assert hit.sum() > 0.1 * hit.size
    err = np.abs(img[ok][:, :3] - jimg[ok][:, :3]).max(-1)
    reading = (float(err.max()), float((err > tight).mean()))
    print(f"rgb on {ok.sum()} decided pixels: max {reading[0]:.6g}, "
          f"share above {tight:g} {reading[1]:.6g}")
    assert reading[0] <= rgb_max and reading[1] <= rgb_share, (reading, rgb_max, rgb_share)
    return reading


# -- the JAX package's capacities -------------------------------------------------


def _screen(cen, rad, proj, W, H):
    """JAX's projection (raster.py:186-198) → sx, sy, rpx_x, rpx, valid."""
    p = np.asarray(proj, F32)
    x, y, z = cen[:, 0], cen[:, 1], cen[:, 2]
    cw = np.maximum(-z, F32(1e-6))
    sx = ((p[0, 0] * x + p[0, 2] * z) / cw * 0.5 + 0.5) * W
    sy = ((p[1, 1] * y + p[1, 2] * z) / cw * 0.5 + 0.5) * H
    return sx, sy, rad * p[0, 0] / cw * 0.5 * W, rad * p[1, 1] / cw * 0.5 * H, -z > 1e-6


def _pallas_caps_hold(sc, cap):
    """True when no tier of the Pallas path can drop a primitive of this
    scene: TL-binned small spheres ≤ cap per tile, big spheres ≤ 16 per row
    (BCAP), huge spheres ≤ 64, capsule samples ≤ ccap per home tile, huge
    capsules ≤ 32 (raster.py:291-336, :425-503)."""
    sph, cyl, _ = _view_space(sc)
    W, H = sc["W"], sc["H"]
    tx, ty = -(-W // TILE), -(-H // TILE)
    sx, sy, rx, ry, valid = _screen(sph[:, :3], sph[:, 3], sc["proj"], W, H)
    reach = valid & (sx + rx >= 0) & (sx - rx <= tx * TILE)
    small = np.maximum(rx, ry) < 8.0
    huge = ry >= 40.0
    tl = (np.clip((sy - ry) // TILE, 0, ty - 1) * tx + np.clip((sx - rx) // TILE, 0, tx - 1))
    row = np.clip(sy // TILE, 0, ty - 1)
    ok = np.bincount(tl[reach & small].astype(int), minlength=1).max(initial=0) <= cap
    ok &= np.bincount(row[reach & ~small & ~huge].astype(int), minlength=1).max(initial=0) <= 16
    ok &= (reach & huge).sum() <= 64
    m = len(cyl)
    if m:
        ccap = min(max(int(np.ceil(8.0 * m / (tx * ty) / 8.0)) * 8, 8), 96)
        pts = np.concatenate([cyl[:, 0:3] + cyl[:, 3:6] * (cyl[:, 6:7] * f)
                              for f in (0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0)])
        csx, csy, _, _, cvalid = _screen(pts, np.zeros(len(pts), F32), sc["proj"], W, H)
        cvalid &= (csx >= -32.0) & (csx <= tx * TILE + 32.0)
        home = np.clip(csy // TILE, 0, ty - 1) * tx + np.clip(csx // TILE, 0, tx - 1)
        ok &= np.bincount(home[cvalid].astype(int), minlength=1).max(initial=0) <= ccap
        zmin = np.maximum(np.minimum(-pts[:m, 2], -pts[3 * m:, 2]), 1e-6)
        slen = np.hypot(csx[3 * m:] - csx[:m], csy[3 * m:] - csy[:m])
        crad = cyl[:, 7] * sc["proj"][1, 1] / zmin * 0.5 * H
        ok &= ((slen > 80.0) | (crad > 14.0)).sum() <= 32
    return bool(ok)


def _xla_capacity(sc):
    """The XLA engine's union-table capacity that drops nothing on this
    scene, after checking that its 3×3-tile reach covers every primitive:
    each sphere's exact screen box lies within its home tile ± 1, and each
    half-capsule's within the union of its endpoints' home tiles ± 1."""
    sph, cyl, _ = _view_space(sc)
    W, H = sc["W"], sc["H"]
    tx, ty = -(-W // TILE), -(-H // TILE)
    s = RasterSettings(width=W, height=H)
    sh = build_scene(sc["positions"], sc["radii"], sc["colors"], sc["view"],
                     sc["proj"], s, None, device="cpu").shading

    def homes(c):
        sx, sy, _, _, valid = _screen(c, np.zeros(len(c), F32), sc["proj"], W, H)
        return (np.clip(sx // TILE, 0, tx - 1).astype(int),
                np.clip(sy // TILE, 0, ty - 1).astype(int), valid)

    def boxes(c, r):
        t = lambda a: torch.as_tensor(a)  # noqa: E731
        return [b.numpy() for b in _tile_boxes(t(c[:, 0]), t(c[:, 1]), t(c[:, 2]), t(r), sh, W, H)]

    hx, hy, valid = homes(sph[:, :3])
    bx0, bx1, by0, by1 = boxes(sph[:, :3], sph[:, 3])
    seen = valid & (bx0 <= bx1) & (by0 <= by1)
    assert (bx0[seen] >= hx[seen] - 1).all() and (bx1[seen] <= hx[seen] + 1).all()
    assert (by0[seen] >= hy[seen] - 1).all() and (by1[seen] <= hy[seen] + 1).all()
    counts = [(hx[valid], hy[valid])]
    if len(cyl):
        p0, p1 = cyl[:, 0:3], cyl[:, 0:3] + cyl[:, 3:6] * cyl[:, 6:7]
        h0, h1 = homes(p0), homes(p1)
        b0, b1 = boxes(p0, cyl[:, 7]), boxes(p1, cyl[:, 7])
        for k in range(len(cyl)):
            for ix in range(min(b0[0][k], b1[0][k]), max(b0[1][k], b1[1][k]) + 1):
                for iy in range(min(b0[2][k], b1[2][k]), max(b0[3][k], b1[3][k]) + 1):
                    assert any(h[2][k] and abs(ix - h[0][k]) <= 1 and abs(iy - h[1][k]) <= 1
                               for h in (h0, h1)), (k, ix, iy)
        counts.append((np.concatenate([h0[0][h0[2]], h1[0][h1[2]]]),
                       np.concatenate([h0[1][h0[2]], h1[1][h1[2]]])))
    worst = 0
    for cx, cy in counts:
        home = np.zeros((ty + 2, tx + 2), int)
        np.add.at(home, (cy + 1, cx + 1), 1)
        union = sum(np.roll(home, (oy, ox), (0, 1)) for oy in (-1, 0, 1) for ox in (-1, 0, 1))
        worst = max(worst, union.max())
    return int(2 ** np.ceil(np.log2(max(worst, 8))))


# -- tests ----------------------------------------------------------------------


# rgb limits per scene on decided pixels: (largest error, largest share of
# pixels above 1e-4 against Pallas or above 6e-3 against XLA), set just
# above the readings that the tests print (PERF.md lists them)
PALLAS_RGB = {"spheres250": (2.5e-3, 0.007), "licorice40": (6e-3, 0.045)}
XLA_RGB = {
    "spheres250": (3.2e-3, 0.0),
    "spheres250_jitter": (3.2e-3, 0.0),
    "water_spacefill": (9e-4, 0.0),
    "water_licorice": (0.04, 0.003),
    "water_ballstick": (0.15, 0.001),
    "water_oblique_licorice": (0.036, 0.003),
}


@functools.lru_cache(maxsize=None)
def _pallas(case):
    """The scene and its image from _raster_row_kernel itself (Pallas
    interpret mode, ~20-35 s a call; cached, so these are the module's only
    two such calls)."""
    sc = _spheres250() if case == "spheres250" else _licorice40()
    cap = 48 if case == "spheres250" else 32
    assert _pallas_caps_hold(sc, cap)
    return sc, _jax(sc, engine="pallas", home_capacity=cap)


@pytest.mark.parametrize("case", ["spheres250", "licorice40"])
def test_matches_pallas_interpret(case):
    """The port against the Pallas engine, which packs colours to 8 bits as
    the port does."""
    sc, want = _pallas(case)
    _assert_matches(_port(sc), want, sc, *PALLAS_RGB[case], tight=1e-4)


@pytest.mark.parametrize(
    "fault", ["no_specular", "capsules_no_specular", "capsules_light_mirrored"],
)
def test_limits_catch_shading_faults(fault):
    """Planted shading faults fail the Pallas limits: the specular term
    dropped everywhere, or only on capsule hits; capsule hits shaded with
    the light mirrored in x (the diffuse term of normals mirrored in x)."""
    sc, want = _pallas("licorice40")
    good = _port(sc)
    kw = dict(light_dir=(-0.4, 0.7, 0.6)) if fault.endswith("mirrored") else dict(specular=0.0)
    bad = _port(sc, **kw)
    if fault.startswith("capsules"):
        spheres = _port(dict(sc, bonds=None))
        capsule = good[1] < spheres[1]  # a capsule is nearer than any sphere
        assert capsule.sum() > 0.1 * capsule.size
        img = np.where(capsule[..., None], bad[0], good[0])
        bad = (img, good[1], good[2])
    with pytest.raises(AssertionError):
        _assert_matches(bad, want, sc, *PALLAS_RGB["licorice40"], tight=1e-4)


@pytest.mark.parametrize(
    "case", ["spheres250", "spheres250_jitter", "water_spacefill",
             "water_licorice", "water_ballstick", "water_oblique_licorice"],
)
def test_matches_xla(case):
    """The port against the XLA engine, which covers a primitive only
    within its home tile ± 1 (so not the 40-atom scene's long bonds, which
    the Pallas comparison covers)."""
    sc = {
        "spheres250": lambda: _spheres250(),
        "spheres250_jitter": lambda: _spheres250(jitter=True),
        "water_spacefill": lambda: _water("spacefill"),
        "water_licorice": lambda: _water("licorice"),
        "water_ballstick": lambda: _water("ballstick"),
        "water_oblique_licorice": lambda: _water("licorice", (0.9, 0.7, 1.2)),
    }[case]()
    want = _jax(sc, engine="xla", capacity=_xla_capacity(sc))
    _assert_matches(_port(sc), want, sc, *XLA_RGB[case], tight=6e-3)


def _huge_sphere():
    view, proj = _camera([0.0, 0, 6.0], 256, 256)
    return dict(positions=np.zeros((1, 3), F32), radii=np.array([3.0], F32),
                colors=np.array([[1, 0, 0, 1]], F32), bonds=None, view=view,
                proj=proj, W=256, H=256, rep="spacefill")


def _long_bond():
    view, proj = _camera([0.0, 0, 6.0], 256, 256)
    return dict(positions=np.array([[-2.8, 0, 0], [2.8, 0, 0]], F32),
                radii=np.array([0.2, 0.2], F32),
                colors=np.array([[1, 0, 0, 1], [0, 0, 1, 1]], F32),
                bonds=np.array([[0, 1]], np.int32), view=view, proj=proj,
                W=256, H=256, rep="licorice", kw=dict(licorice_radius=0.1))


def _grid81():
    view, proj = _camera([0.0, 0, 6.0], 256, 256)
    g = np.linspace(-1.9, 1.9, 9)
    gx, gy = np.meshgrid(g, g)
    pos = np.stack([gx.ravel(), gy.ravel(), np.zeros(81)], 1).astype(F32)
    return dict(positions=pos, radii=np.full(81, 1.4, F32),
                colors=np.tile(np.array([[0.8, 0.2, 0.2, 1.0]], F32), (81, 1)),
                bonds=None, view=view, proj=proj, W=256, H=256, rep="spacefill")


def _wide_frame():
    """The strip test's scene: 2144×160, 134 × 10 tiles in one grid."""
    from viamd_tpu_torch.render.camera import perspective

    rng = np.random.RandomState(2)
    n = 120
    cen = rng.uniform(-20, 20, (n, 3)).astype(F32)
    cen[:, 2] -= 45
    W, H = 2144, 160
    return dict(positions=cen, radii=rng.uniform(0.4, 2.0, n).astype(F32),
                colors=rng.rand(n, 4).astype(F32), bonds=None,
                view=np.eye(4, dtype=F32),
                proj=perspective(np.radians(45.0), W / H, 1.0, 200.0),
                W=W, H=H, rep="spacefill")


def _frame_edges():
    """Wide-angle camera, spheres straddling every frame edge and corner
    (where the projected ellipse is most elongated) and bonds crossing the
    edges; jittered projection."""
    from viamd_tpu_torch.render.camera import perspective

    W, H = 200, 120
    proj = perspective(np.radians(100.0), W / H, 0.5, 100.0,
                       (0.37 * 2 / W, -0.21 * 2 / H))
    tx = np.tan(np.radians(50.0)) * W / H  # frame edge slope
    ty = np.tan(np.radians(50.0))
    pos, rad = [], []
    for sx in (-1.0, -0.97, 0.0, 0.97, 1.0):
        for sy in (-1.0, -0.95, 0.0, 0.95, 1.0):
            for depth in (3.0, 7.0):
                if sx == sy == 0.0:
                    continue
                pos.append([sx * tx * depth, sy * ty * depth, -depth])
                rad.append(0.15 * depth)
    pos = np.asarray(pos, F32)
    n = len(pos)
    bonds = np.array([[i, i + 1] for i in range(0, n - 1, 2)], np.int32)
    rng = np.random.RandomState(4)
    return dict(positions=pos, radii=np.asarray(rad, F32),
                colors=rng.rand(n, 4).astype(F32), bonds=bonds,
                view=np.eye(4, dtype=F32), proj=proj, W=W, H=H,
                rep="ballstick")


def _behind_eye():
    """Bonds that cross the eye plane: one atom in front, one behind (its
    sphere is dropped, JAX's rule; its half-capsules are drawn where they
    lie in front)."""
    view, proj = _camera([0.0, 0, 0.0 + 1e-3], 160, 120)
    pos = np.array([
        [0.0, 0.0, -4.0], [0.5, 0.3, 2.0],   # crosses the eye plane
        [-1.0, 0.5, -3.0], [-1.2, 0.6, 1.5],
        [1.0, -0.8, -0.2], [1.4, -0.9, -6.0],  # near end just in front
        [0.3, 0.2, 0.5], [0.2, -0.3, 0.8],   # wholly behind
    ], F32)
    return dict(positions=pos, radii=np.full(8, 0.5, F32),
                colors=np.random.RandomState(5).rand(8, 4).astype(F32),
                bonds=np.array([[0, 1], [2, 3], [4, 5], [6, 7]], np.int32),
                view=view, proj=proj, W=160, H=120, rep="licorice",
                kw=dict(licorice_radius=0.3))


@pytest.mark.parametrize(
    "case", ["huge_sphere", "long_bond", "grid81", "wide_frame",
             "frame_edges", "behind_eye"],
)
def test_brute_force(case):
    """Every pixel against the float32 brute force over all primitives:
    zero disagreements in pick, alpha and depth."""
    sc = {
        "huge_sphere": _huge_sphere, "long_bond": _long_bond, "grid81": _grid81,
        "wide_frame": _wide_frame, "frame_edges": _frame_edges,
        "behind_eye": _behind_eye,
    }[case]()
    kw = sc.pop("kw", {})
    img, dep, pick = _port(sc, **kw)
    s = RasterSettings(width=sc["W"], height=sc["H"], rep=sc["rep"], **kw)
    scene = build_scene(sc["positions"], sc["radii"], sc["colors"], sc["view"],
                        sc["proj"], s, sc["bonds"], device="cpu")
    want_pick, want_dep = _brute_f32(
        scene.sph.numpy(), scene.cyl.numpy(), scene.cyl_ci[:, 1].numpy(),
        sc["proj"], sc["W"], sc["H"],
    )
    np.testing.assert_array_equal(pick, want_pick)
    np.testing.assert_array_equal(img[..., 3], (want_pick >= 0).astype(F32))
    np.testing.assert_array_equal(dep, want_dep)
    assert (pick >= 0).any()
    if case == "grid81":  # every sphere shows at its own centre
        assert set(np.unique(pick[pick >= 0]).tolist()) == set(range(81))
    if case == "long_bond":  # continuous along the bond, split by owner
        xs = np.nonzero(img[128, :, 3] > 0)[0]
        assert xs.size > 150 and np.all(np.diff(xs) == 1)
        assert pick[128, 88] == 0 and pick[128, 168] == 1
    if case == "behind_eye":  # the wholly-behind bond draws nothing
        assert not np.isin(pick, [6, 7]).any()


def test_jax_pallas_tiers_at_bench_scene():
    """Counts, not a parity check: the JAX package's Pallas tier rules
    (raster.py:186-198, :291-336) applied to the 1080p benchmark frame
    (water_box(33_334, seed=3) frame 0, bench.py's camera). 79,788 spheres
    are "big" (8–40 px); the per-row big list keeps BCAP = 16 slots, so
    68 rows keep 1,088 and drop 78,700, the nearest. The small tier (≤ 22
    per tile against its automatic capacity of 32) drops nothing. The port
    bins without capacities (test_brute_force)."""
    sys, traj = water_box(33_334, n_frames=1, seed=3)
    d = render_inputs(sys, 1920, 1080)
    vm = d["view"]
    pv = (traj.load_frames([0])[0][0] @ vm[:3, :3].T + vm[:3, 3]).astype(F32)
    W, H, tx, ty = 1920, 1080, 120, 68
    sx, sy, rx, ry, valid = _screen(pv, d["radii"], d["proj"], W, H)
    reach = valid & (sx + rx >= 0) & (sx - rx <= tx * TILE)
    small = np.maximum(rx, ry) < 8.0
    huge = ry >= 40.0
    big = reach & ~small & ~huge
    rows = np.bincount(np.clip(sy // TILE, 0, ty - 1).astype(int)[big], minlength=ty)
    tl = (np.clip((sy - ry) // TILE, 0, ty - 1) * 128
          + np.clip((sx - rx) // TILE, 0, tx - 1)).astype(int)
    auto_cap = min(max(int(np.ceil(2.0 * len(pv) / (tx * ty) / 8.0)) * 8, 16), 96)
    assert (int((reach & small).sum()), int(big.sum()), int((reach & huge).sum())) == (20214, 79788, 0)
    assert int(np.minimum(rows, 16).sum()) == 1088 and int(big.sum() - np.minimum(rows, 16).sum()) == 78700
    assert np.bincount(tl[reach & small]).max() == 22 and auto_cap == 32


def test_tile_lists(monkeypatch):
    """CSR invariants of bin_primitives: offsets monotone, each tile's list
    in ascending near depth with ties in primitive order, the same entries
    per tile as a binning in primitive order, every entry inside its
    primitive's tile box."""
    sc = _water("licorice")
    s = RasterSettings(width=sc["W"], height=sc["H"], rep="licorice")
    scene = build_scene(sc["positions"], sc["radii"], sc["colors"], sc["view"],
                        sc["proj"], s, sc["bonds"], device="cpu")
    tiles_x = -(-sc["W"] // TILE)
    ls = scene.lists
    monkeypatch.setattr(raster_mod, "_depth_order", lambda near: torch.arange(near.shape[0]))
    by_id = bin_primitives(scene.sph, scene.cyl, scene.shading, sc["W"], sc["H"])
    monkeypatch.undo()
    near_s = cuda_raster.near_depth_spheres(scene.sph).numpy()
    near_c = cuda_raster.near_depth_capsules(scene.cyl).numpy()
    for start, lst, start_id, lst_id, near, boxes in (
        (ls.s_start, ls.s_list, by_id.s_start, by_id.s_list, near_s,
         _tile_boxes(*scene.sph.T, scene.shading, sc["W"], sc["H"])),
        (ls.c_start, ls.c_list, by_id.c_start, by_id.c_list, near_c, None),
    ):
        start, lst = start.numpy(), lst.numpy()
        assert start[0] == 0 and start[-1] == len(lst) and (np.diff(start) >= 0).all()
        assert np.array_equal(start, start_id.numpy())
        assert not np.array_equal(lst, lst_id.numpy())  # the order did change
        for t in range(len(start) - 1):
            ids = lst[start[t]:start[t + 1]]
            ids_by_id = lst_id.numpy()[start[t]:start[t + 1]]
            assert (np.diff(ids_by_id) > 0).all()
            assert np.array_equal(np.sort(ids), ids_by_id)
            dn = np.diff(near[ids])
            assert (dn >= 0).all() and (np.diff(ids)[dn == 0] > 0).all()
            if boxes is not None and len(ids):
                tx0, tx1, ty0, ty1 = (b.numpy()[ids] for b in boxes)
                assert ((tx0 <= t % tiles_x) & (t % tiles_x <= tx1)
                        & (ty0 <= t // tiles_x) & (t // tiles_x <= ty1)).all()
    assert len(ls.c_list) > 0 and len(ls.s_list) > 0
    again = bin_primitives(scene.sph, scene.cyl, scene.shading, sc["W"], sc["H"])
    assert torch.equal(again.s_list, ls.s_list) and torch.equal(again.c_list, ls.c_list)


# -- the kernel's list order, tie rule and cull margin ------------------------------


def _tie_scene(case):
    """Scenes of exact ties: every atom twice (the same centre and radius
    under two ids); a bond whose two half-capsules meet at its midpoint;
    every bond twice."""
    if case == "duplicate_spheres":
        sc = _water("spacefill")
        return dict(sc, positions=np.concatenate([sc["positions"]] * 2),
                    radii=np.concatenate([sc["radii"]] * 2),
                    colors=np.concatenate([sc["colors"]] * 2))
    if case == "bond_halves":  # tilted: the second atom's half lies nearer
        sc = _long_bond()
        pos = np.array([[-2.8, 0.0, -1.0], [2.8, 0.0, 1.0], [-2.0, -1.5, 0.8],
                        [2.0, -1.2, -0.6], [-1.0, 1.6, -1.5], [1.5, 1.0, 1.2]], F32)
        return dict(sc, positions=pos, radii=np.full(6, 0.2, F32),
                    colors=np.random.RandomState(6).rand(6, 4).astype(F32),
                    bonds=np.array([[0, 1], [2, 3], [4, 5]], np.int32))
    sc = _water("licorice")
    return dict(sc, bonds=np.concatenate([sc["bonds"]] * 2))


def _reorder(start, lst, key):
    """Each tile's list re-sorted by key(ids) (ascending)."""
    tile = torch.repeat_interleave(torch.arange(start.shape[0] - 1), start[1:] - start[:-1])
    k = key(lst.long())
    k = k - k.min() if k.numel() else k
    order = torch.argsort(tile * (int(k.max()) + 1 if k.numel() else 1) + k, stable=True)
    return lst[order]


def _tie_built(case):
    sc = _tie_scene(case)
    kw = sc.pop("kw", {})
    s = RasterSettings(width=sc["W"], height=sc["H"], rep=sc["rep"], **kw)
    return sc, build_scene(sc["positions"], sc["radii"], sc["colors"], sc["view"],
                           sc["proj"], s, sc["bonds"], device="cpu")


@pytest.mark.parametrize("case", ["duplicate_spheres", "bond_halves", "duplicate_bonds"])
def test_tie_rule_is_order_free(case, one_thread):
    """The plain version on the depth-ordered lists equals, pixel for
    pixel, the same function on the lists in primitive order (where the
    tie rule reduces to the strict `<` in list order that it replaced) and
    in reverse primitive order (where only the rule, not the order, can
    keep the lower row)."""
    sc, scene = _tie_built(case)
    ls = scene.lists
    args = list(scene.raster_args())
    got = cuda_raster.raster_tiles_plain(*args)
    lists = {}
    for sign in (1, -1):
        s_list = _reorder(ls.s_start, ls.s_list, lambda i: sign * i)
        c_list = _reorder(ls.c_start, ls.c_list, lambda i: sign * i)
        lists[sign] = (s_list, c_list)
        args[5], args[7] = s_list, c_list
        want = cuda_raster.raster_tiles_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    changed = [not torch.equal(a, b) for a, b in zip((ls.s_list, ls.c_list), lists[1])]
    if case == "duplicate_spheres":
        n = len(sc["positions"]) // 2
        assert changed[0] and (got[2] >= 0).sum() > 0.2 * got[2].numel()
        assert int(got[2].max()) < n  # the lower id of each twin wins
    else:
        assert changed[1] and (got[2] >= 0).any()


def _tangent_rays(centre, r, n=256):
    """float32 ray slopes (dx, dy) along the cone of rays tangent to a
    sphere, and at 1 ± 10⁻ᵏ of its half-angle (k = 1..7): silhouette and
    grazing rays."""
    c = np.asarray(centre, np.float64)
    ln = np.linalg.norm(c)
    u = c / ln
    e1 = np.cross(u, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(u, e1)
    half = np.arcsin(min(r / ln, 1.0))
    phi = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    out = []
    for f in [1.0] + [1.0 + sg * 10.0 ** -k for k in range(1, 8) for sg in (-1, 1)]:
        a = half * f
        v = u * np.cos(a) + (np.cos(phi)[:, None] * e1 + np.sin(phi)[:, None] * e2) * np.sin(a)
        out.append(v[v[:, 2] < -1e-3])
    v = np.concatenate(out)
    d = v[:, :2] / -v[:, 2:3]
    return torch.tensor(d[:, 0], dtype=torch.float32), torch.tensor(d[:, 1], dtype=torch.float32)


def _grid_rays(centre, span, n=48):
    """float32 slopes on an n×n grid of half-width `span` about the
    direction of `centre`."""
    c = np.asarray(centre, np.float64)
    g = np.linspace(-span, span, n)
    gx, gy = np.meshgrid(g + c[0] / -c[2], g + c[1] / -c[2])
    return torch.tensor(gx.ravel(), dtype=torch.float32), torch.tensor(gy.ravel(), dtype=torch.float32)


def _margin_cases(case):
    """(spheres (n, 4), half-capsules (m, 8), rays per primitive) of one
    adversarial scene, float32."""
    rng = np.random.RandomState(11)
    lateral = [(0.0, 0.0), (0.74, 0.41), (1.5, -1.0), (2.5, 0.41)]
    sph, cyl = [], []
    if case == "silhouette":  # grazing rays at the frame's centre and corners
        sph = [(ux * z, uy * z, -z, r) for z in (110.0, 200.0, 500.0)
               for r in (0.1, 0.25, 1.52) for ux, uy in lateral]
    elif case == "eye_plane":  # spheres that reach, or nearly reach, the eye plane
        sph = [(ux * z, uy * z, -z, r) for z in (1e-3, 0.1, 0.3, 1.0)
               for r in (0.25, 1.0, 3.0) for ux, uy in lateral]
    elif case == "thin_far":  # licorice half-bonds, 0.25 Å, at ~200 Å
        for z in (190.0, 200.0, 210.0):
            for ux, uy in lateral:
                for _ in range(6):
                    a = rng.normal(size=3)
                    cyl.append((ux * z, uy * z, -z, *(a / np.linalg.norm(a)), 0.48, 0.25))
    else:  # end_on: the axis along a float32 ray, its line at 0–2 r from the eye
        for z in (5.0, 20.0, 110.0, 200.0):
            for ux, uy in lateral[:3]:
                d = np.array([ux, uy, -1.0], np.float32)
                a = (d / np.linalg.norm(d)).astype(np.float32)
                e = np.cross(a.astype(np.float64), [0.0, 1.0, 0.0])
                e /= np.linalg.norm(e)
                for rho in (0.0, 0.125, 0.2475, 0.2525, 0.5):
                    for sg in (1.0, -1.0):  # axis away from / towards the eye
                        p0 = d * z - (a * 0.96 if sg < 0 else 0.0) + e * rho
                        cyl.append((*p0, *(a * sg), 0.96, 0.25))
    rays = []
    for p in sph:
        c, r = p[:3], p[3]
        ts = _tangent_rays(c, r) if -c[2] > r else _grid_rays(c, 2.5, 96)
        gr = _grid_rays(c, 1.3 * r / max(-c[2] - r, 1e-3 * -c[2]) if -c[2] > r else 2.5)
        rays.append((torch.cat([ts[0], gr[0]]), torch.cat([ts[1], gr[1]])))
    for q in cyl:
        p0, a, ln, r = np.array(q[:3]), np.array(q[3:6]), q[6], q[7]
        parts = [_tangent_rays(p0 + a * ln * f, r, 64) for f in (0.0, 0.5, 1.0)]
        parts.append(_grid_rays(p0 + a * ln * 0.5, 3.0 * (ln + r) / -p0[2]))
        # along the axis, a few ulps off it, and 1e-6 to 0.1 off it
        d = a / -a[2]
        ulps = np.arange(-6, 7) * 2.0 ** -23
        gx, gy = np.meshgrid(d[0] * (1 + ulps) + ulps, d[1] * (1 + ulps) + ulps)
        phi = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
        off = np.concatenate([10.0 ** -k * np.stack([np.cos(phi), np.sin(phi)], 1)
                              for k in range(1, 7)])
        parts.append((torch.tensor(np.concatenate([gx.ravel(), d[0] + off[:, 0]]), dtype=torch.float32),
                      torch.tensor(np.concatenate([gy.ravel(), d[1] + off[:, 1]]), dtype=torch.float32)))
        rays.append(tuple(torch.cat([p_[j] for p_ in parts]) for j in (0, 1)))
    return (torch.tensor(np.asarray(sph, np.float32).reshape(-1, 4)),
            torch.tensor(np.asarray(cyl, np.float32).reshape(-1, 8)), rays)


@pytest.mark.parametrize("case", ["silhouette", "eye_plane", "thin_far", "end_on"])
def test_cull_margin(case, one_thread):
    """Every hit that the kernel's float32 arithmetic computes (the plain
    version's, as chip_smoke.py replays it) lies at or behind
    cull_depth(tlo) of its primitive, so the kernel's front-to-back
    cull, which skips a candidate once cull_depth(tlo) > the nearest hit,
    never skips one that could have won (csrc/raster.cu's note says why;
    this reads how close the rounding comes)."""
    sph, cyl, rays = _margin_cases(case)
    worst, hits, clamped = 0.0, 0, 0
    for k, (dx, dy) in enumerate(rays):
        dx, dy = dx[:, None], dy[:, None]
        dd = dx * dx + dy * dy + 1.0
        if k < sph.shape[0]:
            prim = sph[k:k + 1]
            t, hit = chip_smoke.sphere_hits(prim, dx, dy, dd)
            tlo = cuda_raster.near_depth_spheres(prim)
        else:
            prim = cyl[k - sph.shape[0]:k - sph.shape[0] + 1]
            t, hit = chip_smoke.capsule_hits(prim, dx, dy, dd)
            da = dx * prim[:, 3] + dy * prim[:, 4] - prim[:, 5]
            clamped += int((dd - da * da <= 1e-9).sum())
            tlo = cuda_raster.near_depth_capsules(prim)
        cut = cuda_raster.cull_depth(tlo)
        assert (t[hit] >= cut.expand_as(t)[hit]).all(), (case, prim.tolist())
        hits += int(hit.sum())
        if hit.any():
            short = float((tlo - t[hit].min()) / (tlo - cut))
            worst = max(worst, short)
    print(f"{case}: {hits} hits, largest shortfall below tlo {worst:.4f} of the margin, "
          f"{clamped} rays with A clamped")
    assert hits > 1000
    if case == "end_on":
        assert clamped > 0
    if case in ("silhouette", "thin_far"):
        assert worst > 0.0  # float32 hits do fall in front of tlo here


@pytest.mark.parametrize("case", ["water_spacefill", "water_licorice", "frame_edges",
                                  "duplicate_spheres", "bond_halves"])
def test_culled_walk_matches_plain(case, one_thread):
    """The kernel's front-to-back cull, replayed on the CPU over the lists
    that bin_primitives sorts (chip_smoke.kernel_walk, which counts the
    kernel's work on the card), gives the unculled plain version's picks
    and depths at every pixel, with fewer tests than all candidates and no
    fewer than an exact cull needs."""
    if case.startswith("water"):
        sc = _water(case.split("_")[1])
    elif case == "frame_edges":
        sc = _frame_edges()
    else:
        sc = _tie_scene(case)
    kw = sc.pop("kw", {})
    s = RasterSettings(width=sc["W"], height=sc["H"], rep=sc["rep"], **kw)
    scene = build_scene(sc["positions"], sc["radii"], sc["colors"], sc["view"],
                        sc["proj"], s, sc["bonds"], device="cpu")
    _, pdep, ppick = cuda_raster.raster_tiles_plain(*scene.raster_args())
    walk = chip_smoke.kernel_walk(scene, pdep)
    assert torch.equal(walk["pick"], ppick) and torch.equal(walk["depth"], pdep)
    ls = scene.lists
    full = sum(int(((st[1:] - st[:-1]) * TILE * TILE).sum()) for st in (ls.s_start, ls.c_start))
    tests, needed = sum(walk["lane_tests"]), sum(walk["needed"])
    print(f"{case}: culled walk {tests} tests of {full} ({full / max(tests, 1):.2f}x fewer; "
          f"an exact cull's {needed}), {sum(walk['warp_steps'])} warp steps")
    assert needed <= tests < full
    assert all(n <= t for n, t in zip(walk["needed"], walk["lane_tests"]))


def test_camera_and_colors_match_jax(ala_system):
    from tests._torch_parity import port_system
    from viamd_tpu.render import camera as JC, color as JCol
    from viamd_tpu_torch.render import camera as PC, color as PCol

    psys = port_system(ala_system)
    for name in PCol.COLOR_MAPPINGS:
        np.testing.assert_array_equal(
            PCol.COLOR_MAPPINGS[name](psys), JCol.COLOR_MAPPINGS[name](ala_system)
        )
    np.testing.assert_array_equal(
        PCol.color_atoms_uniform(psys, (0.1, 0.2, 0.3, 1.0)),
        JCol.color_atoms_uniform(ala_system, (0.1, 0.2, 0.3, 1.0)),
    )
    cj, cp = JC.compute_optimal_view(*ala_system.aabb()), PC.compute_optimal_view(*psys.aabb())
    np.testing.assert_array_equal(cp.view_matrix(), cj.view_matrix())
    np.testing.assert_array_equal(cp.proj_matrix(96, 64, (0.3, -0.2)), cj.proj_matrix(96, 64, (0.3, -0.2)))
    np.testing.assert_array_equal(PC.taa_jitter_sequence(8), JC.taa_jitter_sequence(8))
    np.testing.assert_array_equal(PC.orthographic(-2, 3, -1, 4, 0.1, 9), JC.orthographic(-2, 3, -1, 4, 0.1, 9))
    cam = PC.Camera(eye=np.array([5.0, 0, 0]), center=np.zeros(3), up=np.array([0.0, 1, 0]))
    jcam = JC.Camera(eye=np.array([5.0, 0, 0]), center=np.zeros(3), up=np.array([0.0, 1, 0]))
    np.testing.assert_array_equal(PC.trackball_rotate(cam, 0.1, 0.05).eye,
                                  JC.trackball_rotate(jcam, 0.1, 0.05).eye)


def test_water_scene_inputs_match_jax():
    """water_render_inputs (port numpy copies) equals the JAX package's
    datagen + CPK colours + camera on the same seed."""
    from tests._torch_parity import water_render_inputs
    from viamd_tpu.datagen import water_box as jax_water_box
    from viamd_tpu.render import camera as JC, color as JCol

    d = water_render_inputs(200, 5, 128, 96)
    sys, traj = jax_water_box(200, n_frames=1, seed=5)
    np.testing.assert_array_equal(d["positions"], np.asarray(traj.load_frames([0])[0][0]))
    np.testing.assert_array_equal(d["colors"], JCol.color_atoms_cpk(sys))
    np.testing.assert_array_equal(d["radii"], sys.radius)
    np.testing.assert_array_equal(d["bonds"], sys.bonds)
    box = np.asarray(sys.cell.extent(), np.float64)
    np.testing.assert_array_equal(
        d["view"], JC.look_at(box * 0.5 + np.array([0, 0, 1.6]) * box[2], box * 0.5, np.array([0.0, 1, 0]))
    )


def test_wrapper_rejects_other_devices():
    z = torch.zeros((1, 4), device="meta")
    zi = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    st = torch.zeros(2, dtype=torch.int32, device="meta")
    sh = cuda_raster.Shading(*([1.0] * len(cuda_raster.Shading._fields)))
    with pytest.raises(ValueError):
        cuda_raster.raster_tiles(z, zi, torch.zeros((0, 8), device="meta"),
                                 zi[:0], st, st[:1], st, st[:0], 16, 16, sh)


# -- the CUDA kernel (needs the card) ---------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "case", ["spacefill", "licorice", "duplicate_spheres", "bond_halves", "duplicate_bonds"],
)
def test_kernel_matches_plain(cuda, case):
    """The culled kernel against its unculled plain version on the card:
    pick, alpha and depth identical (same float operations, no FMA, the
    same tie rule), rgb within 1e-5 (powf against torch.pow); on water
    frames and on the tie scenes of test_tie_rule_is_order_free."""
    if case in ("spacefill", "licorice"):
        sys, traj = water_box(600, n_frames=1, seed=3)
        d = render_inputs(sys, 400, 240)
        s = RasterSettings(width=400, height=240, rep=case)
        scene = build_scene(traj.load_frames([0])[0][0], d["radii"], d["colors"], d["view"],
                            d["proj"], s, d["bonds"], device=cuda)
    else:
        sc = _tie_scene(case)
        s = RasterSettings(width=sc["W"], height=sc["H"], rep=sc["rep"], **sc.pop("kw", {}))
        scene = build_scene(sc["positions"], sc["radii"], sc["colors"], sc["view"],
                            sc["proj"], s, sc["bonds"], device=cuda)
    before = cuda_raster.launches
    img, dep, pick = render_scene(scene)
    torch.cuda.synchronize()
    assert cuda_raster.launches == before + 1
    pimg, pdep, ppick = cuda_raster.raster_tiles_plain(*scene.raster_args())
    assert torch.equal(pick, ppick) and torch.equal(img[..., 3], pimg[..., 3])
    assert torch.equal(dep, pdep)
    assert (img[..., :3] - pimg[..., :3]).abs().max().item() <= 1e-5
    assert (pick >= 0).sum().item() > (0.2 * pick.numel() if case != "bond_halves" else 0)


@pytest.mark.requires_cuda
def test_kernel_wrapper_checks_inputs(cuda):
    sh = cuda_raster.Shading(*([1.0] * len(cuda_raster.Shading._fields)))
    sph = torch.zeros((2, 4), device=cuda)
    ci = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    cyl = torch.zeros((0, 8), device=cuda)
    st = torch.zeros(2, dtype=torch.int32, device=cuda)
    lst = torch.zeros(0, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cuda_raster.raster_tiles(sph.double(), ci, cyl, ci[:0], st, lst, st, lst, 16, 16, sh)
    with pytest.raises(ValueError):  # 2 tiles need 3 offsets
        cuda_raster.raster_tiles(sph, ci, cyl, ci[:0], st, lst, st, lst, 32, 16, sh)
