"""The triangle raster of the port (render/triangles.py, its plain version
and csrc/triangles.cu) against viamd_tpu's XLA tile kernel on scenes where
its 64-slot cap cannot bind, and against a brute-force ray cast over every
triangle (no tile lists).

The JAX package is imported inside the tests that use it, so the tests
marked `requires_cuda` collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_triangles.py

Tolerances.
- Brute force: the torch float32 cast below repeats the plain version's
  arithmetic over ALL triangles, in the tile lists' order (ascending near
  depth, ties in triangle order: each list is a subsequence of it), so
  pick, depth and rgba must be identical at every pixel: a triangle a
  tile list missed would show.
- Against the JAX package: its CPU backend contracts a·b + c into FMAs,
  the port does not (so that the kernel, built with -fmad=false, equals
  its plain version). A pixel whose float64 ray lies within 1e-4 of a
  triangle's edge (u, v or u + v − 1 of a candidate that passes the other
  tests), or whose two nearest hits lie within 1e-5 of each other in t,
  is "undecided": counted, bounded by UNDECIDED_SHARE of the frame, and
  held to nothing. Every other pixel: the same pick, depth within 1e-5
  relative and 99% of hits within 1e-6 (t = (q·e2)·(1/det), two sums of
  products that cancel and that FMAs round apart: 4.6e-6 at most on these
  scenes, on a thin triangle), rgb within 1e-5 (the
  normal's rounding through the specular x^32: 32 · a few ulps). A
  reversed winding changes the same arithmetic, so it is held to the
  same bounds.
- Kernel against plain (on the card): equal, pixel for pixel, in every
  channel.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.render import cuda_triangles
from viamd_tpu_torch.render import triangles as tri_mod
from viamd_tpu_torch.render.triangles import (
    arrow_mesh,
    bin_triangles,
    raster_triangles,
    raster_triangles_plain,
    render_triangles,
)

TILE = 16
UNDECIDED_SHARE = 0.01
JAX_CAP = 64  # viamd_tpu/render/triangles.py's max_per_tile


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# -- scenes (numpy, seeded; view space) ---------------------------------------


def _proj(W, H):
    from viamd_tpu_torch.render.camera import perspective

    return perspective(np.radians(45.0), W / H, 0.1, 100.0)


def _pair(W=96, H=64):
    """tests/test_render.py::TestTriangleRaster's scene: a triangle in front
    of a larger one."""
    tris = np.array(
        [
            [[-3, -3, -10], [3, -3, -10], [0, 3, -10]],
            [[-9, -9, -20], [9, -9, -20], [0, 9, -20]],
        ],
        np.float32,
    )
    cols = np.array([[1, 0, 0, 1], [0, 1, 0, 1]], np.float32)
    return dict(tris=tris, cols=cols, picks=np.array([7, 8], np.int32), W=W, H=H)


def _random(W=72, H=40, n=120, seed=1, size=2.5, crossing=False):
    """n random triangles 8–30 deep, random orientations and windings,
    random colours and picks; with `crossing`, one more that crosses the
    eye plane (binned by JAX's rule from its clamped depths, so its box
    misses part of its image: held to JAX, not to the brute force)."""
    rng = np.random.RandomState(seed)
    c = np.stack([rng.uniform(-7, 7, n), rng.uniform(-4.5, 4.5, n), rng.uniform(-30, -8, n)], 1)
    tris = c[:, None, :] + rng.normal(scale=size, size=(n, 3, 3))
    if crossing:
        tris = np.concatenate([tris, [[[-2, -1, -4], [2, -1, -4], [0, 1.5, 3.0]]]])
        n += 1
    cols = rng.uniform(0.05, 1.0, (n, 4)).astype(np.float32)
    cols[rng.rand(n) < 0.3, 3] = 1.0
    picks = rng.randint(0, 10_000, n).astype(np.int32)
    picks[::7] = -1
    return dict(tris=tris.astype(np.float32), cols=cols, picks=picks, W=W, H=H)


def _flipped(sc):
    """The same triangles with their winding reversed."""
    return dict(sc, tris=sc["tris"][:, ::-1].copy())


def _crowded(W=64, H=48, n=200, seed=3):
    """Over JAX's 64-slot cap: n overlapping triangles over a few tiles, the
    near ones small, so the nearest 64 of a tile do not cover it."""
    rng = np.random.RandomState(seed)
    c = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n), rng.uniform(-20, -6, n)], 1)
    scale = np.where(c[:, 2] > -12, 0.15, 1.5)[:, None, None]
    tris = c[:, None, :] + rng.normal(size=(n, 3, 3)) * scale
    cols = rng.uniform(0.05, 1.0, (n, 4)).astype(np.float32)
    return dict(tris=tris.astype(np.float32), cols=cols,
                picks=np.arange(n, dtype=np.int32), W=W, H=H)


# -- references -------------------------------------------------------------------


def _tile_counts(sc):
    p = _proj(sc["W"], sc["H"])
    start, _ = bin_triangles(torch.as_tensor(sc["tris"]), float(np.float32(p[0, 0])),
                             float(np.float32(p[1, 1])), sc["W"], sc["H"])
    return (start[1:] - start[:-1]).numpy()


def _port(sc, shade=True, device="cpu"):
    out = render_triangles(sc["tris"], sc["cols"], sc["picks"], _proj(sc["W"], sc["H"]),
                           sc["W"], sc["H"], shade=shade, device=device)
    assert out[0].dtype == torch.float32 and out[2].dtype == torch.int32
    return tuple(t.cpu().numpy() for t in out)


def _jax(sc, shade=True, cap=JAX_CAP):
    from viamd_tpu.render.triangles import render_triangles as j_render

    out = j_render(sc["tris"], sc["cols"], sc["picks"], _proj(sc["W"], sc["H"]),
                   sc["W"], sc["H"], shade=shade, max_per_tile=cap)
    return tuple(np.asarray(a) for a in out)


def _rays64(W, H, proj):
    """(H, W) float64 ray directions from the float32 ones the port casts."""
    p = np.asarray(proj, np.float32)
    dx, dy = tri_mod._tile_rays(W, H, float(p[0, 0]), float(p[1, 1]), torch.device("cpu"))
    tx, ty = -(-W // TILE), -(-H // TILE)

    def image(a):
        a = a.reshape(ty, tx, TILE, TILE).transpose(1, 2).reshape(ty * TILE, tx * TILE)
        return a[:H, :W].double().numpy()

    return image(dx), image(dy)


def _undecided(sc, eps_edge=1e-4, eps_t=1e-5):
    """(H, W) bool: pixels within rounding of a decision, in float64 over
    every triangle (module docstring)."""
    W, H = sc["W"], sc["H"]
    dx, dy = _rays64(W, H, _proj(W, H))
    d = np.stack([dx, dy, -np.ones_like(dx)], -1)[:, :, None, :]  # (H, W, 1, 3)
    v = sc["tris"].astype(np.float64)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    pv = np.cross(d, e2)
    det = np.sum(pv * e1, -1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tv = -v[:, 0]
    u = np.sum(tv * pv, -1) * inv
    q = np.cross(tv, e1)
    w = np.sum(q * d, -1) * inv
    t = np.sum(q * e2, -1) * inv
    inside = (u >= 0) & (w >= 0) & (u + w <= 1)
    near_edge = (np.minimum(np.minimum(np.abs(u), np.abs(w)), np.abs(1 - u - w)) < eps_edge)
    cand = (t > 1e-3) & (np.abs(det) > 1e-12)
    edge = (cand & near_edge & (inside | (np.minimum(u, w) > -eps_edge))).any(-1)
    ts = np.sort(np.where(cand & inside, t, np.inf), axis=-1)
    if ts.shape[-1] < 2:
        return edge
    t0, t1 = ts[..., 0], ts[..., 1]
    tie = np.isfinite(t1) & (t1 - np.where(np.isfinite(t0), t0, 0) <= eps_t * t0)
    return edge | tie


def _brute(sc, shade=True):
    """Every pixel's ray against EVERY triangle, in the plain version's
    float32 arithmetic and the tile lists' order, through one tile list
    that holds all triangles (the binning bypassed)."""
    W, H = sc["W"], sc["H"]
    p = np.asarray(_proj(W, H), np.float32)
    tri = torch.as_tensor(sc["tris"])
    order = tri_mod._depth_order((-tri[..., 2]).clamp_min(1e-2).amin(1)).int()
    tx, ty = -(-W // TILE), -(-H // TILE)
    T = tri.shape[0]
    start = torch.arange(tx * ty + 1, dtype=torch.int32) * T
    lst = order.repeat(tx * ty)
    return tuple(a.numpy() for a in raster_triangles_plain(
        tri, torch.as_tensor(sc["cols"]), torch.as_tensor(sc["picks"]), start, lst,
        W, H, float(p[0, 0]), float(p[1, 1]), tri_mod.LIGHT, shade))


# -- against the JAX package --------------------------------------------------------


@pytest.mark.parametrize(
    "case,shade",
    [
        ("pair", True),
        ("random", True),
        ("random", False),
        ("random_flipped", True),
        ("random_crossing", True),
        ("random_96x64", True),
    ],
)
def test_matches_jax(case, shade):
    sc = {
        "pair": _pair,
        "random": _random,
        "random_flipped": lambda: _flipped(_random()),
        "random_crossing": lambda: _random(crossing=True),
        "random_96x64": lambda: _random(96, 64, n=110, seed=2, size=1.5),
    }[case]()
    assert _tile_counts(sc).max() < JAX_CAP  # JAX drops nothing here
    got = _port(sc, shade)
    want = _jax(sc, shade)
    und = _undecided(sc)
    pick, dep, img = got[2], got[1], got[0]
    jpick, jdep, jimg = want[2], want[1], want[0]
    dec = ~und
    n_und = int(und.sum())
    print(f"{case} shade={shade}: {n_und} undecided of {und.size}, "
          f"{int((pick != jpick).sum())} pick mismatches")
    assert n_und <= UNDECIDED_SHARE * und.size
    _hold(got, want, und)
    assert (jpick >= 0).sum() > 100


def _hold(got, want, und):
    """Picks equal, depth within 1e-5 relative (99% within 1e-6), rgba
    within 1e-5 at every decided pixel (module docstring)."""
    (img, dep, pick), (jimg, jdep, jpick) = got, want
    dec = ~und
    assert np.array_equal(pick[dec], jpick[dec])
    assert np.array_equal(np.isfinite(dep[dec]), np.isfinite(jdep[dec]))
    hit = dec & np.isfinite(jdep)
    rel = np.abs(dep[hit] - jdep[hit]) / jdep[hit]
    assert rel.max(initial=0) <= 1e-5 and np.quantile(rel, 0.99) <= 1e-6
    assert np.abs(img[dec] - jimg[dec]).max() <= 1e-5


def test_empty_scene_and_two_sided():
    sc = _pair()
    z = dict(sc, tris=np.zeros((0, 3, 3), np.float32), cols=np.zeros((0, 4), np.float32),
             picks=np.zeros(0, np.int32))
    img, dep, pick = _port(z)
    assert (pick == -1).all() and not np.isfinite(dep).any() and (img == 0).all()
    # the normal turns toward the viewer either way
    _hold(_port(_flipped(_random())), _port(_random()), _undecided(_random()))
    img, dep, pick = _port(sc)
    flipped = _port(_flipped(sc))[2]
    assert (flipped == 7).sum() == (pick == 7).sum() and (flipped == 8).sum() == (pick == 8).sum()
    H, W = dep.shape
    assert pick[H // 2, W // 2] == 7 and abs(dep[H // 2, W // 2] - 10.0) < 0.2
    assert (pick == 8).sum() > 100  # the back triangle peeks out


@pytest.mark.parametrize("case", ["random", "crowded", "random_flat"])
def test_brute_force(case):
    sc = {"random": _random, "crowded": _crowded, "random_flat": _random}[case]()
    shade = case != "random_flat"
    got = _port(sc, shade)
    want = _brute(sc, shade)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_over_the_jax_cap():
    """A scene with tiles over 64 candidates: the port's picks equal the
    brute-force cast everywhere; the JAX package's 64-slot cap drops the
    farther candidates and gets pixels wrong."""
    sc = _crowded()
    assert _tile_counts(sc).max() > JAX_CAP
    got, brute, jax_out = _port(sc), _brute(sc), _jax(sc)
    assert np.array_equal(got[2], brute[2])
    und = _undecided(sc)
    assert int(((jax_out[2] != brute[2]) & ~und).sum()) > 0


def test_arrow_mesh_matches_jax():
    from viamd_tpu.render.triangles import arrow_mesh as j_arrow

    for beg, end, r in (([0, 0, 0], [0, 0, 5], 0.3), ([1, 2, 3], [4, -2, 0.5], 0.1),
                        ([0, 0, 0], [5, 0, 0], 0.2), ([1, 1, 1], [1, 1, 1], 0.2)):
        assert np.array_equal(arrow_mesh(beg, end, r), j_arrow(beg, end, r))
    assert arrow_mesh([0, 0, 0], [0, 0, 5], 0.3).shape == (96, 3, 3)


def test_binning_matches_jax_order(monkeypatch):
    """The lists hold what JAX's binning would give every tile without its
    cap, in its order: np.lexsort((znear, tile)) over the same boxes."""
    sc = _random(96, 64, n=200, seed=2, size=2.0, crossing=True)
    W, H = sc["W"], sc["H"]
    p = np.asarray(_proj(W, H), np.float32)
    v = sc["tris"]
    start, lst = bin_triangles(torch.as_tensor(v), float(p[0, 0]), float(p[1, 1]), W, H)
    # the JAX rule in numpy (viamd_tpu/render/triangles.py:191-209)
    tx, ty = -(-W // TILE), -(-H // TILE)
    z = -v[..., 2]
    front = (z > 1e-2).any(axis=1)
    zc = np.maximum(z, 1e-2)
    sx = (v[..., 0] / zc * float(p[0, 0]) * 0.5 + 0.5) * W
    sy = (-v[..., 1] / zc * float(p[1, 1]) * 0.5 + 0.5) * H
    x0 = np.clip(np.floor(sx.min(1) / TILE), 0, tx - 1).astype(np.int64)
    x1 = np.clip(np.floor(sx.max(1) / TILE), 0, tx - 1).astype(np.int64)
    y0 = np.clip(np.floor(sy.min(1) / TILE), 0, ty - 1).astype(np.int64)
    y1 = np.clip(np.floor(sy.max(1) / TILE), 0, ty - 1).astype(np.int64)
    nx = x1 - x0 + 1
    cnt = np.where(front, nx * (y1 - y0 + 1), 0)
    tri_of = np.repeat(np.arange(len(v)), cnt)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    k = np.arange(cnt.sum()) - off[tri_of]
    txy = x0[tri_of] + (k % nx[tri_of]) + tx * (y0[tri_of] + k // nx[tri_of])
    order = np.lexsort((zc.min(axis=1)[tri_of], txy))
    assert np.array_equal(lst.numpy(), tri_of[order])
    assert np.array_equal(start.numpy(), np.searchsorted(txy[order], np.arange(tx * ty + 1)))


def test_wrapper_rejects_other_devices():
    sc = _pair()
    t = torch.as_tensor(sc["tris"], device="meta")
    z = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no triangle raster"):
        raster_triangles(t, t, z, z, z, 16, 16, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_triangles.raster(torch.as_tensor(sc["tris"]), None, None, None, None,
                              16, 16, 1.0, 1.0, tri_mod.LIGHT, True)


# -- on the card -------------------------------------------------------------------


def _scene_tensors(sc, dev):
    p = np.asarray(_proj(sc["W"], sc["H"]), np.float32)
    v = torch.as_tensor(sc["tris"], device=dev)
    start, lst = bin_triangles(v, float(p[0, 0]), float(p[1, 1]), sc["W"], sc["H"])
    return (v, torch.as_tensor(sc["cols"], device=dev), torch.as_tensor(sc["picks"], device=dev),
            start, lst, sc["W"], sc["H"], float(p[0, 0]), float(p[1, 1]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["pair", "random", "random_flat", "crowded", "wide"])
def test_kernel_matches_plain(cuda, case):
    sc = {
        "pair": _pair, "random": _random, "random_flat": _random, "crowded": _crowded,
        "wide": lambda: _random(333, 157, n=3000, seed=9, size=1.0),
    }[case]()
    shade = case != "random_flat"
    args = _scene_tensors(sc, cuda)
    n0 = cuda_triangles.launches
    got = raster_triangles(*args, tri_mod.LIGHT, shade)
    assert cuda_triangles.launches == n0 + 1
    want = raster_triangles_plain(*args, tri_mod.LIGHT, shade)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    # and the same as the plain version on the CPU
    cpu = raster_triangles(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args),
                           tri_mod.LIGHT, shade)
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)


@pytest.mark.requires_cuda
def test_kernel_wrapper_checks_inputs(cuda):
    args = list(_scene_tensors(_random(), cuda))
    bad = [
        (0, args[0].double(), TypeError),
        (0, args[0].cpu(), ValueError),
        (1, args[1][:, :3].contiguous(), ValueError),
        (2, args[2].long(), TypeError),
        (3, args[3][:-1], ValueError),
        (0, args[0].transpose(1, 2), ValueError),
    ]
    for i, val, exc in bad:
        a = list(args)
        a[i] = val
        with pytest.raises(exc):
            cuda_triangles.raster(*a, tri_mod.LIGHT, True)
