"""render/overlay.py::OverlayQueue and render/font.py of the port against
viamd_tpu's (the cases of tests/test_app.py::TestOverlay, without a
Session), on the CPU.

Tolerances. The queue is host code: primitives, triangles and texts are
bit-equal, and so are the glyph masks. A render goes through the sphere
raster and the triangle raster, whose JAX CPU versions contract a·b + c
into FMAs (tests/test_torch_render.py, tests/test_torch_triangles.py): at
most 1% of the pixels may differ in pick or in coverage (finite depth) at
silhouettes and edges. Every other pixel has the same alpha and rgb within
1e-2, and at most 1% of them differ by more than 6e-3: the port's sphere
raster packs colours to 8 bits a channel, as the Pallas kernel does, and
the JAX overlay goes through the XLA engine's float colours on the CPU
(0.9 → 230/255, lit, plus the specular at a highlight; the bound of
tests/test_torch_render.py against that engine). Text pixels, written last
on top, are equal. The parity scenes keep the JAX raster's tiers unbound:
on the CPU it draws 1,831 of the 2,724 pixels of a radius-3 sphere 16 Å
away in a 128² frame, which the port draws whole (checked alone below).
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.render import font as t_font
from viamd_tpu_torch.render.camera import look_at, perspective
from viamd_tpu_torch.render.overlay import OverlayQueue

PICK_SHARE = 0.01


def _queues():
    from viamd_tpu.render.overlay import OverlayQueue as JQueue

    return OverlayQueue(), JQueue()


def _fill(q, case):
    if case == "primitives":
        q.add_point([0, 0, 0], pick_id=7)
        q.add_line([0, 0, 0], [5, 0, 0], radius=0.2)
        q.add_box(np.eye(3) * 10)
    elif case == "fill_and_text":
        q.add_triangle([-3, -3, 0], [3, -3, 0], [0, 3, 0], (1, 0, 0, 1), pick_id=42)
        q.add_text([0, -4, 0], "1.23 Å", (1, 1, 1, 1), pick_id=9)
    elif case in ("blend", "blend_small"):
        q.add_sphere([0, 0, -6], 3.0 if case == "blend" else 1.2, (0, 1, 0, 1))
        q.add_triangle([-3, -3, 0], [3, -3, 0], [0, 3, 0], (1, 0, 0, 0.5))
    elif case == "measurements":
        rng = np.random.RandomState(2)
        coords = rng.uniform(-4, 4, (12, 3)).astype(np.float32)
        vis = {
            "lines": [(0, 1), (2, 3)],
            "angles": [(1, 3, 6)],
            "dihedrals": [(1, 3, 6, 8)],
            "points": [4, 5],
            "triangles": [(7, 9, 10)],
            "text": [(11, "r1")],
        }
        q.add_script_visualization(vis, coords)
        q.add_box(np.diag([9.0, 8.0, 7.0]), origin=(-4.5, -4, -3.5))
    return q


def _camera(W, H):
    view = look_at(np.array([0.0, 0, 10]), np.zeros(3), np.array([0.0, 1, 0]))
    return view, perspective(np.radians(45), W / H, 0.1, 100)


@pytest.mark.parametrize("case", ["primitives", "fill_and_text", "blend", "measurements"])
def test_queue_matches_jax(case):
    tq, jq = _queues()
    _fill(tq, case)
    _fill(jq, case)
    for got, want in zip(tq.primitives(), jq.primitives()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(tq._tris) == len(jq._tris) and len(tq._texts) == len(jq._texts)
    for a, b in zip(tq._tris + tq._tri_col, jq._tris + jq._tri_col):
        assert np.array_equal(a, b)
    assert tq._tri_pick == jq._tri_pick
    for a, b in zip(tq._texts, jq._texts):
        assert np.array_equal(a[0], b[0]) and a[1:2] == b[1:2] and a[3:] == b[3:]
        assert np.array_equal(a[2], b[2])
    assert tq.is_empty() == jq.is_empty()
    if case == "primitives":
        pos, rad, col, pick = tq.primitives()
        assert pos.shape[0] > 20 and pick[0] == 7 and (pick[1:] == -1).all()
    if case == "measurements":
        assert len(tq._tris) >= 2 and any("°" in t[1] for t in tq._texts)


@pytest.mark.parametrize("case,size", [
    ("fill_and_text", (128, 128)),
    ("blend_small", (128, 128)),
    ("measurements", (160, 120)),
])
def test_render_matches_jax(case, size, one_thread):
    W, H = size
    view, proj = _camera(W, H)
    tq, jq = _queues()
    _fill(tq, case)
    _fill(jq, case)
    img, dep, pick = (t.numpy() for t in tq.render(view, proj, W, H, device="cpu"))
    jimg, jdep, jpick = (np.asarray(a) for a in jq.render(view, proj, W, H))
    assert img.shape == (H, W, 4) and pick.dtype == np.int32
    off = (pick != jpick) | (np.isfinite(dep) != np.isfinite(jdep))
    assert off.sum() <= PICK_SHARE * off.size
    same = ~off
    assert np.array_equal(img[same][:, 3], jimg[same][:, 3])
    err = np.abs(img[same] - jimg[same]).max(-1)
    assert err.max() <= 1e-2 and (err > 6e-3).sum() <= PICK_SHARE * off.size
    text_ids = {t[4] for t in tq._texts if t[4] >= 0}
    for pid in text_ids:
        m = jpick == pid
        assert np.array_equal(pick == pid, m) and np.array_equal(img[m], jimg[m])
    if case == "fill_and_text":
        assert (pick == 42).sum() > 200 and np.isfinite(dep[pick == 42]).all()
        assert (pick == 9).sum() > 20
        assert ((img[..., :3] > 0.95).all(-1) & (pick == 9)).sum() > 20
    if case == "blend_small":
        c = img[64, 64]
        assert c[0] > 0.2 and c[1] > 0.2  # red fill over green sphere
    if case == "measurements":
        white = (img[..., :3] > 0.95).all(-1) & (img[..., 3] > 0.9)
        assert white.sum() > 20


def test_render_blend_over_a_large_sphere(one_thread):
    """tests/test_app.py's blend case alone: the half-transparent fill over
    a radius-3 sphere that the port draws whole."""
    W = H = 128
    view, proj = _camera(W, H)
    img, dep, pick = (t.numpy() for t in _fill(OverlayQueue(), "blend").render(
        view, proj, W, H, device="cpu"))
    c = img[64, 64]
    assert c[0] > 0.2 and c[1] > 0.2  # red fill over green sphere
    # the sphere's silhouette: ~29 px across at 16 Å under a 45° field
    r_px = 3.0 / np.sqrt(16.0**2 - 9.0) / np.tan(np.radians(22.5)) * 64
    covered = np.isfinite(dep).sum()
    assert abs(covered - np.pi * r_px**2) < 0.05 * np.pi * r_px**2
    assert (pick == -1).all()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("depth_test,halo", [(False, True), (True, True), (True, False)])
def test_splat_text_matches_jax(depth_test, halo):
    from viamd_tpu.render import font as j_font

    for text, scale in (("1.23 Å", 2), ("φ=-57.3°", 1), ("", 2), ("Xy%", 3)):
        assert np.array_equal(t_font.text_mask(text, scale), j_font.text_mask(text, scale))
    rng = np.random.RandomState(3)
    H, W = 40, 64
    img = rng.rand(H, W, 4).astype(np.float32)
    depth = rng.uniform(1, 20, (H, W)).astype(np.float32)
    pick = rng.randint(-1, 50, (H, W)).astype(np.int32)
    want = [img.copy(), depth.copy(), pick.copy()]
    got = [torch.as_tensor(a.copy()) for a in (img, depth, pick)]
    for x, y, z, text in ((20.3, 10.7, 8.0, "12.5 Å"), (-3.0, 38.2, 15.0, "109.5°"),
                          (60.0, 20.0, 2.0, "A"), (500.0, 10.0, 5.0, "gone")):
        kw = dict(color=(0.9, 0.8, 0.1, 1.0), scale=2, pick_id=99, halo=halo,
                  depth_test=depth_test)
        j_font.splat_text(*want, x, y, z, text, **kw)
        t_font.splat_text(*got, x, y, z, text, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert (want[2] == 99).sum() > 20
