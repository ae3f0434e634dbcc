"""Tiled triangle rasterizer (ray cast) for ribbons, cartoon, overlay fills
and dipole arrows.

Torch port of viamd_tpu/render/triangles.py (the reference's triangle
geometry: the script visualization's triangle primitives, main.cpp:
6540-6575, immediate_draw_utils.h:51-108, and the extruded ribbon / cartoon
meshes md_gl draws, viamd.h:161-169, main.cpp:6878-6925). A frame goes
through three steps on the caller's device:

1. `bin_triangles`: each triangle's projected bounding box (the JAX rule,
   triangles.py:191-205: drawn when any vertex has view depth > 1e-2, the
   depths clamped to ≥ 1e-2 for the projection) → the 16×16 tiles it
   touches → per-tile CSR lists in ascending near depth (the least clamped
   vertex depth), ties in triangle order: the order JAX's
   np.lexsort((znear, txy)) gives (:207-209). There is no capacity: the
   JAX package keeps the nearest `max_per_tile` = 64 of a tile and drops
   the rest; the lists drop nothing;
2. `raster_triangles`: the nearest two-sided hit of every pixel's ray among
   its tile's candidates — csrc/triangles.cu on a CUDA device
   (render/cuda_triangles.py), `raster_triangles_plain` on the CPU;
3. the image: (H, W, 4) rgba (shaded or flat), (H, W) view depth (+inf
   where nothing is hit) and (H, W) int32 picks (-1 where nothing is hit).

`arrow_mesh` (the dipole arrow) is a numpy copy.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.core.tracing import section
from viamd_tpu_torch.ops.rdf import div_rn, sqrt_rn
from viamd_tpu_torch.render import cuda_triangles
from viamd_tpu_torch.render.cuda_triangles import TILE
from viamd_tpu_torch.render.raster import _csr, _depth_order

__all__ = [
    "TILE",
    "arrow_mesh",
    "bin_triangles",
    "pixel_rays",
    "raster_triangles",
    "raster_triangles_plain",
    "ray_test",
    "render_triangles",
    "triangle_terms",
    "view_transform",
]

LIGHT = (0.57735, 0.57735, 0.57735)


def arrow_mesh(
    beg: np.ndarray,
    end: np.ndarray,
    radius: float,
    head_radius: float | None = None,
    body_fraction: float = 0.8,
    segments: int = 16,
) -> np.ndarray:
    """World-space triangle mesh of an arrow: cylinder body over the first
    `body_fraction` of beg→end plus a cone head (the reference's dipole-
    moment representation draws immediate::cylinder + immediate::cone with
    head radius 1.5× body, main.cpp:6939-6953).
    Returns (T, 3, 3) triangles."""
    beg = np.asarray(beg, np.float64)
    end = np.asarray(end, np.float64)
    head_radius = 1.5 * radius if head_radius is None else head_radius
    axis = end - beg
    ln = np.linalg.norm(axis)
    if ln < 1e-12:
        return np.zeros((0, 3, 3), np.float32)
    az = axis / ln
    ref = np.array([1.0, 0, 0]) if abs(az[0]) < 0.9 else np.array([0, 1.0, 0])
    ax = np.cross(az, ref)
    ax /= np.linalg.norm(ax)
    ay = np.cross(az, ax)
    mid = beg + axis * body_fraction
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.cos(ang)[:, None] * ax + np.sin(ang)[:, None] * ay  # (S,3)
    b0 = beg + ring * radius
    b1 = mid + ring * radius
    h0 = mid + ring * head_radius
    tris = []
    for i in range(segments):
        j = (i + 1) % segments
        # cylinder side (two triangles)
        tris.append([b0[i], b1[i], b0[j]])
        tris.append([b0[j], b1[i], b1[j]])
        # cone side
        tris.append([h0[i], end, h0[j]])
        # cone base annulus + body base cap
        tris.append([b1[i], h0[i], b1[j]])
        tris.append([b1[j], h0[i], h0[j]])
        tris.append([b0[i], b0[j], beg])
    return np.asarray(tris, np.float32)


def view_transform(tris, view, *, device) -> torch.Tensor:
    """World-space triangles (T, 3, 3) (numpy or a tensor) → view space, a
    float32 tensor on `device`; the product written out elementwise, as
    render/raster.py::build_scene transforms atoms."""
    v = torch.as_tensor(tris, dtype=torch.float32, device=torch.device(device))
    vm = np.asarray(view, np.float32)
    return torch.stack(
        [
            v[..., 0] * float(vm[j, 0]) + v[..., 1] * float(vm[j, 1])
            + v[..., 2] * float(vm[j, 2]) + float(vm[j, 3])
            for j in range(3)
        ],
        dim=-1,
    ).contiguous()


def bin_triangles(v: torch.Tensor, p00: float, p11: float, width: int,
                  height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile CSR lists (start (tiles + 1,) int32, list int32) of the
    view-space triangles v (T, 3, 3) whose projected box touches the tile,
    by the JAX binning rule (float32, as numpy computes it there); each
    list in ascending near depth, ties in triangle order. One host sync,
    for the list size."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    z = -v[..., 2]  # (T, 3)
    front = (z > 1e-2).any(dim=1)
    zc = z.clamp_min(1e-2)
    sx = ((v[..., 0] / zc * p00 * 0.5 + 0.5) * width)
    sy = ((-v[..., 1] / zc * p11 * 0.5 + 0.5) * height)

    def tile_of(s, n):
        return torch.floor(s / TILE).clamp(0, n - 1).long()

    box = (
        tile_of(sx.amin(1), tiles_x), tile_of(sx.amax(1), tiles_x),
        tile_of(sy.amin(1), tiles_y), tile_of(sy.amax(1), tiles_y),
    )
    wx = box[1] - box[0] + 1
    cnt = torch.where(front, wx * (box[3] - box[2] + 1), torch.zeros_like(wx))
    total = int(cnt.sum())
    order = _depth_order(zc.amin(1))
    return _csr(box, cnt, wx, order, total, tiles_x, tiles_x * tiles_y)


def pixel_rays(ix: torch.Tensor, iy: torch.Tensor, width: int, height: int,
               p00: float, p11: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) of the rays through pixels (ix, iy) (integer tensors), as
    the kernel computes them: px = ix + 0.5, dx = (px / W · 2 − 1) / p00,
    dy = (1 − py / H · 2) / p11; the ray is (dx, dy, −1) from the eye."""
    f32 = torch.float32
    px = ix.to(f32) + 0.5
    py = iy.to(f32) + 0.5
    dx = div_rn(div_rn(px, float(width)) * 2.0 - 1.0, p00)
    dy = div_rn(1.0 - div_rn(py, float(height)) * 2.0, p11)
    return dx, dy


def _tile_rays(width: int, height: int, p00: float, p11: float, dev):
    """pixel_rays of every pixel of every tile, (tiles, 256)."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    lane = torch.arange(TILE * TILE, device=dev)
    tid = torch.arange(tiles_x * tiles_y, device=dev)
    ix = ((tid % tiles_x) * TILE)[:, None] + (lane % TILE)[None, :]
    iy = ((tid // tiles_x) * TILE)[:, None] + (lane // TILE)[None, :]
    return pixel_rays(ix, iy, width, height, p00, p11)


def _cross(a, b):
    """jnp.cross's component formula on 3-tuples of tensors."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0


def _dot(a, b):
    """Summed left to right."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def triangle_terms(tri: torch.Tensor) -> dict:
    """What the kernel stages once per candidate, for every triangle of
    tri (T, 3, 3): e1, e2, tvec = −v0, qvec = tvec × e1, tnum = qvec·e2
    and the unit face normal n, each a 3-tuple of (T,) tensors (tnum one
    tensor)."""
    v0 = tuple(tri[:, 0, j] for j in range(3))
    e1 = tuple(tri[:, 1, j] - v0[j] for j in range(3))
    e2 = tuple(tri[:, 2, j] - v0[j] for j in range(3))
    tv = tuple(-c for c in v0)
    qv = _cross(tv, e1)
    nv = _cross(e1, e2)
    nl = sqrt_rn(_dot(nv, nv)).clamp_min(1e-12)
    return dict(e1=e1, e2=e2, tv=tv, qv=qv, tnum=_dot(qv, e2),
                n=tuple(c / nl for c in nv))


def ray_test(terms: dict, d: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """(t, hit) of rays d = (dx, dy, dz) against triangles' `terms`
    (broadcasting), in the kernel's operations: Möller-Trumbore from the
    eye, two-sided; hit means |det| > 1e-12, u ≥ 0, v ≥ 0, u + v ≤ 1 and
    t > 1e-3 (the caller adds t < best)."""
    pv = _cross(d, terms["e2"])
    det = _dot(pv, terms["e1"])
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    u = _dot(terms["tv"], pv) * inv
    w = _dot(terms["qv"], d) * inv
    t = terms["tnum"] * inv
    return t, ok & (u >= 0.0) & (w >= 0.0) & (u + w <= 1.0) & (t > 1e-3)


def raster_triangles_plain(tri, color, pick, start, lst, width: int,
                           height: int, p00: float, p11: float, light,
                           shade: bool):
    """The plain PyTorch version of csrc/triangles.cu on (tiles, 256) pixel
    state: each tile's list padded to the longest, one slot k of every tile
    per step (the XLA kernel's `fori_loop`, triangles.py:47-95), the
    kernel's operations in its order (`triangle_terms`, `ray_test`), strict
    `t < best` (the first candidate in list order keeps a tie), then the
    shading (:97-116)."""
    dev = tri.device
    f32 = torch.float32
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    ntiles = tiles_x * tiles_y
    dx, dy = _tile_rays(width, height, p00, p11, dev)
    d = (dx, dy, torch.full_like(dx, -1.0))
    terms = triangle_terms(tri)

    bt = torch.full(dx.shape, float("inf"), dtype=f32, device=dev)
    bi = torch.full(dx.shape, -1, dtype=torch.long, device=dev)
    bn = [torch.zeros_like(dx) for _ in range(3)]
    count = start[1:] - start[:-1]
    k_max = int(count.max()) if ntiles else 0
    for k in range(k_max):
        valid = (count > k)[:, None]
        pos = (start[:-1] + k).clamp(max=max(lst.shape[0] - 1, 0))
        ids = lst[pos].long()
        at = {key: (tuple(c[ids][:, None] for c in val) if isinstance(val, tuple)
                    else val[ids][:, None]) for key, val in terms.items()}
        t, ok = ray_test(at, d)
        hit = valid & ok & (t < bt)
        flip = _dot(at["n"], d) > 0.0
        bt = torch.where(hit, t, bt)
        bi = torch.where(hit, ids[:, None], bi)
        for j in range(3):
            nj = at["n"][j]
            bn[j] = torch.where(hit, torch.where(flip, -nj, nj), bn[j])

    hitm = bi >= 0
    safe = bi.clamp_min(0)
    c = color[safe]  # (tiles, 256, 4)
    rgb = [c[..., j] for j in range(3)]
    if shade:
        lx, ly, lz = (float(np.float32(v)) for v in light)
        nd = sqrt_rn(_dot(d, d))
        dn = tuple(comp / nd for comp in d)
        ndotl = (bn[0] * lx + bn[1] * ly + bn[2] * lz).clamp_min(0.0)
        h = (lx - dn[0], ly - dn[1], lz - dn[2])
        hl = sqrt_rn(_dot(h, h)).clamp_min(1e-12)
        h = tuple(comp / hl for comp in h)
        s = _dot(bn, h).clamp_min(0.0)
        for _ in range(5):  # x^32 as five squarings, as jnp lowers x ** 32
            s = s * s
        lum = 0.25 + 0.75 * ndotl
        spec = 0.25 * s
        rgb = [comp * lum + spec for comp in rgb]
    zero = torch.zeros((), dtype=f32, device=dev)
    out = torch.stack(
        [torch.where(hitm, comp.clamp(0.0, 1.0), zero) for comp in rgb]
        + [torch.where(hitm, c[..., 3], zero)],
        dim=-1,
    )
    depth = torch.where(hitm, bt, torch.full_like(bt, float("inf")))
    out_pick = torch.where(hitm, pick[safe], torch.full_like(pick[safe], -1))

    def image(tiles, ch):  # (tiles, 256, *ch) → (H, W, *ch)
        a = tiles.reshape(tiles_y, tiles_x, TILE, TILE, *ch)
        a = a.transpose(1, 2).reshape(tiles_y * TILE, tiles_x * TILE, *ch)
        return a[:height, :width].contiguous()

    return image(out, (4,)), image(depth, ()), image(out_pick, ())


def raster_triangles(tri, color, pick, start, lst, width: int, height: int,
                     p00: float, p11: float, light=LIGHT, shade: bool = True):
    """Ray cast every tile → (rgba, depth, pick): the kernel on CUDA, the
    plain version on the CPU; any other device raises."""
    dev = tri.device
    if dev.type == "cpu":
        return raster_triangles_plain(tri, color, pick, start, lst, width, height,
                                      p00, p11, light, shade)
    if dev.type != "cuda":
        raise ValueError(f"no triangle raster for device {dev}")
    return cuda_triangles.raster(tri, color, pick, start, lst, width, height,
                                 p00, p11, light, shade)


def render_triangles(
    verts_view,  # (T, 3, 3) view-space vertices
    colors,  # (T, 4) rgba per triangle
    pick_ids,  # (T,) int (≥ 0; -1 disables picking)
    proj,
    width: int,
    height: int,
    light=LIGHT,
    shade: bool = True,
    *,
    device,
):
    """→ ((H, W, 4) rgba, (H, W) view depth, (H, W) int32 pick ids), tensors
    on `device`. Inputs may be numpy arrays or tensors."""
    dev = torch.device(device)
    f32 = torch.float32
    T = int(len(verts_view))
    if T == 0:
        return (
            torch.zeros((height, width, 4), dtype=f32, device=dev),
            torch.full((height, width), float("inf"), dtype=f32, device=dev),
            torch.full((height, width), -1, dtype=torch.int32, device=dev),
        )
    v = torch.as_tensor(verts_view, dtype=f32, device=dev).contiguous()
    col = torch.as_tensor(colors, dtype=f32, device=dev).contiguous()
    pk = torch.as_tensor(pick_ids, device=dev).to(torch.int32).contiguous()
    p = np.asarray(proj, np.float32)
    p00, p11 = float(p[0, 0]), float(p[1, 1])
    with section("triangles.bin"):
        start, lst = bin_triangles(v, p00, p11, width, height)
    with section("triangles.kernel"):
        return raster_triangles(v, col, pk, start, lst, width, height, p00, p11,
                                light, shade)
