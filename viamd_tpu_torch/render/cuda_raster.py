"""Tile ray cast of sphere and half-capsule impostors: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of viamd_tpu/render/pallas_raster.py (`raster_rows_pl`, whose
Pallas kernel `_raster_row_kernel` is replaced by csrc/raster.cu).

Inputs are per-primitive attribute rows plus per-tile CSR candidate lists
(render/raster.py::bin_primitives builds them):

    sph     (ns, 4) f32    view-space centre x y z, radius
    sph_ci  (ns, 2) int32  packed 0xRRGGBB colour, pick id
    cyl     (nc, 8) f32    view-space p0 x y z, unit axis x y z, length, radius
    cyl_ci  (nc, 2) int32  packed colour, pick id
    s_start, c_start (T + 1,) int32 list offsets; s_list, c_list int32 ids

Outputs: rgba (H, W, 4) f32, view depth (H, W) f32 (+inf where nothing is
hit), pick (H, W) int32 (-1 where nothing is hit).

`raster_tiles` takes the plain version, `raster_tiles_plain`, for CPU
tensors only; for CUDA tensors it launches the kernel or raises. Both keep
the nearest hit under one tie rule that does not depend on list order: a
sphere replaces the current hit when t < bt, or t == bt and its row in
`sph` is lower than the winner's; capsules come after spheres, tie among
themselves by their row in `cyl` and need t < bt to replace a sphere. Both
evaluate every expression in the same order with correctly rounded float32
operations, so they agree exactly in pick, alpha and depth; rgb differs
only where `powf` and `torch.pow` round differently.

The kernel culls front to back and so needs each tile's lists in ascending
order of the primitives' near depths (`near_depth_spheres`,
`near_depth_capsules`; bin_primitives sorts by them). It stops testing a
pixel's list once `cull_depth(tlo)` of the next candidate exceeds the
pixel's nearest hit. The plain version tests every candidate, in any list
order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from viamd_tpu_torch.cuda_build import Library, check_tensor as _check
from viamd_tpu_torch.ops.rdf import sqrt_rn

__all__ = [
    "TILE",
    "CULL_ABS",
    "CULL_REL",
    "Shading",
    "cull_depth",
    "launches",
    "near_depth_capsules",
    "near_depth_spheres",
    "raster_tiles",
    "raster_tiles_plain",
    "shading_params",
]

TILE = 16  # pixels per screen tile side; one kernel block per tile

# The cull margin (csrc/raster.cu::cull_depth): a candidate with near depth
# tlo is skipped once tlo·(1 ∓ CULL_REL) − CULL_ABS exceeds the pixel's
# nearest hit, so a computed hit t may fall below tlo by up to 4e-3 of the
# depth plus 1e-3 Å without being missed (the source note says why that is
# safe; tests/test_torch_render.py::test_cull_margin holds it).
CULL_REL = 4e-3
CULL_ABS = 1e-3

# kernel launches since import (reset freely by callers that count a run)
launches = 0


class Shading(NamedTuple):
    """Camera and shading constants as float32 values, rounded as the TPU
    kernel rounds its Python constants (`shading_params`)."""

    p00: float
    p11: float
    p02: float
    p12: float
    two_over_w: float
    two_over_h: float
    ambient: float
    one_m_amb: float
    inv255: float
    specular: float
    shininess: float
    lx: float
    ly: float
    lz: float
    bg_r: float
    bg_g: float
    bg_b: float


_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("raster", ("raster.cu",), {
    "raster_launch": (_i, [_p] * 8 + [_i] * 4 + [_p] * 5),
    "raster_num_params": (_i, []),
}, check=lambda lib: lib.raster_num_params() == len(Shading._fields))


def near_depth_spheres(sph: torch.Tensor) -> torch.Tensor:
    """(ns,) conservative near view depth of each sphere, −cz − r, in the
    kernel's float32 operations."""
    return -sph[:, 2] - sph[:, 3]


def near_depth_capsules(cyl: torch.Tensor) -> torch.Tensor:
    """(nc,) conservative near view depth of each half-capsule,
    min(−z0, −z1) − r with z1 = qz + len·az, in the kernel's float32
    operations."""
    z1 = cyl[:, 2] + cyl[:, 6] * cyl[:, 5]
    return torch.minimum(-cyl[:, 2], -z1) - cyl[:, 7]


def cull_depth(tlo: torch.Tensor) -> torch.Tensor:
    """tlo − margin(tlo) as the kernel rounds it: tlo·(1 − CULL_REL) −
    CULL_ABS for tlo ≥ 0, tlo·(1 + CULL_REL) − CULL_ABS below; monotone in
    tlo, so a list sorted by tlo is sorted by it too."""
    f = lambda v: torch.tensor(np.float32(v), device=tlo.device)  # noqa: E731
    scale = torch.where(tlo >= 0.0, f(1.0 - CULL_REL), f(1.0 + CULL_REL))
    return tlo * scale - f(CULL_ABS)


def _grid(width: int, height: int) -> tuple[int, int]:
    return -(-width // TILE), -(-height // TILE)


def raster_tiles(
    sph, sph_ci, cyl, cyl_ci, s_start, s_list, c_start, c_list,
    width: int, height: int, shading: Shading,
):
    """Ray cast every tile → (rgba, depth, pick): the kernel on CUDA, the
    plain version on the CPU. The kernel needs each tile's lists in
    ascending near depth (bin_primitives' order); the plain version takes
    any order."""
    global launches
    dev = sph.device
    if dev.type == "cpu":
        return raster_tiles_plain(
            sph, sph_ci, cyl, cyl_ci, s_start, s_list, c_start, c_list,
            width, height, shading,
        )
    if dev.type != "cuda":
        raise ValueError(f"no raster route for device {dev}")
    tiles_x, tiles_y = _grid(width, height)
    ntiles = tiles_x * tiles_y
    ns, nc = sph.shape[0], cyl.shape[0]
    _check(sph, "sph", torch.float32, (ns, 4), dev)
    _check(sph_ci, "sph_ci", torch.int32, (ns, 2), dev)
    _check(cyl, "cyl", torch.float32, (nc, 8), dev)
    _check(cyl_ci, "cyl_ci", torch.int32, (nc, 2), dev)
    _check(s_start, "s_start", torch.int32, (ntiles + 1,), dev)
    _check(s_list, "s_list", torch.int32, (s_list.shape[0],), dev)
    _check(c_start, "c_start", torch.int32, (ntiles + 1,), dev)
    _check(c_list, "c_list", torch.int32, (c_list.shape[0],), dev)
    lib = LIBRARY.load()
    rgba = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    pick = torch.empty((height, width), dtype=torch.int32, device=dev)
    params = (ctypes.c_float * len(shading))(*shading)
    err = lib.raster_launch(
        sph.data_ptr(), sph_ci.data_ptr(), cyl.data_ptr(), cyl_ci.data_ptr(),
        s_start.data_ptr(), s_list.data_ptr(), c_start.data_ptr(),
        c_list.data_ptr(), width, height, tiles_x, tiles_y,
        ctypes.cast(params, ctypes.c_void_p), rgba.data_ptr(),
        depth.data_ptr(), pick.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")
    launches += 1
    return rgba, depth, pick


def _slot(start, lst, k):
    """Candidate k of every tile's list → (ids clamped in range, valid)."""
    count = start[1:] - start[:-1]
    valid = count > k
    pos = (start[:-1] + k).clamp(max=max(lst.shape[0] - 1, 0))
    ids = lst[pos] if lst.shape[0] else torch.zeros_like(pos)
    return ids.long(), valid


def raster_tiles_plain(
    sph, sph_ci, cyl, cyl_ci, s_start, s_list, c_start, c_list,
    width: int, height: int, shading: Shading,
):
    """The plain PyTorch version of csrc/raster.cu on (T, 256) pixel state:
    each tile's list padded to the longest, one slot k of every tile per
    step (the XLA engine's loop, raster.py:580-697), the kernel's tests,
    tie rule and shading, with no culling."""
    s = shading
    dev = sph.device
    f32 = torch.float32
    tiles_x, tiles_y = _grid(width, height)
    ntiles = tiles_x * tiles_y
    lane = torch.arange(TILE * TILE, device=dev)
    tid = torch.arange(ntiles, device=dev)
    px = ((tid % tiles_x) * TILE)[:, None] + (lane % TILE)[None, :]
    py = ((tid // tiles_x) * TILE)[:, None] + (lane // TILE)[None, :]
    one = torch.ones((), dtype=f32, device=dev)
    inv00 = one / s.p00
    inv11 = one / s.p11
    dx = ((px.to(f32) + 0.5) * s.two_over_w - 1.0 + s.p02) * inv00
    dy = ((py.to(f32) + 0.5) * s.two_over_h - 1.0 + s.p12) * inv11
    dd = dx * dx + dy * dy + 1.0
    inv_dd = 1.0 / dd

    shape = dx.shape
    bt = torch.full(shape, 1e30, dtype=f32, device=dev)
    bid = torch.full(shape, -1, dtype=torch.int32, device=dev)
    bcol = torch.zeros(shape, dtype=torch.int32, device=dev)
    hx = torch.zeros(shape, dtype=f32, device=dev)
    hy = torch.zeros(shape, dtype=f32, device=dev)
    hz = torch.zeros(shape, dtype=f32, device=dev)
    hr = torch.ones(shape, dtype=f32, device=dev)
    bi = torch.full(shape, -1, dtype=torch.long, device=dev)  # winner's row

    k_max = int((s_start[1:] - s_start[:-1]).max()) if ntiles else 0
    for k in range(k_max):
        ids, valid = _slot(s_start, s_list, k)
        c = sph[ids]  # (T, 4)
        ci = sph_ci[ids]
        cx, cy, cz, rk = (c[:, j : j + 1] for j in range(4))
        cc = cx * cx + cy * cy + cz * cz - rk * rk
        dc = dx * cx + dy * cy - cz
        disc = dc * dc - dd * cc
        t = (dc - sqrt_rn(disc.clamp_min(0.0))) * inv_dd
        win = (t < bt) | ((t == bt) & (ids[:, None] < bi))
        ok = valid[:, None] & (disc > 0.0) & (t > 1e-6) & win
        bt = torch.where(ok, t, bt)
        bi = torch.where(ok, ids[:, None], bi)
        bid = torch.where(ok, ci[:, 1:2], bid)
        bcol = torch.where(ok, ci[:, 0:1], bcol)
        hx = torch.where(ok, cx, hx)
        hy = torch.where(ok, cy, hy)
        hz = torch.where(ok, cz, hz)
        hr = torch.where(ok, rk, hr)

    bi = torch.full(shape, -1, dtype=torch.long, device=dev)  # a sphere ties no capsule
    k_max = int((c_start[1:] - c_start[:-1]).max()) if ntiles else 0
    for k in range(k_max):
        ids, valid = _slot(c_start, c_list, k)
        q = cyl[ids]  # (T, 8)
        ci = cyl_ci[ids]
        qx, qy, qz, ax, ay, az, ln, rr = (q[:, j : j + 1] for j in range(8))
        pa = qx * ax + qy * ay + qz * az
        cc2 = qx * qx + qy * qy + qz * qz - pa * pa - rr * rr
        da = dx * ax + dy * ay - az
        dp = dx * qx + dy * qy - qz
        A = (dd - da * da).clamp_min(1e-9)
        Bq = dp - da * pa
        disc = Bq * Bq - A * cc2
        t = (Bq - sqrt_rn(disc.clamp_min(0.0))) / A
        sax = t * da - pa
        win = (t < bt) | ((t == bt) & (ids[:, None] < bi))
        ok = (
            valid[:, None] & (disc > 0.0) & (t > 1e-6) & win
            & (sax >= 0.0) & (sax <= ln)
        )
        inv = 1.0 / rr.clamp_min(1e-12)
        bt = torch.where(ok, t, bt)
        bi = torch.where(ok, ids[:, None], bi)
        bid = torch.where(ok, ci[:, 1:2], bid)
        bcol = torch.where(ok, ci[:, 0:1], bcol)
        hx = torch.where(ok, (dx * t - qx - sax * ax) * inv, hx)
        hy = torch.where(ok, (dy * t - qy - sax * ay) * inv, hy)
        hz = torch.where(ok, (-t - qz - sax * az) * inv, hz)
        hr = torch.where(ok, -1.0, hr)

    # resolve the winner's normal once per pixel, then shade
    is_norm = hr < 0.0
    inv = 1.0 / hr.clamp_min(1e-12)
    nx = torch.where(is_norm, hx, (dx * bt - hx) * inv)
    ny = torch.where(is_norm, hy, (dy * bt - hy) * inv)
    nz = torch.where(is_norm, hz, (-bt - hz) * inv)
    ri = ((bcol >> 16) & 255).to(f32)
    gi = ((bcol >> 8) & 255).to(f32)
    bi = (bcol & 255).to(f32)
    ndl = (nx * s.lx + ny * s.ly + nz * s.lz).clamp_min(0.0)
    vn = 1.0 / sqrt_rn(dd)
    hvx = s.lx + -dx * vn
    hvy = s.ly + -dy * vn
    hvz = s.lz + vn
    hn = 1.0 / sqrt_rn((hvx * hvx + hvy * hvy + hvz * hvz).clamp_min(1e-24))
    ndh = ((nx * hvx + ny * hvy + nz * hvz) * hn).clamp_min(0.0)
    lum = (s.ambient + s.one_m_amb * ndl) * s.inv255
    spec = s.specular * torch.pow(ndh, s.shininess)
    hit = bid >= 0
    bg = torch.tensor([s.bg_r, s.bg_g, s.bg_b], dtype=f32, device=dev)
    rgb = torch.where(
        hit[..., None],
        torch.stack([ri * lum + spec, gi * lum + spec, bi * lum + spec], -1),
        bg,
    )
    rgba = torch.cat([rgb, hit.to(f32)[..., None]], -1)
    depth = torch.where(hit, bt, torch.full_like(bt, float("inf")))

    def image(tiles, ch):  # (T, 256, *ch) → (H, W, *ch)
        a = tiles.reshape(tiles_y, tiles_x, TILE, TILE, *ch)
        a = a.transpose(1, 2).reshape(tiles_y * TILE, tiles_x * TILE, *ch)
        return a[:height, :width].contiguous()

    return image(rgba, (4,)), image(depth, ()), image(bid, ())


def shading_params(proj, width: int, height: int, ambient: float,
                   specular: float, shininess: float, light_dir,
                   background) -> Shading:
    """Round the camera and shading constants to float32 as the TPU kernel
    does: Python-float expressions are evaluated in double and rounded once
    (pallas_raster.py:141-147, :453-459); the light is normalized in
    float32 numpy (raster.py:257-258)."""
    f = lambda v: float(np.float32(v))  # noqa: E731
    p = np.asarray(proj, np.float32)
    lt = np.asarray(light_dir, np.float32)
    lt = lt / np.linalg.norm(lt)
    bgr, bgg, bgb, bga = (float(v) for v in background)
    return Shading(
        f(p[0, 0]), f(p[1, 1]), f(p[0, 2]), f(p[1, 2]),
        f(2.0 / width), f(2.0 / height),
        f(ambient), f(1.0 - ambient), f(1.0 / 255.0), f(specular),
        f(shininess), f(lt[0]), f(lt[1]), f(lt[2]),
        f(bgr * bga), f(bgg * bga), f(bgb * bga),
    )
