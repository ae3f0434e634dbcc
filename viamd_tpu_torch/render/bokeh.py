"""Bokeh depth of field: the reference's single-pass scatter-as-gather DOF.

Torch port of viamd_tpu/render/bokeh.py (VIAMD src/shaders/dof/dof.frag,
the Tuxedolabs single-pass bokeh, with the reference defaults focus_depth
10, focus_scale 10, viamd.h:1256-1257, and apply_dof's wiring,
src/gfx/postprocessing_utils.cpp:1516-1540): the signed circle of
confusion clamp((1/focus − 1/depth)·scale, −1, 1) scaled by MAX_BLUR_SIZE
= 15 px; a golden-angle spiral whose radius grows r += 1.5/r from 1.5;
each tap gated by a smoothstep of its own circle of confusion; near and
far layers with depth-gated weights, the near layer composited over the
far by its presence; a per-pixel random spiral phase and an output
dither from the shader's sin hash.

As in the JAX package, the spiral is one static schedule of taps for
every pixel (~74 at the reference's 15 px), a pixel's own maximum radius
masks the taps beyond it, and each tap is one bilinear gather of a packed
(rgb, depth) table. The sine of the hash is taken in float64 and rounded
once, so the CPU and the card give the same phase bit for bit
(`_glsl_sin`). It is a per-pixel pseudo-random number: the JAX package's
jitted passes round its argument otherwise (a fused multiply-add, a
division by the height turned into a multiplication), so their phases
differ from the port's at many pixels, as two GPUs' would.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from viamd_tpu_torch.ops.rdf import div_rn

GOLDEN_ANGLE = 2.39996323
MAX_BLUR_SIZE = 15.0
RAD_SCALE = 1.5

_C1, _C2 = 12.9898, 78.233


@functools.lru_cache(maxsize=None)
def _radius_schedule(max_blur: float = MAX_BLUR_SIZE):
    """The shader's data-independent spiral radii: r = 1.5; r += 1.5/r
    while r < max_blur (dof.frag:72-99; 74 taps at the reference's
    MAX_BLUR_SIZE)."""
    radii = []
    r = RAD_SCALE
    while r < max_blur:
        radii.append(r)
        r += RAD_SCALE / r
    return tuple(radii)


def _glsl_sin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sin(x·12.9898 + y·78.233) of float32 x, y: the argument in float32
    operations, the sine in float64 rounded to float32, so the hash is the
    same on every device (float32 sines differ by an ulp between
    libraries, and fract(43758.5453·sin) turns an ulp into another random
    value)."""
    a = x * _C1 + y * _C2
    return torch.sin(a.double()).float()


def _glsl_rand(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """fract(sin(dot(n, (12.9898, 78.233))) · 43758.5453) (dof.frag:22)."""
    s = _glsl_sin(x, y) * 43758.5453
    return s - torch.floor(s)


def _smoothstep(e0: float, e1: float, x):
    t = ((x - e0) / (e1 - e0)).clamp(0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _bilinear_rows(rows, X, Y, W: int, H: int):
    """Bilinear sample of packed rows (H·W, C) at float pixel-centre
    coordinates, clamp-to-edge; one gather per corner."""
    xm, ym = X - 0.5, Y - 0.5
    x0f, y0f = torch.floor(xm), torch.floor(ym)
    fx, fy = (xm - x0f)[..., None], (ym - y0f)[..., None]
    x0 = x0f.to(torch.int64).clamp(0, W - 1)
    y0 = y0f.to(torch.int64).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    v00, v10 = rows[y0 * W + x0], rows[y0 * W + x1]
    v01, v11 = rows[y1 * W + x0], rows[y1 * W + x1]
    top = v00 * (1 - fx) + v10 * fx
    bot = v01 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def bokeh_dof(
    rgb,
    view_depth,
    focus_depth: float = 10.0,
    focus_scale: float = 10.0,
    time: float = 0.0,
    dither: bool = True,
    max_blur: float = MAX_BLUR_SIZE,
):
    """(H, W, 3|4) colour + (H, W) linear view depth → bokeh-blurred
    colour (alpha passed through), on their device.

    `time` animates the spiral phase and the dither as the shader's u_time
    does (0: static). `max_blur` caps the blur radius in pixels (the
    reference: 15); a smaller one shortens the tap schedule."""
    rgb = torch.as_tensor(rgb)
    dev = rgb.device
    nch = rgb.shape[-1]
    rgb3 = rgb[..., :3]
    depth = torch.as_tensor(view_depth, device=dev)
    H, W = depth.shape
    d = torch.where(torch.isfinite(depth), depth, torch.full_like(depth, 1e8))
    d = torch.clamp_min(d, 1e-6)

    # the hash's inputs divided as on every device (ops/rdf.py::div_rn)
    u = div_rn(torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5, W).expand(H, W)
    v = div_rn(torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5, H).expand(H, W)
    inv_focus = 1.0 / focus_depth

    def signed_coc(z):
        return ((inv_focus - 1.0 / z) * focus_scale).clamp(-1.0, 1.0)

    center_coc = signed_coc(d)
    center_radius = center_coc.abs() * max_blur
    max_radius = (center_radius * 1.35 + 1.0).clamp(2.0, max_blur)

    table = torch.cat([rgb3, d[..., None]], dim=-1).reshape(-1, 4)
    near_center = center_coc < 0.0
    zero = torch.zeros_like(d)
    near_sum = torch.where(near_center[..., None], rgb3, zero[..., None])
    far_sum = torch.where(near_center[..., None], zero[..., None], rgb3)
    near_w = torch.where(near_center, zero + 1.0, zero)
    far_w = torch.where(near_center, zero, zero + 1.0)
    near_occ = zero

    ang0 = _glsl_rand(u + time, v + time) * 2.0 * np.pi
    xs = (torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5).expand(H, W)
    ys = (torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5).expand(H, W)

    for k, radius in enumerate(_radius_schedule(max_blur)):
        ang = ang0 + k * GOLDEN_ANGLE
        tx = xs + torch.cos(ang) * radius
        ty = ys + torch.sin(ang) * radius
        s = _bilinear_rows(table, tx, ty, W, H)
        s_rgb, s_d = s[..., :3], torch.clamp_min(s[..., 3], 1e-6)
        s_coc = signed_coc(s_d)
        s_radius = s_coc.abs() * max_blur
        coc_w = _smoothstep(radius - 0.5, radius + 0.5, s_radius)
        coc_w = torch.where(radius < max_radius, coc_w, zero)  # the pixel's own trip count
        is_near = s_coc < 0.0
        gate_n = _smoothstep(0.0, 0.004, d - s_d)
        w_n = coc_w * (0.2 + 0.8 * gate_n) * is_near
        gate_f = _smoothstep(0.0, 0.004, s_d - d)
        w_f = coc_w * (0.15 + 0.85 * gate_f) * (~is_near)
        near_sum = near_sum + s_rgb * w_n[..., None]
        near_w = near_w + w_n
        near_occ = near_occ + w_n
        far_sum = far_sum + s_rgb * w_f[..., None]
        far_w = far_w + w_f

    near_color = torch.where((near_w > 0.0)[..., None],
                             near_sum / torch.clamp_min(near_w, 1e-12)[..., None], rgb3)
    far_color = torch.where((far_w > 0.0)[..., None],
                            far_sum / torch.clamp_min(far_w, 1e-12)[..., None], rgb3)
    near_presence = near_occ / (near_w + far_w + 1e-5)
    near_alpha = torch.maximum(torch.where(near_center, zero + 1.0, zero), near_presence)
    near_alpha = near_alpha.clamp(0.0, 1.0)
    out = far_color + (near_color - far_color) * near_alpha[..., None]
    # in-focus early exit (dof.frag:52)
    out = torch.where((center_radius < 0.5)[..., None], rgb3, out)
    if dither:
        # rand4(tc + u_time) / 20 banding dither (dof.frag:151-153)
        sn = _glsl_sin(u + time, v + time)
        s = torch.stack([sn * 43758.5453, sn * 28001.8384, sn * 50849.4141], dim=-1)
        out = out + (s - torch.floor(s)) / 20.0
    if nch > 3:
        return torch.cat([out, rgb[..., 3:]], dim=-1)
    return out
