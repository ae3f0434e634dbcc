"""Postprocess pipeline: tonemaps, ambient occlusion, motion blur, depth of
field, compose, FXAA, sharpen and temporal accumulation.

Torch port of viamd_tpu/render/postprocess.py (the reference's pass order,
src/gfx/postprocessing_utils.cpp:1938-2171): the five tonemaps, depth
utilities (`linearize_depth`, `normals_from_depth`), the depth-only `ssao`,
the motion blur (`velocity_dilate`, `motion_blur`, `velocity_image`),
`sharpen`, the cheap `fxaa` and `depth_of_field` approximations,
`TAAState` / `taa_accumulate`, and `execute`, the pass chain `Session.render`
runs on a rendered frame, on the frame's device: ambient occlusion (HBAO
when a projection is given, render/hbao.py), motion blur, bokeh depth of
field (render/bokeh.py), tonemap, background compose, FXAA 3.11
(render/fxaa.py), sharpen. The velocity-reprojected TAA resolve is
render/taa.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from viamd_tpu_torch.core.tracing import section
from viamd_tpu_torch.render.bokeh import bokeh_dof
from viamd_tpu_torch.render.fxaa import _luma, fxaa311
from viamd_tpu_torch.render.hbao import hbao

# -- tonemap family -----------------------------------------------------------


def tonemap_passthrough(rgb):
    return rgb.clamp(0.0, 1.0)


def tonemap_exposure_gamma(rgb, exposure=1.0, gamma=2.2):
    return (1.0 - torch.exp(-rgb * exposure)).clamp(0.0, 1.0) ** (1.0 / gamma)


def tonemap_aces(rgb):
    """ACES filmic fit."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = rgb.clamp_min(0.0)
    return ((x * (a * x + b)) / (x * (c * x + d) + e)).clamp(0.0, 1.0)


def _uncharted_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def tonemap_uncharted2(rgb, exposure=2.0, white=11.2):
    x = _uncharted_partial(rgb.clamp_min(0.0) * exposure)
    w = _uncharted_partial(torch.tensor(white, dtype=torch.float32, device=rgb.device))
    return (x / w).clamp(0.0, 1.0) ** (1 / 2.2)


def tonemap_hejl_dawson(rgb):
    x = (rgb - 0.004).clamp_min(0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


TONEMAPS = {
    "passthrough": tonemap_passthrough,
    "exposure_gamma": tonemap_exposure_gamma,
    "aces": tonemap_aces,
    "uncharted2": tonemap_uncharted2,
    "hejl_dawson": tonemap_hejl_dawson,
}


# -- depth utilities ----------------------------------------------------------


def linearize_depth(depth, znear, zfar):
    """+inf-padded view depth → linear [0, 1] view depth."""
    d = torch.where(torch.isfinite(depth), depth, torch.full_like(depth, zfar))
    return ((d - znear) / max(zfar - znear, 1e-6)).clamp(0.0, 1.0)


def normals_from_depth(view_depth, proj):
    """(H, W, 3) view-space normals from an (H, W) view depth buffer
    (screen-space derivatives)."""
    H, W = view_depth.shape
    dev = view_depth.device
    p = np.asarray(proj, np.float32)
    d = torch.where(
        torch.isfinite(view_depth), view_depth, torch.full_like(view_depth, 1e6)
    )
    px = (torch.arange(W, device=dev) + 0.5) / W * 2 - 1
    py = (torch.arange(H, device=dev) + 0.5) / H * 2 - 1
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    vx = gx / float(p[0, 0]) * d
    vy = gy / float(p[1, 1]) * d
    pt = torch.stack([vx, vy, -d], -1)
    ddx = torch.diff(pt, dim=1, append=pt[:, -1:])
    ddy = torch.diff(pt, dim=0, append=pt[-1:, :])
    n = torch.linalg.cross(ddx, ddy, dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-9)


# -- SSAO (depth-only; HBAO is render/hbao.py) ---------------------------------


def ssao(view_depth, strength=1.0, radius_px: int = 8, n_samples: int = 8):
    """Screen-space AO from the depth buffer alone: horizon-style occlusion
    from a fixed spiral sample pattern, then a 5-tap box blur."""
    d = torch.where(
        torch.isfinite(view_depth), view_depth, torch.full_like(view_depth, 1e6)
    )
    occl = torch.zeros_like(d)
    golden = 2.399963
    for k in range(n_samples):
        ang = k * golden
        r = radius_px * (k + 1) / n_samples
        dy, dx = int(round(np.sin(ang) * r)), int(round(np.cos(ang) * r))
        shifted = torch.roll(d, (dy, dx), dims=(0, 1))
        delta = d - shifted  # positive: the neighbour is closer, occludes
        occl = occl + (delta / (0.05 * d + 1e-3)).clamp(0.0, 1.0) * torch.exp(
            -delta.abs() / (d * 0.2 + 1e-3)
        )
    ao = (1.0 - strength * occl / n_samples).clamp(0.0, 1.0)
    return (
        ao
        + torch.roll(ao, 1, 0) + torch.roll(ao, -1, 0)
        + torch.roll(ao, 1, 1) + torch.roll(ao, -1, 1)
    ) / 5.0


# -- cheap FXAA and DOF approximations -------------------------------------------


def fxaa(rgb):
    """Simplified FXAA: a luma-gradient-directed blend with the 4-neighbour
    mean (the quality knee of FXAA 3.11 without its search loop; the
    pipeline runs `fxaa311`)."""
    luma = _luma(rgb[..., :3])
    lN, lS = torch.roll(luma, 1, 0), torch.roll(luma, -1, 0)
    lW, lE = torch.roll(luma, 1, 1), torch.roll(luma, -1, 1)
    lmin = torch.minimum(luma, torch.minimum(torch.minimum(lN, lS), torch.minimum(lW, lE)))
    lmax = torch.maximum(luma, torch.maximum(torch.maximum(lN, lS), torch.maximum(lW, lE)))
    contrast = lmax - lmin
    edge = contrast > torch.clamp_min(lmax * 0.125, 0.0312)
    blur = (
        rgb
        + torch.roll(rgb, 1, 0) + torch.roll(rgb, -1, 0)
        + torch.roll(rgb, 1, 1) + torch.roll(rgb, -1, 1)
    ) / 5.0
    w = torch.where(edge, (contrast * 4.0).clamp(0.0, 0.75), torch.zeros_like(contrast))
    return rgb * (1 - w[..., None]) + blur * w[..., None]


def depth_of_field(rgb, view_depth, focus_depth, focus_scale=0.05, max_radius: int = 6):
    """Gather DOF: widening 8-tap ring blurs blended by the circle of
    confusion (the pipeline runs render/bokeh.py's `bokeh_dof`)."""
    d = torch.where(torch.isfinite(view_depth), view_depth, torch.full_like(view_depth, 1e6))
    focus = np.float32(focus_depth)
    den = float(focus * np.float32(focus_scale) + np.float32(1e-6))  # float32, as traced
    coc = ((d - float(focus)).abs() / den).clamp(0, 1)
    acc = rgb
    taps = 1.0
    for r in range(1, max_radius + 1):
        ring = (
            torch.roll(rgb, (r, 0), (0, 1)) + torch.roll(rgb, (-r, 0), (0, 1))
            + torch.roll(rgb, (0, r), (0, 1)) + torch.roll(rgb, (0, -r), (0, 1))
            + torch.roll(rgb, (r, r), (0, 1)) + torch.roll(rgb, (-r, -r), (0, 1))
            + torch.roll(rgb, (r, -r), (0, 1)) + torch.roll(rgb, (-r, r), (0, 1))
        ) / 8.0
        t = (coc * max_radius - (r - 1)).clamp(0.0, 1.0)[..., None]
        acc = acc + ring * t
        taps = taps + t
    return acc / taps


# -- static temporal accumulation ---------------------------------------------------


@dataclass
class TAAState:
    history: torch.Tensor | None = None
    count: int = 0


def taa_accumulate(state: TAAState, rgb, alpha=0.1) -> torch.Tensor:
    """Exponential history blend of Halton-jittered renders
    (camera.taa_jitter_sequence): a converging average for the first
    samples, exponential after — the reference's screenshot accumulation
    (main.cpp:6794-6820). The history is a tensor on the frames' device."""
    rgb = torch.as_tensor(rgb)
    if state.history is None or state.history.shape != rgb.shape:
        state.history = rgb.clone()
        state.count = 1
        return state.history
    w = max(alpha, 1.0 / (state.count + 1))
    state.history = state.history * (1 - w) + rgb * w
    state.count += 1
    return state.history


# -- motion blur (temporal.frag + velocity/blit_tilemax/neighbormax) ----------------


def velocity_dilate(velocity, tile: int = 20):
    """Tile-max + 3×3 neighbour-max dominant velocity (the reference's
    blit_tilemax/blit_neighbormax passes): per tile² block the
    largest-magnitude velocity (the first of equals), then the largest of
    the 3×3 neighbouring tiles (wrapping at the edges), back at pixel
    resolution. velocity: (H, W, 2) in pixels."""
    H, W, _ = velocity.shape
    Ht, Wt = -(-H // tile), -(-W // tile)
    v = torch.nn.functional.pad(velocity, (0, 0, 0, Wt * tile - W, 0, Ht * tile - H))
    v = v.reshape(Ht, tile, Wt, tile, 2).permute(0, 2, 1, 3, 4).reshape(Ht, Wt, tile * tile, 2)
    mag = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    best = mag.argmax(dim=-1)
    tmax = torch.gather(v, 2, best[..., None, None].expand(Ht, Wt, 1, 2))[:, :, 0]
    nmag = tmax[..., 0] * tmax[..., 0] + tmax[..., 1] * tmax[..., 1]
    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    cv = torch.stack([torch.roll(tmax, sh, (0, 1)) for sh in shifts])  # (9, Ht, Wt, 2)
    cm = torch.stack([torch.roll(nmag, sh, (0, 1)) for sh in shifts])
    pick = cm.argmax(dim=0)
    nmax = torch.gather(cv, 0, pick[None, ..., None].expand(1, Ht, Wt, 2))[0]
    full = nmax.repeat_interleave(tile, 0).repeat_interleave(tile, 1)
    return full[:H, :W]


def _map_coordinates(img, yy, xx):
    """Bilinear fetch of (H, W, C) at float pixel coordinates (H, W) as
    jax.scipy.ndimage.map_coordinates(order=1, mode="constant") computes
    it per channel: the four corners in (y, x) order, each weight w_y·w_x
    times the pixel (0 outside the image), summed in that order."""
    H, W = img.shape[:2]
    y0f, x0f = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0f, xx - x0f
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy, ix = y0f.to(torch.int64), x0f.to(torch.int64)
    out = None
    for cy, wy in ((iy, wy0), (iy + 1, wy1)):
        for cx, wx in ((ix, wx0), (ix + 1, wx1)):
            valid = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
            v = img[cy.clamp(0, H - 1), cx.clamp(0, W - 1)]
            v = torch.where(valid[..., None], v, torch.zeros_like(v))
            term = (wy * wx)[..., None] * v
            out = term if out is None else out + term
    return out


def motion_blur(rgb, velocity, scale: float = 1.0, n_taps: int = 8, tile: int = 20):
    """Per-pixel motion blur along the dilated dominant velocity
    (temporal.frag's motion-blur half; taa.py is the resolve): n_taps
    bilinear taps along ±velocity·scale/2 and the pixel itself, averaged."""
    H, W, _ = rgb.shape
    vdom = velocity_dilate(torch.as_tensor(velocity, device=rgb.device), tile=tile)
    vdom = vdom * float(np.float32(scale))
    yy = torch.arange(H, dtype=torch.float32, device=rgb.device)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=rgb.device)[None, :].expand(H, W)
    acc = rgb
    wsum = 1.0
    for k in range(1, n_taps + 1):
        t = k / (n_taps + 1) - 0.5  # taps in [−0.5, 0.5] around the pixel
        cy = (yy + vdom[..., 1] * t).clamp(0, H - 1)
        cx = (xx + vdom[..., 0] * t).clamp(0, W - 1)
        acc = acc + _map_coordinates(rgb, cy, cx)
        wsum += 1.0
    return acc / wsum


def velocity_image(pick, screen_xy, prev_screen_xy) -> torch.Tensor:
    """(H, W, 2) per-pixel velocity from the picking buffer: each pixel
    takes its atom's screen-space motion (current − previous projected
    position, pixels); background (pick −1) gets 0 (the reference's
    velocity gbuffer attachment, gbuffer.h:14-44). On the device of
    `pick`."""
    pick = torch.as_tensor(pick)
    dev = pick.device
    cur = torch.as_tensor(screen_xy, dtype=torch.float32, device=dev)
    prev = torch.as_tensor(prev_screen_xy, dtype=torch.float32, device=dev)
    ids = pick.clamp_min(0).long()
    vel = cur[ids] - prev[ids]
    return torch.where((pick < 0)[..., None], torch.zeros_like(vel), vel)


# -- sharpen (the final pass) -------------------------------------------------------


def sharpen(rgb, amount=0.3):
    blur = (
        rgb * 4
        + torch.roll(rgb, 1, 0) + torch.roll(rgb, -1, 0)
        + torch.roll(rgb, 1, 1) + torch.roll(rgb, -1, 1)
    ) / 8.0
    return (rgb + (rgb - blur) * amount).clamp(0.0, 1.0)


# -- the pipeline ----------------------------------------------------------------


@dataclass
class PostprocessSettings:
    tonemap: str = "aces"
    exposure: float = 1.0
    gamma: float = 2.2
    enable_ssao: bool = True
    ssao_strength: float = 1.0
    # HBAO controls (reference defaults), used when execute() gets a
    # projection matrix; without one the depth-only `ssao` runs
    ssao_intensity: float = 6.0
    ssao_radius: float = 6.0
    ssao_bias: float = 0.1
    enable_fxaa: bool = True
    enable_dof: bool = False
    focus_depth: float = 10.0
    focus_scale: float = 10.0
    dof_max_blur: float = 15.0
    enable_sharpen: bool = False
    enable_motion_blur: bool = False
    motion_blur_scale: float = 1.0
    background: tuple = (0.05, 0.05, 0.08)


def ambient_occlusion(view_depth, s: PostprocessSettings, proj=None,
                      ortho: bool = False) -> torch.Tensor:
    """(H, W) ambient occlusion of the frame: HBAO with a projection
    matrix, else the depth-only `ssao`."""
    if proj is not None:
        return hbao(
            view_depth, proj, intensity=s.ssao_intensity * s.ssao_strength,
            radius=s.ssao_radius, bias=s.ssao_bias, ortho=ortho,
        )
    return ssao(view_depth, s.ssao_strength)


def lens_passes(rgba, ao, view_depth, s: PostprocessSettings, velocity=None) -> torch.Tensor:
    """rgba with its rgb occluded (ao, or None for none), then motion
    blurred (with a velocity) and bokeh-blurred, as enabled — the passes
    between the AO and the tonemap."""
    rgb = rgba[..., :3]
    if ao is not None:
        rgb = rgb * ao[..., None]
    if s.enable_motion_blur and velocity is not None:
        rgb = motion_blur(rgb, torch.as_tensor(velocity, device=rgb.device),
                          scale=s.motion_blur_scale)
    if s.enable_dof:
        rgb = bokeh_dof(rgb, view_depth, focus_depth=float(s.focus_depth),
                        focus_scale=float(s.focus_scale), max_blur=float(s.dof_max_blur))
    return torch.cat([rgb, rgba[..., 3:]], dim=-1)


def tonemap_compose(rgba, ao, s: PostprocessSettings) -> torch.Tensor:
    """Occluded (ao, or None for none), tonemapped rgb composited over the
    background by alpha → (H, W, 3)."""
    rgb = rgba[..., :3]
    a = rgba[..., 3:]
    if ao is not None:
        rgb = rgb * ao[..., None]
    tm = TONEMAPS[s.tonemap]
    if s.tonemap == "exposure_gamma":
        rgb = tm(rgb, s.exposure, s.gamma)
    else:
        rgb = tm(rgb * s.exposure)
    bg = torch.tensor(s.background, dtype=torch.float32, device=rgba.device)
    return rgb * a + bg * (1 - a)


def antialias(rgb, s: PostprocessSettings) -> torch.Tensor:
    """FXAA 3.11, then sharpen, as enabled; then the clamp to [0, 1]."""
    if s.enable_fxaa:
        rgb = fxaa311(rgb)
    if s.enable_sharpen:
        rgb = sharpen(rgb)
    return rgb.clamp(0, 1)


def execute(
    rgba: torch.Tensor,
    view_depth: torch.Tensor,
    settings: PostprocessSettings = PostprocessSettings(),
    velocity=None,
    proj=None,
    ortho: bool = False,
) -> torch.Tensor:
    """Run the pass chain on a rendered frame → display-ready (H, W, 3)
    tensor on the frame's device, in the JAX package's order: ambient
    occlusion, motion blur, bokeh depth of field, tonemap, compose, FXAA,
    sharpen. `velocity`: optional (H, W, 2) per-pixel screen velocity
    (pixels) for the motion blur (`velocity_image`). `proj`: the 4x4
    projection matrix; with it the AO pass is HBAO, without it the
    depth-only `ssao`. The stages are `ambient_occlusion`, `lens_passes`,
    `tonemap_compose` and `antialias`."""
    s = settings
    rgba = torch.as_tensor(rgba)
    depth = torch.as_tensor(view_depth, device=rgba.device)
    ao = None
    if s.enable_ssao:
        with section("pp.ao"):
            ao = ambient_occlusion(depth, s, proj, ortho)
    if s.enable_dof or (s.enable_motion_blur and velocity is not None):
        with section("pp.lens"):
            rgba, ao = lens_passes(rgba, ao, depth, s, velocity), None
    with section("pp.tonemap"):
        rgb = tonemap_compose(rgba, ao, s)
    with section("pp.antialias"):
        return antialias(rgb, s)
