"""Postprocess pipeline: tonemaps, ambient occlusion, compose and FXAA.

Torch port of viamd_tpu/render/postprocess.py: the five tonemaps, depth
utilities (`linearize_depth`, `normals_from_depth`), the depth-only `ssao`,
`PostprocessSettings` and `execute`, the pass chain that `Session.render`
runs on a rendered frame — ambient occlusion (HBAO when a projection is
given, render/hbao.py), tonemap, background compose, FXAA 3.11
(render/fxaa.py) — on the frame's device.

Not ported yet (each raises NotImplementedError when enabled; all are off
by default): depth of field (bokeh), motion blur and sharpen, with TAA and
the cheap `fxaa` / `depth_of_field` approximations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from viamd_tpu_torch.render.fxaa import fxaa311
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


def _not_ported(what: str):
    return NotImplementedError(f"{what} not yet ported to viamd_tpu_torch")


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
    """FXAA 3.11 when enabled, then the clamp to [0, 1]."""
    if s.enable_fxaa:
        rgb = fxaa311(rgb)
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
    tensor on the frame's device. `proj`: the 4x4 projection matrix; with
    it the AO pass is HBAO, without it the depth-only `ssao`. The stages
    are `ambient_occlusion`, `tonemap_compose` and `antialias`."""
    s = settings
    if s.enable_dof:
        raise _not_ported("depth of field (bokeh)")
    if s.enable_motion_blur and velocity is not None:
        raise _not_ported("motion blur")
    if s.enable_sharpen:
        raise _not_ported("sharpen")
    rgba = torch.as_tensor(rgba)
    depth = torch.as_tensor(view_depth, device=rgba.device)
    ao = ambient_occlusion(depth, s, proj, ortho) if s.enable_ssao else None
    return antialias(tonemap_compose(rgba, ao, s), s)
