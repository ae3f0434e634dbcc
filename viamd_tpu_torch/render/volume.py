"""Headless volume renderer: DVR + multi-isosurface ray-marching.

Torch port of viamd_tpu/render/volume.py (the reference's volume pipeline,
VIAMD src/gfx/volumerender_utils.{h,cpp} + src/shaders/volume/
raycaster.frag): closed-form entry and exit of the clip box, jittered
fixed-rate marching with the opacity corrected to a reference sampling
rate, transfer-function DVR with early ray termination at alpha 0.995,
isosurface crossings refined linearly and shaded with a central-difference
gradient, an optional colour volume for the DVR colour, the exit clamped
to the opaque scene's depth, and the ray parameter of the first hit as the
depth.

`render_volume` builds the parameter block on the host — the rays'
(`ray_params`: inv(proj @ view) and inv(model) in float32 by `inv44`, row
2 of the view matrix, the clip box, the frame size and step count) and the
march's (`march_params`) — draws the jitter on the device, and hands both
to render/cuda_volume.py::render: on a CUDA device one launch of the
kernel csrc/volume.cu, which builds each ray in registers and marches it
over the grid; on the CPU its plain version, `ray_setup` (the
per-ray table, every division and square root correctly rounded, so the
CPU and the card build the same table) then `march_plain` (JAX's masked
step loop).

Not ported, by design: the row banding at 2^18 pixels (the TPU worker's
limit; the CUDA grid covers any size), the `_Frozen` jit key, and the
shear-warp renderer (render/shearwarp.py exists because gathers are slow
on a TPU; the port ray-marches at every size). Jitter comes from a
`torch.Generator` on the device seeded with `seed`, so a jittered frame
differs from the JAX package's (whose stream is PRNGKey(0) folded with
`seed`); unjittered frames agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from viamd_tpu_torch.render import cuda_volume
from viamd_tpu_torch.render.cuda_volume import (  # noqa: F401  (re-exported)
    EARLY_TERMINATION_ALPHA,
    REF_SAMPLING_RATE,
    MarchParams,
    RayParams,
    _sample_tf,
    _sample_trilinear,
    _sample_trilinear_c,
    ray_box,
    ray_setup,
)


@dataclass
class VolumeRenderSettings:
    width: int = 512
    height: int = 512
    samples_per_voxel: float = 2.0  # SAMPLING_RATE analog
    enable_dvr: bool = True
    enable_iso: bool = False
    iso_values: tuple = ()
    iso_colors: tuple = ()  # (r,g,b,a) per iso
    value_range: tuple = (0.0, 1.0)
    background: tuple = (0.0, 0.0, 0.0, 0.0)
    jitter: bool = True
    light_dir: tuple = (0.577, 0.577, 0.577)
    ambient: float = 0.2
    specular: float = 0.4
    shininess: float = 32.0
    # DVR takes its colour from a (D,D,D,3) colour volume instead of the TF
    # (set by render_volume when it is given one)
    use_color_volume: bool = False
    # fractional clip sub-box [clip_min, clip_max] in texture space (the
    # reference's clip planes, volumerender_utils.h:44,72): rays march only
    # inside it
    clip_min: tuple = (0.0, 0.0, 0.0)
    clip_max: tuple = (1.0, 1.0, 1.0)


def _f32(v) -> float:
    return float(np.float32(v))


def inv44(m: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 matrix in float32 as the JAX package computes it:
    LU with partial pivoting and two triangular solves (LAPACK getrf and
    getrs, through scipy). The unprojection at NDC z = −1 and 0 magnifies
    the inverse's rounding (with znear 0.1, zfar 200 the float32 inverse is
    1e-3 off the float64 one), so the two packages' rays agree only if
    their inverses do."""
    lu = scipy.linalg.lu_factor(np.asarray(m, np.float32), check_finite=False)
    return scipy.linalg.lu_solve(lu, np.eye(4, dtype=np.float32), check_finite=False)


def model_matrix_from_extent(extent, center=None) -> np.ndarray:
    """Unit cube → world box spanning ±extent about `center` (the SDF grid's
    model matrix, density_volume.cpp:193-197)."""
    e = np.asarray(extent, np.float64) * np.ones(3)
    c = np.zeros(3) if center is None else np.asarray(center, np.float64)
    m = np.eye(4)
    m[:3, :3] = np.diag(2 * e)
    m[:3, 3] = c - e
    return m.astype(np.float32)


def march_params(grid_shape, settings: VolumeRenderSettings, use_cvol: bool) -> MarchParams:
    """The march's constants, rounded to float32 as the JAX package rounds
    its Python values (a Python expression in double, rounded once)."""
    s = settings
    vmin, vmax = s.value_range
    light = np.asarray(s.light_dir, np.float32)
    light = light / np.float32(np.sqrt(np.sum(light * light, dtype=np.float32)))
    isos = tuple(s.iso_values) if s.enable_iso else ()
    cols = tuple(tuple(c) for c in s.iso_colors) if s.enable_iso else ()
    if len(cols) < len(isos):
        raise ValueError(f"{len(isos)} iso values but {len(cols)} iso colours")
    D = max(grid_shape[:3])
    bg = [_f32(v) for v in s.background]
    return MarchParams(
        nsteps=int(D * s.samples_per_voxel),
        enable_dvr=bool(s.enable_dvr),
        use_cvol=bool(use_cvol),
        vmin=_f32(vmin),
        vspan=_f32(max(vmax - vmin, 1e-30)),
        lx=float(light[0]), ly=float(light[1]), lz=float(light[2]),
        ambient=_f32(s.ambient),
        one_m_amb=_f32(1 - s.ambient),
        specular=_f32(s.specular),
        shininess=_f32(s.shininess),
        h=_f32(1.0 / D),
        bg_r=bg[0], bg_g=bg[1], bg_b=bg[2], bg_a=bg[3],
        iso_values=tuple(_f32(v) for v in isos),
        iso_colors=tuple(tuple(_f32(v) for v in c[:4]) for c in cols[: len(isos)]),
    )


def ray_params(grid_shape, model, view, proj, settings: VolumeRenderSettings) -> RayParams:
    """The rays' half of the parameter block: the float32 inverses of
    proj @ view and of the model matrix (`inv44`, on the host: they are 4x4
    matrices), row 2 of the view matrix, the clip box, the frame size and
    the step count."""
    f32 = np.float32
    view32 = np.asarray(view, f32)
    inv_vp = inv44(np.asarray(proj, f32) @ view32)
    inv_model = inv44(np.asarray(model, f32))

    def floats(a, n):
        return tuple(float(v) for v in np.broadcast_to(np.asarray(a, f32), (n,)))

    return RayParams(
        width=int(settings.width),
        height=int(settings.height),
        nsteps=int(max(grid_shape[:3]) * settings.samples_per_voxel),
        inv_vp=floats(inv_vp.reshape(-1), 16),
        inv_model=floats(inv_model.reshape(-1), 16),
        view_z=floats(view32[2], 4),
        clip_min=floats(settings.clip_min, 3),
        clip_max=floats(settings.clip_max, 3),
    )


def render_volume(
    grid,
    tf,
    model: np.ndarray,
    view: np.ndarray,
    proj: np.ndarray,
    settings: VolumeRenderSettings,
    seed: int = 0,
    color_volume=None,
    scene_depth=None,
    *,
    device,
    generator: torch.Generator | None = None,
):
    """Render a density grid → ((H, W, 4) float32 rgba, (H, W) depth) as
    tensors on `device`. rgb is premultiplied by alpha and composited over
    `settings.background`; depth is the ray parameter of the first iso hit
    or of alpha passing 0.5 (+inf where nothing is hit).

    model: 4x4 matrix mapping the unit cube [0, 1]³ (texture space) to
    world (`model_matrix_from_extent`). `color_volume`: optional (D, D, D,
    3) RGB grid that colours the DVR instead of the TF. `scene_depth`:
    optional (H, W) linear view depth of the opaque scene rendered with the
    same view and projection — the march stops at its surface, so a
    translucent volume composites correctly against geometry inside it.
    With `settings.jitter`, each ray's start is offset by a uniform draw
    from `generator` (default: a new generator on `device` seeded with
    `seed`). On a CUDA device the frame is one launch of csrc/volume.cu,
    on the CPU its plain version."""
    dev = torch.device(device)
    g = torch.as_tensor(grid, dtype=torch.float32, device=dev).contiguous()
    t = torch.as_tensor(tf, dtype=torch.float32, device=dev).contiguous()
    cvol = None
    if color_volume is not None:
        cvol = torch.as_tensor(color_volume, dtype=torch.float32, device=dev).contiguous()
    sd = None
    if scene_depth is not None:
        sd = torch.as_tensor(scene_depth, dtype=torch.float32, device=dev)
        sd = sd.reshape(settings.height, settings.width).contiguous()
    jitter = None
    if settings.jitter:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(int(seed))
        jitter = torch.rand(settings.width * settings.height, generator=generator, device=dev)
    return cuda_volume.render(g, t, cvol, ray_params(g.shape, model, view, proj, settings),
                              march_params(g.shape, settings, cvol is not None), jitter, sd)
