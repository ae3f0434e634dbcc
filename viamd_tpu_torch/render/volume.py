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

`render_volume` runs in two parts on the caller's device:

1. `ray_setup`: per-ray torch ops shared by both routes — inv(proj @ view)
   and inv(model) (float32, on the host: they are 4x4 matrices, `inv44`), every
   pixel unprojected at NDC z = −1 and 0 into texture space, `ray_box`
   against the clip sub-box, the scene-depth clamp, `hit`, `dt`, `tex_dt`,
   the view direction and the jitter → the ray table of
   render/cuda_volume.py (every division and square root correctly
   rounded, so the CPU and the card build the same table);
2. the march, render/cuda_volume.py::march: the CUDA kernel
   csrc/volume.cu on a CUDA device, its plain version `march_plain` (JAX's
   masked step loop) on the CPU.

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

from viamd_tpu_torch.ops.rdf import div_rn, sqrt_rn
from viamd_tpu_torch.render import cuda_volume
from viamd_tpu_torch.render.cuda_volume import (  # noqa: F401  (re-exported)
    EARLY_TERMINATION_ALPHA,
    REF_SAMPLING_RATE,
    MarchParams,
    _sample_tf,
    _sample_trilinear,
    _sample_trilinear_c,
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


def _apply44(m: np.ndarray, x, y, z):
    """Homogeneous transform of points (x, y, z, 1) by the float32 4x4 m,
    written out elementwise as the JAX package does, with its guard of the
    perspective divide (|w'| < 1e-12 → ±1e-12: an inf coordinate would turn
    into NaN in a later affine transform) → (x', y', z')."""
    m = [[float(v) for v in row] for row in np.asarray(m, np.float32)]
    out = [x * r[0] + y * r[1] + z * r[2] + r[3] for r in m]
    ww = out[3]
    tiny = torch.where(ww < 0, torch.full_like(ww, -1e-12), torch.full_like(ww, 1e-12))
    ww = torch.where(ww.abs() < 1e-12, tiny, ww)
    return out[0] / ww, out[1] / ww, out[2] / ww


def inv44(m: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 matrix in float32 as the JAX package computes it:
    LU with partial pivoting and two triangular solves (LAPACK getrf and
    getrs, through scipy). The unprojection at NDC z = −1 and 0 magnifies
    the inverse's rounding (with znear 0.1, zfar 200 the float32 inverse is
    1e-3 off the float64 one), so the two packages' rays agree only if
    their inverses do."""
    lu = scipy.linalg.lu_factor(np.asarray(m, np.float32), check_finite=False)
    return scipy.linalg.lu_solve(lu, np.eye(4, dtype=np.float32), check_finite=False)


def _per_axis(v) -> list:
    """A box bound (a number or three) as three float32 values."""
    return [float(x) for x in np.broadcast_to(np.asarray(v, np.float32), (3,))]


def ray_box(orig: torch.Tensor, direc: torch.Tensor, lo=0.0, hi=1.0):
    """Entry and exit parameters of rays (P, 3) against the box [lo, hi]³
    (lo, hi scalars or per-axis (3,)): the entry/exit rasterization of
    volumerender_utils in closed form. → (tmin clamped at 0, tmax); a ray
    misses where tmax ≤ tmin. The bounds stay scalars of the ops (no
    tensor is made from host data)."""
    lo3, hi3 = _per_axis(lo), _per_axis(hi)
    tmin = tmax = None
    for a in range(3):
        o, d = orig[:, a], direc[:, a]
        d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        inv = 1.0 / d
        t1 = (lo3[a] - o) * inv
        t2 = (hi3[a] - o) * inv
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    return torch.clamp_min(tmin, 0.0), tmax


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


def ray_setup(grid_shape, model, view, proj, settings: VolumeRenderSettings,
              jitter: torch.Tensor | None = None, scene_depth=None, *, device):
    """The per-ray table of render/cuda_volume.py (len(RAY_FIELDS), H·W)
    for the whole frame, row-major from image row 0 (NDC y = −1).
    `jitter`: (H·W,) values in [0, 1), or None for none; `scene_depth`:
    (H, W) linear view depth of the opaque scene (+inf where empty)."""
    dev = torch.device(device)
    W, H = settings.width, settings.height
    P = W * H
    f32 = np.float32
    proj32, view32 = np.asarray(proj, f32), np.asarray(view, f32)
    inv_vp = inv44(proj32 @ view32)
    inv_model = inv44(np.asarray(model, f32))

    px = div_rn(torch.arange(W, dtype=torch.float32, device=dev) + 0.5, W) * 2.0 - 1.0
    py = div_rn(torch.arange(H, dtype=torch.float32, device=dev) + 0.5, H) * 2.0 - 1.0
    gx = px[None, :].expand(H, W).reshape(-1)
    gy = py[:, None].expand(H, W).reshape(-1)

    p_near = _apply44(inv_vp, gx, gy, torch.full_like(gx, -1.0))
    # a second point on the ray at NDC mid-depth: the far-plane
    # unprojection degenerates (w' → 0), and only the direction matters
    p_far = _apply44(inv_vp, gx, gy, torch.zeros_like(gx))
    o = torch.stack(_apply44(inv_model, *p_near), dim=1)
    e = torch.stack(_apply44(inv_model, *p_far), dim=1)
    d = e - o
    t0, t1 = ray_box(o, d, settings.clip_min, settings.clip_max)
    if scene_depth is not None:
        # the exit clamped where the ray passes the opaque scene
        # (entryexit.frag:28,61-68): view depth is affine in t, so solve
        # zd(t) = zd_scene for t
        v2 = [float(v) for v in view32[2]]

        def vdepth(p):  # world point → view depth −z_view, no divide
            return -(p[0] * v2[0] + p[1] * v2[1] + p[2] * v2[2] + v2[3])

        zd0 = vdepth(p_near)
        zdb = vdepth(p_far) - zd0
        zdb = torch.where(zdb.abs() < 1e-12, torch.full_like(zdb, 1e-12), zdb)
        zs = torch.as_tensor(scene_depth, dtype=torch.float32, device=dev).reshape(-1)
        t_scene = (zs - zd0) / zdb
        t1 = torch.minimum(t1, torch.where(torch.isfinite(zs), t_scene, t1))
    hit = t1 > t0
    nsteps = int(max(grid_shape[:3]) * settings.samples_per_voxel)
    dt = torch.where(hit, div_rn(t1 - t0, float(nsteps)), torch.zeros_like(t0))
    dnorm = sqrt_rn(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    tex_dt = dt * dnorm
    vn = torch.clamp_min(dnorm, 1e-12)
    jit = torch.zeros_like(t0) if jitter is None else jitter.to(torch.float32).reshape(P)
    rows = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t0, t1, dt,
            tex_dt, -d[:, 0] / vn, -d[:, 1] / vn, -d[:, 2] / vn, jit, hit.to(torch.float32)]
    return torch.stack(rows)


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
    `seed`). The march runs csrc/volume.cu on a CUDA device and its plain
    version on the CPU."""
    dev = torch.device(device)
    g = torch.as_tensor(grid, dtype=torch.float32, device=dev).contiguous()
    t = torch.as_tensor(tf, dtype=torch.float32, device=dev).contiguous()
    cvol = None
    if color_volume is not None:
        cvol = torch.as_tensor(color_volume, dtype=torch.float32, device=dev).contiguous()
    params = march_params(g.shape, settings, cvol is not None)
    jitter = None
    if settings.jitter:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(int(seed))
        jitter = torch.rand(settings.width * settings.height, generator=generator, device=dev)
    rays = ray_setup(g.shape, model, view, proj, settings, jitter, scene_depth, device=dev)
    return cuda_volume.march(g, t, cvol, rays, settings.width, settings.height, params)
