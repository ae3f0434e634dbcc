"""The volume frame: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of the ray setup and march of viamd_tpu/render/volume.py
(`_render_impl`: the per-ray setup, :176-227, the `step` loop, :263-316,
and the background compose, :318-320) — an XLA `fori_loop`, not a Pallas
kernel. csrc/volume.cu replaces it: one launch builds every ray from the
parameter block and marches it, the whole loop in registers.

The parameter block is `RayParams` (the camera, the clip box, the frame
size) and `MarchParams` (the march's scalars and isosurfaces): float32
values built on the host by render/volume.py (`ray_params`,
`march_params`). Its plain version is `ray_setup`, which gives a
(len(RAY_FIELDS), P) float32 table, one row per field:

    ox oy oz   ray origin at NDC z = −1, texture space
    dx dy dz   ray direction (to the NDC z = 0 point), texture space
    t0 t1      entry and exit of the clip box, t1 clamped by the scene depth
    dt tex_dt  step in t ((t1 − t0) / nsteps where hit, else 0) and its
               texture-space length dt·|d|
    vx vy vz   unit view direction −d / |d|
    jit        the ray's jitter in [0, 1) (0 without jitter)
    hit        1.0 where t1 > t0, else 0.0

then `march_plain`, which marches that table. Step k of a ray (k = 0 …
nsteps − 1) samples the grid at t = t0 + (k + jit)·dt and is live while
hit, alpha < 0.995 and k·dt + t0 < t1. A live step first composites each
isosurface the segment from the last sample crosses (k > 0, in iso order,
shaded with the central-difference normal at the interpolated hit), then
the transfer function's colour with its opacity corrected to the reference
rate, 1 − max(1 − a, 1e-7)^(tex_dt·150); the depth is set at the first iso
hit or where alpha first passes 0.5. Once a step is not live no later one
is (alpha never falls, k·dt + t0 never shrinks), so the kernel leaves the
loop there and gets what the masked loop gets.

`render` takes the plain version, `render_plain`, for CPU tensors only;
for CUDA tensors it launches the kernel on the row-major volumes or
raises. The kernel keeps no ray table in device memory; given `rays_out` it also writes the table
it built, which equals `ray_setup`'s on the card word for word. Both
versions evaluate every expression in the same order with correctly
rounded float32 operations (the library is built with -fmad=false; the
plain version takes `sqrt_rn` and `div_rn`, since PyTorch's CPU sqrt is
not correctly rounded and its CUDA division by a Python number multiplies
by the reciprocal), so the frames agree up to the rounding of `powf`
against `torch.pow`, and through it at undecided pixels
(`march_plain(undecided=...)`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from viamd_tpu_torch.cuda_build import Library, check_tensor as _check
from viamd_tpu_torch.ops.rdf import div_rn, sqrt_rn

__all__ = [
    "EARLY_TERMINATION_ALPHA",
    "MAX_ISO",
    "MarchParams",
    "RAY_FIELDS",
    "REF_SAMPLING_RATE",
    "RayParams",
    "launches",
    "march_plain",
    "ray_box",
    "ray_setup",
    "render",
    "render_plain",
]

EARLY_TERMINATION_ALPHA = 0.995  # raycaster.frag:51
REF_SAMPLING_RATE = 150.0  # raycaster.frag:50
MAX_ISO = 8  # isosurfaces the kernel takes (its parameter block holds 8)

RAY_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz", "t0", "t1", "dt", "tex_dt",
              "vx", "vy", "vz", "jit", "hit")

# The decisions a float rounding can flip, for `march_plain(undecided=...)`:
# a sample within UNDECIDED_S·max|grid| of an iso value (crossing or not),
# alpha within UNDECIDED_ALPHA of 0.995 or 0.5, t1 − t0 within
# UNDECIDED_T·(|t0| + |t1|) of 0.
UNDECIDED_S, UNDECIDED_ALPHA, UNDECIDED_T = 1e-4, 1e-5, 1e-5

# kernel launches since import (reset freely by callers that count a run)
launches = 0


class MarchParams(NamedTuple):
    """The march's settings as the kernel takes them: float32 values
    rounded as the JAX package rounds its Python constants
    (render/volume.py::march_params builds them)."""

    nsteps: int
    enable_dvr: bool
    use_cvol: bool
    vmin: float
    vspan: float
    lx: float  # unit light direction
    ly: float
    lz: float
    ambient: float
    one_m_amb: float  # f32(1 − ambient)
    specular: float
    shininess: float
    h: float  # f32(1 / max(dims)): the gradient's half step
    bg_r: float
    bg_g: float
    bg_b: float
    bg_a: float
    iso_values: tuple  # (n_iso,) f32
    iso_colors: tuple  # (n_iso,) of (r, g, b, a) f32


class RayParams(NamedTuple):
    """The rays' settings as the kernel takes them, float32 values
    (render/volume.py::ray_params builds them)."""

    width: int
    height: int
    nsteps: int
    inv_vp: tuple  # (16,) row-major float32 inverse of proj @ view
    inv_model: tuple  # (16,) row-major float32 inverse of the model matrix
    view_z: tuple  # (4,) row 2 of the view matrix
    clip_min: tuple  # (3,) the clip box, texture space
    clip_max: tuple


_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("volume", ("volume.cu",), {
    "volume_launch": (_i, [_p, _i, _i, _i, _p, _i, _p, _i, _i, _i, _p, _p] + [_i] * 6
                      + [_p] * 7),
    "volume_max_iso": (_i, []),
    "volume_num_rays": (_i, []),
}, check=lambda lib: (lib.volume_max_iso(), lib.volume_num_rays()) == (MAX_ISO,
                                                                        len(RAY_FIELDS)))


# -- samplers (render/volume.py re-exports them) -------------------------------


def _corners(grid_shape, px, py, pz):
    """Trilinear corners at texture coords: [(flat index, weight)] × 8 in
    corner order (x, y, z bits 2, 1, 0), clamp-to-edge."""
    d0, d1, d2 = grid_shape[:3]
    out = []
    axes = []
    for p, n in ((px, d0), (py, d1), (pz, d2)):
        g = p * float(n) - 0.5
        g0 = torch.floor(g)
        f = g - g0
        i0 = g0.to(torch.int64)
        axes.append((i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), 1.0 - f, f))
    for corner in range(8):
        ox, oy, oz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        (ax, ay, az) = axes
        ix, iy, iz = ax[ox], ay[oy], az[oz]
        wt = ax[2 + ox] * ay[2 + oy] * az[2 + oz]
        out.append(((ix * d1 + iy) * d2 + iz, wt))
    return out


def _sample_trilinear(grid: torch.Tensor, px, py, pz) -> torch.Tensor:
    """Trilinear sample of a (D0, D1, D2) grid at texture coords in [0,
    1]³ (clamp-to-edge), each coordinate a tensor of one shape."""
    flat = grid.reshape(-1)
    out = torch.zeros_like(px)
    for idx, wt in _corners(grid.shape, px, py, pz):
        out = out + wt * flat[idx]
    return out


def _sample_trilinear_c(grid: torch.Tensor, px, py, pz) -> list:
    """Trilinear sample of a (D0, D1, D2, C) grid → C tensors."""
    c = grid.shape[3]
    flat = grid.reshape(-1, c)
    out = [torch.zeros_like(px) for _ in range(c)]
    for idx, wt in _corners(grid.shape, px, py, pz):
        v = flat[idx]
        out = [o + wt * v[..., j] for j, o in enumerate(out)]
    return out


def _sample_tf(tf: torch.Tensor, u: torch.Tensor) -> list:
    """Linear lookup into an (N, 4) RGBA transfer function at u ∈ [0, 1]
    (clamped) → 4 tensors."""
    n = tf.shape[0]
    x = u.clamp(0.0, 1.0) * float(n - 1)
    i0 = torch.floor(x).to(torch.int64).clamp(0, n - 1)
    i1 = (i0 + 1).clamp(0, n - 1)
    f = x - i0.to(torch.float32)
    a, b = tf[i0], tf[i1]
    g = 1.0 - f
    return [a[..., j] * g + b[..., j] * f for j in range(4)]


# -- the ray setup (render/volume.py re-exports it) ------------------------------


def _apply44(m, x, y, z):
    """Homogeneous transform of points (x, y, z, 1) by the float32 4x4 m
    (16 values, row-major), written out elementwise as the JAX package
    does, with its guard of the perspective divide (|w'| < 1e-12 → ±1e-12:
    an inf coordinate would turn into NaN in a later affine transform) →
    (x', y', z')."""
    out = [x * m[4 * r] + y * m[4 * r + 1] + z * m[4 * r + 2] + m[4 * r + 3] for r in range(4)]
    ww = out[3]
    tiny = torch.where(ww < 0, torch.full_like(ww, -1e-12), torch.full_like(ww, 1e-12))
    ww = torch.where(ww.abs() < 1e-12, tiny, ww)
    return out[0] / ww, out[1] / ww, out[2] / ww


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


def ray_setup(rays: RayParams, jitter: torch.Tensor | None = None, scene_depth=None, *,
              device) -> torch.Tensor:
    """The ray table (len(RAY_FIELDS), H·W) of the whole frame, row-major
    from image row 0 (NDC y = −1): the plain version of the kernel's setup.
    `jitter`: (H·W,) values in [0, 1), or None for none; `scene_depth`:
    (H, W) linear view depth of the opaque scene (+inf where empty)."""
    dev = torch.device(device)
    W, H = rays.width, rays.height
    P = W * H
    px = div_rn(torch.arange(W, dtype=torch.float32, device=dev) + 0.5, W) * 2.0 - 1.0
    py = div_rn(torch.arange(H, dtype=torch.float32, device=dev) + 0.5, H) * 2.0 - 1.0
    gx = px[None, :].expand(H, W).reshape(-1)
    gy = py[:, None].expand(H, W).reshape(-1)

    p_near = _apply44(rays.inv_vp, gx, gy, torch.full_like(gx, -1.0))
    # a second point on the ray at NDC mid-depth: the far-plane
    # unprojection degenerates (w' → 0), and only the direction matters
    p_far = _apply44(rays.inv_vp, gx, gy, torch.zeros_like(gx))
    o = torch.stack(_apply44(rays.inv_model, *p_near), dim=1)
    e = torch.stack(_apply44(rays.inv_model, *p_far), dim=1)
    d = e - o
    t0, t1 = ray_box(o, d, rays.clip_min, rays.clip_max)
    if scene_depth is not None:
        # the exit clamped where the ray passes the opaque scene
        # (entryexit.frag:28,61-68): view depth is affine in t, so solve
        # zd(t) = zd_scene for t
        v2 = rays.view_z

        def vdepth(p):  # world point → view depth −z_view, no divide
            return -(p[0] * v2[0] + p[1] * v2[1] + p[2] * v2[2] + v2[3])

        zd0 = vdepth(p_near)
        zdb = vdepth(p_far) - zd0
        zdb = torch.where(zdb.abs() < 1e-12, torch.full_like(zdb, 1e-12), zdb)
        zs = torch.as_tensor(scene_depth, dtype=torch.float32, device=dev).reshape(-1)
        t_scene = (zs - zd0) / zdb
        t1 = torch.minimum(t1, torch.where(torch.isfinite(zs), t_scene, t1))
    hit = t1 > t0
    dt = torch.where(hit, div_rn(t1 - t0, float(rays.nsteps)), torch.zeros_like(t0))
    dnorm = sqrt_rn(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    tex_dt = dt * dnorm
    vn = torch.clamp_min(dnorm, 1e-12)
    jit = torch.zeros_like(t0) if jitter is None else jitter.to(torch.float32).reshape(P)
    rows = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t0, t1, dt,
            tex_dt, -d[:, 0] / vn, -d[:, 1] / vn, -d[:, 2] / vn, jit, hit.to(torch.float32)]
    return torch.stack(rows)


# -- the frame ---------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def render(grid, tf, cvol, rays: RayParams, march: MarchParams, jitter=None,
           scene_depth=None, rays_out=None):
    """The volume frame → ((height, width, 4) rgba, (height, width) depth,
    +inf where nothing was hit): on CUDA one launch of the kernel, on the
    CPU the plain version. `grid`: (D0, D1, D2); `cvol`: a (D0', D1', D2',
    3) colour volume when march.use_cvol, else None; `jitter`: (P,) or
    None; `scene_depth`: (height, width) or None; `rays_out`: None, or a
    (len(RAY_FIELDS), P) float32 tensor that receives the ray table.
    Raises on what the kernel does not take, or if the launch fails."""
    global launches
    dev = grid.device
    if dev.type == "cpu":
        return render_plain(grid, tf, cvol, rays, march, jitter, scene_depth, rays_out)
    if dev.type != "cuda":
        raise ValueError(f"no volume route for device {dev}")
    if grid.ndim != 3:
        raise ValueError(f"grid: shape {tuple(grid.shape)}, expected (D0, D1, D2)")
    n_iso = len(march.iso_values)
    if n_iso > MAX_ISO:
        raise ValueError(f"{n_iso} isosurfaces: the kernel takes at most {MAX_ISO}")
    if march.nsteps != rays.nsteps:
        raise ValueError(f"nsteps: {march.nsteps} in the march, {rays.nsteps} in the rays")
    W, H = rays.width, rays.height
    P = W * H
    _check(grid, "grid", torch.float32, grid.shape, dev)
    _check(tf, "tf", torch.float32, (tf.shape[0], 4), dev)
    if march.use_cvol:
        if cvol is None or cvol.ndim != 4:
            raise ValueError("use_cvol needs a (D0, D1, D2, 3) colour volume")
        _check(cvol, "cvol", torch.float32, (*cvol.shape[:3], 3), dev)
        cdims, cptr = tuple(cvol.shape[:3]), cvol.data_ptr()
    else:
        cdims, cptr = (1, 1, 1), None
    if jitter is not None:
        _check(jitter, "jitter", torch.float32, (P,), dev)
    if scene_depth is not None:
        _check(scene_depth, "scene_depth", torch.float32, (H, W), dev)
    if rays_out is not None:
        _check(rays_out, "rays_out", torch.float32, (len(RAY_FIELDS), P), dev)
    lib = LIBRARY.load()
    rgba = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    m = march
    scal = (m.vmin, m.vspan, m.lx, m.ly, m.lz, m.ambient, m.one_m_amb, m.specular,
            m.shininess, m.h, m.bg_r, m.bg_g, m.bg_b, m.bg_a)
    cam = (*rays.inv_vp, *rays.inv_model, *rays.view_z, *rays.clip_min, *rays.clip_max)
    iso = [v for i in range(n_iso) for v in (m.iso_values[i], *m.iso_colors[i])]

    def floats(vals):
        return ctypes.cast((ctypes.c_float * max(len(vals), 1))(*vals), ctypes.c_void_p)

    err = lib.volume_launch(
        grid.data_ptr(), *grid.shape, tf.data_ptr(), tf.shape[0], cptr, *cdims,
        _ptr(jitter), _ptr(scene_depth), W, H, rays.nsteps, int(m.enable_dvr),
        int(m.use_cvol), n_iso, floats(scal), floats(cam), floats(iso),
        rgba.data_ptr(), depth.data_ptr(), _ptr(rays_out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"volume kernel launch failed: CUDA error {err}")
    launches += 1
    return rgba, depth


def render_plain(grid, tf, cvol, rays: RayParams, march: MarchParams, jitter=None,
                 scene_depth=None, rays_out=None):
    """The plain version of the kernel: `ray_setup` then `march_plain`,
    with `render`'s arguments and result."""
    table = ray_setup(rays, jitter, scene_depth, device=grid.device)
    if rays_out is not None:
        rays_out.copy_(table)
    return march_plain(grid, tf, cvol, table, rays.width, rays.height, march)


def march_plain(grid, tf, cvol, rays, width: int, height: int, params: MarchParams,
                undecided=None, work=None):
    """The plain PyTorch version of csrc/volume.cu's march over the ray
    table of `ray_setup`: JAX's masked loop, all rays one step at a time,
    in the kernel's order of operations.

    `undecided`, a list, receives the (height, width) bool map of pixels
    where a float rounding could flip a decision (see UNDECIDED_*).
    `work`, a dict, receives the live samples and iso crossings marched."""
    F = dict(zip(RAY_FIELDS, rays))
    ox, oy, oz, dx, dy, dz = (F[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz"))
    t0, t1, dt, tex_dt, jit = F["t0"], F["t1"], F["dt"], F["tex_dt"], F["jit"]
    vx, vy, vz = F["vx"], F["vy"], F["vz"]
    hit = F["hit"] > 0.0
    p = params
    zeros = torch.zeros_like(t0)
    rgb = [zeros, zeros, zeros]
    alpha = zeros
    depth = torch.full_like(t0, 1e30)
    prev_s = zeros
    # the half vector is the same at every step
    hx, hy, hz = p.lx + vx, p.ly + vy, p.lz + vz
    hn = torch.clamp_min(sqrt_rn(hx * hx + hy * hy + hz * hz), 1e-12)
    hx, hy, hz = hx / hn, hy / hn, hz / hn
    track = undecided is not None
    if track:
        smax = float(grid.abs().max()) if grid.numel() else 0.0
        eps_s = UNDECIDED_S * smax
        und = (t1 - t0).abs() <= UNDECIDED_T * (t0.abs() + t1.abs())
    n_live = n_cross = 0
    for k in range(p.nsteps):
        kf = float(k)
        t = t0 + (kf + jit) * dt
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        s = _sample_trilinear(grid, px, py, pz)
        live = hit & (alpha < EARLY_TERMINATION_ALPHA) & (kf * dt + t0 < t1)
        if work is not None:
            n_live += int(live.sum())
        if track:
            und = und | (hit & ((alpha - EARLY_TERMINATION_ALPHA).abs() <= UNDECIDED_ALPHA)
                         & (kf * dt + t0 < t1))
        trans = 1.0 - alpha
        for vi, col in zip(p.iso_values, p.iso_colors):
            if k == 0:
                break
            crossed = live & ((prev_s - vi) * (s - vi) < 0.0)
            if track:
                near = torch.minimum((prev_s - vi).abs(), (s - vi).abs()) <= eps_s
                und = und | (live & near)
            if work is not None:
                n_cross += int(crossed.sum())
            ds = s - prev_s
            frac = torch.where(ds.abs() > 1e-12, (vi - prev_s) / ds, zeros + 0.5)
            t_hit = t0 + (((kf - 1.0) + jit) + frac.clamp(0.0, 1.0)) * dt
            qx, qy, qz = ox + dx * t_hit, oy + dy * t_hit, oz + dz * t_hit
            gx = (_sample_trilinear(grid, qx + p.h, qy, qz)
                  - _sample_trilinear(grid, qx - p.h, qy, qz))
            gy = (_sample_trilinear(grid, qx, qy + p.h, qz)
                  - _sample_trilinear(grid, qx, qy - p.h, qz))
            gz = (_sample_trilinear(grid, qx, qy, qz + p.h)
                  - _sample_trilinear(grid, qx, qy, qz - p.h))
            gn = torch.clamp_min(sqrt_rn(gx * gx + gy * gy + gz * gz), 1e-12)
            nx, ny, nz = gx / gn, gy / gn, gz / gn
            ndl = (nx * p.lx + ny * p.ly + nz * p.lz).abs()
            ndh = (nx * hx + ny * hy + nz * hz).abs()
            spec = p.specular * torch.pow(ndh, p.shininess)
            lum = p.ambient + p.one_m_amb * ndl
            contrib = torch.where(crossed, trans * col[3], zeros)
            rgb = [c + (col[j] * lum + spec) * contrib for j, c in enumerate(rgb)]
            alpha = alpha + contrib
            depth = torch.where(crossed & (depth >= 1e30), t_hit, depth)
            trans = 1.0 - alpha
        if p.enable_dvr:
            c = _sample_tf(tf, div_rn(s - p.vmin, p.vspan))
            a_corr = 1.0 - torch.pow(torch.clamp_min(1.0 - c[3], 1e-7),
                                     tex_dt * REF_SAMPLING_RATE)
            a_eff = torch.where(live, trans * a_corr, zeros)
            base = _sample_trilinear_c(cvol, px, py, pz) if p.use_cvol else c[:3]
            rgb = [acc + b * a_eff for acc, b in zip(rgb, base)]
            alpha = alpha + a_eff
            if track:
                und = und | (live & ((alpha - 0.5).abs() <= UNDECIDED_ALPHA))
            depth = torch.where((alpha > 0.5) & (depth >= 1e30), t, depth)
        prev_s = s
    one_m_a = 1.0 - alpha
    out = [c + bg * one_m_a * p.bg_a for c, bg in zip(rgb, (p.bg_r, p.bg_g, p.bg_b))]
    img = torch.stack([*out, alpha], dim=-1).reshape(height, width, 4)
    dep = torch.where(depth >= 1e30, torch.full_like(depth, float("inf")), depth)
    if track:
        undecided.append(und.reshape(height, width))
    if work is not None:
        work["samples"] = work.get("samples", 0) + n_live
        work["crossings"] = work.get("crossings", 0) + n_cross
    return img, dep.reshape(height, width)
