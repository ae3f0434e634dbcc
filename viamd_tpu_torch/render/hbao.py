"""HBAO: normals-aware, mip-sampled horizon-based ambient occlusion.

Torch port of viamd_tpu/render/hbao.py (`hbao`, `hbao_blur`, `view_normals`,
`proj_info`): per-pixel view-space position reconstruction, screen-space
derivative normals, the 32-entry Intel-ASSAO spiral sample pattern with a
deterministic 4x4-pixel jitter tile, per-sample nearest-texel fetches from
a full-resolution-upsampled depth mip stack, NdotV-bias obscurance with
quadratic falloff, and the depth-aware separable blur. Reference defaults:
intensity 6, radius 6, bias 0.1.

`hbao` routes by the depth buffer's device. A CUDA tensor goes to the
hand-written kernel, csrc/hbao.cu through render/cuda_hbao.py: four
launches a frame (the mips at their own sizes, the occlusion, the blur
along x and y) and no wait, or it raises. The rest of this module is the
plain version (`hbao_plain`), which CPU tensors take and the kernel is
held to: the jitter tables are numpy (computed once, identical to the JAX package's)
and are gathered per pixel phase on the depth buffer's device, where
everything per pixel runs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Intel ASSAO sample pattern (x, y, weight, mip bias): public constant data
# from Intel's ASSAO sample, the table the JAX package embeds.
_SAMPLE_PATTERN = np.array([
    [0.78488064, 0.56661671, 1.500000, -0.126083],
    [0.26022232, -0.29575172, 1.500000, -1.064030],
    [0.10459357, 0.08372527, 1.110000, -2.730563],
    [-0.68286800, 0.04963045, 1.090000, -0.498827],
    [-0.13570161, -0.64190155, 1.250000, -0.532765],
    [-0.26193795, -0.08205118, 0.670000, -1.783245],
    [-0.61177456, 0.66664219, 0.710000, -0.044234],
    [0.43675563, 0.25119025, 0.610000, -1.167283],
    [0.07884444, 0.86618668, 0.640000, -0.459002],
    [-0.12790935, -0.29869005, 0.600000, -1.729424],
    [-0.04031125, 0.02413622, 0.600000, -4.792042],
    [0.16201244, -0.52851415, 0.790000, -1.067055],
    [-0.70991218, 0.47301072, 0.640000, -0.335236],
    [0.03277707, -0.22349690, 0.600000, -1.982384],
    [0.68921727, 0.36800742, 0.630000, -0.266718],
    [0.29251814, 0.37775412, 0.610000, -1.422520],
    [-0.12224089, 0.96582592, 0.600000, -0.426142],
    [0.11071457, -0.16131058, 0.600000, -2.165947],
    [0.46562141, -0.59747696, 0.600000, -0.189760],
    [-0.51548797, 0.11804193, 0.600000, -1.246800],
    [0.89141309, -0.42090443, 0.600000, 0.028192],
    [-0.32402530, -0.01591529, 0.600000, -1.543018],
    [0.60771245, 0.41635221, 0.600000, -0.605411],
    [0.02379565, -0.08239821, 0.600000, -3.809046],
    [0.48951152, -0.23657045, 0.600000, -1.189011],
    [-0.17611565, -0.81696892, 0.600000, -0.513724],
    [-0.33930185, -0.20732205, 0.600000, -1.698047],
    [-0.91974425, 0.05403209, 0.600000, 0.062246],
    [-0.15064627, -0.14949332, 0.600000, -1.896062],
    [0.53180975, -0.35210401, 0.600000, -0.758838],
    [0.41487166, 0.81442589, 0.600000, -0.505648],
    [-0.24106961, -0.32721516, 0.600000, -1.665244],
], dtype=np.float64)

_N_SAMPLES = 16  # AO_NUM_SAMPLES
_TILE = 4        # AO_RANDOM_TEX_SIZE
_N_MIPS = 5
_GLOBAL_MIP_OFFSET = -4.3


@functools.lru_cache(maxsize=1)
def _jitter_tables():
    """Per-phase tables of the 4x4 jitter tile: for each pixel phase the 16
    rotated and scaled sample directions, weights, mip biases and the weight
    sum (numpy float32, (16, 4, 4[, 2]) and (4, 4))."""
    rng = np.random.RandomState(12345)
    r = rng.rand(_TILE * _TILE, 3)
    ang = 2 * np.pi * r[:, 0]
    cos_a, sin_a = np.cos(ang), np.sin(ang)
    offset = np.floor(r[:, 1] * 32.0).astype(np.int64) & 31
    uv_scale = 0.5 + 0.5 * (0.5 + (r[:, 2] * 2 - 1) * 0.5)

    dirs = np.zeros((_N_SAMPLES, _TILE, _TILE, 2))
    wgts = np.zeros((_N_SAMPLES, _TILE, _TILE))
    mips = np.zeros((_N_SAMPLES, _TILE, _TILE))
    for t in range(_TILE * _TILE):
        ty, tx = t // _TILE, t % _TILE
        for i in range(_N_SAMPLES):
            s = _SAMPLE_PATTERN[(offset[t] + i) & 31]
            dx = s[0] * cos_a[t] - s[1] * sin_a[t]
            dy = s[0] * sin_a[t] + s[1] * cos_a[t]
            dirs[i, ty, tx] = (dx * uv_scale[t], dy * uv_scale[t])
            wgts[i, ty, tx] = s[2]
            mips[i, ty, tx] = s[3]
    wsum = wgts.sum(axis=0)
    return (
        dirs.astype(np.float32),
        wgts.astype(np.float32),
        mips.astype(np.float32),
        wsum.astype(np.float32),
    )


def _phase_tables(H: int, W: int, device):
    """The jitter tables on `device`, indexed by each pixel's 4x4 phase:
    per-sample (H, W, 2) directions, (H, W) weights and mip biases, and the
    (H, W) weight sum — the values np.tile(table)[y, x] = table[y % 4, x % 4]
    would give, gathered on the device instead of tiled on the host."""
    dirs, wgts, mips, wsum = (torch.as_tensor(t, device=device) for t in _jitter_tables())
    ys = torch.arange(H, device=device) % _TILE
    xs = torch.arange(W, device=device) % _TILE
    phase = (ys[:, None] * _TILE + xs[None, :]).reshape(-1)

    def at(table):  # (4, 4, *rest) → (H, W, *rest)
        flat = table.reshape(_TILE * _TILE, *table.shape[2:])
        return flat[phase].reshape(H, W, *table.shape[2:])

    per_sample = [(at(dirs[i]), at(wgts[i]), at(mips[i])) for i in range(_N_SAMPLES)]
    return per_sample, at(wsum)


def proj_info(proj, ortho: bool):
    """(sx, sy, ox, oy) uv→view unprojection constants, proj_scl and z_max
    from the row-major 4x4 projection of render/camera.py."""
    p = np.asarray(proj, np.float64)
    if not ortho:
        info = (
            2.0 / p[0, 0],
            2.0 / p[1, 1],
            -(1.0 - p[0, 2]) / p[0, 0],
            -(1.0 + p[1, 2]) / p[1, 1],
        )
        proj_scl = p[1, 1] * 0.5
        z_max = p[2, 3] / (p[2, 2] + 1.0)
    else:
        info = (
            2.0 / p[0, 0],
            2.0 / p[1, 1],
            -(1.0 + p[0, 3]) / p[0, 0],
            -(1.0 - p[1, 3]) / p[1, 1],
        )
        proj_scl = p[1, 1] * 0.5
        z_max = (-2.0 + p[2, 3]) / p[2, 2]
    return tuple(float(v) for v in info), float(proj_scl), float(z_max)


def _uv_to_view(u, v, eye_z, info, ortho: bool):
    """uv ([0,1]², v top-down) + linear depth → view position, z = +eye_z."""
    sx, sy, ox, oy = info
    if ortho:
        x = u * sx + ox
        y = v * sy + oy
    else:
        x = (u * sx + ox) * eye_z
        y = (v * sy + oy) * eye_z
    return x, y, eye_z


def _uv(H: int, W: int, device):
    f32 = torch.float32
    u = ((torch.arange(W, dtype=f32, device=device)[None, :] + 0.5) / W).expand(H, W)
    v = ((torch.arange(H, dtype=f32, device=device)[:, None] + 0.5) / H).expand(H, W)
    return u, v


def _finite_or(view_depth: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(
        torch.isfinite(view_depth), view_depth, torch.full_like(view_depth, fill)
    )


def view_normals(view_depth: torch.Tensor, proj, ortho: bool = False) -> torch.Tensor:
    """(H, W, 3) view-space normals from the linear depth buffer via
    screen-space forward differences."""
    H, W = view_depth.shape
    info, _, _ = proj_info(proj, ortho)
    d = _finite_or(view_depth, 1e8)
    u, v = _uv(H, W, d.device)

    def pos(uu, vv, dd):
        return torch.stack(_uv_to_view(uu, vv, dd, info, ortho), dim=-1)

    p0 = pos(u, v, d)
    dE = torch.cat([d[:, 1:], d[:, -1:]], dim=1)
    dS = torch.cat([d[1:, :], d[-1:, :]], dim=0)
    px = pos(u + 1.0 / W, v, dE)
    py = pos(u, v + 1.0 / H, dS)
    n = -torch.linalg.cross(px - p0, py - p0, dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-12)


def _mip_levels(d: torch.Tensor) -> list:
    """Mip levels 1 … M−1 of the linear depth, each at its own size: the
    2×2 mean of the level below, an odd last row or column replicated."""
    levels = []
    cur = d
    for _ in range(1, _N_MIPS):
        h, w = cur.shape
        p = cur
        if h & 1:
            p = torch.cat([p, p[-1:, :]], dim=0)
        if w & 1:
            p = torch.cat([p, p[:, -1:]], dim=1)
        ph, pw = p.shape
        cur = p.reshape(ph // 2, 2, pw // 2, 2).mean(dim=(1, 3))
        levels.append(cur)
    return levels


def _mip_stack(d: torch.Tensor) -> torch.Tensor:
    """(M, H, W) linear-depth mip pyramid: each level a 2^m-box average,
    upsampled back to full resolution (nearest), so level m at pixel (y, x)
    is texel (y >> m, x >> m) of `_mip_levels`' level m."""
    H, W = d.shape
    ups = [d]
    for m, cur in enumerate(_mip_levels(d), start=1):
        k = 2 ** m
        ups.append(cur.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)[:H, :W])
    return torch.stack(ups)


def _hbao_impl(view_depth, normals, *, info, proj_scl, z_max, ortho,
               intensity, radius, bias):
    H, W = view_depth.shape
    dev = view_depth.device
    d = _finite_or(view_depth, 1e8)
    samples, wsum_t = _phase_tables(H, W, dev)

    radius_to_screen = radius * 0.5 * proj_scl * H
    neg_inv_r2 = -1.0 / (radius * radius)
    n_dot_v_bias = min(max(bias, 0.0), 1.0 - 1e-7)
    ao_multiplier = 1.0 / (1.0 - n_dot_v_bias)

    if ortho:
        radius_pixels = torch.full_like(d, max(radius_to_screen, 3.0))
    else:
        radius_pixels = (radius_to_screen / d).clamp_min(3.0)
    mip_offset = torch.log2(radius_pixels * 4.0) + _GLOBAL_MIP_OFFSET

    u, v = _uv(H, W, dev)
    Px, Py, Pz = _uv_to_view(u, v, d, info, ortho)
    Nx, Ny, Nz = normals[..., 0], normals[..., 1], normals[..., 2]
    stack = _mip_stack(d).reshape(-1)

    ao = torch.zeros_like(d)
    for dirs_i, wgts_i, mips_i in samples:
        duv = dirs_i * radius_pixels[..., None]  # pixels
        su = u + duv[..., 0] / W
        sv = v + duv[..., 1] / H
        m = torch.round(mip_offset + mips_i).clamp(0, _N_MIPS - 1).long()
        xi = (su * W).to(torch.int32).clamp(0, W - 1).long()
        yi = (sv * H).to(torch.int32).clamp(0, H - 1).long()
        sz = stack[m * (H * W) + yi * W + xi]
        Sx, Sy, Sz = _uv_to_view(su, sv, sz, info, ortho)
        Vx, Vy, Vz = Sx - Px, Sy - Py, Sz - Pz
        vdotv = Vx * Vx + Vy * Vy + Vz * Vz
        ndotv = (Nx * Vx + Ny * Vy + Nz * Vz) * torch.rsqrt(vdotv.clamp_min(1e-12))
        falloff = (vdotv * neg_inv_r2 + 1.0).clamp_min(0.0)
        ao = ao + (ndotv - n_dot_v_bias).clamp_min(0.0) * falloff * wgts_i

    ao = (1.0 - ao * (ao_multiplier / wsum_t)).clamp(0.0, 1.0)
    ao = ao ** max(intensity, 0.0)
    return torch.where(d > z_max, torch.ones_like(ao), ao)


def hbao(view_depth, proj, *, intensity: float = 6.0, radius: float = 6.0,
         bias: float = 0.1, ortho: bool = False, normals=None,
         blur: bool = True) -> torch.Tensor:
    """(H, W) linear view depth tensor (+ proj from render/camera.py) →
    (H, W) AO factor in [0, 1] on the depth's device: csrc/hbao.cu for a
    CUDA tensor (float32, contiguous, or it raises), `hbao_plain` for a CPU
    one."""
    view_depth = torch.as_tensor(view_depth)
    if view_depth.device.type != "cuda":
        return hbao_plain(view_depth, proj, intensity=intensity, radius=radius, bias=bias,
                          ortho=ortho, normals=normals, blur=blur)
    from viamd_tpu_torch.render import cuda_hbao

    info, proj_scl, z_max = proj_info(proj, ortho)
    return cuda_hbao.hbao(
        view_depth, normals, info=info, proj_scl=proj_scl, z_max=z_max * 0.99,
        ortho=ortho, intensity=float(intensity), radius=float(radius), bias=float(bias),
        sharpness=_sharpness(radius) if blur else None,
    )


def _sharpness(radius: float) -> float:
    return float(4.0 / np.sqrt(max(radius, 1e-6)))  # compute_sharpness


def hbao_plain(view_depth, proj, *, intensity: float = 6.0, radius: float = 6.0,
               bias: float = 0.1, ortho: bool = False, normals=None,
               blur: bool = True) -> torch.Tensor:
    """The plain version of `hbao`, on the depth's device, whatever it is."""
    view_depth = torch.as_tensor(view_depth)
    info, proj_scl, z_max = proj_info(proj, ortho)
    if normals is None:
        normals = view_normals(view_depth, proj, ortho)
    ao = _hbao_impl(
        view_depth, normals, info=info, proj_scl=proj_scl,
        z_max=z_max * 0.99, ortho=ortho, intensity=float(intensity),
        radius=float(radius), bias=float(bias),
    )
    if blur:
        ao = hbao_blur(ao, view_depth, sharpness=_sharpness(radius), z_max=z_max * 0.99)
    return ao


def hbao_blur(ao, view_depth, *, sharpness: float, z_max: float) -> torch.Tensor:
    """Depth-aware separable 3-tap-radius blur, horizontal then vertical."""
    d = _finite_or(view_depth, 1e8)
    kr = 3
    sigma = kr * 0.5
    fall = 1.0 / (2.0 * sigma * sigma)

    def one_axis(c, axis):
        total = c
        wtot = torch.ones_like(c)
        for r in range(1, kr + 1):
            for sgn in (1, -1):
                cs = _shift_edge(c, sgn * r, axis)
                ds = _shift_edge(d, sgn * r, axis)
                ddiff = (ds - d) * sharpness
                w = torch.exp2(-r * r * fall - ddiff * ddiff)
                total = total + cs * w
                wtot = wtot + w
        return torch.where(d > z_max, c, total / wtot)

    return one_axis(one_axis(ao, 1), 0)


def _shift_edge(img: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """Shift with clamp-to-edge (texture CLAMP_TO_EDGE semantics)."""
    n = img.shape[axis]
    idx = (torch.arange(n, device=img.device) + shift).clamp(0, n - 1)
    return img.index_select(axis, idx)
