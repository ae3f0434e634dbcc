"""Plain reference of a composed viewer frame: the water box at a playback
position, drawn as CPK spheres seen from a camera, the selection's outline,
the SDF volume ray-marched in the scene, then ambient occlusion (HBAO),
the ACES tonemap over the background and FXAA 3.11.

Plain PyTorch (and SciPy's 4x4 LU, as the program inverts its matrices)
that imports nothing of the program and takes nothing it made: the volume
is the reference's own SDF (portbench/reference/analysis.py) over the
benchmark's frames. The arithmetic is a frozen copy of the plain versions
the port's kernels and passes are held to: the sphere ray cast tests every
sphere whose screen box touches a pixel's 16x16 tile, in any order, with
the same tie rule and shading; the volume march runs the same steps on the
rays that enter the volume.

`Scene(..., control=True)` is the control: the same chain with every
tensor it hands from one stage to the next rounded to bfloat16.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from portbench.inputs import WaterBox
from portbench.reference import analysis

TILE = 16
F32 = torch.float32

# the viewer's fixed settings (the program's defaults)
AMBIENT, SPECULAR, SHININESS, LIGHT = 0.25, 0.35, 48.0, (0.4, 0.7, 0.6)
DESATURATE = 0.7
OUTLINE = (1.0, 0.6, 0.1)
EARLY_TERMINATION_ALPHA, REF_SAMPLING_RATE = 0.995, 150.0
BACKGROUND = (0.05, 0.05, 0.08)
VIRIDIS = [
    (0.267, 0.005, 0.329), (0.283, 0.141, 0.458), (0.254, 0.265, 0.530),
    (0.207, 0.372, 0.553), (0.164, 0.471, 0.558), (0.128, 0.567, 0.551),
    (0.135, 0.659, 0.518), (0.267, 0.749, 0.441), (0.478, 0.821, 0.318),
    (0.741, 0.873, 0.150), (0.993, 0.906, 0.144),
]


def f32(v) -> float:
    return float(np.float32(v))


def div_rn(a, b: float):
    """a / b for a Python number b, correctly rounded on every device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


# -- camera ------------------------------------------------------------------------


def look_at(eye, center, up) -> np.ndarray:
    def normalize(v):
        v = np.asarray(v, np.float64)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    eye = np.asarray(eye, np.float64)
    f = normalize(np.asarray(center, np.float64) - eye)
    s = normalize(np.cross(f, normalize(up)))
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m.astype(np.float32)


def perspective(fovy: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    t = 1.0 / np.tan(fovy / 2)
    m = np.zeros((4, 4))
    m[0, 0], m[1, 1] = t / aspect, t
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = 2 * zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def inv44(m) -> np.ndarray:
    lu = scipy.linalg.lu_factor(np.asarray(m, np.float32), check_finite=False)
    return scipy.linalg.lu_solve(lu, np.eye(4, dtype=np.float32), check_finite=False)


# -- the sphere ray cast --------------------------------------------------------------


@dataclass
class Shading:
    p00: float
    p11: float
    p02: float
    p12: float
    two_over_w: float
    two_over_h: float
    lx: float
    ly: float
    lz: float


def shading(proj, width: int, height: int) -> Shading:
    p = np.asarray(proj, np.float32)
    lt = np.asarray(LIGHT, np.float32)
    lt = lt / np.linalg.norm(lt)
    return Shading(f32(p[0, 0]), f32(p[1, 1]), f32(p[0, 2]), f32(p[1, 2]), f32(2.0 / width),
                   f32(2.0 / height), f32(lt[0]), f32(lt[1]), f32(lt[2]))


def _pixel_range(c, w, r, den, bounded, pdiag: float, pjit: float, n: int):
    """Pixels [lo, hi] whose centre ray along one screen axis can meet the
    sphere: the tangent planes through the eye bound the slopes."""
    s = torch.sqrt((c * c + w * w - r * r).clamp_min(0.0))
    ends = [(((c * w + sg * r * s) / den * pdiag - pjit) + 1.0) * (n * 0.5) - 0.5
            for sg in (-1.0, 1.0)]
    u0 = torch.where(bounded, torch.minimum(*ends) - 1.0, torch.full_like(c, -1.0))
    u1 = torch.where(bounded, torch.maximum(*ends) + 1.0, torch.full_like(c, float(n)))
    lo = torch.ceil(u0.clamp(-1.0, float(n))).long().clamp_min(0)
    hi = torch.floor(u1.clamp(-1.0, float(n))).long().clamp_max(n - 1)
    return lo, hi


def tile_lists(sph, sh: Shading, width: int, height: int):
    """Per-tile CSR lists of the spheres whose screen box touches the tile
    (spheres with the centre behind the eye are dropped)."""
    dev = sph.device
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    x, y, z, r = (sph[:, k].double() for k in range(4))
    w = -z
    bounded = w > r * (1.0 + 1e-4)
    den = torch.where(bounded, w * w - r * r, torch.ones_like(w))
    px0, px1 = _pixel_range(x, w, r, den, bounded, sh.p00, sh.p02, width)
    py0, py1 = _pixel_range(y, w, r, den, bounded, sh.p11, sh.p12, height)
    tx0, tx1, ty0, ty1 = px0 // TILE, px1 // TILE, py0 // TILE, py1 // TILE
    wx = (tx1 - tx0 + 1).clamp_min(0)
    wy = (ty1 - ty0 + 1).clamp_min(0)
    cnt = torch.where(-sph[:, 2] > 1e-6, wx * wy, torch.zeros_like(wx))
    total = int(cnt.sum())
    prim = torch.repeat_interleave(torch.arange(sph.shape[0], device=dev), cnt, output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(cnt, 0) - cnt)[prim]
    tile = (ty0[prim] + local // wx[prim]) * tiles_x + tx0[prim] + local % wx[prim]
    tile, by_tile = torch.sort(tile, stable=True)
    start = torch.searchsorted(tile, torch.arange(tiles_x * tiles_y + 1, device=dev))
    return start, prim[by_tile]


def raster(sph, packed, sh: Shading, width: int, height: int):
    """Ray cast the spheres → (rgba (H, W, 4), depth (H, W), pick (H, W)):
    every pixel tests every sphere of its tile's list; the nearest hit wins,
    ties to the lower sphere; Blinn-Phong shading of the 8-bit colour."""
    dev = sph.device
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    start, lst = tile_lists(sph, sh, width, height)
    lane = torch.arange(TILE * TILE, device=dev)
    tid = torch.arange(tiles_x * tiles_y, device=dev)
    px = ((tid % tiles_x) * TILE)[:, None] + (lane % TILE)[None, :]
    py = ((tid // tiles_x) * TILE)[:, None] + (lane // TILE)[None, :]
    one = torch.ones((), dtype=F32, device=dev)
    dx = ((px.to(F32) + 0.5) * sh.two_over_w - 1.0 + sh.p02) * (one / sh.p00)
    dy = ((py.to(F32) + 0.5) * sh.two_over_h - 1.0 + sh.p12) * (one / sh.p11)
    dd = dx * dx + dy * dy + 1.0
    inv_dd = 1.0 / dd
    bt = torch.full(dx.shape, 1e30, dtype=F32, device=dev)
    bid = torch.full(dx.shape, -1, dtype=torch.long, device=dev)
    count = start[1:] - start[:-1]
    for k in range(int(count.max())):
        valid = count > k
        ids = lst[(start[:-1] + k).clamp(max=max(lst.shape[0] - 1, 0))]
        c = sph[ids]
        cx, cy, cz, rk = (c[:, j:j + 1] for j in range(4))
        cc = cx * cx + cy * cy + cz * cz - rk * rk
        dc = dx * cx + dy * cy - cz
        disc = dc * dc - dd * cc
        t = (dc - analysis.sqrt_rn(disc.clamp_min(0.0))) * inv_dd
        win = (t < bt) | ((t == bt) & (ids[:, None] < bid))
        ok = valid[:, None] & (disc > 0.0) & (t > 1e-6) & win
        bt = torch.where(ok, t, bt)
        bid = torch.where(ok, ids[:, None], bid)
    hit = bid >= 0
    c = sph[bid.clamp_min(0)]
    inv = 1.0 / c[..., 3].clamp_min(1e-12)
    nx = (dx * bt - c[..., 0]) * inv
    ny = (dy * bt - c[..., 1]) * inv
    nz = (-bt - c[..., 2]) * inv
    col = packed[bid.clamp_min(0)]
    rgb8 = [((col >> s) & 255).to(F32) for s in (16, 8, 0)]
    ndl = (nx * sh.lx + ny * sh.ly + nz * sh.lz).clamp_min(0.0)
    vn = 1.0 / analysis.sqrt_rn(dd)
    hvx, hvy, hvz = sh.lx + -dx * vn, sh.ly + -dy * vn, sh.lz + vn
    hn = 1.0 / analysis.sqrt_rn((hvx * hvx + hvy * hvy + hvz * hvz).clamp_min(1e-24))
    ndh = ((nx * hvx + ny * hvy + nz * hvz) * hn).clamp_min(0.0)
    lum = (f32(AMBIENT) + f32(1.0 - AMBIENT) * ndl) * f32(1.0 / 255.0)
    spec = f32(SPECULAR) * torch.pow(ndh, f32(SHININESS))
    rgb = torch.where(hit[..., None], torch.stack([v * lum + spec for v in rgb8], -1),
                      torch.zeros((), dtype=F32, device=dev))
    rgba = torch.cat([rgb, hit.to(F32)[..., None]], -1)
    depth = torch.where(hit, bt, torch.full_like(bt, float("inf")))

    def image(a, ch):
        a = a.reshape(tiles_y, tiles_x, TILE, TILE, *ch).transpose(1, 2)
        return a.reshape(tiles_y * TILE, tiles_x * TILE, *ch)[:height, :width].contiguous()

    return image(rgba, (4,)), image(depth, ()), image(bid.int(), ())


def outline(img, pick, selected):
    """Colour the boundary pixels of the selected atoms' coverage."""
    sel = (pick >= 0) & selected[pick.clamp_min(0).long()]
    edge = torch.zeros_like(sel)
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        edge |= sel != torch.roll(sel, sh, dims=ax)
    edge &= sel | (torch.roll(sel, 1, 0) | torch.roll(sel, -1, 0)
                   | torch.roll(sel, 1, 1) | torch.roll(sel, -1, 1))
    return torch.stack([torch.where(edge, float(c), img[..., i])
                        for i, c in enumerate((*OUTLINE, 1.0))], dim=-1)


# -- the volume march -------------------------------------------------------------------


def transfer_function(n: int = 256) -> np.ndarray:
    anchors = np.asarray(VIRIDIS, np.float32)
    t = np.linspace(0, 1, n)
    src = np.linspace(0, 1, anchors.shape[0])
    rgb = np.stack([np.interp(t, src, anchors[:, c]) for c in range(3)], -1).astype(np.float32)
    a = np.linspace(0, 1, n, dtype=np.float32)
    return np.concatenate([rgb, a[:, None]], -1).astype(np.float32)


def _apply44(m, x, y, z):
    out = [x * m[4 * r] + y * m[4 * r + 1] + z * m[4 * r + 2] + m[4 * r + 3] for r in range(4)]
    ww = out[3]
    tiny = torch.where(ww < 0, torch.full_like(ww, -1e-12), torch.full_like(ww, 1e-12))
    ww = torch.where(ww.abs() < 1e-12, tiny, ww)
    return out[0] / ww, out[1] / ww, out[2] / ww


def _sample(grid, px, py, pz):
    """Trilinear sample of a (D, D, D) grid at texture coordinates,
    clamp-to-edge, the corners summed in x, y, z bit order."""
    d0, d1, d2 = grid.shape
    flat = grid.reshape(-1)
    axes = []
    for p, n in ((px, d0), (py, d1), (pz, d2)):
        g = p * float(n) - 0.5
        g0 = torch.floor(g)
        i0 = g0.to(torch.int64)
        axes.append((i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), 1.0 - (g - g0), g - g0))
    out = torch.zeros_like(px)
    for corner in range(8):
        ox, oy, oz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        (ax, ay, az) = axes
        wt = ax[2 + ox] * ay[2 + oy] * az[2 + oz]
        out = out + wt * flat[(ax[ox] * d1 + ay[oy]) * d2 + az[oz]]
    return out


def march(grid, tf, vmax: float, model, view, proj, width: int, height: int, jitter, depth):
    """DVR of `grid` (no isosurfaces) over the scene, the exit clamped at
    the scene's depth → premultiplied (H, W, 4) rgba."""
    dev = grid.device
    D = max(grid.shape)
    nsteps = int(D * 2.0)
    inv_vp = inv44(np.asarray(proj, np.float32) @ np.asarray(view, np.float32)).reshape(-1)
    inv_model = inv44(np.asarray(model, np.float32)).reshape(-1)
    inv_vp, inv_model = [float(v) for v in inv_vp], [float(v) for v in inv_model]
    v2 = [float(v) for v in np.asarray(view, np.float32)[2]]
    px = div_rn(torch.arange(width, dtype=F32, device=dev) + 0.5, width) * 2.0 - 1.0
    py = div_rn(torch.arange(height, dtype=F32, device=dev) + 0.5, height) * 2.0 - 1.0
    gx = px[None, :].expand(height, width).reshape(-1)
    gy = py[:, None].expand(height, width).reshape(-1)
    p_near = _apply44(inv_vp, gx, gy, torch.full_like(gx, -1.0))
    p_far = _apply44(inv_vp, gx, gy, torch.zeros_like(gx))
    o = torch.stack(_apply44(inv_model, *p_near), 1)
    d = torch.stack(_apply44(inv_model, *p_far), 1) - o
    t0 = t1 = None
    for a in range(3):
        da = torch.where(d[:, a].abs() < 1e-12, torch.full_like(d[:, a], 1e-12), d[:, a])
        ia = 1.0 / da
        ta, tb = (0.0 - o[:, a]) * ia, (1.0 - o[:, a]) * ia
        near, far = torch.minimum(ta, tb), torch.maximum(ta, tb)
        t0 = near if t0 is None else torch.maximum(t0, near)
        t1 = far if t1 is None else torch.minimum(t1, far)
    t0 = t0.clamp_min(0.0)

    def vdepth(p):
        return -(p[0] * v2[0] + p[1] * v2[1] + p[2] * v2[2] + v2[3])

    zd0 = vdepth(p_near)
    zdb = vdepth(p_far) - zd0
    zdb = torch.where(zdb.abs() < 1e-12, torch.full_like(zdb, 1e-12), zdb)
    zs = depth.reshape(-1)
    t1 = torch.minimum(t1, torch.where(torch.isfinite(zs), (zs - zd0) / zdb, t1))
    live_rays = torch.nonzero(t1 > t0)[:, 0]  # only these rays enter the volume
    o, d, t0, t1 = o[live_rays], d[live_rays], t0[live_rays], t1[live_rays]
    jit = jitter[live_rays]
    dt = div_rn(t1 - t0, float(nsteps))
    tex_dt = dt * analysis.sqrt_rn(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    vmin, vspan = f32(0.0), f32(max(vmax, 1e-30))
    zeros = torch.zeros_like(t0)
    rgb, alpha = [zeros, zeros, zeros], zeros
    n = tf.shape[0]
    for k in range(nsteps):
        kf = float(k)
        t = t0 + (kf + jit) * dt
        s = _sample(grid, o[:, 0] + d[:, 0] * t, o[:, 1] + d[:, 1] * t, o[:, 2] + d[:, 2] * t)
        live = (alpha < EARLY_TERMINATION_ALPHA) & (kf * dt + t0 < t1)
        x = div_rn(s - vmin, vspan).clamp(0.0, 1.0) * float(n - 1)
        i0 = torch.floor(x).to(torch.int64).clamp(0, n - 1)
        i1 = (i0 + 1).clamp(0, n - 1)
        fr = x - i0.to(F32)
        c = [tf[i0, j] * (1.0 - fr) + tf[i1, j] * fr for j in range(4)]
        a_corr = 1.0 - torch.pow(torch.clamp_min(1.0 - c[3], 1e-7), tex_dt * REF_SAMPLING_RATE)
        a_eff = torch.where(live, (1.0 - alpha) * a_corr, zeros)
        rgb = [acc + b * a_eff for acc, b in zip(rgb, c[:3])]
        alpha = alpha + a_eff
    out = torch.zeros((width * height, 4), dtype=F32, device=dev)
    out[live_rays] = torch.stack([*rgb, alpha], -1)
    return out.reshape(height, width, 4)


# -- postprocess ---------------------------------------------------------------------------

_SAMPLE_PATTERN = np.array([
    [0.78488064, 0.56661671, 1.5, -0.126083], [0.26022232, -0.29575172, 1.5, -1.064030],
    [0.10459357, 0.08372527, 1.11, -2.730563], [-0.68286800, 0.04963045, 1.09, -0.498827],
    [-0.13570161, -0.64190155, 1.25, -0.532765], [-0.26193795, -0.08205118, 0.67, -1.783245],
    [-0.61177456, 0.66664219, 0.71, -0.044234], [0.43675563, 0.25119025, 0.61, -1.167283],
    [0.07884444, 0.86618668, 0.64, -0.459002], [-0.12790935, -0.29869005, 0.6, -1.729424],
    [-0.04031125, 0.02413622, 0.6, -4.792042], [0.16201244, -0.52851415, 0.79, -1.067055],
    [-0.70991218, 0.47301072, 0.64, -0.335236], [0.03277707, -0.22349690, 0.6, -1.982384],
    [0.68921727, 0.36800742, 0.63, -0.266718], [0.29251814, 0.37775412, 0.61, -1.422520],
    [-0.12224089, 0.96582592, 0.6, -0.426142], [0.11071457, -0.16131058, 0.6, -2.165947],
    [0.46562141, -0.59747696, 0.6, -0.189760], [-0.51548797, 0.11804193, 0.6, -1.246800],
    [0.89141309, -0.42090443, 0.6, 0.028192], [-0.32402530, -0.01591529, 0.6, -1.543018],
    [0.60771245, 0.41635221, 0.6, -0.605411], [0.02379565, -0.08239821, 0.6, -3.809046],
    [0.48951152, -0.23657045, 0.6, -1.189011], [-0.17611565, -0.81696892, 0.6, -0.513724],
    [-0.33930185, -0.20732205, 0.6, -1.698047], [-0.91974425, 0.05403209, 0.6, 0.062246],
    [-0.15064627, -0.14949332, 0.6, -1.896062], [0.53180975, -0.35210401, 0.6, -0.758838],
    [0.41487166, 0.81442589, 0.6, -0.505648], [-0.24106961, -0.32721516, 0.6, -1.665244],
], dtype=np.float64)
AO_SAMPLES, AO_TILE, AO_MIPS, AO_MIP_OFFSET = 16, 4, 5, -4.3
AO_INTENSITY, AO_RADIUS, AO_BIAS = 6.0, 6.0, 0.1


@functools.lru_cache(maxsize=1)
def _ao_tables():
    """The 4x4 jitter tile's per-phase sample directions, weights, mip
    biases and weight sums."""
    rng = np.random.RandomState(12345)
    r = rng.rand(AO_TILE * AO_TILE, 3)
    ang = 2 * np.pi * r[:, 0]
    cos_a, sin_a = np.cos(ang), np.sin(ang)
    offset = np.floor(r[:, 1] * 32.0).astype(np.int64) & 31
    uv_scale = 0.5 + 0.5 * (0.5 + (r[:, 2] * 2 - 1) * 0.5)
    dirs = np.zeros((AO_SAMPLES, AO_TILE, AO_TILE, 2))
    wgts = np.zeros((AO_SAMPLES, AO_TILE, AO_TILE))
    mips = np.zeros((AO_SAMPLES, AO_TILE, AO_TILE))
    for t in range(AO_TILE * AO_TILE):
        ty, tx = t // AO_TILE, t % AO_TILE
        for i in range(AO_SAMPLES):
            s = _SAMPLE_PATTERN[(offset[t] + i) & 31]
            dirs[i, ty, tx] = ((s[0] * cos_a[t] - s[1] * sin_a[t]) * uv_scale[t],
                               (s[0] * sin_a[t] + s[1] * cos_a[t]) * uv_scale[t])
            wgts[i, ty, tx], mips[i, ty, tx] = s[2], s[3]
    return (dirs.astype(np.float32), wgts.astype(np.float32), mips.astype(np.float32),
            wgts.sum(axis=0).astype(np.float32))


def hbao(view_depth, proj):
    """(H, W) horizon-based ambient occlusion, blurred, from the linear
    depth and the perspective projection."""
    H, W = view_depth.shape
    dev = view_depth.device
    p = np.asarray(proj, np.float64)
    info = (2.0 / p[0, 0], 2.0 / p[1, 1], -(1.0 - p[0, 2]) / p[0, 0], -(1.0 + p[1, 2]) / p[1, 1])
    info = tuple(float(v) for v in info)
    proj_scl, z_max = float(p[1, 1] * 0.5), float(p[2, 3] / (p[2, 2] + 1.0)) * 0.99
    sx, sy, ox, oy = info
    d = torch.where(torch.isfinite(view_depth), view_depth, torch.full_like(view_depth, 1e8))
    u = ((torch.arange(W, dtype=F32, device=dev)[None, :] + 0.5) / W).expand(H, W)
    v = ((torch.arange(H, dtype=F32, device=dev)[:, None] + 0.5) / H).expand(H, W)

    def pos(uu, vv, dd):
        return torch.stack([(uu * sx + ox) * dd, (vv * sy + oy) * dd, dd], dim=-1)

    p0 = pos(u, v, d)
    px = pos(u + 1.0 / W, v, torch.cat([d[:, 1:], d[:, -1:]], dim=1))
    py = pos(u, v + 1.0 / H, torch.cat([d[1:, :], d[-1:, :]], dim=0))
    nrm = -torch.linalg.cross(px - p0, py - p0, dim=-1)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)

    dirs, wgts, mips, wsum = (torch.as_tensor(t, device=dev) for t in _ao_tables())
    phase = ((torch.arange(H, device=dev) % AO_TILE)[:, None] * AO_TILE
             + (torch.arange(W, device=dev) % AO_TILE)[None, :]).reshape(-1)

    def at(table):
        flat = table.reshape(AO_TILE * AO_TILE, *table.shape[2:])
        return flat[phase].reshape(H, W, *table.shape[2:])

    radius_to_screen = AO_RADIUS * 0.5 * proj_scl * H
    neg_inv_r2 = -1.0 / (AO_RADIUS * AO_RADIUS)
    bias = min(max(AO_BIAS, 0.0), 1.0 - 1e-7)
    radius_px = (radius_to_screen / d).clamp_min(3.0)
    mip_offset = torch.log2(radius_px * 4.0) + AO_MIP_OFFSET
    levels, cur = [d], d
    for _ in range(1, AO_MIPS):
        h, w = cur.shape
        q = cur
        if h & 1:
            q = torch.cat([q, q[-1:, :]], dim=0)
        if w & 1:
            q = torch.cat([q, q[:, -1:]], dim=1)
        ph, pw = q.shape
        cur = q.reshape(ph // 2, 2, pw // 2, 2).mean(dim=(1, 3))
        k = 2 ** len(levels)
        levels.append(cur.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)[:H, :W])
    stack = torch.stack(levels).reshape(-1)
    P = p0.unbind(-1)
    N = nrm.unbind(-1)
    ao = torch.zeros_like(d)
    for i in range(AO_SAMPLES):
        duv = at(dirs[i]) * radius_px[..., None]
        su, sv = u + duv[..., 0] / W, v + duv[..., 1] / H
        m = torch.round(mip_offset + at(mips[i])).clamp(0, AO_MIPS - 1).long()
        xi = (su * W).to(torch.int32).clamp(0, W - 1).long()
        yi = (sv * H).to(torch.int32).clamp(0, H - 1).long()
        sz = stack[m * (H * W) + yi * W + xi]
        S = ((su * sx + ox) * sz, (sv * sy + oy) * sz, sz)
        V = [S[j] - P[j] for j in range(3)]
        vdotv = V[0] * V[0] + V[1] * V[1] + V[2] * V[2]
        ndotv = (N[0] * V[0] + N[1] * V[1] + N[2] * V[2]) * torch.rsqrt(vdotv.clamp_min(1e-12))
        falloff = (vdotv * neg_inv_r2 + 1.0).clamp_min(0.0)
        ao = ao + (ndotv - bias).clamp_min(0.0) * falloff * at(wgts[i])
    ao = (1.0 - ao * ((1.0 / (1.0 - bias)) / at(wsum))).clamp(0.0, 1.0)
    ao = ao ** max(AO_INTENSITY, 0.0)
    ao = torch.where(d > z_max, torch.ones_like(ao), ao)
    sharp = float(4.0 / np.sqrt(max(AO_RADIUS, 1e-6)))
    fall = 1.0 / (2.0 * 1.5 * 1.5)

    def shift(img, s, axis):
        n = img.shape[axis]
        return img.index_select(axis, (torch.arange(n, device=dev) + s).clamp(0, n - 1))

    def blur(c, axis):
        total, wtot = c, torch.ones_like(c)
        for r in range(1, 4):
            for sg in (1, -1):
                dd = (shift(d, sg * r, axis) - d) * sharp
                w = torch.exp2(-r * r * fall - dd * dd)
                total = total + shift(c, sg * r, axis) * w
                wtot = wtot + w
        return torch.where(d > z_max, c, total / wtot)

    return blur(blur(ao, 1), 0)


def _luma(rgb3):
    f64 = torch.float64
    r, g, b = (rgb3[..., i].to(f64) for i in range(3))
    w0, w1, w2 = (float(torch.tensor(w, dtype=F32)) for w in (0.299, 0.587, 0.114))
    acc = (r * w0).to(F32).to(f64)
    acc = (g * w1 + acc).to(F32).to(f64)
    return (b * w2 + acc).to(F32)


def _bilinear(flat, X, Y, W: int, H: int):
    x0, y0 = torch.floor(X - 0.5), torch.floor(Y - 0.5)
    fx, fy = (X - 0.5 - x0)[..., None], (Y - 0.5 - y0)[..., None]
    x0 = x0.to(torch.int32).clamp(0, W - 1).long()
    y0 = y0.to(torch.int32).clamp(0, H - 1).long()
    x1, y1 = (x0 + 1).clamp_max(W - 1), (y0 + 1).clamp_max(H - 1)
    top = flat[y0 * W + x0] * (1 - fx) + flat[y0 * W + x1] * fx
    bot = flat[y1 * W + x0] * (1 - fx) + flat[y1 * W + x1] * fx
    return top * (1 - fy) + bot * fy


def fxaa(rgb, subpix=0.5, edge_threshold=0.125, edge_threshold_min=0.0625):
    """FXAA 3.11, PC quality preset 12, clamp to edge."""
    nch = rgb.shape[-1]
    luma = _luma(rgb[..., :3])
    H, W = luma.shape
    lp = torch.cat([luma[:, :1], luma, luma[:, -1:]], dim=1)
    lp = torch.cat([lp[:1], lp, lp[-1:]], dim=0)
    lM = luma
    lN, lS = lp[0:H, 1:W + 1], lp[2:H + 2, 1:W + 1]
    lW, lE = lp[1:H + 1, 0:W], lp[1:H + 1, 2:W + 2]
    lNW, lNE = lp[0:H, 0:W], lp[0:H, 2:W + 2]
    lSW, lSE = lp[2:H + 2, 0:W], lp[2:H + 2, 2:W + 2]
    mx, mn = torch.maximum, torch.minimum
    rng_max = mx(lM, mx(mx(lN, lS), mx(lW, lE)))
    rng_min = mn(lM, mn(mn(lN, lS), mn(lW, lE)))
    rng = rng_max - rng_min
    early_exit = rng < (rng_max * edge_threshold).clamp_min(edge_threshold_min)
    luma_ns, luma_we = lN + lS, lW + lE
    subpix_rcp_range = 1.0 / rng.clamp_min(1e-12)
    subpix_nswe = luma_ns + luma_we
    edge_horz = ((-2.0 * lW + (lNW + lSW)).abs() + (-2.0 * lM + luma_ns).abs() * 2.0
                 + (-2.0 * lE + (lNE + lSE)).abs())
    edge_vert = ((-2.0 * lS + (lSW + lSE)).abs() + (-2.0 * lM + luma_we).abs() * 2.0
                 + (-2.0 * lN + (lNW + lNE)).abs())
    horz_span = edge_horz >= edge_vert
    luma1 = torch.where(horz_span, lN, lW)
    luma2 = torch.where(horz_span, lS, lE)
    gradient1, gradient2 = luma1 - lM, luma2 - lM
    pair1 = gradient1.abs() >= gradient2.abs()
    gradient = mx(gradient1.abs(), gradient2.abs())
    one = torch.ones_like(lM)
    length_sign = torch.where(pair1, -one, one)
    luma_pair = torch.where(pair1, luma1 + lM, luma2 + lM)
    subpix_a = subpix_nswe * 2.0 + (lNW + lNE + lSW + lSE)
    subpix_b = subpix_a * (1.0 / 12.0) - lM
    subpix_c = (subpix_b.abs() * subpix_rcp_range).clamp(0.0, 1.0)
    subpix_f = (-2.0 * subpix_c + 3.0) * (subpix_c * subpix_c)
    subpix_h = (subpix_f * subpix_f) * subpix
    gradient_scaled = gradient * 0.25
    luma_m_lt_zero = (lM - luma_pair * 0.5) < 0.0
    dev = luma.device
    xs = (torch.arange(W, dtype=F32, device=dev)[None, :] + 0.5).expand(H, W)
    ys = (torch.arange(H, dtype=F32, device=dev)[:, None] + 0.5).expand(H, W)
    pos_bx = torch.where(horz_span, xs, xs + length_sign * 0.5)
    pos_by = torch.where(horz_span, ys + length_sign * 0.5, ys)
    zero = torch.zeros_like(lM)
    off_x = torch.where(horz_span, one, zero)
    off_y = torch.where(horz_span, zero, one)
    luma_flat = luma.reshape(-1, 1)

    def end_luma(px, py):
        return _bilinear(luma_flat, px, py, W, H)[..., 0] - luma_pair * 0.5

    steps = (1.0, 1.5, 2.0, 4.0, 12.0)
    pos_nx, pos_ny = pos_bx - off_x * steps[0], pos_by - off_y * steps[0]
    pos_px, pos_py = pos_bx + off_x * steps[0], pos_by + off_y * steps[0]
    luma_end_n, luma_end_p = end_luma(pos_nx, pos_ny), end_luma(pos_px, pos_py)
    done_n = luma_end_n.abs() >= gradient_scaled
    done_p = luma_end_p.abs() >= gradient_scaled
    for step in steps[1:]:
        pos_nx = torch.where(done_n, pos_nx, pos_nx - off_x * step)
        pos_ny = torch.where(done_n, pos_ny, pos_ny - off_y * step)
        pos_px = torch.where(done_p, pos_px, pos_px + off_x * step)
        pos_py = torch.where(done_p, pos_py, pos_py + off_y * step)
        luma_end_n = torch.where(done_n, luma_end_n, end_luma(pos_nx, pos_ny))
        luma_end_p = torch.where(done_p, luma_end_p, end_luma(pos_px, pos_py))
        done_n = done_n | (luma_end_n.abs() >= gradient_scaled)
        done_p = done_p | (luma_end_p.abs() >= gradient_scaled)
    dst_n = torch.where(horz_span, xs - pos_nx, ys - pos_ny)
    dst_p = torch.where(horz_span, pos_px - xs, pos_py - ys)
    good_span = torch.where(dst_n < dst_p, (luma_end_n < 0.0) != luma_m_lt_zero,
                            (luma_end_p < 0.0) != luma_m_lt_zero)
    pixel_offset = mn(dst_n, dst_p) * (-1.0 / (dst_p + dst_n).clamp_min(1e-12)) + 0.5
    offset = mx(torch.where(good_span, pixel_offset, zero), subpix_h)
    pos_mx = torch.where(horz_span, xs, xs + offset * length_sign)
    pos_my = torch.where(horz_span, ys + offset * length_sign, ys)
    rgb3 = rgb[..., :3]
    out3 = _bilinear(rgb3.reshape(-1, 3), pos_mx, pos_my, W, H)
    out3 = torch.where(early_exit[..., None], rgb3, out3)
    return torch.cat([out3, rgb[..., 3:]], dim=-1) if nch > 3 else out3


def tonemap(rgba, ao):
    """The ACES tonemap of the occluded colour, composited over the
    background by alpha → (H, W, 3)."""
    x = (rgba[..., :3] * ao[..., None]).clamp_min(0.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    rgb = ((x * (a * x + b)) / (x * (c * x + d) + e)).clamp(0.0, 1.0)
    bg = torch.tensor(BACKGROUND, dtype=F32, device=rgba.device)
    return rgb * rgba[..., 3:] + bg * (1 - rgba[..., 3:])


# -- the frame ------------------------------------------------------------------------------


class Scene:
    """The inputs every frame shares: the frames, the atoms' colours and
    radii, the selection (the mix's `residue(first:last)`), and the SDF
    volume over all frames."""

    def __init__(self, wb: WaterBox, stack, config: dict, traffic: dict, control: bool = False):
        dev = stack.device
        self.q = (lambda t: t.to(torch.bfloat16).to(t.dtype)) if control else (lambda t: t)
        self.wb, self.stack, self.traffic = wb, stack, traffic
        self.width, self.height = traffic["width"], traffic["height"]
        self.basis = torch.as_tensor(wb.basis, device=dev)
        self.inv = torch.linalg.inv_ex(self.basis).inverse.contiguous()
        # the system cell's inverse, as the float64 reciprocal rounded once
        self.inv_sys = torch.as_tensor(np.diag(np.full(3, 1.0 / wb.box)).astype(np.float32),
                                       device=dev)
        lo, hi = (int(v) for v in traffic["selection"][len("residue("):-1].split(":"))
        self.selected = torch.as_tensor((wb.res_ids >= lo) & (wb.res_ids <= hi), device=dev)
        cols = wb.colors()
        sel = ~self.selected.cpu().numpy()
        lum = cols[sel, :3] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
        cols[sel, :3] = cols[sel, :3] * (1 - DESATURATE) + lum[:, None] * DESATURATE
        c8 = torch.round(torch.as_tensor(cols[:, :3], device=dev).clamp(0.0, 1.0) * 255.0).int()
        self.packed = (c8[:, 0] << 16) | (c8[:, 1] << 8) | c8[:, 2]
        self.radii = torch.as_tensor(wb.radii(), device=dev)
        res = analysis.evaluate(wb, stack, config, rdf=False)
        self.structures = analysis.Structures(wb, range(1, 65), dev, F32)
        n_struct = self.structures.idx.shape[0]
        grid = (res["v"] / (stack.shape[0] * n_struct)).to(F32)
        self.vmax = float(grid.max()) or 1.0
        self.grid = self.q(grid.contiguous())
        self.tf = torch.as_tensor(transfer_function(), device=dev)
        self.jitter = torch.rand(self.width * self.height,
                                 generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    def coords(self, t: float):
        F = self.stack.shape[0]
        f = float(np.clip(t, 0, F - 1))
        i0 = int(np.floor(f))
        tt = f - i0
        if tt < 1e-6:
            return self.stack[int(round(f))]
        x0, x1 = self.stack[i0], self.stack[min(i0 + 1, F - 1)]
        return x0 + analysis.min_image(x1 - x0, self.basis, self.inv) * tt

    def frame(self, t: float, cam: dict):
        """The composed frame at playback position t seen from `cam` (eye,
        center, up, fovy, znear, zfar) → (rgba, depth, pick, volume alpha)."""
        q, W, H = self.q, self.width, self.height
        x = q(self.coords(t))
        # the camera's vectors as the viewer holds them, in float32
        view = look_at(*(np.asarray(cam[k], np.float32) for k in ("eye", "center", "up")))
        proj = perspective(cam["fovy"], W / max(H, 1), cam["znear"], cam["zfar"])
        pv = torch.stack([x[:, 0] * float(view[j, 0]) + x[:, 1] * float(view[j, 1])
                          + x[:, 2] * float(view[j, 2]) + float(view[j, 3]) for j in range(3)], 1)
        sph = q(torch.cat([pv, self.radii[:, None]], 1).contiguous())
        rgba, depth, pick = raster(sph, self.packed, shading(proj, W, H), W, H)
        rgba, depth = q(rgba), q(depth)
        img = outline(rgba, pick, self.selected)
        st = self.structures
        R, c = analysis.align(x[st.idx], st.w, st.ref, self.basis, self.inv_sys)
        R, c = R.cpu().numpy(), c.cpu().numpy()
        M = np.tile(np.eye(4, dtype=np.float32), (R.shape[0], 1, 1))
        M[:, :3, :3] = R
        M[:, :3, 3] = -np.einsum("sij,sj->si", R, c)
        e = np.full(3, 5.0)
        tex2ref = np.eye(4)
        tex2ref[:3, :3], tex2ref[:3, 3] = np.diag(2 * e), -e
        model = np.linalg.inv(M[0]) @ tex2ref.astype(np.float32)
        vimg = q(march(self.grid, self.tf, self.vmax, model, view, proj, W, H, self.jitter, depth))
        va = vimg[..., 3:4]
        img = q(torch.cat([vimg[..., :3] + img[..., :3] * (1.0 - va), va + img[..., 3:4] * (1.0 - va)], -1))
        ao = q(hbao(depth, proj))
        rgb = q(tonemap(img, ao))
        rgb = fxaa(rgb).clamp(0, 1)
        return torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1), depth, pick, va[..., 0]


def compare(got: tuple, want: tuple) -> dict:
    """The numbers `correct` is decided on, for one frame: the share of
    pixels whose pick differs; the largest relative depth gap where both
    picked the same atom; the mean gap of the displayed rgb over all pixels,
    and over the pixels the volume covers (its alpha above 1e-3)."""
    rgba, depth, pick = (t.float() if t.is_floating_point() else t for t in got)
    w_rgba, w_depth, w_pick, w_va = want
    same = (pick == w_pick) & (w_pick >= 0)
    gap = ((depth - w_depth).abs() / w_depth.abs().clamp_min(1e-30))[same]
    drgb = (rgba[..., :3] - w_rgba[..., :3]).abs()
    vol = w_va > 1e-3
    return {
        "pick_mismatch": float((pick != w_pick).float().mean()),
        "depth_rel_max": float(gap.max()) if gap.numel() else 0.0,
        "rgb_mean_abs": float(drgb.mean()),
        "volume_rgb_mean_abs": float(drgb[vol].mean()) if bool(vol.any()) else 0.0,
    }
