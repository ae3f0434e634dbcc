"""Headless molecule renderer: tiled sphere / capsule impostor ray casting.

Torch port of viamd_tpu/render/raster.py (`RasterSettings`,
`render_molecules`). The scene goes through four steps, all on the caller's
device:

1. the view transform, written out elementwise (no (n, 3) @ (3, 3) product)
   and, for licorice / ball-and-stick, the two half-capsules of every bond,
   each coloured and picked by its own atom (raster.py:746-784);
2. `bin_primitives`: each primitive's conservative screen box → the 16×16
   tiles it touches → per-tile CSR candidate lists (a sort of the
   primitives by near depth, a cumsum, an expansion in that order and a
   stable sort by tile, so each list runs front to back, ties in primitive
   order). There is no capacity: every candidate is kept;
3. the ray cast of every tile, render/cuda_raster.py (the CUDA kernel
   csrc/raster.cu on a CUDA device, its plain version on the CPU);
4. the image: (H, W, 4) rgba, (H, W) view depth (+inf where nothing is
   hit) and (H, W) int32 picks, the atom id of the nearest hit (-1 = none).

Not ported, because nothing needs them without capacities: the XLA engine
(a CPU oracle in the JAX package), the vertical strips, the small / big /
huge sphere tiers, the depth-bucket sort key, the huge-tier auto-raise, and
the capacity knobs of `RasterSettings` (`capacity`, `home_capacity`,
`huge_cap`, `huge_capsule_cap`, `engine`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from viamd_tpu_torch.core.tracing import section
from viamd_tpu_torch.ops.rdf import sqrt_rn
from viamd_tpu_torch.render.cuda_raster import (
    TILE,
    Shading,
    near_depth_capsules,
    near_depth_spheres,
    raster_tiles,
    shading_params,
)

__all__ = [
    "RasterSettings",
    "Scene",
    "TileLists",
    "bin_primitives",
    "build_scene",
    "render_molecules",
    "render_scene",
]

# screen boxes are widened by this many pixels on every side, so float32
# rounding in the kernel's ray tests can never reach a pixel outside them
BOX_MARGIN_PX = 1.0


@dataclass(frozen=True)
class RasterSettings:
    width: int = 512
    height: int = 512
    rep: str = "spacefill"  # spacefill | licorice | ballstick
    radius_scale: float = 1.0
    licorice_radius: float = 0.25
    ambient: float = 0.25
    specular: float = 0.35
    shininess: float = 48.0
    light_dir: tuple = (0.4, 0.7, 0.6)
    background: tuple = (0.0, 0.0, 0.0, 0.0)


@dataclass
class TileLists:
    """Per-tile CSR candidate lists: tile i tests spheres
    s_list[s_start[i]:s_start[i+1]], then capsules likewise; each list in
    ascending near depth, ties in primitive order."""

    s_start: torch.Tensor  # (T + 1,) int32
    s_list: torch.Tensor  # (entries,) int32 sphere ids
    c_start: torch.Tensor
    c_list: torch.Tensor


@dataclass
class Scene:
    """Everything the ray cast reads (cuda_raster.raster_tiles' inputs)."""

    sph: torch.Tensor  # (ns, 4) f32 view-space centre, radius
    sph_ci: torch.Tensor  # (ns, 2) int32 packed colour, atom id
    cyl: torch.Tensor  # (nc, 8) f32 p0, unit axis, length, radius
    cyl_ci: torch.Tensor  # (nc, 2) int32 packed colour, owner atom id
    lists: TileLists
    width: int
    height: int
    shading: Shading

    def raster_args(self) -> tuple:
        ls = self.lists
        return (
            self.sph, self.sph_ci, self.cyl, self.cyl_ci, ls.s_start,
            ls.s_list, ls.c_start, ls.c_list, self.width, self.height,
            self.shading,
        )


def _tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _pixel_range(c, w, r, den, bounded, pdiag: float, pjit: float, n: int):
    """Pixels [lo, hi] (int64, lo > hi when none) whose centre ray along one
    screen axis can meet the sphere (centre c across, w deep, radius r):
    the two planes through the eye and the other screen axis that touch
    the sphere bound the ray slopes to (c·w ∓ r·sqrt(c² + w² − r²)) /
    (w² − r²), exactly. A pixel's slope is ((u + 0.5)·2/n − 1 + jit) / p.
    Unbounded (the sphere reaches the eye plane): the whole axis."""
    s = torch.sqrt((c * c + w * w - r * r).clamp_min(0.0))
    ends = []
    for sign in (-1.0, 1.0):
        slope = (c * w + sign * r * s) / den
        ends.append(((slope * pdiag - pjit) + 1.0) * (n * 0.5) - 0.5)
    u0 = torch.minimum(*ends) - BOX_MARGIN_PX
    u1 = torch.maximum(*ends) + BOX_MARGIN_PX
    u0 = torch.where(bounded, u0, torch.full_like(u0, -1.0))
    u1 = torch.where(bounded, u1, torch.full_like(u1, float(n)))
    lo = torch.ceil(u0.clamp(-1.0, float(n))).long().clamp_min(0)
    hi = torch.floor(u1.clamp(-1.0, float(n))).long().clamp_max(n - 1)
    return lo, hi


def _tile_boxes(x, y, z, r, sh: Shading, width: int, height: int):
    """Tile box (tx0, tx1, ty0, ty1) of each sphere's projection, in float64
    from its float32 view-space centre and radius; boxes of spheres that
    reach the eye plane cover the whole frame. Empty boxes have tx0 > tx1
    or ty0 > ty1."""
    x, y, z, r = (v.double() for v in (x, y, z, r))
    w = -z
    bounded = w > r * (1.0 + 1e-4)
    den = torch.where(bounded, w * w - r * r, torch.ones_like(w))
    px0, px1 = _pixel_range(x, w, r, den, bounded, sh.p00, sh.p02, width)
    py0, py1 = _pixel_range(y, w, r, den, bounded, sh.p11, sh.p12, height)
    return px0 // TILE, px1 // TILE, py0 // TILE, py1 // TILE


def _box_counts(box, keep):
    tx0, tx1, ty0, ty1 = box
    wx = (tx1 - tx0 + 1).clamp_min(0)
    wy = (ty1 - ty0 + 1).clamp_min(0)
    return torch.where(keep, wx * wy, torch.zeros_like(wx)), wx


def _depth_order(near: torch.Tensor) -> torch.Tensor:
    """The primitives in ascending near depth, ties in primitive order."""
    return torch.sort(near, stable=True).indices


def _csr(box, cnt, wx, order, total: int, tiles_x: int, ntiles: int):
    """CSR lists of the (tile, primitive) entries of every box, the
    primitives expanded in `order`, so that the stable sort by tile keeps
    that order within each tile's list."""
    dev = cnt.device
    n = cnt.shape[0]
    cnt_o = cnt[order]
    run = torch.repeat_interleave(
        torch.arange(n, device=dev), cnt_o, output_size=total
    )
    prim = order[run]
    first = torch.cumsum(cnt_o, 0) - cnt_o
    local = torch.arange(total, device=dev) - first[run]
    w = wx[prim]
    tile = (box[2][prim] + local // w) * tiles_x + box[0][prim] + local % w
    tile_sorted, by_tile = torch.sort(tile.int(), stable=True)
    start = torch.searchsorted(
        tile_sorted, torch.arange(ntiles + 1, dtype=torch.int32, device=dev)
    ).int()
    return start, prim[by_tile].int()


def bin_primitives(sph, cyl, sh: Shading, width: int, height: int) -> TileLists:
    """Per-tile CSR lists of the spheres and half-capsules whose screen box
    touches the tile.

    Spheres: drawn only with the centre in front of the eye (view depth
    > 1e-6, JAX's rule, raster.py:191); boxed exactly (`_tile_boxes`).
    Half-capsules: a capsule lies inside the convex hull of its two end
    spheres, so the union of the two end boxes bounds it; one that reaches
    the eye plane covers the whole frame, one wholly behind the eye (both
    ends deeper than −r) is dropped. Each list runs in ascending near depth
    (cuda_raster.near_depth_spheres / near_depth_capsules, which the kernel
    recomputes to cull front to back), ties in primitive order. One host
    sync, for the two list sizes.
    """
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    ntiles = tiles_x * tiles_y
    sbox = _tile_boxes(sph[:, 0], sph[:, 1], sph[:, 2], sph[:, 3], sh, width, height)
    scnt, swx = _box_counts(sbox, -sph[:, 2] > 1e-6)
    p0 = cyl[:, 0:3]
    p1 = p0 + cyl[:, 3:6] * cyl[:, 6:7]
    rr = cyl[:, 7]
    b0 = _tile_boxes(p0[:, 0], p0[:, 1], p0[:, 2], rr, sh, width, height)
    b1 = _tile_boxes(p1[:, 0], p1[:, 1], p1[:, 2], rr, sh, width, height)
    cbox = (
        torch.minimum(b0[0], b1[0]), torch.maximum(b0[1], b1[1]),
        torch.minimum(b0[2], b1[2]), torch.maximum(b0[3], b1[3]),
    )
    front = (-p0[:, 2] + rr > 0) | (-p1[:, 2] + rr > 0)
    ccnt, cwx = _box_counts(cbox, front)
    n_s, n_c = torch.stack([scnt.sum(), ccnt.sum()]).tolist()
    s_order = _depth_order(near_depth_spheres(sph))
    c_order = _depth_order(near_depth_capsules(cyl))
    s_start, s_list = _csr(sbox, scnt, swx, s_order, n_s, tiles_x, ntiles)
    c_start, c_list = _csr(cbox, ccnt, cwx, c_order, n_c, tiles_x, ntiles)
    return TileLists(s_start, s_list, c_start, c_list)


def _pack_rgb(colors: torch.Tensor) -> torch.Tensor:
    """(n, ≥3) float colours → int32 0xRRGGBB, 8 bits a channel rounded half
    to even (raster.py:339-343)."""
    c = torch.round(colors[:, :3].clamp(0.0, 1.0) * 255.0).int()
    return (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]


def build_scene(
    positions, radii, colors, view, proj, settings: RasterSettings,
    bonds=None, *, device,
) -> Scene:
    """The ray cast's inputs for one frame: view-space spheres, bond
    half-capsules for licorice / ball-and-stick, and the tile lists.
    Arrays may be numpy or tensors; everything is made on `device`."""
    s = settings
    dev = torch.device(device)
    f32 = torch.float32
    pos = _tensor(positions, f32, dev)
    vm = np.asarray(view, np.float32)
    pv = torch.stack(
        [
            pos[:, 0] * float(vm[j, 0]) + pos[:, 1] * float(vm[j, 1])
            + pos[:, 2] * float(vm[j, 2]) + float(vm[j, 3])
            for j in range(3)
        ],
        dim=1,
    )
    rad = _tensor(radii, f32, dev) * s.radius_scale
    cols = _tensor(colors, f32, dev)
    packed = _pack_rgb(cols)
    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=dev)
    cyl = torch.zeros((0, 8), dtype=f32, device=dev)
    cyl_ci = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    if s.rep in ("licorice", "ballstick"):
        keep = rad > 0  # radius 0 = culled (filtered-out) atoms
        if s.rep == "licorice":
            rad = torch.where(keep, s.licorice_radius, 0.0)
        else:
            rad = rad * 0.35
        b = None if bonds is None else _tensor(bonds, torch.long, dev)
        if b is not None and b.shape[0]:
            b = b[keep[b[:, 0]] & keep[b[:, 1]]]
        if b is not None and b.shape[0]:
            pa, pb = pv[b[:, 0]], pv[b[:, 1]]
            mid = (pa + pb) * 0.5
            halves, owners = [], []
            for p_from, owner in ((pa, b[:, 0]), (pb, b[:, 1])):
                axis = mid - p_from
                length = sqrt_rn(
                    axis[:, 0] * axis[:, 0] + axis[:, 1] * axis[:, 1]
                    + axis[:, 2] * axis[:, 2]
                )[:, None]
                axis = axis / length.clamp_min(1e-12)
                halves.append(torch.cat(
                    [p_from, axis, length, torch.full_like(length, s.licorice_radius)],
                    dim=1,
                ))
                owners.append(owner)
            cyl = torch.cat(halves).contiguous()
            owner = torch.cat(owners)
            cyl_ci = torch.stack([packed[owner], owner.int()], dim=1).contiguous()
    sph = torch.cat([pv, rad[:, None]], dim=1).contiguous()
    sph_ci = torch.stack([packed, ids], dim=1).contiguous()
    sh = shading_params(
        proj, s.width, s.height, s.ambient, s.specular, s.shininess,
        s.light_dir, s.background,
    )
    lists = bin_primitives(sph, cyl, sh, s.width, s.height)
    return Scene(sph, sph_ci, cyl, cyl_ci, lists, s.width, s.height, sh)


def render_scene(scene: Scene):
    """Ray cast a built scene → (rgba, depth, pick) on its device."""
    return raster_tiles(*scene.raster_args())


def render_molecules(
    positions,  # (n, 3) world
    radii,  # (n,)
    colors,  # (n, 4)
    view,  # (4, 4) world → view
    proj,  # (4, 4) view → clip
    settings: RasterSettings,
    bonds=None,  # (m, 2) atom index pairs, licorice / ball-and-stick
    *,
    device,
):
    """Render atoms (+ bond half-capsules for licorice / ball-and-stick) →
    ((H, W, 4) rgba, (H, W) view depth, (H, W) int32 picks) as tensors on
    `device`. A pick is the atom id of the nearest hit, -1 where nothing is
    hit — the reference's GBuffer picking attachment (viamd.h:1687-1760)."""
    with section("raster.scene"):
        scene = build_scene(positions, radii, colors, view, proj, settings, bonds,
                            device=device)
    with section("raster.kernel"):
        return render_scene(scene)
