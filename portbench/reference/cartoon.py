"""Plain reference of a composed cartoon frame: the capsid's chains at a
playback position drawn as secondary-structure ribbons seen from a camera,
the selection's outline, then ambient occlusion (HBAO), the ACES tonemap
over the background and FXAA 3.11.

Plain PyTorch and numpy that import nothing of the program and take
nothing it made: the backbone, the chains and the selection come from the
generator's layout (`portbench/capsid.py`). The arithmetic is a frozen copy
of the plain versions the port is held to:
- phi/psi of every residue with the minimum image, and the (coil, helix,
  sheet) weights of their zone ellipses;
- the secondary-structure colours, desaturated outside the selection;
- the ribbon mesh (a Catmull-Rom spline through the CA trace, the
  peptide plane's orientation, the cartoon's profiles and sheet
  arrowheads), in float64 numpy;
- the view transform, written out elementwise in float32;
- the triangle ray cast: each pixel tests every triangle whose screen box
  touches its 16x16 tile (the box of the projected vertices, depths
  clamped to 1e-2), in ascending near depth, ties in triangle order, and
  keeps a hit only when strictly nearer (Moller-Trumbore from the eye, two
  sided, in the kernel's operations), then the lit shading.
Outline, HBAO, tonemap and FXAA are `portbench/reference/render.py`'s.

`Scene(..., control=True)` is the control: the same chain with every
tensor it hands from one stage to the next rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.capsid import Capsid
from portbench.reference import analysis
from portbench.reference.render import (
    DESATURATE, F32, compare as compare_frames, div_rn, fxaa, hbao, look_at, outline,
    perspective, tonemap,
)

TILE = 16
SUBDIV = 8  # spline samples a residue
# the cartoon's profile (A) and the sheet arrowhead's widening
COIL_WIDTH, COIL_THICKNESS, RIBBON_WIDTH, RIBBON_THICKNESS, ARROW_SCALE = 0.6, 0.5, 2.2, 0.35, 1.6
LIGHT = (0.57735, 0.57735, 0.57735)
SS_COLORS = np.array([[0.75, 0.75, 0.75, 1.0], [0.85, 0.25, 0.65, 1.0],
                      [0.95, 0.75, 0.25, 1.0]], np.float32)  # coil, helix, sheet
# (phi0, psi0, r_phi, r_psi) zone ellipses, degrees
HELIX_ZONE = (-80.0, -40.0, 50.0, 50.0)
SHEET_ZONE = (-110.0, 130.0, 70.0, 60.0)


def triangle_count(n_chains: int, residues_per_chain: int) -> int:
    """Triangles of the cartoon of `n_chains` chains: 4 faces x 2 between
    consecutive spline samples, (residues - 1) x SUBDIV of them, and two
    caps of 2."""
    return n_chains * (8 * SUBDIV * (residues_per_chain - 1) + 4)


# -- secondary structure -------------------------------------------------------------


def dihedral(b1, b2, b3):
    """Signed dihedral of consecutive (..., 3) bond vectors, radians."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2n = b2 / torch.sqrt((b2 * b2).sum(-1, keepdim=True).clamp_min(1e-30))
    m1 = torch.linalg.cross(n1, b2n)
    return torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1))


def zone_weight(phi_deg, psi_deg, zone):
    p0, s0, rp, rs = zone
    dpsi = (psi_deg - s0 + 180.0) % 360.0 - 180.0
    qp, qs = div_rn(phi_deg - p0, rp), div_rn(dpsi, rs)
    return torch.clamp(1.0 - (qp * qp + qs * qs), 0.0, 1.0)


def ss_weights(x, cap: Capsid, basis, inv):
    """(residues, 3) float32 (coil, helix, sheet) weights of one frame's
    coordinates x (n, 3): the zone weights of each residue's phi/psi, a
    chain's first and last residues coil."""
    dev = x.device
    xn, xca, xc = (x[torch.as_tensor(cap.backbone(a), device=dev)] for a in ("N", "CA", "C"))

    def bond(p, q):
        return analysis.min_image(q - p, basis, inv)

    b_n_ca, b_ca_c = bond(xn, xca), bond(xca, xc)
    phi = dihedral(bond(torch.roll(xc, 1, dims=-2), xn), b_n_ca, b_ca_c)
    psi = dihedral(b_n_ca, b_ca_c, bond(xc, torch.roll(xn, -1, dims=-2)))
    pos = torch.arange(xca.shape[0], device=dev) % cap.residues_per_chain
    valid = (pos > 0) & (pos < cap.residues_per_chain - 1)
    deg = 57.29577951308232
    phi_d, psi_d = phi * deg, psi * deg
    zero = torch.zeros((), dtype=phi.dtype, device=dev)
    h = torch.where(valid, zone_weight(phi_d, psi_d, HELIX_ZONE), zero)
    s = torch.where(valid, zone_weight(phi_d, psi_d, SHEET_ZONE), zero)
    c = torch.clamp(1.0 - h - s, 0.0, 1.0)
    tot = (c + h + s).clamp_min(1e-30)
    return torch.stack([c / tot, h / tot, s / tot], dim=-1)


def atom_colors(cap: Capsid, w: np.ndarray, selected: np.ndarray) -> np.ndarray:
    """(n, 4) float32 colours: each protein residue's blend of SS_COLORS by
    its weights w, coil grey elsewhere; desaturated outside `selected`."""
    res_rgb = np.asarray(w, np.float32) @ SS_COLORS
    cols = np.tile(SS_COLORS[0], (cap.n_atoms, 1))
    cols[:cap.n_protein_atoms] = np.repeat(res_rgb, cap.n_protein_atoms // res_rgb.shape[0], 0)
    sel = ~selected
    lum = cols[sel, :3] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    cols[sel, :3] = cols[sel, :3] * (1 - DESATURATE) + lum[:, None] * DESATURATE
    return cols


# -- the ribbon mesh -----------------------------------------------------------------


def _spline(P: np.ndarray) -> np.ndarray:
    """Catmull-Rom through control points P (k, d) -> ((k - 1) SUBDIV + 1, d)."""
    Ppad = np.concatenate([P[:1] * 2 - P[1:2], P, P[-1:] * 2 - P[-2:-1]])
    t = np.linspace(0.0, 1.0, SUBDIV, endpoint=False)[:, None]
    segs = []
    for s in range(P.shape[0] - 1):
        p0, p1, p2, p3 = Ppad[s], Ppad[s + 1], Ppad[s + 2], Ppad[s + 3]
        segs.append(0.5 * (2 * p1 + (-p0 + p2) * t + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
                           + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t))
    segs.append(P[-1:])
    return np.concatenate(segs)


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def ribbon_mesh(coords: np.ndarray, cap: Capsid, w: np.ndarray):
    """The cartoon of every chain -> (tris (T, 3, 3) float32 world, src (T,)
    int32 the CA atom each triangle stands for)."""
    ca, c_at, o_at = (cap.backbone(a) for a in ("CA", "C", "O"))
    tris_out, src_out = [], []
    for beg, end in cap.chain_ranges():
        k = end - beg
        idx = ca[beg:end]
        P = coords[idx].astype(np.float64)
        # the peptide plane: C=O normal to the chain, flipped to follow it
        co = coords[o_at[beg:end]] - coords[c_at[beg:end]]
        tan_res = _unit(np.gradient(P, axis=0))
        od = _unit(co - tan_res * np.sum(co * tan_res, axis=1, keepdims=True))
        for i in range(1, k):
            if np.dot(od[i], od[i - 1]) < 0.0:
                od[i] = -od[i]
        w3 = np.asarray(w[beg:end], np.float64)
        flat_w = w3[:, 1] + w3[:, 2]
        width_res = COIL_WIDTH + (RIBBON_WIDTH - COIL_WIDTH) * flat_w
        thick_res = COIL_THICKNESS + (RIBBON_THICKNESS - COIL_THICKNESS) * flat_w
        sheet = w3[:, 2] > 0.5
        arrow_at = np.zeros(k, bool)
        for i in range(k):
            if sheet[i] and (i + 1 >= k or not sheet[i + 1]):
                arrow_at[i] = True
        S = _spline(P)
        O = _unit(_spline(od))
        m = S.shape[0]
        u = np.arange(m) / SUBDIV
        ui = np.minimum(u.astype(np.int64), k - 1)
        uf = u - ui
        nxt = np.minimum(ui + 1, k - 1)
        width_s = width_res[ui] * (1 - uf) + width_res[nxt] * uf
        thick_s = thick_res[ui] * (1 - uf) + thick_res[nxt] * uf
        # a sheet run's last residue owns u in [i - 0.5, i]: the arrowhead
        # widens to ARROW_SCALE there and tapers to a point at its CA
        for i in np.nonzero(arrow_at)[0]:
            if i == 0:
                continue
            seg = (u >= i - 0.5) & (u <= i + 1e-9)
            f = (u[seg] - (i - 0.5)) / 0.5
            width_s[seg] = width_res[i] * ARROW_SCALE * np.maximum(1.0 - f, 0.02)
        tang = _unit(np.gradient(S, axis=0))
        wdir = _unit(O - tang * np.sum(O * tang, axis=1, keepdims=True))
        ndir = _unit(np.cross(tang, wdir))
        half_w, half_t = (width_s * 0.5)[:, None], (thick_s * 0.5)[:, None]
        corners = np.stack([S + wdir * half_w + ndir * half_t, S - wdir * half_w + ndir * half_t,
                            S - wdir * half_w - ndir * half_t, S + wdir * half_w - ndir * half_t],
                           axis=1)
        a, b = corners[:-1], corners[1:]
        quads = []
        for f in range(4):
            g = (f + 1) % 4
            quads.append(np.stack([a[:, f], b[:, f], b[:, g]], axis=1))
            quads.append(np.stack([a[:, f], b[:, g], a[:, g]], axis=1))
        c0, cn = corners[0], corners[-1]
        cap0 = np.stack([np.stack([c0[0], c0[1], c0[2]]), np.stack([c0[0], c0[2], c0[3]])])
        capn = np.stack([np.stack([cn[0], cn[2], cn[1]]), np.stack([cn[0], cn[3], cn[2]])])
        # residue r owns the samples of u in [r - 0.5, r + 0.5)
        mid = (np.arange(m - 1) + 0.5) / SUBDIV
        samp_res = np.clip(np.rint(mid).astype(np.int64), 0, k - 1)
        tris_out += [np.concatenate(quads, axis=0), cap0, capn]
        src_out += [np.tile(idx[samp_res], 8).astype(np.int32), np.full(2, idx[0], np.int32),
                    np.full(2, idx[-1], np.int32)]
    return np.concatenate(tris_out).astype(np.float32), np.concatenate(src_out)


# -- the triangle ray cast -----------------------------------------------------------


def view_transform(tris, view, dev) -> torch.Tensor:
    v = torch.as_tensor(tris, dtype=F32, device=dev)
    vm = np.asarray(view, np.float32)
    return torch.stack([v[..., 0] * float(vm[j, 0]) + v[..., 1] * float(vm[j, 1])
                        + v[..., 2] * float(vm[j, 2]) + float(vm[j, 3]) for j in range(3)],
                       dim=-1).contiguous()


def tile_lists(v, p00: float, p11: float, width: int, height: int):
    """Per-tile CSR lists (start, ids) of the triangles v (T, 3, 3) whose
    projected box touches the tile, each list in ascending near depth
    (the least clamped vertex depth), ties in triangle order; triangles
    with every vertex at depth <= 1e-2 are dropped."""
    dev = v.device
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    z = -v[..., 2]
    zc = z.clamp_min(1e-2)
    sx = (v[..., 0] / zc * p00 * 0.5 + 0.5) * width
    sy = (-v[..., 1] / zc * p11 * 0.5 + 0.5) * height

    def tile_of(s, n):
        return torch.floor(s / TILE).clamp(0, n - 1).long()

    tx0, tx1 = tile_of(sx.amin(1), tiles_x), tile_of(sx.amax(1), tiles_x)
    ty0, ty1 = tile_of(sy.amin(1), tiles_y), tile_of(sy.amax(1), tiles_y)
    wx = tx1 - tx0 + 1
    cnt = torch.where((z > 1e-2).any(dim=1), wx * (ty1 - ty0 + 1), torch.zeros_like(wx))
    order = torch.sort(zc.amin(1), stable=True).indices  # near depth, then triangle id
    cnt_o = cnt[order]
    total = int(cnt_o.sum())
    run = torch.repeat_interleave(torch.arange(order.shape[0], device=dev), cnt_o,
                                  output_size=total)
    prim = order[run]
    local = torch.arange(total, device=dev) - (torch.cumsum(cnt_o, 0) - cnt_o)[run]
    tile = (ty0[prim] + local // wx[prim]) * tiles_x + tx0[prim] + local % wx[prim]
    tile, by_tile = torch.sort(tile, stable=True)
    start = torch.searchsorted(tile, torch.arange(tiles_x * tiles_y + 1, device=dev))
    return start, prim[by_tile]


def _cross(a, b):
    return a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def raster(v, color, pick, p00: float, p11: float, width: int, height: int):
    """Ray cast the triangles v (T, 3, 3) -> (rgba (H, W, 4), depth (H, W),
    pick (H, W)) by the rule of the module's docstring."""
    dev = v.device
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    start, lst = tile_lists(v, p00, p11, width, height)
    lane = torch.arange(TILE * TILE, device=dev)
    tid = torch.arange(tiles_x * tiles_y, device=dev)
    px = (((tid % tiles_x) * TILE)[:, None] + (lane % TILE)[None, :]).to(F32) + 0.5
    py = (((tid // tiles_x) * TILE)[:, None] + (lane // TILE)[None, :]).to(F32) + 0.5
    d = (div_rn(div_rn(px, float(width)) * 2.0 - 1.0, p00),
         div_rn(1.0 - div_rn(py, float(height)) * 2.0, p11), torch.full_like(px, -1.0))
    v0 = tuple(v[:, 0, j] for j in range(3))
    e1 = tuple(v[:, 1, j] - v0[j] for j in range(3))
    e2 = tuple(v[:, 2, j] - v0[j] for j in range(3))
    tv = tuple(-c for c in v0)
    qv = _cross(tv, e1)
    tnum = _dot(qv, e2)
    nv = _cross(e1, e2)
    nl = analysis.sqrt_rn(_dot(nv, nv)).clamp_min(1e-12)
    n = tuple(c / nl for c in nv)
    bt = torch.full(px.shape, float("inf"), dtype=F32, device=dev)
    bi = torch.full(px.shape, -1, dtype=torch.long, device=dev)
    bn = [torch.zeros_like(px) for _ in range(3)]
    count = start[1:] - start[:-1]
    for k in range(int(count.max())):
        ids = lst[(start[:-1] + k).clamp(max=max(lst.shape[0] - 1, 0))]
        at = {name: tuple(c[ids][:, None] for c in val)
              for name, val in (("e1", e1), ("e2", e2), ("tv", tv), ("qv", qv), ("n", n))}
        pv = _cross(d, at["e2"])
        det = _dot(pv, at["e1"])
        ok = det.abs() > 1e-12
        inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
        uu = _dot(at["tv"], pv) * inv
        ww = _dot(at["qv"], d) * inv
        t = tnum[ids][:, None] * inv
        hit = ((count > k)[:, None] & ok & (uu >= 0.0) & (ww >= 0.0) & (uu + ww <= 1.0)
               & (t > 1e-3) & (t < bt))
        flip = _dot(at["n"], d) > 0.0
        bt = torch.where(hit, t, bt)
        bi = torch.where(hit, ids[:, None], bi)
        for j in range(3):
            bn[j] = torch.where(hit, torch.where(flip, -at["n"][j], at["n"][j]), bn[j])
    hitm = bi >= 0
    c = color[bi.clamp_min(0)]
    lx, ly, lz = (float(np.float32(x)) for x in LIGHT)
    nd = analysis.sqrt_rn(_dot(d, d))
    dn = tuple(comp / nd for comp in d)
    ndotl = (bn[0] * lx + bn[1] * ly + bn[2] * lz).clamp_min(0.0)
    h = (lx - dn[0], ly - dn[1], lz - dn[2])
    hl = analysis.sqrt_rn(_dot(h, h)).clamp_min(1e-12)
    s = _dot(bn, tuple(comp / hl for comp in h)).clamp_min(0.0)
    for _ in range(5):  # s^32
        s = s * s
    lum, spec = 0.25 + 0.75 * ndotl, 0.25 * s
    zero = torch.zeros((), dtype=F32, device=dev)
    rgba = torch.stack([torch.where(hitm, (c[..., j] * lum + spec).clamp(0.0, 1.0), zero)
                        for j in range(3)] + [torch.where(hitm, c[..., 3], zero)], dim=-1)
    depth = torch.where(hitm, bt, torch.full_like(bt, float("inf")))
    picks = torch.where(hitm, pick[bi.clamp_min(0)], torch.full_like(bi, -1))

    def image(a, ch):
        a = a.reshape(tiles_y, tiles_x, TILE, TILE, *ch).transpose(1, 2)
        return a.reshape(tiles_y * TILE, tiles_x * TILE, *ch)[:height, :width].contiguous()

    return image(rgba, (4,)), image(depth, ()), image(picks.int(), ())


# -- the frame -------------------------------------------------------------------------


class Scene:
    """The inputs every frame shares: the frames, the cell, the selection
    (the mix's `residue(first:last)`), the representation's atoms (the
    protein)."""

    def __init__(self, cap: Capsid, stack, config: dict, traffic: dict, control: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = stack.device
        self.q = (lambda t: t.to(torch.bfloat16).to(t.dtype)) if control else (lambda t: t)
        self.cap, self.stack = cap, stack
        self.width, self.height = traffic["width"], traffic["height"]
        self.basis = torch.as_tensor(cap.basis, device=dev)
        self.inv = torch.linalg.inv_ex(self.basis).inverse.contiguous()
        lo, hi = (int(v) for v in traffic["selection"][len("residue("):-1].split(":"))
        self.selected_np = (cap.res_ids >= lo) & (cap.res_ids <= hi)
        self.selected = torch.as_tensor(self.selected_np, device=dev)

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
        center, up, fovy, znear, zfar) -> (rgba, depth, pick)."""
        q, W, H, cap = self.q, self.width, self.height, self.cap
        x = q(self.coords(t))
        w = ss_weights(x, cap, self.basis, self.inv).cpu().numpy()
        cols = atom_colors(cap, w, self.selected_np)
        tris, src = ribbon_mesh(x.cpu().numpy(), cap, w)
        view = look_at(*(np.asarray(cam[k], np.float32) for k in ("eye", "center", "up")))
        proj = perspective(cam["fovy"], W / max(H, 1), cam["znear"], cam["zfar"])
        dev = x.device
        v = q(view_transform(tris, view, dev))
        color = torch.as_tensor(cols[src], device=dev)
        pick = torch.as_tensor(src, device=dev).long()
        rgba, depth, picks = raster(v, color, pick, float(proj[0, 0]), float(proj[1, 1]), W, H)
        rgba, depth = q(rgba), q(depth)
        img = outline(rgba, picks, self.selected)
        ao = q(hbao(depth, proj))
        rgb = fxaa(q(tonemap(img, ao))).clamp(0, 1)
        return torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1), depth, picks


def compare(got: tuple, want: tuple) -> dict:
    """The numbers `correct` is decided on, for one frame: the share of
    pixels whose pick differs, the largest relative depth gap where both
    picked the same atom, the mean gap of the displayed rgb."""
    rgba, depth, pick = want
    out = compare_frames(got, (rgba, depth, pick, torch.zeros_like(depth)))
    del out["volume_rgb_mean_abs"]
    return out
