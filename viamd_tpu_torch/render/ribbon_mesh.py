"""Ribbon / cartoon backbone triangle meshes.

A numpy copy of viamd_tpu/render/ribbon_mesh.py (host code, float64
inside): the same inputs give bit-equal triangles and sources.

True rebuild of md_gl's RIBBONS / CARTOON draw types
(VIAMD src/viamd.h:161-169, draw ops src/main.cpp:6878-6925):
a Catmull-Rom spline through the CA trace whose flat cross-section is
oriented by the PEPTIDE PLANE (carbonyl C=O vector, flip-corrected along
the chain — the classic Richardson ribbon construction), extruded into a
quad-strip box (width × thickness) with secondary-structure styling:

- coil: narrow near-square section (reads as a tube)
- helix: wide flat ribbon
- sheet: wide flat ribbon with a 1.6× ARROWHEAD that tapers to a point
  over the final residue of each sheet run
- cartoon mode interpolates width/thickness through the per-residue
  (coil, helix, sheet) weights; ribbons mode uses a constant flat section

Outputs world-space triangles + per-triangle source CA atom ids so
coloring and picking resolve per residue through render/triangles.py.

`ribbon_view` is the session's route to view-space triangles: on a CUDA
device one launch of csrc/ribbon.cu (render/cuda_ribbon.py), on the CPU
`ribbon_mesh` then `view_transform`, which the kernel equals bit for bit.
Both take the frame-independent `ribbon_tables` of the system, built once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from viamd_tpu_torch.core.system import System
from viamd_tpu_torch.render import cuda_ribbon
from viamd_tpu_torch.render.triangles import view_transform

# the mesh's styling (Å): ribbon_mesh's defaults, which ribbon_view hands to
# either route
COIL_WIDTH, COIL_THICKNESS = 0.6, 0.5
RIBBON_WIDTH, RIBBON_THICKNESS = 2.2, 0.35
ARROW_SCALE = 1.6


def _spline(P: np.ndarray, subdiv: int) -> np.ndarray:
    """Catmull-Rom through control points P (k,d) → ((k-1)*subdiv+1, d)."""
    k = P.shape[0]
    Ppad = np.concatenate([P[:1] * 2 - P[1:2], P, P[-1:] * 2 - P[-2:-1]])
    t = np.linspace(0.0, 1.0, subdiv, endpoint=False)[:, None]
    segs = []
    for s in range(k - 1):
        p0, p1, p2, p3 = Ppad[s], Ppad[s + 1], Ppad[s + 2], Ppad[s + 3]
        segs.append(
            0.5
            * (
                2 * p1
                + (-p0 + p2) * t
                + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
                + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t
            )
        )
    segs.append(P[-1:])
    return np.concatenate(segs)


def _normalize(v, axis=-1):
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, 1e-12)


def ribbon_mesh(
    sys: System,
    coords: np.ndarray,
    ss_weights: np.ndarray | None = None,
    subdiv: int = 8,
    cartoon: bool = True,
    coil_width: float = COIL_WIDTH,
    coil_thickness: float = COIL_THICKNESS,
    ribbon_width: float = RIBBON_WIDTH,
    ribbon_thickness: float = RIBBON_THICKNESS,
    arrow_scale: float = ARROW_SCALE,
    width_scale: float = 1.0,
):
    """→ (tris (T,3,3) world, src (T,) int32 CA atom per triangle)."""
    bb = sys.backbone
    if bb is None:
        raise ValueError("system has no protein backbone")
    ca, c_at, o_at = bb.atom_ca, bb.atom_c, bb.atom_o
    tris_out: list[np.ndarray] = []
    src_out: list[np.ndarray] = []
    for beg, end in np.asarray(bb.ranges):
        k = end - beg
        if k < 2:
            continue
        idx = ca[beg:end]
        P = coords[idx].astype(np.float64)  # (k,3)

        # peptide-plane orientation per residue: carbonyl C=O direction,
        # projected ⊥ to the local chain direction, flip-corrected
        co = coords[o_at[beg:end]] - coords[c_at[beg:end]]
        tan_res = np.gradient(P, axis=0)
        tan_res = _normalize(tan_res)
        od = co - tan_res * np.sum(co * tan_res, axis=1, keepdims=True)
        od = _normalize(od)
        for i in range(1, k):
            if np.dot(od[i], od[i - 1]) < 0.0:
                od[i] = -od[i]

        # per-residue SS weights → width/thickness profiles
        if ss_weights is not None:
            w3 = np.asarray(ss_weights[beg:end], np.float64)  # (k,3) c/h/s
        else:
            w3 = np.tile([1.0, 0.0, 0.0], (k, 1))
        if cartoon:
            flat_w = w3[:, 1] + w3[:, 2]
            width_res = coil_width + (ribbon_width - coil_width) * flat_w
            thick_res = coil_thickness + (
                ribbon_thickness - coil_thickness
            ) * flat_w
        else:
            width_res = np.full(k, ribbon_width)
            thick_res = np.full(k, ribbon_thickness)

        # sheet arrowheads: a residue ENDING a sheet run (next residue not
        # sheet) widens by arrow_scale then tapers to a point
        sheet = w3[:, 2] > 0.5
        arrow_at = np.zeros(k, bool)
        if cartoon:
            for i in range(k):
                if sheet[i] and (i + 1 >= k or not sheet[i + 1]):
                    arrow_at[i] = True

        # spline-sample everything
        S = _spline(P, subdiv)  # (m,3)
        O = _normalize(_spline(od, subdiv))
        m = S.shape[0]
        u = np.arange(m) / subdiv  # fractional residue coordinate
        ui = np.minimum(u.astype(np.int64), k - 1)
        uf = u - ui
        nxt = np.minimum(ui + 1, k - 1)
        width_s = width_res[ui] * (1 - uf) + width_res[nxt] * uf
        thick_s = thick_res[ui] * (1 - uf) + thick_res[nxt] * uf
        # arrowhead profile: the sheet run's final residue owns spline
        # territory u ∈ [i-0.5, i] (matching the nearest-residue triangle
        # attribution below); it widens to arrow_scale × the sheet width
        # at its start and tapers to a point at the residue's CA
        for i in np.nonzero(arrow_at)[0]:
            if i == 0:
                continue
            seg = (u >= i - 0.5) & (u <= i + 1e-9)
            f = (u[seg] - (i - 0.5)) / 0.5
            base = width_res[i]
            width_s[seg] = base * arrow_scale * np.maximum(1.0 - f, 0.02)
        width_s = width_s * width_scale
        thick_s = thick_s * width_scale

        tang = _normalize(np.gradient(S, axis=0))
        wdir = _normalize(O - tang * np.sum(O * tang, axis=1, keepdims=True))
        ndir = _normalize(np.cross(tang, wdir))

        half_w = (width_s * 0.5)[:, None]
        half_t = (thick_s * 0.5)[:, None]
        # 4 corners per sample: (+w+t, -w+t, -w-t, +w-t)
        c0 = S + wdir * half_w + ndir * half_t
        c1 = S - wdir * half_w + ndir * half_t
        c2 = S - wdir * half_w - ndir * half_t
        c3 = S + wdir * half_w - ndir * half_t
        corners = np.stack([c0, c1, c2, c3], axis=1)  # (m,4,3)

        # quad strip between consecutive samples: 4 faces × 2 triangles
        a = corners[:-1]  # (m-1,4,3)
        b = corners[1:]
        quads = []
        for f in range(4):
            g = (f + 1) % 4
            quads.append(np.stack([a[:, f], b[:, f], b[:, g]], axis=1))
            quads.append(np.stack([a[:, f], b[:, g], a[:, g]], axis=1))
        # end caps
        cap0 = np.stack(
            [
                np.stack([corners[0, 0], corners[0, 1], corners[0, 2]]),
                np.stack([corners[0, 0], corners[0, 2], corners[0, 3]]),
            ]
        )
        capn = np.stack(
            [
                np.stack([corners[-1, 0], corners[-1, 2], corners[-1, 1]]),
                np.stack([corners[-1, 0], corners[-1, 3], corners[-1, 2]]),
            ]
        )
        seg_tris = np.concatenate(quads, axis=0)  # (8*(m-1),3,3)
        # nearest-residue attribution: residue r owns u ∈ [r-0.5, r+0.5)
        # so the chain-final residue owns triangles (incl. its arrowhead)
        mid = (np.arange(m - 1) + 0.5) / subdiv
        samp_res = np.clip(np.rint(mid).astype(np.int64), 0, k - 1)
        src_seg = np.tile(idx[samp_res], 8)
        tris_out += [seg_tris, cap0, capn]
        src_out += [
            src_seg.astype(np.int32),
            np.full(2, idx[0], np.int32),
            np.full(2, idx[-1], np.int32),
        ]
    if not tris_out:
        raise ValueError("backbone ranges too short for a ribbon")
    return (
        np.concatenate(tris_out).astype(np.float32),
        np.concatenate(src_out),
    )


@dataclass(frozen=True)
class RibbonTables:
    """What a system's ribbon mesh at one `subdiv` keeps from frame to
    frame, on a device: per chain of >= 2 backbone residues (as
    `ribbon_mesh` draws them) its first residue, residues and first
    triangle (`chains`, (n, 3) int32); the CA, C and O atom of every
    backbone residue (`atoms`, (3, nbb) int32); and per triangle, in
    `ribbon_mesh`'s order, its backbone residue (`res`, (count,) int64)
    and CA atom (`src`, (count,) int32, `ribbon_mesh`'s sources)."""

    subdiv: int
    count: int
    chains: torch.Tensor
    atoms: torch.Tensor
    res: torch.Tensor
    src: torch.Tensor


def ribbon_tables(sys: System, subdiv: int = 8, *, device) -> RibbonTables:
    """The system's `RibbonTables` at `subdiv`, by `ribbon_mesh`'s rules:
    8 face groups of (k - 1) * subdiv segments a chain, each segment owned
    by the residue nearest its midpoint, then two caps at each end."""
    bb = sys.backbone
    if bb is None:
        raise ValueError("system has no protein backbone")
    chains, res = [], []
    count = 0
    for beg, end in np.asarray(bb.ranges, np.int64):
        k = int(end - beg)
        if k < 2:
            continue
        m = (k - 1) * subdiv + 1
        mid = (np.arange(m - 1) + 0.5) / subdiv
        seg = beg + np.clip(np.rint(mid).astype(np.int64), 0, k - 1)
        res += [np.tile(seg, 8), np.array([beg, beg, end - 1, end - 1])]
        chains.append((beg, k, count))
        count += 8 * (m - 1) + 4
    if not chains:
        raise ValueError("backbone ranges too short for a ribbon")
    res = np.concatenate(res)
    atoms = np.stack([bb.atom_ca, bb.atom_c, bb.atom_o]).astype(np.int32)
    dev = torch.device(device)
    return RibbonTables(
        subdiv=subdiv, count=count,
        chains=torch.as_tensor(np.asarray(chains, np.int32), device=dev),
        atoms=torch.as_tensor(atoms, device=dev),
        res=torch.as_tensor(res, device=dev),
        src=torch.as_tensor(atoms[0][res], device=dev),
    )


def ribbon_view(sys: System, coords: torch.Tensor, ss_weights, view, tables: RibbonTables,
                *, cartoon: bool = True, coil_width: float = COIL_WIDTH,
                coil_thickness: float = COIL_THICKNESS, ribbon_width: float = RIBBON_WIDTH,
                ribbon_thickness: float = RIBBON_THICKNESS, arrow_scale: float = ARROW_SCALE,
                width_scale: float = 1.0) -> torch.Tensor:
    """The ribbon or cartoon mesh of one frame in view space: (count, 3, 3)
    float32 on `coords`' device. `ss_weights` is a (nbb, 3) tensor there,
    or None; the keywords are `ribbon_mesh`'s but `subdiv`, which the
    tables fix. CUDA tensors go to csrc/ribbon.cu, CPU tensors to
    `ribbon_mesh` and `view_transform`."""
    style = dict(subdiv=tables.subdiv, cartoon=cartoon, coil_width=coil_width,
                 coil_thickness=coil_thickness, ribbon_width=ribbon_width,
                 ribbon_thickness=ribbon_thickness, arrow_scale=arrow_scale,
                 width_scale=width_scale)
    dev = coords.device
    if dev.type == "cuda":
        return cuda_ribbon.mesh(coords.contiguous(), ss_weights, tables.chains, tables.atoms,
                                tables.count, view, **style)
    if dev.type != "cpu":
        raise ValueError(f"no ribbon mesh for device {dev}")
    ss = None if ss_weights is None else ss_weights.numpy()
    tris, _ = ribbon_mesh(sys, coords.numpy(), ss_weights=ss, **style)
    return view_transform(tris, view, device=dev)
