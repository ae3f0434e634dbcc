"""Immediate-mode overlay geometry: retained per-frame draw queues.

Port of viamd_tpu/render/overlay.py. The queue is host code (a numpy
copy); `render` draws the spheres through render/raster.py (csrc/raster.cu
on a CUDA device) and the fills through render/triangles.py
(csrc/triangles.cu), composites them in torch on the caller's device and
splats the text labels (render/font.py). It takes no `capacity`: the
port's raster lists have no caps.

Rebuild of src/gfx/immediate_draw_utils.{h,cpp} (reference: retained
"world"/"overlay" queues of points/lines/triangles/spheres/boxes with
picking indices, API at immediate_draw_utils.h:51-108) — used for the
simulation box, script visualization geometry (main.cpp:6540-6575) and
component annotations.

Headless formulation: primitives decompose into sphere impostors (points →
spheres, lines → capsule chains, boxes → 12 edge lines) and render through
the same tiled ray tracer as molecules, depth-compositing with the main
pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from viamd_tpu_torch.render import raster
from viamd_tpu_torch.render.font import splat_text
from viamd_tpu_torch.render.triangles import render_triangles, view_transform


@dataclass
class OverlayQueue:
    _pos: list = field(default_factory=list)
    _rad: list = field(default_factory=list)
    _col: list = field(default_factory=list)
    _pick: list = field(default_factory=list)
    _tris: list = field(default_factory=list)      # (3,3) world verts
    _tri_col: list = field(default_factory=list)   # (4,) rgba
    _tri_pick: list = field(default_factory=list)  # int
    _texts: list = field(default_factory=list)     # (pos, str, rgba, scale, pick)

    def clear(self):
        self._pos.clear()
        self._rad.clear()
        self._col.clear()
        self._pick.clear()
        self._tris.clear()
        self._tri_col.clear()
        self._tri_pick.clear()
        self._texts.clear()

    def add_point(self, p, color=(1, 1, 1, 1), radius=0.3, pick_id=-1):
        self._pos.append(np.asarray(p, np.float32))
        self._rad.append(radius)
        self._col.append(np.asarray(color, np.float32))
        self._pick.append(pick_id)

    def add_sphere(self, center, radius, color=(1, 1, 1, 1), pick_id=-1):
        self.add_point(center, color, radius, pick_id)

    def add_line(
        self, a, b, color=(1, 1, 1, 1), radius=0.12, pick_id=-1,
        spacing: float = 0.8,
    ):
        """Capsule-chain line: spheres every `spacing`·radius along a→b."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        length = float(np.linalg.norm(b - a))
        n = max(int(length / max(radius * 2 * spacing, 1e-6)) + 1, 2)
        for t in np.linspace(0.0, 1.0, n):
            self.add_point(a * (1 - t) + b * t, color, radius, pick_id)

    def add_triangle(self, v0, v1, v2, color=(1, 1, 1, 1), pick_id=-1):
        """Filled (two-sided) world-space triangle — the reference's
        immediate triangle primitive (immediate_draw_utils.h:51-108)."""
        self._tris.append(
            np.stack([np.asarray(v, np.float32) for v in (v0, v1, v2)])
        )
        self._tri_col.append(np.asarray(color, np.float32))
        self._tri_pick.append(int(pick_id))

    def add_text(self, pos, text, color=(1, 1, 1, 1), scale=2, pick_id=-1):
        """Screen-billboard text label anchored at world `pos` — the
        reference's vis-payload text primitive (main.cpp:6540-6575)."""
        self._texts.append(
            (
                np.asarray(pos, np.float64),
                str(text),
                np.asarray(color, np.float32),
                int(scale),
                int(pick_id),
            )
        )

    def add_angle_arc(
        self, apex, arm1, arm2, color=(0.2, 0.9, 0.9, 0.55),
        segments: int = 12, label=True, label_color=(1, 1, 1, 1),
        pick_id=-1,
    ):
        """Angle sector fan at `apex` between directions toward arm1/arm2
        (+ optional value label) — the reference's angle vis geometry."""
        apex = np.asarray(apex, np.float64)
        u1 = np.asarray(arm1, np.float64) - apex
        u2 = np.asarray(arm2, np.float64) - apex
        l1, l2 = np.linalg.norm(u1), np.linalg.norm(u2)
        if l1 < 1e-9 or l2 < 1e-9:
            return
        u1, u2 = u1 / l1, u2 / l2
        cosw = float(np.clip(np.dot(u1, u2), -1.0, 1.0))
        ang = float(np.arccos(cosw))
        r = 0.35 * min(l1, l2)
        # slerp fan u1→u2 in their common plane
        if ang > 1e-6 and abs(np.sin(ang)) > 1e-9:
            ts = np.linspace(0.0, 1.0, segments + 1)
            s = np.sin(ang)
            dirs = (
                np.sin((1 - ts) * ang)[:, None] * u1[None, :]
                + np.sin(ts * ang)[:, None] * u2[None, :]
            ) / s
        else:
            dirs = np.stack([u1, u2])
        pts = apex + dirs * r
        for i in range(len(pts) - 1):
            self.add_triangle(apex, pts[i], pts[i + 1], color, pick_id)
        if label:
            bis = u1 + u2
            nb = np.linalg.norm(bis)
            bis = bis / nb if nb > 1e-9 else u1
            self.add_text(
                apex + bis * (r * 1.8),
                f"{np.degrees(ang):.1f}°",
                label_color,
                pick_id=pick_id,
            )

    def add_box(self, basis, origin=(0, 0, 0), color=(1, 1, 0, 1),
                radius=0.1):
        """Wireframe parallelepiped from a (3,3) row-vector basis (the
        simulation-box draw of the reference's render pass)."""
        basis = np.asarray(basis, np.float64)
        o = np.asarray(origin, np.float64)
        a, b, c = basis[0], basis[1], basis[2]
        corners = [
            o, o + a, o + b, o + c, o + a + b, o + a + c, o + b + c,
            o + a + b + c,
        ]
        edges = [
            (0, 1), (0, 2), (0, 3), (1, 4), (1, 5), (2, 4), (2, 6),
            (3, 5), (3, 6), (4, 7), (5, 7), (6, 7),
        ]
        for i, j in edges:
            self.add_line(corners[i], corners[j], color, radius)

    def add_script_visualization(
        self, vis: dict, coords: np.ndarray,
        line_color=(0.2, 0.9, 0.9, 1.0), point_color=(0.9, 0.9, 0.2, 1.0),
        fill_color=(0.2, 0.9, 0.9, 0.55), text_color=(1.0, 1.0, 1.0, 1.0),
        labels: bool = True,
    ):
        """Draw a CompiledScript.visualization payload — the md_script vis
        geometry of the reference (main.cpp:6540-6575): distance lines with
        value labels, angle arc sectors + degree labels, dihedral plane
        fill + labels, plus raw triangle / text channels."""
        for i, j in vis.get("lines", []):
            a, b = coords[i], coords[j]
            self.add_line(a, b, line_color)
            if labels:
                d = float(np.linalg.norm(
                    np.asarray(b, np.float64) - np.asarray(a, np.float64)
                ))
                self.add_text((a + b) * 0.5, f"{d:.2f} Å", text_color)
        for tri in vis.get("angles", []):
            for i, j in zip(tri[:-1], tri[1:]):
                self.add_line(coords[i], coords[j], line_color)
            self.add_point(coords[tri[1]], point_color, 0.2)
            self.add_angle_arc(
                coords[tri[1]], coords[tri[0]], coords[tri[2]],
                fill_color, label=labels, label_color=text_color,
            )
        for quad in vis.get("dihedrals", []):
            for i, j in zip(quad[:-1], quad[1:]):
                self.add_line(coords[i], coords[j], line_color)
            a, b, c, d = (np.asarray(coords[k], np.float64) for k in quad)
            # half-plane fill on each side of the central bond
            self.add_triangle(a, b, c, fill_color)
            self.add_triangle(b, c, d, fill_color)
            if labels:
                b1, b2, b3 = b - a, c - b, d - c
                n1 = np.cross(b1, b2)
                n2 = np.cross(b2, b3)
                m1 = np.cross(n1, b2 / max(np.linalg.norm(b2), 1e-12))
                x = float(np.dot(n1, n2))
                y = float(np.dot(m1, n2))
                phi = np.degrees(np.arctan2(y, x))
                self.add_text((b + c) * 0.5, f"{phi:.1f}°", text_color)
        for i in vis.get("points", []):
            self.add_point(coords[i], point_color, 0.25)
        for i, j, k in vis.get("triangles", []):
            self.add_triangle(coords[i], coords[j], coords[k], fill_color)
        for rec in vis.get("text", []):
            i, s = rec[0], rec[1]
            self.add_text(coords[i], s, text_color)

    def is_empty(self) -> bool:
        return not (self._pos or self._tris or self._texts)

    def primitives(self):
        """(positions (m,3), radii (m,), colors (m,4), pick ids (m,))."""
        if not self._pos:
            z = np.zeros((0, 3), np.float32)
            return z, np.zeros(0, np.float32), np.zeros((0, 4), np.float32), \
                np.zeros(0, np.int32)
        return (
            np.stack(self._pos),
            np.asarray(self._rad, np.float32),
            np.stack(self._col),
            np.asarray(self._pick, np.int32),
        )

    def render(self, view, proj, width: int, height: int, *, device):
        """Render the queue → (rgba, depth, pick) tensors on `device`:
        sphere impostors + filled triangles depth-composite; text splats
        last (billboarded, always on top)."""
        dev = torch.device(device)
        view = np.asarray(view, np.float32)
        proj = np.asarray(proj, np.float32)
        if self._pos:
            pos, rad, col, pick = self.primitives()
            settings = raster.RasterSettings(width=width, height=height)
            img, depth, prim_pick = raster.render_molecules(
                pos, rad, col, view, proj, settings, device=dev
            )
            pick_t = torch.as_tensor(pick, device=dev)
            mapped = torch.where(
                prim_pick >= 0, pick_t[prim_pick.clamp_min(0).long()],
                torch.full_like(prim_pick, -1),
            )
        else:
            img = torch.zeros((height, width, 4), dtype=torch.float32, device=dev)
            depth = torch.full((height, width), float("inf"), dtype=torch.float32, device=dev)
            mapped = torch.full((height, width), -1, dtype=torch.int32, device=dev)
        if self._tris:
            tv = view_transform(np.stack(self._tris), view, device=dev)
            t_img, t_depth, t_pick = render_triangles(
                tv, np.stack(self._tri_col), np.asarray(self._tri_pick, np.int32),
                proj, width, height, shade=False, device=dev,
            )
            # alpha-blend semi-transparent fills over the scene-nearer of
            # the two layers; opaque fills depth-composite
            a = t_img[..., 3:4]
            closer = t_depth < depth
            blend = closer[..., None] & (a > 0)
            img = torch.where(
                blend,
                torch.cat(
                    [
                        t_img[..., :3] * a + img[..., :3] * (1 - a),
                        torch.maximum(img[..., 3:], a),
                    ],
                    dim=-1,
                ),
                img,
            )
            opaque = closer & (t_img[..., 3] >= 0.999)
            mapped = torch.where(closer & (t_pick >= 0), t_pick, mapped)
            depth = torch.where(opaque, t_depth, depth)
        if self._texts:
            img, depth, mapped = img.contiguous(), depth.contiguous(), mapped.contiguous()
            p00, p11 = float(proj[0, 0]), float(proj[1, 1])
            for pos3, s, col4, scale, pid in self._texts:
                v = view[:3, :3] @ np.asarray(pos3, np.float64) + view[:3, 3]
                zc = -float(v[2])
                if zc < 1e-2:
                    continue
                sx = (v[0] / zc * p00 * 0.5 + 0.5) * width
                sy = (-v[1] / zc * p11 * 0.5 + 0.5) * height
                splat_text(
                    img, depth, mapped, sx, sy, zc, s,
                    color=col4, scale=scale, pick_id=pid,
                )
        return img, depth, mapped
