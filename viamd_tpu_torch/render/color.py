"""Per-atom colouring for the molecule render path.

Numpy copy of viamd_tpu/render/color.py (host-only: no device code), the
capability of the reference's src/color_utils.{h,cpp}: HSV and OKLab
conversions, hash→hue golden-ratio palettes, atom colouring by element /
index / residue / chain / secondary structure / property, and the masked
filter / tint / desaturate passes (color_utils.h:252-295).

Colors are float32 RGBA in [0,1], vectorized over atoms; `pack_u32` /
`unpack_u32` bridge to the 0xAABBGGRR packed form.
"""

from __future__ import annotations

import numpy as np

from viamd_tpu_torch.core import elements as E
from viamd_tpu_torch.core.system import System

GOLDEN_RATIO_CONJ = 0.61803398875


def hsv_to_rgb(h, s, v):
    """Vectorized HSV→RGB, h∈[0,1)."""
    h = np.asarray(h) % 1.0
    s, v = np.asarray(s), np.asarray(v)
    i = np.floor(h * 6).astype(int)
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def rgb_to_hsv(rgb):
    rgb = np.asarray(rgb, np.float64)
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    d = mx - mn
    h = np.zeros_like(mx)
    mask = d > 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    idx = (mx == r) & mask
    h[idx] = ((g - b)[idx] / d[idx]) % 6
    idx = (mx == g) & mask
    h[idx] = (b - r)[idx] / d[idx] + 2
    idx = (mx == b) & mask
    h[idx] = (r - g)[idx] / d[idx] + 4
    h = h / 6 % 1.0
    s = np.where(mx > 1e-12, d / np.maximum(mx, 1e-12), 0.0)
    return np.stack([h, s, mx], -1)


def _srgb_to_linear(c):
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    c = np.asarray(c, np.float64)
    return np.where(
        c <= 0.0031308, 12.92 * c, 1.055 * np.maximum(c, 0) ** (1 / 2.4) - 0.055
    )


def rgb_to_oklab(rgb):
    """sRGB [0,1] → OKLab (Björn Ottosson's standard matrices)."""
    lin = _srgb_to_linear(rgb)
    M1 = np.array(
        [
            [0.4122214708, 0.5363325363, 0.0514459929],
            [0.2119034982, 0.6806995451, 0.1073969566],
            [0.0883024619, 0.2817188376, 0.6299787005],
        ]
    )
    lms = lin @ M1.T
    lms_ = np.cbrt(np.maximum(lms, 0))
    M2 = np.array(
        [
            [0.2104542553, 0.7936177850, -0.0040720468],
            [1.9779984951, -2.4285922050, 0.4505937099],
            [0.0259040371, 0.7827717662, -0.8086757660],
        ]
    )
    return lms_ @ M2.T


def oklab_to_rgb(lab):
    M2i = np.array(
        [
            [1.0, 0.3963377774, 0.2158037573],
            [1.0, -0.1055613458, -0.0638541728],
            [1.0, -0.0894841775, -1.2914855480],
        ]
    )
    lms_ = np.asarray(lab) @ M2i.T
    lms = lms_**3
    M1i = np.array(
        [
            [4.0767416621, -3.3077115913, 0.2309699292],
            [-1.2684380046, 2.6097574011, -0.3413193965],
            [-0.0041960863, -0.7034186147, 1.7076147010],
        ]
    )
    return np.clip(_linear_to_srgb(lms @ M1i.T), 0, 1)


def oklab_mix(rgb_a, rgb_b, t):
    """Perceptual blend in OKLab (the reference's OKLab lerp capability)."""
    la, lb = rgb_to_oklab(rgb_a), rgb_to_oklab(rgb_b)
    return oklab_to_rgb(la + (lb - la) * np.asarray(t))


def pack_u32(rgba: np.ndarray) -> np.ndarray:
    """(…,4) float [0,1] → uint32 0xAABBGGRR."""
    c = np.clip(np.asarray(rgba) * 255 + 0.5, 0, 255).astype(np.uint32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | (c[..., 3] << 24)


def unpack_u32(packed: np.ndarray) -> np.ndarray:
    p = np.asarray(packed, np.uint32)
    return np.stack(
        [
            (p & 0xFF), (p >> 8) & 0xFF, (p >> 16) & 0xFF, (p >> 24) & 0xFF,
        ],
        axis=-1,
    ).astype(np.float32) / 255.0


def _hash_color(ids: np.ndarray, s=0.7, v=0.9, alpha=1.0) -> np.ndarray:
    """Golden-ratio hue from integer ids (hash→hue of color_utils)."""
    h = (np.asarray(ids, np.float64) * GOLDEN_RATIO_CONJ) % 1.0
    rgb = hsv_to_rgb(h, s, v)
    a = np.full(rgb.shape[:-1] + (1,), alpha)
    return np.concatenate([rgb, a], -1).astype(np.float32)


def color_atoms_cpk(sys: System) -> np.ndarray:
    """(n,4) element CPK colors."""
    packed = E.CPK_COLORS[sys.element]
    rgb = np.stack(
        [
            (packed >> 16) & 0xFF,
            (packed >> 8) & 0xFF,
            packed & 0xFF,
        ],
        axis=-1,
    ).astype(np.float32) / 255.0
    return np.concatenate([rgb, np.ones((sys.natoms, 1), np.float32)], -1)


def color_atoms_idx(sys: System) -> np.ndarray:
    return _hash_color(np.arange(sys.natoms))


def color_atoms_residue(sys: System) -> np.ndarray:
    return _hash_color(sys.atom_res_idx)


def color_atoms_resname(sys: System) -> np.ndarray:
    return _hash_color(sys.atom_res_name_id())


def color_atoms_chain(sys: System) -> np.ndarray:
    return _hash_color(np.maximum(sys.atom_chain_idx, 0))


SS_COLORS = np.array(
    [
        [0.75, 0.75, 0.75, 1.0],  # coil: grey
        [0.85, 0.25, 0.65, 1.0],  # helix: magenta-ish
        [0.95, 0.75, 0.25, 1.0],  # sheet: yellow-ish
    ],
    np.float32,
)


def color_atoms_secondary_structure(
    sys: System, ss_weights: np.ndarray
) -> np.ndarray:
    """Blend per-residue (coil, helix, sheet) weights → per-atom colors."""
    res_rgb = np.asarray(ss_weights, np.float32) @ SS_COLORS  # (nbb,4)
    out = np.tile(SS_COLORS[0], (sys.natoms, 1))
    if sys.backbone is not None:
        for k, r in enumerate(sys.backbone.res_idx):
            beg, end = sys.res_offsets[r], sys.res_offsets[r + 1]
            out[beg:end] = res_rgb[k]
    return out


def color_atoms_uniform(sys: System, rgba) -> np.ndarray:
    return np.tile(np.asarray(rgba, np.float32), (sys.natoms, 1))


COLOR_MAPPINGS = {
    "cpk": color_atoms_cpk,
    "element": color_atoms_cpk,
    "atom_index": color_atoms_idx,
    "residue_index": color_atoms_residue,
    "residue_name": color_atoms_resname,
    "chain": color_atoms_chain,
}


def color_atoms_property(
    sys: System,
    values,
    map_range: tuple,
    colormap_name: str = "viridis",
    structures=None,
    base=None,
) -> np.ndarray:
    """ColorMapping::Property (viamd.cpp:1408-1445): map the current
    frame's property value(s) through a colormap over [map_beg, map_end].

    `values`: scalar → every atom gets the one colormap sample; (S,) with
    `structures` (S atom-index arrays) → each structure's atoms colored by
    its own value (the reference's dim == vis.structure-count branch).
    `base`: colors to start from (uncovered atoms keep it; default CPK)."""
    from viamd_tpu_torch.render.colormap import colormap as cmap_fn

    cols = (np.array(base, np.float32) if base is not None
            else color_atoms_cpk(sys))
    lo, hi = map_range
    span = (hi - lo) or 1.0
    table = np.asarray(cmap_fn(colormap_name, 256), np.float32)
    vals = np.asarray(values, np.float64).reshape(-1)

    def sample(v):
        t = float(np.clip((v - lo) / span, 0.0, 1.0))
        c = table[int(round(t * 255))]
        return np.array([c[0], c[1], c[2], 1.0], np.float32)

    if structures is not None and len(structures) == vals.size:
        for s, v in zip(structures, vals):
            cols[np.asarray(s, np.int64)] = sample(v)
    else:
        cols[:] = sample(float(vals.mean()) if vals.size else lo)
    return cols


# -- masked ops (filter_colors / tint / desaturate, color_utils.h:276+) ------


def filter_colors(colors: np.ndarray, mask) -> np.ndarray:
    """Zero alpha outside the mask (the representation filter)."""
    out = np.array(colors, np.float32, copy=True)
    keep = mask.to_bools() if hasattr(mask, "to_bools") else np.asarray(mask, bool)
    out[~keep, 3] = 0.0
    return out


def tint_colors(colors: np.ndarray, mask, tint, amount=0.5) -> np.ndarray:
    out = np.array(colors, np.float32, copy=True)
    sel = mask.to_bools() if hasattr(mask, "to_bools") else np.asarray(mask, bool)
    out[sel, :3] = out[sel, :3] * (1 - amount) + np.asarray(tint)[:3] * amount
    return out


def desaturate_colors(colors: np.ndarray, mask, amount=0.7) -> np.ndarray:
    out = np.array(colors, np.float32, copy=True)
    sel = mask.to_bools() if hasattr(mask, "to_bools") else np.asarray(mask, bool)
    lum = out[sel, :3] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    out[sel, :3] = (
        out[sel, :3] * (1 - amount) + lum[:, None] * amount
    )
    return out
