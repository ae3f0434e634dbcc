"""Per-atom colouring for the molecule render path.

Numpy copy of the parts of viamd_tpu/render/color.py that the render path
uses (host-only: no device code): `hsv_to_rgb`, the golden-ratio hash
palette, and the element / index / residue / residue-name / chain / uniform
mappings with `COLOR_MAPPINGS`. Property, secondary-structure and colormap
colouring come with the components slice.

Colors are float32 RGBA in [0,1], vectorized over atoms.
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
