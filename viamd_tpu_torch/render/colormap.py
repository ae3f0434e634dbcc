"""Colormaps + transfer functions (numpy only).

A copy of viamd_tpu/render/colormap.py (the reference's ImPlot-colormap →
transfer-function textures, volumerender_utils.cpp:296:
compute_transfer_function_texture): small anchor tables resampled to any
resolution, and alpha ramps attached to build DVR transfer functions. The
port keeps its own copy because it may not import the JAX package.
"""

from __future__ import annotations

import numpy as np

# anchor points (r, g, b) — standard public colormap data, coarse anchors
_MAPS = {
    "viridis": [
        (0.267, 0.005, 0.329), (0.283, 0.141, 0.458), (0.254, 0.265, 0.530),
        (0.207, 0.372, 0.553), (0.164, 0.471, 0.558), (0.128, 0.567, 0.551),
        (0.135, 0.659, 0.518), (0.267, 0.749, 0.441), (0.478, 0.821, 0.318),
        (0.741, 0.873, 0.150), (0.993, 0.906, 0.144),
    ],
    "plasma": [
        (0.050, 0.030, 0.528), (0.294, 0.012, 0.631), (0.490, 0.012, 0.658),
        (0.658, 0.134, 0.588), (0.798, 0.280, 0.470), (0.899, 0.422, 0.361),
        (0.973, 0.580, 0.254), (0.993, 0.763, 0.157), (0.940, 0.975, 0.131),
    ],
    "magma": [
        (0.001, 0.000, 0.014), (0.113, 0.065, 0.277), (0.317, 0.071, 0.485),
        (0.513, 0.148, 0.508), (0.716, 0.215, 0.475), (0.904, 0.320, 0.388),
        (0.988, 0.536, 0.382), (0.997, 0.770, 0.535), (0.987, 0.991, 0.750),
    ],
    "hot": [
        (0.0, 0.0, 0.0), (0.9, 0.0, 0.0), (1.0, 0.8, 0.0), (1.0, 1.0, 1.0),
    ],
    "cool": [(0.0, 1.0, 1.0), (1.0, 0.0, 1.0)],
    "jet": [
        (0.0, 0.0, 0.5), (0.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 0.0),
        (1.0, 0.0, 0.0), (0.5, 0.0, 0.0),
    ],
    "greys": [(0.0, 0.0, 0.0), (1.0, 1.0, 1.0)],
    "bone": [(0.0, 0.0, 0.0), (0.32, 0.32, 0.45), (0.66, 0.78, 0.78), (1, 1, 1)],
}


def colormap(name: str, n: int = 256) -> np.ndarray:
    """(n, 3) RGB colormap resampled from anchors."""
    anchors = np.asarray(_MAPS[name.lower()], np.float32)
    t = np.linspace(0, 1, n)
    src = np.linspace(0, 1, anchors.shape[0])
    out = np.stack(
        [np.interp(t, src, anchors[:, c]) for c in range(3)], axis=-1
    )
    return out.astype(np.float32)


def colormap_names() -> list[str]:
    return sorted(_MAPS)


def transfer_function(
    name: str = "viridis",
    n: int = 256,
    alpha_scale: float = 1.0,
    alpha_ramp: str = "linear",
) -> np.ndarray:
    """(n, 4) RGBA DVR transfer function (compute_transfer_function_texture).

    alpha_ramp: 'linear' | 'quadratic' | 'constant' | 'smooth'.
    """
    rgb = colormap(name, n)
    t = np.linspace(0, 1, n, dtype=np.float32)
    if alpha_ramp == "linear":
        a = t
    elif alpha_ramp == "quadratic":
        a = t * t
    elif alpha_ramp == "constant":
        a = np.ones_like(t)
    elif alpha_ramp == "smooth":
        a = t * t * (3 - 2 * t)
    else:
        raise ValueError(f"unknown alpha ramp '{alpha_ramp}'")
    return np.concatenate([rgb, (a * alpha_scale)[:, None]], -1).astype(
        np.float32
    )
