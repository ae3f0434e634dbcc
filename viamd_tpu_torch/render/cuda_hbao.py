"""HBAO on the card: csrc/hbao.cu's wrapper.

`hbao` in render/hbao.py routes a CUDA depth buffer here; its plain version
(the rest of render/hbao.py) stays for CPU tensors and is what the kernel
is held to. A frame is four launches on PyTorch's current stream: the
depth mips (levels 1–4, each at its own size: `level_shapes`), the
occlusion, and the depth-aware blur along x then y (two without the blur).
The 4×4 jitter tile's tables go to the kernel's `__constant__` memory once
per device (`table_image`), so a frame makes no host-to-device copy and
waits on nothing: the host's work is the launches and their scalars.

Each scalar is the float32 value the plain version's op uses, derived here
from the Python numbers as PyTorch rounds them on the card (`ao_scalars`,
`blur_scalars`): a tensor divided by a Python number is multiplied by the
number's float32 reciprocal, a Python number is rounded to float32 where
an op takes it, and `t ** e` takes torch.pow's special cases.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from viamd_tpu_torch.cuda_build import Library, check_tensor as _check
from viamd_tpu_torch.render.hbao import (_GLOBAL_MIP_OFFSET, _N_MIPS, _N_SAMPLES, _TILE,
                                         _finite_or, _jitter_tables, _phase_tables, proj_info)

__all__ = ["LIBRARY", "TIE", "ao_scalars", "blur_scalars", "check_inputs", "hbao", "launches",
           "level_shapes", "mips", "pow_mode", "table_image", "tie_pixels"]

# kernel launches since import (reset freely by callers that count a run)
launches = 0

_tables_on: set = set()  # device indices whose __constant__ tables are loaded

_F32 = np.float32


_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("hbao", ("hbao.cu",), {
    "hbao_table_floats": (_i, []),
    "hbao_set_tables": (_i, [_p, _i]),
    "hbao_mips_launch": (_i, [_p, _i, _i, _p, _i, _p]),
    "hbao_ao_launch": (_i, [_p, _p, _p, _i, _i, _i, _i, _i, _p, _p, _p]),
    "hbao_blur_launch": (_i, [_p, _p, _i, _i, _i, _p, _p, _p]),
}, check=lambda lib: lib.hbao_table_floats() == table_image().size)


def table_image() -> np.ndarray:
    """The kernel's `__constant__` tables as one float32 array: for each
    pixel phase (y % 4) * 4 + x % 4, its 16 samples' (dx, dy, weight, mip
    bias), then the 16 phases' weight sums — `_jitter_tables()` reordered."""
    dirs, wgts, mips_, wsum = _jitter_tables()
    samples = np.concatenate([dirs, wgts[..., None], mips_[..., None]], axis=-1)  # (16, 4, 4, 4)
    per_phase = samples.transpose(1, 2, 0, 3).reshape(_TILE * _TILE, _N_SAMPLES, 4)
    return np.concatenate([per_phase.reshape(-1), wsum.reshape(-1)]).astype(_F32)


def level_shapes(height: int, width: int) -> list:
    """(h, w) of mip levels 1 … 4: each (n + 1) // 2 of the level below."""
    shapes, h, w = [], height, width
    for _ in range(1, _N_MIPS):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


# how near k + 0.5 a sample's mip offset + bias may lie before log2f's
# rounding could send the kernel and the plain version to adjacent levels
TIE = 1e-5


def tie_pixels(view_depth: torch.Tensor, proj, *, ortho: bool = False, radius: float = 6.0,
               blur: bool = True) -> torch.Tensor:
    """(H, W) bool: the pixels where the kernel may differ from `hbao_plain`.
    A sample whose mip offset + bias lies within TIE of k + 0.5 (k = 0 … 3)
    rounds to its level by a margin below log2f's error, so it may fetch the
    neighbouring level; with the blur that reaches every pixel within 3 of
    it along x and y. Everywhere else the two agree bit for bit."""
    H, W = view_depth.shape
    _, proj_scl, _ = proj_info(proj, ortho)
    d = _finite_or(view_depth, 1e8)
    rts = radius * 0.5 * proj_scl * H
    rp = torch.full_like(d, max(rts, 3.0)) if ortho else (rts / d).clamp_min(3.0)
    mo = torch.log2(rp * 4.0) + _GLOBAL_MIP_OFFSET
    tie = torch.zeros_like(d, dtype=torch.bool)
    for _, _, mips_i in _phase_tables(H, W, d.device)[0]:
        t = mo + mips_i
        tie |= ((t - torch.floor(t) - 0.5).abs() <= TIE) & (t > 0) & (t < 4)
    if blur:
        tie = torch.nn.functional.max_pool2d(tie[None].float(), 7, 1, 3)[0] > 0
    return tie


def pow_mode(intensity: float) -> tuple[int, float]:
    """(mode, exponent) of `t ** max(intensity, 0)` on a float32 CUDA tensor:
    0 fills 1, 1 copies, then sqrt at 0.5; the float32 exponent 2 or 3 is
    t·t or t·t·t; anything else powf (torch.pow's dispatch)."""
    e = max(float(intensity), 0.0)
    ef = float(_F32(e))
    for mode, hit in ((0, e == 0.0), (1, e == 1.0), (4, e == 0.5), (2, ef == 2.0), (3, ef == 3.0)):
        if hit:
            return mode, ef
    return 5, ef


def ao_scalars(height: int, width: int, *, info, proj_scl: float, z_max: float, ortho: bool,
               intensity: float, radius: float, bias: float) -> tuple[list, int]:
    """The occlusion launch's 17 float32 scalars, in csrc/hbao.cu's order,
    and its power mode: what `_hbao_impl` and `view_normals` compute them
    from, rounded as their ops round them."""
    sx, sy, ox, oy = info
    rts = radius * 0.5 * proj_scl * height
    nbias = min(max(bias, 0.0), 1.0 - 1e-7)
    mode, power = pow_mode(intensity)
    vals = [
        _F32(1) / _F32(width), _F32(1) / _F32(height),  # `/ W`: times f32(1 / f32(W))
        1.0 / width, 1.0 / height,  # `u + 1.0 / W`
        sx, sy, ox, oy, rts, max(rts, 3.0), -1.0 / (radius * radius), nbias,
        1.0 / (1.0 - nbias), power, z_max, width, height,
    ]
    return [float(_F32(v)) for v in vals], mode


def blur_scalars(*, sharpness: float, z_max: float) -> list:
    """The blur launches' 5 float32 scalars: sharpness, z_max and
    −r·r·fall for r = 1, 2, 3 (`hbao_blur`'s Python constants)."""
    fall = 1.0 / (2.0 * 1.5 * 1.5)
    return [float(_F32(v)) for v in (sharpness, z_max, *(-r * r * fall for r in (1, 2, 3)))]


def _floats(vals):
    return ctypes.cast((ctypes.c_float * len(vals))(*vals), ctypes.c_void_p)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def check_inputs(view_depth, normals=None) -> None:
    """Raise unless the kernel takes these: a non-empty (H, W) float32
    contiguous depth buffer on a CUDA device and, if given, (H, W, 3)
    float32 contiguous normals on the same device. Type, shape and layout
    are checked before the device."""
    if view_depth.ndim != 2 or view_depth.numel() == 0:
        raise ValueError(f"view_depth: shape {tuple(view_depth.shape)}, expected (H, W), not empty")
    H, W = view_depth.shape
    _check(view_depth, "view_depth", torch.float32, (H, W), view_depth.device)
    if normals is not None:
        _check(normals, "normals", torch.float32, (H, W, 3), normals.device)
    if view_depth.device.type != "cuda":
        raise ValueError(f"view_depth: on {view_depth.device}, the kernel takes a CUDA tensor")
    if normals is not None and normals.device != view_depth.device:
        raise ValueError(f"normals: on {normals.device}, expected {view_depth.device}")


def mips(view_depth: torch.Tensor) -> torch.Tensor:
    """Mip levels 1–4 of a (H, W) float32 CUDA depth buffer, one launch:
    one flat tensor holding each level of `level_shapes` row-major in turn
    (the plain version is `render/hbao.py::_mip_levels`)."""
    global launches
    check_inputs(view_depth)
    H, W = view_depth.shape
    n = sum(h * w for h, w in level_shapes(H, W))
    out = torch.empty(n, dtype=torch.float32, device=view_depth.device)
    err = LIBRARY.load().hbao_mips_launch(view_depth.data_ptr(), W, H, out.data_ptr(), n,
                                          _stream(view_depth.device))
    if err != 0:
        raise RuntimeError(f"hbao mips launch failed: CUDA error {err}")
    launches += 1
    return out


def _load_tables(dev) -> None:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index in _tables_on:
        return
    image = table_image()
    with torch.cuda.device(index):
        err = LIBRARY.load().hbao_set_tables(image.ctypes.data, image.size)
    if err != 0:
        raise RuntimeError(f"hbao table upload failed: CUDA error {err}")
    _tables_on.add(index)


def hbao(view_depth: torch.Tensor, normals=None, *, info, proj_scl: float, z_max: float,
         ortho: bool, intensity: float, radius: float, bias: float,
         sharpness: float | None) -> torch.Tensor:
    """(H, W) AO of a (H, W) float32 CUDA depth buffer: the mips, the
    occlusion and, with a `sharpness`, the blur's two passes (None: no
    blur). `normals`: None, or (H, W, 3) float32 view-space normals on the
    depth's device. The arguments are `render/hbao.py::hbao`'s after
    `proj_info` (z_max already scaled by 0.99). Raises on what the kernel
    does not take, or if a launch fails."""
    global launches
    check_inputs(view_depth, normals)
    dev = view_depth.device
    H, W = view_depth.shape
    lib = LIBRARY.load()
    _load_tables(dev)
    levels = mips(view_depth)
    scal, mode = ao_scalars(H, W, info=info, proj_scl=proj_scl, z_max=z_max, ortho=ortho,
                            intensity=intensity, radius=radius, bias=bias)
    ao = torch.empty((H, W), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    err = lib.hbao_ao_launch(view_depth.data_ptr(), None if normals is None else normals.data_ptr(),
                             levels.data_ptr(), levels.numel(), W, H, int(ortho), mode,
                             _floats(scal), ao.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hbao occlusion launch failed: CUDA error {err}")
    launches += 1
    if sharpness is None:
        return ao
    bs = _floats(blur_scalars(sharpness=sharpness, z_max=z_max))
    tmp = torch.empty_like(ao)
    for axis, src, dst in ((0, ao, tmp), (1, tmp, ao)):  # x into tmp, then y back into ao
        err = lib.hbao_blur_launch(src.data_ptr(), view_depth.data_ptr(), W, H, axis, bs,
                                   dst.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"hbao blur launch failed: CUDA error {err}")
        launches += 1
    return ao
