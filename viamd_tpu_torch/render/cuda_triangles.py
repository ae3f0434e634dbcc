"""The triangle tile ray cast's CUDA kernel wrapper (csrc/triangles.cu).

Counterpart of the XLA tile kernel viamd_tpu/render/triangles.py::
_tile_kernel (:30-117). Its plain PyTorch version is
render/triangles.py::raster_triangles_plain, and render/triangles.py::
raster_triangles routes a CPU tensor there and a CUDA tensor here. Inputs:

    tri    (T, 3, 3) f32  view-space vertices
    color  (T, 4) f32     rgba per triangle
    pick   (T,) int32     pick id per triangle (-1: none)
    start  (tiles + 1,) int32 CSR offsets; lst (entries,) int32 ids, each
           tile's list in ascending near depth, ties in triangle order

Outputs: rgba (H, W, 4) f32, view depth (H, W) f32 (+inf where nothing is
hit), pick (H, W) int32 (-1 where nothing is hit).
"""

from __future__ import annotations

import ctypes

import torch

from viamd_tpu_torch.cuda_build import Library, check_tensor as _check

__all__ = ["LIBRARY", "TILE", "launches", "raster", "triangles"]

TILE = 16  # pixels per screen tile side; one kernel block per tile

# kernel launches since import, and the triangles handed to them, summed
# (reset freely by callers that count a run)
launches = 0
triangles = 0

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = Library("triangles", ("triangles.cu",), {
    "triangles_launch": (_i, [_p] * 5 + [_i] * 4 + [_f] * 5 + [_i] + [_p] * 4),
})


def raster(tri, color, pick, start, lst, width: int, height: int,
           p00: float, p11: float, light, shade: bool):
    """One launch of csrc/triangles.cu on CUDA tensors → (rgba, depth,
    pick). Raises on what the kernel does not take, or if the launch
    fails."""
    global launches, triangles
    dev = tri.device
    if dev.type != "cuda":
        raise ValueError(f"the triangle kernel runs on CUDA tensors, not {dev}")
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    T = tri.shape[0]
    _check(tri, "tri", torch.float32, (T, 3, 3), dev)
    _check(color, "color", torch.float32, (T, 4), dev)
    _check(pick, "pick", torch.int32, (T,), dev)
    _check(start, "start", torch.int32, (tiles_x * tiles_y + 1,), dev)
    _check(lst, "lst", torch.int32, (lst.shape[0],), dev)
    lib = LIBRARY.load()
    rgba = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    out_pick = torch.empty((height, width), dtype=torch.int32, device=dev)
    lx, ly, lz = (float(v) for v in light)
    err = lib.triangles_launch(
        tri.data_ptr(), color.data_ptr(), pick.data_ptr(), start.data_ptr(),
        lst.data_ptr(), width, height, tiles_x, tiles_y, p00, p11, lx, ly, lz,
        int(bool(shade)), rgba.data_ptr(), depth.data_ptr(), out_pick.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"triangle kernel launch failed: CUDA error {err}")
    launches += 1
    triangles += T
    return rgba, depth, out_pick
