"""The ribbon and cartoon mesh's CUDA kernel wrapper (csrc/ribbon.cu).

The kernel's plain version is render/ribbon_mesh.py::ribbon_mesh followed
by render/triangles.py::view_transform, and render/ribbon_mesh.py::
ribbon_view routes a CPU tensor there and a CUDA tensor here. Inputs, from
render/ribbon_mesh.py::ribbon_tables but for the frame's own:

    coords (N, 3) f32       atom positions
    ss     (nbb, 3) f32     (coil, helix, sheet) weights per backbone
                            residue, or None (every residue coil)
    chains (n, 3) int32     per chain of >= 2 residues: first backbone
                            residue, residues, first triangle
    atoms  (3, nbb) int32   CA, C and O atom of each backbone residue
    view                    the 4x4 view matrix (its first three rows are
                            taken, as float32)

Output: the (count, 3, 3) float32 view-space triangles, equal to the plain
version's bit for bit. The launch copies nothing to the card and waits on
nothing: the view matrix and the styling travel as kernel arguments.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from viamd_tpu_torch.cuda_build import Library, check_tensor as _check

__all__ = ["LIBRARY", "launches", "mesh", "triangles"]

# kernel launches since import, and the triangles they wrote, summed (reset
# freely by callers that count a run)
launches = 0
triangles = 0

_p, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
LIBRARY = Library("ribbon", ("ribbon.cu",), {
    "ribbon_launch": (_i, [_p] * 6 + [_i, _p, _i, _i] + [_d] * 6 + [_p, _p, _p]),
})

_WORK = 5  # the kernel's float64 scratch per backbone residue (kWork)


def mesh(coords, ss, chains, atoms, count: int, view, *, subdiv: int, cartoon: bool,
         coil_width: float, coil_thickness: float, ribbon_width: float,
         ribbon_thickness: float, arrow_scale: float, width_scale: float) -> torch.Tensor:
    """One launch of csrc/ribbon.cu on CUDA tensors → the (count, 3, 3)
    view-space triangles. The keywords are ribbon_mesh's, every one given
    (ribbon_mesh.py::ribbon_view fills in its defaults). Raises on what
    the kernel does not take, or if the launch fails."""
    global launches, triangles
    dev = coords.device
    if dev.type != "cuda":
        raise ValueError(f"the ribbon kernel runs on CUDA tensors, not {dev}")
    nbb = atoms.shape[1]
    _check(coords, "coords", torch.float32, (coords.shape[0], 3), dev)
    _check(atoms, "atoms", torch.int32, (3, nbb), dev)
    _check(chains, "chains", torch.int32, (chains.shape[0], 3), dev)
    if ss is not None:
        _check(ss, "ss", torch.float32, (nbb, 3), dev)
    if subdiv < 1:
        raise ValueError(f"subdiv must be at least 1, not {subdiv}")
    lib = LIBRARY.load()
    out = torch.empty((count, 3, 3), dtype=torch.float32, device=dev)
    work = torch.empty((nbb, _WORK), dtype=torch.float64, device=dev)
    rows = (ctypes.c_float * 12)(*np.asarray(view, np.float32)[:3].reshape(-1).tolist())
    err = lib.ribbon_launch(
        coords.data_ptr(), atoms[0].data_ptr(), atoms[1].data_ptr(), atoms[2].data_ptr(),
        0 if ss is None else ss.data_ptr(), chains.data_ptr(), chains.shape[0], rows,
        int(subdiv), int(bool(cartoon)), float(coil_width), float(coil_thickness),
        float(ribbon_width), float(ribbon_thickness), float(arrow_scale), float(width_scale),
        work.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ribbon kernel launch failed: CUDA error {err}")
    launches += 1
    triangles += count
    return out
