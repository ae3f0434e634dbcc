"""Cell-list pair-distance histogram: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of viamd_tpu/ops/pallas_rdf.py (`pair_dist_histogram_pl`, whose
Pallas kernel `_hist_kernel` is replaced by csrc/pair_hist.cu).

`pair_dist_histogram_cl` is the route the compiler takes for periodic
orthorhombic systems. On a CUDA tensor it builds the CSR cell lists
(ops/neighbors.py) and launches the kernel; on a CPU tensor it computes the
same histogram with the plain version, `pair_dist_histogram_scatter_idx`
(ops/rdf.py, imported here). Any other device raises. The kernel counts
every pair (no capacity drops), so it is held exactly to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from viamd_tpu_torch.cuda_build import build_info, load_library, check_tensor as _check
from viamd_tpu_torch.ops.neighbors import build_cell_list
from viamd_tpu_torch.ops.rdf import pair_dist_histogram_scatter_idx

__all__ = [
    "launches",
    "pair_dist_histogram_cl",
    "pair_dist_histogram_scatter_idx",
    "pair_hist_cells",
]

# kernel launches since import (reset freely by callers that count a run)
launches = 0

# (library name, sources in csrc/) for cuda_build
LIBRARY = ("pair_hist", ("pair_hist.cu",))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library(*LIBRARY)
        lib.pair_hist_launch.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pair_hist_launch.restype = ctypes.c_int
        lib.pair_hist_max_bins.argtypes = []
        lib.pair_hist_max_bins.restype = ctypes.c_int
        _lib = lib
    return _lib


def load_kernel() -> float:
    """Build (first call) and load the kernel library; returns the build
    seconds, 0 when an earlier build was reused."""
    _library()
    return build_info[LIBRARY[0]]["seconds"]


def pair_hist_cells(
    xa: torch.Tensor,  # (na, 3) f32, A atoms in cell order
    ida: torch.Tensor,  # (na,) int32 global ids
    a_start: torch.Tensor,  # (ncells+1,) int32 CSR offsets
    xb: torch.Tensor,
    idb: torch.Tensor,
    b_start: torch.Tensor,
    basis: torch.Tensor,  # (3, 3) f32
    inv_basis: torch.Tensor,  # (3, 3) f32
    dims: tuple,
    nbins: int,
    r_max: float,
) -> torch.Tensor:
    """Launch csrc/pair_hist.cu on CSR cell lists → (nbins,) f32 counts."""
    global launches
    dev = xa.device
    if dev.type != "cuda":
        raise ValueError(f"pair_hist_cells needs CUDA tensors, got {dev}")
    if min(dims) < 3:
        raise ValueError(f"pair_hist_cells needs min(dims) >= 3, got {dims}")
    lib = _library()
    if not 0 < nbins <= lib.pair_hist_max_bins():
        raise ValueError(f"nbins {nbins} outside (0, {lib.pair_hist_max_bins()}]")
    ncells = dims[0] * dims[1] * dims[2]
    na, nb = xa.shape[0], xb.shape[0]
    _check(xa, "xa", torch.float32, (na, 3), dev)
    _check(ida, "ida", torch.int32, (na,), dev)
    _check(a_start, "a_start", torch.int32, (ncells + 1,), dev)
    _check(xb, "xb", torch.float32, (nb, 3), dev)
    _check(idb, "idb", torch.int32, (nb,), dev)
    _check(b_start, "b_start", torch.int32, (ncells + 1,), dev)
    _check(basis, "basis", torch.float32, (3, 3), dev)
    _check(inv_basis, "inv_basis", torch.float32, (3, 3), dev)
    hist = torch.zeros(nbins, dtype=torch.int32, device=dev)
    inv_bin = float(torch.tensor(nbins / r_max, dtype=torch.float32))
    err = lib.pair_hist_launch(
        xa.data_ptr(), ida.data_ptr(), a_start.data_ptr(),
        xb.data_ptr(), idb.data_ptr(), b_start.data_ptr(),
        basis.data_ptr(), inv_basis.data_ptr(),
        dims[0], dims[1], dims[2], nbins, r_max, inv_bin,
        hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pair_hist kernel launch failed: CUDA error {err}")
    launches += 1
    return hist.to(torch.float32)


def pair_dist_histogram_cl(
    x: torch.Tensor,  # (n, 3) f32 frame coordinates
    idx_a: torch.Tensor,  # (na,) int32 global indices of the A selection
    idx_b: torch.Tensor,  # (nb,) int32 global indices of the B selection
    basis: torch.Tensor,  # (3, 3) orthorhombic basis (diagonal)
    inv_basis: torch.Tensor,
    nbins: int,
    r_max: float,
    dims: tuple,  # cell grid, cells >= r_max wide, min(dims) >= 3
) -> torch.Tensor:
    """A→B min-image pair-distance histogram (nbins,) f32 through a cell
    list: the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        ones_a = torch.ones(idx_a.shape[0], dtype=torch.float32)
        ones_b = torch.ones(idx_b.shape[0], dtype=torch.float32)
        return pair_dist_histogram_scatter_idx(
            x, idx_a, idx_b, ones_a, ones_b, basis, inv_basis, nbins, r_max
        )
    if x.device.type != "cuda":
        raise ValueError(f"no pair histogram route for device {x.device}")
    if idx_a.shape[0] == 0 or idx_b.shape[0] == 0:
        return torch.zeros(nbins, dtype=torch.float32, device=x.device)
    box = torch.diagonal(basis)

    def cells(idx):
        xs = x[idx]
        cl = build_cell_list(xs, box, dims)
        return xs[cl.order].contiguous(), idx[cl.order].contiguous(), cl.cell_start

    xa, ida, a_start = cells(idx_a)
    # one cell list serves both sides when the caller passes one index
    # tensor for both (comparing contents here would wait on the device)
    xb, idb, b_start = (xa, ida, a_start) if idx_b is idx_a else cells(idx_b)
    return pair_hist_cells(
        xa, ida, a_start, xb, idb, b_start,
        basis.contiguous(), inv_basis.contiguous(), dims, nbins, r_max,
    )
