"""Weighted histograms: bin ids and one order-free scatter sum.

Counterpart of viamd_tpu/ops/histogram.py (`histogram_cdf`,
`histogram_bins`, `histogram_segment`, `resample_histogram`; the
reference's compute_histogram_masked, VIAMD src/main.cpp:172-230). The JAX
package computes these without a scatter — compare-CDF sums and a sorted
segment sum — because a TPU has no fast scatter-add. The port computes
what they compute: each value's bin id, then one scatter sum of the
weights by id (`density.scaled_fixed_point_sum`: fixed point, int64 adds,
the same result in any order on every device, so two runs on CUDA agree
bit for bit). Ids outside [0, nbins) are dropped, as the JAX forms drop
them.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.ops.density import scaled_fixed_point_sum


def _binned(ids: torch.Tensor, weights: torch.Tensor, nbins: int) -> torch.Tensor:
    """(nbins,) float32 sums of `weights` by `ids`; ids outside [0, nbins)
    dropped."""
    ids = ids.reshape(-1).to(torch.int64)
    w = weights.reshape(-1).to(torch.float32)
    keep = (ids >= 0) & (ids < nbins)
    w = torch.where(keep, w, torch.zeros_like(w))
    ids = torch.where(keep, ids, torch.zeros_like(ids))
    return scaled_fixed_point_sum(nbins, ids, w)


def histogram_cdf(
    values: torch.Tensor,
    weights: torch.Tensor,
    nbins: int,
    vmin: float,
    vmax: float,
) -> torch.Tensor:
    """Weighted histogram of `values` into nbins over [vmin, vmax), reduced
    over all axes → (nbins,). A value v goes to bin k when t = (v − vmin) /
    span lies in [k / nbins, (k + 1) / nbins), both edges the float32
    values the JAX compare-CDF uses (so each value lands where that form
    counts it); values outside [vmin, vmax), and those whose t rounds to
    1, count nowhere."""
    v = values.reshape(-1)
    # the bounds stay scalars of the ops, rounded as the JAX package rounds them
    span = float(np.float32(max(vmax - vmin, 1e-30)))
    vmin, vmax = float(np.float32(vmin)), float(np.float32(vmax))
    inside = (v >= vmin) & (v < vmax)
    t = (v - vmin) / span
    edges = torch.arange(1, nbins + 1, dtype=torch.float32, device=v.device) / nbins
    ids = torch.searchsorted(edges, t.contiguous(), right=True)  # edges <= t
    ids = torch.where(inside, ids, torch.full_like(ids, -1))
    return _binned(ids, weights, nbins)


def histogram_bins(
    bin_ids: torch.Tensor, weights: torch.Tensor, nbins: int
) -> torch.Tensor:
    """Weighted histogram of integer bin ids (−1 or ≥ nbins dropped)."""
    return _binned(bin_ids, weights, nbins)


def histogram_segment(
    bin_ids: torch.Tensor, weights: torch.Tensor, nbins: int
) -> torch.Tensor:
    """Weighted histogram of a large id space (density volumes): the same
    scatter sum as `histogram_bins`; the JAX package sorts the ids first
    because a TPU has no fast scatter."""
    return _binned(bin_ids, weights, nbins)


def resample_histogram(hist: torch.Tensor, new_bins: int) -> torch.Tensor:
    """Conservative rebin of a histogram to another bin count (the export
    resampling of draw_property_export_window, VIAMD src/main.cpp:
    5822-5831): each source bin's mass spread over the target bins it
    overlaps, as one small matrix product."""
    n = hist.shape[-1]
    dev = hist.device
    src = torch.linspace(0.0, 1.0, n + 1, device=dev)
    dst = torch.linspace(0.0, 1.0, new_bins + 1, device=dev)
    lo = torch.maximum(src[None, :-1], dst[:-1, None])
    hi = torch.minimum(src[None, 1:], dst[1:, None])
    overlap = torch.clamp_min(hi - lo, 0.0) * n  # fraction of each source bin
    return hist.to(torch.float32) @ overlap.T
