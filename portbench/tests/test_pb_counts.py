"""The work the roofline readers count, against brute force: the reference's
cell-list pair histogram and pair count against all pairs of a small box,
and each reader's arithmetic on a made-up trace."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench import run as R
from portbench.reference import analysis
from portbench.trace import Trace


def brute_hist(x, box, r_max, nbins):
    """Every ordered pair (i ≠ j) in float64, minimum image in a cube."""
    x = x.astype(np.float64)
    d = x[:, None, :] - x[None, :, :]
    d -= box * np.round(d / box)
    r = np.sqrt((d * d).sum(-1))
    np.fill_diagonal(r, np.inf)
    r = r[r < r_max]
    return np.bincount((r * nbins / r_max).astype(np.int64), minlength=nbins)[:nbins], r.size // 2


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_pair_histogram_and_count(seed, one_thread):
    wb, st = inputs.make({"n_waters": 800, "density_atoms_per_A3": 0.1, "n_frames": 1,
                          "jitter_A": 0.15}, seed, "cpu")
    x = st[0][torch.as_tensor(wb.z == 8)]
    basis, inv = analysis.cell_tensors(wb, "cpu", torch.float32)
    r_max = wb.box / 3.5
    hist, pairs = analysis.rdf_hist(x, basis, inv, r_max, nbins=64)
    want, want_pairs = brute_hist(x.numpy(), wb.box, r_max, 64)
    # float32 against float64 distances: a pair may sit on a bin edge
    assert np.abs(hist.numpy() - want).sum() <= 4
    assert abs(pairs - want_pairs) <= 2 and pairs > 1000


@pytest.mark.parametrize("block,pairs_max", [(4, 1 << 25), (16, 1), (3, 100)])
def test_pair_histogram_tiling(block, pairs_max, one_thread):
    wb, st = inputs.make({"n_waters": 800, "density_atoms_per_A3": 0.1, "n_frames": 1,
                          "jitter_A": 0.15}, 5, "cpu")
    x = st[0][torch.as_tensor(wb.z == 8)]
    basis, inv = analysis.cell_tensors(wb, "cpu", torch.float32)
    a = analysis.rdf_hist(x, basis, inv, wb.box / 3.5, nbins=32)
    b = analysis.rdf_hist(x, basis, inv, wb.box / 3.5, nbins=32, block=block,
                          pairs_max=pairs_max)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]


def _run(kernels, frames, reference=None, cell=None, config=None, width=64, height=32):
    tr = Trace(window_s=1.0, busy_s=0.5, kernels=kernels)
    return R.Run(config or {"n_atoms": 100}, {"width": width, "height": height}, cell,
                 {"frames": frames}, tr, reference or {}, R.load_json(R.HERE / "peaks.json"))


def test_raster_reader_counts_bytes_from_the_inputs():
    peaks = R.load_json(R.HERE / "peaks.json")
    run = _run([("raster_tile_kernel(float4 const*)", 0, 1000)], frames=2)
    want = 2 * (100 * 24 + 64 * 32 * 24) / peaks["hbm_bytes_per_s"] / 1e-6 * 100
    assert R.metric_reader("raster.roofline_pct")(run) == pytest.approx(want)
    assert R.metric_reader("raster.roofline_pct")(_run([("other", 0, 5)], 2)) is None


def test_pair_hist_reader_counts_pairs_from_the_reference():
    peaks = R.load_json(R.HERE / "peaks.json")
    # the reference's histogram of a pass of 8 frames: 1e6 pairs a frame, both orders
    ref = {"r": torch.full((128,), 2 * 8 * 1e6 / 128, dtype=torch.float64)}
    cell = SimpleNamespace(wb=SimpleNamespace(z=np.tile([8, 1, 1], 1000)))
    run = _run([("pair_hist_kernel", 0, 2000), ("pair_hist_kernel", 5000, 2000)], 4, ref,
               cell, {"n_frames": 8})
    want = 4 * 23 * 1e6 / peaks["f32_flops_per_s"] / 4e-6 * 100
    assert R.metric_reader("pair_hist.roofline_pct")(run) == pytest.approx(want)
    # bytes bound a pass with few pairs: 1000 O positions and 128 bins a frame
    few = _run([("pair_hist_kernel", 0, 4000)], 4, {"r": torch.zeros(128, dtype=torch.float64)},
               cell, {"n_frames": 8})
    want = 4 * (12 * 1000 + 4 * 128) / peaks["hbm_bytes_per_s"] / 4e-6 * 100
    assert R.metric_reader("pair_hist.roofline_pct")(few) == pytest.approx(want)


def test_idle_and_count_readers():
    k = [("k1", 0, 10), ("Memcpy HtoD", 20, 5), ("k2", 30, 10)]
    run = _run(k, frames=2)
    assert R.metric_reader("device.idle_pct.view")(run) == pytest.approx(50.0)
    assert R.metric_reader("view.kernels_per_frame")(run) == 1.0
    assert R.metric_reader("evaluate.kernels_per_frame")(run) == 1.0


def test_trace_reduction():
    from portbench import trace

    class E:
        def __init__(self, name, s, d, dev, ann=False):
            self.n, self.s, self.d, self.dev, self.ann = name, s, d, dev, ann

        def name(self):
            return self.n

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

        def device_type(self):
            return torch.autograd.DeviceType.CUDA if self.dev else torch.autograd.DeviceType.CPU

        def is_user_annotation(self):
            return self.ann

    ev = [E(trace.WINDOW, 0, 1000, False, True), E(trace.WINDOW, 0, 1000, True, True),
          E("a", 100, 200, True), E("b", 250, 100, True), E("a", 600, 100, True),
          E("aten::nonzero", 350, 250, False), E("cudaStreamSynchronize", 360, 230, False)]
    t = trace.reduce(ev)
    assert t.window_s == pytest.approx(1e-6) and t.busy_s == pytest.approx(350e-9)
    assert t.device_ops[0][0] == "a" and t.device_ops[0][1] == pytest.approx(300e-9)
    assert t.idle_gaps[0][0] == "no traced host op"
    assert t.idle_gaps[0][1] == pytest.approx(300e-9)
    assert t.idle_gaps[1][0] == "aten::nonzero"  # covers the most of the gap
    assert sum(g for _, g in t.idle_gaps) == pytest.approx(650e-9)
