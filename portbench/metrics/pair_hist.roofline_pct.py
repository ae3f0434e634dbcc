"""csrc/pair_hist.cu's share of its roofline in the traced evaluation
window.

Its work is counted from the inputs, not from the kernel's cell walk: the
O–O pairs within r_max are the plain reference's (its histogram holds each
pair in both orders, summed over the frames of a pass; the few pairs that
round onto r_max itself are not in it), and each takes one minimum-image
distance and one bin (22 + 1 float32 operations). The O positions are read
once and the histogram written once (12 bytes an atom, 4 a bin)."""

from portbench.metrics_util import roofline_pct

OPS_PER_PAIR = 23


def read(run):
    hist = run.reference["r"]
    pairs_per_frame = float(hist.sum()) / 2 / run.config["n_frames"]
    n_o = int((run.cell.wb.z == 8).sum())
    frames = run.window["frames"]
    ops = OPS_PER_PAIR * pairs_per_frame * frames
    nbytes = frames * (12 * n_o + 4 * hist.numel())
    return roofline_pct(ops, nbytes, run.trace.kernel_seconds("pair_hist_kernel"), run.peaks)
