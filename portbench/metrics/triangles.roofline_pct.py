"""csrc/triangles.cu's share of its roofline in the traced cartoon window.

Its work is counted from the configuration, not from the program: the
cartoon's triangles by the reference's mesh rule
(`reference/cartoon.py::triangle_count`), each read once (36 bytes of
vertices, 16 of rgba, 4 of pick id), and each pixel's rgba, depth and pick
written once (16 + 4 + 4 bytes), per frame. The tile lists and the ray
tests are not counted."""

from portbench.metrics_util import roofline_pct
from portbench.reference.cartoon import triangle_count

TRIANGLE_BYTES = 56
PIXEL_BYTES = 24


def read(run):
    cfg, tr, frames = run.config, run.traffic, run.window["frames"]
    n_tris = triangle_count(cfg["n_chains"], cfg["residues_per_chain"])
    nbytes = frames * (n_tris * TRIANGLE_BYTES + tr["width"] * tr["height"] * PIXEL_BYTES)
    return roofline_pct(0.0, nbytes, run.trace.kernel_seconds("triangle_tile_kernel"), run.peaks)
