"""csrc/raster.cu's share of its roofline in the traced view window.

Its work is counted from the inputs, not from the kernel's cull: each
sphere's centre, radius, colour and id read once (16 + 8 bytes) and each
pixel's rgba, depth and pick written once (16 + 4 + 4 bytes), per frame.
Its operations are not counted: bytes bound it (a sphere's test is some
twenty operations, and a culled walk tests few spheres a pixel)."""

from portbench.metrics_util import roofline_pct

SPHERE_BYTES = 24
PIXEL_BYTES = 24


def read(run):
    tr, frames = run.traffic, run.window["frames"]
    nbytes = frames * (run.config["n_atoms"] * SPHERE_BYTES
                       + tr["width"] * tr["height"] * PIXEL_BYTES)
    return roofline_pct(0.0, nbytes, run.trace.kernel_seconds("raster_tile_kernel"), run.peaks)
