"""Device-idle time inside postprocess per frame in the traced view window:
for each of the program's `render.postprocess` spans, its interval less
the union of the device activities of `run.trace` that overlap it (both on
kineto's clock), summed, ÷ the window's frames."""

from portbench import spans


def read(run):
    ms = spans.idle_ms("render.postprocess", run.trace.kernels)
    return None if ms is None else ms / run.window["frames"]
