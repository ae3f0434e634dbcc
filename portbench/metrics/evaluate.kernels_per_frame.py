"""Device kernels per evaluated frame in the traced evaluation window
(copies and fills not counted)."""

from portbench.metrics_util import kernel_count


def read(run):
    return kernel_count(run.trace) / run.window["frames"]
