"""Helpers the per-layer metric readers share."""


def kernel_count(trace) -> int:
    """Device activities in a Trace that are kernels, not copies or fills."""
    return sum(1 for n, _, _ in trace.kernels if not n.startswith(("Memcpy", "Memset")))


def roofline_pct(ops: float, nbytes: float, seconds: float, peaks: dict) -> float | None:
    """The least time the work can take on the card, the larger of its
    operations over peak float32 rate and its bytes over peak bandwidth,
    as a share of the measured device time, in %; None without a time."""
    if seconds <= 0:
        return None
    least = max(ops / peaks["f32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds
