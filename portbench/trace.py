"""A traced window: torch.profiler's device activity and host ops, reduced
to the busy and idle time of the device, the device operations that took
the most time, and the longest idle gaps with what the host did in each.

The window is the span of a `portbench.window` annotation on the host;
device intervals are clipped to it. Busy time is the union of every device
activity (kernels, copies, fills), so overlapping streams count once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW = "portbench.window"
NAME_CHARS = 160  # of an operation's name in the breakdown


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list  # [(name, start_ns, duration_ns)] device activity in the window
    device_ops: list = field(default_factory=list)  # [[name, seconds]], top 10
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds]], top 10

    def kernel_seconds(self, name_part: str) -> float:
        """Device seconds of the activities whose name contains `name_part`."""
        return sum(d for n, _, d in self.kernels if name_part in n) * 1e-9

    def count(self, name_part: str = "") -> int:
        return sum(1 for n, _, _ in self.kernels if name_part in n)


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def capture(fn):
    """Run fn() under the profiler inside a WINDOW annotation, wait for
    the device, and return (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return out, reduce(prof.profiler.kineto_results.events())


def reduce(events) -> Trace:
    """Reduce the profiler's raw events to a Trace."""
    host, device, annotations = [], [], set()
    w0 = w1 = None
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            device.append((e.name(), s, d))
            continue
        if e.name() == WINDOW:
            w0, w1 = s, s + d
        elif e.is_user_annotation():
            annotations.add(e.name())
        else:
            host.append((e.name(), s, d))
    # a host annotation has a device-side twin of its name: not device work
    annotations.add(WINDOW)
    device = [ev for ev in device if ev[0] not in annotations]
    if w0 is None:
        raise RuntimeError("the traced window's annotation is missing from the trace")
    inside = [(n, max(s, w0), min(s + d, w1) - max(s, w0)) for n, s, d in device
              if s < w1 and s + d > w0]
    busy = _union([[s, s + d] for _, s, d in inside])
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    for n, _, d in inside:
        by_name[n] = by_name.get(n, 0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for g0, g1 in gaps:
        best, best_ov, best_d = "no traced host op", 0, 0
        for n, s, d in host:
            ov = min(s + d, g1) - max(s, g0)
            # the op that covers most of the gap; of equals, the innermost
            if ov > best_ov or (ov == best_ov and ov > 0 and d < best_d):
                best, best_ov, best_d = n, ov, d
        named.append([best[:NAME_CHARS], (g1 - g0) * 1e-9])
    return Trace(
        window_s=(w1 - w0) * 1e-9,
        busy_s=busy_ns * 1e-9,
        kernels=inside,
        device_ops=[[n[:NAME_CHARS], d * 1e-9] for n, d in top],
        idle_gaps=named,
    )


class SyncCounter:
    """Counts the synchronizing CUDA calls made inside `with` blocks, as
    `torch.cuda.set_sync_debug_mode("warn")` reports them, by occurrence."""

    def __init__(self):
        self.count = 0

    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.count += sum("synchroniz" in str(w.message) for w in self._log)
        self._catch.__exit__(*exc)
        return False
