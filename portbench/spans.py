"""The program's spans, as the per-layer metric readers take them.

The program (viamd_tpu_torch/core/tracing.py) records a span while a torch
profiler collects, so the traced window of `trace.capture` fills its
buffer with the window's spans, and nothing of set-up or the check. This
module reads that buffer from the program's tracing module, which the run
has already loaded, and imports nothing of the program: where the module
or its `spans()` is missing, it finds no span and a reader returns None.

A span is stamped with `time.time_ns()`, the clock of the kineto events a
`trace.Trace` holds, so it can be laid over `run.trace.kernels`.
"""

from __future__ import annotations

import bisect
import sys

from portbench.trace import _union

TRACING = "viamd_tpu_torch.core.tracing"


def records() -> list:
    """[(name, start_ns, end_ns, parent, root)] of the program's span
    buffer; `parent` and `root` index this list, −1 for none. [] where the
    program records no spans."""
    spans = getattr(getattr(sys.modules.get(TRACING), "TRACER", None), "spans", None)
    if spans is None:
        return []
    return [(str(n), int(s), int(e), int(p), int(r)) for n, s, e, p, r in spans()]


def intervals(name: str) -> list:
    """[(start_ns, end_ns)] of the spans named `name`."""
    return [(s, e) for n, s, e, _, _ in records() if n == name]


def total_ms(name: str) -> float | None:
    """The summed durations of the spans named `name`, in ms; None when
    there is none."""
    iv = intervals(name)
    return sum(e - s for s, e in iv) * 1e-6 if iv else None


def _idle_ns(span: tuple, busy: list, ends: list) -> int:
    """The time of `span` (start_ns, end_ns) in which no interval of
    `busy` (sorted, disjoint; `ends` their ends) runs."""
    s, e = span
    covered = 0
    i = bisect.bisect_right(ends, s)
    while i < len(busy) and busy[i][0] < e:
        covered += min(e, busy[i][1]) - max(s, busy[i][0])
        i += 1
    return (e - s) - covered


def idle_ms(name: str, kernels) -> float | None:
    """Device-idle time inside the spans named `name`: each span's interval
    less the union of the device activities that overlap it, summed, in
    ms; None when there is no such span."""
    iv = intervals(name)
    if not iv:
        return None
    busy = _union([[s, s + d] for _, s, d in kernels])
    ends = [b[1] for b in busy]
    return sum(_idle_ns(x, busy, ends) for x in iv) * 1e-6
