"""Tracing: CPU/device section timers with a real collector.

A copy of viamd_tpu/core/tracing.py over torch. The reference carries
PUSH_CPU_SECTION markers that are compiled-out no-ops and GL debug groups
for external profilers (VIAMD src/viamd.h:54-59; POSTPROCESS_ENABLE_TIMING
at postprocessing_utils.cpp:39-53; script wall-time logging at
main.cpp:70,987-996). Here the markers collect: nested sections accumulate
wall time + call counts into a global profile, and `section(...,
device=True)` waits for the work queued on the tracer's device (a CUDA
device: `torch.cuda.synchronize`) so the span covers the launched kernels.
A fence that fails raises: a span that silently stopped at the launch
would read as a fast kernel.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass
class SectionStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float):
        self.calls += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


class Tracer:
    """Section timers; `device` is the device a `device=True` section
    fences ("cuda" unless the caller asks for the CPU, where the fence is a
    no-op)."""

    def __init__(self, device="cuda"):
        self._stats: dict[str, SectionStats] = defaultdict(SectionStats)
        self._local = threading.local()
        self.enabled = True
        self.device = torch.device(device)

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def fence(self):
        """Wait for the work queued on the tracer's device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def section(self, name: str, device: bool = False):
        """Timed scope; nested names join with '/'."""
        if not self.enabled:
            yield
            return
        stack = self._stack()
        stack.append(name)
        key = "/".join(stack)
        t0 = time.perf_counter()
        try:
            yield
            if device:
                self.fence()
        finally:
            self._stats[key].add(time.perf_counter() - t0)
            stack.pop()

    def stats(self) -> dict[str, SectionStats]:
        return dict(self._stats)

    def reset(self):
        self._stats.clear()

    def report(self) -> str:
        lines = ["section                                     calls    total      max"]
        for key in sorted(self._stats):
            s = self._stats[key]
            lines.append(
                f"{key:<42s} {s.calls:6d} {s.total_s * 1e3:8.2f}ms "
                f"{s.max_s * 1e3:8.2f}ms"
            )
        return "\n".join(lines)


TRACER = Tracer()
section = TRACER.section
