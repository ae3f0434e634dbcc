"""Tracing: spans at the port's layer boundaries, on the device trace's clock.

Counterpart of viamd_tpu/core/tracing.py. The reference carries
PUSH_CPU_SECTION markers that are compiled-out no-ops and GL debug groups
for external profilers (VIAMD src/viamd.h:54-59; POSTPROCESS_ENABLE_TIMING
at postprocessing_utils.cpp:39-53; script wall-time logging at
main.cpp:70,987-996). Here a marker records a span: (name, start_ns,
end_ns, parent, root), stamped with `time.time_ns()`, the clock that
torch.profiler's kineto events report, so a span can be laid over the
device trace. `parent` is the enclosing span on the same thread, `root`
the outermost one (one request: a `Session.render`, a `Session.evaluate`).

`section(name)` scopes a span; `traced(name)` makes each call of a
function one. A span records only while `TRACER.enabled` is set (off by
default) or a torch profiler is collecting in the process; while one
collects, the span also opens a `torch.profiler.record_function` of its
name, so a Chrome or TensorBoard trace shows the program's stages over the
kernels. Otherwise `section` returns one shared no-op context: no record,
no allocation. A span never waits on the device; device time comes from
the device trace.

Records go to a bounded buffer (the newest `CAPACITY`); `stats()`,
`report()` and `spans()` read it.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled

CAPACITY = 1 << 18  # span records kept, the newest


class Span(NamedTuple):
    """One closed span. `parent` and `root` index the list `spans()`
    returns; −1 where there is no enclosing span or it has left the
    buffer (a root span's `root` is its own index)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


@dataclass
class SectionStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    self_s: float = 0.0  # total_s less the time of the direct children


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    """A span being recorded. Its record [name, start, end, parent,
    root, path], parent and root as sequence numbers, is in the buffer
    from the moment it opens; `end` stays None until it closes."""

    __slots__ = ("tracer", "rec", "seq", "rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.rec = [name, 0, None, -1, -1, name]
        self.rf = None

    def __enter__(self):
        tr, rec = self.tracer, self.rec
        stack = tr._stack()
        if stack:
            up = stack[-1].rec
            rec[3], rec[4], rec[5] = stack[-1].seq, up[4], f"{up[5]}/{rec[0]}"
        self.seq = tr._append(rec)
        if not stack:
            rec[4] = self.seq
        stack.append(self)
        if _profiling():
            self.rf = torch.profiler.record_function(rec[0])
            self.rf.__enter__()
        rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        # stamped inside the twin's start and after its end: the sides on
        # which the stamps lie closest to the twin's own
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec[2] = time.time_ns()
        self.tracer._stack().pop()
        return False


class Tracer:
    """Span recorder; it keeps the newest CAPACITY records."""

    def __init__(self):
        self._buf: deque = deque(maxlen=CAPACITY)
        self._seq = 0  # spans opened so far; never reset, so indices stay unique
        self._lock = threading.Lock()
        self._local = threading.local()
        self.enabled = False

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _append(self, rec: list) -> int:
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._buf.append(rec)
        return seq

    def section(self, name: str):
        """Span scope; nested names join with '/' in `stats`."""
        if not (self.enabled or _profiling()):
            return _NOOP
        return _Open(self, name)

    def current(self) -> Optional[str]:
        """The innermost open span's path on this thread ('a/b/c'), or
        None outside every span."""
        stack = self._stack()
        return stack[-1].rec[5] if stack else None

    def _closed(self) -> list:
        """The closed records in the buffer, each with its sequence number
        appended."""
        with self._lock:
            recs = list(self._buf)
            base = self._seq - len(recs)
        return [r + [base + i] for i, r in enumerate(recs) if r[2] is not None]

    def spans(self) -> list[Span]:
        """The closed spans in the buffer, in the order they opened."""
        recs = self._closed()
        pos = {r[6]: i for i, r in enumerate(recs)}
        return [Span(r[0], r[1], r[2], pos.get(r[3], -1), pos.get(r[4], -1)) for r in recs]

    def stats(self) -> dict[str, SectionStats]:
        """Per path ('outer/inner'): calls, total, max and self time."""
        recs = self._closed()
        child_ns: dict = {}
        for r in recs:
            if r[3] >= 0:
                child_ns[r[3]] = child_ns.get(r[3], 0) + r[2] - r[1]
        out: dict[str, SectionStats] = {}
        for r in recs:
            dt = (r[2] - r[1]) * 1e-9
            s = out.setdefault(r[5], SectionStats())
            s.calls += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)
            s.self_s += dt - child_ns.get(r[6], 0) * 1e-9
        return out

    def reset(self):
        with self._lock:
            self._buf.clear()

    def report(self) -> str:
        stats = self.stats()
        lines = ["section                                     calls    total      max     self"]
        for key in sorted(stats):
            s = stats[key]
            lines.append(
                f"{key:<42s} {s.calls:6d} {s.total_s * 1e3:8.2f}ms "
                f"{s.max_s * 1e3:8.2f}ms {s.self_s * 1e3:8.2f}ms"
            )
        return "\n".join(lines)


TRACER = Tracer()
section = TRACER.section


def traced(name: str):
    """Decorator: each call of the function is a span `name` of TRACER."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with TRACER.section(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
