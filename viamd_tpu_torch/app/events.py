"""Event bus: synchronous broadcast + timestamp-ordered delayed queue.

A pure-Python copy of viamd_tpu/app/events.py (no device code).

Capability mirror of src/event.{h,cpp} + src/viamd_event.h (reference:
global pub/sub with compile-time string-hash event types, immediate
broadcast via event_system_broadcast_event:event.cpp:32 and a delayed queue
drained per frame via event_system_process_event_queue:event.cpp:45; the
~20-type event vocabulary at viamd_event.h:12-52).
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable


# Event vocabulary (the viamd_event.h analog)
class EventType:
    INITIALIZE = "initialize"
    SHUTDOWN = "shutdown"
    FRAME_TICK = "frame_tick"
    SYSTEM_INIT = "system_init"  # new system loaded
    TRAJECTORY_INIT = "trajectory_init"
    SYSTEM_STATE_CHANGED = "system_state_changed"  # interpolated coords moved
    SELECTION_CHANGED = "selection_changed"
    HIGHLIGHT_CHANGED = "highlight_changed"
    REPRESENTATION_CHANGED = "representation_changed"
    SCRIPT_COMPILED = "script_compiled"
    EVAL_STARTED = "eval_started"
    EVAL_PROGRESS = "eval_progress"
    EVAL_COMPLETE = "eval_complete"
    SERIALIZE = "serialize"  # workspace save: components append sections
    DESERIALIZE = "deserialize"  # workspace load: components read sections
    LOAD_DATA = "load_data"  # supplemental file loaded
    RENDER = "render"


@dataclass
class Event:
    type: str
    payload: Any = None
    timestamp: float = field(default_factory=time.monotonic)


class EventBus:
    """Synchronous broadcast + delayed queue (drained by Session.tick)."""

    def __init__(self):
        self._handlers: dict[str, list[Callable[[Event], None]]] = {}
        self._queue: list = []
        self._counter = itertools.count()

    def subscribe(self, event_type: str, handler: Callable[[Event], None]):
        self._handlers.setdefault(event_type, []).append(handler)
        return handler

    def unsubscribe(self, event_type: str, handler):
        try:
            self._handlers.get(event_type, []).remove(handler)
        except ValueError:
            pass

    def broadcast(self, event_type: str, payload: Any = None):
        """Immediate synchronous delivery (event_system_broadcast_event)."""
        ev = Event(event_type, payload)
        for h in list(self._handlers.get(event_type, [])):
            h(ev)
        return ev

    def enqueue(self, event_type: str, payload: Any = None, delay: float = 0.0):
        """Deferred delivery, timestamp-ordered (the delayed queue)."""
        ev = Event(event_type, payload, time.monotonic() + delay)
        heapq.heappush(self._queue, (ev.timestamp, next(self._counter), ev))

    def process_queue(self, now: float | None = None):
        """Deliver all due queued events (event_system_process_event_queue)."""
        now = time.monotonic() if now is None else now
        delivered = 0
        while self._queue and self._queue[0][0] <= now:
            _, _, ev = heapq.heappop(self._queue)
            for h in list(self._handlers.get(ev.type, [])):
                h(ev)
            delivered += 1
        return delivered
