"""Logging: pluggable sinks + dedup window — copy of viamd_tpu.core.vlog.

Capability mirror of mdlib's md_log (reference: pluggable md_logger_i sinks;
viamd registers a deduplicating (1 s hash window) toast notifier at
VIAMD src/main.cpp:378-421; VIAMD_LOG_* adds a SUCCESS level,
src/viamd.h:62-65).
"""

from __future__ import annotations

import sys
import time
from typing import Callable

DEBUG, INFO, SUCCESS, WARNING, ERROR = 10, 20, 25, 30, 40
_NAMES = {DEBUG: "debug", INFO: "info", SUCCESS: "success",
          WARNING: "warning", ERROR: "error"}

_sinks: list[Callable[[int, str], None]] = []
_dedup: dict[int, float] = {}
DEDUP_WINDOW_S = 1.0  # main.cpp's 1 s hash window


def register_sink(fn: Callable[[int, str], None]):
    """md_log_register analog; fn(level, message)."""
    _sinks.append(fn)
    return fn


def unregister_sink(fn):
    try:
        _sinks.remove(fn)
    except ValueError:
        pass


def _stderr_sink(level: int, msg: str):
    print(f"[viamd_tpu_torch:{_NAMES.get(level, level)}] {msg}", file=sys.stderr)


_default_enabled = True


def set_default_sink(enabled: bool):
    global _default_enabled
    _default_enabled = enabled


def log(level: int, msg: str, dedup: bool = True):
    if dedup:
        h = hash((level, msg))
        now = time.monotonic()
        last = _dedup.get(h, -1e9)
        if now - last < DEDUP_WINDOW_S:
            return
        _dedup[h] = now
    for s in _sinks:
        s(level, msg)
    if _default_enabled and not _sinks:
        _stderr_sink(level, msg)


def debug(msg, **kw):
    log(DEBUG, msg, **kw)


def info(msg, **kw):
    log(INFO, msg, **kw)


def success(msg, **kw):
    log(SUCCESS, msg, **kw)


def warning(msg, **kw):
    log(WARNING, msg, **kw)


def error(msg, **kw):
    log(ERROR, msg, **kw)
