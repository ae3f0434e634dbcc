"""Async task system: pooled tasks with progress, interruption, dependencies.

A pure-Python copy of viamd_tpu/app/tasks.py (no device code).

Capability mirror of src/task_system.{h,cpp} (reference: enkiTS wrapper —
256-slot pool, range tasks, dependencies, interrupt flags, progress
fractions, main-thread pinned tasks, task_interrupt_and_wait_for).

Host-side I/O and orchestration run here (trajectory prefetch, script
evals); device work stays in the callers' torch code. "Pinned main-thread
tasks" become `run_main_queue()` callbacks — the host-callback pattern of
SURVEY.md §5.8.
"""

from __future__ import annotations

import queue
import threading
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class TaskHandle:
    id: str
    label: str
    future: Optional[Future] = None
    _progress: float = 0.0
    _interrupt: threading.Event = field(default_factory=threading.Event)
    dependency: Optional["TaskHandle"] = None

    @property
    def progress(self) -> float:
        return self._progress

    def set_progress(self, frac: float):
        self._progress = max(0.0, min(1.0, frac))

    def interrupt(self):
        self._interrupt.set()

    @property
    def interrupted(self) -> bool:
        return self._interrupt.is_set()

    def done(self) -> bool:
        return self.future is not None and self.future.done()

    def wait(self, timeout: Optional[float] = None):
        if self.future is not None:
            return self.future.result(timeout)

    def interrupt_and_wait(self, timeout: Optional[float] = None):
        """task_interrupt_and_wait_for (task_system.h:60)."""
        self.interrupt()
        try:
            self.wait(timeout)
        except Exception:
            pass


class TaskSystem:
    """Thread-pool tasks + a main-thread pinned queue."""

    def __init__(self, num_workers: int = 4):
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, num_workers), thread_name_prefix="vtpu-task"
        )
        self._tasks: dict[str, TaskHandle] = {}
        self._main_queue: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._lock = threading.Lock()

    # -- pool tasks ----------------------------------------------------------
    def enqueue(
        self,
        label: str,
        fn: Callable[[TaskHandle], Any],
        dependency: Optional[TaskHandle] = None,
    ) -> TaskHandle:
        """Run fn(task) on the pool. `fn` should poll task.interrupted and
        call task.set_progress."""
        handle = TaskHandle(id=uuid.uuid4().hex[:8], label=label,
                            dependency=dependency)

        def run():
            if dependency is not None:
                dependency.wait()
            if handle.interrupted:
                return None
            out = fn(handle)
            handle.set_progress(1.0)
            return out

        handle.future = self._pool.submit(run)
        with self._lock:
            self._tasks[handle.id] = handle
        return handle

    def enqueue_range(
        self,
        label: str,
        fn: Callable[[int, int, TaskHandle], Any],
        total: int,
        grain: int = 1024,
        dependency: Optional[TaskHandle] = None,
    ) -> TaskHandle:
        """Range task partitioned by grain across the pool (the enkiTS
        SetRanges pattern, task_system.cpp:75): every [beg, end) chunk is an
        independent pool submission sharing one handle's interrupt flag and
        progress fraction. Results come back ordered by range start; an
        interrupt drops not-yet-started chunks (in-flight chunks observe
        handle.interrupted themselves, like the reference's interrupt flag)."""
        handle = TaskHandle(id=uuid.uuid4().hex[:8], label=label,
                            dependency=dependency)
        ranges = [(beg, min(beg + grain, total))
                  for beg in range(0, total, grain)]
        n_chunks = max(len(ranges), 1)
        done_count = [0]
        count_lock = threading.Lock()

        _SKIPPED = object()

        def run_chunk(beg: int, end: int):
            if handle.interrupted:
                return _SKIPPED
            out = fn(beg, end, handle)
            with count_lock:
                done_count[0] += 1
                handle.set_progress(done_count[0] / n_chunks)
            return out

        def gather(_handle: TaskHandle):
            if dependency is not None:
                dependency.wait()
            if handle.interrupted:
                return []
            chunk_futs = [self._pool.submit(run_chunk, beg, end)
                          for beg, end in ranges]
            return [r for f in chunk_futs
                    if (r := f.result()) is not _SKIPPED]

        # The gather runs on a dedicated thread (not a pool worker): if it sat
        # in the pool, N concurrent range tasks could occupy every worker with
        # gathers and starve their own chunks.
        fut: Future = Future()

        def gather_thread():
            try:
                fut.set_result(gather(handle))
            except BaseException as exc:  # noqa: BLE001 - mirror pool behavior
                fut.set_exception(exc)

        handle.future = fut
        threading.Thread(target=gather_thread, daemon=True,
                         name=f"vtpu-range-{handle.id}").start()
        with self._lock:
            self._tasks[handle.id] = handle
        return handle

    def running_tasks(self) -> list[TaskHandle]:
        """Visible async tasks (the draw_async_task_window overlay feed,
        main.cpp:3889)."""
        with self._lock:
            self._tasks = {
                k: t for k, t in self._tasks.items() if not t.done()
            }
            return list(self._tasks.values())

    # -- main-thread pinned tasks -------------------------------------------
    def enqueue_main(self, fn: Callable[[], None]):
        self._main_queue.put(fn)

    def run_main_queue(self, max_items: int = 64) -> int:
        """Drain pinned tasks on the calling (main) thread."""
        n = 0
        while n < max_items:
            try:
                fn = self._main_queue.get_nowait()
            except queue.Empty:
                break
            fn()
            n += 1
        return n

    def shutdown(self, wait: bool = True):
        for t in self.running_tasks():
            t.interrupt()
        self._pool.shutdown(wait=wait)
