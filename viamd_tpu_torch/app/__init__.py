"""The port's application layer: so far the event bus and the task system
(pure-Python copies of viamd_tpu/app/events.py and tasks.py) that the
components subscribe through, and the exports (app/export.py)."""
