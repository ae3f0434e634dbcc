"""Host time of the script's `sdf` builtin per frame in the traced
evaluation window: the summed durations of the program's `script.sdf`
spans ÷ the window's frames (passes × staged frames)."""

from portbench import spans


def read(run):
    ms = spans.total_ms("script.sdf")
    return None if ms is None else ms / run.window["frames"]
