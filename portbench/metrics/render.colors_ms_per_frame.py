"""Host time of the representations' colours per frame in the traced view
window: the summed durations of the program's `render.colors` spans
(`Session._rep_colors` with its dynamic filters and secondary-structure
weights) ÷ the window's frames."""

from portbench import spans


def read(run):
    ms = spans.total_ms("render.colors")
    return None if ms is None else ms / run.window["frames"]
