"""Host time of the cartoon's mesh per frame in the traced view window: the
summed durations of the program's `cartoon.mesh` spans
(`render/ribbon_mesh.py::ribbon_mesh` over every chain) ÷ the window's
frames."""

from portbench import spans


def read(run):
    ms = spans.total_ms("cartoon.mesh")
    return None if ms is None else ms / run.window["frames"]
