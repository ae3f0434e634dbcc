"""Share of the traced view window in which no operation ran on the device:
1 − (the union of every device activity ÷ the window), in %."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
