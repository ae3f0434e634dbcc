"""Synchronizing CUDA calls inside `Session.render` per frame, as
`torch.cuda.set_sync_debug_mode("warn")` reports them, counted by
occurrence over the traced frames."""


def read(run):
    return run.cell.waits / run.window["frames"]
