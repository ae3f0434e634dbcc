"""The port's application layer: the headless `Session` (app/session.py),
the `.via` workspace (workspace.py), the command line (cli.py), the browser
viewer (viewer.py), the event bus and the task system (events.py, tasks.py)
and the exports (export.py) — counterparts of viamd_tpu/app/, each on an
explicit torch device."""

from viamd_tpu_torch.app.session import Session

__all__ = ["Session"]
