"""Atom-selection filter queries (the md_filter.h capability) — counterpart
of viamd_tpu.script.filterlang on the port's compiler.

The reference exposes a selection query language to the GUI — `md_filter`
returning an atom bitfield + is_dynamic flag (VIAMD src/viamd.cpp:1510,
src/main.cpp:3171) and a multi-structure variant (shapespace.cpp:365). It
shares the script front-end: a filter string is one script expression that
must evaluate to a selection. Selections are host values; `device` holds
the tensors a dynamic selection's per-frame mask closes over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.core.system import System
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.script import parser as P
from viamd_tpu_torch.script.compiler import _Compiler
from viamd_tpu_torch.script.parser import ScriptError
from viamd_tpu_torch.script.values import Selection


def evaluate_filter(
    expr: str,
    system: System,
    identifiers: Optional[dict[str, Bitfield]] = None,
    coords=None,
    device="cuda",
) -> tuple[Bitfield, bool]:
    """Evaluate a filter expression → (mask, is_dynamic).

    `coords` (n, 3) replaces the reference-frame coordinates, so dynamic
    selections (within / x / y / z) follow the current playback frame
    (viamd.cpp:1510). Raises ScriptError on parse and type errors."""
    sel = evaluate_filter_structures(expr, system, identifiers, coords, device)
    return sel.mask, sel.dynamic


def evaluate_filter_structures(
    expr: str,
    system: System,
    identifiers: Optional[dict[str, Bitfield]] = None,
    coords=None,
    device="cuda",
) -> Selection:
    """Multi-structure variant (md_filter_evaluate per-structure bitfields,
    shapespace.cpp:365): the whole Selection with its structures."""
    import torch

    stmts = P.parse(expr)
    if len(stmts) != 1:
        raise ScriptError("filter must be a single expression")
    comp = _Compiler(system, torch.empty(0, device=device).device, identifiers)
    if coords is not None:
        comp.x0 = np.ascontiguousarray(coords, dtype=np.float32)
    comp._x = comp.tensor(comp.x0)
    comp._basis = comp.tensor(comp.basis0)
    comp._inv = inv_basis_of(comp._basis)
    comp.env = dict(comp.injected)
    val = comp.eval(stmts[0].expr)
    if not isinstance(val, Selection):
        raise ScriptError("filter expression is not a selection")
    return val
