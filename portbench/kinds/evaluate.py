"""Whole-trajectory evaluation: `Session.evaluate` of the configuration's
script over every staged frame, pass after pass, each pass fenced by
`EvalResult.force()`.

A traffic file of this kind gives the chunk (frames a chunk of the
Evaluator). Set-up compiles the script and runs one chunk.

Every pass evaluates the same frames, so besides comparing each pass with
the reference the check holds each pass to work done on the card: a pass
in which none of the program's hand-written kernels launched (a result
served from a cache) counts against `passes_without_launch`.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch

from portbench import inputs, program


@dataclass
class Cell:
    config: dict
    traffic: dict
    wb: inputs.WaterBox
    session: object
    kept: list = field(default_factory=list)  # [(pass, EvalResult)]
    launches: list = field(default_factory=list)  # hand-kernel launches of each pass


def setup(config: dict, traffic: dict, seed: int, device) -> Cell:
    """The Session over the seed's inputs, the script compiled and one
    chunk evaluated."""
    wb, stack = inputs.make(config, seed, device)
    s = program.session(wb, stack, config["script"], device)
    s.evaluate(frame_range=range(traffic["chunk"]), chunk=traffic["chunk"]).force()
    return Cell(config, traffic, wb, s)


def window(cell: Cell, seconds: float, seed: int, steps: int | None = None) -> dict:
    """Evaluate every frame, pass after pass, for `seconds` (or `steps`
    passes); a pass that has started finishes and counts. Every pass's
    result is kept for the check. → {"frames", "passes", "elapsed_s"}."""
    s, chunk = cell.session, cell.traffic["chunk"]
    passes = 0
    t_start = time.perf_counter()
    while (steps is None and time.perf_counter() - t_start < seconds) or (
            steps is not None and passes < steps):
        n0 = program.kernel_launches()
        res = s.evaluate(chunk=chunk)
        res.force()
        cell.launches.append(program.kernel_launches() - n0)
        cell.kept.append((passes, res))
        passes += 1
    elapsed = time.perf_counter() - t_start
    return {"frames": passes * cell.config["n_frames"], "passes": passes,
            "elapsed_s": elapsed}


def end_to_end(w: dict) -> dict:
    return {"analysis_frames_per_s": (w["frames"] / w["elapsed_s"], "frames/s")}


def release(cell: Cell) -> None:
    """Free the program's state; the kept results stay."""
    cell.session.shutdown()
    cell.session = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(cell: Cell, seed: int, device, limits: dict) -> tuple:
    """Every kept pass against one run of the plain reference → ({name:
    worst value over the passes, "passes_without_launch"}, the reference's
    result, the frames of the passes with a number over its limit)."""
    from portbench.reference import analysis as ref

    cfg = cell.config
    stack = inputs.frames(cell.wb, cfg["n_frames"], cfg["jitter_A"], seed, device)
    want = ref.evaluate(cell.wb, stack, cfg)
    del stack
    out: dict = {"passes_without_launch": sum(n == 0 for n in cell.launches)}
    failed = 0
    for (_, res), launched in zip(cell.kept, cell.launches):
        got = ref.compare({"r": res.distributions["r"], "v": res.volumes["v"],
                           **{k: res.temporal[k].reshape(-1) for k in ("lin", "plan", "iso")}},
                          want)
        failed += cfg["n_frames"] * (launched == 0 or any(v > limits[k] for k, v in got.items()))
        for name, v in got.items():
            out[name] = max(out.get(name, 0.0), v)
    return out, want, failed


def control(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control: the reference computed in bfloat16 in the program's
    place, held to the reference by `check`'s numbers."""
    from portbench.reference import analysis as ref

    wb, stack = inputs.make(config, seed, device)
    want = ref.evaluate(wb, stack, config)
    got = ref.evaluate(wb, stack, config, torch.bfloat16)
    return ref.compare({k: got[k].cpu().numpy() for k in ("r", "v", "lin", "plan", "iso")}, want)
