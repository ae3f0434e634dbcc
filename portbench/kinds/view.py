"""Interactive playback: each frame advances the playback position, orbits
the camera and renders the composed frame through `Session.render`.

A traffic file of this kind gives the frame size, the playback step (in
trajectory frames per displayed frame), the orbit (degrees per frame, the
elevation, the eye's distance in box edges, the field of view), the
selection that is outlined and the volume property drawn in the scene.
Set-up evaluates the script once, for the volume, and renders two frames.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import inputs, program
from portbench.trace import SyncCounter


@dataclass
class Frame:
    """What a displayed frame is made from, and what the program made."""

    k: int
    t: float  # playback position, trajectory frames
    eye: tuple
    out: tuple = ()  # (rgba, depth, pick) tensors


@dataclass
class Cell:
    config: dict
    traffic: dict
    wb: inputs.WaterBox
    session: object
    kept: list = field(default_factory=list)
    waits: int = 0


def view_params(traffic: dict, wb: inputs.WaterBox, n_frames: int, k: int) -> Frame:
    """Frame k of the mix: the playback position wraps at the last frame;
    the eye orbits the box centre about +y."""
    t = (k * traffic["frame_step"]) % (n_frames - 1)
    az = math.radians(traffic["azimuth0_deg"] + k * traffic["orbit_deg_per_frame"])
    el = math.radians(traffic["elevation_deg"])
    dist = traffic["distance_box"] * wb.box
    c = np.full(3, wb.box * 0.5)
    eye = c + dist * np.array([math.cos(el) * math.sin(az), math.sin(el),
                               math.cos(el) * math.cos(az)])
    return Frame(k, t, tuple(float(v) for v in eye))


def camera_args(traffic: dict, wb: inputs.WaterBox, eye) -> dict:
    dist = traffic["distance_box"] * wb.box
    return dict(eye=eye, center=np.full(3, wb.box * 0.5), up=(0.0, 1.0, 0.0),
                fovy=math.radians(traffic["fovy_deg"]), znear=traffic["znear"],
                zfar=dist + 2.0 * wb.box)


def setup(config: dict, traffic: dict, seed: int, device) -> Cell:
    """The Session over the seed's inputs, `v` evaluated, the selection
    made, and two frames rendered."""
    wb, stack = inputs.make(config, seed, device)
    s = program.session(wb, stack, config["script"], device)
    s.evaluate(chunk=traffic["eval_chunk"]).force()
    s.select(traffic["selection"])
    cell = Cell(config, traffic, wb, s)
    for k in (-2, -1):  # every shape the window renders, before it starts
        render(cell, view_params(traffic, wb, config["n_frames"], k))
    return cell


def render(cell: Cell, fr: Frame, waits: SyncCounter | None = None) -> Frame:
    s, tr = cell.session, cell.traffic
    s.set_frame(fr.t)
    s.camera = program.camera(**camera_args(tr, cell.wb, fr.eye))
    with waits or contextlib.nullcontext():
        fr.out = s.render(tr["width"], tr["height"], volume=tr["volume"], postprocess=True)
    if fr.out[0].is_cuda:
        torch.cuda.synchronize()
    return fr


def sampled_frame(traffic: dict, seed: int) -> int:
    """The frame the check compares besides the last: drawn from the seed
    among the first `min_frames`."""
    return int(np.random.RandomState(inputs.host_seed(seed)).randint(traffic["min_frames"]))


def window(cell: Cell, seconds: float, seed: int, steps: int | None = None) -> dict:
    """Render frames for `seconds` (or `steps` frames); a frame that has
    started finishes and counts. Keeps frame `sample` (drawn from the
    seed among the first `min_frames`) and the last frame for the check.
    → {"frames", "elapsed_s", "frame_s"}."""
    tr, wb, n_frames = cell.traffic, cell.wb, cell.config["n_frames"]
    sample = sampled_frame(tr, seed)
    if steps is not None:
        sample = min(sample, steps - 1)
    waits = SyncCounter() if steps is not None else None
    times, last = [], None
    t_start = time.perf_counter()
    k = 0
    while (steps is None and time.perf_counter() - t_start < seconds) or (
            steps is not None and k < steps):
        t0 = time.perf_counter()
        fr = render(cell, view_params(tr, wb, n_frames, k), waits)
        times.append(time.perf_counter() - t0)
        if k == sample:
            cell.kept.append(fr)
        last = fr
        k += 1
    elapsed = time.perf_counter() - t_start
    if last is not None and last.k != sample:
        cell.kept.append(last)
    cell.waits = waits.count if waits is not None else 0
    if k <= sample:
        raise RuntimeError(f"the window rendered {k} frames, fewer than the sampled "
                           f"frame {sample}: raise the window or lower min_frames")
    return {"frames": k, "elapsed_s": elapsed, "frame_s": times}


def end_to_end(w: dict) -> dict:
    """The window's end-to-end numbers: the mean frame time over the
    window, and the 95th percentile of every frame in it."""
    return {
        "view_ms": (w["elapsed_s"] * 1e3 / w["frames"], "ms/frame"),
        "view_ms_p95": (float(np.percentile(np.asarray(w["frame_s"]) * 1e3, 95)), "ms"),
    }


def release(cell: Cell) -> None:
    """Free the program's state; the kept frames stay."""
    cell.session.shutdown()
    cell.session = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(cell: Cell, seed: int, device, limits: dict) -> tuple:
    """The kept frames against the plain reference → ({name: worst value
    over the frames}, the reference's Scene, the frames with a number over
    its limit)."""
    from portbench.reference import render as ref

    tr, cfg = cell.traffic, cell.config
    stack = inputs.frames(cell.wb, cfg["n_frames"], cfg["jitter_A"], seed, device)
    scene = ref.Scene(cell.wb, stack, cfg, tr)
    out: dict = {}
    failed = 0
    for fr in cell.kept:
        got = ref.compare(fr.out, scene.frame(fr.t, camera_args(tr, cell.wb, fr.eye)))
        failed += any(got[k] > lim for k, lim in limits.items())
        for name, v in got.items():
            out[name] = max(out.get(name, 0.0), v)
    return out, scene, failed


def control(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control: the reference's bfloat16 chain in the program's place,
    held to the reference by `check`'s numbers over two frames of the mix
    as a window keeps them (the sampled one, and one `min_frames` later)
    → {name: worst value}."""
    from portbench.reference import render as ref

    sample = sampled_frame(traffic, seed)
    ks = (sample, sample + traffic["min_frames"])
    wb, stack = inputs.make(config, seed, device)
    want, got = ref.Scene(wb, stack, config, traffic), ref.Scene(wb, stack, config, traffic,
                                                                  control=True)
    out: dict = {}
    for k in ks:
        fr = view_params(traffic, wb, config["n_frames"], k)
        cam = camera_args(traffic, wb, fr.eye)
        for name, v in ref.compare(got.frame(fr.t, cam)[:3], want.frame(fr.t, cam)).items():
            out[name] = max(out.get(name, 0.0), v)
    return out
