"""Where the time of the molecule render path goes, on one NVIDIA GPU.

    python -m viamd_tpu_torch.profile_render [--frames 8]

The scene is chip_smoke.py's: water_box_device(33_334, seed=3), 1920×1080,
bench.py's camera, CPK colours, in spacefill and licorice. For each
representation it prints
- the median time of each stage over the frames (CUDA events around
  work that ends in a synchronize): build_scene (view transform, bond
  halves, tile binning), the raster kernel (render_scene), and the three
  stages of postprocess.execute — ambient_occlusion (HBAO),
  tonemap_compose, antialias (FXAA);
- the busy share of the device over render_molecules → execute
  (torch.profiler: device time of all kernels ÷ wall time, with the
  profiler on) and the kernels with the most device time.
Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from viamd_tpu_torch import datagen
from viamd_tpu_torch.render import postprocess
from viamd_tpu_torch.render.raster import (
    RasterSettings,
    build_scene,
    render_molecules,
    render_scene,
)

WIDTH, HEIGHT = 1920, 1080


def _timed(fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profile(rep: str, frames: int, traj, inputs: dict) -> None:
    dev = traj.device
    s = RasterSettings(width=WIDTH, height=HEIGHT, rep=rep)
    pp = postprocess.PostprocessSettings()
    proj = inputs["proj"]
    args = (inputs["radii"], inputs["colors"], inputs["view"], proj, s, inputs["bonds"])
    stages: dict[str, list[float]] = {}
    for f in range(-1, frames):  # frame -1: warm-up, not recorded
        x = traj.device_frame(max(f, 0))[0]
        scene, t_bin = _timed(lambda: build_scene(x, *args, device=dev))
        (img, dep, _), t_ras = _timed(lambda: render_scene(scene))
        ao, t_ao = _timed(lambda: postprocess.ambient_occlusion(dep, pp, proj))
        rgb, t_tm = _timed(lambda: postprocess.tonemap_compose(img, ao, pp))
        _, t_fx = _timed(lambda: postprocess.antialias(rgb, pp))
        if f >= 0:
            for k, v in (("build_scene", t_bin), ("raster kernel", t_ras),
                         ("hbao", t_ao), ("tonemap + compose", t_tm), ("fxaa", t_fx)):
                stages.setdefault(k, []).append(v)
    total = sum(statistics.median(v) for v in stages.values())
    print(f"[{rep}] median ms per frame over {frames} frames: " + ", ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in stages.items()
    ) + f"; sum {total:.3f}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for f in range(frames):
            x = traj.device_frame(f)[0]
            img, dep, _ = render_molecules(x, *args, device=dev)
            postprocess.execute(img, dep, pp, proj=proj)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    # device-side entries only: an operator's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / frames / 1e3
    launches = sum(e.count for e in kernels) / frames
    print(f"[{rep}] profiled render_molecules + execute: wall {wall:.3f} ms/frame "
          f"(profiler on), device {dev_ms:.3f} ms/frame, busy share "
          f"{dev_ms / wall:.3f}, {launches:.0f} kernel launches/frame")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[{rep}]   {e.self_device_time_total / frames / 1e3:8.3f} ms/frame "
              f"{e.count / frames:6.1f}x  {e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    sys_, traj = datagen.water_box_device(33_334, n_frames=a.frames, seed=3, device=dev)
    inputs = datagen.render_inputs(sys_, WIDTH, HEIGHT, device=dev)
    for rep in ("spacefill", "licorice"):
        profile(rep, a.frames, traj, inputs)


if __name__ == "__main__":
    main()
