"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. The cell names a configuration (portbench/configs/<name>.json)
and a traffic mix (portbench/traffic/<name>.json, whose "kind" names the
module in portbench/kinds/); its limits are portbench/limits/<cell>.json;
each per-layer metric is read by portbench/metrics/<metric>.py. With
--trace 0 the line holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics from a traced window of the mix's `trace_steps` steps.
Either way the outputs of the window are compared with the plain reference
(portbench/reference/) once it has closed, and `correct` says whether every
number is within its limit; the numbers and limits are the last lines on
standard error and the `checks` key of the result line.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "viamd_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (viamd_tpu_torch is not viamd_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, bench: dict | None = None) -> dict:
    """The files a cell of BENCHMARK.json names, found by name."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return {
        "workload": w,
        "config": load_json(ROOT / configs[w["config"]]["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])],
        "per_layer": [m for m in bench["per_layer"]
                      if workload in m.get("workloads", [workload])],
    }


def metric_reader(name: str):
    """portbench/metrics/<name>.py's `read`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a per-layer metric reader reads."""

    config: dict
    traffic: dict
    cell: object  # the kind's Cell (its inputs: `cell.wb`)
    window: dict  # the kind's window summary ("frames", …)
    trace: object  # portbench.trace.Trace
    reference: object  # what the kind's plain reference computed for the check
    peaks: dict


def run_cell(files: dict, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> tuple:
    """Set-up, window, check: → (result dict, checks {name: (value, limit)})."""
    import torch

    from portbench import trace as trace_mod

    kind = importlib.import_module(f"portbench.kinds.{files['traffic']['kind']}")
    cfg, tr = files["config"], files["traffic"]
    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = kind.setup(cfg, tr, seed, device)
    sync()
    setup_s = time.perf_counter() - t_process
    tr_out = None
    if trace:
        w, tr_out = trace_mod.capture(
            lambda: kind.window(cell, seconds, seed, steps=tr["trace_steps"]))
    else:
        w = kind.window(cell, seconds, seed)
    sync()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    kind.release(cell)
    t_check = time.perf_counter()
    limits = files["limits"]
    values, reference, failed = kind.check(cell, seed, device, limits)
    sync()
    print(f"portbench: set-up {setup_s:.3f} s, window {w['elapsed_s']:.3f} s with "
          f"{w['frames']} frames, reference and check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    checks = {k: (float(values[k]), float(limits[k])) for k in limits}
    metrics = {}
    if trace:
        ctx = Run(cfg, tr, cell, w, tr_out, reference, load_json(HERE / "peaks.json"))
        for m in files["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        got = kind.end_to_end(w)
        got["setup_s"] = (setup_s, "s")
        for m in files["end_to_end"]:
            v, unit = got[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": unit}
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": int(w["frames"]),
        "failed": int(failed),
        "metrics": metrics,
        "device": {},
        "memory_peak_bytes": int(peak),
    }
    if tr_out is not None:
        result["busy_s"] = tr_out.busy_s
        result["window_s"] = tr_out.window_s
        result["breakdown"] = {"device_ops": tr_out.device_ops, "idle_gaps": tr_out.idle_gaps}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = cell_files(args.workload)
    import torch

    chips = files["workload"]["chips"]
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {torch.cuda.device_count()} CUDA devices, the cell needs {chips}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(files, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    peak = result.pop("memory_peak_bytes")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": peak}
    for k in ("busy_s", "window_s"):
        if k in result:
            device[k] = result.pop(k)
    result["device"] = device
    breakdown = result.pop("breakdown", None)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
