"""Build and load the hand-written CUDA kernels of `csrc/`.

Each library is compiled with `nvcc` for Hopper (`sm_90a`) into a shared
object with a plain C interface and loaded with ctypes. The build happens at
first use, into `_build/` beside this file (ignored by git), keyed by a hash
of the sources and flags, so a fresh checkout builds on its first call and
reuses the object afterwards. A missing `nvcc` or a failed build raises with
the compiler's output; nothing is ever skipped or replaced. `build` compiles
several libraries at once, one `nvcc` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no FMA contraction, so the kernels round every product and
# sum exactly as the plain PyTorch versions they are held to.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
# per library: {"seconds": build time (0 when reused), "log": nvcc output}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of viamd_tpu_torch/csrc must be built before use"
        )
    return found


def _target(name: str, sources: tuple[str, ...]) -> tuple[Path, list[str]]:
    """(shared object keyed by the sources' and flags' hash, its sources)."""
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so", [str(p) for p in paths]


def build(libraries: dict[str, tuple[str, ...]]) -> None:
    """Compile every library of {name: sources} not built yet, one `nvcc`
    per library, all started together; records build_info[name]. Raises on
    the first failed build, after every process has ended."""
    pending = []
    for name, sources in libraries.items():
        out, paths = _target(name, sources)
        if out.exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        else:
            pending.append((name, out, paths))
    if not pending:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, out, paths in pending:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *paths]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in jobs:
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed with exit code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile (once per source hash) and load `lib<name>.so` from csrc/."""
    lib = _loaded.get(name)
    if lib is None:
        build({name: sources})
        lib = ctypes.CDLL(str(_target(name, sources)[0]))
        _loaded[name] = lib
    return lib


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless tensor `t` is what a kernel takes: on `device`, of
    `dtype` and `shape`, contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
