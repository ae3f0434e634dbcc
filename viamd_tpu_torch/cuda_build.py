"""Build and load the port's native libraries: the hand-written CUDA kernels
of `csrc/*.cu` and the host codecs of `csrc/host/*.cpp`.

Each library is declared once, as data, by the module that calls it: a
module-level `LIBRARY = Library(name, sources, signatures)` holding its
sources under `csrc/` and the C signatures (restype, argtypes) of its entry
points. Its sources say its compiler: `nvcc` for Hopper (`sm_90a`) for
`.cu`, the system `g++` with the JAX package's flags for `.cpp`. The build
happens at first use, into `_build/` beside this file (ignored by git), as
a shared object with a plain C interface keyed by a hash of the flags and
the sources (and of the host machine where the flags hold `-march=native`),
written to a temporary file named per process and thread and renamed into
place, so builders that run at once (test workers, threads) never load a
half written object. `Library.load` builds and loads under one lock, once;
the launch path after that takes no lock. A missing compiler or a failed
build raises with the compiler's output; nothing is ever skipped or
replaced. `build` compiles several libraries at once, one compiler process
each, and records each one's seconds and output in `build_info`.

To run a variant build of one library (an experiment on the card), load it
in the declared library's place before the first launch:
`_loaded[lib.name] = lib.bind(ctypes.CDLL(path))`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading
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
# viamd_tpu/native/__init__.py:31-33
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # held around a first build and load only
# per library: {"seconds": build time (0 when reused), "log": compiler output}
build_info: dict[str, dict] = {}


class Library:
    """One native library: `name`, its `sources` under csrc/ (all `.cu` or
    all `.cpp`), `signatures` {entry point: (restype, argtypes)} applied at
    load, and an optional `check(cdll) -> bool` run once after them (a
    wrapper's agreement with the source); a False check raises."""

    def __init__(self, name: str, sources: tuple[str, ...], signatures: dict, check=None):
        self.name, self.sources, self.signatures, self.check = name, sources, signatures, check
        self.compiler = "nvcc" if sources[0].endswith(".cu") else "g++"
        self.flags = NVCC_FLAGS if self.compiler == "nvcc" else GXX_FLAGS

    def target(self) -> Path:
        """The shared object, keyed by the flags, the sources and (with
        `-march=native`) the host machine."""
        h = hashlib.sha256("\0".join(self.flags).encode())
        if "-march=native" in self.flags:
            h.update(f"{platform.machine()}\0{platform.node()}".encode())
        for s in self.sources:
            h.update((CSRC / s).read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def bind(self, cdll: ctypes.CDLL) -> ctypes.CDLL:
        """Apply the declared signatures to `cdll` and run the check."""
        for entry, (restype, argtypes) in self.signatures.items():
            fn = getattr(cdll, entry)
            fn.restype, fn.argtypes = restype, argtypes
        if self.check is not None and not self.check(cdll):
            raise RuntimeError(f"csrc/{', '.join(self.sources)} and the module declaring "
                               f"{self.name} disagree")
        return cdll

    def load(self) -> ctypes.CDLL:
        """The loaded library: built (once per hash) and bound on first use."""
        lib = _loaded.get(self.name)
        if lib is None:
            with _lock:
                lib = _loaded.get(self.name)
                if lib is None:
                    build([self])
                    lib = _loaded[self.name] = self.bind(ctypes.CDLL(str(self.target())))
        return lib


def declared() -> list:
    """The loaded modules of the port that declare a library (a module-level
    `LIBRARY`), by library name."""
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("viamd_tpu_torch.") and isinstance(getattr(m, "LIBRARY", None),
                                                                  Library)]
    return sorted(mods, key=lambda m: m.LIBRARY.name)


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


def build(libraries) -> None:
    """Compile every library not built yet, one compiler process each, all
    started together; records build_info[name]. Raises on the first failed
    build, after every process has ended, and leaves no temporary file."""
    pending = []
    for lib in libraries:
        out = lib.target()
        if out.exists():
            build_info.setdefault(lib.name, {"seconds": 0.0, "log": ""})
        else:
            pending.append((lib, out))
    if not pending:
        return
    compilers = {lib.compiler: find_nvcc() if lib.compiler == "nvcc" else "g++"
                 for lib, _ in pending}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for lib, out in pending:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [compilers[lib.compiler], *lib.flags, "-o", str(tmp),
               *(str(CSRC / s) for s in lib.sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((lib, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for lib, out, tmp, cmd, proc, t0 in jobs:
        log, _ = proc.communicate()
        build_info[lib.name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{lib.compiler} failed for {lib.name} with exit code "
                          f"{proc.returncode}:\n{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


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
