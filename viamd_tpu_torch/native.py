"""Build and load the host codecs of `csrc/host/` (C++, no CUDA).

Counterpart of viamd_tpu.native: the XTC codec (`xtc.cpp`) and the PDB
multi-model coordinate parser (`fastparse.cpp`) are compiled with the
system `g++`, with that package's flags, into shared objects with a plain
C interface and loaded with ctypes. The build happens at first use, into
`_build/` beside this file (ignored by git), as `cuda_build` builds the
CUDA kernels: keyed by a hash of the sources, the flags and the host (the
flags hold `-march=native`), written to a temporary file and renamed into
place, so processes that build at once (test workers) never load a half
written object. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

HOST_SRC = Path(__file__).resolve().parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# viamd_tpu/native/__init__.py:31-33
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

# the codecs: library name → sources under csrc/host
XTC = ("vtt_xtc", ("xtc.cpp",))
FASTPARSE = ("vtt_fastparse", ("fastparse.cpp",))

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def target(name: str, sources: tuple[str, ...]) -> Path:
    """The shared object for `sources`, keyed by their hash, the flags and
    the host machine."""
    h = hashlib.sha256("\0".join(GXX_FLAGS).encode())
    h.update(f"{platform.machine()}\0{platform.node()}".encode())
    for s in sources:
        h.update((HOST_SRC / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[str, ...]) -> Path:
    """Compile `sources` into the keyed shared object unless it exists."""
    out = target(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), *(str(HOST_SRC / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr[:4000]}")
    os.replace(tmp, out)
    return out


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (once per hash) and load `lib<name>.so`."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _loaded[name] = lib
        return lib
