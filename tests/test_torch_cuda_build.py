"""The port's one native-library layer (viamd_tpu_torch/cuda_build.py), on
the CPU: every library is declared once, keyed by its compiler's flags and
its sources under `_build/`, built and loaded once under a lock, and a
failed or impossible build raises and leaves nothing behind."""

import ctypes
import hashlib
import importlib
import os
import pkgutil
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

import viamd_tpu_torch
from viamd_tpu_torch import cuda_build
from viamd_tpu_torch.io import pdb, xtc
from viamd_tpu_torch.ops import cuda_rdf

THREADS = (os.cpu_count() or 4) + 2  # more threads than cores
WAIT = 120  # seconds any one wait may take


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """An empty `_build/` and nothing loaded or recorded yet."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build_info", {})
    return tmp_path


def _every_module_declared() -> list:
    for info in pkgutil.walk_packages(viamd_tpu_torch.__path__, "viamd_tpu_torch."):
        importlib.import_module(info.name)
    return cuda_build.declared()


def test_every_source_is_declared_once():
    """Each file under csrc/ belongs to exactly one declared library, and
    each library's compiler follows from its sources."""
    mods = _every_module_declared()
    sources = [s for m in mods for s in m.LIBRARY.sources]
    on_disk = sorted(p.relative_to(cuda_build.CSRC).as_posix()
                     for p in cuda_build.CSRC.rglob("*") if p.is_file())
    assert sorted(sources) == on_disk
    names = [m.LIBRARY.name for m in mods]
    assert len(set(names)) == len(names)
    for m in mods:
        lib = m.LIBRARY
        cu = all(s.endswith(".cu") for s in lib.sources)
        assert cu or all(s.startswith("host/") and s.endswith(".cpp") for s in lib.sources)
        assert (lib.compiler, lib.flags) == (("nvcc", cuda_build.NVCC_FLAGS) if cu
                                             else ("g++", cuda_build.GXX_FLAGS))
        if cu:  # the launch counter portbench/program.py::kernel_launches sums
            assert type(m.launches) is int


def test_cuda_targets_keyed_by_flags_and_sources(tmp_path, monkeypatch):
    """Every declared CUDA library's object sits under BUILD_DIR, named by
    a hash of nvcc's flags and its sources' bytes (not the host); the
    targets are distinct, and editing one source moves only its target."""
    kernels = [m.LIBRARY for m in _every_module_declared() if m.LIBRARY.compiler == "nvcc"]
    assert {lib.name for lib in kernels} >= {"pair_hist", "raster", "volume", "triangles",
                                              "gto", "hbao", "ribbon"}
    before = {}
    for lib in kernels:
        h = hashlib.sha256("\0".join(cuda_build.NVCC_FLAGS).encode())
        for s in lib.sources:
            h.update((cuda_build.CSRC / s).read_bytes())
        want = cuda_build.BUILD_DIR / f"lib{lib.name}-{h.hexdigest()[:16]}.so"
        assert lib.target() == want
        before[lib.name] = want.name
    assert len(set(before.values())) == len(kernels)

    csrc = tmp_path / "csrc"
    for lib in kernels:
        for s in lib.sources:
            (csrc / s).parent.mkdir(parents=True, exist_ok=True)
            (csrc / s).write_bytes((cuda_build.CSRC / s).read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    assert {lib.name: lib.target().name for lib in kernels} == before
    with open(csrc / cuda_rdf.LIBRARY.sources[0], "a") as f:
        f.write("\n")
    moved = {lib.name for lib in kernels if lib.target().name != before[lib.name]}
    assert moved == {"pair_hist"}


def _fake_nvcc(bin_dir):
    """An nvcc that writes a partial object where -o points and fails."""
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo partial > "$2"\necho "fake.cu(1): error: no kernel here"\nexit 2\n')
    nvcc.chmod(0o755)
    return str(nvcc)


@pytest.mark.parametrize("how", ["missing", "failing"])
def test_failed_first_load_leaves_nothing(fresh, monkeypatch, how):
    """With no nvcc, or an nvcc that fails, a first load raises with the
    compiler named (and its output), leaves no temporary file and caches
    nothing; the next load tries again."""
    if how == "missing":
        def no_nvcc():
            raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
        monkeypatch.setattr(cuda_build, "find_nvcc", no_nvcc)
        match = "nvcc not found"
    else:
        nvcc = _fake_nvcc(fresh.parent / f"{fresh.name}-bin")
        monkeypatch.setattr(cuda_build, "find_nvcc", lambda: nvcc)
        match = "(?s)nvcc failed for pair_hist with exit code 2.*no kernel here"
    for _ in range(2):
        with pytest.raises(RuntimeError, match=match):
            cuda_rdf.LIBRARY.load()
        assert list(fresh.rglob("*")) == []
        assert cuda_build._loaded == {}
        assert not cuda_rdf.LIBRARY.target().exists()


def test_threads_share_one_first_load(fresh, monkeypatch):
    """More threads than cores, switching as often as the interpreter
    allows, first load the same host codec at once: they run one build and
    get one library object, with the declared signatures applied."""
    runs = []
    popen = cuda_build.subprocess.Popen

    def counted(cmd, **kw):
        runs.append(cmd)
        return popen(cmd, **kw)

    monkeypatch.setattr(cuda_build.subprocess, "Popen", counted)
    start = threading.Barrier(THREADS, timeout=WAIT)

    def first():
        start.wait()
        return xtc.LIBRARY.load()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(THREADS) as ex:
            libs = [f.result(timeout=WAIT) for f in [ex.submit(first) for _ in range(THREADS)]]
    finally:
        sys.setswitchinterval(interval)
    assert all(lib is libs[0] for lib in libs)
    assert len(runs) == 1 and runs[0][0] == "g++"
    assert [p.name for p in fresh.iterdir()] == [xtc.LIBRARY.target().name]
    for entry, (restype, argtypes) in xtc.LIBRARY.signatures.items():
        fn = getattr(libs[0], entry)
        assert fn.restype is restype and list(fn.argtypes) == list(argtypes)


def test_concurrent_builds_of_several(fresh):
    """`build` from two threads at once, each compiling both codecs in
    parallel: per-thread temporary names, so both succeed, two objects
    result, no temporary file is left, and each build is recorded."""
    libs = (xtc.LIBRARY, pdb.LIBRARY)
    start = threading.Barrier(2, timeout=WAIT)

    def run():
        start.wait()
        cuda_build.build(libs)

    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(run) for _ in range(2)]:
            f.result(timeout=WAIT)
    assert sorted(p.name for p in fresh.iterdir()) == sorted(lib.target().name for lib in libs)
    assert set(cuda_build.build_info) == {lib.name for lib in libs}
    assert all(cuda_build.build_info[lib.name]["seconds"] > 0 for lib in libs)
    cuda_build.build(libs)  # reused: nothing runs, the record stays
    assert all(cuda_build.build_info[lib.name]["seconds"] > 0 for lib in libs)


def test_variant_swap_and_check(fresh):
    """A variant object bound in a library's place is what `load` returns;
    a check that the object fails raises and caches nothing."""
    built = xtc.LIBRARY.load()
    variant = xtc.LIBRARY.bind(ctypes.CDLL(str(xtc.LIBRARY.target())))
    cuda_build._loaded[xtc.LIBRARY.name] = variant
    assert xtc.LIBRARY.load() is variant and variant is not built
    assert variant.xtc_read_frames.restype is ctypes.c_int32
    picky = cuda_build.Library("vtt_xtc_picky", xtc.LIBRARY.sources, xtc.LIBRARY.signatures,
                               check=lambda lib: False)
    with pytest.raises(RuntimeError, match="disagree"):
        picky.bind(variant)
    assert "vtt_xtc_picky" not in cuda_build._loaded
