"""The port's kernel and host sources ship with the package: every file
under viamd_tpu_torch/csrc/ matches a package-data glob of pyproject.toml,
so a wheel or a non-editable install can build them (cuda_build.py builds
csrc/*.cu, native.py csrc/host/*.cpp)."""

import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "viamd_tpu_torch"
SOURCES = sorted(p.relative_to(PACKAGE).as_posix() for p in (PACKAGE / "csrc").rglob("*")
                 if p.is_file() and "__pycache__" not in p.parts)


def _shipped() -> set:
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["viamd_tpu_torch"]
    return {p.relative_to(PACKAGE).as_posix() for g in globs for p in PACKAGE.glob(g)}


def test_sources_found():
    assert {"csrc/gto.cu", "csrc/host/xtc.cpp", "csrc/host/fastparse.cpp"} <= set(SOURCES)


@pytest.mark.parametrize("source", SOURCES)
def test_source_is_package_data(source):
    assert source in _shipped(), f"{source} matches no package-data glob of viamd_tpu_torch"
