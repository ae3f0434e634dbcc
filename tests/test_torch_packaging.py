"""The port's kernel and host sources ship with the package: every file
under viamd_tpu_torch/csrc/ matches a package-data glob of pyproject.toml,
so a wheel or a non-editable install can build them (cuda_build.py builds
csrc/*.cu and csrc/host/*.cpp)."""

import re
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


def test_card_command_lists_every_card_test():
    """README.md's card command names each test file that holds a
    `requires_cuda` test, once, and no other; none of them imports jax, the
    JAX package or the tests package at module level, which the card's
    `--noconftest` run needs."""
    readme = (ROOT / "README.md").read_text()
    cmd = readme[readme.index("--noconftest -m requires_cuda"):]
    listed = re.findall(r"tests/(test_\w+\.py)", cmd[:cmd.index("\n\n")])
    card = sorted(p.name for p in (ROOT / "tests").glob("test_*.py")
                  if re.search(r"^@pytest\.mark\.requires_cuda$", p.read_text(), re.M))
    assert sorted(listed) == card and len(card) == 20
    for name in card:
        top = [ln for ln in (ROOT / "tests" / name).read_text().splitlines()
               if re.match(r"(import|from) (jax|viamd_tpu\b|tests\b)", ln)]
        assert not top, (name, top)
