"""viamd_tpu_torch must never import jax or the JAX package (whose package
import pulls in jax): checked in a fresh interpreter."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import viamd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    viamd_tpu_torch.__path__, "viamd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "viamd_tpu" or m.startswith("viamd_tpu."))
print(len(names), bad)
for mod in ("ops.cuda_rdf", "render.camera", "render.color", "render.cuda_raster",
            "render.raster", "render.hbao", "render.fxaa", "render.postprocess",
            "ops.bonds", "ops.geometry", "ops.com", "ops.covariance", "ops.rmsd",
            "ops.pbc", "ops.rdf", "core.system", "script.compiler", "script.filterlang"):
    assert "viamd_tpu_torch." + mod in names, (mod, names)
assert not bad, bad
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "viamd_tpu." not in src.replace("viamd_tpu_torch", "")
