"""viamd_tpu_torch must never import jax or the JAX package (whose package
import pulls in jax), nor h5py or PIL, which the GPU machine lacks (the
VeloxChem reader and the image export import them when called): checked in
a fresh interpreter."""

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
# the app layer imports and serves without them too
from viamd_tpu_torch.app import Session, cli, viewer, workspace
assert cli.build_parser().parse_args(["info", "x.pdb"]).device == "cuda"
# the Ramachandran reference tables come from the port's own copy
from viamd_tpu_torch.components.ramachandran import reference_density
assert reference_density("glycine").shape == (180, 180)
bad = sorted(m for m in sys.modules
             if m in ("jax", "viamd_tpu", "h5py", "PIL")
             or m.startswith(("jax.", "jaxlib", "viamd_tpu.", "h5py.", "PIL.")))
print(len(names), bad)
for mod in ("ops.cuda_rdf", "render.camera", "render.color", "render.cuda_raster",
            "render.raster", "render.hbao", "render.fxaa", "render.postprocess",
            "ops.bonds", "ops.geometry", "ops.com", "ops.covariance", "ops.rmsd",
            "ops.pbc", "ops.rdf", "core.system", "script.compiler", "script.filterlang",
            "cuda_build", "eval.engine", "io.trajectory", "io.loader", "io.xtc", "io.trr",
            "io.dcd", "io.cache", "io.gro", "io.pdb", "io.xyz", "io.mmcif", "io.lammps",
            "io.edr", "io.xvg", "io.csv", "render.volume", "render.cuda_volume",
            "render.colormap", "render.bokeh", "render.taa", "ops.histogram",
            "app.events", "app.tasks", "ops.backbone", "render.backbone_rep",
            "render.ribbon_mesh", "render.cuda_ribbon", "render.triangles", "render.cuda_triangles",
            "render.font", "render.overlay", "components", "components.ramachandran",
            "components.shapespace", "components.veloxchem", "components.density_volume",
            "components.dataset", "core.vlog", "io.basis", "io.vlx", "ops.gto", "ops.topo",
            "app.export", "interop", "app", "app.session", "app.cli", "app.viewer",
            "app.workspace", "core.tracing", "core.selection_utils", "ops.interpolate",
            "parallel", "parallel.mesh", "parallel.launch", "parallel.programs",
            "parallel.dryrun"):
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


def test_host_codecs_build_and_load(tmp_path, monkeypatch):
    """The host codecs build with g++ into a keyed shared object under
    `_build/` (here a fresh directory, so the build runs) and load; a
    second load reuses the object."""
    from viamd_tpu_torch import cuda_build
    from viamd_tpu_torch.io import pdb, xtc

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build_info", {})
    for lib in (xtc.LIBRARY, pdb.LIBRARY):
        out = lib.target()
        assert lib.compiler == "g++" and out.parent == tmp_path and not out.exists()
        cdll = lib.load()
        assert out.exists() and lib.load() is cdll
        assert not list(tmp_path.glob("*.tmp.so"))
    assert hasattr(xtc.LIBRARY.load(), "xtc_read_frames")
    assert hasattr(pdb.LIBRARY.load(), "pdb_parse_coords")
    assert xtc.LIBRARY.target().parent == tmp_path
    assert xtc.LIBRARY.target() != pdb.LIBRARY.target()
