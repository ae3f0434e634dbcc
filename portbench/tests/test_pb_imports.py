"""No file the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (viamd_tpu_torch begins with viamd_tpu); the
reference imports nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run as R

FORBIDDEN = {"jax", "jaxlib", "flax", "viamd_tpu"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub=""):
    return sorted((R.HERE / sub).rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    bad = {str(p): imported_tops(p) & FORBIDDEN for p in sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        assert "viamd_tpu_torch" not in imported_tops(p), p
    for p in (R.HERE / "inputs.py", R.HERE / "trace.py"):
        assert "viamd_tpu_torch" not in imported_tops(p), p


def test_loaded_modules_at_run_time():
    code = (
        "import sys; import portbench.reference.analysis, portbench.reference.render, "
        "portbench.inputs, portbench.control, portbench.trace; "
        "import portbench.kinds.view, portbench.kinds.evaluate; "
        "tops = {m.split('.')[0] for m in sys.modules}; "
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'viamd_tpu', 'viamd_tpu_torch'}))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "viamd_tpu_torch_fake", object())
    assert "viamd_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "viamd_tpu.fake", object())
    assert "viamd_tpu" in R.forbidden_modules()
