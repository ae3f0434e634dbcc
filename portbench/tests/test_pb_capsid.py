"""The capsid cells' files: the generator and the cartoon reference import
nothing of the program, the control exceeds a limit of `stmv.cartoon`, the
harness finds both new cells' files, the triangle roofline counts the
reference mesh's triangles, and a small run of the cell on the CPU comes
out correct."""

import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import capsid, run as R
from portbench.reference import cartoon as ref
from portbench.tests.test_pb_imports import imported_tops

SEED = 2**31 + 6061


def small():
    files = R.cell_files("stmv.cartoon")
    files["config"].update(n_chains=2, residues_per_chain=40, n_waters=200, n_ions=2,
                           box_A=50.0, shell_radius_A=14.0, n_frames=4)
    files["traffic"].update(width=96, height=72, min_frames=1, distance_box=1.2)
    return files


def test_generator_and_reference_import_nothing_of_the_program():
    for p in (R.HERE / "capsid.py", R.HERE / "reference" / "cartoon.py"):
        assert "viamd_tpu_torch" not in imported_tops(p), p
    code = ("import sys, portbench.capsid, portbench.reference.cartoon; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'viamd_tpu', 'viamd_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_both_cells_files_are_found():
    cart, view = R.cell_files("stmv.cartoon"), R.cell_files("water1m.view")
    assert cart["config"]["name"] == "stmv" and cart["traffic"]["kind"] == "cartoon"
    assert set(cart["limits"]) == {"pick_mismatch", "depth_rel_max", "rgb_mean_abs"}
    assert {m["name"] for m in cart["end_to_end"]} == {"view_ms", "view_ms_p95", "setup_s"}
    assert {"cartoon.mesh_ms_per_frame", "triangles.roofline_pct"} <= {
        m["name"] for m in cart["per_layer"]}
    assert "raster.roofline_pct" not in {m["name"] for m in cart["per_layer"]}
    assert view["config"]["name"] == "water1m" and view["traffic"]["kind"] == "view"
    assert (view["traffic"]["min_frames"], view["traffic"]["trace_steps"]) == (24, 12)
    assert {m["name"] for m in view["end_to_end"]} == {"view_ms", "view_ms_p95", "setup_s"}
    assert len(view["per_layer"]) == 6
    sizes = capsid.sizes(cart["config"])
    assert sizes["atoms"] == cart["config"]["n_atoms"]
    assert sizes["protein"] == cart["config"]["n_protein_atoms"]
    assert sizes["water"] == cart["config"]["n_water_atoms"]


def test_triangle_roofline_counts_the_reference_mesh():
    files = small()
    cfg, tr = files["config"], files["traffic"]
    cap = capsid.capsid(cfg, SEED)
    w = np.tile([[0.2, 0.3, 0.5]], (cfg["n_chains"] * cfg["residues_per_chain"], 1))
    tris, src = ref.ribbon_mesh(cap.coords, cap, w)
    n_tris = ref.triangle_count(cfg["n_chains"], cfg["residues_per_chain"])
    assert tris.shape == (n_tris, 3, 3) and src.shape == (n_tris,)
    trace = SimpleNamespace(kernel_seconds=lambda name: 1e-3 * (name == "triangle_tile_kernel"))
    run = R.Run(cfg, tr, None, {"frames": 2}, trace, None, R.load_json(R.HERE / "peaks.json"))
    want = 100.0 * 2 * (n_tris * 56 + 96 * 72 * 24) / 3.35e12 / 1e-3
    assert R.metric_reader("triangles.roofline_pct")(run) == pytest.approx(want)
    assert R.metric_reader("cartoon.mesh_ms_per_frame")(run) is None  # no span recorded


def test_control_exceeds_a_limit():
    torch.set_num_threads(4)
    from portbench.kinds import cartoon as kind

    files = small()
    got = kind.control(files["config"], files["traffic"], SEED, "cpu")
    assert set(got) == set(files["limits"])
    assert any(got[k] > v for k, v in files["limits"].items()), got


def test_small_run_is_correct():
    torch.set_num_threads(4)
    result, checks = R.run_cell(small(), SEED, 0.5, False, "cpu", time.perf_counter())
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"view_ms", "view_ms_p95", "setup_s"}


def test_a_program_without_attach_fails_before_the_inputs(monkeypatch):
    from portbench.kinds import cartoon as kind
    from viamd_tpu_torch.app import Session

    made = []
    monkeypatch.setattr(capsid, "make", lambda *a, **k: made.append(1))
    monkeypatch.delattr(Session, "attach")
    files = small()
    with pytest.raises(AttributeError):
        kind.setup(files["config"], files["traffic"], SEED, "cpu")
    assert made == []
