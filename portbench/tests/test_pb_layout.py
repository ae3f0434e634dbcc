"""The harness finds a cell's files by the names in BENCHMARK.json: a
configuration, a traffic mix, limits and a per-layer metric added as new
files are picked up with no edit to any file already there."""

import json
import shutil

from portbench import run as R


def test_dropped_in_files_are_found(tmp_path, monkeypatch):
    shutil.copytree(R.HERE, tmp_path / "portbench")
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    here = tmp_path / "portbench"
    cfg = dict(R.load_json(here / "configs" / "water100k.json"), name="water10k", n_waters=3334)
    (here / "configs" / "water10k.json").write_text(json.dumps(cfg))
    mix = dict(R.load_json(here / "traffic" / "view.json"), width=1280, height=720)
    (here / "traffic" / "view720.json").write_text(json.dumps(mix))
    (here / "limits" / "water10k.view720.json").write_text(json.dumps({"pick_mismatch": 0.5}))
    (here / "metrics" / "view.frames.py").write_text(
        "def read(run):\n    return run.window['frames']\n")
    bench["configs"].append({"name": "water10k", "source": "x",
                             "file": "portbench/configs/water10k.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "water10k.view720", "config": "water10k",
                               "traffic": "view720", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "view.frames", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "view_ms",
                               "workloads": ["water10k.view720"]})
    for m in bench["end_to_end"]:
        if "water100k.view" in m.get("workloads", []):
            m["workloads"].append("water10k.view720")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(R, "ROOT", tmp_path)
    monkeypatch.setattr(R, "HERE", here)

    files = R.cell_files("water10k.view720")
    assert files["config"]["n_waters"] == 3334
    assert (files["traffic"]["kind"], files["traffic"]["width"]) == ("view", 1280)
    assert files["limits"] == {"pick_mismatch": 0.5}
    assert [m["name"] for m in files["per_layer"]] == ["view.frames"]
    assert {m["name"] for m in files["end_to_end"]} == {"view_ms", "view_ms_p95", "setup_s"}
    run = R.Run(cfg, mix, None, {"frames": 7}, None, {}, {})
    assert R.metric_reader("view.frames")(run) == 7
    # the cells already there read the same files as before
    old = R.cell_files("water100k.view")
    assert old["traffic"]["width"] == 1920 and "view.frames" not in [
        m["name"] for m in old["per_layer"]]


def test_every_named_file_exists():
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        files = R.cell_files(w["name"], bench)
        assert files["limits"] and files["per_layer"] and files["end_to_end"]
        for m in files["per_layer"]:
            assert callable(R.metric_reader(m["name"]))
