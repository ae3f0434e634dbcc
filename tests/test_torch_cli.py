"""The port's command line (viamd_tpu_torch/app/cli.py, `--device cpu`) and
browser viewer (app/viewer.py) against viamd_tpu's, on the same seeded
files. The oracles are tests/test_app.py TestCLI, TestMovieRendering::
test_movie_cli and TestViewer.

Tolerances.
- Exit codes, the `info` summary, the `.vtraj` bytes, PNG bytes of the
  same pixels, CSV headers and frame counts: exact. Evaluated values: 1e-4 absolute (printed with the
  CSV writer's digits on both sides).
- Images (8-bit PNG): the frames are tests/test_torch_session.py's renders
  written by both packages: at most 1% of pixels differ by more than
  3/255 in a channel (a silhouette pixel that one rounding flips), the
  rest within 3/255 (the raster's rgb differences of tests/
  test_torch_render.py, quantized to 8 bits).
- Cube files: the volume within 1e-3 of its largest voxel (the sdf's bound
  in tests/test_torch_session.py), the header lines equal.
- The viewer: the same endpoints answer with the same keys and types, the
  PNGs decode to the requested size, and each interaction changes the
  session as the JAX viewer's does.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.conftest import make_ala_pdb
from viamd_tpu_torch.app import cli


def _ala(tmp_path, n_res=4, n_models=5, name="a.pdb"):
    p = tmp_path / name
    p.write_text(make_ala_pdb(n_res, n_models=n_models))
    return str(p)


def _both(argv_p, argv_j):
    from viamd_tpu.app import cli as jcli

    return cli.main(argv_p + ["--device", "cpu"]), jcli.main(argv_j)


def _images_close(got, want, share=0.01, tol=3 / 255 + 1e-6):
    assert got.shape == want.shape
    err = np.abs(got - want).max(-1)
    assert (err > tol).mean() <= share, (err > tol).mean()


def test_parser_adds_only_device():
    """The same subcommands and flags as the JAX CLI, plus --device."""
    from viamd_tpu.app import cli as jcli

    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {name: sorted(opt for act in p._actions for opt in act.option_strings)
                for name, p in sub.choices.items()}

    got, want = flags(cli.build_parser()), flags(jcli.build_parser())
    assert got.keys() == want.keys()
    for name in want:
        assert sorted(set(got[name]) - {"--device"}) == want[name], name
    args = cli.build_parser().parse_args(["render", "x.pdb"])
    assert args.device == "cuda"


def test_info_and_errors(tmp_path, capsys):
    """TestCLI::test_info; a missing file exits 1 in both."""
    p = _ala(tmp_path, 3, 1)
    assert cli.main(["info", p, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    from viamd_tpu.app import cli as jcli

    assert jcli.main(["info", p]) == 0
    assert got == json.loads(capsys.readouterr().out)
    assert got["atoms"] == 15
    assert _both(["info", str(tmp_path / "none.pdb")], ["info", str(tmp_path / "none.pdb")]) \
        == (1, 1)
    bad = str(tmp_path / "m.png")
    assert _both(["movie", p, "-o", bad], ["movie", p, "-o", bad]) == (1, 1)


def test_eval_csv(tmp_path):
    """TestCLI::test_eval_csv, with a distribution and --frames."""
    from viamd_tpu_torch.io.csv import read_csv

    p = _ala(tmp_path)
    script = "d1 = distance(1, 6);\nr = rdf(element('C'), element('O'), 6.0);"
    outs = {}
    for tag in ("p", "j"):
        outs[tag] = str(tmp_path / f"{tag}.csv")
    rc = _both(["eval", p, "-s", script, "-o", outs["p"], "-q", "--frames", "1:5"],
               ["eval", p, "-s", script, "-o", outs["j"], "-q", "--frames", "1:5"])
    assert rc == (0, 0)
    (cp, hp), (cj, hj) = read_csv(outs["p"]), read_csv(outs["j"])
    assert hp == hj == ["time", "d1"] and cp.shape == cj.shape == (2, 4)
    np.testing.assert_allclose(cp, cj, atol=1e-4)
    (dp, dhp), (dj, dhj) = (read_csv(o.replace(".csv", ".r.csv")) for o in outs.values())
    assert dhp == dhj
    np.testing.assert_allclose(dp, dj, atol=1e-4, rtol=1e-3)
    xp, xj = (str(tmp_path / f"{t}.xvg") for t in "pj")
    assert _both(["eval", p, "-s", "d1 = distance(1, 6);", "-o", xp, "-q", "--xvg"],
                 ["eval", p, "-s", "d1 = distance(1, 6);", "-o", xj, "-q", "--xvg"]) == (0, 0)
    assert open(xp).read().splitlines()[:8] == open(xj).read().splitlines()[:8]


def test_render_png(tmp_path):
    """TestCLI::test_render_png, raw and postprocessed."""
    from viamd_tpu_torch.app.export import load_image

    p = _ala(tmp_path)
    for extra in ([], ["--postprocess"], ["--rep", "licorice", "--frame", "2.5"]):
        op, oj = str(tmp_path / "p.png"), str(tmp_path / "j.png")
        base = ["render", p, "--width", "64", "--height", "48"] + extra
        assert _both(base + ["-o", op], base + ["-o", oj]) == (0, 0)
        got, want = load_image(op), load_image(oj)
        assert got.shape == (48, 64, 4) and got[..., :3].sum() > 0
        _images_close(got, want)


@pytest.mark.parametrize("shape", [(300, 257, 4), (64, 48, 3), (1, 5, 4)])
def test_png_bytes_equal_jax(tmp_path, shape):
    """app/export.py::save_image writes every PNG with `encode_png`, which
    needs no imaging library: the JAX package's bytes (PIL's writer), here
    over several IDAT chunks, RGB and a single row, rows that take each of
    the adaptive filters."""
    from viamd_tpu.app import export as JE
    from viamd_tpu_torch.app import export as TE

    rng = np.random.RandomState(5)
    img = rng.rand(*shape).astype(np.float32)
    h = shape[0]
    img[: h // 3] = np.round(img[: h // 3] * 4) / 4  # flat rows: Sub and Up win there
    img[h // 3: 2 * h // 3] = np.linspace(0, 1, shape[1])[None, :, None]
    op, oj = tmp_path / "p.png", tmp_path / "j.png"
    TE.save_image(str(op), img)
    JE.save_image(str(oj), img)
    assert op.read_bytes() == oj.read_bytes()
    if shape[0] == 300:
        assert op.read_bytes().count(b"IDAT") > 2


def test_movie_cli(tmp_path, monkeypatch):
    """TestMovieRendering::test_movie_cli, with TAA. The demo's 640 atoms
    at 64×64 overflow the JAX XLA engine's default tile capacity (64), so
    the JAX side gets 1,024 (the port has no capacity)."""
    import functools

    from viamd_tpu.render import raster as JR
    from viamd_tpu_torch.app.export import load_image

    monkeypatch.setattr(JR, "RasterSettings", functools.partial(JR.RasterSettings,
                                                                capacity=1024))

    for extra in ([], ["--taa"]):
        pp, pj = str(tmp_path / "p_%02d.png"), str(tmp_path / "j_%02d.png")
        base = ["movie", "demo", "--frames", "0:4", "--step", "2", "--width", "64",
                "--height", "64", "-q"] + extra
        assert _both(base + ["-o", pp], base + ["-o", pj]) == (0, 0)
        for k in (0, 1):
            got, want = load_image(pp % k), load_image(pj % k)
            _images_close(got, want, share=0.03 if extra else 0.01)
        assert not (tmp_path / "p_02.png").exists()


def test_transcode(tmp_path):
    """TestCLI::test_transcode: the same .vtraj bytes."""
    from viamd_tpu_torch.io.cache import PackedTrajectory

    p = _ala(tmp_path, 4, 6)
    op, oj = str(tmp_path / "p.vtraj"), str(tmp_path / "j.vtraj")
    assert _both(["transcode", p, "-o", op], ["transcode", p, "-o", oj]) == (0, 0)
    assert PackedTrajectory(op).num_frames == 6
    assert open(op, "rb").read() == open(oj, "rb").read()
    g = str(tmp_path / "x.gro")
    open(g, "w").write("t\n    1\n    1SOL     OW    1   0.000   0.000   0.000\n   1.0 1.0 1.0\n")
    assert _both(["transcode", g, "-o", op], ["transcode", g, "-o", oj]) == (1, 1)


def test_volume_and_workspace(tmp_path):
    """The volume subcommand's cube and image; a workspace saved by the JAX
    package, evaluated and rendered by both CLIs."""
    from viamd_tpu.app import Session as JSession
    from viamd_tpu_torch.app.export import load_image, read_cube

    p = _ala(tmp_path, 6, 4)
    script = "v = sdf(residue(1:4), element('H'), 4.0);"
    cp, cj = str(tmp_path / "p.cube"), str(tmp_path / "j.cube")
    ip, ij = str(tmp_path / "pv.png"), str(tmp_path / "jv.png")
    assert _both(["volume", p, "-s", script, "--cube", cp, "-o", ip, "--width", "48",
                  "--height", "48"],
                 ["volume", p, "-s", script, "--cube", cj, "-o", ij, "--width", "48",
                  "--height", "48"]) == (0, 0)
    gp, gj = read_cube(cp), read_cube(cj)
    np.testing.assert_allclose(gp[0], gj[0], atol=1e-3 * np.abs(gj[0]).max())
    assert open(cp).read().splitlines()[2:6] == open(cj).read().splitlines()[2:6]
    assert load_image(ip).shape == (48, 48, 4)
    s = JSession(num_workers=1)
    try:
        s.load(p)
        s.set_script("d1 = distance(1, 6);")
        s.add_representation(name="lico", filter="element('C')", type="licorice")
        ws = str(tmp_path / "w.via")
        s.save_workspace(ws)
    finally:
        s.shutdown()
    op, oj = str(tmp_path / "wp.png"), str(tmp_path / "wj.png")
    base = ["workspace", ws, "--eval", "--width", "64", "--height", "48"]
    assert _both(base + ["--render", op], base + ["--render", oj]) == (0, 0)
    _images_close(load_image(op), load_image(oj))


# -- the viewer -------------------------------------------------------------------------


@pytest.fixture
def viewers(tmp_path):
    """A port viewer and a JAX viewer, each over a session of its package on
    the same file, on ephemeral ports."""
    from viamd_tpu.app import Session as JSession
    from viamd_tpu.app.viewer import ViewerServer as JViewer
    from viamd_tpu_torch.app import Session
    from viamd_tpu_torch.app.viewer import ViewerServer

    p = _ala(tmp_path, 6, 10)
    sp, sj = Session(num_workers=1, device="cpu"), JSession(num_workers=1)
    for s in (sp, sj):
        s.load(p)
    vp, vj = ViewerServer(sp, port=0).serve(blocking=False), \
        JViewer(sj, port=0).serve(blocking=False)
    yield (vp, sp), (vj, sj)
    for v, s in ((vp, sp), (vj, sj)):
        v.close()
        s.shutdown()


def _client(viewer):
    base = f"http://127.0.0.1:{viewer.httpd.server_address[1]}"

    def get(path):
        return urllib.request.urlopen(base + path).read()

    def post(path, **data):
        req = urllib.request.Request(base + "/api/" + path, data=json.dumps(data).encode())
        return json.loads(urllib.request.urlopen(req).read())

    return get, post


def test_viewer_endpoints(viewers):
    """TestViewer::test_endpoints and test_full_interaction_sequence on both
    viewers side by side: the page, /api/state, /render, orbit, zoom,
    pick, rep, frame, script, eval, plots, select, volume and the rep
    manager."""
    (vp, sp), (vj, sj) = viewers
    (getp, postp), (getj, postj) = _client(vp), _client(vj)
    assert getp("/") == getj("/") and b"viamd-tpu" in getp("/")
    state_p, state_j = (json.loads(g("/api/state")) for g in (getp, getj))
    assert state_p == state_j and state_p["num_frames"] == 10
    png = getp("/render?w=128&h=96")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    import io

    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(png)))
    jimg = np.asarray(Image.open(io.BytesIO(getj("/render?w=128&h=96"))))
    assert img.shape == (96, 128, 4)
    _images_close(img / 255.0, jimg / 255.0)
    eye0 = np.asarray(sp.camera.eye).copy()
    for post in (postp, postj):
        assert post("orbit", dx=0.1, dy=0.05) == {}
        assert post("zoom", d=1) == {}
    assert not np.allclose(eye0, sp.camera.eye)
    np.testing.assert_allclose(sp.camera.eye, sj.camera.eye, atol=1e-4)
    _, _, pick = sp.render(128, 96)
    hits = np.argwhere(pick.numpy() >= 0)
    y, x = hits[len(hits) // 2]
    outs = [post("pick", x=(x + 0.5) / 128, y=(y + 0.5) / 96, w=128, h=96)
            for post in (postp, postj)]
    assert outs[0] == outs[1] and outs[0]["atom"] >= 0 and outs[0]["label"]
    assert sp.selection.popcount() == 1
    for post in (postp, postj):
        post("rep", type="licorice")
        post("frame", f=9.0)
    assert sp.representations[0].type == "licorice" and sp.frame == 9.0
    np.testing.assert_allclose(sp.current_coords(), sj.current_coords(), atol=1e-5)
    for post in (postp, postj):
        assert post("script", text="d1 = distance(1, 99999);")["errors"]
        assert post("script", text="d1 = distance(1, 6);\nv = sdf(residue(1:4), "
                                   "element('H'), 4.0);") == {"errors": []}
    ev_p, ev_j = postp("eval"), postj("eval")
    assert ev_p == ev_j and ev_p["properties"] == ["d1"] and ev_p["volume_props"] == ["v"]
    assert getp("/api/plot?prop=d1&kind=temporal")[:8] == b"\x89PNG\r\n\x1a\n"
    assert postp("select", query="element('C')") == postj("select", query="element('C')")
    assert postp("volume", prop="v") == postj("volume", prop="v")
    assert postp("volume", prop="nope")["error"]
    assert getp("/render?w=64&h=64")[:8] == b"\x89PNG\r\n\x1a\n"
    reps_p, reps_j = postp("rep_add"), postj("rep_add")
    assert reps_p == reps_j and len(reps_p["reps"]) == 2
    upd = dict(index=1, filter="element('N')", type="cartoon", alpha=0.5)
    assert postp("rep_update", **upd) == postj("rep_update", **upd)
    assert postp("rep_del", index=1) == postj("rep_del", index=1)
    for path, code in (("/api/qm_plot?kind=nope", 400), ("/nothing", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            getp(path)
        assert e.value.code == code
