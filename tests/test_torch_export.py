"""The port's exports (viamd_tpu_torch/app/export.py) against viamd_tpu's;
the oracle is TestExports (tests/test_app.py) and
TestVolumeExport::test_export_cube_and_mhd.

Tolerances: none for the files. Cube, MetaImage (header, raw payload, xyz)
and image files are written by copies of the JAX package's writers, so
they are compared byte for byte; so are the CSV/XVG tables and structure
files, written from the same evaluated values (the two packages' float32
distances and histograms agree to the printed 6 significant digits on
these frames; the resampled histogram, a small float32 product on both
sides, too).
"""

import io
import types

import numpy as np
import pytest

from tests._torch_parity import port_system
from tests.conftest import make_ala_pdb
from viamd_tpu_torch.app import export as TE
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.script import compile_script


def _grid(seed=0, shape=(6, 5, 4)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 10 ** rng.uniform(-6, 2, shape)).astype(np.float32)


ATOMS = dict(atoms_z=np.array([8, 1, 1]),
             atoms_xyz=np.array([[0.0, 0.0, 0.1], [0.76, 0.58, 0.0], [-0.76, 0.58, 0.0]]))


@pytest.mark.parametrize("axes", [False, True])
@pytest.mark.parametrize("atoms", [False, True])
def test_cube_bytes_equal_and_read_back(tmp_path, axes, atoms):
    from viamd_tpu.app import export as JE

    g = _grid()
    kw = dict(origin=[-1.5, 0.25, 3.0], voxel=[0.5, 0.4, 0.3])
    if axes:
        R = np.linalg.qr(np.random.RandomState(1).randn(3, 3))[0]
        kw["axes"] = (R * np.array([0.5, 0.4, 0.3])[None, :]).T
    if atoms:
        kw.update(ATOMS)
    a, b = tmp_path / "port.cube", tmp_path / "jax.cube"
    TE.export_cube(str(a), g, **kw)
    JE.export_cube(str(b), g, **kw)
    assert a.read_bytes() == b.read_bytes()
    buf = io.StringIO()
    TE.export_cube(buf, g, comment="buffer", **kw)
    assert buf.getvalue().splitlines()[0] == "buffer"
    got, want = TE.read_cube(str(a)), JE.read_cube(str(b))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    if not axes:
        np.testing.assert_allclose(got[0], g, rtol=1e-4)  # TestExports::test_cube_roundtrip


@pytest.mark.parametrize("oriented", [False, True])
@pytest.mark.parametrize("atoms", [False, True])
def test_mhd_files_equal(tmp_path, oriented, atoms):
    from viamd_tpu.app import export as JE

    g = _grid(2, (7, 3, 5))
    kw = dict(origin=[0.1, -2.0, 1.0 / 3.0], voxel=[0.2, 0.25, 1.0 / 7.0])
    if oriented:
        kw["orientation"] = np.linalg.qr(np.random.RandomState(3).randn(3, 3))[0]
    if atoms:
        kw.update(ATOMS)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = TE.export_mhd(str(tmp_path / "p" / "vol.mhd"), g, **kw)
    want = JE.export_mhd(str(tmp_path / "j" / "vol.mhd"), g, **kw)
    assert len(got) == len(want) == (3 if atoms else 2)
    for x, y in zip(got, want):
        assert open(x, "rb").read() == open(y, "rb").read()


def _results(src: str, n_res: int = 6, n_models: int = 10):
    """(JAX EvalResult, port EvalResult, JAX system, port system, frames)
    of `src` over the poly-alanine fixture."""
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io.pdb import parse_pdb
    from viamd_tpu.script import compile_script as j_compile

    sys_j, traj = parse_pdb(make_ala_pdb(n_res, n_models=n_models))
    frames, cells = traj.load_frames(list(range(traj.num_frames)))
    rj = JEvaluator(j_compile(src, sys_j), traj, chunk=4).run()
    sys_t = port_system(sys_j)
    rt = Evaluator(compile_script(src, sys_t, "cpu"),
                   trajectory_from_numpy(frames, cells, "cpu"), chunk=4).run()
    return rj, rt, sys_j, sys_t, frames


def test_temporal_and_distribution_tables():
    """The port's tables of its own evaluation hold the JAX package's values
    within float32 rounding (distances, angles: rtol 1e-5 as printed); fed
    the JAX result's values, its writers print the same bytes."""
    from viamd_tpu.app import export as JE

    rj, rt, *_ = _results(
        "d1 = distance(1, 6);\na1 = angle(1, 2, 3) in residue(1:3);\n"
        "r = rdf(element('C'), element('O'), 6.0);\n")
    # the default column order is the result's property order: the
    # script's in the port, the JAX package's temporal outputs sorted by
    # name (a jit's dict outputs), so the names go in explicitly
    names = ["d1", "a1"]

    def tables(res, ex):
        out = {}
        for fn in ("export_temporal_csv", "export_temporal_xvg"):
            out[fn] = io.StringIO()
            getattr(ex, fn)(res, out[fn], names=names)
        for bins, volume in ((None, 0.0), (16, 0.0), (40, 64000.0)):
            out[bins] = io.StringIO()
            ex.export_distribution_csv(res, out[bins], "r", bins=bins, volume=volume)
        return {k: v.getvalue() for k, v in out.items()}

    want = tables(rj, JE)
    got = tables(rt, TE)
    for k in want:
        assert got[k].splitlines()[0] == want[k].splitlines()[0], k
    default = io.StringIO()
    TE.export_temporal_csv(rt, default)
    assert default.getvalue() == got["export_temporal_csv"]
    assert got["export_temporal_csv"].splitlines()[0] == "time,d1,a1[1],a1[2],a1[3]"
    for k in ("export_temporal_csv", None, 16, 40):
        a = np.array([[float(t) for t in ln.split(",")] for ln in got[k].splitlines()[1:]])
        b = np.array([[float(t) for t in ln.split(",")] for ln in want[k].splitlines()[1:]])
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=str(k))
    # the writers, fed the JAX result's values (g(r), the volume case, is
    # each package's own float32 normalization: held above to 1e-5)
    rt._temporal_np = {k: np.array(v) for k, v in rj.temporal.items()}
    rt._dist_np = {k: np.array(v) for k, v in rj.distributions.items()}
    fed = tables(rt, TE)
    assert {k: v for k, v in fed.items() if k != 40} == \
        {k: v for k, v in want.items() if k != 40}


def _session(sys_, frames, traj):
    return types.SimpleNamespace(
        system=sys_, stored_selections={}, trajectory=traj, num_frames=len(frames),
        current_coords=lambda: frames[0],
    )


@pytest.mark.parametrize("path,filt,frames_arg", [
    ("sub.pdb", "element('C')", "current"),
    ("sub.xyz", "all", [0, 2]),
    ("all.pdb", "residue(2:3)", "all"),
])
def test_structure_export_equal(tmp_path, path, filt, frames_arg):
    from viamd_tpu.app import export as JE
    from viamd_tpu.io.pdb import parse_pdb
    from viamd_tpu.io.trajectory import InMemoryTrajectory as JTraj
    from viamd_tpu_torch.io.trajectory import InMemoryTrajectory as TTraj

    sys_j, traj = parse_pdb(make_ala_pdb(6, n_models=4))
    frames, cells = traj.load_frames(list(range(traj.num_frames)))
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    TE.export_structure(_session(port_system(sys_j), frames, TTraj(frames)),
                        str(tmp_path / "p" / path), filt, frames=frames_arg, device="cpu")
    JE.export_structure(_session(sys_j, frames, JTraj(frames)), str(tmp_path / "j" / path),
                        filt, frames=frames_arg)
    got = (tmp_path / "p" / path).read_bytes()
    assert got == (tmp_path / "j" / path).read_bytes()
    if path == "sub.pdb":
        from viamd_tpu_torch.io.pdb import parse_pdb as t_parse

        assert t_parse(got.decode())[0].natoms == 18  # TestExports::test_structure_export


def test_image_files_equal(tmp_path):
    pytest.importorskip("PIL")
    from viamd_tpu.app import export as JE

    img = np.random.RandomState(0).rand(16, 12, 4).astype(np.float32)
    for name in ("t.png", "t.bmp"):
        TE.save_image(str(tmp_path / ("p" + name)), img)
        JE.save_image(str(tmp_path / ("j" + name)), img)
        assert (tmp_path / ("p" + name)).read_bytes() == (tmp_path / ("j" + name)).read_bytes()
    back = TE.load_image(str(tmp_path / "pt.png"))
    np.testing.assert_array_equal(back, JE.load_image(str(tmp_path / "jt.png")))
    np.testing.assert_allclose(back, img, atol=0.01)
