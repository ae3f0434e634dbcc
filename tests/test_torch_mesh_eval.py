"""Sharded evaluation of the port — `Evaluator(mesh=)`, `compile_script(
atom_shard=)`, `Session.evaluate(mesh=)` — on CPU ranks (gloo, world 2
and 4, `parallel.launch.spawn`), against the one-rank port and the JAX
package's sharded evaluation (conftest's 8 virtual devices).

The JAX package is imported inside the parity tests only, so the tests
marked `requires_cuda` collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_mesh_eval.py

Tolerances. Against the one-rank port: temporal rows, frame indices, masks
and progress reports identical (each frame is computed alone, and the rows
are gathered, not summed); accumulators within the float32 reassociation
bound of their frame sums, |a − b| <= n_frames · 2⁻²⁴ · |b| per element
(their terms are not negative), and identical where the histogram's counts
are integers below 2²⁴ (r). Against the JAX package: r within 1 count a
bin and equal totals on the dense route (tests/test_torch_rdf.py), within
2 counts + 1e-3 relative on the cell list (tests/test_torch_slice.py: its
CPU cell list drops atoms past its capacities); v rtol 1e-4, atol 1e-5 ·
max; d1, lin, plan, iso atol 1e-5; a1 (degrees) atol 1e-3.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.parallel import programs
from viamd_tpu_torch.parallel.launch import spawn

TP_SCRIPT = "r = rdf(element('O'), element('O'), 6.0);\n"
# flagship runs: (kwargs of programs.evaluate) over water_box(32, 7, seed 1)
FLAGSHIP_RUNS = {
    "staged": dict(chunk=4),
    "streamed": dict(chunk=4, staged=False, frame_range=[6, 0, 2, 3, 5], stop_after=1,
                     resume=True),
    "session": dict(chunk=2, session=True),
    "triclinic": dict(chunk=4, triclinic=True),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread here, as in the ranks: the walks are many small
    ops, and with the cores shared several threads an op only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _flagship_calls(runs):
    return [(programs.evaluate, (programs.FLAGSHIP, 32, 7, 1), kw) for kw in runs.values()]


@pytest.fixture(scope="module")
def flagship_on_ranks():
    """2 CPU ranks: each flagship run, then the JAX modules they loaded."""
    calls = _flagship_calls(FLAGSHIP_RUNS) + [(programs.reference_modules, (), {})]
    return spawn(programs.sequence, 2, "cpu", *calls, timeout=180)


@pytest.fixture(scope="module")
def tp_on_ranks():
    """4 CPU ranks as a 2 × 2 frames × atoms mesh: dp × tp on
    water_box(1500) (3 frames: one frames rank gets 2, the other 1), the
    flagship on the 2D mesh without atom_shard (5 frames), an atom_shard
    script given other meshes, the JAX modules."""
    return spawn(programs.sequence, 4, "cpu",
                 (programs.evaluate, (TP_SCRIPT, 1500, 3, 2),
                  dict(chunk=4, atoms=2, atom_shard=("atoms", 2))),
                 (programs.evaluate, (programs.FLAGSHIP, 32, 5, 1), dict(chunk=2, atoms=2)),
                 (programs.atom_shard_mesh_errors, (), {}),
                 (programs.reference_modules, (), {}),
                 timeout=180)


def _assert_same_run(got: dict, want: dict, n_frames: int):
    """A sharded run against the one-rank run (module docstring)."""
    np.testing.assert_array_equal(got["frame_indices"], want["frame_indices"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert (got["n_frames_done"], got["interrupted"]) == (want["n_frames_done"],
                                                         want["interrupted"])
    assert got["progress"] == want["progress"]
    assert got["temporal"].keys() == want["temporal"].keys()
    for k, v in want["temporal"].items():
        assert got["temporal"][k].tobytes() == v.tobytes(), k  # −0 keeps its sign
    for kind in ("distributions", "volumes"):
        assert got[kind].keys() == want[kind].keys()
        for k, v in want[kind].items():
            assert (v >= 0).all()
            assert (np.abs(got[kind][k] - v) <= n_frames * 2.0**-24 * np.abs(v)).all(), k
    if "r" in want["distributions"]:
        np.testing.assert_array_equal(got["distributions"]["r"], want["distributions"]["r"])


@pytest.mark.parametrize("run", list(FLAGSHIP_RUNS))
def test_frames_sharded_equals_one_rank(flagship_on_ranks, run):
    i = list(FLAGSHIP_RUNS).index(run)
    kw = FLAGSHIP_RUNS[run]
    want = programs.evaluate(programs.FLAGSHIP, 32, 7, 1, device="cpu", **kw)
    for rank in flagship_on_ranks:
        _assert_same_run(rank[i], want, 7)
    r0, r1 = flagship_on_ranks[0][i], flagship_on_ranks[1][i]
    # interrupt() is asked on the mesh's first rank only, each chunk step
    assert r1["asked"] == 0 and r0["asked"] == want["asked"]
    if run == "streamed":
        assert want["interrupted"] is False and want["n_frames_done"] == 5
        np.testing.assert_array_equal(want["frame_indices"], [0, 2, 3, 5, 6])
        assert want["progress"] == [0.8, 1.0]


def test_frames_sharded_matches_jax(flagship_on_ranks):
    import __graft_entry__ as g
    from viamd_tpu.eval import evaluate as j_evaluate
    from viamd_tpu.parallel import frames_mesh as j_frames_mesh

    from viamd_tpu_torch.datagen import water_box

    cs, _sys, traj = g._flagship(n_waters=32, n_frames=7)
    ours = water_box(32, n_frames=7, seed=1)[1]
    np.testing.assert_array_equal(ours.load_frames(range(7))[0], traj.load_frames(range(7))[0])
    want = j_evaluate(cs, traj, chunk=4, mesh=j_frames_mesh(2))
    got = flagship_on_ranks[0][0]
    for k, atol in (("d1", 1e-5), ("a1", 1e-3), ("lin", 1e-5), ("plan", 1e-5), ("iso", 1e-5)):
        np.testing.assert_allclose(got["temporal"][k], want.temporal[k], rtol=0, atol=atol)
    r_got, r_want = got["distributions"]["r"], np.asarray(want.distributions["r"])
    assert r_got.sum() == r_want.sum() > 0
    assert np.abs(r_got - r_want).max() <= 1
    v_want = np.asarray(want.volumes["v"])
    np.testing.assert_allclose(got["volumes"]["v"], v_want, rtol=1e-4,
                               atol=1e-5 * np.abs(v_want).max())


def test_dp_tp_equals_one_rank(tp_on_ranks):
    want_tp = programs.evaluate(TP_SCRIPT, 1500, 3, 2, chunk=4, device="cpu")
    # chunk 2 on 4 ranks becomes 4 (a multiple of the mesh's ranks)
    want_2d = programs.evaluate(programs.FLAGSHIP, 32, 5, 1, chunk=4, device="cpu")
    for rank in tp_on_ranks:
        assert rank[0]["routes"] == ["rdf:cell_list"]
        _assert_same_run(rank[0], want_tp, 3)
        _assert_same_run(rank[1], want_2d, 5)
    # collectives of a rank: a sum of the row partials over the atoms axis
    # for the compile's own walk and for each of its frames (frames ranks
    # 0 / 1 evaluated 2 / 1), the interrupt broadcast of the one chunk step,
    # the gather of the rows and the sum of r over the frames axis
    coll = {tuple(r[0]["coords"].values()): r[0]["collectives"] for r in tp_on_ranks}
    assert coll == {(0, 0): 1 + 2 + 1 + 2, (0, 1): 1 + 2 + 1 + 2, (1, 0): 1 + 1 + 1 + 2,
                    (1, 1): 1 + 1 + 1 + 2}, coll


def test_dp_tp_matches_jax(tp_on_ranks, monkeypatch):
    from viamd_tpu.datagen import water_box as j_water_box
    from viamd_tpu.eval import evaluate as j_evaluate
    from viamd_tpu.parallel import frames_mesh as j_frames_mesh
    from viamd_tpu.script import compile_script as j_compile

    monkeypatch.setenv("VIAMD_TPU_PALLAS_INTERPRET", "1")
    sys_j, traj_j = j_water_box(1500, n_frames=3, seed=2)
    cs = j_compile(TP_SCRIPT, sys_j, atom_shard=("atoms", 2))
    want = np.asarray(j_evaluate(cs, traj_j, chunk=4,
                                 mesh=j_frames_mesh(4, atoms=2)).distributions["r"])
    got = tp_on_ranks[0][0]["distributions"]["r"]
    assert abs(got.sum() - want.sum()) <= 1e-3 * want.sum()
    assert (np.abs(got - want) <= 2 + 1e-3 * np.abs(want)).all()


def test_atom_shard_needs_its_compile_mesh(tp_on_ranks):
    """A script compiled with atom_shard on the 2 × 2 mesh and evaluated on
    the 4-rank frames mesh would sum the rows of different frames over its
    old atoms line: the Evaluator refuses it on every rank, and refuses the
    shard axis as the frames axis."""
    for rank in tp_on_ranks:
        errors = rank[2]
        assert len(errors) == 2, errors
        assert "compiled with atom_shard on the mesh" in errors[0]
        assert "'frames': 2, 'atoms': 2" in errors[0] and "{'frames': 4}" in errors[0]
        assert "is the frames axis" in errors[1]


def test_ranks_import_no_jax(flagship_on_ranks, tp_on_ranks):
    assert [r[-1] for r in flagship_on_ranks + tp_on_ranks] == [[]] * 6


def test_atom_shard_needs_its_mesh():
    from viamd_tpu_torch.datagen import water_box
    from viamd_tpu_torch.script import ScriptError, compile_script

    sys, _ = water_box(32, n_frames=1)
    with pytest.raises(ScriptError, match="no device mesh"):
        compile_script(TP_SCRIPT, sys, "cpu", atom_shard=("atoms", 2))


@pytest.mark.requires_cuda
def test_frames_sharded_on_the_card(cuda):
    """2 ranks sharing the card (gloo) against one rank on it, staged and
    streamed."""
    runs = {k: FLAGSHIP_RUNS[k] for k in ("staged", "streamed")}
    out = spawn(programs.sequence, 2, "cuda", *_flagship_calls(runs), timeout=300)
    for i, kw in enumerate(runs.values()):
        want = programs.evaluate(programs.FLAGSHIP, 32, 7, 1, device=cuda, **kw)
        for rank in out:
            _assert_same_run(rank[i], want, 7)
