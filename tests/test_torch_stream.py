"""The analysis path with its input read from files, on the CPU device:
viamd_tpu_torch streamed and staged against each other and against
viamd_tpu (JAX, CPU) over the same .xtc.

The system is a 100-water box (300 atoms, a 14.4 Å cube), 24 frames
written as precision-1000 XTC by the port's writer (the JAX writer's
bytes, tests/test_torch_io.py). Its RDF takes the dense route in both
packages, its SDF the dense route.

Tolerances:
- streamed against staged, and either against a resumed run's temporal
  values and RDF counts: exact (the same coordinates reach the same
  `frame_fn` in the same order; counts are integers in float32);
- a resumed run's SDF grid: 4e-6 relative per voxel (the float32 sums of
  the chunk sums in another grouping);
- against the JAX Evaluator: r bin for bin, v rtol 1e-4 + atol 1e-5 · max
  (the float32 Kabsch and splat, summed over frames), shape weights atol
  1e-5 (tests/test_torch_slice.py's);
- `import` and checkpoints: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import port_system
from viamd_tpu_torch.datagen import water_box
from viamd_tpu_torch.eval import (
    Evaluator,
    evaluate,
    load_checkpoint,
    merge_results,
    save_checkpoint,
)
from viamd_tpu_torch.io import load_file
from viamd_tpu_torch.io.trajectory import CachedTrajectory, DeviceTrajectory
from viamd_tpu_torch.io.xtc import XTCTrajectory, write_xtc
from viamd_tpu_torch.script import compile_script

SCRIPT = (
    "r = rdf(element('O'), element('O'), 6.0);\n"
    "v = sdf(residue(1:8), element('H'), 4.0);\n"
    "{lin, plan, iso} = shape_weights(all);\n"
    "d = distance(1, 4);\n"
)
N_FRAMES, CHUNK = 24, 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    sys_, traj = water_box(100, n_frames=N_FRAMES, seed=11)
    xtc = str(d / "box.xtc")
    write_xtc(xtc, traj.load_frames(range(N_FRAMES))[0], sys_.cell)
    return sys_, xtc


@pytest.fixture(scope="module")
def runs(files):
    """The staged run and the streamed ones (from the .xtc, its sidecar,
    an LRU over the .xtc), all on the CPU device."""
    sys_, xtc = files
    cs = compile_script(SCRIPT, sys_, "cpu")
    raw = XTCTrajectory(xtc)
    packed = load_file(xtc, system=sys_).trajectory
    staged = Evaluator(cs, DeviceTrajectory.stage(raw, "cpu"), chunk=CHUNK).run()
    streamed = {
        "xtc": Evaluator(cs, raw, chunk=CHUNK).run(),
        "vtraj": Evaluator(cs, packed, chunk=CHUNK).run(),
        "cached": Evaluator(cs, CachedTrajectory(raw), chunk=CHUNK).run(),
    }
    return cs, raw, packed, staged, streamed


def _equal(a, b):
    for field in ("temporal", "distributions", "volumes"):
        da, db = getattr(a, field), getattr(b, field)
        assert set(da) == set(db), field
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=f"{field} {k}")


@pytest.mark.parametrize("source", ["xtc", "vtraj", "cached"])
def test_streamed_equals_staged(runs, source):
    cs, _, packed, staged, streamed = runs
    assert type(packed).__name__ == "PackedTrajectory"
    assert cs.routes == ["rdf:dense", "sdf:dense"]
    got = streamed[source]
    _equal(got, staged)
    np.testing.assert_array_equal(got.frame_indices, np.arange(N_FRAMES))
    np.testing.assert_array_equal(got.times, staged.times)
    assert got.frame_mask.popcount() == N_FRAMES and not got.interrupted
    assert got.fingerprint != staged.fingerprint


def test_streamed_frame_range(runs):
    """A scattered frame range streams its frames in the order given."""
    cs, raw, _, _, _ = runs
    frames = [17, 3, 4, 22, 0, 9, 8]
    staged = Evaluator(cs, DeviceTrajectory.stage(raw, "cpu"), chunk=3).run(frames)
    streamed = Evaluator(cs, raw, chunk=3).run(frames)
    _equal(streamed, staged)
    np.testing.assert_array_equal(streamed.frame_indices, frames)


def test_matches_jax(files, runs):
    """The JAX Evaluator over the same file through the JAX loader."""
    from viamd_tpu.datagen import water_box as j_water_box
    from viamd_tpu.eval import Evaluator as JEvaluator
    from viamd_tpu.io import load_file as j_load
    from viamd_tpu.script import compile_script as j_compile

    sys_, xtc = files
    _, _, _, _, streamed = runs
    sys_j, _ = j_water_box(100, n_frames=1, seed=11)
    np.testing.assert_array_equal(port_system(sys_j).coords(), sys_.coords())
    traj_j = j_load(xtc, system=sys_j, cache=False).trajectory
    rj = JEvaluator(j_compile(SCRIPT, sys_j), traj_j, chunk=CHUNK, batch_mode="map").run()
    rt = streamed["xtc"]
    np.testing.assert_array_equal(rt.distributions["r"], np.asarray(rj.distributions["r"]))
    vj = np.asarray(rj.volumes["v"])
    np.testing.assert_allclose(rt.volumes["v"], vj, rtol=1e-4, atol=1e-5 * np.abs(vj).max())
    for k in ("lin", "plan", "iso", "d"):
        np.testing.assert_allclose(rt.temporal[k], np.asarray(rj.temporal[k]).reshape(-1, 1),
                                   atol=1e-5, err_msg=k)


def test_progress_interrupt_resume(runs, tmp_path):
    """TestCheckpointResume: progress after each chunk; an interrupt after
    two chunks, checkpointed, loaded and resumed, gives the uninterrupted
    run (temporal values and counts exactly, the SDF grid within 4e-6)."""
    cs, raw, _, _, streamed = runs
    ev = Evaluator(cs, raw, chunk=CHUNK)
    seen = []
    part = ev.run(progress=seen.append, interrupt=lambda: len(seen) >= 2)
    assert seen == [5 / 24, 10 / 24]
    assert part.interrupted and part.n_frames_done == 10
    assert part.frame_mask.popcount() == 10 and part.temporal["d"].shape == (10, 1)
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(part, p)
    loaded = load_checkpoint(p)
    assert loaded.n_frames_done == 10 and loaded.frame_mask.popcount() == 10
    seen.clear()
    full = ev.run(resume_from=loaded, progress=seen.append)
    assert seen[-1] == 1.0 and len(seen) == 3  # 14 frames left: 3 chunks
    ref = streamed["xtc"]
    assert full.n_frames_done == N_FRAMES and full.frame_mask.popcount() == N_FRAMES
    assert not full.interrupted
    np.testing.assert_array_equal(full.frame_indices, ref.frame_indices)
    np.testing.assert_array_equal(full.times, ref.times)
    for k in ref.temporal:
        np.testing.assert_array_equal(full.temporal[k], ref.temporal[k], err_msg=k)
    np.testing.assert_array_equal(full.distributions["r"], ref.distributions["r"])
    np.testing.assert_allclose(full.volumes["v"], ref.volumes["v"], rtol=4e-6, atol=0)
    # evaluate() is the one-shot form, with the same interrupt
    one = evaluate(cs, raw, chunk=CHUNK, interrupt=lambda: True)
    assert one.interrupted and one.n_frames_done == 0 and one.temporal == {}


def test_merge_order(runs):
    """merge_results sums accumulators as `b + a` and sorts rows by frame."""
    cs, raw, _, _, _ = runs
    ev = Evaluator(cs, raw, chunk=CHUNK)
    a, b = ev.run([7, 1, 2]), ev.run([0, 9])
    m = merge_results(a, b)
    np.testing.assert_array_equal(m.frame_indices, [0, 1, 2, 7, 9])
    np.testing.assert_array_equal(
        m.volumes["v"], b.volumes["v"] + a.volumes["v"])
    np.testing.assert_array_equal(
        m.temporal["d"], np.concatenate([a.temporal["d"], b.temporal["d"]])[[3, 1, 2, 0, 4]])
    assert m.n_frames_done == 5 and m.frame_mask.indices().tolist() == [0, 1, 2, 7, 9]


def test_checkpoints_interchange(files, runs, tmp_path):
    """A checkpoint the port saves loads in viamd_tpu.eval.engine and one
    the JAX package saves loads in the port, with equal arrays and
    property metadata; a resume of either finishes the run."""
    from viamd_tpu.eval.engine import Evaluator as JEvaluator
    from viamd_tpu.eval.engine import load_checkpoint as j_load_ckpt
    from viamd_tpu.eval.engine import save_checkpoint as j_save_ckpt
    from viamd_tpu.datagen import water_box as j_water_box
    from viamd_tpu.io import load_file as j_load
    from viamd_tpu.script import compile_script as j_compile

    sys_, xtc = files
    cs, raw, _, _, streamed = runs
    part = Evaluator(cs, raw, chunk=CHUNK).run(range(0, N_FRAMES, 2))
    pt = str(tmp_path / "port.npz")
    save_checkpoint(part, pt)
    in_jax = j_load_ckpt(pt)
    sys_j, _ = j_water_box(100, n_frames=1, seed=11)
    traj_j = j_load(xtc, system=sys_j, cache=False).trajectory
    cj = j_compile(SCRIPT, sys_j)
    jpart = JEvaluator(cj, traj_j, chunk=CHUNK, batch_mode="map").run(range(0, N_FRAMES, 2))
    pj = str(tmp_path / "jax.npz")
    j_save_ckpt(jpart, pj)
    in_port = load_checkpoint(pj)
    for got, want in ((in_jax, part), (in_port, jpart)):
        assert got.n_frames_done == want.n_frames_done == N_FRAMES // 2
        assert got.frame_mask.indices().tolist() == list(range(0, N_FRAMES, 2))
        np.testing.assert_array_equal(got.frame_indices, want.frame_indices)
        np.testing.assert_array_equal(got.times, want.times)
        for field in ("temporal", "distributions", "volumes"):
            g, w = getattr(got, field), getattr(want, field)
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]).reshape(g[k].shape))
        key = lambda p: (p.name, p.kind, p.dim, p.unit)  # noqa: E731
        assert list(map(key, got.properties)) == list(map(key, want.properties))
        for pg, pw in zip(got.properties, want.properties):
            assert (pg.spec is None) == (pw.spec is None)
            if pg.spec is not None:
                for f in ("kind", "nbins", "r_min", "r_max", "x_unit", "count_a",
                          "count_b", "n_structures", "extent"):
                    assert getattr(pg.spec, f) == getattr(pw.spec, f), f
                assert tuple(np.ravel(pg.spec.dims)) == tuple(np.ravel(pw.spec.dims))
    full = Evaluator(cs, raw, chunk=CHUNK).run(resume_from=in_port)
    assert full.frame_mask.popcount() == N_FRAMES and full.n_frames_done == N_FRAMES
    ref = streamed["xtc"]
    np.testing.assert_array_equal(full.distributions["r"], ref.distributions["r"])
    vref = ref.volumes["v"]
    np.testing.assert_allclose(full.volumes["v"], vref, rtol=1e-4, atol=1e-5 * np.abs(vref).max())
    for k in ("lin", "plan", "iso", "d"):
        np.testing.assert_allclose(full.temporal[k], ref.temporal[k], atol=1e-5, err_msg=k)


def _reference_downsample(src_bins, num_dst, src_weights=None):
    """TestWeightedRebin's transcription of the reference's C loop."""
    num_src = len(src_bins)
    factor = max(1, num_src // num_dst)
    dst = np.zeros(num_dst, np.float64)
    for j in range(num_dst):
        b = w = 0.0
        for i in range(factor):
            si = j * factor + i
            b += float(src_bins[si])
            w += float(src_weights[si]) if src_weights is not None else 1.0
        dst[j] = b / w if w else 0.0
    return dst.astype(np.float32)


def test_derived_views(runs):
    """aggregate, histogram and rebin (with and without weights) per
    TestWeightedRebin, against the JAX EvalResult's methods on the same
    arrays."""
    from viamd_tpu.eval.engine import EvalResult as JEvalResult

    _, _, _, _, streamed = runs
    res = streamed["xtc"]
    j = JEvalResult(frame_indices=res.frame_indices, times=res.times,
                    frame_mask=None, properties=res.properties)
    j._temporal_np, j._dist_np, j._vol_np = res.temporal, res.distributions, res.volumes
    for k in ("d", "lin"):
        got, want = res.aggregate(k), j.aggregate(k)
        for s in ("mean", "var", "min", "max"):
            np.testing.assert_array_equal(got[s], want[s])
        for rng in (None, (0.0, 1.0)):
            h, e = res.histogram(k, bins=16, vrange=rng)
            hj, ej = j.histogram(k, bins=16, vrange=rng)
            np.testing.assert_array_equal(h, hj)
            np.testing.assert_array_equal(e, ej)
    src = res.distributions["r"]
    np.testing.assert_allclose(res.rebin("r", 32), _reference_downsample(src, 32), rtol=1e-6)
    w = np.random.RandomState(3).uniform(0.5, 4.0, src.shape[0]).astype(np.float32)
    w[5:9] = 0.0  # zero-weight bins divide to 0, not inf
    res.set_distribution_weights("r", w)
    j.set_distribution_weights("r", w)
    np.testing.assert_allclose(res.rebin("r", 16), _reference_downsample(src, 16, w), rtol=1e-6)
    np.testing.assert_array_equal(res.rebin("r", 16), j.rebin("r", 16))
    with pytest.raises(KeyError):
        res.set_distribution_weights("nope", w)
    with pytest.raises(ValueError):
        res.rebin("r", 4096)


@pytest.mark.parametrize("fmt", ["xvg", "csv", "edr"])
def test_import(files, tmp_path, fmt):
    """`import` of a table holds its columns, as the JAX compiler's value."""
    from viamd_tpu.datagen import water_box as j_water_box
    from viamd_tpu.io.csv import write_csv
    from viamd_tpu.io.edr import write_edr
    from viamd_tpu.io.xvg import write_xvg
    from viamd_tpu.script import compile_script as j_compile

    sys_, _ = files
    t = np.arange(30) * 0.5
    cols = np.stack([t, np.sin(t) * 10.0, 300.0 + t])
    p = str(tmp_path / f"table.{fmt}")
    if fmt == "xvg":
        write_xvg(p, cols, legends=["a", "b"])
    elif fmt == "csv":
        write_csv(p, cols, header=["t", "a", "b"])
    else:
        write_edr(p, ["a", "b"], t, cols[1:].T)
    src = f'e = import("{p}");\nn = count(element("O"));\n'
    sys_j, _ = j_water_box(100, n_frames=1, seed=11)
    cj, ct = j_compile(src, sys_j), compile_script(src, sys_, "cpu")
    basis = np.asarray(sys_j.cell.basis, np.float32)
    inv = np.asarray(sys_j.cell.inv_basis, np.float32)
    x0 = sys_.coords()
    tj, _ = cj.frame_fn(jnp.asarray(x0), jnp.asarray(basis), jnp.asarray(inv))
    tt, _ = ct.frame_fn(*(torch.as_tensor(a) for a in (x0, basis, inv)))
    want = np.asarray(tj["e"]).reshape(-1)
    np.testing.assert_array_equal(tt["e"].numpy(), want)
    assert want.size == cols.size
    assert ct.property("e").dim == cj.property("e").dim == cols.size
