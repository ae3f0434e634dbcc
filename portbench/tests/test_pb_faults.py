"""A run of each cell, here on the CPU at a small size with the look for a
card skipped, comes out correct on the sound program and not correct with
its timed path broken underneath: a step that returns its state unchanged,
half of the batch left out (the sums scaled up from the rest), an answer
altered where it is produced, and an evaluation served from a cache. (One
chip: no exchange between chips to leave out.)

The program's CPU route launches no hand-written kernel, so here an
Evaluator run stands in for a launch of the evaluate cell's kernels."""

import time

import pytest
import torch

from portbench import run as R

SEED = 2**31 + 4242


def small(workload):
    files = R.cell_files(workload)
    if workload == "water100k.view":
        files["config"].update(n_waters=1000, n_atoms=3000, n_frames=8)
        files["traffic"].update(width=192, height=108, min_frames=1, eval_chunk=4)
    else:
        files["config"].update(n_waters=3000, n_atoms=9000, n_frames=8)
        files["traffic"].update(chunk=4)
    return files


@pytest.fixture(autouse=True)
def evaluator_runs_count_as_launches(monkeypatch):
    from portbench import program
    from viamd_tpu_torch.eval.engine import Evaluator

    runs = [0]
    real = Evaluator.run

    def run(self, *a, **k):
        runs[0] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(Evaluator, "run", run)
    monkeypatch.setattr(program, "kernel_launches", lambda: runs[0])


def run(workload, seconds=0.5):
    result, checks = R.run_cell(small(workload), SEED, seconds, False, "cpu",
                                time.perf_counter())
    return result, checks


# -- the view cell -------------------------------------------------------------------


def stale_frames(monkeypatch):
    from viamd_tpu_torch.app.session import Session

    first = {}
    real = Session.render

    def render(self, *a, **k):
        out = real(self, *a, **k)
        return first.setdefault("out", out)

    monkeypatch.setattr(Session, "render", render)


def half_the_atoms(monkeypatch):
    from viamd_tpu_torch.render import raster

    real = raster.render_molecules

    def render_molecules(positions, radii, *a, **k):
        r = torch.as_tensor(radii).clone()
        r[r.shape[0] // 2:] = 0.0
        return real(positions, r, *a, **k)

    monkeypatch.setattr(raster, "render_molecules", render_molecules)


def shifted_colour(monkeypatch):
    from viamd_tpu_torch.render import postprocess

    real = postprocess.execute
    monkeypatch.setattr(postprocess, "execute",
                        lambda *a, **k: (real(*a, **k) + 0.02).clamp(0, 1))


def wrong_picks(monkeypatch):
    from viamd_tpu_torch.render import raster

    real = raster.render_scene

    def render_scene(scene):
        rgba, depth, pick = real(scene)
        return rgba, depth, torch.flip(pick, dims=[1])  # each pick lands mirrored

    monkeypatch.setattr(raster, "render_scene", render_scene)


# -- the evaluate cell --------------------------------------------------------------


def sdf_state_unchanged(monkeypatch):
    from viamd_tpu_torch.ops import sdf

    for route in ("sdf_accumulate", "sdf_accumulate_pairs"):  # the grid stays empty
        real = getattr(sdf, route)
        monkeypatch.setattr(sdf, route, lambda *a, real=real, **k: real(*a, **k) * 0.0)


def half_the_frames(monkeypatch):
    from viamd_tpu_torch.eval.engine import Evaluator

    real = Evaluator.run

    def run_half(self, frame_range=None, **k):
        res = real(self, frame_range=range(0, self.traj.num_frames, 2), **k)
        res._dist_dev = {n: v * 2.0 for n, v in res._dist_dev.items()}
        res._vol_dev = {n: v * 2.0 for n, v in res._vol_dev.items()}
        return res

    monkeypatch.setattr(Evaluator, "run", run_half)


def rolled_histogram(monkeypatch):
    from viamd_tpu_torch.script import compiler

    real = compiler.pair_dist_histogram_cl
    monkeypatch.setattr(compiler, "pair_dist_histogram_cl",
                        lambda *a, **k: torch.roll(real(*a, **k), 1))


CASES = [
    ("water100k.view", None), ("water100k.view", stale_frames),
    ("water100k.view", half_the_atoms), ("water100k.view", shifted_colour),
    ("water100k.view", wrong_picks),
    ("water1m.evaluate", None), ("water1m.evaluate", sdf_state_unchanged),
    ("water1m.evaluate", half_the_frames), ("water1m.evaluate", rolled_histogram),
]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__ if f else 'sound'}" for w, f in CASES])
def test_fault_is_caught(workload, fault, monkeypatch):
    torch.set_num_threads(4)
    if fault is not None:
        fault(monkeypatch)
    result, checks = run(workload)
    over = [k for k, (v, lim) in checks.items() if v > lim]
    assert result["correct"] is (fault is None), checks
    assert bool(over) is (fault is not None)
    assert (result["failed"] > 0) is (fault is not None)
    assert 0 <= result["failed"] <= result["attempted"]


@pytest.mark.parametrize("cached", [False, True])
def test_cached_pass_is_caught(cached, monkeypatch):
    """A result cache keyed on the frames serves the window's second pass
    with no work done: its numbers equal the reference's, and only
    `passes_without_launch` sees it."""
    from portbench.kinds import evaluate as kind
    from viamd_tpu_torch.app.session import Session

    torch.set_num_threads(4)
    if cached:
        cache = {}
        real = Session.evaluate

        def evaluate(self, frame_range=None, **k):
            key = None if frame_range is None else tuple(frame_range)
            if key not in cache:
                cache[key] = real(self, frame_range=frame_range, **k)
            return cache[key]

        monkeypatch.setattr(Session, "evaluate", evaluate)
    files = small("water1m.evaluate")
    cell = kind.setup(files["config"], files["traffic"], SEED, "cpu")
    kind.window(cell, 0.0, SEED, steps=2)
    kind.release(cell)
    values, _, failed = kind.check(cell, SEED, "cpu", files["limits"])
    over = sorted(k for k, v in values.items() if v > files["limits"][k])
    assert over == (["passes_without_launch"] if cached else []), values
    assert failed == cached * files["config"]["n_frames"]
