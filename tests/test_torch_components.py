"""The port's components (Ramachandran, shape space) and what they subscribe
through (app/events.py, app/tasks.py), against viamd_tpu's components on a
SimpleNamespace session built for each package from the same numpy frames.

Tolerances. Angles: atol 1e-4 rad (tests/test_torch_backbone.py). Reference
tables, their bilinear samples and classifications: exact (numpy copies).
Densities without blur: exact (integer counts over an exact total, and the
same float32 binning of the same angles; the angles are the JAX package's,
fed to both). With blur: rtol 1e-5 (float32 taps summed in one order; the
total summed in another). Shape weights: atol 3e-5, on whole residues:
the float32 closed-form eigen solve of a 7-atom mass-weighted residue
moves a small eigenvalue's ratio by up to 1.35e-5 between the packages,
and by 2.2e-5 within the JAX package between its jitted component and the
same function called eagerly, on these frames.
"""

import io
import threading
import time
import types

import numpy as np
import pytest
import torch

from tests._torch_parity import port_system
from viamd_tpu_torch.app.events import EventBus, EventType
from viamd_tpu_torch.app.tasks import TaskSystem
from viamd_tpu_torch.components import RamachandranComponent, ShapespaceComponent
from viamd_tpu_torch.components import ramachandran as t_rama
from viamd_tpu_torch.io.trajectory import DeviceTrajectory, InMemoryTrajectory


# -- events and tasks (tests/test_app.py::TestEvents, ::TestTasks) ------------------


def test_event_bus():
    bus = EventBus()
    got = []
    bus.subscribe("ping", lambda ev: got.append(ev.payload))
    bus.broadcast("ping", 1)
    assert got == [1]
    bus.enqueue("ping", 2)
    bus.enqueue("ping", 3, delay=999)
    bus.process_queue()
    assert got == [1, 2]  # the delayed one is not due yet
    h = bus.subscribe("x", lambda ev: got.append("x"))
    bus.unsubscribe("x", h)
    bus.unsubscribe("x", h)  # twice: no error
    bus.broadcast("x")
    assert got == [1, 2]


def test_task_ranges_progress_and_interrupt():
    ts = TaskSystem(4)
    try:
        h = ts.enqueue_range("count", lambda b, e, t: e - b, total=100, grain=10)
        assert sum(h.wait(timeout=30)) == 100 and h.progress == 1.0
        # grain chunks run on several workers at once
        seen, active, peak, lock = set(), [0], [0], threading.Lock()

        def chunk(beg, end, task):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
                seen.add(threading.current_thread().name)
            time.sleep(0.05)
            with lock:
                active[0] -= 1
            return end - beg

        h = ts.enqueue_range("par", chunk, total=80, grain=10)
        assert sum(h.wait(timeout=30)) == 80 and len(seen) > 1 and peak[0] > 1
        # an interrupt drops the chunks not yet started; the results that
        # came back are in range order
        started = []

        def slow(beg, end, task):
            started.append(beg)
            time.sleep(0.03)
            return beg

        h = ts.enqueue_range("slow", slow, total=400, grain=2)
        while not started:
            time.sleep(0.005)
        h.interrupt_and_wait(timeout=30)
        got = h.wait(timeout=30)
        assert 0 < len(got) < 200 and got == sorted(got)
        # dependencies and the main-thread queue
        order = []
        a = ts.enqueue("a", lambda t: order.append("a"))
        b = ts.enqueue("b", lambda t: order.append("b"), dependency=a)
        b.wait(timeout=30)
        assert order == ["a", "b"]
        ts.enqueue_main(lambda: order.append("main"))
        assert ts.run_main_queue() == 1 and order[-1] == "main"
    finally:
        ts.shutdown()


# -- sessions for both packages -------------------------------------------------------


def _helix_frames(n_res=20, n_frames=12, seed=3):
    from viamd_tpu.datagen import polyala_helix

    sys, traj = polyala_helix(n_res, n_frames=n_frames, seed=seed)
    return sys, traj.load_frames(range(n_frames))


def _mixed(n_frames=12, seed=6):
    """A helix with GLY and PRO residues (every residue class), jittered."""
    from viamd_tpu.core.system import build_system, postprocess
    from viamd_tpu.core.unitcell import UnitCell

    sys, (frames, _) = _helix_frames(20, n_frames, seed)
    names = np.array([sys.res_names[i] for i in sys.res_name_id], dtype=object)
    names[[3, 11]] = "GLY"
    names[[6, 15]] = "PRO"
    res_names = [names[r] for r in sys.atom_res_idx]
    new = postprocess(build_system(
        coords=frames[0], atom_names=[sys.atom_names[i] for i in sys.atom_name_id],
        res_names=res_names, res_ids=np.asarray(sys.res_id)[sys.atom_res_idx],
        elements_z=sys.element, cell=UnitCell.none(),
    ))
    cells = np.zeros((n_frames, 3, 3), np.float32)
    return new, (frames, cells)


def _sessions(case, tasks=False, staged=False):
    from viamd_tpu.app.events import EventBus as JBus
    from viamd_tpu.io.trajectory import InMemoryTrajectory as JTraj

    jsys, (frames, cells) = _mixed() if case == "mixed" else _helix_frames()
    jts = None
    jsess = types.SimpleNamespace(system=jsys, trajectory=JTraj(frames), events=JBus(),
                                  tasks=jts, stored_selections={})
    ttraj = (DeviceTrajectory.stage(InMemoryTrajectory(frames), "cpu") if staged
             else InMemoryTrajectory(frames))
    tsess = types.SimpleNamespace(system=port_system(jsys), trajectory=ttraj,
                                  events=EventBus(), stored_selections={},
                                  tasks=TaskSystem(2) if tasks else None)
    return jsess, tsess


def _close(sess):
    if sess.tasks is not None:
        sess.tasks.shutdown()


def _wrapped_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


# -- Ramachandran ----------------------------------------------------------------------


def test_reference_tables_and_classes_match_jax():
    from viamd_tpu.components import ramachandran as j_rama

    rng = np.random.RandomState(0)
    phi = rng.uniform(-180, 180, 400)
    psi = rng.uniform(-180, 180, 400)
    for cls in t_rama.CLASSES:
        t = t_rama.reference_density(cls)
        assert t.shape == (180, 180) and np.array_equal(t, j_rama.reference_density(cls))
        assert np.array_equal(t_rama.sample_reference_density(phi, psi, cls, degrees=True),
                              j_rama.sample_reference_density(phi, psi, cls, degrees=True))
        assert np.array_equal(t_rama.classify_reference(np.radians(phi), np.radians(psi), cls),
                              j_rama.classify_reference(np.radians(phi), np.radians(psi), cls))
    assert t_rama.classify_reference(-60, -45, "general", degrees=True) == 2
    assert t_rama.classify_reference(0, 0, "general", degrees=True) == 0
    assert t_rama.classify_reference(75, -60, "glycine", degrees=True) >= 1


@pytest.mark.parametrize("case,tasks,staged", [
    ("helix", False, False),
    ("mixed", True, False),
    ("mixed", False, True),
])
def test_ramachandran_matches_jax(case, tasks, staged):
    from viamd_tpu.components.ramachandran import RamachandranComponent as JRama

    jsess, tsess = _sessions(case, tasks, staged)
    try:
        # past 64 frames with a task system, the frames load on the pool
        frame_range = list(range(12)) * 6 if tasks else None
        jr, tr = JRama(jsess), RamachandranComponent(tsess, device="cpu")
        jphi, jpsi = jr.compute_angles(frame_range)
        phi, psi = tr.compute_angles(frame_range)
        assert isinstance(phi, torch.Tensor) and phi.shape == jphi.shape
        assert _wrapped_diff(phi.numpy(), jphi).max() <= 1e-4
        assert _wrapped_diff(psi.numpy(), jpsi).max() <= 1e-4
        assert np.array_equal(tr._class_of, jr._class_of)
        # the densities from the same angles (JAX's, fed to both)
        tr._angles = (torch.tensor(np.array(jphi)), torch.tensor(np.array(jpsi)))
        for cls in t_rama.CLASSES:
            for sigma in (0.0, 1.5):
                want = jr.density(cls, blur_sigma=sigma)
                got = tr.density(cls, blur_sigma=sigma)
                assert isinstance(got, torch.Tensor) and got.shape == (128, 128)
                if sigma == 0:
                    assert np.array_equal(got.numpy(), want)
                else:
                    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)
                if want.sum() > 0:
                    assert abs(float(got.sum()) - 1.0) < 1e-5
                assert tr.iso_levels(got) == pytest.approx(jr.iso_levels(want), rel=1e-5)
        for f in (0, 5):
            assert np.array_equal(tr.classification(f), jr.classification(f))
        for box in (((-180, 180), (-180, 180)), ((-180, 180), (170, -170)),
                    ((-120, -40), (-80, 20)), ((179.9, 180), (179.9, 180))):
            for frame in (None, 3):
                res, mask = tr.select_in_plot(*box, frame=frame)
                jres, jmask = jr.select_in_plot(*box, frame=frame)
                assert np.array_equal(res, jres)
                assert np.array_equal(mask.to_bools(), jmask.to_bools())
        # an event resets the angles
        tsess.events.broadcast(EventType.TRAJECTORY_INIT)
        assert tr._angles is None
    finally:
        _close(tsess)


def test_ramachandran_density_bins():
    """Known angles land in known bins: (φ, ψ) = (−90°, 90°) → column 32,
    row 96 of 128; ends (0, 0) are dropped."""
    jsess, tsess = _sessions("helix")
    tr = RamachandranComponent(tsess, device="cpu")
    tr._classify()
    nbb = tsess.system.backbone.count
    phi = torch.full((2, nbb), -np.pi / 2)
    psi = torch.full((2, nbb), np.pi / 2)
    phi[0, 0] = psi[0, 0] = 0.0
    tr._angles = (phi, psi)
    d = tr.density("general", blur_sigma=0)
    assert d[96, 32] == 1.0 and d.sum() == 1.0


# -- shape space -----------------------------------------------------------------------


@pytest.mark.parametrize("filt,staged", [("residue(:)", False), ("residue(:)", True),
                                         ("resname('GLY') or resname('PRO')", False)])
def test_shapespace_matches_jax(filt, staged):
    from viamd_tpu.components.shapespace import ShapespaceComponent as JShape

    jsess, tsess = _sessions("mixed", staged=staged)
    js, ts = JShape(jsess), ShapespaceComponent(tsess, device="cpu")
    seen = []
    want = js.evaluate(filt)
    got = ts.evaluate(filt, progress=seen.append)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-5)
    assert seen[-1] == 1.0
    np.testing.assert_allclose(ts.scatter_points(), js.scatter_points(), atol=6e-5)
    for export in ("export_csv", "export_xvg"):
        a, b = io.StringIO(), io.StringIO()
        getattr(ts, export)(a)
        getattr(js, export)(b)
        la, lb = a.getvalue().splitlines(), b.getvalue().splitlines()
        assert len(la) == len(lb) and la[0] == lb[0]
    # a frame range, and an interrupt before the first batch
    sub = ts.evaluate(filt, frame_range=range(3, 7))
    np.testing.assert_allclose(sub, got[3:7], atol=1e-6)
    assert ts.evaluate(filt, interrupt=lambda: True).shape == (0, want.shape[1], 3)
    with pytest.raises(ValueError, match="matches nothing"):
        ts.evaluate("resname('XYZ')")
