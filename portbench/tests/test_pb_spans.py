"""The span readers on a made-up run: hand-made spans in a stand-in for the
program's tracing module and hand-made kernel intervals, each reader against
its hand-computed value, and no spans → None."""

import sys
from types import SimpleNamespace

import pytest

from portbench import run as R
from portbench import spans
from portbench.trace import Trace

MS = 1_000_000  # ns


def _install(monkeypatch, records):
    """A tracing module whose TRACER.spans() returns `records`."""
    tracer = SimpleNamespace(spans=lambda: list(records))
    monkeypatch.setitem(sys.modules, spans.TRACING, SimpleNamespace(TRACER=tracer))


def _run(kernels=(), frames=1, passes=1):
    tr = Trace(window_s=1.0, busy_s=0.0, kernels=list(kernels))
    return R.Run({}, {}, None, {"frames": frames, "passes": passes}, tr, {}, {})


def test_render_colors(monkeypatch):
    _install(monkeypatch, [
        ("render", 0, 50 * MS, -1, 0), ("render.colors", 2 * MS, 12 * MS, 0, 0),
        ("render", 60 * MS, 110 * MS, -1, 2), ("render.colors", 61 * MS, 72 * MS, 2, 2),
        ("render.draw", 72 * MS, 80 * MS, 2, 2)])
    assert R.metric_reader("render.colors_ms_per_frame")(_run(frames=2)) == pytest.approx(10.5)


def test_postprocess_idle(monkeypatch):
    _install(monkeypatch, [
        ("render.postprocess", 10 * MS, 30 * MS, -1, 0),
        ("render.postprocess", 100 * MS, 110 * MS, -1, 1)])
    kernels = [  # (name, start_ns, duration_ns)
        ("a", 5 * MS, 7 * MS),     # 10–12 inside the first span
        ("b", 11 * MS, 3 * MS),    # 11–14, overlaps a: the union counts once
        ("c", 20 * MS, 2 * MS),    # 20–22
        ("d", 29 * MS, 4 * MS),    # 29–30 inside
        ("e", 40 * MS, 50 * MS),   # outside both
        ("f", 105 * MS, 10 * MS),  # 105–110 inside the second
    ]
    # first span: 20 − (4 + 2 + 1) = 13; second: 10 − 5 = 5
    got = R.metric_reader("postprocess.idle_ms_per_frame")(_run(kernels, frames=2))
    assert got == pytest.approx(9.0)


def test_sdf_host(monkeypatch):
    _install(monkeypatch, [
        ("eval.frame", 0, 10 * MS, -1, 0), ("script.sdf", 1 * MS, 4 * MS, 0, 0),
        ("eval.frame", 10 * MS, 20 * MS, -1, 2), ("script.sdf", 11 * MS, 16 * MS, 2, 2)])
    got = R.metric_reader("sdf.host_ms_per_frame")(_run(frames=4, passes=2))
    assert got == pytest.approx(2.0)


def test_evaluate_overhead(monkeypatch):
    _install(monkeypatch, [
        ("evaluate", 0, 100 * MS, -1, 0), ("eval.build", 0, 20 * MS, 0, 0),
        ("eval.frame", 20 * MS, 50 * MS, 0, 0), ("eval.frame", 50 * MS, 90 * MS, 0, 0),
        ("result.force", 100 * MS, 130 * MS, -1, 4),
        ("evaluate", 200 * MS, 260 * MS, -1, 5), ("eval.frame", 210 * MS, 250 * MS, 5, 5),
        ("result.force", 260 * MS, 270 * MS, -1, 7)])
    # (100 + 60) + (30 + 10) − (30 + 40 + 40) = 90 over 2 passes
    got = R.metric_reader("evaluate.overhead_ms_per_pass")(_run(frames=8, passes=2))
    assert got == pytest.approx(45.0)


@pytest.mark.parametrize("name", ["render.colors_ms_per_frame", "postprocess.idle_ms_per_frame",
                                  "sdf.host_ms_per_frame", "evaluate.overhead_ms_per_pass"])
def test_no_spans_reads_none(name, monkeypatch):
    run = _run([("k", 0, MS)], frames=3, passes=1)
    _install(monkeypatch, [("other", 0, MS, -1, 0)])
    assert R.metric_reader(name)(run) is None
    # a program without spans(), or without the tracing module at all
    monkeypatch.setitem(sys.modules, spans.TRACING, SimpleNamespace(TRACER=object()))
    assert R.metric_reader(name)(run) is None
    monkeypatch.delitem(sys.modules, spans.TRACING)
    assert R.metric_reader(name)(run) is None


def test_records_from_the_program(monkeypatch):
    """The program's own tracer, through the helper: plain tuples."""
    from viamd_tpu_torch.core.tracing import Tracer

    tr = Tracer()
    tr.enabled = True
    with tr.section("evaluate"):
        with tr.section("eval.frame"):
            pass
    monkeypatch.setitem(sys.modules, spans.TRACING, SimpleNamespace(TRACER=tr))
    recs = spans.records()
    assert [(r[0], r[3], r[4]) for r in recs] == [("evaluate", -1, 0), ("eval.frame", 0, 0)]
    assert all(type(r) is tuple and r[1] <= r[2] for r in recs)
