"""The port's spans (viamd_tpu_torch/core/tracing.py) and where the program
opens them: the span record and its tree, the off path, the profiler twins
on kineto's clock, no device waits, and the span tree of a CPU session's
render and evaluate with its outputs unchanged by tracing."""

from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from viamd_tpu_torch.core import tracing as PT


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracer():
    """The program's TRACER, on and empty; off and empty again after."""
    PT.TRACER.reset()
    PT.TRACER.enabled = True
    yield PT.TRACER
    PT.TRACER.enabled = False
    PT.TRACER.reset()


def _tree(spans) -> set:
    """Each span's path of names from its root."""
    paths = []
    for s in spans:
        paths.append(s.name if s.parent < 0 else f"{paths[s.parent]}/{s.name}")
    return set(paths)


def test_spans_nest_with_parent_and_root(monkeypatch):
    tr = PT.Tracer()
    tr.enabled = True
    assert tr.current() is None
    with tr.section("a"):
        with tr.section("b"):
            with tr.section("c"):
                assert tr.current() == "a/b/c"
        with tr.section("b"):
            pass
        assert tr.current() == "a"
    with tr.section("d"):
        pass
    sp = tr.spans()
    assert [(s.name, s.parent, s.root) for s in sp] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 1, 0), ("b", 0, 0), ("d", -1, 4)]
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = sp[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    st = tr.stats()
    assert {k: v.calls for k, v in st.items()} == {"a": 1, "a/b": 2, "a/b/c": 1, "d": 1}
    children = sum((s.end_ns - s.start_ns) for s in sp if s.parent == 0) * 1e-9
    assert st["a"].self_s == pytest.approx(st["a"].total_s - children, abs=1e-9)
    assert tr.report().splitlines()[0].split() == ["section", "calls", "total", "max", "self"]
    # the buffer keeps the newest: a parent that left it reads −1
    monkeypatch.setattr(PT, "CAPACITY", 2)
    small = PT.Tracer()
    small.enabled = True
    with small.section("x"):
        with small.section("y"):
            with small.section("z"):
                pass
    assert [(s.name, s.parent, s.root) for s in small.spans()] == [("y", -1, -1), ("z", 0, -1)]
    assert set(small.stats()) == {"x/y", "x/y/z"}
    small.reset()
    assert small.spans() == [] and small.stats() == {}


def test_off_path_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tr = PT.Tracer()
    assert PT.Tracer().enabled is False and PT.TRACER.enabled is False
    a, b = tr.section("a"), tr.section("b")
    assert a is b  # one shared no-op context
    with a:
        with b:
            assert tr.current() is None
    assert tr.spans() == [] and tr.stats() == {}
    tr.enabled = True  # recording without a profiler opens no twin either
    with tr.section("on"):
        pass
    assert [s.name for s in tr.spans()] == ["on"]


def test_script_span_names_made_once():
    """A builtin call's span name is one string per builtin, so the off
    path of `_Compiler._eval_Call` builds none."""
    from viamd_tpu_torch.script import compiler as C

    first = C._span_name("distance")
    assert first == "script.distance"
    assert C._span_name("distance") is first


def test_profiler_twins_share_the_clock():
    """Under a profiler an off tracer records, and each span's
    record_function twin carries the span's stamps on kineto's clock."""
    tr = PT.Tracer()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(40):
            with tr.section(f"outer{i}"):
                with tr.section(f"inner{i}"):
                    x = x * 1.0001
    sp = tr.spans()
    assert len(sp) == 80 and tr.enabled is False
    twins = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()}
    assert all(s.name in twins for s in sp)
    d0 = statistics.median(abs(s.start_ns - twins[s.name][0]) for s in sp)
    d1 = statistics.median(abs(s.end_ns - twins[s.name][1]) for s in sp)
    assert d0 <= 100_000 and d1 <= 100_000, (d0, d1)
    with tr.section("after"):  # the profiler has stopped: off again
        pass
    assert len(tr.spans()) == 80


def test_spans_never_wait_on_the_device(monkeypatch):
    """Replaces the old device fence: no span synchronizes, on or off."""
    def refuse(*a, **k):
        raise AssertionError("a span synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    tr = PT.Tracer()
    assert not hasattr(tr, "fence")
    with pytest.raises(TypeError):
        PT.Tracer(device="cuda")
    for on in (False, True):
        tr.enabled = on
        with tr.section("k"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.section("k"):
            pass
    assert len(tr.spans()) == 2


def test_sdf_pairs_spans(tracer, one_thread):
    from viamd_tpu_torch.ops import sdf

    g = torch.Generator().manual_seed(3)
    n, box = 300, 12.0
    x = torch.rand((n, 3), generator=g) * box
    basis = torch.eye(3) * box
    inv = torch.eye(3) / box
    idx = torch.arange(6).reshape(2, 3)
    w = torch.ones((2, 3))
    refc = x[idx] - x[idx].mean(1, keepdim=True)
    idx_t = torch.arange(6, n)
    args = (x, torch.ones(n), idx, w, refc, 3.0, 8, basis, inv, idx_t, 64)
    want = sdf.sdf_accumulate_pairs(*args, compact_cap=100)
    tracer.reset()
    with tracer.section("script.sdf"):
        got = sdf.sdf_accumulate_pairs(*args, compact_cap=100)
    assert torch.equal(got, want)
    assert [s.name for s in tracer.spans()] == [
        "script.sdf", "sdf.frames", "sdf.cover", "sdf.compact", "sdf.splat"]
    assert {s.parent for s in tracer.spans()[1:]} == {0}


RENDER_TREE = {
    "session.set_frame", "render", "render/render.coords", "render/render.colors",
    "render/render.draw", "render/render.draw/raster.scene",
    "render/render.draw/raster.kernel", "render/render.composite", "render/render.outline",
    "render/render.volume", "render/render.postprocess",
    "render/render.postprocess/pp.ao", "render/render.postprocess/pp.tonemap",
    "render/render.postprocess/pp.antialias",
}
FRAME = "evaluate/eval.chunk/eval.frame"
EVAL_TREE = {
    "evaluate", "evaluate/eval.build", "evaluate/eval.chunk", FRAME,
    f"{FRAME}/script.distance", f"{FRAME}/script.angle", f"{FRAME}/script.rdf",
    f"{FRAME}/script.sdf", f"{FRAME}/script.shape_weights", "evaluate/eval.result",
    "result.force",
}


def test_session_span_tree(tracer, one_thread):
    """A CPU session's frame and evaluation open the spans of PERF.md's
    table, and give the same pixels and results with tracing on and off."""
    from viamd_tpu_torch.app import Session

    tracer.enabled = False
    s = Session(device="cpu").load_demo(n_res=8, n_frames=4)
    s.select("residue(1:2)")

    def frame_and_pass():
        s.set_frame(1.5)
        out = s.render(32, 24, volume="v", postprocess=True)
        res = s.evaluate(chunk=2)
        res.force()
        return out, res

    s.evaluate(chunk=2)  # the volume the render draws
    off_img, off_res = frame_and_pass()
    assert tracer.spans() == []
    tracer.enabled = True
    on_img, on_res = frame_and_pass()
    sp = tracer.spans()
    assert _tree(sp) == RENDER_TREE | EVAL_TREE
    roots = {sp[i].name for i in {x.root for x in sp}}
    assert roots == {"session.set_frame", "render", "evaluate", "result.force"}
    assert sum(x.name == "eval.frame" for x in sp) == 4
    for a, b in zip(off_img, on_img):
        assert torch.equal(a, b)
    for k in ("distributions", "volumes", "temporal"):
        got, want = getattr(on_res, k), getattr(off_res, k)
        assert got.keys() == want.keys()
        for name in got:
            np.testing.assert_array_equal(got[name], want[name])
