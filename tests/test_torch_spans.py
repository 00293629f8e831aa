"""The port's spans and the census of its captured graphs
(``cubemapslam_tpu_torch/spans.py``), on the CPU.

* With no profiler running, ``span`` is one shared no-op and calls no
  ``record_function``; under ``torch.profiler`` it is one, so the names
  land in the trace, nested as entered.
* ``Census`` with an injected count of captured device operations: nested
  stages, an empty stage, stages entered under a profiler (in the trace
  too), and a captured part that raises (no table, the census gone).
* ``spans.frame``: the outermost decorated call is ``slam.frame`` and the
  row it appended gets the census tables of the graphs replayed in it;
  nested calls and calls with no profiler add nothing.

The port's eager frames under the profiler, with the names they emit and
their ``kind``, are in ``test_torch_fused_step.py`` (a tracked frame),
``test_torch_fused_localization.py`` (localization-mode frames) and
``test_torch_fused_mapping.py`` (initialization, keyframe and BA frames).
"""

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from cubemapslam_tpu_torch import spans


def raise_on_span(name):
    """A ``record_function`` that no frame without a profiler may call."""
    raise AssertionError(f"record_function({name!r}) called")


def host_spans(prof, names=None):
    """(name, start ns, end ns) of the host events of a CPU profile, sorted
    by start (an enclosing span before what it holds)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if names is None or e.name() in names:
            a = e.start_ns()
            out.append((e.name(), a, a + e.duration_ns()))
    return sorted(out, key=lambda x: (x[1], -x[2]))


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_profiler_calls_no_record_function(monkeypatch):
    monkeypatch.setattr(spans, "record_function", raise_on_span)
    assert not autograd_profiler._is_profiler_enabled
    with spans.span("a") as got:
        with spans.span("b"):
            pass
    assert got is None and spans.span("c") is spans.NO_SPAN
    assert spans.host_read(torch.tensor([1, 2])) == [1, 2]


def test_span_under_profiler_lands_in_the_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            with spans.span("inner"):
                pass
    got = host_spans(prof, {"outer", "inner"})
    assert [n for n, _, _ in got] == ["outer", "inner"]
    assert inside(got[1], got[0])


class Counter:
    """A stand-in for ``_build.capture_ops``: the operations captured so
    far."""

    def __init__(self, start=0):
        self.n = start

    def __call__(self):
        return self.n


@pytest.mark.parametrize("case", ["nested", "empty", "raises"])
def test_census_bookkeeping(case):
    ops = Counter(7)      # positions count from the capture's start
    census = spans.Census("graph.t.X", ops)
    if case == "raises":
        with pytest.raises(ValueError):
            with census:
                with spans.span("a"):
                    ops.n += 2
                    raise ValueError("a capture that fails")
        assert spans._censuses == []
        with pytest.raises(RuntimeError, match="did not finish"):
            census.table()
        assert spans.span("after") is spans.NO_SPAN
        return
    with census:
        if case == "nested":
            with spans.span("warp"):
                ops.n += 1
            with spans.span("extract"):
                with spans.span("extract.pyramid"):
                    ops.n += 3
                ops.n += 1
                with spans.span("extract.detect"):
                    ops.n += 2
            ops.n += 4            # captured outside every stage
        else:
            ops.n += 2
            with spans.span("host.nothing"):
                pass
    assert spans._censuses == []
    if case == "nested":
        assert census.table() == (
            ("graph.t.X", 0, 11), ("warp", 0, 1), ("extract", 1, 7),
            ("extract.pyramid", 1, 4), ("extract.detect", 5, 7))
    else:
        assert census.table() == (("graph.t.X", 0, 2),
                                  ("host.nothing", 2, 2))


def test_census_stages_under_profiler_land_in_the_trace():
    ops = Counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.Census("graph.t.Y", ops) as census:
            with spans.span("stage"):
                ops.n += 5
    assert census.table() == (("graph.t.Y", 0, 5), ("stage", 0, 5))
    assert [n for n, _, _ in host_spans(prof, {"stage"})] == ["stage"]


class Tracker:
    """A tracker whose decorated per-frame methods nest, as
    ``CubemapSLAM.track_fisheye`` calls ``MapTracker``'s."""

    TABLE = (("graph.t.A", 0, 3), ("warp", 0, 1))

    def __init__(self):
        self.metrics = []

    @spans.frame
    def outer(self, replay):
        return self.inner(replay)

    @spans.frame
    def inner(self, replay):
        if replay:
            spans.replayed(self.TABLE)
        self.metrics.append({"frame": len(self.metrics)})
        return "pose"


def test_frame_span_and_graph_stages(monkeypatch):
    tr = Tracker()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tr.outer(True) == "pose"
        assert tr.outer(False) == "pose"
    assert [n for n, _, _ in host_spans(prof, {"slam.frame"})] == [
        "slam.frame"] * 2
    assert tr.metrics[0]["graph_stages"] == {"graph.t.A": Tracker.TABLE}
    assert tr.metrics[0]["graph_stages"]["graph.t.A"] is Tracker.TABLE
    assert tr.metrics[1]["graph_stages"] == {}
    assert spans._frames == []
    monkeypatch.setattr(spans, "record_function", raise_on_span)
    tr.outer(True)
    assert "graph_stages" not in tr.metrics[2]
