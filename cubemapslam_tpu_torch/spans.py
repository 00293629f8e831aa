"""The port's named spans, and the census of the stages inside its CUDA
graphs.

``span(name)`` is the one way the port names a part of its work:

* while ``torch.profiler`` records, it is ``record_function(name)``, so the
  span lands in the trace on the device trace's clock (kineto puts host
  events and CUPTI's device timestamps on one timeline);
* while a CUDA graph is captured (``runtime/fused_step.py::
  CapturedFrame.run``), it is also a stage of that capture's ``Census``;
* otherwise it is one shared context that does nothing. A profiler being on
  is the only switch; with none, a span costs an attribute check.

A replay runs no host code, so nothing marks the stages inside it at run
time. ``Census`` records them at capture instead: each span entered while
the part is captured becomes ``(stage, first, end)``, the positions among
the capture's device operations (kernel, memcpy and memset nodes, the
kinds the profiler reports) of its first operation and one past its last,
read from the graph being captured (``_build.capture_ops``). The k-th
device operation of a replay, in device order, then belongs to every stage
with ``first <= k < end``.

``frame`` decorates a tracker's per-frame methods: while a profiler
records, the outermost call is the span ``slam.frame``, and the frame's
``metrics`` row gets ``graph_stages``: {replay span name: census table} of
every graph replayed in the frame (``replayed``). ``host_read`` is a host
read of a tensor, spanned as ``host.read``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

# one census table: (stage, first, end) entries, the graph's own first
Table = Tuple[Tuple[str, int, int], ...]


class _NoSpan:
    """The span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
# the censuses of the captures in progress (innermost last) and the
# graph_stages of the frames open while a profiler records
_censuses: List["Census"] = []
_frames: List[Dict[str, Table]] = []


def span(name: str):
    """The context that names a part of the port's work ``name`` (see the
    module docstring)."""
    if _censuses:
        return _Stage(_censuses[-1], name)
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return NO_SPAN


def host_read(t: torch.Tensor):
    """``t.tolist()``: a read of ``t`` to the host, spanned ``host.read``.
    The caller counts it where its row counts reads."""
    with span("host.read"):
        return t.tolist()


class _Stage:
    """A span entered during a capture: a census stage, and the profiler's
    range too while one records."""

    __slots__ = ("census", "name", "index", "first", "rf")

    def __init__(self, census: "Census", name: str):
        self.census, self.name = census, name
        self.rf = None

    def __enter__(self):
        c = self.census
        self.index = len(c.stages)
        c.stages.append((self.name, -1, -1))
        self.first = c.position()
        if _profiler._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        c = self.census
        c.stages[self.index] = (self.name, self.first, c.position())
        return False


class Census:
    """The stages of one capture. ``count()`` returns the device operations
    captured so far (``_build.capture_ops`` on the capturing stream, or a
    counter a test injects). Used as a context around the captured part:
    every ``span`` entered inside becomes an entry of ``stages``, in the
    order entered; ``table()`` is ``((name, 0, total), *stages)``. A part
    that raises leaves no table."""

    def __init__(self, name: str, count: Callable[[], int]):
        self.name = name
        self.count = count
        self.stages: List[Tuple[str, int, int]] = []
        self.total: Optional[int] = None
        self._base = 0

    def position(self) -> int:
        return self.count() - self._base

    def __enter__(self) -> "Census":
        self._base = self.count()
        _censuses.append(self)
        return self

    def __exit__(self, exc_type, *exc):
        _censuses.remove(self)
        if exc_type is None:
            self.total = self.position()
        return False

    def table(self) -> Table:
        if self.total is None:
            raise RuntimeError(f"the census of {self.name} did not finish")
        return ((self.name, 0, self.total), *self.stages)


def replayed(table: Table) -> None:
    """Note a replay of the graph whose census table is ``table`` in the
    frame open while a profiler records, if any, under the graph's span
    name."""
    if _frames:
        _frames[-1][table[0][0]] = table


def frame(track):
    """Decorate a per-frame method of a tracker (an object with a
    ``metrics`` list of rows): while a profiler records, the outermost
    such call is the span ``slam.frame``, and the row the call appended,
    if any, gets ``graph_stages`` (``replayed``). Nested calls and calls
    with no profiler run as they are."""

    @functools.wraps(track)
    def tracked(self, *args, **kwargs):
        if _frames or not _profiler._is_profiler_enabled:
            return track(self, *args, **kwargs)
        n = len(self.metrics)
        stages: Dict[str, Table] = {}
        _frames.append(stages)
        try:
            with record_function("slam.frame"):
                return track(self, *args, **kwargs)
        finally:
            _frames.pop()
            if len(self.metrics) > n:
                self.metrics[-1]["graph_stages"] = stages

    return tracked
