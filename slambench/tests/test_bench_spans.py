"""The metrics that read the program's own spans, counters and census
tables (``measure/stages.py``), on a synthetic event list: frames of kind
``localization`` read, a ``vo`` frame left out, a replay whose operations
miss its table read as None, and a trace without the program's spans (a
program older than them) read as nothing."""

import pytest

from slambench import harness
from slambench.measure.window import TraceWindow

METRICS = ("front_end.busy_ms", "front_end.pyramid_ms", "system.host_gap_ms",
           "system.host_reads")
# graph L1's census: 4 device operations, kernel W, the pyramid's two, an
# empty detect stage nested in extract, and the pose LM
TABLE = (("graph.loc.L1", 0, 4), ("warp", 0, 1), ("extract", 1, 3),
         ("extract.pyramid", 1, 3), ("extract.detect", 3, 3),
         ("pose_lm", 3, 4))
KERNELS = ("warp_remap_kernel", "gemm", "round", "pose_lm_kernel")


def _frame(t0, corr, kind, reads, ops=KERNELS):
    """One traced frame at ``t0``: the harness's frame, the program's
    ``slam.frame``, graph L1's replay span with its launch, a host read;
    on the device the replay's operations (listed out of device order) and
    one eager copy after the read."""
    cpu = [("frame", False, t0, t0 + 1000, [], 0),
           ("slam.frame", False, t0 + 10, t0 + 990, [], 0),
           ("graph.loc.L1", False, t0 + 100, t0 + 200, [], 0),
           ("cudaGraphLaunch", False, t0 + 110, t0 + 120, [], corr),
           ("host.read", False, t0 + 500, t0 + 600, [], 0),
           ("cudaStreamSynchronize", False, t0 + 510, t0 + 590, [], 0),
           ("cudaMemcpyAsync", False, t0 + 700, t0 + 710, [], corr + 1)]
    at = {"warp_remap_kernel": (300, 310), "gemm": (310, 350),
          "round": (350, 360), "pose_lm_kernel": (400, 450)}
    dev = [(name, True, t0 + at[name][0], t0 + at[name][1], [], corr)
           for name in reversed(ops)]
    dev.append(("Memcpy DtoH", True, t0 + 720, t0 + 730, [], corr + 1))
    row = {"kind": kind, "stage": "localization", "state": "OK",
           "host_reads": reads, "graph_stages": {"graph.loc.L1": TABLE}}
    return cpu + dev, row


def _window(frames):
    events, rows = [], []
    for k, (kind, reads, ops) in enumerate(frames):
        e, r = _frame(k * 10_000, 10 * (k + 1), kind, reads, ops)
        events += e
        rows.append(r)
    return TraceWindow(events, rows, {})


def _read(tw):
    return {m: harness.metric_reader(m)(tw) for m in METRICS}


def test_localization_frames_read_and_vo_left_out():
    tw = _window([("localization", 2, KERNELS), ("vo", 3, KERNELS[:2]),
                  ("localization", 2, KERNELS)])
    got = _read(tw)
    # warp + extract: [300, 360]; the pyramid [310, 360]; in ms
    assert got["front_end.busy_ms"] == pytest.approx(60e-6)
    assert got["front_end.pyramid_ms"] == pytest.approx(50e-6)
    # slam.frame's 980 ns less the busy [300, 360], [400, 450], [720, 730]
    assert got["system.host_gap_ms"] == pytest.approx(860e-6)
    assert got["system.host_reads"] == 2.0
    assert got["front_end.pyramid_ms"] <= got["front_end.busy_ms"]


def test_a_replay_that_misses_its_table_reads_none():
    tw = _window([("localization", 2, KERNELS),
                  ("localization", 2, KERNELS[:3])])
    got = _read(tw)
    assert got["front_end.busy_ms"] is None
    assert got["front_end.pyramid_ms"] is None
    # 860 ns, then 910 without the pose LM's 50
    assert got["system.host_gap_ms"] == pytest.approx(885e-6)
    assert got["system.host_reads"] == 2.0


def test_without_the_program_spans_nothing_is_read():
    """A program older than the spans: no ``slam.frame``, no graph span
    names, no ``kind`` and no ``graph_stages`` in its rows."""
    events, _ = _frame(0, 10, "localization", 2)
    events = [e for e in events
              if e[0] not in ("slam.frame", "graph.loc.L1", "host.read")]
    tw = TraceWindow(events, [{"stage": "localization", "state": "OK",
                               "host_reads": 2}], {})
    assert all(v is None for v in _read(tw).values())
    assert harness.metric_reader("track.device_ops")(tw) == 5
