"""Reading a ``torch.profiler`` trace: a frozen copy of ``chip_smoke.py``'s
event arithmetic (``raw_events``, ``launch_times``, ``launched_in``,
``wait_sources``, ``waits_in``, ``device_gaps``, ``bound``), which was
checked on the card through the port's bring-up, and the H100's peaks.

An event is a tuple (name, on the device, start ns, end ns, input shapes,
correlation id)."""

from __future__ import annotations

import bisect

# NVIDIA H100 SXM data sheet, at its full 700 W power limit
H100_BYTES_PER_S = 3.35e12    # HBM3
H100_F32_OPS_PER_S = 67e12    # float32 outside the tensor cores
H100_F64_OPS_PER_S = 34e12    # float64 outside the tensor cores


def raw_events(prof):
    """The profiler's events as (name, on the card, start ns, end ns, input
    shapes, correlation id), read from its raw result: ``prof.events()``
    builds a tree of Python objects, which takes minutes for 10^5
    operations."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                    s + e.duration_ns(), e.shapes(), e.correlation_id()))
    return out


def launch_times(cpu):
    """The start of each CUDA runtime or driver call (a kernel launch, a
    copy, a graph launch) by its correlation id."""
    return {e[5]: e[2] for e in cpu if e[5] and e[0].startswith("cu")}


def launched_in(kernels, launch, host):
    """The device operations whose launch (``launch_times``) starts inside
    one of the ``host`` spans. Unlike the range's span on the device, this
    holds for nested ranges."""
    spans = sorted(host)
    starts = [a for a, _ in spans]

    def inside(k):
        t = launch.get(k[5])
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return i >= 0 and t < spans[i][1]

    return [k for k in kernels if inside(k)]


def wait_sources(cpu):
    """A function that names the outermost aten operation around a host
    wait (a span of ``cpu``), else the wait's own name."""
    tops = []
    for name, _, a, b, *_ in sorted((e for e in cpu
                                    if e[0].startswith("aten::")),
                                   key=lambda e: (e[2], -e[3])):
        if not tops or a >= tops[-1][2]:
            tops.append((name, a, b))
    starts = [t[1] for t in tops]

    def source(w):
        i = bisect.bisect_right(starts, w[2]) - 1
        return tops[i][0] if i >= 0 and tops[i][2] >= w[3] else w[0]

    return source


def waits_in(waits, spans, n, source):
    """Host waits that start inside ``spans``, per frame: their count and
    their count by ``source``, most first."""
    spans = sorted(spans)
    starts = [a for a, _ in spans]

    def inside(w):
        i = bisect.bisect_right(starts, w[2]) - 1
        return i >= 0 and w[2] < spans[i][1]

    hits = [w for w in waits if inside(w)]
    by_src = {}
    for w in hits:
        src = source(w)
        by_src[src] = by_src.get(src, 0) + 1 / n
    return len(hits) / n, sorted(by_src.items(), key=lambda kv: -kv[1])


# a gap between two device operations of a frame shorter than this is
# counted as the cost of back-to-back launches (inside a graph replay or
# between eager launches); a longer one waits for the host
SHORT_GAP_NS = 20_000


def device_gaps(kernels, spans):
    """Per span (a frame's host range) of the device operations that start
    in it, sorted by start: the device span from the first start to the
    last end, and the idle time between operations split into gaps
    shorter than SHORT_GAP_NS and the rest (ms, summed over the spans)."""
    span = short = long_ = 0
    for a, b in spans:
        ks = sorted((k for k in kernels if a <= k[2] < b),
                    key=lambda k: k[2])
        if not ks:
            continue
        end = ks[0][3]
        for k in ks[1:]:
            gap = k[2] - end
            if gap > 0:
                if gap < SHORT_GAP_NS:
                    short += gap
                else:
                    long_ += gap
            end = max(end, k[3])
        span += end - ks[0][2]
    return span / 1e6, short / 1e6, long_ / 1e6


def bound(nbytes: float, nops: float, ops_per_s: float = H100_F32_OPS_PER_S):
    """Least time on an H100 (ms) and what bounds it; ``nops`` at the
    float32 rate unless another is given."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def union(intervals):
    """The merged (start, end) intervals of ``intervals``, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out
