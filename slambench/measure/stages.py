"""The program's own spans and counters in a traced window, for the
per-layer metrics that read them.

The program (``cubemapslam_tpu_torch/spans.py``) marks each frame with the
span ``slam.frame``, each CUDA graph replay with ``graph.<owner>.<NAME>``,
and gives each ``metrics`` row its ``kind`` and, while a profiler records,
``graph_stages``: the census table of every graph the frame replayed,
((graph, 0, total), (stage, first, end), ...), positions among the graph's
device operations in device order. A replay's operations are those of the
graph launch inside its span (one correlation id); the k-th of them, by
device start, belongs to every stage with first <= k < end.

Every function returns nothing to read (None or empty) where the program
marks none of this, as a program older than these spans does."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Optional

from slambench.measure.window import busy_ms


def kind_frames(tw, kind: str) -> List[int]:
    """The window's frames whose row has this ``kind``."""
    return [i for i in range(tw.n) if tw.rows[i].get("kind") == kind]


def _inside(starts, spans, t) -> int:
    """The index of the span of sorted ``spans`` (with their ``starts``)
    that holds ``t``, else -1."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t < spans[i][1] else -1


def replays(tw, graph: str) -> Optional[dict]:
    """{frame index: [(device operations by device start, census table)]}
    for each replay of the graph spanned ``graph``: the operations launched
    inside its span, and the table the frame's row carries for it. None
    where a replay's frame row carries no table for it (the program marks
    no stages)."""
    spans = tw.spans(graph)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    corr = defaultdict(set)
    for c, t in tw.launch.items():
        i = _inside(starts, spans, t)
        if i >= 0:
            corr[i].add(c)
    ops = defaultdict(list)
    members = {c: i for i, cs in corr.items() for c in cs}
    for k in tw.ops:
        i = members.get(k[5])
        if i is not None:
            ops[i].append(k)
    frame_starts = [a for a, _ in tw.frames]
    out = defaultdict(list)
    for i, (a, _) in enumerate(spans):
        f = _inside(frame_starts, tw.frames, a)
        if f < 0:
            continue
        table = tw.rows[f].get("graph_stages", {}).get(graph)
        if table is None:
            return None
        out[f].append((sorted(ops[i], key=lambda k: k[2]), table))
    return out


def stage_ms(tw, graph: str, kind: str, keep) -> Optional[float]:
    """Device busy ms (union) a frame of ``kind`` of the operations of the
    graph spanned ``graph`` that the census puts under a stage whose name
    ``keep`` takes, averaged over such frames with a replay. None where
    there is no such replay, or a replay's count of device operations
    differs from its table's total (the census does not account for it)."""
    by_frame = replays(tw, graph)
    if not by_frame:
        return None
    per_frame = []
    for f in kind_frames(tw, kind):
        got = []
        for ops, table in by_frame.get(f, ()):
            if len(ops) != table[0][2]:
                return None
            idx = set()
            for name, first, end in table[1:]:
                if keep(name):
                    idx.update(range(first, end))
            got += [ops[k] for k in sorted(idx)]
        if f in by_frame:
            per_frame.append(busy_ms(got))
    if not per_frame:
        return None
    return sum(per_frame) / len(per_frame)


def host_gap_ms(tw, kind: str) -> Optional[float]:
    """A frame of ``kind``'s ``slam.frame`` span less the device's busy time
    (the window's union) inside it, in ms, averaged over such frames. None
    where the program spans no frame."""
    spans = tw.spans("slam.frame")
    if not spans:
        return None
    frame_starts = [a for a, _ in tw.frames]
    by_frame = {}
    for a, b in spans:
        f = _inside(frame_starts, tw.frames, a)
        if f >= 0:
            by_frame.setdefault(f, (a, b))
    busy_starts = [s for s, _ in tw.busy]
    gaps = []
    for f in kind_frames(tw, kind):
        if f not in by_frame:
            continue
        a, b = by_frame[f]
        busy = 0
        j = max(0, bisect.bisect_right(busy_starts, a) - 1)
        while j < len(tw.busy) and tw.busy[j][0] < b:
            s, e = tw.busy[j]
            busy += max(0, min(e, b) - max(s, a))
            j += 1
        gaps.append((b - a - busy) / 1e6)
    if not gaps:
        return None
    return sum(gaps) / len(gaps)
