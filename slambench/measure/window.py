"""A traced window, as the per-layer metrics read it.

Built once from the profiler's raw events (``trace.raw_events``): the host
events, the device operations (every device event that is not the device
side of a host range), the harness's ``frame`` spans with each frame's
metrics row from the program (``CubemapSLAM.metrics``), which device
operations each frame and each of the program's own ranges launched, and
the union of the device's busy intervals over the window."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from slambench.measure import trace as TR

# device gaps are labelled by the innermost of these host ranges that was
# open when the gap began: the harness's frame and the program's own ranges
LABELLED = ("frame", "init", "extract", "warp", "epilogue", "localization",
            "reloc", "insert+mapping", "local_ba", "loop")


class TraceWindow:
    def __init__(self, events, rows: List[dict], fields: dict):
        self.fields = fields
        self.cpu = [e for e in events if not e[1]]
        host_names = {e[0] for e in self.cpu}
        self.ops = [e for e in events if e[1] and e[0] not in host_names]
        self.frames = sorted((e[2], e[3]) for e in self.cpu
                             if e[0] == "frame")
        self.rows = rows[:len(self.frames)]
        self.n = len(self.frames)
        if self.frames:
            self.start, self.end = self.frames[0][0], self.frames[-1][1]
        else:
            self.start = self.end = 0
        self.launch = TR.launch_times(self.cpu)
        # the frame whose host span launched each device operation
        starts = [a for a, _ in self.frames]
        self.op_frame = []
        for k in self.ops:
            t = self.launch.get(k[5])
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            ok = i >= 0 and t < self.frames[i][1]
            self.op_frame.append(i if ok else -1)
        clipped = [(max(a, self.start), min(b, self.end))
                   for _, _, a, b, *_ in self.ops]
        self.busy = TR.union((a, b) for a, b in clipped if b > a)

    @classmethod
    def from_profile(cls, prof, rows, fields) -> "TraceWindow":
        return cls(TR.raw_events(prof), rows, fields)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def spans(self, *names: str) -> list:
        """Host spans of the named ranges (a name ending in ``.`` takes
        every range under it)."""
        return sorted((e[2], e[3]) for e in self.cpu
                      if e[0] in names or any(n.endswith(".")
                                              and e[0].startswith(n)
                                              for n in names))

    def launched_in(self, *names: str) -> list:
        return TR.launched_in(self.ops, self.launch, self.spans(*names))

    def frame_ops(self, keep) -> List[list]:
        """The device operations of each frame whose row ``keep`` takes."""
        by = defaultdict(list)
        for k, i in zip(self.ops, self.op_frame):
            if i >= 0:
                by[i].append(k)
        return [by[i] for i in range(self.n) if keep(self.rows[i])]

    def waits(self) -> list:
        """Host calls that wait for the device: synchronisations (which
        every blocking copy makes) and blocking ``cudaMemcpy``."""
        return [e for e in self.cpu
                if "Synchronize" in e[0] or e[0] == "cudaMemcpy"]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations with the most time, and the longest idle
        gaps of the device with what the host was doing then."""
        by = defaultdict(int)
        for name, _, a, b, *_ in self.ops:
            by[name] += b - a
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        prev = self.start
        for a, b in self.busy + [[self.end, self.end]]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        ranges = sorted((e[2], e[3], e[0]) for e in self.cpu
                        if e[0] in LABELLED)
        out = []
        for a, b in gaps[:top]:
            label = "between frames"
            for s, e, name in ranges:
                if s > a:
                    break
                if e > a:
                    label = name     # the innermost open range, by start
            out.append([label, (b - a) / 1e9])
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": out}


def busy_ms(ops) -> float:
    """The union of the operations' device intervals, in ms."""
    return sum(b - a for a, b in TR.union((k[2], k[3]) for k in ops)) / 1e6


def plain_frame(row: dict) -> bool:
    """A frame that only tracked: no keyframe, no deferred BA, no loop
    closure, and not an initialization or relocalization frame."""
    return (row.get("state") == "OK" and not row.get("keyframe")
            and not row.get("ba") and not row.get("loop_closed")
            and row.get("stage") not in ("init", "reloc"))


def kernel_ms(tw: TraceWindow, *names: str) -> Optional[tuple]:
    """(device ms summed over the window, launches) of the kernels whose
    names contain one of ``names``; None where none ran."""
    hit = [k for k in tw.ops if any(n in k[0] for n in names)]
    if not hit:
        return None
    return sum(k[3] - k[2] for k in hit) / 1e6, len(hit)
