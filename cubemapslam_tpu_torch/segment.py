"""Segmented sums in a fixed order: the port's ``zeros(n).at[idx].add(v)``.

The JAX package sums the BA's normal-equation blocks, the pose graph's
normal matrix and the landmarks' viewing normals with ``.at[idx].add``,
which returns the same bits on every run of its chips. PyTorch's
``index_add_`` on the card adds with float atomics in whatever order the
threads arrive, so those sums, and every map built on them, change from run
to run. Here the order is fixed by a plan:

- ``SegmentPlan(idx, n)`` sorts the segment ids once (stable, so each
  segment keeps its rows in index order) into a permutation and ``n + 1``
  offsets, on the device and with no host read. The BA, the pose graph and
  the landmark statistics build one per problem and reuse it for every LM
  step and CG iteration, whose indices do not change.
- ``segment_sum(plan, values)``: on a CUDA tensor it launches
  ``csrc/seg_sum.cu`` or raises; on a CPU tensor it is the plain
  ``zeros(...).index_add_(0, idx, values)``, so the port's CPU results do
  not depend on the plans. The order of additions: a segment of at most
  ``WARP`` rows adds its rows in index order from +0.0 (the CPU's order);
  a longer one is cut into ``WARP`` contiguous chunks of ceil(len / WARP)
  rows, each summed from 0.0, and the chunk sums are added in chunk order
  from 0.0. The kernel is one launch on the current stream whose blocks
  take one of two roles: a chunk of a long segment (its rows staged into
  shared memory; the block that finishes a segment's last chunk adds the
  chunk sums and writes its row), or a tile of neighbouring segments
  (their offsets and short rows staged, 16-byte stores, zeros for the
  empty ones). Its bound is the bytes it moves; the source says how each
  role approaches it.
- ``segment_sum_ordered(plan, values)`` repeats the kernel's order of
  additions in plain PyTorch, on any device: it holds the kernel bitwise on
  the card and holds that order against JAX on the CPU.

An id equal to ``n`` marks a dropped row (the dump slot of
``slam_map._scatter``): it belongs to no segment, and the result has ``n``
rows.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cubemapslam_tpu_torch._build import CudaKernel

WARP = 32            # rows of a short segment, chunks of a long one
                     # (csrc kWarp)
MAX_LANES = 49       # lanes (values per row) the kernel takes: the pose
                     # graph's 7x7 blocks are the widest

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

SEG_SUM = CudaKernel("seg_sum.cu", "seg_sum_launch",
                     [_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                      _LL, _LL])


class SegmentPlan:
    """The order of one segmented sum: ``idx`` (E,) int64 segment ids in
    [0, n] (``n`` drops the row) over ``n`` segments.

    ``order()``: ``perm`` lists the rows segment by segment, each
    segment's rows in index order, and ``off`` (n + 1,) the segments'
    start positions in it (a stable sort and a ``searchsorted``).

    ``schedule()``: the long segments (more than ``WARP`` rows), which the
    kernel sums by chunks. ``long_seg`` (``long_bound``,) lists them in
    segment order, then ``n``; ``long_count`` (1,) is their number, on the
    plan's device; ``long_done`` (``long_bound``,) int32 zeros, a counter
    of finished chunks a long segment, which the kernel sets back to 0
    (so two launches on one plan must not overlap: they do not on one
    stream). ``long_bound`` = min(E // (WARP + 1), n) is known on the host
    and is never below the count, since a long segment holds at least
    WARP + 1 of the E rows: it sizes the kernel's long-segment grid and
    workspace. Built with a cumsum and a stable sort, never ``nonzero``.

    On the card both are built at construction with no host read, once a
    solve; on the CPU on first use, since its ``segment_sum`` needs
    neither."""

    def __init__(self, idx: torch.Tensor, n: int):
        if idx.dim() != 1 or idx.dtype != torch.int64:
            raise ValueError(f"segment ids must be (E,) int64, got "
                             f"{tuple(idx.shape)} {idx.dtype}")
        self.idx = idx
        self.n = int(n)
        self.long_bound = min(idx.shape[0] // (WARP + 1), self.n)
        self._perm = self._off = self._sched = None
        if idx.device.type == "cuda":
            self.schedule()

    N_PARTS = 6

    def parts(self):
        """The plan's tensors, flat: (idx, perm, off, long_seg, long_count,
        long_done); ``from_parts`` makes the plan again from them."""
        return [self.idx, *self.order(), *self.schedule()]

    @classmethod
    def from_parts(cls, parts, n: int) -> "SegmentPlan":
        """The plan of ``parts`` (``parts()``) over ``n`` segments, on those
        tensors (a captured graph's outputs, say), with no launch."""
        plan = cls.__new__(cls)
        plan.idx, plan.n = parts[0], int(n)
        plan.long_bound = min(plan.idx.shape[0] // (WARP + 1), plan.n)
        plan._perm, plan._off = parts[1], parts[2]
        plan._sched = tuple(parts[3:cls.N_PARTS])
        return plan

    def order(self):
        """(perm, off) of the plan, built on first use."""
        if self._perm is None:
            keys, self._perm = torch.sort(self.idx, stable=True)
            self._off = torch.searchsorted(
                keys, torch.arange(self.n + 1, dtype=torch.int64,
                                   device=keys.device))
        return self._perm, self._off

    def schedule(self):
        """(long_seg, long_count, long_done) of the plan, built on first
        use."""
        if self._sched is None:
            off = self.order()[1]
            dev = off.device
            short = (off[1:] - off[:-1]) <= WARP
            count = torch.cumsum(~short, 0)[-1:] if self.n else torch.zeros(
                1, dtype=torch.int64, device=dev)
            # the long segments first, each group in segment order
            listed = torch.sort(short.to(torch.uint8), stable=True)[1]
            pos = torch.arange(self.long_bound, dtype=torch.int64,
                               device=dev)
            long_seg = torch.where(pos < count, listed[:self.long_bound],
                                   self.n)
            done = torch.zeros(self.long_bound, dtype=torch.int32,
                               device=dev)
            self._sched = (long_seg, count, done)
        return self._sched


def _rows(plan: SegmentPlan, values: torch.Tensor):
    """``values`` as (E, C) rows (a view where the layout allows) and C."""
    E = plan.idx.shape[0]
    if values.shape[0] != E:
        raise ValueError(f"values have {values.shape[0]} rows, the plan "
                         f"{E}")
    lanes = math.prod(values.shape[1:])
    return values.reshape(E, lanes), lanes


def segment_sum(plan: SegmentPlan, values: torch.Tensor) -> torch.Tensor:
    """(n, ...) sums of the rows of ``values`` (E, ...) by segment: the JAX
    ``zeros((n,) + v.shape[1:]).at[idx].add(v)``, with rows whose id is
    ``n`` dropped. A CPU tensor takes ``index_add_``; a CUDA tensor
    launches the segmented-sum kernel (float32, at most ``MAX_LANES``
    values a row, rows and lanes at any strides, on the plan's device),
    whose order of additions is fixed by the plan and repeated bitwise by
    ``segment_sum_ordered``. The wrapper allocates the output and the
    chunks' workspace (``long_bound`` x ``WARP`` x lanes floats) and
    counts one launch a call in ``SEG_SUM.launches``."""
    tail = tuple(values.shape[1:])
    if values.device.type == "cpu":
        out = torch.zeros((plan.n + 1,) + tail, dtype=values.dtype)
        return out.index_add_(0, plan.idx, values)[:plan.n]
    rows, lanes = _rows(plan, values)
    if values.device != plan.idx.device:
        raise ValueError(f"segment_sum: values on {values.device}, the plan "
                         f"on {plan.idx.device}")
    if values.dtype != torch.float32 or not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"segment_sum takes float32 rows of 1 to "
                         f"{MAX_LANES} values, got {lanes} {values.dtype}")
    if plan.n * lanes >= 2 ** 31 or rows.shape[0] >= 2 ** 31:
        raise ValueError(f"segment_sum takes fewer than 2^31 rows and output "
                         f"values, got {rows.shape[0]} rows, {plan.n} x "
                         f"{lanes} values")
    perm, off = plan.order()
    long_seg, long_count, long_done = plan.schedule()
    out = torch.empty((plan.n, lanes), dtype=torch.float32,
                      device=values.device)
    partial = torch.empty((plan.long_bound * WARP * lanes,),
                          dtype=torch.float32, device=values.device)
    SEG_SUM(rows.data_ptr(), rows.stride(0), rows.stride(1), perm.data_ptr(),
            off.data_ptr(), long_seg.data_ptr(), long_count.data_ptr(),
            long_done.data_ptr(), partial.data_ptr(), out.data_ptr(), plan.n,
            lanes, rows.shape[0], plan.long_bound)
    return out.view((plan.n,) + tail)


def segment_sum_ordered(plan: SegmentPlan,
                        values: torch.Tensor) -> torch.Tensor:
    """The kernel's sums in plain PyTorch, on any device: each segment's
    sorted rows cut into ``WARP`` contiguous chunks of ceil(len / WARP)
    rows, each chunk summed row by row from 0.0, then the chunks' sums
    added in chunk order from 0.0 (an empty chunk adds +0.0, which leaves
    a sum that never is -0.0 unchanged). Reads the longest chunk to the
    host; for checks, not for the main path."""
    n = plan.n
    rows, lanes = _rows(plan, values)
    dev = values.device
    perm, off = plan.order()
    E = rows.shape[0]
    lens = off[1:] - off[:-1]
    chunk = (lens + WARP - 1) // WARP
    k = torch.arange(E, dtype=torch.int64, device=dev)
    seg = plan.idx[perm].clamp(max=max(n - 1, 0))
    kept = k < off[-1]
    r = k - off[seg]
    ch = chunk[seg].clamp(min=1)
    slot = seg * WARP + r // ch               # the (segment, chunk) of a row
    step = r % ch                             # its place in the chunk
    srt = rows[perm]
    partial = torch.zeros((n * WARP, lanes), dtype=rows.dtype, device=dev)
    for q in range(int(chunk.max()) if n else 0):
        sel = (kept & (step == q)).nonzero()[:, 0]
        # at most one row a chunk at each step: one add a target
        partial.index_add_(0, slot[sel], srt[sel])
    total = torch.zeros((n, lanes), dtype=rows.dtype, device=dev)
    partial = partial.view(n, WARP, lanes)
    for j in range(WARP):
        total = total + partial[:, j]
    return total.view((n,) + tuple(values.shape[1:]))
