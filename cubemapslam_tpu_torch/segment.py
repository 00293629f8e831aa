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
  ``csrc/seg_sum.cu`` (one warp a segment, 32 contiguous chunks summed in
  order; see the source) or raises; on a CPU tensor it is the plain
  ``zeros(...).index_add_(0, idx, values)``, so the port's CPU results do
  not depend on the plans.
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

WARP = 32            # threads, and so chunks, a segment (csrc kWarp)
MAX_LANES = 49       # lanes (values per row) the kernel takes: the pose
                     # graph's 7x7 blocks are the widest

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

SEG_SUM = CudaKernel("seg_sum.cu", "seg_sum_launch",
                     [_P, _LL, _LL, _P, _P, _P, _LL, _I])


class SegmentPlan:
    """The order of one segmented sum: ``idx`` (E,) int64 segment ids in
    [0, n] (``n`` drops the row) over ``n`` segments. ``perm`` lists the
    rows segment by segment, each segment's rows in index order, and
    ``off`` (n + 1,) the segments' start positions in it; both are built
    at construction on the card (a stable sort and a ``searchsorted``, no
    host read) and on first use on the CPU, whose ``segment_sum`` does not
    need them."""

    def __init__(self, idx: torch.Tensor, n: int):
        if idx.dim() != 1 or idx.dtype != torch.int64:
            raise ValueError(f"segment ids must be (E,) int64, got "
                             f"{tuple(idx.shape)} {idx.dtype}")
        self.idx = idx
        self.n = int(n)
        self._perm = self._off = None
        if idx.device.type == "cuda":
            self.order()

    def order(self):
        """(perm, off) of the plan, built on first use."""
        if self._perm is None:
            keys, self._perm = torch.sort(self.idx, stable=True)
            self._off = torch.searchsorted(
                keys, torch.arange(self.n + 1, dtype=torch.int64,
                                   device=keys.device))
        return self._perm, self._off


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
    values a row, on the plan's device), whose order of additions is fixed
    by the plan."""
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
    perm, off = plan.order()
    out = torch.empty((plan.n, lanes), dtype=torch.float32,
                      device=values.device)
    SEG_SUM(rows.data_ptr(), rows.stride(0), rows.stride(1), perm.data_ptr(),
            off.data_ptr(), out.data_ptr(), plan.n, lanes)
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
