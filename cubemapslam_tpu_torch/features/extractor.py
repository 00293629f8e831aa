"""Batched fixed-shape ORB extractor in PyTorch, with kernel D and the
describe kernel.

Counterpart of ``cubemapslam_tpu/features/extractor.py``: an 8-level x1.2
pyramid, FAST-9/16 with per-cell adaptive ini/min thresholds 20/7,
grid-bucketed NMS (3x3 local max, per-cell top-4, global top-K per level),
quadratic subpixel refinement, intensity-centroid orientation and 256-bit
blur-folded rBRIEF, coordinates scaled to level 0 and cubemap-face + mask
culling.

The port follows the JAX package's CPU path, which is exact; the TPU detect
kernel's slab-halo and fixed-cell approximations are layout artefacts of the
TPU and are not reproduced. Two TPU kernels become CUDA kernels here, each
launched once for all pyramid levels:

* kernel D (``csrc/orb_detect.cu``, replaces ``_detect_kernel``): FAST
  strength with the per-cell fallback flags, then merge, 3x3 NMS, border
  mask, per-cell top-4 and subpixel offsets (``detect_cells_levels``).
  ``_detect_cells_plain`` is its plain version, level by level.
* the describe kernel (``csrc/orb_describe.cu``, replaces ``_gather_kernel``
  and the dense descriptor product after it): per keypoint, the raw-window
  gather from the edge-replicated level image, the IC angle and the rBRIEF
  bits of the chosen rotation bin only, from a sparse table of the
  descriptor operator (``describe_keypoints``). ``_describe_plain`` is its
  plain version: the 48x48 patch gather and one dense product with the
  descriptor+moment operator.

The pyramid and the plain descriptor+moment product are plain matrix
products (``torch.matmul``), as the JAX package leaves them to XLA. They
reproduce its bf16 operand rounding with float32 accumulation and float32
output: the operands are rounded to bf16 and multiplied as float32 with
TF32 off.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch._build import CudaKernel, require_cuda
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.features.pattern import orb_pattern
from cubemapslam_tpu_torch.spans import span

# FAST radius-3 Bresenham circle, circular order (dx, dy)
_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
     (-1, -3)], dtype=np.int32)

EDGE_BORDER = 19          # keep-out border in level coords
PATCH_R = 18              # descriptor patch radius (rotated pattern reach)
ORI_R = 15                # orientation circular-patch radius
BLUR_R = 3                # 7x7 sigma-2 Gaussian
RAW_R = PATCH_R + BLUR_R  # 21: raw-patch radius covering blurred desc reach
_RAWP = 48                # raw patch side; rows/cols >= 43 are junk and
                          # zeroed in the flat operators
_WIN = 2 * RAW_R + 1      # 43: the part of a raw patch the operators read
N_ROT = 32                # steered-BRIEF rotation bins (11.25 deg)
PER_CELL = 4              # detection survivors per cell

MAX_LEVELS = 16           # levels one kernel launch takes (csrc kMaxLevels)
DETECT_CELLS = (16, 32)   # cell sizes kernel D is instantiated for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LLS = ctypes.POINTER(ctypes.c_longlong)     # host array of device pointers
_INTS = ctypes.POINTER(ctypes.c_int)         # host array of sizes

# kernel D is two launches over all levels, each with its own counter
ORB_FAST = CudaKernel("orb_detect.cu", "orb_fast_launch",
                      [_I, _LLS, _INTS, _INTS, _I, _F, _F, _P, _P])
ORB_SELECT = CudaKernel("orb_detect.cu", "orb_select_launch",
                        [_I, _LLS, _INTS, _INTS, _I, _F, _F, _P, _P, _P, _P,
                         _P, _P, _P])
ORB_DESCRIBE = CudaKernel("orb_describe.cu", "orb_describe_launch",
                          [_I, _LLS, _INTS, _INTS, _INTS, _P, _P, _P, _I, _P,
                           _P])


class OrbParams(NamedTuple):
    """Static extractor plan (python values)."""

    n_features: int
    n_levels: int
    scale_factor: float
    ini_th: int
    min_th: int
    cell: int                       # detection/NMS cell size in px
    level_hw: Tuple[Tuple[int, int], ...]   # per-level (H, W)
    level_k: Tuple[int, ...]        # per-level keypoint budget


class Keypoints(NamedTuple):
    """Fixed-size keypoint set for one image; invalid rows are masked."""

    uv: torch.Tensor        # (N, 2) float32 level-0 cubemap (u, v)
    response: torch.Tensor  # (N,) float32
    angle: torch.Tensor     # (N,) float32 radians
    level: torch.Tensor     # (N,) int64 pyramid octave
    face: torch.Tensor      # (N,) int64 cubemap face (UNKNOWN=-1 if culled)
    desc: torch.Tensor      # (N, 8) int64 holding the 8 uint32 words of the
                            # 256-bit rBRIEF (bit j of word w = bit 32w+j)
    rays: torch.Tensor      # (N, 3) float32 unit bearing rays (rig frame)
    valid: torch.Tensor     # (N,) bool

    @property
    def n(self) -> int:
        return self.uv.shape[0]


def plan_levels(n_features: int, n_levels: int, scale_factor: float,
                image_hw: Tuple[int, int], cell: int = 32) -> OrbParams:
    """Per-level shapes and keypoint budgets (geometric distribution)."""
    H, W = image_hw
    level_hw = []
    for lv in range(n_levels):
        s = 1.0 / (scale_factor ** lv)
        level_hw.append((int(round(H * s)), int(round(W * s))))
    f = 1.0 / scale_factor
    k0 = n_features * (1 - f) / (1 - f ** n_levels)
    ks = [int(round(k0 * (f ** lv))) for lv in range(n_levels)]
    ks[-1] = max(n_features - sum(ks[:-1]), 0)
    return OrbParams(n_features=sum(ks), n_levels=n_levels,
                     scale_factor=scale_factor, ini_th=0, min_th=0,
                     cell=cell, level_hw=tuple(level_hw), level_k=tuple(ks))


# ---------------------------------------------------------------------------
# FAST corner response (plain versions of kernel D's first pass)
# ---------------------------------------------------------------------------

def _run9_strength(ds) -> torch.Tensor:
    """max over the 16 9-long circular runs of the run's min difference, by
    a doubling chain of min over the neighbour list."""
    m2 = [torch.minimum(ds[i], ds[(i + 1) % 16]) for i in range(16)]
    m4 = [torch.minimum(m2[i], m2[(i + 2) % 16]) for i in range(16)]
    m8 = [torch.minimum(m4[i], m4[(i + 4) % 16]) for i in range(16)]
    v = None
    for i in range(16):
        m9 = torch.minimum(m8[i], ds[(i + 8) % 16])
        v = m9 if v is None else torch.maximum(v, m9)
    return v


def _fast_strength(ds) -> torch.Tensor:
    """FAST-9/16 corner strength from the 16 neighbour differences: the
    maximal threshold at which the segment test still fires."""
    return torch.maximum(_run9_strength(ds), _run9_strength([-d for d in ds]))


def _fast_maps_dual(img: torch.Tensor, th_hi: int, th_lo: int):
    """FAST corner masks at two thresholds + the corner strength. Neighbours
    wrap around the image (a roll), as in the JAX version."""
    ds = []
    for dx, dy in _CIRCLE:
        neigh = torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))
        ds.append(neigh - img)
    strength = _fast_strength(ds)
    return strength > float(th_hi), strength > float(th_lo), strength


def _fast_adaptive(img: torch.Tensor, ini_th: int, min_th: int,
                   cell: int) -> torch.Tensor:
    """Response map with the per-cell threshold fallback: use ini_th; where
    a cell (anchored at (0,0), zero padded) has no ini_th corner, fall back
    to min_th. Non-corners get response 0."""
    strong_c, weak_c, score = _fast_maps_dual(img, ini_th, min_th)
    H, W = img.shape
    Hc, Wc = -(-H // cell), -(-W // cell)
    sc = torch.nn.functional.pad(strong_c, (0, Wc * cell - W,
                                            0, Hc * cell - H))
    cell_any = sc.reshape(Hc, cell, Wc, cell).any(dim=3).any(dim=1)
    full = cell_any.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    corner = torch.where(full[:H, :W], strong_c, weak_c)
    return torch.where(corner, score, torch.zeros_like(score))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 local-maximum suppression (outside the image counts as -inf)."""
    p = torch.nn.functional.pad(score[None, None], (1, 1, 1, 1),
                                value=-float("inf"))
    neigh_max = torch.nn.functional.max_pool2d(p, 3, stride=1)[0, 0]
    return torch.where(score >= neigh_max, score, torch.zeros_like(score))


def _border_mask(score: torch.Tensor) -> torch.Tensor:
    """Zero the EDGE_BORDER keep-out band (also guards patch gathers)."""
    H, W = score.shape
    out = torch.zeros_like(score)
    b = EDGE_BORDER
    out[b:H - b, b:W - b] = score[b:H - b, b:W - b]
    return out


def _cell_topk(score: torch.Tensor, cell: int, per_cell: int = PER_CELL):
    """Top-`per_cell` responses of every cell, ties to the lower in-cell
    (row-major) index. Returns (val, y, x), each (ncells, per_cell), cells
    in row-major order."""
    H, W = score.shape
    Hc, Wc = -(-H // cell), -(-W // cell)
    pad = torch.nn.functional.pad(score, (0, Wc * cell - W, 0, Hc * cell - H))
    cells = pad.reshape(Hc, cell, Wc, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(Hc * Wc, cell * cell)
    val, arg = torch.sort(cells, dim=1, descending=True, stable=True)
    val, arg = val[:, :per_cell], arg[:, :per_cell]
    dev = score.device
    cy = torch.arange(Hc, device=dev).repeat_interleave(Wc)
    cx = torch.arange(Wc, device=dev).repeat(Hc)
    ys = cy[:, None] * cell + arg // cell
    xs = cx[:, None] * cell + arg % cell
    return val, ys, xs


def _n_cells(hw: Tuple[int, int], cell: int) -> int:
    return (-(-hw[0] // cell)) * (-(-hw[1] // cell))


def _global_topk(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, ties to the lower index (the order
    lax.top_k gives); never torch.topk, whose tie order is unspecified."""
    order = torch.sort(vals, descending=True, stable=True).indices
    return order[:min(k, vals.shape[0])]


def _pad_to(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, k - x.shape[0]))


def _topk_grid(score: torch.Tensor, cell: int, k: int,
               per_cell: int = PER_CELL):
    """Top-`per_cell` responses per cell, then global top-k. Returns
    (y, x, response) each (k,); response 0 marks an unfilled slot."""
    val, ys, xs = _cell_topk(score, cell, per_cell)
    vals = val.reshape(-1)
    top = _global_topk(vals, k)
    return (_pad_to(ys.reshape(-1)[top], k), _pad_to(xs.reshape(-1)[top], k),
            _pad_to(vals[top], k))


def _subpixel_offsets(score: torch.Tensor, ys: torch.Tensor,
                      xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic (parabola) refinement of integer winners on the response
    map, zero padded by one pixel; positions beyond the padding clamp to
    it (the JAX gather's clamping)."""
    H, W = score.shape
    pad = torch.nn.functional.pad(score, (1, 1, 1, 1))

    def at(y, x):
        return pad[y.clamp(0, H + 1), x.clamp(0, W + 1)]

    yp, xp = ys + 1, xs + 1
    c = at(yp, xp)
    xm, xpl = at(yp, xp - 1), at(yp, xp + 1)
    ym, ypl = at(yp - 1, xp), at(yp + 1, xp)
    denx = 2.0 * c - xm - xpl
    deny = 2.0 * c - ym - ypl
    zero = torch.zeros_like(c)
    dx = torch.where(denx.abs() > 1e-6,
                     0.5 * (xpl - xm) / torch.clamp(denx, min=1e-6), zero)
    dy = torch.where(deny.abs() > 1e-6,
                     0.5 * (ypl - ym) / torch.clamp(deny, min=1e-6), zero)
    return dy.clamp(-0.5, 0.5), dx.clamp(-0.5, 0.5)


# ---------------------------------------------------------------------------
# Kernel D: per-cell detection candidates
# ---------------------------------------------------------------------------

def _detect_cells_plain(img: torch.Tensor, cell: int, ini_th: int,
                        min_th: int):
    """Plain version of kernel D: per-cell top-4 candidates of one level.

    FAST with the cell fallback, 3x3 NMS, then the EDGE_BORDER mask (after
    NMS), per-cell top-4, and subpixel offsets from the pre-NMS merged map.
    Returns (resp f32, ys i32, xs i32, dy f32, dx f32), each
    (ncells, PER_CELL)."""
    raw = _fast_adaptive(img, ini_th, min_th, cell)
    score = _border_mask(_nms3(raw))
    val, ys, xs = _cell_topk(score, cell)
    dy, dx = _subpixel_offsets(raw, ys, xs)
    return val, ys.to(torch.int32), xs.to(torch.int32), dy, dx


def _check_levels(name: str, levels) -> list:
    """The level images as a list: 2-D float32 tensors on one device."""
    levels = list(levels)
    if not levels:
        raise ValueError(f"{name}: no level images")
    for img in levels:
        if img.dim() != 2 or img.dtype != torch.float32:
            raise ValueError(f"{name}: level images must be 2-D float32, "
                             f"got {tuple(img.shape)} {img.dtype}")
        if img.device != levels[0].device:
            raise ValueError(f"{name}: level images on {img.device} and "
                             f"{levels[0].device}")
    return levels


def _level_arrays(levels):
    """The host arrays a kernel's C entry takes for its level table: the
    count, the device pointers, the heights and the widths."""
    n = len(levels)
    return (n, (ctypes.c_longlong * n)(*[t.data_ptr() for t in levels]),
            (ctypes.c_int * n)(*[t.shape[0] for t in levels]),
            (ctypes.c_int * n)(*[t.shape[1] for t in levels]))


def _cuda_levels(name: str, levels) -> list:
    """Contiguous CUDA level images that one launch of a kernel takes."""
    levels = [img.contiguous() for img in levels]
    require_cuda(name, *levels)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"{name}: at most {MAX_LEVELS} levels a launch, "
                         f"got {len(levels)}")
    if min(min(img.shape) for img in levels) < 3:
        raise ValueError(f"{name}: level images must be at least 3x3")
    return levels


def detect_cells_levels(levels, cell: int, ini_th: int, min_th: int):
    """Per-cell detection candidates of every level image ((H, W) float32
    each), concatenated in level order: (resp f32, ys i32, xs i32, dy f32,
    dx f32), each (sum of the levels' cells, PER_CELL), as
    ``_detect_cells_plain`` gives them level by level.

    CPU tensors take that plain version. CUDA tensors launch kernel D
    twice for all levels: FAST strength with per-cell any-strong flags,
    then merge/NMS/border/top-4/subpixel per cell (cells of 16 or 32 px,
    thresholds >= 0)."""
    levels = _check_levels("detect_cells_levels", levels)
    if levels[0].device.type == "cpu":
        outs = [_detect_cells_plain(img, cell, ini_th, min_th)
                for img in levels]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    if cell not in DETECT_CELLS:
        raise ValueError(f"kernel D is built for cells of {DETECT_CELLS} "
                         f"px, got {cell}")
    if ini_th < 0 or min_th < 0:
        raise ValueError("kernel D takes thresholds >= 0")
    levels = _cuda_levels("detect_cells_levels", levels)
    dev = levels[0].device
    nc = sum(_n_cells(img.shape, cell) for img in levels)
    strength = torch.empty((sum(img.numel() for img in levels),),
                           dtype=torch.float32, device=dev)
    flags = torch.empty((nc,), dtype=torch.int32, device=dev)
    resp = torch.empty((nc, PER_CELL), dtype=torch.float32, device=dev)
    ys = torch.empty((nc, PER_CELL), dtype=torch.int32, device=dev)
    xs = torch.empty_like(ys)
    dy = torch.empty_like(resp)
    dx = torch.empty_like(resp)
    table = _level_arrays(levels)
    ORB_FAST(*table, cell, float(ini_th), float(min_th), strength.data_ptr(),
             flags.data_ptr())
    ORB_SELECT(*table, cell, float(ini_th), float(min_th),
               strength.data_ptr(), flags.data_ptr(), resp.data_ptr(),
               ys.data_ptr(), xs.data_ptr(), dy.data_ptr(), dx.data_ptr())
    return resp, ys, xs, dy, dx


def detect_cells(img: torch.Tensor, cell: int, ini_th: int, min_th: int):
    """Per-cell detection candidates of one level image (H, W) float32:
    ``detect_cells_levels`` of that one level."""
    return detect_cells_levels([img], cell, ini_th, min_th)


def _detect_level(img: torch.Tensor, k: int, cell: int, ini_th: int,
                  min_th: int):
    """One level -> fixed-k (ys, xs) integer winners, (ys_f, xs_f) refined
    positions and responses. Unfilled slots (k > 4 x cells) are zero."""
    resp, ys, xs, dy, dx = detect_cells(img, cell, ini_th, min_th)
    vals = resp.reshape(-1)
    top = _global_topk(vals, k)
    yi = ys.reshape(-1)[top].long()
    xi = xs.reshape(-1)[top].long()
    ys_f = yi.to(torch.float32) + dy.reshape(-1)[top]
    xs_f = xi.to(torch.float32) + dx.reshape(-1)[top]
    return (_pad_to(yi, k), _pad_to(xi, k), _pad_to(ys_f, k),
            _pad_to(xs_f, k), _pad_to(vals[top], k))


def _selection_index(level_cells: Tuple[int, ...],
                     level_k: Tuple[int, ...]):
    """Static indices of ``_select_levels`` for one plan: ``index`` (L, M)
    int64, the position of each level's candidates in the concatenated
    candidate vector, -1 past the level's own (M: the most candidates of a
    level, or the largest k if that is more); ``take`` (sum k,) int64, the
    positions of each level's first k in that matrix, flattened."""
    n = np.array([PER_CELL * c for c in level_cells])
    M = max(int(n.max()), max(level_k))
    col = np.arange(M)
    start = np.concatenate([[0], np.cumsum(n)[:-1]])
    index = np.where(col[None, :] < n[:, None], start[:, None] + col, -1)
    take = np.concatenate([lv * M + np.arange(k)
                           for lv, k in enumerate(level_k)])
    return index.astype(np.int64), take.astype(np.int64)


def _select_levels(cands, index: torch.Tensor, take: torch.Tensor):
    """Every level's global top-k of the concatenated per-cell candidates
    (``detect_cells_levels``), in level order: one stable descending sort
    of the (L, M) candidate matrix padded with -1 (``_selection_index``),
    so ties go to the lower index as in ``_global_topk``. Returns (ys, xs)
    int64 integer winners, (ys_f, xs_f) refined positions and responses,
    each (sum k,); unfilled slots (k > 4 x cells) are zero, as in
    ``_detect_level``."""
    resp, ys, xs, dy, dx = (t.reshape(-1) for t in cands)
    vals = torch.where(index >= 0, resp[index.clamp(min=0)], -1.0)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    cid = index.gather(1, order).reshape(-1)[take]
    ok = cid >= 0
    c = cid.clamp(min=0)
    yi = torch.where(ok, ys[c], 0).long()
    xi = torch.where(ok, xs[c], 0).long()
    ys_f = torch.where(ok, yi.to(torch.float32) + dy[c], 0.0)
    xs_f = torch.where(ok, xi.to(torch.float32) + dx[c], 0.0)
    return yi, xi, ys_f, xs_f, torch.where(ok, resp[c], 0.0)


# ---------------------------------------------------------------------------
# The describe kernel: window gather + IC angle + rBRIEF of one bin
# ---------------------------------------------------------------------------

def _gather_patches_plain(img: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """(K, 48, 48) raw patches whose [:43,:43] block is the 43x43 patch
    centred at integer (clamped) (ys, xs), with the image edge-replicated:
    patch[i, j] = img[clamp(y-21+i), clamp(x-21+j)]."""
    H, W = img.shape
    off = torch.arange(_RAWP, device=img.device) - RAW_R
    yt = ys.long().clamp(0, H - 1)
    xt = xs.long().clamp(0, W - 1)
    rows = (yt[:, None] + off).clamp(0, H - 1)
    cols = (xt[:, None] + off).clamp(0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def gather_patches(img: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """(K, 48, 48) float32 raw patches of one level image on the CPU (see
    ``_gather_patches_plain``). On the card the gather is part of the
    describe kernel (``describe_keypoints``), so a CUDA tensor raises."""
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError("level image must be 2-D float32")
    if ys.shape != xs.shape or ys.dim() != 1:
        raise ValueError("ys and xs must be matching 1-D index vectors")
    if img.device.type != "cpu":
        raise ValueError("gather_patches takes CPU tensors; on the card "
                         "describe_keypoints gathers inside its kernel")
    return _gather_patches_plain(img, ys, xs)


def _describe_plain(levels, ys: torch.Tensor, xs: torch.Tensor, level_k,
                    table: torch.Tensor):
    """Plain version of the describe kernel: the 48x48 raw patches of every
    level, then one dense product with the descriptor+moment operator
    (scattered back from ``table``), which scores all 32 rotation bins and
    keeps the chosen one (``_angle_and_desc``)."""
    b = np.concatenate([[0], np.cumsum(level_k)])
    patches = torch.cat([_gather_patches_plain(img, ys[b[i]:b[i + 1]],
                                               xs[b[i]:b[i + 1]])
                         for i, img in enumerate(levels)])
    return _angle_and_desc(patches, _operator_from_table(table))


def describe_keypoints(levels, ys: torch.Tensor, xs: torch.Tensor, level_k,
                       table: torch.Tensor):
    """IC angle (K,) float32 and 256-bit rBRIEF (K, 8) int64 of keypoints at
    integer level coordinates (ys, xs), each (K,): the first level_k[0] on
    levels[0], the next level_k[1] on levels[1], and so on. ``table`` is
    the sparse descriptor operator (``desc_table``).

    CPU tensors take the plain version (``_describe_plain``). CUDA tensors
    launch the describe kernel once for all levels: per keypoint, the window
    gather, the angle and the bits of the chosen rotation bin only."""
    levels = _check_levels("describe_keypoints", levels)
    level_k = [int(k) for k in level_k]
    K = sum(level_k)
    if len(level_k) != len(levels) or min(level_k) < 0:
        raise ValueError("level_k must give a count for every level")
    if ys.shape != (K,) or xs.shape != (K,):
        raise ValueError(f"ys and xs must be ({K},), got {tuple(ys.shape)} "
                         f"and {tuple(xs.shape)}")
    if table.dim() != 3 or table.shape[0] != N_ROT or table.shape[2] != 256 \
            or table.dtype != torch.int32:
        raise ValueError("table must be (32, nnz, 256) int32 (desc_table)")
    if levels[0].device.type == "cpu":
        return _describe_plain(levels, ys, xs, level_k, table)
    levels = _cuda_levels("describe_keypoints", levels)
    ys = ys.to(torch.int64).contiguous()
    xs = xs.to(torch.int64).contiguous()
    table = table.contiguous()
    require_cuda("describe_keypoints", levels[0], ys, xs, table)
    dev = levels[0].device
    ang = torch.empty((K,), dtype=torch.float32, device=dev)
    desc = torch.empty((K, 8), dtype=torch.int64, device=dev)
    n, ptrs, hs, ws = _level_arrays(levels)
    ORB_DESCRIBE(n, ptrs, hs, ws, (ctypes.c_int * n)(*level_k),
                 ys.data_ptr(), xs.data_ptr(), table.data_ptr(),
                 table.shape[1], ang.data_ptr(), desc.data_ptr())
    return ang, desc


# ---------------------------------------------------------------------------
# Operators: composed pyramid resize + blur-folded binned rBRIEF
# ---------------------------------------------------------------------------

def _gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(ksize) - ksize // 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _circular_moment_weights() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """x/y weight grids over the radius-15 circular patch (IC_Angle)."""
    r = ORI_R
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs * xs + ys * ys) <= r * r
    return (xs * mask).astype(np.float32), (ys * mask).astype(np.float32), \
        mask.astype(np.float32)


def _linear_resize_mat(n0: int, n1: int) -> np.ndarray:
    """(n1, n0) half-pixel-centre linear interpolation matrix."""
    A = np.zeros((n1, n0), np.float32)
    for i in range(n1):
        x = (i + 0.5) * n0 / n1 - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        A[i, np.clip(x0, 0, n0 - 1)] += 1.0 - f
        A[i, np.clip(x0 + 1, 0, n0 - 1)] += f
    return A


@functools.lru_cache(maxsize=8)
def _pyramid_operators(level_hw: Tuple[Tuple[int, int], ...]
                       ) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """Per-level (A, B^T) so that level_l = A @ level_0 @ B^T: the chained
    1.2x linear resizes composed once on the host."""
    ops = []
    Ah = np.eye(level_hw[0][0], dtype=np.float32)
    Aw = np.eye(level_hw[0][1], dtype=np.float32)
    for lv in range(1, len(level_hw)):
        h0, w0 = level_hw[lv - 1]
        h1, w1 = level_hw[lv]
        Ah = _linear_resize_mat(h0, h1) @ Ah
        Aw = _linear_resize_mat(w0, w1) @ Aw
        ops.append((Ah.copy(), Aw.T.copy()))
    return tuple(ops)


@functools.lru_cache(maxsize=1)
def _descriptor_operator() -> np.ndarray:
    """(48*48, N_ROT*256) operator taking a flat raw patch to the 256
    comparison scores (t2 - t1) for every rotation bin, with the 7x7 sigma-2
    Gaussian blur folded in. Descriptor bit s = score > 0."""
    pat = orb_pattern().astype(np.float64)              # (256, 4)
    g = _gaussian_kernel1d()
    G2 = np.outer(g, g)                                 # (7, 7)
    D = np.zeros((N_ROT, _RAWP * _RAWP, 256), np.float32)
    for b in range(N_ROT):
        th = 2.0 * np.pi * b / N_ROT
        ca, sa = np.cos(th), np.sin(th)
        for (cx, cy), sign in (((pat[:, 2], pat[:, 3]), 1.0),
                               ((pat[:, 0], pat[:, 1]), -1.0)):
            rx = np.clip(np.round(cx * ca - cy * sa), -PATCH_R, PATCH_R)
            ry = np.clip(np.round(cx * sa + cy * ca), -PATCH_R, PATCH_R)
            rx = rx.astype(np.int64)
            ry = ry.astype(np.int64)
            for dy in range(-BLUR_R, BLUR_R + 1):
                for dx in range(-BLUR_R, BLUR_R + 1):
                    idx = (ry + dy + RAW_R) * _RAWP + (rx + dx + RAW_R)
                    np.add.at(D[b], (idx, np.arange(256)),
                              sign * G2[dy + BLUR_R, dx + BLUR_R])
    return D.transpose(1, 0, 2).reshape(_RAWP * _RAWP, N_ROT * 256)


@functools.lru_cache(maxsize=1)
def _moment_operator() -> np.ndarray:
    """(48*48, 2) operator: flat raw patch -> (m10, m01) intensity-centroid
    moments over the central radius-15 circular patch."""
    wx31, wy31, _ = _circular_moment_weights()
    o = RAW_R - ORI_R
    WX = np.zeros((_RAWP, _RAWP), np.float32)
    WY = np.zeros((_RAWP, _RAWP), np.float32)
    WX[o:o + 2 * ORI_R + 1, o:o + 2 * ORI_R + 1] = wx31
    WY[o:o + 2 * ORI_R + 1, o:o + 2 * ORI_R + 1] = wy31
    return np.stack([WX.ravel(), WY.ravel()], axis=1)


@functools.lru_cache(maxsize=1)
def _desc_and_moment_operator() -> np.ndarray:
    """Descriptor operator with the two moment columns appended: one product
    yields the comparison scores and (m10, m01)."""
    return np.concatenate([_descriptor_operator(), _moment_operator()],
                          axis=1)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bf16 (nearest even) and keep them float32:
    the product of two such values is exact in float32, so a float32 matmul
    of rounded operands is a bf16-operand product with float32 accumulation
    and output."""
    return x.to(torch.bfloat16).to(torch.float32)


def desc_operator(device) -> torch.Tensor:
    """The (2304, 8194) descriptor+moment operator, bf16-rounded, float32,
    on ``device``."""
    return _bf16_round(torch.as_tensor(_desc_and_moment_operator(),
                                       device=device))


@functools.lru_cache(maxsize=1)
def _desc_table() -> np.ndarray:
    """(N_ROT, nnz, 256) uint32 sparse form of the bf16-rounded descriptor
    operator: for each (bin, bit), its non-zero entries in increasing
    offset, each one word (bf16 bits of the coefficient << 16 | offset in
    the 43x43 window), padded with zero words to the largest count."""
    dense = _bf16_round(torch.as_tensor(_descriptor_operator())).numpy()
    cols = dense.T.reshape(N_ROT, 256, _RAWP * _RAWP)    # (bin, bit, offset)
    nz = cols != 0
    nnz = int(nz.sum(axis=-1).max())
    order = np.argsort(~nz, axis=-1, kind="stable")[..., :nnz]
    coef = np.take_along_axis(cols, order, axis=-1).view(np.uint32)
    keep = np.take_along_axis(nz, order, axis=-1)
    row, col = np.divmod(order, _RAWP)
    if (row[keep] >= _WIN).any() or (col[keep] >= _WIN).any() \
            or (coef & 0xFFFF).any():
        raise AssertionError("descriptor operator outside the 43x43 window "
                             "or not bf16")
    words = np.where(keep, coef | (row * _WIN + col).astype(np.uint32), 0)
    return np.ascontiguousarray(words.transpose(0, 2, 1), dtype=np.uint32)


def desc_table(device) -> torch.Tensor:
    """The sparse descriptor operator (``_desc_table``) as (N_ROT, nnz, 256)
    int32 on ``device``: what the describe kernel reads."""
    return torch.tensor(_desc_table().view(np.int32), device=device)


def _operator_from_table(table: torch.Tensor) -> torch.Tensor:
    """The dense (2304, 8194) descriptor+moment operator from its sparse
    table: equal to ``desc_operator`` (the moment columns are integers,
    exact in bf16)."""
    dev = table.device
    off = (table & 0xFFFF).long()
    coef = (table & -0x10000).view(torch.float32)
    rows = (off // _WIN) * _RAWP + off % _WIN
    cols = (torch.arange(N_ROT, device=dev)[:, None, None] * 256
            + torch.arange(256, device=dev)).expand_as(rows)
    dense = torch.zeros((_RAWP * _RAWP, N_ROT * 256), dtype=torch.float32,
                        device=dev)
    # zero padding words add +0 at offset 0, which leaves any entry there
    dense.index_put_((rows.reshape(-1), cols.reshape(-1)), coef.reshape(-1),
                     accumulate=True)
    return torch.cat([dense, torch.as_tensor(_moment_operator(),
                                             device=dev)], dim=1)


def pyramid_operators(level_hw, device):
    """Per-level (A, B^T) pyramid operators, bf16-rounded, float32, on
    ``device``."""
    return tuple((_bf16_round(torch.as_tensor(A, device=device)),
                  _bf16_round(torch.as_tensor(Bt, device=device)))
                 for A, Bt in _pyramid_operators(tuple(level_hw)))


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,256) {0,1} -> (N,8) int64 words of 32 bits each."""
    bits = bits.reshape(-1, 8, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return torch.sum(bits << shifts, dim=-1)


def _angle_and_desc(raw_patches: torch.Tensor, desc_op: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IC angle + blur-folded rBRIEF from raw patches: one product of the
    bf16-rounded flat patches with the operator, float32 accumulation and
    output (the moment columns must stay float32: bf16 moments would move
    the angle)."""
    flat = raw_patches.reshape(raw_patches.shape[0], -1)
    fused = _bf16_round(flat) @ desc_op
    scores = fused[:, :N_ROT * 256]
    mom = fused[:, N_ROT * 256:]
    ang = torch.atan2(mom[:, 1], mom[:, 0])
    bins = torch.remainder(
        torch.round(ang * (N_ROT / (2.0 * np.pi))).to(torch.int64), N_ROT)
    sc = scores.reshape(scores.shape[0], N_ROT, 256)
    t = torch.gather(sc, 1, bins[:, None, None].expand(-1, 1, 256))[:, 0, :]
    return ang, _pack_bits(t > 0)


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

def pyramid_level(image: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor
                  ) -> torch.Tensor:
    """One pyramid level from level 0: bf16 operands, float32 accumulation,
    the intermediate rounded to bf16 before the second product."""
    return _bf16_round(A @ _bf16_round(image)) @ Bt


class OrbOperators(NamedTuple):
    """The static operators of one extractor plan, on one device
    (``orb_operators``)."""

    pyr: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # levels 1..: (A, B^T)
    desc_table: torch.Tensor   # (N_ROT, nnz, 256) int32 (``desc_table``)
    sel_index: torch.Tensor    # (L, M) int64 (``_selection_index``)
    sel_take: torch.Tensor     # (n_features,) int64
    kp_level: torch.Tensor     # (n_features,) int64 pyramid level of a row
    kp_scale: torch.Tensor     # (n_features,) float32 level -> level 0


def orb_operators(params: OrbParams, device) -> OrbOperators:
    """Build the operators of ``params`` on ``device``."""
    cells = tuple(_n_cells(hw, params.cell) for hw in params.level_hw)
    index, take = _selection_index(cells, params.level_k)
    scale = [params.scale_factor ** lv for lv in range(params.n_levels)]

    def dev(a):
        return torch.as_tensor(a, device=device)

    return OrbOperators(
        pyr=pyramid_operators(params.level_hw, device),
        desc_table=desc_table(device), sel_index=dev(index),
        sel_take=dev(take),
        kp_level=dev(np.repeat(np.arange(params.n_levels), params.level_k)),
        kp_scale=dev(np.repeat(np.array(scale, np.float32), params.level_k)))


def extract_orb(params: OrbParams, cam: CubemapCamera, image: torch.Tensor,
                mask: Optional[torch.Tensor], ini_th: int, min_th: int,
                ops: OrbOperators) -> Keypoints:
    """Extract ORB keypoints+descriptors from a cubemap-cross image.

    image: (H, W) float32. mask: optional (H, W) {0,1}; keypoints on zero
    pixels are culled. ops: the plan's operators on the image's device
    (``orb_operators``); ``OrbExtractor`` builds them once.

    The pyramid first (it depends only on level 0), then kernel D over all
    levels, the per-level global top-k, and the describe kernel over all
    keypoints; CPU tensors take the kernels' plain versions. Each step is a
    span (``extract.pyramid``, ``.detect``, ``.select``, ``.describe``,
    ``.rays``: the coordinates, culls and rays), so a captured graph's
    census names its operations.
    """
    with span("extract.pyramid"):
        levels = [image] + [pyramid_level(image, A, Bt) for A, Bt in ops.pyr]
    with span("extract.detect"):
        cands = detect_cells_levels(levels, params.cell, ini_th, min_th)
    with span("extract.select"):
        ys, xs, ys_f, xs_f, resp = _select_levels(cands, ops.sel_index,
                                                  ops.sel_take)
    with span("extract.describe"):
        ang, desc = describe_keypoints(levels, ys, xs, params.level_k,
                                       ops.desc_table)
    with span("extract.rays"):
        uv = torch.stack([xs_f * ops.kp_scale, ys_f * ops.kp_scale], dim=-1)
        lvl = ops.kp_level.clone()

        valid = resp > 0
        face = C.face_from_cubemap_uv(cam, uv)
        valid = valid & (face != C.UNKNOWN_FACE)
        if mask is not None:
            mu = uv[:, 0].to(torch.int64).clamp(0, image.shape[1] - 1)
            mv = uv[:, 1].to(torch.int64).clamp(0, image.shape[0] - 1)
            valid = valid & (mask[mv, mu] > 0)
        face = torch.where(valid, face,
                           torch.full_like(face, C.UNKNOWN_FACE))
        rays, _ = C.cubemap_to_ray(cam, uv)
        rays = torch.where(valid[:, None], rays, torch.zeros_like(rays))
        return Keypoints(uv=uv, response=resp, angle=ang, level=lvl,
                         face=face, desc=desc, rays=rays, valid=valid)


class OrbExtractor(nn.Module):
    """``extract_orb`` bound to one image geometry and its thresholds, with
    its operators (``orb_operators``) built once as buffers on the camera's
    device. ``forward(image, mask=None)`` -> ``Keypoints``."""

    def __init__(self, params: OrbParams, cam: CubemapCamera, ini_th: int,
                 min_th: int):
        super().__init__()
        self.params, self.cam = params, cam
        self.ini_th, self.min_th = ini_th, min_th
        ops = orb_operators(params, cam.device)
        for lv, (A, Bt) in enumerate(ops.pyr, start=1):
            self.register_buffer(f"pyr_a{lv}", A)
            self.register_buffer(f"pyr_bt{lv}", Bt)
        for name in OrbOperators._fields[1:]:
            self.register_buffer(name, getattr(ops, name))

    @property
    def ops(self) -> OrbOperators:
        pyr = tuple((getattr(self, f"pyr_a{lv}"), getattr(self, f"pyr_bt{lv}"))
                    for lv in range(1, self.params.n_levels))
        return OrbOperators(pyr, *(getattr(self, name)
                                   for name in OrbOperators._fields[1:]))

    def forward(self, image: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Keypoints:
        return extract_orb(self.params, self.cam, image, mask, self.ini_th,
                           self.min_th, self.ops)


def build_extractor(cfg, cam: CubemapCamera, n_features: int,
                    image_hw: Tuple[int, int]):
    """Return an extractor specialised to one image geometry (an
    ``OrbExtractor``, called as ``run(image, mask=None)``) and its plan."""
    params = plan_levels(n_features, cfg.n_levels, cfg.scale_factor, image_hw)
    return OrbExtractor(params, cam, cfg.ini_th_fast, cfg.min_th_fast), params
