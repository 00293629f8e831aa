"""Batched fixed-shape ORB extractor in PyTorch, with kernels D and G.

Counterpart of ``cubemapslam_tpu/features/extractor.py``: an 8-level x1.2
pyramid, FAST-9/16 with per-cell adaptive ini/min thresholds 20/7,
grid-bucketed NMS (3x3 local max, per-cell top-4, global top-K per level),
quadratic subpixel refinement, intensity-centroid orientation and 256-bit
blur-folded rBRIEF, coordinates scaled to level 0 and cubemap-face + mask
culling.

The port follows the JAX package's CPU path, which is exact; the TPU detect
kernel's slab-halo and fixed-cell approximations are layout artefacts of the
TPU and are not reproduced. Two TPU kernels become CUDA kernels here:

* kernel D (``csrc/orb_detect.cu``, replaces ``_detect_kernel``): FAST
  strength with the per-cell fallback flags, then merge, 3x3 NMS, border
  mask, per-cell top-4 and subpixel offsets. ``_detect_cells_plain`` is its
  plain version.
* kernel G (``csrc/patch_gather.cu``, replaces ``_gather_kernel``): the
  48x48 raw-patch gather around each keypoint from the edge-replicated level
  image. ``_gather_patches_plain`` is its plain version.

The pyramid and the descriptor+moment operator are plain matrix products
(``torch.matmul``), as the JAX package leaves them to XLA. They reproduce
its bf16 operand rounding with float32 accumulation and float32 output: the
operands are rounded to bf16 and multiplied as float32 with TF32 off.
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
N_ROT = 32                # steered-BRIEF rotation bins (11.25 deg)
PER_CELL = 4              # detection survivors per cell

_P, _I = ctypes.c_void_p, ctypes.c_int

_F = ctypes.c_float

# kernel D is two launches, each with its own counter
ORB_FAST = CudaKernel("orb_detect.cu", "fast_strength_launch",
                      [_P, _P, _P, _I, _I, _I, _F])
ORB_SELECT = CudaKernel("orb_detect.cu", "detect_select_launch",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F])
PATCH_GATHER = CudaKernel("patch_gather.cu", "patch_gather_launch",
                          [_P, _P, _P, _P, _I, _I, _I])


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


def detect_cells(img: torch.Tensor, cell: int, ini_th: int, min_th: int):
    """Per-cell detection candidates of one level image (H, W) float32 (see
    ``_detect_cells_plain``). A CPU tensor takes the plain version; a CUDA
    tensor launches kernel D (two passes: FAST strength with per-cell
    any-strong flags, then merge/NMS/border/top-4/subpixel per cell)."""
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"level image must be 2-D float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if img.device.type == "cpu":
        return _detect_cells_plain(img, cell, ini_th, min_th)
    img = img.contiguous()
    require_cuda("detect_cells", img)
    H, W = img.shape
    if not 4 <= cell <= 64:
        raise ValueError(f"kernel D supports cells of 4..64 px, got {cell}")
    nc = (-(-H // cell)) * (-(-W // cell))
    dev = img.device
    strength = torch.empty((H, W), dtype=torch.float32, device=dev)
    flags = torch.empty((nc,), dtype=torch.int32, device=dev)
    resp = torch.empty((nc, PER_CELL), dtype=torch.float32, device=dev)
    ys = torch.empty((nc, PER_CELL), dtype=torch.int32, device=dev)
    xs = torch.empty_like(ys)
    dy = torch.empty_like(resp)
    dx = torch.empty_like(resp)
    ORB_FAST(img.data_ptr(), strength.data_ptr(), flags.data_ptr(), H, W,
             cell, float(ini_th))
    ORB_SELECT(strength.data_ptr(), flags.data_ptr(), resp.data_ptr(),
               ys.data_ptr(), xs.data_ptr(), dy.data_ptr(), dx.data_ptr(), H,
               W, cell, float(ini_th), float(min_th))
    return resp, ys, xs, dy, dx


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


# ---------------------------------------------------------------------------
# Kernel G: raw-patch gather
# ---------------------------------------------------------------------------

def _gather_patches_plain(img: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G: (K, 48, 48) raw patches whose [:43,:43]
    block is the 43x43 patch centred at integer (clamped) (ys, xs), with the
    image edge-replicated: patch[i, j] = img[clamp(y-21+i), clamp(x-21+j)].
    """
    H, W = img.shape
    off = torch.arange(_RAWP, device=img.device) - RAW_R
    yt = ys.long().clamp(0, H - 1)
    xt = xs.long().clamp(0, W - 1)
    rows = (yt[:, None] + off).clamp(0, H - 1)
    cols = (xt[:, None] + off).clamp(0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def gather_patches(img: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """(K, 48, 48) float32 raw patches of one level image (see
    ``_gather_patches_plain``). A CPU tensor takes the plain version; a CUDA
    tensor launches kernel G."""
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError("level image must be 2-D float32")
    if ys.shape != xs.shape or ys.dim() != 1:
        raise ValueError("ys and xs must be matching 1-D index vectors")
    if img.device.type == "cpu":
        return _gather_patches_plain(img, ys, xs)
    img = img.contiguous()
    ys32 = ys.to(torch.int32).contiguous()
    xs32 = xs.to(torch.int32).contiguous()
    require_cuda("gather_patches", img, ys32, xs32)
    H, W = img.shape
    K = ys.shape[0]
    out = torch.empty((K, _RAWP, _RAWP), dtype=torch.float32,
                      device=img.device)
    PATCH_GATHER(img.data_ptr(), ys32.data_ptr(), xs32.data_ptr(),
                 out.data_ptr(), K, H, W)
    return out


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


def extract_orb(params: OrbParams, cam: CubemapCamera, image: torch.Tensor,
                mask: Optional[torch.Tensor], ini_th: int, min_th: int,
                desc_op: torch.Tensor, pyr_ops) -> Keypoints:
    """Extract ORB keypoints+descriptors from a cubemap-cross image.

    image: (H, W) float32. mask: optional (H, W) {0,1}; keypoints on zero
    pixels are culled. desc_op / pyr_ops: the operators on the image's
    device (``desc_operator`` / ``pyramid_operators``); ``OrbExtractor``
    builds them once.
    """
    dev = image.device
    uv_all, resp_all, lvl_all, patches = [], [], [], []
    for lv in range(params.n_levels):
        if lv == 0:
            img_l = image
        else:
            A, Bt = pyr_ops[lv - 1]
            img_l = pyramid_level(image, A, Bt)
        k = params.level_k[lv]
        ys, xs, ys_f, xs_f, resp = _detect_level(img_l, k, params.cell,
                                                 ini_th, min_th)
        patches.append(gather_patches(img_l, ys, xs))
        s = params.scale_factor ** lv
        uv_all.append(torch.stack([xs_f * s, ys_f * s], dim=-1))
        resp_all.append(resp)
        lvl_all.append(torch.full((k,), lv, dtype=torch.int64, device=dev))

    # one descriptor product for all levels (rows are independent)
    ang, desc = _angle_and_desc(torch.cat(patches), desc_op)
    uv = torch.cat(uv_all)
    resp = torch.cat(resp_all)
    lvl = torch.cat(lvl_all)

    valid = resp > 0
    face = C.face_from_cubemap_uv(cam, uv)
    valid = valid & (face != C.UNKNOWN_FACE)
    if mask is not None:
        mu = uv[:, 0].to(torch.int64).clamp(0, image.shape[1] - 1)
        mv = uv[:, 1].to(torch.int64).clamp(0, image.shape[0] - 1)
        valid = valid & (mask[mv, mu] > 0)
    face = torch.where(valid, face, torch.full_like(face, C.UNKNOWN_FACE))
    rays, _ = C.cubemap_to_ray(cam, uv)
    rays = torch.where(valid[:, None], rays, torch.zeros_like(rays))
    return Keypoints(uv=uv, response=resp, angle=ang, level=lvl, face=face,
                     desc=desc, rays=rays, valid=valid)


class OrbExtractor(nn.Module):
    """``extract_orb`` bound to one image geometry and its thresholds, with
    the descriptor and pyramid operators built once as buffers on the
    camera's device. ``forward(image, mask=None)`` -> ``Keypoints``."""

    def __init__(self, params: OrbParams, cam: CubemapCamera, ini_th: int,
                 min_th: int):
        super().__init__()
        self.params, self.cam = params, cam
        self.ini_th, self.min_th = ini_th, min_th
        self.register_buffer("desc_op", desc_operator(cam.device))
        for lv, (A, Bt) in enumerate(
                pyramid_operators(params.level_hw, cam.device), start=1):
            self.register_buffer(f"pyr_a{lv}", A)
            self.register_buffer(f"pyr_bt{lv}", Bt)

    @property
    def pyr_ops(self):
        """Per-level (A, B^T) for levels 1 .. n_levels-1."""
        return tuple((getattr(self, f"pyr_a{lv}"),
                      getattr(self, f"pyr_bt{lv}"))
                     for lv in range(1, self.params.n_levels))

    def forward(self, image: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Keypoints:
        return extract_orb(self.params, self.cam, image, mask, self.ini_th,
                           self.min_th, self.desc_op, self.pyr_ops)


def build_extractor(cfg, cam: CubemapCamera, n_features: int,
                    image_hw: Tuple[int, int]):
    """Return an extractor specialised to one image geometry (an
    ``OrbExtractor``, called as ``run(image, mask=None)``) and its plan."""
    params = plan_levels(n_features, cfg.n_levels, cfg.scale_factor, image_hw)
    return OrbExtractor(params, cam, cfg.ini_th_fast, cfg.min_th_fast), params
