"""The reference warp and ORB extractor, every pyramid level, in plain
PyTorch (on the host or the card, float64), written from the extractor's
stated semantics:

* the warp: each cross pixel samples the fisheye bilinearly at the
  coordinates the camera model gives it (float64 here), the top-left
  corner clipped to the image while the fractions keep the unclipped
  floor; 0 off the faces and outside the fisheye image;
* the pyramid: 8 levels, each 1/1.2 the side of the one above (rounded),
  made from level 0 by the chained linear resizes (half-pixel centres),
  composed into one operator a level and applied to rows and columns;
  level 0, the operators and the row pass are taken at bfloat16, as the
  configuration states; the keypoint budget split geometrically over the
  levels;
* on every level: FAST-9/16 strength (the largest threshold at which 9
  contiguous circle pixels are all brighter or all darker; neighbours
  wrap at the image edge), the threshold 20 in every 32 px cell that has
  a corner at it and 7 elsewhere, 3x3 non-maximum suppression, a 19 px
  border, the 4 strongest of each cell (ties to the lower row-major
  offset), the level's k strongest of those (ties to the lower cell), and
  a parabola through the unsuppressed responses for the sub-pixel
  position;
* orientation by the intensity centroid over a radius-15 disc and a
  256-bit steered BRIEF over a 7x7 sigma-2 Gaussian blur, the pattern
  turned to the nearest of 32 angles; the patch and the blur-folded
  comparison weights are taken at bfloat16, as the configuration states;
* a keypoint is kept on a face, inside the field of view, judged at its
  position scaled to level 0.

``levels`` computes all of it in one of two precisions: ``"reference"``
(float64 arithmetic, the stated bfloat16 operands) and ``"control"`` (the
precision below each stated one: the warped image rounded to bfloat16,
the pyramid's and the descriptor's operands to float8 e4m3), which
``compare`` must find wrong."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.reference import camera as C

CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
          (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
          (-2, -2), (-1, -3))
BORDER = 19
CELL = 32
PER_CELL = 4
PATCH_R = 18          # reach of the turned pattern
BLUR_R = 3
RAW_R = PATCH_R + BLUR_R
ORI_R = 15
N_ROT = 32
PATTERN_SEED = 20180510
PATTERN_R = 13


class Level(NamedTuple):
    """One pyramid level's keypoints, in that level's pixels: the rows of a
    frame's that the plan gives the level."""

    uv: np.ndarray        # (k, 2) float64 sub-pixel (u, v)
    ij: np.ndarray        # (k, 2) int64 integer (x, y)
    response: np.ndarray  # (k,) float64, 0 for an unfilled row
    angle: np.ndarray     # (k,) float64 radians
    desc: np.ndarray      # (k, 256) bool
    valid: np.ndarray     # (k,) bool


class Plan(NamedTuple):
    """The pyramid: each level's (H, W), its share of the keypoint budget
    (geometric in the scale, the last level taking the rest) and its scale
    to level 0."""

    hw: tuple
    k: tuple
    scale: tuple


def plan(fields: dict) -> Plan:
    n, L = fields["n_features"], fields["n_levels"]
    sf = fields["scale_factor"]
    side = 3 * fields["cube_face_w"]
    f = 1.0 / sf
    k0 = n * (1 - f) / (1 - f ** L)
    ks = [int(round(k0 * f ** lv)) for lv in range(L)]
    ks[-1] = max(n - sum(ks[:-1]), 0)
    hw = tuple((int(round(side * (1.0 / sf ** lv))),) * 2
               for lv in range(L))
    return Plan(hw, tuple(ks), tuple(sf ** lv for lv in range(L)))


def resize_matrix(n0: int, n1: int) -> np.ndarray:
    """(n1, n0) linear resize with half-pixel centres, the edge clamped."""
    A = np.zeros((n1, n0))
    for i in range(n1):
        x = (i + 0.5) * n0 / n1 - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        A[i, min(max(x0, 0), n0 - 1)] += 1.0 - f
        A[i, min(max(x0 + 1, 0), n0 - 1)] += f
    return A


def pyramid_operators(p: Plan):
    """For each level past the first, the float64 operator that takes level
    0's rows (and, transposed, columns) to it: the chained 1.2x linear
    resizes composed (the pyramid's levels are square)."""
    ops, A = [], np.eye(p.hw[0][0])
    for lv in range(1, len(p.hw)):
        A = resize_matrix(p.hw[lv - 1][0], p.hw[lv][0]) @ A
        ops.append(A.copy())
    return ops


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.bfloat16).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.float8_e4m3fn).to(x.dtype)


class Warp(NamedTuple):
    i00: torch.Tensor     # (n, n) int64 flat index of the top-left texel
    w: torch.Tensor       # (n, n, 4) float64 weights, 0 where invalid
    fov: torch.Tensor     # (n, n) bool: keypoints may lie here
    width: int


def make_warp(cam: C.Camera, device="cpu") -> Warp:
    xy, ok = C.warp_coords(cam, torch.float64, device)
    W, H = cam.fisheye_w, cam.fisheye_h
    x = torch.where(ok, xy[..., 0], torch.full_like(xy[..., 0], -1.0))
    y = torch.where(ok, xy[..., 1], torch.full_like(xy[..., 1], -1.0))
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    i00 = (y0.long().clamp(0, H - 2) * W + x0.long().clamp(0, W - 2))
    w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy,
                     fx * fy], dim=-1)
    w = torch.where(ok[..., None], w, torch.zeros_like(w))
    return Warp(i00, w, C.fov_cross(cam, device=device) & (C.face_of_cross(
        cam, _grid(3 * cam.face_w, device)) >= 0), W)


def _grid(n, device="cpu"):
    ax = torch.arange(n, dtype=torch.float64, device=device)
    vv, uu = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def warp(frame_u8: np.ndarray, wp: Warp) -> torch.Tensor:
    flat = torch.as_tensor(frame_u8).reshape(-1).to(wp.w.device,
                                                     torch.float64)
    W = wp.width
    g = torch.stack([flat[wp.i00], flat[wp.i00 + 1], flat[wp.i00 + W],
                     flat[wp.i00 + W + 1]], dim=-1)
    return (wp.w * g).sum(-1)


def fast_strength(img: torch.Tensor) -> torch.Tensor:
    ds = [torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) - img
          for dx, dy in CIRCLE]
    best = None
    for d in (ds, [-x for x in ds]):
        # the least of d[i..i+8] for every start i, by doubling
        m2 = [torch.minimum(d[i], d[(i + 1) % 16]) for i in range(16)]
        m4 = [torch.minimum(m2[i], m2[(i + 2) % 16]) for i in range(16)]
        del m2
        m8 = [torch.minimum(m4[i], m4[(i + 4) % 16]) for i in range(16)]
        del m4
        for i in range(16):
            run = torch.minimum(m8[i], d[(i + 8) % 16])
            best = run if best is None else torch.maximum(best, run)
        del m8
    return best


def fast_response(img: torch.Tensor, ini_th: float, min_th: float):
    s = fast_strength(img)
    H, W = img.shape
    hc, wc = -(-H // CELL), -(-W // CELL)
    strong = torch.nn.functional.pad(s > ini_th, (0, wc * CELL - W,
                                                  0, hc * CELL - H))
    any_c = strong.reshape(hc, CELL, wc, CELL).any(3).any(1)
    full = any_c.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)[:H, :W]
    corner = torch.where(full, s > ini_th, s > min_th)
    return torch.where(corner, s, torch.zeros_like(s))


def select(raw: torch.Tensor, k: int):
    """NMS, border, per-cell top 4, global top k: (y, x, response)."""
    H, W = raw.shape
    p = torch.nn.functional.pad(raw[None, None], (1, 1, 1, 1),
                                value=-float("inf"))
    nb = torch.nn.functional.max_pool2d(p, 3, stride=1)[0, 0]
    score = torch.where(raw >= nb, raw, torch.zeros_like(raw))
    keep = torch.zeros_like(score)
    keep[BORDER:H - BORDER, BORDER:W - BORDER] = \
        score[BORDER:H - BORDER, BORDER:W - BORDER]
    hc, wc = -(-H // CELL), -(-W // CELL)
    pad = torch.nn.functional.pad(keep, (0, wc * CELL - W, 0, hc * CELL - H))
    cells = pad.reshape(hc, CELL, wc, CELL).permute(0, 2, 1, 3).reshape(
        hc * wc, CELL * CELL)
    val, arg = torch.sort(cells, dim=1, descending=True, stable=True)
    val, arg = val[:, :PER_CELL].reshape(-1), arg[:, :PER_CELL]
    cy = torch.arange(hc, device=raw.device).repeat_interleave(wc)[:, None]
    cx = torch.arange(wc, device=raw.device).repeat(hc)[:, None]
    ys = (cy * CELL + arg // CELL).reshape(-1)
    xs = (cx * CELL + arg % CELL).reshape(-1)
    top = torch.sort(val, descending=True, stable=True).indices[:k]
    n = len(top)
    out = [torch.zeros(k, dtype=t.dtype, device=raw.device)
           for t in (ys, xs, val)]
    for o, t in zip(out, (ys, xs, val)):
        o[:n] = t[top]
    return out


def subpixel(raw: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    H, W = raw.shape
    pad = torch.nn.functional.pad(raw, (1, 1, 1, 1))

    def at(y, x):
        return pad[y.clamp(0, H + 1), x.clamp(0, W + 1)]

    yp, xp = ys + 1, xs + 1
    c = at(yp, xp)
    xm, xq = at(yp, xp - 1), at(yp, xp + 1)
    ym, yq = at(yp - 1, xp), at(yp + 1, xp)
    out = []
    for lo, hi in ((ym, yq), (xm, xq)):
        den = 2.0 * c - lo - hi
        off = torch.where(den.abs() > 1e-6,
                          0.5 * (hi - lo) / den.clamp(min=1e-6),
                          torch.zeros_like(c))
        out.append(off.clamp(-0.5, 0.5))
    return out


def pattern() -> np.ndarray:
    """The 256 (x1, y1, x2, y2) pairs of the steered BRIEF test: Gaussian
    BRIEF points (sigma = patch / 5), rounded, clipped to the 27 px patch,
    no pair of one point, from a fixed seed."""
    rs = np.random.RandomState(PATTERN_SEED)
    sigma = (2 * PATTERN_R + 1) / 5.0
    pairs = []
    while len(pairs) < 256:
        p = np.clip(np.round(rs.normal(0.0, sigma, size=4)), -PATTERN_R,
                    PATTERN_R).astype(np.int64)
        if p[0] == p[2] and p[1] == p[3]:
            continue
        pairs.append(p)
    return np.stack(pairs)


def comparison_weights() -> np.ndarray:
    """(N_ROT, 256, 43, 43) float32: for each angle and bit, the weights
    over the 43 x 43 window whose sum against the patch is the blurred
    second point less the blurred first (each float32 sum of the two
    points' Gaussian taps, as the extractor folds them)."""
    pat = pattern().astype(np.float64)
    x = np.arange(2 * BLUR_R + 1) - BLUR_R
    g = np.exp(-0.5 * (x / 2.0) ** 2)
    g = (g / g.sum()).astype(np.float32)
    g2 = np.outer(g, g)
    n = 2 * RAW_R + 1
    out = np.zeros((N_ROT, 256, n, n), np.float32)
    bits = np.arange(256)
    for b in range(N_ROT):
        th = 2.0 * np.pi * b / N_ROT
        ca, sa = np.cos(th), np.sin(th)
        for (px, py), sign in (((pat[:, 2], pat[:, 3]), 1.0),
                               ((pat[:, 0], pat[:, 1]), -1.0)):
            rx = np.clip(np.round(px * ca - py * sa), -PATCH_R,
                         PATCH_R).astype(np.int64)
            ry = np.clip(np.round(px * sa + py * ca), -PATCH_R,
                         PATCH_R).astype(np.int64)
            for dy in range(-BLUR_R, BLUR_R + 1):
                for dx in range(-BLUR_R, BLUR_R + 1):
                    np.add.at(out[b], (bits, ry + dy + RAW_R,
                                       rx + dx + RAW_R),
                              sign * g2[dy + BLUR_R, dx + BLUR_R])
    return out


def describe(img: torch.Tensor, ys, xs, weights: torch.Tensor,
             operand) -> tuple:
    """(angle, (k, 256) bits) at integer positions, the window edge-
    replicated; ``operand`` rounds the patch and the weights."""
    H, W = img.shape
    dev = img.device
    off = torch.arange(2 * RAW_R + 1, device=dev) - RAW_R
    rows = (ys.clamp(0, H - 1)[:, None] + off).clamp(0, H - 1)
    cols = (xs.clamp(0, W - 1)[:, None] + off).clamp(0, W - 1)
    P = operand(img[rows[:, :, None], cols[:, None, :]])     # (k, 43, 43)
    r = torch.arange(-ORI_R, ORI_R + 1, dtype=torch.float64, device=dev)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    disc = (dx * dx + dy * dy) <= ORI_R * ORI_R
    o = RAW_R - ORI_R
    C31 = P[:, o:o + 2 * ORI_R + 1, o:o + 2 * ORI_R + 1]
    m10 = (C31 * (dx * disc)).sum((1, 2))
    m01 = (C31 * (dy * disc)).sum((1, 2))
    ang = torch.atan2(m01, m10)
    b = torch.remainder(torch.round(ang * (N_ROT / (2 * np.pi))).long(),
                        N_ROT)
    score = torch.empty((len(b), 256), dtype=torch.float64, device=dev)
    for s in range(0, len(b), 32):
        w = operand(weights[b[s:s + 32]]).to(torch.float64)
        score[s:s + 32] = torch.einsum("kbij,kij->kb", w, P[s:s + 32])
    return ang, score > 0


def pyramid(img: torch.Tensor, ops, operand) -> list:
    """Level 0 and the levels below it: each the composed operator applied
    to level 0's rows and columns, with the operands (level 0, the operator,
    the row pass) rounded by ``operand`` and float64 sums."""
    out = [img]
    x = operand(img)
    for A in ops:
        A = operand(A.to(img.device, torch.float64))
        out.append(operand(A @ x) @ A.T)
    return out


def levels(frame_u8: np.ndarray, wp: Warp, p: Plan, ops, ini_th: float,
           min_th: float, weights: torch.Tensor,
           precision: str = "reference") -> list:
    """Every level's keypoints (``Level``) of one frame. ``ops`` are
    ``pyramid_operators(p)`` as tensors."""
    img = warp(frame_u8, wp)
    operand = bf16
    if precision == "control":
        img, operand = bf16(img), fp8
    elif precision != "reference":
        raise ValueError(precision)
    out = []
    n = wp.fov.shape[0]
    w = weights.to(img.device)
    for lv, im in enumerate(pyramid(img, ops, operand)):
        raw = fast_response(im, ini_th, min_th)
        ys, xs, resp = select(raw, p.k[lv])
        dy, dx = subpixel(raw, ys, xs)
        uv = torch.stack([xs + dx, ys + dy], dim=-1)
        ang, bits = describe(im, ys, xs, w, operand)
        uv0 = uv * p.scale[lv]
        mu = uv0[:, 0].long().clamp(0, n - 1)
        mv = uv0[:, 1].long().clamp(0, n - 1)
        valid = (resp > 0) & wp.fov[mv, mu]
        out.append(Level(*(t.cpu().numpy() for t in (
            uv, torch.stack([xs, ys], -1), resp, ang, bits, valid))))
    return out


def split(got: dict, p: Plan) -> list:
    """A frame's keypoint rows (level-0 pixels) as one dict a level, each
    in its level's pixels."""
    out, r = [], 0
    for lv, k in enumerate(p.k):
        d = {key: np.asarray(v)[r:r + k] for key, v in got.items()
             if v is not None}
        d["uv"] = np.asarray(d["uv"], np.float64) / p.scale[lv]
        out.append(d)
        r += k
    return out


def unpack(desc_words: np.ndarray) -> np.ndarray:
    """(k, 8) int64 words -> (k, 256) bool, bit 32 w + j = bit j of w."""
    w = np.asarray(desc_words, np.int64) & 0xFFFFFFFF
    return ((w[:, :, None] >> np.arange(32)) & 1).reshape(len(w), 256) > 0


# gaps above these count as a twin that disagrees
UV_TOL_PX = 0.01
ANGLE_TOL_RAD = 0.01
RESP_TOL = 0.01


def tally(got: dict, ref: Level) -> dict:
    """One level's counts: valid keypoints of either side (``n``), those
    without a twin on the other (the same pixel; ``alone``), twins
    (``twins``), and of the twins those whose sub-pixel positions (``uv``),
    angles (``angle``) or responses (``resp``, where ``got`` has them)
    differ beyond a tolerance, and the descriptor bits that differ
    (``bits``)."""
    gv = np.asarray(got["valid"], bool)
    guv = np.asarray(got["uv"], np.float64)
    rv = ref.valid
    gpix = {}
    for i in np.nonzero(gv)[0]:
        gpix.setdefault((int(np.round(guv[i, 0])), int(np.round(guv[i, 1]))),
                        i)
    pairs = []
    for j in np.nonzero(rv)[0]:
        i = gpix.get((int(ref.ij[j, 0]), int(ref.ij[j, 1])))
        if i is None:     # a sub-pixel offset of exactly +-0.5
            for du in (-1, 0, 1):
                for dv in (-1, 0, 1):
                    c = gpix.get((int(ref.ij[j, 0]) + du,
                                  int(ref.ij[j, 1]) + dv))
                    if c is not None and np.abs(guv[c] - ref.uv[j]).max() \
                            <= 0.5 + 1e-3:
                        i = c
        if i is not None:
            pairs.append((i, j))
    n = int(gv.sum()) + int(rv.sum())
    out = {"n": n, "alone": n - 2 * len(pairs), "twins": len(pairs),
           "uv": 0, "angle": 0, "bits": 0}
    if not pairs:
        return out
    gi = np.array([p[0] for p in pairs], np.int64)
    rj = np.array([p[1] for p in pairs], np.int64)
    out["uv"] = int((np.abs(guv[gi] - ref.uv[rj]).max(1) > UV_TOL_PX).sum())
    gb = got["bits"][gi] if "bits" in got else unpack(got["desc"])[gi]
    out["bits"] = int((gb != ref.desc[rj]).sum())
    da = np.angle(np.exp(1j * (np.asarray(got["angle"], np.float64)[gi]
                               - ref.angle[rj])))
    out["angle"] = int((np.abs(da) > ANGLE_TOL_RAD).sum())
    if got.get("response") is not None:
        out["resp"] = int((np.abs(np.asarray(got["response"],
                                             np.float64)[gi]
                                  - ref.response[rj]) > RESP_TOL).sum())
    return out


def compare(got: list, ref: list) -> dict:
    """The numbers that judge a frame's keypoints over every pyramid level
    (``got`` and ``ref`` one entry a level, as ``split`` and ``levels``
    give them): ``kp_set`` the share of valid keypoints of either side
    without a twin on the other, the shares of twins whose sub-pixel
    positions (``uv_off``), angles (``angle_off``) or responses
    (``resp_off``, where ``got`` has them) differ beyond a tolerance, and
    ``desc_bits`` the mean Hamming distance of twins' descriptors. Shares
    and means, not the worst twin: a response a rounding away from a FAST
    threshold, or a patch whose intensity centroid is at its centre, moves
    one twin's position or angle far on either side."""
    t = [tally(g, r) for g, r in zip(got, ref)]
    total = {k: sum(x.get(k, 0) for x in t) for k in t[0]}
    out = {"kp_set": total["alone"] / max(total["n"], 1)}
    tw = total["twins"]
    if not tw:
        return out
    out["uv_off"] = total["uv"] / tw
    out["desc_bits"] = total["bits"] / tw
    out["angle_off"] = total["angle"] / tw
    if all("resp" in x for x in t):
        out["resp_off"] = total["resp"] / tw
    return out
