"""Descriptor matching: batched and masked, in PyTorch.

Counterpart of the projection-matching part of ``cubemapslam_tpu/matching.py``:

* Hamming distance is one matrix product on {0,1} bit matrices,
  ``rowsum(A) + rowsum(B) - 2 A Bᵀ`` (exact in float32 with TF32 off).
* The windowed search is an angular gate between unit bearing rays,
  ``ray_a . ray_b >= cos(window)``, so windows wrap across cube faces.
* Best/second-best bookkeeping is a masked top-2 (argmin-first on ties);
  one-to-one assignment is a scatter-min auction; the rotation histogram
  with top-3-bin filtering is a scatter-add plus a stable sort.

Descriptors are (N, 8) int64 tensors holding the 8 uint32 words of the
256-bit descriptor (PyTorch's uint32 lacks shifts and bitwise ops on some
backends).

Thresholds: TH_LOW=50, TH_HIGH=100, 12-degree histogram bins.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch.camera import CubemapCamera

TH_LOW = 50
TH_HIGH = 100
N_ROT_BINS = 30          # ceil(360/HISTO_LENGTH) bins of 12 deg
BIG = 1e9

# Search radii are pixels on the reference's 650^2 cube faces (fx = 325);
# the angular window atan(r/325) is the calibration-independent quantity,
# with a floor of 6 actual pixels for keypoint detection noise (see the JAX
# module for the measurements behind both).
WINDOW_REF_FOCAL = 325.0
WINDOW_FLOOR_PX = 6.0


def _window_cos(r_px, fx: torch.Tensor) -> torch.Tensor:
    """cos of the effective angular search radius for a reference-pixel
    window r_px on a face with focal fx."""
    r = torch.as_tensor(r_px, dtype=torch.float32, device=fx.device)
    ang = torch.maximum(torch.atan(r / WINDOW_REF_FOCAL),
                        torch.atan(WINDOW_FLOOR_PX / fx))
    return torch.cos(ang)


# ---------------------------------------------------------------------------
# Hamming distance
# ---------------------------------------------------------------------------

def unpack_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int64 words -> (N, 256) float32 bit matrix."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = (desc.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor
                   ) -> torch.Tensor:
    """(Na,256),(Nb,256) {0,1} -> (Na,Nb) float32 Hamming distances,
    dist = |a| + |b| - 2 a.b. The product is exact: {0,1} operands and
    integer sums <= 256 in float32."""
    cross = bits_a @ bits_b.T
    na = bits_a.sum(dim=1, keepdim=True)
    nb = bits_b.sum(dim=1, keepdim=True)
    return na + nb.T - 2.0 * cross


def hamming_pairs(desc_a: torch.Tensor, desc_b: torch.Tensor
                  ) -> torch.Tensor:
    """Elementwise Hamming distance for aligned pairs: (N,8),(N,8) -> (N,)."""
    x = desc_a.to(torch.int64) ^ desc_b.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return ((x[:, :, None] >> shifts) & 1).sum(dim=(1, 2)).to(torch.float32)


# ---------------------------------------------------------------------------
# Rotation-consistency histogram
# ---------------------------------------------------------------------------

def rotation_consistency(angle1: torch.Tensor, angle2: torch.Tensor,
                         matched: torch.Tensor,
                         bin_deg: float = 12.0) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (the second and third only when >= 0.1x the first).
    Equal counts rank the lower bin first."""
    n_bins = int(math.ceil(360.0 / bin_deg))
    rot_deg = torch.rad2deg(angle1 - angle2)
    rot_deg = torch.where(rot_deg < 0, rot_deg + 360.0, rot_deg)
    bins = torch.remainder(torch.round(rot_deg / bin_deg).to(torch.int64),
                           n_bins)
    counts = torch.zeros(n_bins, dtype=torch.float32, device=bins.device)
    counts = counts.index_add(0, bins, matched.to(torch.float32))
    top_val, top_idx = torch.sort(counts, descending=True, stable=True)
    keep2 = top_val[1] >= 0.1 * top_val[0]
    keep3 = top_val[2] >= 0.1 * top_val[0]
    ok = ((bins == top_idx[0])
          | ((bins == top_idx[1]) & keep2)
          | ((bins == top_idx[2]) & keep3))
    return matched & ok


# ---------------------------------------------------------------------------
# One-to-one resolution (auction by scatter-min)
# ---------------------------------------------------------------------------

def resolve_one_to_one(best_idx: torch.Tensor, best_dist: torch.Tensor,
                       matched: torch.Tensor, n_targets: int) -> torch.Tensor:
    """Enforce one-to-one: when several queries pick the same target, only
    the smallest-distance query survives, ties broken by query index."""
    n_q = best_idx.shape[0]
    dev = best_idx.device
    big = torch.iinfo(torch.int64).max
    key = (best_dist.to(torch.int64) * n_q
           + torch.arange(n_q, dtype=torch.int64, device=dev))
    key = torch.where(matched, key, torch.full_like(key, big))
    tgt = torch.where(matched, best_idx.long(), torch.zeros_like(key))
    owner = torch.full((n_targets,), big, dtype=torch.int64, device=dev)
    owner = owner.scatter_reduce(0, tgt, key, reduce="amin",
                                 include_self=True)
    return matched & (owner[tgt] == key)


def _masked_top2(dist: torch.Tensor, gate: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Per-row best & second-best over a gated distance matrix (argmin
    returns the first minimum). Returns (best_idx, best_dist, second_idx,
    second_dist); gated-out entries are BIG."""
    d = torch.where(gate, dist, torch.full_like(dist, BIG))
    best_idx = torch.argmin(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    best = d[rows, best_idx]
    d2 = d.clone()
    d2[rows, best_idx] = BIG
    second_idx = torch.argmin(d2, dim=1)
    second = d2[rows, second_idx]
    return best_idx, best, second_idx, second


class MatchResult(NamedTuple):
    idx: torch.Tensor       # (N1,) int64 target index (undefined if ~ok)
    ok: torch.Tensor        # (N1,) bool
    dist: torch.Tensor      # (N1,) float32 Hamming distance

    @property
    def count(self) -> torch.Tensor:
        return self.ok.sum()


def search_by_projection(query_rays_cam: torch.Tensor,
                         query_desc: torch.Tensor,
                         query_levels: torch.Tensor,
                         query_valid: torch.Tensor,
                         kp, cam: CubemapCamera,
                         scale_factors: torch.Tensor,
                         radius_px,
                         level_lo_off: int, level_hi_off: int,
                         th: float = TH_HIGH,
                         nn_ratio: Optional[float] = None,
                         target_free: Optional[torch.Tensor] = None,
                         query_angles: Optional[torch.Tensor] = None,
                         check_orientation: bool = False) -> MatchResult:
    """Generic projection search.

    query_rays_cam: (Q,3) camera-frame directions of projected 3D points.
    Candidates must lie in [level+level_lo_off, level+level_hi_off] and
    within radius_px * scale_factor[level] (as an angle). nn_ratio, when
    given, applies the best/second same-level ratio test; target_free masks
    frame keypoints still unassociated.
    """
    qn = query_rays_cam / torch.clamp(
        torch.linalg.norm(query_rays_cam, dim=-1, keepdim=True), min=1e-12)
    in_fov = qn[:, 2] >= cam.cos_fov_th
    _, qface = C.ray_to_cubemap(cam, qn)
    projectable = in_fov & (qface != C.UNKNOWN_FACE) & query_valid

    dist = hamming_matrix(unpack_descriptors(query_desc),
                          unpack_descriptors(kp.desc))

    lv = query_levels.long()
    r_eff = torch.as_tensor(radius_px, dtype=torch.float32,
                            device=qn.device) * scale_factors[
        lv.clamp(0, scale_factors.shape[0] - 1)]
    cos_win = _window_cos(r_eff, cam.fxycxy[0])        # (Q,)
    ray_dot = qn @ kp.rays.T                            # (Q, N)
    gate = ray_dot >= cos_win[:, None]
    klv = kp.level[None, :]
    gate &= klv >= lv[:, None] + level_lo_off
    gate &= klv <= lv[:, None] + level_hi_off
    gate &= kp.valid[None, :] & projectable[:, None]
    if target_free is not None:
        gate &= target_free[None, :]

    best_idx, best, second_idx, second = _masked_top2(dist, gate)
    ok = best <= th
    if nn_ratio is not None:
        # the ratio applies only when best and runner-up share a level
        same_level = kp.level[best_idx] == kp.level[second_idx]
        ok &= ~(same_level & (best > nn_ratio * second))
    if check_orientation and query_angles is not None:
        ok = rotation_consistency(query_angles, kp.angle[best_idx], ok)
    ok = resolve_one_to_one(best_idx, best, ok, kp.n)
    return MatchResult(idx=best_idx, ok=ok, dist=best)
