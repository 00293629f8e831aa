"""Descriptor matching: batched and masked, in PyTorch.

Counterpart of ``cubemapslam_tpu/matching.py``: the projection search, the
two-view bootstrap search and the epipolar search for triangulation.

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
    # a Python radius becomes a fill on the device, not a copy from the host
    r = (r_px.to(fx.device, torch.float32) if torch.is_tensor(r_px)
         else torch.full((), float(r_px), dtype=torch.float32,
                         device=fx.device))
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
    # a scatter of a Python scalar: an index_put_ of one would copy it from
    # the host and wait for the device's queue to drain
    d2 = d.scatter(1, best_idx[:, None], BIG)
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
                         check_orientation: bool = False,
                         query_chunk: Optional[int] = None) -> MatchResult:
    """Generic projection search.

    query_rays_cam: (Q,3) camera-frame directions of projected 3D points.
    Candidates must lie in [level+level_lo_off, level+level_hi_off] and
    within radius_px * scale_factor[level] (as an angle). nn_ratio, when
    given, applies the best/second same-level ratio test; target_free masks
    frame keypoints still unassociated. ``query_chunk``, when given, takes
    the (Q, N) distance and gate matrices that many queries at a time: each
    query's best and second candidates are its own row's, so the result is
    the same, and the largest temporaries shrink by Q / query_chunk.
    """
    qn = query_rays_cam / torch.clamp(
        torch.linalg.norm(query_rays_cam, dim=-1, keepdim=True), min=1e-12)
    in_fov = qn[:, 2] >= cam.cos_fov_th
    _, qface = C.ray_to_cubemap(cam, qn)
    projectable = in_fov & (qface != C.UNKNOWN_FACE) & query_valid
    kp_bits = unpack_descriptors(kp.desc)

    lv = query_levels.long()
    # a Python radius stays a scalar: a tensor made from it on the card
    # would be a copy that waits for the device's queue to drain
    r = (radius_px.to(qn.device, torch.float32) if torch.is_tensor(radius_px)
         else float(radius_px))
    r_eff = r * scale_factors[lv.clamp(0, scale_factors.shape[0] - 1)]
    cos_win = _window_cos(r_eff, cam.fxycxy[0])        # (Q,)

    def top2(q):
        """``_masked_top2`` of the queries ``q`` (a slice)."""
        dist = hamming_matrix(unpack_descriptors(query_desc[q]), kp_bits)
        ray_dot = qn[q] @ kp.rays.T                      # (Q, N)
        gate = ray_dot >= cos_win[q, None]
        klv = kp.level[None, :]
        gate &= klv >= lv[q, None] + level_lo_off
        gate &= klv <= lv[q, None] + level_hi_off
        gate &= kp.valid[None, :] & projectable[q, None]
        if target_free is not None:
            gate &= target_free[None, :]
        return _masked_top2(dist, gate)

    n_q = qn.shape[0]
    if query_chunk is None or query_chunk >= n_q:
        best_idx, best, second_idx, second = top2(slice(None))
    else:
        best_idx, best, second_idx, second = (torch.cat(x) for x in zip(*(
            top2(slice(lo, lo + query_chunk))
            for lo in range(0, n_q, query_chunk))))
    ok = best <= th
    if nn_ratio is not None:
        # the ratio applies only when best and runner-up share a level
        same_level = kp.level[best_idx] == kp.level[second_idx]
        ok &= ~(same_level & (best > nn_ratio * second))
    if check_orientation and query_angles is not None:
        ok = rotation_consistency(query_angles, kp.angle[best_idx], ok)
    ok = resolve_one_to_one(best_idx, best, ok, kp.n)
    return MatchResult(idx=best_idx, ok=ok, dist=best)


def search_for_initialization(kp1, kp2, cam: CubemapCamera,
                              window_px: float = 100.0,
                              nn_ratio: float = 0.9,
                              check_orientation: bool = True,
                              center_rays: Optional[torch.Tensor] = None,
                              th_low: float = TH_LOW,
                              histo_bin_deg: float = 12.0) -> MatchResult:
    """Two-view bootstrap matching (``matching.py:183-213``): level-0
    keypoints only, an angular window around ``center_rays`` (each kp1
    feature's last matched direction; kp1's own rays by default), NN ratio,
    TH_LOW, one-to-one, rotation histogram."""
    dist = hamming_matrix(unpack_descriptors(kp1.desc),
                          unpack_descriptors(kp2.desc))
    cos_win = _window_cos(window_px, cam.fxycxy[0])
    centers = kp1.rays if center_rays is None else center_rays
    gate = (centers @ kp2.rays.T) >= cos_win
    gate &= (kp1.level[:, None] == 0) & (kp2.level[None, :] == 0)
    gate &= kp1.valid[:, None] & kp2.valid[None, :]
    best_idx, best, _, second = _masked_top2(dist, gate)
    ok = (best <= th_low) & (best < nn_ratio * second)
    ok = resolve_one_to_one(best_idx, best, ok, kp2.n)
    if check_orientation:
        ok = rotation_consistency(kp1.angle, kp2.angle[best_idx], ok,
                                  bin_deg=histo_bin_deg)
    return MatchResult(idx=best_idx, ok=ok, dist=best)


def epipolar_chi2(cam: CubemapCamera, E12: torch.Tensor,
                  rays1: torch.Tensor, rays2: torch.Tensor,
                  uv2: torch.Tensor, level_sigma2_2: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise ray-epipolar chi-square (``matching.py:279-296``): (N1,N2)
    of num^2 / (|n|^2 sigma^2 levelSigma2), with the anisotropic sigma of
    the epipolar-plane normal n = E12ᵀ ray1 at each frame-2 keypoint."""
    n = rays1 @ E12                                     # (N1,3) normals
    num = n @ rays2.T                                   # (N1,N2)
    den = (n * n).sum(dim=-1, keepdim=True)             # (N1,1)
    sig = C.vector_sigma_along_normal_pairwise(cam, uv2, n)
    chi2 = num * num / torch.clamp(
        den * sig * sig * level_sigma2_2[None, :], min=1e-20)
    return torch.where(den > 0, chi2, torch.full_like(chi2, float("inf")))


def search_for_triangulation(kp1, kp2, cam: CubemapCamera,
                             E12: torch.Tensor,
                             level_sigma2: torch.Tensor,
                             free1: Optional[torch.Tensor] = None,
                             free2: Optional[torch.Tensor] = None,
                             epipole_ray2: Optional[torch.Tensor] = None,
                             epipole_guard_deg: float = 3.0,
                             check_orientation: bool = True,
                             th_low: float = TH_LOW,
                             histo_bin_deg: float = 12.0,
                             chi2_th: float = 7.68) -> MatchResult:
    """Epipolar-gated matching for new-point triangulation
    (``matching.py:299-345``): the full gated Hamming matrix, the epipolar
    chi2 gate, frame-2 keypoints within the guard cone of the epipole
    rejected, ``free1``/``free2`` masking keypoints not yet bound to a
    landmark, TH_LOW, the rotation histogram and one-to-one."""
    dist = hamming_matrix(unpack_descriptors(kp1.desc),
                          unpack_descriptors(kp2.desc))
    chi2 = epipolar_chi2(cam, E12, kp1.rays, kp2.rays, kp2.uv, level_sigma2)
    gate = (chi2 < chi2_th) & kp1.valid[:, None] & kp2.valid[None, :]
    if epipole_ray2 is not None:
        # in float32, as the JAX package rounds it
        cos_guard = float(torch.cos(torch.deg2rad(
            torch.tensor(epipole_guard_deg, dtype=torch.float32))))
        near_epipole = (kp2.rays @ epipole_ray2).abs() >= cos_guard
        gate &= ~near_epipole[None, :]
    if free1 is not None:
        gate &= free1[:, None]
    if free2 is not None:
        gate &= free2[None, :]
    best_idx, best, _, _ = _masked_top2(dist, gate)
    ok = best <= th_low
    if check_orientation:
        ok = rotation_consistency(kp1.angle, kp2.angle[best_idx], ok,
                                  bin_deg=histo_bin_deg)
    ok = resolve_one_to_one(best_idx, best, ok, kp2.n)
    return MatchResult(idx=best_idx, ok=ok, dist=best)
