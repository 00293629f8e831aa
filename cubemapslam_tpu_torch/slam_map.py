"""The map arena: fixed-capacity SLAM map state as tables of tensors.

Counterpart of ``cubemapslam_tpu/slam_map.py``. Keyframes, their features
and the landmarks live in preallocated tables with validity masks, and
observations in one place: ``kf_obs_lm[k, i]`` is the landmark that feature
i of keyframe k observes (``NO_LM`` if none). Every per-landmark statistic
(observation counts, normals, depth bands, distinctive descriptors) is a
segment reduction over that table, and the covisibility graph is the product
``O Oᵀ`` of the keyframe-landmark incidence.

PyTorch idiom: the arena is a NamedTuple of tensors on one device, and the
functions that change it (``update_landmark_stats``,
``update_landmark_stats_touched``) write its tensors in place, where the JAX
package returns a new arena from donated buffers. Descriptors are (.., 8)
int64 words (the 8 uint32 words of the 256-bit descriptor) and every int32
table of the JAX arena is int64 here. A JAX scatter into an ``L+1`` (or
``T+1``) buffer whose last entry is dropped becomes the same scatter here:
duplicate indices meet only in that dump slot.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch import matching as M
from cubemapslam_tpu_torch.segment import SegmentPlan, segment_sum

NO_LM = -1
_BIG = torch.iinfo(torch.int32).max    # the JAX package's int32 sentinel


class MapArena(NamedTuple):
    """All device-side map state. K keyframes x N features, L landmarks
    (``cubemapslam_tpu/slam_map.py:35-78``)."""

    # keyframes
    kf_R: torch.Tensor          # (K,3,3) float32 world->cam
    kf_t: torch.Tensor          # (K,3)
    kf_valid: torch.Tensor      # (K,) bool
    kf_frame_id: torch.Tensor   # (K,) int64 source frame id
    kf_timestamp: torch.Tensor  # (K,) float32 seconds
    # per-keyframe features
    kf_uv: torch.Tensor         # (K,N,2) cubemap cross pixels
    kf_rays: torch.Tensor       # (K,N,3) unit bearings (camera frame)
    kf_face: torch.Tensor       # (K,N) int64
    kf_level: torch.Tensor      # (K,N) int64
    kf_angle: torch.Tensor      # (K,N) float32
    kf_desc: torch.Tensor       # (K,N,8) int64 words
    kf_kp_valid: torch.Tensor   # (K,N) bool
    kf_obs_lm: torch.Tensor     # (K,N) int64 landmark id or NO_LM
    # landmarks
    lm_pos: torch.Tensor        # (L,3) world
    lm_valid: torch.Tensor      # (L,) bool
    lm_desc: torch.Tensor       # (L,8) int64 words, distinctive descriptor
    lm_normal: torch.Tensor     # (L,3) mean viewing direction
    lm_min_dist: torch.Tensor   # (L,) scale-invariance band
    lm_max_dist: torch.Tensor   # (L,)
    lm_visible: torch.Tensor    # (L,) int64 (IncreaseVisible)
    lm_found: torch.Tensor      # (L,) int64 (IncreaseFound)
    lm_first_kf: torch.Tensor   # (L,) int64 creating keyframe slot
    lm_birth: torch.Tensor      # (L,) int64 keyframe counter at creation
    lm_first_frame: torch.Tensor  # (L,) int64 creating frame id

    @property
    def n_kf_cap(self) -> int:
        return self.kf_R.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_uv.shape[1]

    @property
    def n_lm_cap(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kf_R.device

    def to(self, device) -> "MapArena":
        """A copy of every table on ``device``."""
        return MapArena(*(t.to(device, copy=True) for t in self))


def make_arena(max_kf: int, n_feat: int, max_lm: int, device) -> MapArena:
    """An empty arena (``slam_map.py:81-105``): identity keyframe poses,
    ids -1, and visible/found counters at 1."""
    K, N, L = max_kf, n_feat, max_lm
    f32, i64 = dict(dtype=torch.float32, device=device), \
        dict(dtype=torch.int64, device=device)
    return MapArena(
        kf_R=torch.eye(3, **f32).expand(K, 3, 3).clone(),
        kf_t=torch.zeros(K, 3, **f32),
        kf_valid=torch.zeros(K, dtype=torch.bool, device=device),
        kf_frame_id=torch.full((K,), -1, **i64),
        kf_timestamp=torch.zeros(K, **f32),
        kf_uv=torch.zeros(K, N, 2, **f32),
        kf_rays=torch.zeros(K, N, 3, **f32),
        kf_face=torch.full((K, N), -1, **i64),
        kf_level=torch.zeros(K, N, **i64),
        kf_angle=torch.zeros(K, N, **f32),
        kf_desc=torch.zeros(K, N, 8, **i64),
        kf_kp_valid=torch.zeros(K, N, dtype=torch.bool, device=device),
        kf_obs_lm=torch.full((K, N), NO_LM, **i64),
        lm_pos=torch.zeros(L, 3, **f32),
        lm_valid=torch.zeros(L, dtype=torch.bool, device=device),
        lm_desc=torch.zeros(L, 8, **i64),
        lm_normal=torch.zeros(L, 3, **f32),
        lm_min_dist=torch.zeros(L, **f32),
        lm_max_dist=torch.zeros(L, **f32),
        lm_visible=torch.ones(L, **i64),
        lm_found=torch.ones(L, **i64),
        lm_first_kf=torch.full((L,), -1, **i64),
        lm_birth=torch.full((L,), -1, **i64),
        lm_first_frame=torch.full((L,), -1, **i64),
    )


# ---------------------------------------------------------------------------
# Derived quantities (segment reductions over kf_obs_lm)
# ---------------------------------------------------------------------------

def _flat_obs(arena: MapArena):
    """(K*N,) segment ids and liveness of the observation table; a dead
    entry points at the dump slot L (``slam_map.py:112-121``)."""
    lm = arena.kf_obs_lm.reshape(-1)
    kp_ok = arena.kf_kp_valid.reshape(-1)
    kf_ok = arena.kf_valid[:, None].expand(-1, arena.n_feat).reshape(-1)
    live = (lm >= 0) & kp_ok & kf_ok
    live &= (lm >= 0) & arena.lm_valid[lm.clamp(min=0)]
    seg = torch.where(live, lm, torch.full_like(lm, arena.n_lm_cap))
    return seg, live


def _scatter(size: int, fill, seg, values, reduce: str) -> torch.Tensor:
    """A ``full(size, fill).at[seg].<reduce>(values)`` of the JAX package."""
    out = torch.full((size,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    if reduce == "sum":
        return out.index_add_(0, seg, values)
    if values.dim() > 1:
        seg = seg.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce_(0, seg, values, reduce=reduce,
                               include_self=True)


def reference_keyframes(arena: MapArena, seg, live, kf_idx) -> torch.Tensor:
    """(L,) slot of each landmark's reference keyframe, the first live
    keyframe by frame id that still observes it; K marks none
    (``slam_map.py:124-137``)."""
    K = arena.n_kf_cap
    key = arena.kf_frame_id[kf_idx] * K + kf_idx
    big = torch.full_like(key, _BIG)
    best = _scatter(arena.n_lm_cap + 1, _BIG, seg,
                    torch.where(live, key, big), "amin")[:-1]
    return torch.where(best < _BIG, best % K, torch.full_like(best, K))


def incidence_matrix(arena: MapArena) -> torch.Tensor:
    """(K, L) {0,1} float32 keyframe-landmark incidence of the live
    observations (``slam_map.py:140-159``), one row scatter per keyframe."""
    K, N, L = arena.n_kf_cap, arena.n_feat, arena.n_lm_cap
    seg, live = _flat_obs(arena)
    O = torch.zeros(K, L + 1, dtype=torch.float32, device=arena.device)
    O.scatter_reduce_(1, seg.view(K, N), live.view(K, N).float(),
                      reduce="amax", include_self=True)
    return O[:, :-1]


def observation_counts(arena: MapArena, O=None) -> torch.Tensor:
    """(L,) keyframe observations per landmark: the incidence's column sums
    (``slam_map.py:162-168``)."""
    if O is None:
        O = incidence_matrix(arena)
    return O.sum(dim=0).to(torch.int64)


def covisibility_matrix(arena: MapArena, O=None) -> torch.Tensor:
    """(K, K) shared-landmark counts, diagonal zeroed
    (``slam_map.py:171-180``). The JAX package multiplies bf16 {0,1}
    operands into float32; here both operands are float32 (TF32 is off at
    package import), so every count below 2^24 is exact."""
    if O is None:
        O = incidence_matrix(arena)
    W = O @ O.T
    W.fill_diagonal_(0.0)
    return W.to(torch.int64)


def _stats_core(kf_frame_id, Ow, scale_factors, seg, live, kf_idx, desc,
                lev, pos_seg, first_kf_seg, S):
    """Per-segment landmark statistics from an observation list
    (``slam_map.py:183-246``): normals, depth bands from the reference
    keyframe, and the observation descriptor closest to the bitwise
    majority (ties to the smallest flat index).

    seg: (E,) in [0, S] (S = dump); live: (E,) bool; kf_idx: (E,) slot;
    desc: (E, 8) int64 words; lev: (E,); pos_seg: (S, 3); first_kf_seg:
    (S,). Returns (normal, min_dist, max_dist, desc, has_obs), each (S, ..).
    """
    K = Ow.shape[0]
    E = seg.shape[0]
    seg_s = seg.clamp(max=S - 1)
    d = pos_seg[seg_s] - Ow[kf_idx]
    dist = torch.linalg.norm(d, dim=-1)
    dir_n = d / dist.clamp(min=1e-12)[:, None]
    w = live.float()
    # the float sum in the plan's fixed order; the 0/1 counts are exact in
    # any order
    normal_sum = segment_sum(SegmentPlan(seg, S), dir_n * w[:, None])
    cnt = _scatter(S + 1, 0.0, seg, w, "sum")
    normal = normal_sum / cnt[:-1, None].clamp(min=1.0)
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / nn.clamp(min=1e-12)

    key = kf_frame_id[kf_idx] * K + kf_idx
    best = _scatter(S + 1, _BIG, seg,
                    torch.where(live, key, torch.full_like(key, _BIG)),
                    "amin")[:-1]
    ref_kf = torch.where(best < _BIG, best % K, first_kf_seg.clamp(0, K - 1))
    d_ref = torch.linalg.norm(pos_seg - Ow[ref_kf], dim=-1)
    lev_ref = _scatter(S + 1, 0, seg, torch.where(
        live & (kf_idx == ref_kf[seg_s]), lev, torch.zeros_like(lev)),
        "amax")
    n_levels = scale_factors.shape[0]
    sf = scale_factors[lev_ref[:-1].clamp(0, n_levels - 1)]
    max_dist = d_ref * sf
    min_dist = max_dist / scale_factors[n_levels - 1]

    bits = M.unpack_descriptors(desc)                        # (E, 256)
    bit_sum = _scatter(S + 1, 0.0, seg, bits * w[:, None], "sum")
    majority = bit_sum[:-1] > 0.5 * cnt[:-1, None].clamp(min=1.0)
    ham = (bits != majority[seg_s].float()).sum(dim=-1).float()
    ham = torch.where(live, ham, torch.full_like(ham, 1e9))
    best_val = _scatter(S + 1, 1e9, seg, ham, "amin")
    is_best = live & (ham <= best_val[seg])
    flat_idx = torch.arange(E, dtype=torch.int64, device=seg.device)
    best_idx = _scatter(S + 1, E, seg, torch.where(
        is_best, flat_idx, torch.full_like(flat_idx, E)), "amin")
    safe_best = best_idx[:-1].clamp(max=E - 1)
    return normal, min_dist, max_dist, desc[safe_best], cnt[:-1] > 0


def _camera_centres(arena: MapArena) -> torch.Tensor:
    """(K, 3) keyframe centres in the world, -Rᵀ t."""
    return -torch.einsum("kij,ki->kj", arena.kf_R, arena.kf_t)


def update_landmark_stats(arena: MapArena,
                          scale_factors: torch.Tensor) -> MapArena:
    """Recompute normals, depth bands and distinctive descriptors of every
    landmark with observations, in place (``slam_map.py:249-272``); for
    whole-map builds.

    Only the live observations are reduced: the dead ones fall into the
    dump slot and change nothing, and keeping the flat order keeps the
    descriptor tie-break. This costs one host read (the live count)."""
    K, N, L = arena.n_kf_cap, arena.n_feat, arena.n_lm_cap
    seg, live = _flat_obs(arena)
    rows = live.nonzero()[:, 0]
    if rows.numel() == 0:
        return arena
    kf_idx = rows // N
    normal, min_dist, max_dist, desc, has_obs = _stats_core(
        arena.kf_frame_id, _camera_centres(arena), scale_factors, seg[rows],
        live[rows], kf_idx, arena.kf_desc.reshape(-1, 8)[rows],
        arena.kf_level.reshape(-1)[rows], arena.lm_pos, arena.lm_first_kf, L)
    arena.lm_normal.copy_(torch.where(has_obs[:, None], normal,
                                      arena.lm_normal))
    arena.lm_min_dist.copy_(torch.where(has_obs, min_dist,
                                        arena.lm_min_dist))
    arena.lm_max_dist.copy_(torch.where(has_obs, max_dist,
                                        arena.lm_max_dist))
    arena.lm_desc.copy_(torch.where(has_obs[:, None], desc, arena.lm_desc))
    return arena


def compact_mask(mask: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """(cap,) indices of the first ``cap`` set entries of ``mask`` in index
    order, ``fill`` past them: the cumsum-rank compaction of the JAX
    package (``full(cap+1, fill).at[rank].set(arange)[:-1]``)."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    can = mask & (rank < cap)
    out = torch.full((cap + 1,), fill, dtype=torch.int64, device=mask.device)
    out[torch.where(can, rank, torch.full_like(rank, cap))] = torch.arange(
        n, dtype=torch.int64, device=mask.device)
    return out[:-1]


def update_landmark_stats_touched(arena: MapArena,
                                  scale_factors: torch.Tensor,
                                  touched: torch.Tensor,
                                  max_touched: int = 16384,
                                  max_obs: int = 131072) -> MapArena:
    """Update the statistics of the TOUCHED landmarks only, in place
    (``slam_map.py:275-348``): the first ``max_touched`` touched landmarks
    and their observations, compacted into fixed shapes. A landmark whose
    observations overflow ``max_obs`` keeps its old statistics."""
    K, N, L = arena.n_kf_cap, arena.n_feat, arena.n_lm_cap
    T = min(max_touched, L)
    dev = arena.device
    touched = touched & arena.lm_valid

    lm_sel = compact_mask(touched, T, L)
    t_ok = lm_sel < L
    lm_sel_s = lm_sel.clamp(max=L - 1)
    inv = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
    inv[torch.where(t_ok, lm_sel_s, torch.full_like(lm_sel_s, L))] = \
        torch.arange(T, dtype=torch.int64, device=dev)
    inv = inv[:-1]

    seg_full, live_full = _flat_obs(arena)
    pid_full = torch.cat([inv, inv.new_full((1,), -1)])[seg_full]
    is_t = live_full & (pid_full >= 0)
    obs_sel = compact_mask(is_t, max_obs, K * N)
    o_ok = obs_sel < K * N
    obs_sel_s = obs_sel.clamp(max=K * N - 1)

    seg = torch.where(o_ok, pid_full[obs_sel_s].clamp(min=0),
                      torch.full_like(obs_sel_s, T))
    kf_idx = obs_sel_s // N
    desc = arena.kf_desc.reshape(-1, 8)[obs_sel_s]
    lev = arena.kf_level.reshape(-1)[obs_sel_s]
    pos_seg = arena.lm_pos[lm_sel_s]
    first_kf_seg = arena.lm_first_kf[lm_sel_s]
    normal, min_dist, max_dist, desc_b, has_obs = _stats_core(
        arena.kf_frame_id, _camera_centres(arena), scale_factors, seg, o_ok,
        kf_idx, desc, lev, pos_seg, first_kf_seg, T)

    # write only landmarks whose whole observation list was compacted
    cnt_full = _scatter(L + 1, 0, seg_full, live_full.to(torch.int64),
                        "sum")[:-1]
    cnt_cpt = _scatter(T + 1, 0, seg, o_ok.to(torch.int64), "sum")[:-1]
    upd = t_ok & has_obs & (cnt_cpt == cnt_full[lm_sel_s])
    tgt = torch.where(upd, lm_sel_s, torch.full_like(lm_sel_s, L))
    for table, new in ((arena.lm_normal, normal),
                       (arena.lm_min_dist, min_dist),
                       (arena.lm_max_dist, max_dist),
                       (arena.lm_desc, desc_b)):
        pad = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
        pad[tgt] = new
        table.copy_(pad[:-1])
    return arena


def predict_scale(dist: torch.Tensor, max_dist: torch.Tensor,
                  log_scale_factor: float, n_levels: int) -> torch.Tensor:
    """MapPoint::PredictScale: level from the distance ratio
    (``slam_map.py:351-357``)."""
    ratio = max_dist.clamp(min=1e-12) / dist.clamp(min=1e-12)
    lvl = torch.ceil(torch.log(ratio) / log_scale_factor).to(torch.int64)
    return lvl.clamp(0, n_levels - 1)


def ba_edges_from_arena(cam, arena: MapArena, cam_sel: torch.Tensor,
                        inv_level_sigma2: torch.Tensor):
    """The observations of the selected keyframes as BA COO arrays over the
    whole (K*N) table, masked, not compacted (``slam_map.py:392-411``).
    cam_sel: (K,) bool. Returns (obs_cam, obs_pt, obs_face, obs_uv in-face,
    obs_inv_sigma2, obs_valid), each (K*N, ..)."""
    K, N = arena.n_kf_cap, arena.n_feat
    _, live = _flat_obs(arena)
    kf_idx = torch.arange(K, device=arena.device).repeat_interleave(N)
    live = live & cam_sel[kf_idx]
    lm = arena.kf_obs_lm.reshape(-1).clamp(min=0)
    lev = arena.kf_level.reshape(-1).clamp(0, inv_level_sigma2.shape[0] - 1)
    uv_face = C.cubemap_uv_to_in_face(cam, arena.kf_uv.reshape(-1, 2))
    return (kf_idx, lm, arena.kf_face.reshape(-1), uv_face,
            inv_level_sigma2[lev], live)


def apply_redirect(arena: MapArena, redirect: torch.Tensor) -> MapArena:
    """Rewrite every observation link through a forwarding table, in place
    (``slam_map.py:360-366``, MapPoint::Replace in one gather). redirect:
    (L,) with redirect[l] = l for live landmarks, the target id for fused
    ones."""
    lm = arena.kf_obs_lm
    arena.kf_obs_lm.copy_(torch.where(lm >= 0, redirect[lm.clamp(min=0)],
                                      lm))
    return arena


def redundant_keyframe_scores(arena: MapArena
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keyframe (n_redundant, n_total) for KeyFrameCulling
    (``slam_map.py:369-389``, LocalMapping.cpp:561-619): an observation is
    redundant when >= 3 OTHER keyframes see the landmark at the same or a
    finer scale (level' <= level + 1). From an (L+1, 16) level histogram by
    one segment sum, in integer counts."""
    K, N, L = arena.n_kf_cap, arena.n_feat, arena.n_lm_cap
    seg, live = _flat_obs(arena)
    lev = arena.kf_level.reshape(-1).clamp(0, 15)
    hist = torch.zeros((L + 1) * 16, dtype=torch.int64,
                       device=seg.device).index_add_(
        0, seg * 16 + lev, live.to(torch.int64)).view(L + 1, 16)
    cum = hist.cumsum(1)                                  # levels <= j
    n_le = cum[seg, (lev + 1).clamp(max=15)]              # includes self
    redundant = live & (n_le - 1 >= 3)
    return redundant.view(K, N).sum(1), live.view(K, N).sum(1)
