"""Local mapping: map-point culling, triangulation of new landmarks,
duplicate fusion, local BA and keyframe culling, on the map arena.

Counterpart of ``cubemapslam_tpu/runtime/mapping.py:27-707``
(``MappingKernels``, with the same method names): the LocalMapping thread's
per-keyframe pipeline (LocalMapping.cpp:52-117) as plain PyTorch on the
arena's device; none of it has a Pallas kernel in the JAX package. The
arena is updated in place.

Where the JAX package branches on the device (``lax.cond``), this module
computes and masks instead, so a mapping step or a deferred BA makes no host
read: a fuse pair of a neighbour that is not valid matches nothing (its
matches are masked), and ``ba_step`` on a culled slot writes nothing (its
write-back targets are the dump rows). ``cull_keyframes``' ``lax.scan`` of
3 rounds is a Python loop of 3 on the device. Indices that live on the
device go in as 1-element tensors (``index_select``), never as ``t[i]``
with a 0-d tensor: on a CUDA tensor that either reads the index to the
host, which a capture forbids, or takes a copy that an in-place write then
misses. ``lax.top_k`` becomes a stable descending sort (ties to the lower
index).

``mapping_step``, ``ba_step`` and the stages they call take the slot, the
keyframe counter and the frame id as Python ints or as 0-d tensors on the
arena's device, with the same bits: the captured keyframe and BA frames
(``runtime/fused_mapping.py``) pass tensors, so that no value is baked into
a graph.

One rule differs from the JAX package, whose result there depends on the
order of a scatter with duplicate indices (``fuse_pair``, ``mapping.py:
322-327``): a merge's write wins over the rows that do not merge (the kill
mask is a max, the redirect of a non-merge row goes to a dump slot), and of
two merges with the same loser the later row wins, as a sequential scatter
does.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch import matching as M
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.optim.ba import BAProblem, bundle_adjust
from cubemapslam_tpu_torch.runtime.frame_step import resolve_device
from cubemapslam_tpu_torch.runtime.kernels import _members
from cubemapslam_tpu_torch.solvers import triangulate_rays
from cubemapslam_tpu_torch.solvers.triangulate import (
    GateConstants, Keyframes, triangulate_gated)

Slot = Union[int, torch.Tensor]     # a Python slot, a 0-d or 1-element index
_I32_MAX = torch.iinfo(torch.int32).max


def _at(table: torch.Tensor, k: Slot) -> torch.Tensor:
    """Row ``k`` of ``table``: a Python int indexes, a device index is an
    ``index_select`` (no host read)."""
    if isinstance(k, int):
        return table[k]
    return table.index_select(0, k.reshape(1))[0]


def _put(table: torch.Tensor, k: Slot, row: torch.Tensor) -> None:
    """Write row ``k`` of ``table`` in place."""
    if isinstance(k, int):
        table[k] = row
    else:
        table.index_copy_(0, k.reshape(1), row[None])


def _index(k: Slot, device) -> torch.Tensor:
    """``k`` as a 1-element int64 index on ``device`` (a Python int by a
    fill, so with no copy from the host)."""
    if isinstance(k, int):
        return torch.full((1,), k, dtype=torch.int64, device=device)
    return k.reshape(1)


def _one_launch_gates(device: torch.device) -> bool:
    """Whether ``mapping_step`` triangulates and gates all its neighbours
    in one ``triangulate_gated`` launch (on the card) or pair by pair
    through ``triangulate_with_neighbor`` (on the CPU, whose path the
    parity tests hold to JAX)."""
    return device.type == "cuda"


def _top(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties to the lower index."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def _onehot(i: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, device=i.device) == i


def _padded_write(table: torch.Tensor, idx: torch.Tensor, values) -> None:
    """``table = pad(table).at[idx].set(values)[:-1]`` in place: ``idx`` in
    [0, len] where ``len`` is a dump row; a scalar value is a fill."""
    pad = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
    if torch.is_tensor(values):
        pad[idx] = values
    else:
        pad.index_fill_(0, idx, values)
    table.copy_(pad[:-1])


def _kf_keypoints(arena: SM.MapArena, k: Slot) -> Keypoints:
    """View arena row k as a Keypoints struct (``mapping.py:27-33``)."""
    return Keypoints(
        uv=_at(arena.kf_uv, k),
        response=torch.ones(arena.n_feat, device=arena.device),
        angle=_at(arena.kf_angle, k), level=_at(arena.kf_level, k),
        face=_at(arena.kf_face, k), desc=_at(arena.kf_desc, k),
        rays=_at(arena.kf_rays, k), valid=_at(arena.kf_kp_valid, k))


def _relative_geometry(arena: SM.MapArena, k1: Slot, k2: Slot):
    """R21, t21 mapping frame-1 points to frame 2, and the epipolar matrix
    E12 in the convention of ``matching.epipolar_chi2``
    (``mapping.py:36-45``)."""
    R1, t1 = _at(arena.kf_R, k1), _at(arena.kf_t, k1)
    R2, t2 = _at(arena.kf_R, k2), _at(arena.kf_t, k2)
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    E12 = (G.hat(t21) @ R21).T
    return R21, t21, E12


class MappingKernels:
    """The local-mapping stages for one camera geometry
    (``mapping.py:48-58``). With no camera, it builds one on ``device``,
    which by default is the card (it raises without one)."""

    def __init__(self, cfg: Optional[SlamConfig] = None,
                 cam: Optional[CubemapCamera] = None, device=None):
        cfg = SlamConfig() if cfg is None else cfg
        if cam is None:
            cam = CubemapCamera.from_config(cfg, resolve_device(device))
        self.cfg, self.cam = cfg, cam
        dev = cam.device
        self.log_scale = math.log(cfg.scale_factor)
        self.scale_factors = torch.tensor(cfg.scale_factors,
                                          dtype=torch.float32, device=dev)
        self.level_sigma2 = torch.tensor(cfg.level_sigma2,
                                         dtype=torch.float32, device=dev)
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        self.th_low = float(cfg.th_low)
        self.histo_bin = float(cfg.histo_length)
        self.gate_consts = GateConstants(
            cam.fxycxy, cam.face_wh, cam.cos_fov_th, self.level_sigma2,
            self.scale_factors, 1.5 * cfg.scale_factor)

    def _level(self, table: torch.Tensor, level: torch.Tensor
               ) -> torch.Tensor:
        return table[level.clamp(0, self.cfg.n_levels - 1)]

    # ------------------------------------------------------------------
    # MapPointCulling (LocalMapping.cpp:175-206)
    # ------------------------------------------------------------------

    def cull_map_points(self, arena: SM.MapArena, current_kf_count: Slot,
                        cnt=None):
        """Probation culling of RECENT landmarks only (``mapping.py:64-85``):
        within about 3 keyframes of creation a landmark must keep
        found/visible >= ``mp_found_ratio_th`` and reach 3 observations.
        Returns (arena, [n_bad_ratio, n_bad_obs])."""
        if cnt is None:
            cnt = SM.observation_counts(arena)
        ratio = arena.lm_found.float() / torch.clamp(
            arena.lm_visible.float(), min=1.0)
        age = current_kf_count - 1 - arena.lm_birth
        probation = age <= 3
        bad_ratio = arena.lm_valid & probation & (
            ratio < self.cfg.mp_found_ratio_th)
        bad_obs = arena.lm_valid & probation & ((age >= 2) & (cnt <= 2))
        arena.lm_valid.copy_(arena.lm_valid & ~(bad_ratio | bad_obs))
        return arena, torch.stack([bad_ratio.sum(), bad_obs.sum()])

    # ------------------------------------------------------------------
    # CreateNewMapPoints (LocalMapping.cpp:209-386)
    # ------------------------------------------------------------------

    def _search_pair(self, arena: SM.MapArena, k_new: Slot, k_nb: Slot):
        """The pair's geometry and the epipolar search of its free
        keypoints (``mapping.py:97-111``). Returns (kp1, kp2, R21, t21,
        search result)."""
        kp1 = _kf_keypoints(arena, k_new)
        kp2 = _kf_keypoints(arena, k_nb)
        R21, t21, E12 = _relative_geometry(arena, k_new, k_nb)
        free1 = _at(arena.kf_obs_lm, k_new) < 0
        free2 = _at(arena.kf_obs_lm, k_nb) < 0
        base = torch.linalg.norm(t21)
        e2 = t21 / torch.clamp(base, min=1e-12)
        res = M.search_for_triangulation(
            kp1, kp2, self.cam, E12, self._level(self.level_sigma2,
                                                 kp2.level),
            free1=free1, free2=free2, epipole_ray2=e2, epipole_guard_deg=1.0,
            th_low=self.th_low, histo_bin_deg=self.histo_bin,
            chi2_th=float(self.cfg.chi2_epipolar))
        return kp1, kp2, R21, t21, res

    def triangulate_with_neighbor(self, arena: SM.MapArena, k_new: Slot,
                                  k_nb: Slot):
        """Match the free keypoints of (k_new, k_nb) on the epipolar
        constraint and triangulate (``mapping.py:91-169``). Returns the
        candidates' world points per k_new feature, their mask, the matched
        k_nb feature, the parallax cosine and the gate counts [raw,
        parallax, depth, chi2]. ``mapping_step`` takes this pair by pair on
        the CPU; on the card it gates all pairs in one
        ``triangulate_gated`` launch."""
        kp1, kp2, R21, t21, res = self._search_pair(arena, k_new, k_nb)
        at = res.idx
        Xw, ok, cos_par, gates = self.gate_pair(
            kp1.rays, kp2.rays[at], kp1.uv, kp2.uv[at], kp1.level,
            kp2.level[at], res.ok, R21, t21, _at(arena.kf_R, k_new),
            _at(arena.kf_t, k_new))
        return Xw, ok, at, cos_par, gates

    def gate_pair(self, rays1, rays2, uv1, uv2, level1, level2, match_ok,
                  R21, t21, R1, t1):
        """Triangulate one pair's N matched rows (``triangulate_rays``) and
        gate them eagerly (``mapping.py:112-168``): the rows' rays, cross
        uv and levels in each keyframe, the search's mask, the pair's (R21,
        t21) and the new keyframe's pose (R1, t1). Returns (Xw, ok,
        cos_par, gates)."""
        X1 = triangulate_rays(rays1, rays2, R21, t21)     # frame-1 coords
        ok = match_ok & torch.isfinite(X1).all(dim=-1)
        # parallax between the viewing rays in a common frame
        cos_par = (rays1 * (rays2 @ R21)).sum(dim=-1)
        ok &= cos_par < 0.9998
        n_par = ok.sum()
        d1 = torch.linalg.norm(X1, dim=-1)
        ok &= d1 <= 50.0 * torch.linalg.norm(t21)
        n_depth = ok.sum()
        ok &= X1[:, 2] / torch.clamp(d1, min=1e-12) > self.cam.cos_fov_th
        X2 = X1 @ R21.T + t21
        d2 = torch.linalg.norm(X2, dim=-1)
        ok &= X2[:, 2] / torch.clamp(d2, min=1e-12) > self.cam.cos_fov_th
        # reprojection chi2 in both frames
        uvp1, f1 = C.ray_to_cubemap(self.cam, X1)
        uvp2, f2 = C.ray_to_cubemap(self.cam, X2)
        s1 = self._level(self.level_sigma2, level1)
        s2 = self._level(self.level_sigma2, level2)
        e1 = ((uvp1 - uv1) ** 2).sum(dim=-1)
        e2 = ((uvp2 - uv2) ** 2).sum(dim=-1)
        ok &= (f1 >= 0) & (e1 <= 5.991 * s1)
        ok &= (f2 >= 0) & (e2 <= 5.991 * s2)
        n_chi2 = ok.sum()
        # scale consistency
        ratio_dist = d2 / torch.clamp(d1, min=1e-12)
        ratio_oct = (self._level(self.scale_factors, level1)
                     / self._level(self.scale_factors, level2))
        rf = 1.5 * self.cfg.scale_factor
        ok &= (ratio_dist * rf > ratio_oct) & (ratio_dist < ratio_oct * rf)
        Xw = (X1 - t1) @ R1
        gates = torch.stack([match_ok.sum(), n_par, n_depth, n_chi2])
        return Xw, ok, cos_par, gates

    def _allocate(self, arena: SM.MapArena, ok_flat: torch.Tensor,
                  slots: torch.Tensor, Xw_flat: torch.Tensor, k_new: Slot,
                  kf_counter: Slot, frame_id: Slot):
        """Give each accepted candidate, in order, the next free landmark
        slot (``slots``: the free slots in index order) and write its rows;
        the others go to the dump row L. ``k_new``, ``kf_counter`` and
        ``frame_id`` are ints (a fill) or 0-d tensors (an indexed write).
        Returns (slot, can)."""
        L = arena.n_lm_cap
        n_free = (~arena.lm_valid).sum()
        rank = torch.cumsum(ok_flat.to(torch.int64), 0) - 1
        can = ok_flat & (rank < n_free)
        slot = torch.where(can, slots[rank.clamp(0, L - 1)],
                           torch.full_like(rank, L))
        _padded_write(arena.lm_pos, slot, Xw_flat)
        _padded_write(arena.lm_valid, slot, can)
        _padded_write(arena.lm_first_kf, slot, k_new)
        _padded_write(arena.lm_birth, slot, kf_counter)
        _padded_write(arena.lm_first_frame, slot, frame_id)
        _padded_write(arena.lm_visible, slot, 1)
        _padded_write(arena.lm_found, slot, 1)
        return slot, can

    def commit_new_landmarks_multi(self, arena: SM.MapArena, k_new: Slot,
                                   nb_idx: torch.Tensor, Xw, ok, idx2,
                                   kf_counter: Slot, frame_id: Slot):
        """Allocate landmark slots for the accepted candidates of ALL
        neighbours in one pass and wire the observations, k_new's row and
        each neighbour's (``mapping.py:171-224``). Xw/ok/idx2 are (B, N, ..)
        per neighbour; ``ok`` admits at most one neighbour per k_new
        feature. Returns (arena, n_new)."""
        B, N = ok.shape
        L = arena.n_lm_cap
        slots = SM.compact_mask(~arena.lm_valid, L, L)
        slot, can = self._allocate(arena, ok.reshape(-1), slots,
                                   Xw.reshape(-1, 3), k_new, kf_counter,
                                   frame_id)
        slot_bn, can_bn = slot.reshape(B, N), can.reshape(B, N)
        new_slot = torch.where(can_bn, slot_bn,
                               torch.full_like(slot_bn, L)).amin(dim=0)
        obs = arena.kf_obs_lm
        _put(obs, k_new, torch.where(new_slot < L, new_slot, _at(obs, k_new)))
        for b in range(B):
            nb = nb_idx[b:b + 1]
            row = obs.index_select(0, nb)[0].scatter_reduce(
                0, idx2[b], torch.where(can_bn[b], slot_bn[b],
                                        torch.full_like(slot_bn[b],
                                                        SM.NO_LM)),
                reduce="amax", include_self=True)
            obs.index_copy_(0, nb, row[None])
        return arena, can.sum()

    def commit_new_landmarks(self, arena: SM.MapArena, k_new: int,
                             k_nb: int, Xw, ok, idx2, kf_counter: int,
                             frame_id: int):
        """Allocate landmark slots for the accepted candidates and wire the
        observations in both keyframes (``mapping.py:226-269``). Returns
        (arena, n_new)."""
        free = ~arena.lm_valid
        order = torch.argsort(torch.where(free, 0, 1), stable=True)
        slot, can = self._allocate(arena, ok, order, Xw, k_new, kf_counter,
                                   frame_id)
        obs = arena.kf_obs_lm
        obs[k_new] = torch.where(can, slot, obs[k_new])
        obs[k_nb] = obs[k_nb].scatter_reduce(
            0, idx2, torch.where(can, slot, torch.full_like(slot, SM.NO_LM)),
            reduce="amax", include_self=True)
        return arena, can.sum()

    # ------------------------------------------------------------------
    # SearchInNeighbors / Fuse (LocalMapping.cpp:388-466)
    # ------------------------------------------------------------------

    def fuse_pair(self, arena: SM.MapArena, k_src: Slot, k_dst: Slot,
                  cnt=None, defer_redirect: bool = False,
                  enabled: Optional[torch.Tensor] = None):
        """Project k_src's landmarks into k_dst; merge duplicates (the one
        with more observations wins) or add the missing observations, in
        place (``mapping.py:276-332``). ``enabled`` (a 0-d bool on the
        device) masks every match, which makes the pair a no-op without a
        host read. With ``defer_redirect`` returns (arena, redirect) and
        leaves the observation table's landmark ids as they are."""
        L, N = arena.n_lm_cap, arena.n_feat
        lm = _at(arena.kf_obs_lm, k_src)
        lm_s = lm.clamp(min=0)
        has = (lm >= 0) & _at(arena.kf_kp_valid, k_src) & arena.lm_valid[lm_s]
        Xc = G.se3_apply(_at(arena.kf_R, k_dst), _at(arena.kf_t, k_dst),
                         arena.lm_pos[lm_s])
        dist = torch.linalg.norm(Xc, dim=-1)
        lvl = SM.predict_scale(dist, arena.lm_max_dist[lm_s], self.log_scale,
                               self.cfg.n_levels)
        in_band = ((dist >= 0.8 * arena.lm_min_dist[lm_s])
                   & (dist <= 1.2 * arena.lm_max_dist[lm_s]))
        res = M.search_by_projection(
            Xc, arena.lm_desc[lm_s], lvl, has & in_band,
            _kf_keypoints(arena, k_dst), self.cam, self.scale_factors, 3.0,
            level_lo_off=-1, level_hi_off=1, th=self.th_low)
        ok = res.ok if enabled is None else res.ok & enabled
        j = res.idx
        row = _at(arena.kf_obs_lm, k_dst)
        tgt_lm = row[j]
        if cnt is None:
            cnt = SM.observation_counts(arena)
        add = ok & (tgt_lm < 0)
        row = row.scatter_reduce(
            0, torch.where(add, j, torch.full_like(j, N - 1)),
            torch.where(add, lm, torch.full_like(lm, SM.NO_LM)),
            reduce="amax", include_self=True)
        _put(arena.kf_obs_lm, k_dst, row)
        merge = ok & (tgt_lm >= 0) & (tgt_lm != lm)
        tgt_s = tgt_lm.clamp(min=0)
        src_wins = cnt[lm_s] >= cnt[tgt_s]
        loser = torch.where(src_wins, tgt_s, lm_s)
        winner = torch.where(src_wins, lm_s, tgt_s)
        # the last merge row of each loser decides its redirect
        q = torch.arange(lm.shape[0], device=lm.device)
        last = torch.full((L + 1,), -1, dtype=torch.int64,
                          device=lm.device).scatter_reduce(
            0, torch.where(merge, loser, torch.full_like(loser, L)),
            torch.where(merge, q, torch.full_like(q, -1)), reduce="amax",
            include_self=True)[:-1]
        redirect = torch.where(last >= 0, winner[last.clamp(min=0)],
                               torch.arange(L, device=lm.device))
        killed = _members(torch.where(merge, loser,
                                      torch.full_like(loser, -1)), L)
        arena.lm_valid.copy_(arena.lm_valid & ~killed)
        if defer_redirect:
            return arena, redirect
        return SM.apply_redirect(arena, redirect)

    # ------------------------------------------------------------------
    # Local bundle adjustment (Optimizer::LocalBundleAdjustment)
    # ------------------------------------------------------------------

    def local_ba(self, arena: SM.MapArena, center_kf: Slot,
                 max_cams: int = 48, covis=None,
                 enabled: Optional[torch.Tensor] = None):
        """BA over the covisible neighbourhood of ``center_kf``, in place
        (``mapping.py:339-464``): the top covisible keyframes are free
        (except slot 0), the other observers of their landmarks fixed
        anchors, the landmarks they observe compacted to
        ``max_local_ba_points`` and optimized by the direct solver. The
        outlier observations are removed. ``enabled`` (a 0-d bool on the
        device) sends every write to the dump rows when false. Returns
        (arena, touched landmarks)."""
        K, N, L = arena.n_kf_cap, arena.n_feat, arena.n_lm_cap
        dev = arena.device
        if covis is None:
            covis = SM.covisibility_matrix(arena)
        w = _at(covis, center_kf).clone()
        w.index_fill_(0, _index(center_kf, dev), _I32_MAX)  # centre included
        w = torch.where(arena.kf_valid, w, torch.full_like(w, -1))
        cam_w, cam_idx = _top(w, max_cams)
        local_valid = cam_w > 0
        obs_rows = arena.kf_obs_lm[cam_idx]                # (C,N)
        rows_ok = ((obs_rows >= 0) & arena.kf_kp_valid[cam_idx]
                   & local_valid[:, None])
        pt_local = _members(torch.where(rows_ok, obs_rows,
                                        torch.full_like(obs_rows, -1)), L)
        pt_local &= arena.lm_valid
        # fixed anchors: the other keyframes, by summed covisibility with
        # the local set
        in_local_set = torch.zeros(K, dtype=torch.int64, device=dev)
        in_local_set = in_local_set.scatter_reduce(
            0, cam_idx, local_valid.to(torch.int64), reduce="amax",
            include_self=True) > 0
        anchor_votes = torch.where(local_valid[:, None], covis[cam_idx],
                                   torch.zeros_like(covis[cam_idx])).sum(0)
        anchor_votes = torch.where(in_local_set | ~arena.kf_valid,
                                   torch.zeros_like(anchor_votes),
                                   anchor_votes)
        fix_w, fix_idx = _top(anchor_votes, max_cams)
        fix_valid = fix_w > 0

        all_idx = torch.cat([cam_idx, fix_idx])            # (2C,)
        all_valid = torch.cat([local_valid, fix_valid])
        all_fixed = torch.cat([local_valid & (cam_idx == 0),
                               torch.ones_like(fix_valid)])
        # gauge guard: with no fixed camera, fix the temporally oldest
        # local keyframe
        has_fixed = (all_fixed & all_valid).any()
        age_key = torch.where(local_valid, arena.kf_frame_id[cam_idx],
                              torch.full_like(cam_idx, _I32_MAX))
        oldest = torch.argmin(age_key)
        all_fixed = all_fixed | (_onehot(oldest, all_idx.shape[0])
                                 & ~has_fixed)
        # compact the point system to O(local) fixed shapes
        P = min(int(self.cfg.max_local_ba_points), L)
        rank = torch.cumsum(pt_local.to(torch.int64), 0) - 1
        can_pt = pt_local & (rank < P)
        lm_sel = SM.compact_mask(pt_local, P, L)
        pt_ok = lm_sel < L
        lm_sel_s = lm_sel.clamp(max=L - 1)
        inv = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
        inv[torch.where(pt_ok, lm_sel_s, torch.full_like(lm_sel_s, L))] = \
            torch.arange(P, device=dev)
        inv = inv[:-1]

        sub_obs = arena.kf_obs_lm[all_idx]                 # (2C,N)
        sub_lm = sub_obs.clamp(min=0)
        sub_ok = ((sub_obs >= 0) & arena.kf_kp_valid[all_idx]
                  & all_valid[:, None] & arena.lm_valid[sub_lm])
        e_pt = inv[sub_lm].reshape(-1)
        sub_ok = sub_ok.reshape(-1) & (e_pt >= 0)
        Csz = all_idx.shape[0]
        prob = BAProblem(
            R=arena.kf_R[all_idx], t=arena.kf_t[all_idx],
            cam_fixed=all_fixed, cam_valid=all_valid,
            X=arena.lm_pos[lm_sel_s], pt_valid=pt_ok,
            obs_cam=torch.arange(Csz, device=dev)[:, None].expand(
                Csz, N).reshape(-1),
            obs_pt=e_pt.clamp(min=0),
            obs_face=arena.kf_face[all_idx].reshape(-1),
            obs_uv=C.cubemap_uv_to_in_face(
                self.cam, arena.kf_uv[all_idx].reshape(-1, 2)),
            obs_inv_sigma2=self._level(self.inv_level_sigma2,
                                       arena.kf_level[all_idx].reshape(-1)),
            obs_valid=sub_ok)
        out, inl = bundle_adjust(
            self.cam, prob, phase_iters=(5, 10), solver="direct",
            n_free=max_cams,
            max_obs_per_cam=int(self.cfg.max_local_ba_obs_per_cam))
        # write back through the dump rows K (cameras) and L (landmarks)
        gate = (lambda m: m) if enabled is None else (lambda m: m & enabled)
        touched = gate(can_pt)
        upd = gate(all_valid & ~all_fixed)
        tgt_upd = torch.where(upd, all_idx, torch.full_like(all_idx, K))
        _padded_write(arena.kf_R, tgt_upd, out.R)
        _padded_write(arena.kf_t, tgt_upd, out.t)
        _padded_write(arena.lm_pos, torch.where(
            gate(pt_ok), lm_sel_s, torch.full_like(lm_sel_s, L)), out.X)
        kill = (sub_ok & ~inl).reshape(Csz, N)
        obs_new = torch.where(kill, torch.full_like(sub_obs, SM.NO_LM),
                              sub_obs)
        _padded_write(arena.kf_obs_lm, torch.where(
            gate(all_valid), all_idx, torch.full_like(all_idx, K)), obs_new)
        return arena, touched

    # ------------------------------------------------------------------
    # The fused per-keyframe mapping step (LocalMapping::Run body)
    # ------------------------------------------------------------------

    def _stats_caps(self, arena: SM.MapArena, max_touched: int):
        return dict(max_touched=min(max_touched, arena.n_lm_cap),
                    max_obs=min(48 * arena.n_feat,
                                arena.n_kf_cap * arena.n_feat))

    def mapping_step(self, arena: SM.MapArena, slot: Slot, kf_counter: Slot,
                     frame_id: Slot, n_neighbors: int = 6,
                     max_cams: int = 48, run_ba: bool = True,
                     run_cull: bool = True):
        """The whole mapping step of new keyframe ``slot``, in place
        (``mapping.py:476-605``): probation culling, triangulation against
        ``n_neighbors`` neighbours (top covisible plus keyframes forced at
        4/8/16 frames back), the commit, the bidirectional fuse with the top
        4, landmark statistics of the touched set, local BA (``run_ba``) and
        keyframe culling (``run_cull``). ``kf_counter`` is the monotonic
        keyframe count after insertion, ``frame_id`` the keyframe's frame.

        Returns (arena, diagnostics (12,)): [n_culled_kf, first_free_slot,
        n_new, n_live_lm, n_row, n_cull_ratio, n_cull_obs, raw epipolar,
        accepted, post-parallax, post-depth, post-chi2], on the device."""
        K, L = arena.n_kf_cap, arena.n_lm_cap
        dev = arena.device
        O = SM.incidence_matrix(arena)
        covis = SM.covisibility_matrix(arena, O=O)
        at = _index(slot, dev)
        w = _at(covis, slot).clone()
        w.index_fill_(0, at, -1)
        w = torch.where(arena.kf_valid, w, torch.full_like(w, -1))
        # neighbours forced at target temporal baselines of 4/8/16 frames
        fid = arena.kf_frame_id
        fid0 = _at(fid, slot)
        chosen = torch.zeros(K, dtype=torch.bool, device=dev)
        eligible = arena.kf_valid & (torch.arange(K, device=dev) != slot) \
            & (fid < fid0)
        for d in (4, 8, 16):
            c = (fid - (fid0 - d)).abs()
            c = torch.where(eligible & ~chosen, c, torch.full_like(c, 1 << 30))
            j = torch.argmin(c)
            hit = _onehot(j, K) & (c.min() < (1 << 30))
            w = w + torch.where(hit, 1 << 24, 0)
            chosen = chosen | hit
        nb_w, nb_idx = _top(w, n_neighbors)
        nb_ok = nb_w > 0

        cnt0 = SM.observation_counts(arena, O=O)
        arena, n_cull_lm = self.cull_map_points(arena, kf_counter, cnt=cnt0)

        # triangulate against every neighbour; keep the widest-parallax
        # candidate of each feature
        if _one_launch_gates(dev):
            pairs = [self._search_pair(arena, slot, nb_idx[b:b + 1])
                     for b in range(n_neighbors)]
            R21s, t21s, idx2_b, match = (torch.stack(x) for x in zip(*(
                (R21, t21, res.idx, res.ok)
                for _, _, R21, t21, res in pairs)))
            Xw_b, ok_b, cos_b, gates_b = triangulate_gated(
                Keyframes(arena.kf_rays, arena.kf_uv, arena.kf_level,
                          arena.kf_R, arena.kf_t), _index(slot, dev),
                nb_idx, idx2_b, match, R21s, t21s, self.gate_consts)
        else:
            tri = [self.triangulate_with_neighbor(arena, slot,
                                                  nb_idx[b:b + 1])
                   for b in range(n_neighbors)]
            Xw_b, ok_b, idx2_b, cos_b, gates_b = (torch.stack(x)
                                                  for x in zip(*tri))
        ok_b &= nb_ok[:, None]
        all_cos = torch.where(ok_b, cos_b, torch.full_like(cos_b, 2.0))
        winner = torch.argmin(all_cos, dim=0)
        win_ok = ok_b & (winner[None, :] == torch.arange(
            n_neighbors, device=dev)[:, None])
        arena, n_new = self.commit_new_landmarks_multi(
            arena, slot, nb_idx, Xw_b, win_ok, idx2_b, kf_counter - 1,
            frame_id)

        # bidirectional fuse with the top neighbours, redirects composed
        # and applied in one table rewrite
        redirect_total = torch.arange(L, device=dev)
        for i in range(min(4, n_neighbors)):
            nb = nb_idx[i:i + 1]
            arena, r1 = self.fuse_pair(arena, slot, nb, cnt=cnt0,
                                       defer_redirect=True,
                                       enabled=nb_ok[i])
            arena, r2 = self.fuse_pair(arena, nb, slot, cnt=cnt0,
                                       defer_redirect=True,
                                       enabled=nb_ok[i])
            redirect_total = r2[r1[redirect_total]]
        arena = SM.apply_redirect(arena, redirect_total)

        # statistics of what the new keyframe and its neighbours observe
        rows = torch.cat([at, nb_idx])
        row_obs = arena.kf_obs_lm[rows]
        row_live = (row_obs >= 0) & arena.kf_kp_valid[rows]
        touched = _members(torch.where(row_live, row_obs,
                                       torch.full_like(row_obs, -1)), L)
        caps = self._stats_caps(arena, max(
            (n_neighbors + 1) * arena.n_feat,
            int(self.cfg.max_local_ba_points)))
        SM.update_landmark_stats_touched(arena, self.scale_factors, touched,
                                         **caps)
        if run_ba:
            arena, ba_touched = self.local_ba(arena, slot, max_cams,
                                              covis=covis)
            SM.update_landmark_stats_touched(arena, self.scale_factors,
                                             ba_touched, **caps)
        if run_cull:
            arena, n_culled = self.cull_keyframes(arena, slot, covis=covis)
        else:
            n_culled = torch.zeros((), dtype=torch.int64, device=dev)
        free = ~arena.kf_valid
        first_free = torch.where(free.any(), torch.argmax(free.to(torch.int8)),
                                 torch.full((), -1, device=dev))
        row = _at(arena.kf_obs_lm, slot)
        n_row = ((row >= 0) & _at(arena.kf_kp_valid, slot)
                 & arena.lm_valid[row.clamp(min=0)]).sum()
        g = gates_b.sum(dim=0)
        return arena, torch.stack([
            n_culled, first_free, n_new, arena.lm_valid.sum(), n_row,
            n_cull_lm[0], n_cull_lm[1], g[0], ok_b.sum(), g[1], g[2], g[3]])

    # ------------------------------------------------------------------
    # Deferred local BA (LocalMapping.cpp:84-90)
    # ------------------------------------------------------------------

    def ba_step(self, arena: SM.MapArena, slot: Slot, max_cams: int = 48):
        """local_ba around ``slot`` and the statistics of the landmarks it
        moved, in place (``mapping.py:617-633``). When the slot is no longer
        a valid keyframe nothing is written (its validity gates the writes
        on the device, where the JAX package branches)."""
        arena, touched = self.local_ba(arena, slot, max_cams,
                                       enabled=_at(arena.kf_valid, slot))
        caps = self._stats_caps(arena, int(self.cfg.max_local_ba_points))
        SM.update_landmark_stats_touched(arena, self.scale_factors, touched,
                                         **caps)
        return arena

    # ------------------------------------------------------------------
    # KeyFrameCulling (LocalMapping.cpp:561-619)
    # ------------------------------------------------------------------

    def cull_keyframes(self, arena: SM.MapArena, center_kf: Slot,
                       max_culls: int = 3, covis=None):
        """Cull up to ``max_culls`` redundant keyframes one at a time, the
        redundancy recomputed between culls from an (L, levels) observation
        histogram built once (``mapping.py:639-707``). A keyframe is
        redundant when more than ``kf_culling_redundant_ratio`` of its
        observations are seen by >= 3 other keyframes at the same or a finer
        scale. Returns (arena, n_culled)."""
        K, L = arena.n_kf_cap, arena.n_lm_cap
        dev = arena.device
        if covis is None:
            covis = SM.covisibility_matrix(arena)
        row_c = _at(covis, center_kf)
        local0 = row_c >= self.cfg.covisibility_weight_th
        seg0, live0 = SM._flat_obs(arena)
        lev_full = arena.kf_level.reshape(-1).clamp(0, 15)
        hist = torch.zeros((L + 1) * 16, device=dev).index_add_(
            0, seg0 * 16 + lev_full, live0.float())

        n_cand = min(self.cfg.max_local_keyframes, K)
        cand_w = torch.where(local0 & arena.kf_valid, row_c,
                             torch.full_like(row_c, -1))
        ar = torch.arange(K, device=dev)
        cand_w = torch.where((ar == 0) | (ar == center_kf),
                             torch.full_like(cand_w, -1), cand_w)
        cw, cand_idx = _top(cand_w, n_cand)
        cand_ok = cw > 0
        rows_obs = arena.kf_obs_lm[cand_idx]               # (C,N)
        rows_lev = arena.kf_level[cand_idx].clamp(0, 15)
        rows_lm = rows_obs.clamp(min=0)
        rows_live = ((rows_obs >= 0) & arena.kf_kp_valid[cand_idx]
                     & arena.lm_valid[rows_lm] & cand_ok[:, None])
        rows_idx_le = (rows_lev + 1).clamp(max=15)

        kf_valid = arena.kf_valid.clone()
        n_culled = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(max_culls):
            cand_live = kf_valid[cand_idx]
            ok_r = rows_live & cand_live[:, None]
            cum = torch.cumsum(hist.reshape(L + 1, 16)[:-1], dim=1)
            n_le = cum[rows_lm, rows_idx_le]               # (C,N)
            redundant = ok_r & (n_le - 1.0 >= 3.0)
            frac = redundant.sum(dim=1).float() / torch.clamp(
                ok_r.sum(dim=1).float(), min=1.0)
            elig = (cand_ok & cand_live
                    & (frac > self.cfg.kf_culling_redundant_ratio))
            worst_c = torch.argmax(torch.where(elig, frac,
                                               torch.full_like(frac, -1.0)))
            worst = cand_idx.index_select(0, worst_c.reshape(1))
            any_cull = elig.any()
            kf_valid = kf_valid & ~(_onehot(worst, K) & any_cull)
            # subtract the culled keyframe's own observations
            row_ok = rows_live.index_select(0, worst_c.reshape(1))[0] \
                & any_cull
            seg_row = torch.where(
                row_ok, rows_lm.index_select(0, worst_c.reshape(1))[0],
                torch.full_like(rows_lm[0], L))
            hist.index_add_(0, seg_row * 16 + rows_lev.index_select(
                0, worst_c.reshape(1))[0], -row_ok.float())
            n_culled = n_culled + any_cull.to(torch.int64)
        arena.kf_valid.copy_(kf_valid)
        return arena, n_culled
