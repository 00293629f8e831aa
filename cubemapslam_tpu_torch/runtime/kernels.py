"""The tracking stages: the two-view bootstrap and the steady-state frame
against the map arena.

Counterpart of the initialization and tracking parts of
``cubemapslam_tpu/runtime/kernels.py`` (``TrackingKernels``), with the same
method names. Each method is plain PyTorch on the arena's device; none holds
a kernel of its own (the JAX package computes them without Pallas).

Where the JAX package resolves a branch with ``lax.cond`` on the device,
``track_frame_full`` reads the deciding counts to the host and branches
there. On the steady path one read after the motion-model match decides
every branch; each fallback that runs adds one read. The caller reads the
packed result once more. A 0-d device tensor is never used as an index
(PyTorch would read it to the host): such indices go in as 1-element
tensors.

The stages between those reads (``frame_motion``, the fallbacks' parts of
``fallback_parts``, then ``frame_local`` or ``frame_skip``) read nothing to
the host and take the keyframe slots, the motion model's gain and the
radius scale as device tensors, so that ``runtime/fused_step.py`` can
capture them as CUDA graphs; in the JAX package they are one jitted
program. A localization-mode frame's stages (``localization_motion``,
``localization_reference``, ``localization_local``) likewise read nothing,
and ``runtime/fused_localization.py`` captures them; so do an
initialization attempt's (``init_count`` / ``init_match``, then
``init_two_view`` on RANSAC scores drawn outside), which
``runtime/fused_init.py`` captures.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch import matching as M
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.optim.pose_opt import pose_optimization
from cubemapslam_tpu_torch.solvers import TwoViewResult, initialize_two_view
from cubemapslam_tpu_torch.solvers.pnp import pnp_ransac
from cubemapslam_tpu_torch.solvers.sampling import draw_scores
from cubemapslam_tpu_torch.spans import host_read, span

MIN_MATCHES = 20             # widen / fall back below this (Tracking.cpp:641)
VELOCITY_GATE_RAD = 0.2      # implausible rotations predict from the last pose
WIDE_LOCAL_INLIERS = 100     # below this, the local search radius x 3


class FrameTrack(NamedTuple):
    """What ``track_frame_full`` returns: the JAX tuple (``arena, assoc,
    outlier, R, t, packed, vel_R, vel_t, rel_R, rel_t``) and the host's
    record of the branches taken and of its reads of the device."""

    arena: SM.MapArena
    assoc: torch.Tensor
    outlier: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    packed: torch.Tensor     # (23,) float32, see track_frame_full
    vel_R: torch.Tensor
    vel_t: torch.Tensor
    rel_R: torch.Tensor
    rel_t: torch.Tensor
    path: Tuple[str, ...]    # branches taken, in order
    host_reads: int          # device -> host reads made inside


def _row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 0-d device index, without a host read."""
    return table.index_select(0, idx.reshape(1))[0]


def pack(counts: Sequence[torch.Tensor], R, t) -> torch.Tensor:
    """0-d ``counts`` and a pose as one float32 vector for one read:
    [counts, R.ravel(9), t(3)]."""
    return torch.cat([torch.stack([c.to(torch.float32) for c in counts]),
                      R.reshape(-1), t])


def pack_two_view(res: TwoViewResult) -> torch.Tensor:
    """A two-view result as one float32 vector for one read: [success,
    n_good, (p3d, good) of each match (N, 4) flat]."""
    head = torch.stack([res.success.to(torch.float32),
                        res.n_good.to(torch.float32)])
    return torch.cat([head, torch.cat([res.p3d, res.good[:, None].to(
        torch.float32)], 1).reshape(-1)])


class InitMatch(NamedTuple):
    """What ``TrackingKernels.init_match`` returns."""

    idx: torch.Tensor        # (N_ref,) current keypoint of each reference
    ok: torch.Tensor         # (N_ref,) bool
    prev_rays: torch.Tensor  # (N_ref, 3) the window centres, updated
    counts: torch.Tensor     # (2,) float32 [n_valid, n_matches]


def device_scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a 0-d tensor on ``device``: a tensor is taken as it is, a
    Python number is written by a fill (no copy from the host, so no
    wait)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x, dtype=dtype, device=device)


class TrackingKernels:
    """The per-frame tracking stages for one camera geometry
    (``cubemapslam_tpu/runtime/kernels.py:28-41``)."""

    def __init__(self, cfg: SlamConfig, cam: CubemapCamera):
        self.cfg = cfg
        self.cam = cam
        dev = cam.device
        self.scale_factors = torch.tensor(cfg.scale_factors,
                                          dtype=torch.float32, device=dev)
        self.level_sigma2 = torch.tensor(cfg.level_sigma2,
                                         dtype=torch.float32, device=dev)
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        self.log_scale = float(torch.log(torch.tensor(
            cfg.scale_factor, dtype=torch.float32)))
        self.th_low = float(cfg.th_low)
        self.th_high = float(cfg.th_high)
        self.histo_bin = float(cfg.histo_length)

    # ------------------------------------------------------------------
    # Initialization (CubemapInitialization + CreateInitialMapCubemap,
    # Tracking.cpp:391-565)
    # ------------------------------------------------------------------

    def match_for_initialization(self, kp_ref: Keypoints, kp_cur: Keypoints,
                                 prev_rays):
        """The bootstrap match (``kernels.py:48-59``). Matched reference
        features re-center their window on the matched current direction.
        Returns (idx, ok, count, new prev_rays)."""
        res = M.search_for_initialization(
            kp_ref, kp_cur, self.cam, window_px=100.0, nn_ratio=0.9,
            center_rays=prev_rays, th_low=self.th_low,
            histo_bin_deg=self.histo_bin)
        new_prev = torch.where(res.ok[:, None], kp_cur.rays[res.idx],
                               prev_rays)
        return res.idx, res.ok, res.count, new_prev

    @staticmethod
    def init_count(kp_cur: Keypoints) -> torch.Tensor:
        """(1,) float32 [n_valid]: a frame without a reference reads its
        count of valid keypoints."""
        return kp_cur.valid.sum().to(torch.float32).reshape(1)

    def init_match(self, kp_ref: Keypoints, kp_cur: Keypoints,
                   prev_rays) -> InitMatch:
        """An attempt's first stage (``match_for_initialization``, JAX
        ``kernels.py:48``) with the counts the host reads once: [the
        current frame's valid keypoints, the matches]."""
        idx, ok, n, new_prev = self.match_for_initialization(
            kp_ref, kp_cur, prev_rays)
        counts = torch.cat([self.init_count(kp_cur),
                            n.to(torch.float32).reshape(1)])
        return InitMatch(idx, ok, new_prev, counts)

    def init_two_view(self, kp_ref: Keypoints, kp_cur: Keypoints, m_idx,
                      m_ok, scores):
        """An attempt's second stage: ray RANSAC initialization over the
        matched pairs (JAX ``kernels.py:61-75``) on the (n_iters, N_ref)
        uniform ``scores`` drawn outside. Returns (``TwoViewResult``, the
        RANSAC's best E21, ``pack_two_view`` of the result)."""
        cfg = self.cfg
        res, E = initialize_two_view(
            self.cam, scores, kp_ref.rays, kp_cur.rays[m_idx], kp_ref.uv,
            kp_cur.uv[m_idx], m_ok, min_parallax=cfg.init_min_parallax_deg,
            min_triangulated=cfg.init_min_triangulated,
            good_ratio=cfg.init_good_ratio)
        return res, E, pack_two_view(res)

    def downselect_keypoints(self, kp: Keypoints, priority, n_keep: int):
        """Reduce an init-extractor keypoint set to the arena's feature
        width, keeping the highest-priority valid rows, ties to the lower
        index (``kernels.py:77-90``). Returns (reduced Keypoints, selected
        indices)."""
        p = torch.where(kp.valid, priority,
                        torch.full_like(priority, float("-inf")))
        sel = torch.sort(p, descending=True, stable=True)[1][:n_keep]
        return Keypoints(*(x[sel] for x in kp)), sel

    # ------------------------------------------------------------------
    # Motion-model tracking (TrackWithMotionModel, Tracking.cpp:620-677)
    # ------------------------------------------------------------------

    def track_last_frame(self, arena: SM.MapArena, kp_cur: Keypoints,
                         last_assoc, last_outlier, last_kp_level,
                         last_kp_angle, R_pred, t_pred,
                         radius: float = 15.0):
        """Project the last frame's landmarks at the predicted pose and
        match, with the rotation histogram (``kernels.py:96-125``). Returns
        (assoc (N,) landmark per current keypoint or -1, count)."""
        lm = last_assoc
        lm0 = lm.clamp(min=0)
        has = (lm >= 0) & ~last_outlier & arena.lm_valid[lm0]
        Xc = G.se3_apply(R_pred, t_pred, arena.lm_pos[lm0])
        res = M.search_by_projection(
            Xc, arena.lm_desc[lm0], last_kp_level, has, kp_cur, self.cam,
            self.scale_factors, radius, level_lo_off=-1, level_hi_off=1,
            th=self.th_high, query_angles=last_kp_angle,
            check_orientation=True)
        assoc = _assoc_max(kp_cur.n, res, lm)
        return assoc, (assoc >= 0).sum()

    def track_reference_kf(self, arena: SM.MapArena, kp_cur: Keypoints,
                           ref_kf):
        """Match the frame against a keyframe's landmark-bearing features by
        full Hamming search, ratio 0.7 and the rotation histogram
        (``kernels.py:127-152``). ``ref_kf`` is a slot: an int or a 0-d
        device index."""
        ref_kf = device_scalar(ref_kf, torch.int64, arena.device)

        def kf(table):
            return _row(table, ref_kf)

        kf_lm = kf(arena.kf_obs_lm)
        kf_has = ((kf_lm >= 0) & kf(arena.kf_kp_valid)
                  & arena.lm_valid[kf_lm.clamp(min=0)])
        dist = M.hamming_matrix(M.unpack_descriptors(kf(arena.kf_desc)),
                                M.unpack_descriptors(kp_cur.desc))
        gate = kf_has[:, None] & kp_cur.valid[None, :]
        best_idx, best, _, second = M._masked_top2(dist, gate)
        ok = (best <= self.th_low) & (best < 0.7 * second)
        ok = M.rotation_consistency(kf(arena.kf_angle),
                                    kp_cur.angle[best_idx], ok,
                                    bin_deg=self.histo_bin)
        ok = M.resolve_one_to_one(best_idx, best, ok, kp_cur.n)
        assoc = _assoc_max(kp_cur.n, M.MatchResult(best_idx, ok, best),
                           kf_lm)
        return assoc, (assoc >= 0).sum()

    def optimize_pose(self, arena: SM.MapArena, kp_cur: Keypoints, assoc,
                      R0, t0):
        """Pose-only LM on the current associations (``kernels.py:154-169``).
        Returns (R, t, outlier mask, n_inliers): the OUTLIERS are the
        associated keypoints that the solve rejected."""
        has = ((assoc >= 0) & kp_cur.valid
               & arena.lm_valid[assoc.clamp(min=0)])
        Xw = arena.lm_pos[assoc.clamp(min=0)]
        uv_face = C.cubemap_uv_to_in_face(self.cam, kp_cur.uv)
        inv_s2 = self.inv_level_sigma2[
            kp_cur.level.clamp(0, self.cfg.n_levels - 1)]
        R, t, inl, n = pose_optimization(self.cam, R0, t0, Xw, kp_cur.face,
                                         uv_face, inv_s2, has)
        return R, t, has & ~inl, n

    # ------------------------------------------------------------------
    # Local map tracking (TrackLocalMap, Tracking.cpp:679-719)
    # ------------------------------------------------------------------

    def select_local_landmarks(self, arena: SM.MapArena, assoc,
                               max_local: int = 8192, covis=None):
        """Local keyframes by observation voting, expanded by covisibility
        and capped at the top ``max_local_keyframes``, then their landmarks
        compacted to ``max_local`` indices (``kernels.py:175-231``).
        Returns (sel, sel_ok, local_mask, pkf_max, pkf_votes)."""
        K, L = arena.n_kf_cap, arena.n_lm_cap
        member = _members(assoc, L)
        obs = arena.kf_obs_lm
        obs_ok = (obs >= 0) & arena.kf_kp_valid & arena.kf_valid[:, None]
        votes = (obs_ok & member[obs.clamp(min=0)]).sum(dim=1)
        if covis is None:
            covis = SM.covisibility_matrix(arena)
        votersf = (votes > 0).float()
        nb_strength = (covis.float() * votersf[:, None]).amax(dim=0)
        expanded = ((votes > 0)
                    | (nb_strength >= self.cfg.covisibility_weight_th))
        expanded &= arena.kf_valid
        k_eff = min(self.cfg.max_local_keyframes, K)
        prio = torch.where(expanded, votes.float() * 1e6 + nb_strength,
                           torch.full_like(nb_strength, -1.0))
        # lax.top_k puts the lower index first among ties: a stable sort
        top_p, local_kfs = torch.sort(prio, descending=True, stable=True)
        local_mask = torch.zeros(K, dtype=torch.bool, device=obs.device)
        local_mask[local_kfs[:k_eff]] = top_p[:k_eff] > 0
        in_local = local_mask[:, None] & obs_ok
        lm_local = _members(torch.where(in_local, obs,
                                        torch.full_like(obs, L)), L)
        lm_local &= arena.lm_valid
        P = min(max_local, L)
        sel = SM.compact_mask(lm_local, P, 0)
        n_can = torch.clamp(lm_local.sum(), max=P)
        sel_ok = torch.arange(P, device=obs.device) < n_can
        pkf_max = torch.argmax(votes)        # the first maximum
        return sel, sel_ok, local_mask, pkf_max, _row(votes, pkf_max)

    def search_local_points(self, arena: SM.MapArena, kp_cur: Keypoints,
                            assoc, sel, sel_ok, R, t, radius_scale=1.0):
        """Frustum gates and a windowed projection match of the selected
        local landmarks, merged into ``assoc`` (``kernels.py:233-288``).
        Returns (assoc, vis_add (L,), diag [in-frustum, queried, matched])."""
        L = arena.n_lm_cap
        Xw = arena.lm_pos[sel]
        Xc = G.se3_apply(R, t, Xw)
        dist = torch.linalg.norm(Xc, dim=-1)
        Ow = -(R.T @ t)
        view_cos = ((Xw - Ow) * arena.lm_normal[sel]).sum(dim=-1) \
            / dist.clamp(min=1e-12)
        in_range = ((dist >= 0.8 * arena.lm_min_dist[sel])
                    & (dist <= 1.2 * arena.lm_max_dist[sel]))
        ray_n = Xc / dist.clamp(min=1e-12)[:, None]
        in_fov = ray_n[:, 2] >= self.cam.cos_fov_th
        _, face = C.ray_to_cubemap(self.cam, ray_n)
        frustum = (sel_ok & in_fov & (face != C.UNKNOWN_FACE) & in_range
                   & (view_cos > 0.5))
        query_ok = frustum & ~_members(assoc, L)[sel]
        lvl = SM.predict_scale(dist, arena.lm_max_dist[sel], self.log_scale,
                               self.cfg.n_levels)
        radius = torch.where(view_cos > 0.998, 2.5, 4.0) * radius_scale
        res = M.search_by_projection(
            Xc, arena.lm_desc[sel], lvl, query_ok, kp_cur, self.cam,
            self.scale_factors, radius, level_lo_off=-1, level_hi_off=0,
            th=self.th_high, nn_ratio=0.8, target_free=assoc < 0)
        cand = torch.where(res.ok, sel, torch.full_like(sel, SM.NO_LM))
        assoc_new = assoc.scatter_reduce(0, res.idx, cand, reduce="amax",
                                         include_self=True)
        vis_add = torch.zeros(L, dtype=torch.int64, device=sel.device)
        vis_add.index_add_(0, sel, frustum.to(torch.int64))
        diag = torch.stack([frustum.sum(), query_ok.sum(), res.ok.sum()])
        return assoc_new, vis_add, diag

    # ------------------------------------------------------------------
    # Fused stages (kernels.py:295-339)
    # ------------------------------------------------------------------

    def track_motion_fused(self, arena: SM.MapArena, kp_cur: Keypoints,
                           last_assoc, last_outlier, last_kp_level,
                           last_kp_angle, R_pred, t_pred,
                           radius: float = 15.0):
        """track_last_frame + optimize_pose. Returns (assoc, n, R, t,
        outlier, n_inl)."""
        assoc, n = self.track_last_frame(
            arena, kp_cur, last_assoc, last_outlier, last_kp_level,
            last_kp_angle, R_pred, t_pred, radius=radius)
        R, t, outlier, n_inl = self.optimize_pose(arena, kp_cur, assoc,
                                                  R_pred, t_pred)
        return assoc, n, R, t, outlier, n_inl

    def graph_cache(self, arena: SM.MapArena):
        """(covisibility, observation counts) from one incidence build
        (``kernels.py:309-320``); refreshed only when the graph changes."""
        O = SM.incidence_matrix(arena)
        return (SM.covisibility_matrix(arena, O=O),
                SM.observation_counts(arena, O=O))

    def track_local_fused(self, arena: SM.MapArena, kp_cur: Keypoints,
                          assoc, outlier, R, t, covis=None,
                          radius_scale=1.0):
        """TrackLocalMap: local selection, projection search, pose solve and
        the visible/found counters, which are updated in place
        (``kernels.py:322-339``)."""
        assoc = torch.where(outlier, torch.full_like(assoc, SM.NO_LM), assoc)
        with span("local.select"):
            sel, sel_ok, _, pkf_max, pkf_votes = self.select_local_landmarks(
                arena, assoc, covis=covis)
        with span("local.search"):
            assoc, vis_add, diag = self.search_local_points(
                arena, kp_cur, assoc, sel, sel_ok, R, t,
                radius_scale=radius_scale)
        with span("local.optimize"):
            R, t, outlier, n_final = self.optimize_pose(arena, kp_cur, assoc,
                                                        R, t)
        with span("local.counters"):
            arena = self.update_found_counters(arena, assoc, outlier,
                                               vis_add)
        return (arena, assoc, outlier, R, t, n_final, pkf_max, pkf_votes,
                diag)

    # ------------------------------------------------------------------
    # Localization-mode stages (system.py:528-550, 620-707)
    # ------------------------------------------------------------------

    def localization_motion(self, arena: SM.MapArena, kp_cur: Keypoints,
                            last_assoc, last_outlier, last_kp_level,
                            last_kp_angle, rel_R, rel_t, last_ref, vel_R,
                            vel_t, has_vel, radius: float = 15.0):
        """A localization-mode frame's motion-model match, which reads
        nothing to the host: the last pose re-anchored on keyframe
        ``last_ref`` (a 0-d device index), the prediction by the velocity
        ``(vel_R, vel_t)``'s twist scaled by ``motion_model_damping`` where
        the 0-d bool ``has_vel`` is set (else the last pose), both
        rotations projected onto SO(3) (``CubemapSLAM``'s localization
        mode), then ``track_motion_fused`` at ``radius``. Returns (stage
        tuple, R_last, t_last, packed (11,) float32 [matches, inliers,
        R.ravel(9), t(3)])."""
        R_last, t_last = G.se3_compose(rel_R, rel_t,
                                       _row(arena.kf_R, last_ref),
                                       _row(arena.kf_t, last_ref))
        R_last = G.so3_project(R_last)
        R_pred, t_pred = R_last, t_last
        a = float(self.cfg.motion_model_damping)
        if a > 0.0:
            Rv, tv = vel_R, vel_t
            if a < 1.0:
                Rv, tv = G.se3_exp(a * G.se3_log(Rv, tv))
            R_v, t_v = G.se3_compose(Rv, tv, R_last, t_last)
            R_pred = torch.where(has_vel, G.so3_project(R_v), R_last)
            t_pred = torch.where(has_vel, t_v, t_last)
        st = self.track_motion_fused(arena, kp_cur, last_assoc, last_outlier,
                                     last_kp_level, last_kp_angle, R_pred,
                                     t_pred, radius=radius)
        return st, R_last, t_last, pack((st[1], st[5]), st[2], st[3])

    def localization_reference(self, arena: SM.MapArena, kp_cur: Keypoints,
                               ref_kf, R_last, t_last):
        """A localization-mode frame's reference-keyframe fallback
        (``reference_fallback`` against keyframe ``ref_kf`` from the last
        pose), which reads nothing to the host. Returns the stage tuple and
        its packed (11,) float32 [matches, inliers, R.ravel(9), t(3)],
        flat."""
        st = self.reference_fallback(arena, kp_cur, ref_kf, R_last, t_last)
        return [*st, pack((st[1], st[5]), st[2], st[3])]

    def localization_local(self, arena: SM.MapArena, kp_cur: Keypoints,
                           assoc, outlier, R, t, covis, R_last, t_last,
                           ref_kf):
        """TrackLocalMap of a localization-mode frame (``track_local_fused``,
        the visible/found counters updated in place), then what the frame
        keeps, which reads nothing to the host: the velocity from the last
        pose (R_last, t_last) and the pose relative to the new reference
        keyframe (``pkf_max`` where it has votes, else ``ref_kf``, a 0-d
        device index). Returns (assoc, outlier, R, t, packed (14,) float32
        [n_final, pkf_max, pkf_votes, R.ravel(9), t(3)], vel_R, vel_t,
        rel_R, rel_t)."""
        (_, assoc, outlier, R, t, n_final, pkf_max, pkf_votes,
         _) = self.track_local_fused(arena, kp_cur, assoc, outlier, R, t,
                                     covis=covis)
        new_ref = torch.where(pkf_votes > 0, pkf_max, ref_kf)
        vel_R, vel_t = G.se3_compose(R, t, *G.se3_inverse(R_last, t_last))
        rel_R, rel_t = G.se3_compose(R, t, *G.se3_inverse(
            _row(arena.kf_R, new_ref), _row(arena.kf_t, new_ref)))
        return (assoc, outlier, R, t,
                pack((n_final, pkf_max, pkf_votes), R, t), vel_R, vel_t,
                rel_R, rel_t)

    def predict_pose(self, arena: SM.MapArena, rel_R, rel_t, last_ref,
                     vel_R, vel_t, vel_gain):
        """The last pose re-anchored on keyframe ``last_ref`` (a 0-d device
        index) and the motion model's prediction: ``(vel_R, vel_t)`` scaled
        by the 0-d ``vel_gain`` and dropped when it turns by 0.2 rad or more
        (``kernels.py:359-366``). Returns (R_last, t_last, R_pred,
        t_pred)."""
        R_last, t_last = G.se3_compose(rel_R, rel_t,
                                       _row(arena.kf_R, last_ref),
                                       _row(arena.kf_t, last_ref))
        tw = G.se3_log(vel_R, vel_t) * vel_gain
        rot_mag = torch.linalg.norm(tw[3:6])
        tw = torch.where(rot_mag < VELOCITY_GATE_RAD, tw,
                         torch.zeros_like(tw))
        Rv, tv = G.se3_exp(tw)
        R_pred, t_pred = G.se3_compose(Rv, tv, R_last, t_last)
        return R_last, t_last, R_pred, t_pred

    def frame_motion(self, arena: SM.MapArena, kp_cur: Keypoints,
                     last_assoc, last_outlier, last_kp_level, last_kp_angle,
                     rel_R, rel_t, last_ref, vel_R, vel_t, vel_gain):
        """The frame's first stage, which reads nothing to the host: the
        prediction (``predict_pose``) and the motion-model match at 15 px.
        Returns (stage tuple of ``track_motion_fused``, (R_last, t_last,
        R_pred, t_pred), counts (2,) int64 [matches, inliers])."""
        pose = self.predict_pose(arena, rel_R, rel_t, last_ref, vel_R, vel_t,
                                 vel_gain)
        st = self.track_motion_fused(arena, kp_cur, last_assoc, last_outlier,
                                     last_kp_level, last_kp_angle, *pose[2:],
                                     radius=15.0)
        return st, pose, torch.stack([st[1], st[5]])

    def widened_motion(self, arena: SM.MapArena, kp_cur: Keypoints, last,
                       R0, t0):
        """A fallback's motion-model match at 30 px from ``(R0, t0)``
        (``kernels.py:394-416``), which reads nothing to the host: the
        widened search from the prediction, or the zero-velocity retry from
        the last pose. ``last`` is the last frame's (assoc, outlier, kp
        level, kp angle). Returns the stage tuple of ``track_motion_fused``
        and its counts (2,) int64 [matches, inliers], flat."""
        st = self.track_motion_fused(arena, kp_cur, *last, R0, t0,
                                     radius=30.0)
        return [*st, torch.stack([st[1], st[5]])]

    def reference_fallback(self, arena: SM.MapArena, kp_cur: Keypoints,
                           ref_kf, R_last, t_last):
        """The reference-keyframe fallback (``kernels.py:418-426``), which
        reads nothing to the host: ``track_reference_kf`` against keyframe
        ``ref_kf`` (an int or a 0-d device index), then ``optimize_pose``
        from the last pose. Returns the stage tuple (assoc, n, R, t,
        outlier, n_inl)."""
        assoc, n = self.track_reference_kf(arena, kp_cur, ref_kf)
        R, t, outlier, n_inl = self.optimize_pose(arena, kp_cur, assoc,
                                                  R_last, t_last)
        return assoc, n, R, t, outlier, n_inl

    def fallback_parts(self, arena: SM.MapArena, kp_cur: Keypoints, last,
                       pose, ref_kf):
        """The fallbacks of a tracked frame as parts that read nothing to
        the host, by name: ``"w"`` widens to 30 px from the prediction,
        ``"z"`` retries from the last pose, ``"r"`` falls back to keyframe
        ``ref_kf``; each takes no argument and returns the stage tuple and
        its counts (2,) int64 [matches, inliers], flat. ``pose`` is
        ``frame_motion``'s (R_last, t_last, R_pred, t_pred).
        ``runtime/fused_step.py`` captures each as a graph."""
        R_last, t_last, R_pred, t_pred = pose

        def reference():
            st = self.reference_fallback(arena, kp_cur, ref_kf, R_last,
                                         t_last)
            return [*st, torch.stack([st[1], st[5]])]

        return {"w": lambda: self.widened_motion(arena, kp_cur, last, R_pred,
                                                 t_pred),
                "z": lambda: self.widened_motion(arena, kp_cur, last, R_last,
                                                 t_last),
                "r": reference}

    @staticmethod
    def motion_fallbacks(run, st, n: int, n_inl: int, path):
        """The fallbacks after the 15 px match, in the JAX order
        (``kernels.py:389-426``), branching on counts read to the host:
        widened to 30 px below 20 matches, a zero-velocity retry kept when
        it has more inliers, then the reference keyframe. ``run(name)``
        runs the part ``name`` of ``fallback_parts`` (eagerly, or as its
        graph) and returns its outputs; each part's counts are read once.
        ``st`` is the 15 px stage tuple and ``n`` / ``n_inl`` its counts as
        read. Returns (stage tuple, n, n_inl, reads made here)."""

        def part(name, step):
            out = run(name)
            path.append(step)
            return tuple(out[:6]), *host_read(out[6])

        reads = 0
        if n < MIN_MATCHES:
            st, n, n_inl = part("w", "widen")
            reads += 1
            if n < MIN_MATCHES:
                st2, n2, n_inl2 = part("z", "zero_velocity")
                reads += 1
                if n_inl2 > n_inl:
                    st, n, n_inl = st2, n2, n_inl2
        if n < MIN_MATCHES:
            st, n, n_inl = part("r", "reference_kf")
            reads += 1
        return st, n, n_inl, reads

    def frame_local(self, arena: SM.MapArena, kp_cur: Keypoints, st, R_last,
                    t_last, ref_kf, covis, cnt):
        """The rest of a frame that tracks, which reads nothing to the host:
        TrackLocalMap on the stage tuple ``st``, with the search radius
        scaled by 3 below 100 inliers (chosen on the device), then the
        epilogue. The arena's visible/found counters are updated in place.
        Returns (assoc, outlier, R, t, packed, vel_R, vel_t, rel_R,
        rel_t)."""
        assoc, n_t, R, t, outlier, n_inl_t = st
        # x 3.0 or x 1.0 in float32: the bits of the host's choice
        rs = torch.where(n_inl_t < WIDE_LOCAL_INLIERS, 3.0, 1.0)
        (arena, assoc_f, outlier_f, R_f, t_f, n_final, pkf_max,
         pkf_votes, diag) = self.track_local_fused(
            arena, kp_cur, assoc, outlier, R, t, covis=covis,
            radius_scale=rs)
        return self._epilogue(arena, st, assoc_f, outlier_f, R_f, t_f,
                              n_final, pkf_max, pkf_votes, diag, R_last,
                              t_last, ref_kf, cnt)

    def frame_skip(self, arena: SM.MapArena, st, R_last, t_last, ref_kf,
                   cnt):
        """The rest of a frame that does not track: the epilogue on the
        stage tuple ``st``, with TrackLocalMap's counts at 0. Returns what
        ``frame_local`` returns."""
        assoc, _, R, t, outlier, _ = st
        zero = torch.zeros((), dtype=torch.int64, device=arena.device)
        diag = torch.zeros(3, dtype=torch.int64, device=arena.device)
        return self._epilogue(arena, st, assoc, outlier, R, t, zero, ref_kf,
                              zero, diag, R_last, t_last, ref_kf, cnt)

    def _epilogue(self, arena, st, assoc_f, outlier_f, R_f, t_f, n_final,
                  pkf_max, pkf_votes, diag, R_last, t_last, ref_kf, cnt):
        """The new reference keyframe, its tracked-landmark count, the first
        free slot, the velocity, the pose relative to the new reference and
        the packed (23,) result (``kernels.py:387-409``)."""
        n_t, n_inl_t = st[1], st[5]
        with span("epilogue"):
            new_ref = torch.where(pkf_votes > 0, pkf_max, ref_kf)
            live_kf = arena.kf_valid.sum()
            row = _row(arena.kf_obs_lm, new_ref)
            row0 = row.clamp(min=0)
            row_ok = ((row >= 0) & _row(arena.kf_kp_valid, new_ref)
                      & arena.lm_valid[row0])
            min_obs = torch.where(live_kf > 2, 3, 2)
            n_ref_obs = (row_ok & (cnt[row0] >= min_obs)).sum()
            free = (~arena.kf_valid).to(torch.int64)
            first_free = torch.where(free.any(), torch.argmax(free),
                                     torch.full_like(live_kf, -1))
            ok_t = (n_t >= 15) & (n_inl_t >= 10)
            scalars = torch.cat([
                torch.stack([n_t, n_inl_t, n_final, n_ref_obs, live_kf,
                             first_free, ok_t.to(torch.int64), new_ref]),
                diag]).float()
            R_li, t_li = G.se3_inverse(R_last, t_last)
            vel_R, vel_t = G.se3_compose(R_f, t_f, R_li, t_li)
            R_ri, t_ri = G.se3_inverse(_row(arena.kf_R, new_ref),
                                       _row(arena.kf_t, new_ref))
            rel_R, rel_t = G.se3_compose(R_f, t_f, R_ri, t_ri)
            packed = torch.cat([scalars, R_f.reshape(-1), t_f])
        return (assoc_f, outlier_f, R_f, t_f, packed, vel_R, vel_t, rel_R,
                rel_t)

    def track_frame_full(self, arena: SM.MapArena, kp_cur: Keypoints,
                         last_assoc, last_outlier, last_kp_level,
                         last_kp_angle, rel_R, rel_t, last_ref, vel_R,
                         vel_t, vel_gain, ref_kf, covis, cnt) -> FrameTrack:
        """The whole per-frame tracking step (``kernels.py:341-490``):
        motion-model match at 15 px, widened to 30 px below 20 matches, a
        zero-velocity retry, the reference-keyframe fallback, then
        TrackLocalMap when the frame tracks (>= 15 matches and >= 10
        inliers). The arena's visible/found counters are updated in place.

        The last pose arrives relative to keyframe ``last_ref`` and is
        re-anchored on the current keyframe table; the motion model is
        ``(vel_R, vel_t)`` scaled by ``vel_gain`` and dropped when it turns
        by 0.2 rad or more. ``last_ref`` and ``ref_kf`` are keyframe slots
        and ``vel_gain`` the gain, each an int / float or a 0-d tensor on
        the arena's device. ``packed`` is (23,) float32: [n_matches,
        n_inliers, n_final, n_ref_obs, live_kf, first_free_slot, track_ok,
        new_ref_kf, local_frustum, local_queried, local_matched,
        R.ravel(9), t(3)].

        The stages are ``frame_motion``, ``motion_fallbacks`` over the
        parts of ``fallback_parts``, and ``frame_local`` or ``frame_skip``;
        ``runtime/fused_step.py`` captures each stage and each part as a
        CUDA graph and runs the same sequence.
        """
        dev = arena.device
        last_ref = device_scalar(last_ref, torch.int64, dev)
        ref_kf = device_scalar(ref_kf, torch.int64, dev)
        vel_gain = device_scalar(vel_gain, torch.float32, dev)
        path = ["motion"]
        last = (last_assoc, last_outlier, last_kp_level, last_kp_angle)
        with span("motion"):
            st, pose, counts = self.frame_motion(
                arena, kp_cur, *last, rel_R, rel_t, last_ref, vel_R, vel_t,
                vel_gain)
            n, n_inl = host_read(counts)
            parts = self.fallback_parts(arena, kp_cur, last, pose, ref_kf)
            st, n, n_inl, reads = self.motion_fallbacks(
                lambda name: parts[name](), st, n, n_inl, path)
        if n >= 15 and n_inl >= 10:
            out = self.frame_local(arena, kp_cur, st, *pose[:2], ref_kf,
                                   covis, cnt)
            path.append("local")
        else:
            out = self.frame_skip(arena, st, *pose[:2], ref_kf, cnt)
            path.append("skip_local")
        return FrameTrack(arena, *out, tuple(path), reads + 1)

    # ------------------------------------------------------------------
    # Relocalization (Tracking::Relocalization, Tracking.cpp:990-1151)
    # ------------------------------------------------------------------

    def reloc_candidate(self, arena: SM.MapArena, kp_cur: Keypoints, slot,
                        scores, sets=None):
        """One candidate keyframe ``slot`` (an int or a 0-d device index):
        the reference-keyframe match (>= 15), bearing-EPnP RANSAC on the
        minimal sets selected from ``scores`` (n_iters, N) uniform draws
        (or on ``sets`` (n_iters, 4) if given), then pose-only LM (>= 10
        inliers) (``kernels.py:511-521``). Reads nothing to the host, so
        ``runtime/fused_reloc.py`` captures it. Returns (assoc, R, t,
        outlier, score): score is the LM inlier count if the candidate
        passes, else -1."""
        lvl_sig2 = self.level_sigma2[kp_cur.level.clamp(0,
                                                        self.cfg.n_levels - 1)]
        assoc, n = self.track_reference_kf(arena, kp_cur, slot)
        has = (assoc >= 0) & kp_cur.valid
        res = pnp_ransac(self.cam, None, arena.lm_pos[assoc.clamp(min=0)],
                         kp_cur.rays, kp_cur.uv, lvl_sig2, has,
                         n_iters=self.cfg.pnp_ransac_iters, sets=sets,
                         scores=scores)
        R, t, outlier, n2 = self.optimize_pose(arena, kp_cur, assoc, res.R,
                                               res.t)
        good = (n >= 15) & res.success & (n2 >= 10)
        return (assoc, R, t, outlier,
                torch.where(good, n2, torch.full_like(n2, -1)))

    def reloc_scores(self, generator: torch.Generator, kp_cur: Keypoints):
        """One candidate's RANSAC draws: (n_iters, N) uniform scores from
        ``generator``, on the keypoints' device."""
        return draw_scores(generator, self.cfg.pnp_ransac_iters, kp_cur.n,
                           kp_cur.uv.device)

    def reloc_skipped(self, kp_cur: Keypoints):
        """The row of a candidate that is not ok: no association, the
        identity pose, no outlier, score -1."""
        n_kp, dev = kp_cur.n, kp_cur.uv.device
        return (torch.full((n_kp,), SM.NO_LM, dtype=torch.int64, device=dev),
                torch.eye(3, device=dev), torch.zeros(3, device=dev),
                torch.zeros(n_kp, dtype=torch.bool, device=dev),
                torch.full((), -1, dtype=torch.int64, device=dev))

    def reloc_candidates_fused(self, arena: SM.MapArena, kp_cur: Keypoints,
                               cand_idx: Sequence[int],
                               cand_ok: Sequence[bool],
                               generator: torch.Generator, sets=None):
        """Per candidate keyframe slot, ``reloc_candidate``
        (``kernels.py:499-526``). The JAX package maps over the candidates
        on the device; here the host loops over them: a candidate that is
        not ok gets ``reloc_skipped``'s row, an ok one draws its scores
        from ``generator`` (one draw each, in candidate order) unless
        ``sets`` gives each candidate's (n_iters, 4) minimal sets. Returns
        the stacked (assoc, R, t, outlier, score)."""
        outs = []
        for i, (c, ok_c) in enumerate(zip(cand_idx, cand_ok)):
            if not ok_c:
                outs.append(self.reloc_skipped(kp_cur))
            elif sets is None:
                outs.append(self.reloc_candidate(
                    arena, kp_cur, int(c),
                    self.reloc_scores(generator, kp_cur)))
            else:
                outs.append(self.reloc_candidate(arena, kp_cur, int(c), None,
                                                 sets=sets[i]))
        return tuple(torch.stack(x) for x in zip(*outs))

    def reloc_widen_fused(self, arena: SM.MapArena, kp_cur: Keypoints,
                          assoc, outlier, R, t, covis=None):
        """The widening pass of the accepted candidate: local-landmark
        projection search, then pose-only LM (``kernels.py:528-539``).
        Reads nothing to the host (``runtime/fused_reloc.py`` captures it).
        Returns (assoc, R, t, outlier, n_inliers)."""
        assoc = torch.where(outlier, torch.full_like(assoc, SM.NO_LM), assoc)
        sel, sel_ok, _, _, _ = self.select_local_landmarks(arena, assoc,
                                                           covis=covis)
        assoc2, _, _ = self.search_local_points(arena, kp_cur, assoc, sel,
                                                sel_ok, R, t)
        R, t, outlier, n3 = self.optimize_pose(arena, kp_cur, assoc2, R, t)
        return assoc2, R, t, outlier, n3

    # ------------------------------------------------------------------
    # Keyframe creation and counters
    # ------------------------------------------------------------------

    def insert_keyframe(self, arena: SM.MapArena, slot, kp: Keypoints,
                        assoc, outlier, R, t, frame_id,
                        timestamp) -> SM.MapArena:
        """Write a frame into arena row ``slot`` in place and refresh the
        statistics of the landmarks it observes (``kernels.py:545-576``).
        ``slot``, ``frame_id`` and ``timestamp`` are Python numbers or 0-d
        tensors on the arena's device (the captured keyframe frame's,
        ``runtime/fused_mapping.py``); every row is written through a
        1-element index, so neither kind makes the host wait or is baked
        into a capture."""
        N, L = arena.n_feat, arena.n_lm_cap
        dev = arena.device
        at = device_scalar(slot, torch.int64, dev).reshape(1)
        good = torch.where(outlier, torch.full_like(assoc, SM.NO_LM), assoc)
        rows = ((arena.kf_R, R), (arena.kf_t, t),
                (arena.kf_frame_id, device_scalar(frame_id, torch.int64,
                                                  dev)),
                (arena.kf_timestamp, device_scalar(timestamp, torch.float32,
                                                   dev)),
                (arena.kf_uv, kp.uv), (arena.kf_rays, kp.rays),
                (arena.kf_face, kp.face), (arena.kf_level, kp.level),
                (arena.kf_angle, kp.angle), (arena.kf_desc, kp.desc),
                (arena.kf_kp_valid, kp.valid), (arena.kf_obs_lm, good))
        for table, row in rows:
            table.index_copy_(0, at, row.reshape((1,) + table.shape[1:]))
        arena.kf_valid.index_fill_(0, at, True)
        return SM.update_landmark_stats_touched(
            arena, self.scale_factors, _members(good, L),
            max_touched=N, max_obs=min(32 * N, arena.n_kf_cap * N))

    def update_found_counters(self, arena: SM.MapArena, assoc, outlier,
                              vis_add) -> SM.MapArena:
        """IncreaseVisible / IncreaseFound, in place
        (``kernels.py:578-586``)."""
        ok = (assoc >= 0) & ~outlier
        arena.lm_visible.add_(vis_add)
        arena.lm_found.index_add_(0, torch.where(ok, assoc, 0),
                                  ok.to(torch.int64))
        return arena


def _members(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool: which of 0..n-1 appear in ``ids`` (entries < 0 or >= n
    are ignored), the ``zeros(n+1).at[where(ok, ids, n)].set(True)[:-1]`` of
    the JAX package."""
    flat = ids.reshape(-1)
    out = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    # index_fill_ takes the value as a scalar, with no copy from the host
    out.index_fill_(0, torch.where(flat >= 0, flat, torch.full_like(flat, n)),
                    True)
    return out[:-1]


def _assoc_max(n_kp: int, res: M.MatchResult, lm: torch.Tensor
               ) -> torch.Tensor:
    """Per-keypoint landmark association by scatter-max, so that a losing
    query (-1) never overwrites a winner."""
    cand = torch.where(res.ok, lm, torch.full_like(lm, SM.NO_LM))
    assoc = torch.full((n_kp,), SM.NO_LM, dtype=torch.int64, device=lm.device)
    return assoc.scatter_reduce(0, res.idx, cand, reduce="amax",
                                include_self=True)
