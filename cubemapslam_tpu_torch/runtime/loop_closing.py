"""Loop detection, Sim3 computation and loop correction.

Counterpart of ``cubemapslam_tpu/runtime/loop_closing.py`` (the
LoopClosing thread): DetectLoop with the 3-consecutive-keyframe consistency
check, ComputeSim3 (the keyframe-pair match, Sim3 RANSAC, the SearchBySim3
widening, OptimizeSim3 and the S_cw projection gate of 40 matches) and
CorrectLoop (loop fusion, Sim3 propagation to the covisible neighbourhood,
the essential-graph optimization, the landmark remap, SearchAndFuse, the
landmark statistics and the post-loop global BA on the CG solver).
``LoopKernels`` holds the device stages, with the JAX method names;
``LoopCloser`` is the host state machine.

PyTorch idiom: the arena is updated in place, so ``LoopCloser`` always
works on ``system.arena`` and keeps no reference across a stage. Every
stage takes each keyframe slot as a Python int or a 0-d tensor on the
arena's device, with the same bits (rows through ``mapping._at``, writes
through ``_put`` / ``index_fill_``: ``t[s]`` with a 0-d CUDA ``s`` would
read it to the host), so that ``FusedLoop``'s and ``FusedCorrect``'s graphs
bake in no slot; the past loop edges go in as (16,) i / j / ok tensors
written by fills. The JAX ``lax.top_k`` becomes a stable descending sort
and ``jnp.argsort`` a stable sort. ``search_and_fuse`` is a Python loop
over the corrected keyframes: the host's list eagerly, or JAX's 16 masked
slots (``corrected_slots``), a masked one changing nothing. The essential
graph's valid edges are padded to a capacity (``edge_capacity``) on both
paths, and so are the global BA's live observations (``ba_edge_capacity``,
``padded_ba_problem``), so that the captured steps' shapes stay fixed and
their bits are the eager ones.

Two rules differ from the JAX package, whose result there depends on the
order of a scatter with duplicate indices (``loop_closing.py:301-304,
326-329``, the pattern of ``fuse_pair``): in ``loop_fuse`` and
``search_and_fuse`` a merge's redirect wins over the rows that do not merge,
and of two merges with the same loser the later row wins (the rule of
``MappingKernels.fuse_pair``).

Host reads, counted in ``LoopCloser.reads`` for each ``process`` call:
detection reads the candidates, their flags and their covisibility groups in
one packed read. Eagerly ``_try_close`` reads the pair's match count, the
RANSAC verdict, the refined inlier count, and the S_cw match count with the
current keyframe's covisible set in one read; through ``FusedLoop`` (on the
card, ``runtime/fused_loop.py``) it reads the match count, then the
verdict, the refined count, the S_cw count and the covisible set in one
read. The RANSAC's Horn eigen-solves are ``sym_eig`` launches and wait
``sim3.EIGH_WAITS`` = 0 more times (counted in ``LoopCloser.eigh_waits``).
A closure then reads the pose graph's valid-edge count once and the global
BA's live-observation count once (each solves on its live edges only: a
masked edge adds nothing), eagerly the landmark statistics' live count
once, and synchronizes twice to time the correction and the global BA. On
the card DetectLoop, ComputeSim3 and CorrectLoop replay graphs captured
once a system (``runtime/fused_loop.py``: CorrectLoop as graph C, the one
read of the edge count, the Gauss-Newton step of that count's capacity
replayed 12 times and graph F, whose statistics read nothing), and so does
the global BA (``FusedGlobalBA``: graph B, the one read of the live count,
graph P at that count's edge capacity (``ba_edge_capacity``), graph L for
each of its 15 LM steps, graph X for each cut and graph W, those of the
two capacities used last held); a capture makes no host wait
(``LoopCloser.capture_waits``, ``fused_step.CAPTURE_WAITS``).

With ``torch.distributed`` initialized over more than one rank, the global
BA is one SPMD solve over keyframe-block shards (``loop_closing.py:684-700``,
``dist.distributed_bundle_adjust``): rank 0's problem is broadcast first
(the card's float atomics make each rank's own arena differ), its live edges
are sharded on the host (``dist.SHARD_READS`` more reads), and every rank
writes the same result into its arena.
"""

from __future__ import annotations

import math
import time
from typing import List, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch import dist as D
from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch import matching as M
from cubemapslam_tpu_torch import place as PL
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.optim.ba import (BAProblem, CGSolve, _cg_plans,
                                            _cost_plan, _gauge_entry,
                                            _gauge_retract)
from cubemapslam_tpu_torch.optim import pose_graph as PG
from cubemapslam_tpu_torch.optim.pose_graph import optimize_essential_graph
from cubemapslam_tpu_torch.optim.sim3_opt import optimize_sim3
from cubemapslam_tpu_torch.runtime.fused_loop import (FusedGlobalBA,
                                                      pack_detection)
from cubemapslam_tpu_torch.runtime.fused_step import (CAPTURE_WAITS,
                                                      CapturedLoop)
from cubemapslam_tpu_torch.runtime.kernels import _members
from cubemapslam_tpu_torch.runtime.mapping import (Slot, _at, _index,
                                                   _kf_keypoints, _put, _top)
from cubemapslam_tpu_torch.segment import SegmentPlan
from cubemapslam_tpu_torch.solvers import sim3 as S3
from cubemapslam_tpu_torch.solvers.sampling import draw_scores
from cubemapslam_tpu_torch.spans import span

MAX_PREV_LOOPS = 16      # past loop edges in the essential graph
# scw_project's landmarks a block of the (L, N) distance and gate matrices
# (matching.search_by_projection's query_chunk): at L = 65536, N = 2000 the
# unblocked matrices held about 2 GiB of graph S's pool for the system's life
SCW_QUERY_CHUNK = 8192
MAX_NEIGH = 16           # corrected keyframes that SearchAndFuse visits
MAX_LOOP_LANDMARKS = 4096
POSE_GRAPH_ITERS = 12
MIN_EDGE_CAPACITY = 256  # the essential graph's smallest padded edge count
# the global BA: its LM phases and CG iterations a step (loop_closing.py:
# 701-703), and its smallest padded edge count
GBA_PHASES, GBA_CG_ITERS = (5, 10), 50
MIN_BA_EDGE_CAPACITY = 4096
_NP = len(BAProblem._fields)   # graph B's outputs start with the problem
N_CANDIDATES = 8         # DetectLoop's candidates (PL.detect_candidates)


def _ones_like(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=x.dtype, device=x.device)


def _redirect_merges(merge: torch.Tensor, loser: torch.Tensor,
                     winner: torch.Tensor, L: int):
    """(redirect (L,), dead (L,)) of rows that merge ``loser`` into
    ``winner``: a merge's write wins over the rows that do not merge, and
    of two merges with the same loser the later row wins."""
    q = torch.arange(merge.shape[0], device=merge.device)
    last = torch.full((L + 1,), -1, dtype=torch.int64,
                      device=merge.device).scatter_reduce(
        0, torch.where(merge, loser, torch.full_like(loser, L)),
        torch.where(merge, q, torch.full_like(q, -1)), reduce="amax",
        include_self=True)[:-1]
    redirect = torch.where(last >= 0, winner[last.clamp(min=0)],
                           torch.arange(L, device=merge.device))
    dead = _members(torch.where(merge, loser, torch.full_like(loser, -1)), L)
    return redirect, dead


class LoopKernels:
    """The device stages of loop closing for one camera geometry
    (``loop_closing.py:33-486``)."""

    def __init__(self, cfg: SlamConfig, cam: CubemapCamera):
        self.cfg, self.cam = cfg, cam
        dev = cam.device
        self.level_sigma2 = torch.tensor(cfg.level_sigma2,
                                         dtype=torch.float32, device=dev)
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        self.scale_factors = torch.tensor(cfg.scale_factors,
                                          dtype=torch.float32, device=dev)
        self.log_scale = math.log(cfg.scale_factor)

    def _neighbours(self, arena: SM.MapArena, covis: torch.Tensor,
                    k: Slot) -> torch.Tensor:
        """(K,) bool: keyframe k and its covisible set."""
        nb = (_at(covis, k) >= self.cfg.covisibility_weight_th) \
            & arena.kf_valid
        return nb.index_fill_(0, _index(k, nb.device), True)

    def _member_landmarks(self, arena: SM.MapArena, covis, k: Slot):
        """(L,) bool: the landmarks keyframe k and its covisible set observe
        (mvpLoopMapPoints)."""
        nb = self._neighbours(arena, covis, k)
        obs = arena.kf_obs_lm
        obs_ok = (obs >= 0) & arena.kf_kp_valid & nb[:, None]
        return _members(torch.where(obs_ok, obs, torch.full_like(obs, -1)),
                        arena.n_lm_cap) & arena.lm_valid

    def detect_candidates_fused(self, arena: SM.MapArena,
                                bow_table: torch.Tensor, slot: Slot):
        """DetectLoop phase 1 (``loop_closing.py:43-64``): the covisible
        exclusion set, minScore from the covisible BoW scores, candidate
        selection. Returns (cand_idx (8,), cand_ok (8,), cand_groups (8, K)
        the candidates' covisibility groups, each with itself)."""
        covis = SM.covisibility_matrix(arena)
        nb = (_at(covis, slot) >= self.cfg.covisibility_weight_th) \
            & arena.kf_valid
        exclude = nb.clone().index_fill_(0, _index(slot, nb.device), True)
        query = _at(bow_table, slot)
        scores = PL.bow_scores(query, bow_table)
        min_score = torch.where(
            nb.any(), torch.where(nb, scores,
                                  torch.full_like(scores, math.inf)).min(),
            torch.zeros_like(scores[0]))
        cand_idx, cand_ok = PL.detect_candidates(
            query, bow_table, arena.kf_valid, exclude, covis, min_score)
        groups = (covis[cand_idx] > 0).scatter_(1, cand_idx[:, None], True)
        return cand_idx, cand_ok, groups

    def match_kf_pair(self, arena: SM.MapArena, k1: Slot, k2: Slot):
        """Landmark-feature matching between two keyframes (the SearchByBoW
        keyframe pair as a full gated product, ``loop_closing.py:66-90``).
        Returns (per-k1-feature index into k2, ok)."""
        lm1, lm2 = _at(arena.kf_obs_lm, k1), _at(arena.kf_obs_lm, k2)
        has1 = (lm1 >= 0) & _at(arena.kf_kp_valid, k1) \
            & arena.lm_valid[lm1.clamp(min=0)]
        has2 = (lm2 >= 0) & _at(arena.kf_kp_valid, k2) \
            & arena.lm_valid[lm2.clamp(min=0)]
        dist = M.hamming_matrix(
            M.unpack_descriptors(_at(arena.kf_desc, k1)),
            M.unpack_descriptors(_at(arena.kf_desc, k2)))
        gate = has1[:, None] & has2[None, :]
        best_idx, best, _, second = M._masked_top2(dist, gate)
        ok = (best <= self.cfg.th_low) & (best < 0.75 * second)
        ok = M.rotation_consistency(_at(arena.kf_angle, k1),
                                    _at(arena.kf_angle, k2)[best_idx], ok,
                                    bin_deg=float(self.cfg.histo_length))
        ok = M.resolve_one_to_one(best_idx, best, ok, arena.n_feat)
        return best_idx, ok

    def search_by_sim3(self, arena: SM.MapArena, k1: Slot, k2: Slot,
                       s12, R12, t12, idx2_in, ok_in):
        """Widen the keyframe-pair matches with a Sim3 (SearchBySim3,
        ``loop_closing.py:92-153``): each keyframe's landmarks projected
        into the other through S12 / S21 (radius 7.5 x scale at the
        predicted level, TH_HIGH), bidirectional agreements merged into the
        existing matches, whose features both directions exclude."""
        N = arena.n_feat
        kp1, kp2 = _kf_keypoints(arena, k1), _kf_keypoints(arena, k2)
        lm1, lm2 = _at(arena.kf_obs_lm, k1), _at(arena.kf_obs_lm, k2)
        lm1s, lm2s = lm1.clamp(min=0), lm2.clamp(min=0)
        has1 = (lm1 >= 0) & kp1.valid & arena.lm_valid[lm1s]
        has2 = (lm2 >= 0) & kp2.valid & arena.lm_valid[lm2s]
        am1 = ok_in
        am2 = _members(torch.where(ok_in, idx2_in,
                                   torch.full_like(idx2_in, -1)), N)
        # direction A: KF2 landmarks -> KF1 features
        X2c2 = G.se3_apply(_at(arena.kf_R, k2), _at(arena.kf_t, k2),
                           arena.lm_pos[lm2s])
        X2c1 = G.sim3_apply(s12, R12, t12, X2c2)
        lvl_a = SM.predict_scale(torch.linalg.norm(X2c1, dim=-1),
                                 arena.lm_max_dist[lm2s], self.log_scale,
                                 self.cfg.n_levels)
        resA = M.search_by_projection(
            X2c1, arena.lm_desc[lm2s], lvl_a, has2 & ~am2, kp1, self.cam,
            self.scale_factors, 7.5, level_lo_off=-1, level_hi_off=0,
            th=float(self.cfg.th_high))
        # direction B: KF1 landmarks -> KF2 features
        S21 = G.sim3_inverse(s12, R12, t12)
        X1c1 = G.se3_apply(_at(arena.kf_R, k1), _at(arena.kf_t, k1),
                           arena.lm_pos[lm1s])
        X1c2 = G.sim3_apply(*S21, X1c1)
        lvl_b = SM.predict_scale(torch.linalg.norm(X1c2, dim=-1),
                                 arena.lm_max_dist[lm1s], self.log_scale,
                                 self.cfg.n_levels)
        resB = M.search_by_projection(
            X1c2, arena.lm_desc[lm1s], lvl_b, has1 & ~am1, kp2, self.cam,
            self.scale_factors, 7.5, level_lo_off=-1, level_hi_off=0,
            th=float(self.cfg.th_high))
        # kf1 feature i is accepted when B matched it to kf2 feature j and A
        # matched that j back to i
        a_match_of_j = torch.where(resA.ok, resA.idx,
                                   torch.full_like(resA.idx, -1))
        agree = resB.ok & (a_match_of_j[resB.idx]
                           == torch.arange(N, device=idx2_in.device))
        idx2_out = torch.where(ok_in, idx2_in, torch.where(
            agree, resB.idx, torch.zeros_like(resB.idx)))
        return idx2_out, ok_in | agree

    def sim3_candidates(self, arena: SM.MapArena, k1: Slot, k2: Slot, idx2,
                        ok):
        """Matched landmark pairs in each keyframe's camera frame for the
        Sim3 solver (``loop_closing.py:155-171``)."""
        n_lev = self.cfg.n_levels
        lm1 = _at(arena.kf_obs_lm, k1).clamp(min=0)
        lm2 = _at(arena.kf_obs_lm, k2)[idx2].clamp(min=0)
        p1 = G.se3_apply(_at(arena.kf_R, k1), _at(arena.kf_t, k1),
                         arena.lm_pos[lm1])
        p2 = G.se3_apply(_at(arena.kf_R, k2), _at(arena.kf_t, k2),
                         arena.lm_pos[lm2])
        uv1 = _at(arena.kf_uv, k1)
        uv2 = _at(arena.kf_uv, k2)[idx2]
        s1 = self.level_sigma2[_at(arena.kf_level, k1).clamp(0, n_lev - 1)]
        s2 = self.level_sigma2[
            _at(arena.kf_level, k2)[idx2].clamp(0, n_lev - 1)]
        return p1, p2, uv1, uv2, s1, s2

    def sim3_ransac(self, arena: SM.MapArena, k1: Slot, k2: Slot, idx2, ok,
                    generator, scores=None) -> S3.Sim3Result:
        """The Sim3 RANSAC of the matched pairs (``loop_closing.py:585-
        592``): ``sim3_candidates``, then ``solvers.sim3.sim3_ransac``
        (its Horn solves on ``sym_eig``) with its minimal sets from
        ``scores`` if given, else drawn from ``generator``."""
        p1, p2, uv1, uv2, s1, s2 = self.sim3_candidates(arena, k1, k2, idx2,
                                                        ok)
        return S3.sim3_ransac(self.cam, generator, p1, p2, uv1, uv2, s1, s2,
                              ok, n_iters=self.cfg.sim3_ransac_iters,
                              fix_scale=False, min_inliers=20, scores=scores)

    def refine_sim3(self, arena: SM.MapArena, k1: Slot, k2: Slot, idx2, ok,
                    s12, R12, t12):
        """OptimizeSim3 over the matched pairs (``loop_closing.py:173-185``).
        Returns (s, R, t, inliers, n_inliers)."""
        p1, p2, uv1, uv2, s1, s2 = self.sim3_candidates(arena, k1, k2, idx2,
                                                        ok)
        return optimize_sim3(
            self.cam, s12, R12, t12, p1, p2,
            C.cubemap_uv_to_in_face(self.cam, uv1), _at(arena.kf_face, k1),
            C.cubemap_uv_to_in_face(self.cam, uv2),
            _at(arena.kf_face, k2)[idx2],
            1.0 / s1, 1.0 / s2, ok, th2=10.0, fix_scale=False)

    def scw_project(self, arena: SM.MapArena, k_cur: Slot, k_loop: Slot,
                    s_cl, R_cl, t_cl, idx2, ok, covis=None):
        """The loop neighbourhood's landmarks projected into the current
        keyframe through the corrected S_cw (radius 10 x scale at the
        predicted level, TH_LOW), ``loop_closing.py:187-236``. Returns (per
        current feature the loop landmark or -1, the total match count)."""
        L = arena.n_lm_cap
        if covis is None:
            covis = SM.covisibility_matrix(arena)
        member = self._member_landmarks(arena, covis, k_loop)
        # the refined matches: current feature i -> loop feature idx2[i] ->
        # its landmark
        cur_match = torch.where(ok, _at(arena.kf_obs_lm, k_loop)[idx2],
                                torch.full_like(idx2, SM.NO_LM))
        cur_match = torch.where(
            (cur_match >= 0) & arena.lm_valid[cur_match.clamp(min=0)],
            cur_match, torch.full_like(cur_match, SM.NO_LM))
        already = _members(cur_match, L)
        S_cw = G.sim3_compose(s_cl, R_cl, t_cl, _ones_like(s_cl),
                              _at(arena.kf_R, k_loop),
                              _at(arena.kf_t, k_loop))
        Xc = G.sim3_apply(*S_cw, arena.lm_pos)          # (L,3)
        lvl = SM.predict_scale(torch.linalg.norm(Xc, dim=-1),
                               arena.lm_max_dist, self.log_scale,
                               self.cfg.n_levels)
        res = M.search_by_projection(
            Xc, arena.lm_desc, lvl, member & ~already,
            _kf_keypoints(arena, k_cur), self.cam, self.scale_factors, 10.0,
            level_lo_off=-1, level_hi_off=0, th=float(self.cfg.th_low),
            target_free=cur_match < 0, query_chunk=SCW_QUERY_CHUNK)
        lm_ids = torch.arange(L, device=Xc.device)
        loop_assoc = cur_match.scatter_reduce(
            0, res.idx, torch.where(res.ok, lm_ids,
                                    torch.full_like(lm_ids, SM.NO_LM)),
            reduce="amax", include_self=True)
        return loop_assoc, (loop_assoc >= 0).sum()

    def scw_gate(self, arena: SM.MapArena, k_cur: Slot, k_loop: Slot, sim3,
                 idx2, ok):
        """``scw_project`` of the refined S_cl on the covisibility matrix,
        with the current keyframe's covisible set before fusion
        (mvpCurrentConnectedKFs, ``loop_closing.py:620-623``). Returns
        (loop_assoc, the total match count, that set (K,) bool)."""
        covis = SM.covisibility_matrix(arena)
        loop_assoc, total = self.scw_project(arena, k_cur, k_loop, *sim3,
                                             idx2, ok, covis=covis)
        neigh_pre = (_at(covis, k_cur) >= self.cfg.covisibility_weight_th) \
            & arena.kf_valid
        return loop_assoc, total, neigh_pre

    def loop_member_landmarks(self, arena: SM.MapArena, max_sel: int,
                              k_loop: Slot):
        """The loop neighbourhood's landmark set compacted to ``max_sel``
        ids, lowest first (``loop_closing.py:238-256``). Returns (sel,
        sel_ok)."""
        member = self._member_landmarks(
            arena, SM.covisibility_matrix(arena), k_loop)
        score = torch.where(member, 1.0, -1.0)
        val, sel = _top(score, min(max_sel, arena.n_lm_cap))
        return sel, val > 0

    def corrected_slots(self, arena: SM.MapArena, k_cur: Slot,
                        neigh_pre: torch.Tensor):
        """SearchAndFuse's ``MAX_NEIGH`` keyframe slots on the device, as the
        JAX package lists them (``loop_closing.py:644-650``): the current
        keyframe, then the first ``MAX_NEIGH`` - 1 of its pre-fusion
        covisible set ``neigh_pre``, each masked where it is the current
        one, and masked slots after them. Returns (slots, ok), each
        (MAX_NEIGH,)."""
        K = arena.n_kf_cap
        dev = neigh_pre.device
        kc = _index(k_cur, dev)
        rest = SM.compact_mask(neigh_pre, MAX_NEIGH - 1, K)
        slots = torch.cat([kc, rest.clamp(max=K - 1)])
        ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        (rest < K) & (rest != kc)])
        return slots, ok

    def search_and_fuse(self, arena: SM.MapArena, neigh, sel: torch.Tensor,
                        sel_ok: torch.Tensor, neigh_ok=None
                        ) -> SM.MapArena:
        """Project the loop landmark set into each corrected keyframe of
        ``neigh`` and fuse duplicates, the loop landmark winning
        (SearchAndFuse, radius 4), in place (``loop_closing.py:258-309``): a
        matched feature holding another landmark has it replaced, a free one
        gains the observation. ``neigh``: host slots, or a tensor of slots
        (``corrected_slots``) masked by ``neigh_ok``; a masked slot, as in
        the JAX ``fori_loop``, queries nothing, so it adds, merges and
        redirects nothing and writes back its row unchanged."""
        L, N = arena.n_lm_cap, arena.n_feat
        for n, k in enumerate(neigh):
            ok_q = sel_ok & arena.lm_valid[sel] & _at(arena.kf_valid, k)
            if neigh_ok is not None:
                ok_q = ok_q & neigh_ok[n]
            Xc = G.se3_apply(_at(arena.kf_R, k), _at(arena.kf_t, k),
                             arena.lm_pos[sel])
            d = torch.linalg.norm(Xc, dim=-1)
            lvl = SM.predict_scale(d, arena.lm_max_dist[sel], self.log_scale,
                                   self.cfg.n_levels)
            in_band = ((d >= 0.8 * arena.lm_min_dist[sel])
                       & (d <= 1.2 * arena.lm_max_dist[sel]))
            res = M.search_by_projection(
                Xc, arena.lm_desc[sel], lvl, ok_q & in_band,
                _kf_keypoints(arena, k), self.cam, self.scale_factors, 4.0,
                level_lo_off=-1, level_hi_off=1, th=float(self.cfg.th_low))
            j = res.idx
            row = _at(arena.kf_obs_lm, k)
            tgt = row[j]
            # a query whose landmark is already in this row is not fused
            add = res.ok & (tgt < 0)
            merge = res.ok & (tgt >= 0) & (tgt != sel)
            row_new = row.scatter_reduce(
                0, torch.where(add, j, torch.full_like(j, N - 1)),
                torch.where(add, sel, torch.full_like(sel, SM.NO_LM)),
                reduce="amax", include_self=True)
            _put(arena.kf_obs_lm, k, row_new)
            redirect, dead = _redirect_merges(merge, tgt.clamp(min=0), sel, L)
            arena.lm_valid.copy_(arena.lm_valid & ~dead)
            SM.apply_redirect(arena, redirect)
        return arena

    def loop_fuse(self, arena: SM.MapArena, k_cur: Slot,
                  loop_assoc: torch.Tensor) -> SM.MapArena:
        """Fuse the matched loop landmarks into the current keyframe, in
        place (``loop_closing.py:311-332``): a current feature holding
        another landmark has it replaced by the loop landmark, a free one
        gains the observation."""
        L = arena.n_lm_cap
        row = _at(arena.kf_obs_lm, k_cur).clone()
        has_loop = loop_assoc >= 0
        _put(arena.kf_obs_lm, k_cur, torch.where(has_loop, loop_assoc, row))
        merge = has_loop & (row >= 0) & (row != loop_assoc)
        redirect, dead = _redirect_merges(merge, row.clamp(min=0),
                                          loop_assoc.clamp(min=0), L)
        arena.lm_valid.copy_(arena.lm_valid & ~dead)
        return SM.apply_redirect(arena, redirect)

    def essential_graph_edges(self, arena: SM.MapArena, covis, k_cur: Slot,
                              k_loop: Slot, s_cl, R_cl, t_cl, neigh,
                              s_v, R_v, t_v, loop_i, loop_j, loop_ok):
        """The essential graph (``loop_closing.py:397-465``): the temporal
        chain, every covisibility pair of weight >= 100, the past loop edges
        (``fill_loop_edges``) and the new one, with their measurements.
        Returns (e_i, e_j, m_s, m_R, m_t, e_ok), masked, in the JAX
        package's order."""
        K = arena.n_kf_cap
        dev = arena.device
        idx = torch.arange(K, device=dev)
        ordkey = torch.where(arena.kf_valid, arena.kf_frame_id,
                             torch.full_like(arena.kf_frame_id, SM._BIG))
        order = torch.sort(ordkey, stable=True)[1]
        chain_i, chain_j = order, torch.roll(order, -1)
        chain_ok = (arena.kf_valid[chain_i] & arena.kf_valid[chain_j]
                    & (idx + 1 < K))
        cov_i = idx.repeat_interleave(K)
        cov_j = idx.repeat(K)
        cov_ok = ((covis.reshape(-1) >= self.cfg.essential_graph_min_weight)
                  & arena.kf_valid[cov_i] & arena.kf_valid[cov_j]
                  & (cov_i < cov_j))
        e_i = torch.cat([chain_i, cov_i, loop_i, _index(k_cur, dev)])
        e_j = torch.cat([chain_j, cov_j, loop_j, _index(k_loop, dev)])
        e_ok = torch.cat([chain_ok, cov_ok, loop_ok,
                          torch.ones(1, dtype=torch.bool, device=dev)])
        # edges within the corrected neighbourhood or within the untouched
        # rest measure the original relative poses; covisibility edges that
        # cross its boundary (made by loop fusion) measure the seeded ones
        one = torch.ones(e_i.shape[0], device=dev)
        m_orig = G.sim3_compose(one, arena.kf_R[e_j], arena.kf_t[e_j],
                                *G.sim3_inverse(one, arena.kf_R[e_i],
                                                arena.kf_t[e_i]))
        m_seed = G.sim3_compose(s_v[e_j], R_v[e_j], t_v[e_j],
                                *G.sim3_inverse(s_v[e_i], R_v[e_i],
                                                t_v[e_i]))
        is_covis = torch.zeros(e_i.shape[0], dtype=torch.bool, device=dev)
        is_covis[K:K + K * K].fill_(True)
        cross = is_covis & (neigh[e_i] != neigh[e_j])
        ms = torch.where(cross, m_seed[0], m_orig[0])
        mR = torch.where(cross[:, None, None], m_seed[1], m_orig[1])
        mt = torch.where(cross[:, None], m_seed[2], m_orig[2])
        # the new loop edge measures S_cl^-1 (current -> loop)
        S_lc = G.sim3_inverse(s_cl, R_cl, t_cl)
        ms[-1], mR[-1], mt[-1] = S_lc
        return e_i, e_j, ms, mR, mt, e_ok

    @staticmethod
    def padded_edges(edges, cap: int):
        """The valid edges of (e_i, e_j, m_s, m_R, m_t, e_ok) in their
        order, compacted on the device into ``cap`` rows, masked rows after
        them (they gather the last edge): the edge arguments of
        ``optimize_essential_graph``, which leaves the masked rows out of
        its sums."""
        e_ok = edges[-1]
        E = e_ok.shape[0]
        keep = SM.compact_mask(e_ok, cap, E)
        ok = keep < E
        keep = keep.clamp(max=E - 1)
        return (*(x[keep] for x in edges[:-1]), ok)

    def propagate_and_pose_graph(self, arena: SM.MapArena, k_cur: Slot,
                                 k_loop: Slot, s_cl, R_cl, t_cl,
                                 neigh_pre: torch.Tensor,
                                 loop_edges: List[Tuple[int, int]],
                                 loop=None) -> SM.MapArena:
        """CorrectLoop's core (``loop_closing.py:334-486``), in place: seed
        the current keyframe with S_cw = S_cl o T_lw, propagate it through
        ``neigh_pre`` (its covisible set measured before loop fusion),
        optimize the essential graph with the loop keyframe fixed, recover
        the SE3 poses and remap every landmark through its reference
        keyframe. The valid edges are counted (one host read) and padded to
        that count's capacity (``edge_capacity``), as the system's captured
        step takes them (``runtime/fused_loop.py``). ``loop``: the runner
        of the Gauss-Newton iterations (``optimize_essential_graph``)."""
        with span("loop.correct.propagate"):
            own, lm_pos, state, fixed, edges = self._propagate(
                arena, k_cur, k_loop, s_cl, R_cl, t_cl, neigh_pre,
                *self.fill_loop_edges(
                    loop_edges, self.loop_edge_buffers(arena.device)))
            cap = self.edge_capacity(int(edges[-1].sum()),  # the host read
                                     edges[-1].shape[0])
            padded = self.padded_edges(edges, cap)
        with span("loop.correct.pose_graph"):
            s_o, R_o, t_o = optimize_essential_graph(
                *state, arena.kf_valid, fixed, *padded,
                n_iters=POSE_GRAPH_ITERS, loop=loop)
        with span("loop.correct.remap"):
            self.remap(arena, own, lm_pos, s_o, R_o, t_o)
        return arena

    def remap(self, arena: SM.MapArena, own, lm_pos, s_o, R_o, t_o
              ) -> SM.MapArena:
        """The pose graph's Sim3s back to SE3 (t / s) and every landmark
        remapped old -> new through its owning keyframe, in place
        (``loop_closing.py:474-487``)."""
        p_cam_all = G.se3_apply(arena.kf_R[own], arena.kf_t[own], lm_pos)
        lm_final = torch.where(
            arena.lm_valid[:, None],
            G.sim3_apply(*G.sim3_inverse(s_o[own], R_o[own], t_o[own]),
                         p_cam_all), lm_pos)
        kf_t_new = t_o / torch.clamp(s_o[:, None], min=1e-12)
        valid = arena.kf_valid
        arena.kf_R.copy_(torch.where(valid[:, None, None], R_o, arena.kf_R))
        arena.kf_t.copy_(torch.where(valid[:, None], kf_t_new, arena.kf_t))
        arena.lm_pos.copy_(lm_final)
        return arena

    def _propagate(self, arena: SM.MapArena, k_cur: Slot, k_loop: Slot, s_cl,
                   R_cl, t_cl, neigh_pre: torch.Tensor, loop_i, loop_j,
                   loop_ok):
        """``propagate_and_pose_graph`` up to the edge mask: the seeded
        Sim3s, the landmarks of the corrected neighbourhood remapped, the
        essential graph's masked edges. Returns (each landmark's owning
        keyframe, the remapped landmarks, the seeded (s, R, t), the fixed
        vertices, the edges of ``essential_graph_edges``); no host read."""
        K = arena.n_kf_cap
        dev = arena.device
        covis = SM.covisibility_matrix(arena)
        ones = torch.ones(K, device=dev)
        s_v, R_v, t_v = ones, arena.kf_R, arena.kf_t
        S_cw = G.sim3_compose(s_cl, R_cl, t_cl, _ones_like(s_cl),
                              _at(arena.kf_R, k_loop), _at(arena.kf_t, k_loop))
        neigh = (neigh_pre & arena.kf_valid).index_fill_(
            0, _index(k_cur, dev), True)
        R_cw_inv, t_cw_inv = G.se3_inverse(_at(arena.kf_R, k_cur),
                                           _at(arena.kf_t, k_cur))
        R_ic = torch.einsum("kij,jl->kil", arena.kf_R, R_cw_inv)
        t_ic = torch.einsum("kij,j->ki", arena.kf_R, t_cw_inv) + arena.kf_t
        S_iw = G.sim3_compose(ones, R_ic, t_ic, S_cw[0].expand(K),
                              S_cw[1].expand(K, 3, 3), S_cw[2].expand(K, 3))
        s_v = torch.where(neigh, S_iw[0], s_v)
        R_v = torch.where(neigh[:, None, None], S_iw[1], R_v)
        t_v = torch.where(neigh[:, None], S_iw[2], t_v)

        # landmarks of the corrected neighbourhood through S_old -> S_corr,
        # each owned by its reference keyframe (else its creator)
        seg, live = SM._flat_obs(arena)
        kf_of = torch.arange(K, device=dev).repeat_interleave(arena.n_feat)
        ref = SM.reference_keyframes(arena, seg, live, kf_of)
        own = torch.where(ref < K, ref, arena.lm_first_kf.clamp(0, K - 1))
        owned = neigh[own] & arena.lm_valid
        p_cam = G.se3_apply(arena.kf_R[own], arena.kf_t[own], arena.lm_pos)
        lm_new = G.sim3_apply(*G.sim3_inverse(S_iw[0][own], S_iw[1][own],
                                              S_iw[2][own]), p_cam)
        lm_pos = torch.where(owned[:, None], lm_new, arena.lm_pos)

        edges = self.essential_graph_edges(
            arena, covis, k_cur, k_loop, s_cl, R_cl, t_cl, neigh, s_v, R_v,
            t_v, loop_i, loop_j, loop_ok)
        fixed = torch.zeros(K, dtype=torch.bool, device=dev).index_fill_(
            0, _index(k_loop, dev), True)
        return own, lm_pos, (s_v, R_v, t_v), fixed, edges

    @staticmethod
    def loop_edge_buffers(device) -> Tuple[torch.Tensor, ...]:
        """The past loop edges' (MAX_PREV_LOOPS,) i, j and ok tensors,
        zero."""
        return tuple(torch.zeros(MAX_PREV_LOOPS, dtype=dt, device=device)
                     for dt in (torch.int64, torch.int64, torch.bool))

    @staticmethod
    def fill_loop_edges(loop_edges: List[Tuple[int, int]], out):
        """Write the first MAX_PREV_LOOPS of the host's ``loop_edges`` into
        the i, j and ok tensors ``out`` (``loop_edge_buffers``, or the
        system's static buffers) by fills, with no copy from the host;
        returns ``out``."""
        for buf in out:
            buf.zero_()
        for n, (a, b) in enumerate(loop_edges[:MAX_PREV_LOOPS]):
            out[0][n].fill_(a)
            out[1][n].fill_(b)
            out[2][n].fill_(True)
        return out

    @staticmethod
    def edge_capacity(count: int, n_edges: int) -> int:
        """The essential graph's padded edge count for ``count`` valid
        edges of ``n_edges``: the next power of two at or above the count,
        at least ``MIN_EDGE_CAPACITY``, at most ``n_edges``. One captured
        step serves every closure whose count falls in its capacity."""
        return min(n_edges, max(MIN_EDGE_CAPACITY,
                                1 << max(count - 1, 0).bit_length()))

    # ------------------------------------------------------------------
    # The global BA at a padded edge capacity (runtime/fused_loop.py
    # captures its parts)
    # ------------------------------------------------------------------

    @staticmethod
    def ba_edge_capacity(count: int, n_slots: int) -> int:
        """The global BA's padded edge count for ``count`` live
        observations of ``n_slots``: the count rounded up to a multiple of
        2^(bit_length(count) - 4), so 8 capacities an octave and at most
        12.5% padding, at least ``MIN_BA_EDGE_CAPACITY``, at most
        ``n_slots``. Finer than ``edge_capacity``'s powers of two: the
        padding costs every CG iteration, a capacity one capture a
        system."""
        step = 1 << max(count.bit_length() - 4, 0)
        return min(n_slots, max(MIN_BA_EDGE_CAPACITY,
                                -(-count // step) * step))

    @staticmethod
    def padded_ba_problem(prob: BAProblem, cap: int):
        """The live observations of the global BA problem ``prob`` (every
        slot of the observation table, masked) in their order, compacted on
        the device into ``cap`` rows, masked rows after them (they gather
        the last slot; the solve's plans drop them). Returns (the padded
        problem, each row's slot: the slot count for a padded row, which
        ``write_global_ba`` routes to a dump slot)."""
        E = prob.obs_valid.shape[0]
        keep = SM.compact_mask(prob.obs_valid, cap, E)
        rows = keep.clamp(max=E - 1)
        edges = {f: getattr(prob, f)[rows] for f in D.EDGE_FIELDS[:-1]}
        return prob._replace(**edges, obs_valid=keep < E), keep

    @staticmethod
    def write_global_ba(arena: SM.MapArena, out: BAProblem,
                        active: torch.Tensor, keep: torch.Tensor,
                        obs_valid: torch.Tensor) -> SM.MapArena:
        """The solved global BA into the arena, in place: the poses and
        points of ``out``, and every observation slot that was live
        (``obs_valid``, all K*N) and is no inlier (``active`` of the solve's
        rows, put back on their slots ``keep``) unlinked. A padded row's
        slot is the slot count: it lands on a dump slot past the last,
        which is dropped, so no padded row writes over a live verdict."""
        K, N = arena.n_kf_cap, arena.n_feat
        inl = torch.zeros(K * N + 1, dtype=torch.bool,
                          device=active.device).index_copy_(0, keep,
                                                            active)[:-1]
        kill = (obs_valid & ~inl).reshape(K, N)
        obs = torch.where(kill, torch.full_like(arena.kf_obs_lm, SM.NO_LM),
                          arena.kf_obs_lm)
        arena.kf_R.copy_(out.R)
        arena.kf_t.copy_(out.t)
        arena.lm_pos.copy_(out.X)
        arena.kf_obs_lm.copy_(obs)
        return arena

    def gba_b(self, arena: SM.MapArena) -> List[torch.Tensor]:
        """Graph B: the global BA problem over every slot of the
        observation table (``dist.global_ba_problem_from_arena``), the
        solve's copies of the poses and points, the scale gauge's entry
        state and the live count. Returns [the problem's fields, R, t, X,
        the 4 gauge tensors, the count]."""
        prob = D.global_ba_problem_from_arena(self.cam, arena,
                                              self.inv_level_sigma2)
        return [*prob, prob.R.clone(), prob.t.clone(), prob.X.clone(),
                *_gauge_entry(prob), prob.obs_valid.sum()]

    @staticmethod
    def gba_p(b: List[torch.Tensor], cap: int) -> List[torch.Tensor]:
        """Graph P at capacity ``cap`` from graph B's outputs ``b``: the
        padded problem's edges (``padded_ba_problem``), their slots, the
        active edges and the camera, point and cost plans, flat."""
        padded, keep = LoopKernels.padded_ba_problem(BAProblem(*b[:_NP]),
                                                     cap)
        plans = (*_cg_plans(padded), _cost_plan(padded))
        return [*(getattr(padded, f) for f in D.EDGE_FIELDS), keep,
                padded.obs_valid.clone(),
                *(x for plan in plans for x in plan.parts())]

    @staticmethod
    def gba_solve(b: List[torch.Tensor], p: List[torch.Tensor],
                  lm_lambda: torch.Tensor, robust: torch.Tensor) -> CGSolve:
        """The ``CGSolve`` on graph B's and P's outputs and the damping and
        flag buffers: no launch."""
        E, n = len(D.EDGE_FIELDS), SegmentPlan.N_PARTS
        prob = BAProblem(*b[:_NP])._replace(
            R=b[_NP], t=b[_NP + 1], X=b[_NP + 2],
            **dict(zip(D.EDGE_FIELDS, p[:E])))
        parts = p[E + 2:]
        plans = tuple(SegmentPlan.from_parts(parts[i * n:(i + 1) * n], m)
                      for i, m in enumerate((prob.R.shape[0],
                                             prob.X.shape[0], 1)))
        return CGSolve(prob, p[E + 1], lm_lambda, robust, plans)

    @staticmethod
    def gba_w(arena: SM.MapArena, b: List[torch.Tensor],
              p: List[torch.Tensor], st: CGSolve) -> List[torch.Tensor]:
        """Graph W: the scale gauge's retraction of the solved ``st`` and
        ``write_global_ba``; no output."""
        out = _gauge_retract(st.prob, b[_NP + 3:_NP + 7])
        LoopKernels.write_global_ba(arena, out, st.active,
                                    p[len(D.EDGE_FIELDS)],
                                    BAProblem(*b[:_NP]).obs_valid)
        return []

    # ------------------------------------------------------------------
    # CorrectLoop as the system's captured graphs (runtime/fused_loop.py)
    # ------------------------------------------------------------------

    def correct_c(self, arena: SM.MapArena, s: dict) -> List[torch.Tensor]:
        """Graph C on the static inputs ``s`` (the slots, S_cl, loop_assoc,
        neigh_pre, the past loop edges): ``loop_fuse``, then ``_propagate``
        and the vertices' constants of the solve. Returns [own, lm_pos, s,
        R, t (the solve's state), free, free7, keep, diag, the six masked
        edge tensors, the valid-edge count]."""
        self.loop_fuse(arena, s["k_cur"], s["loop_assoc"])
        own, lm_pos, state, fixed, edges = self._propagate(
            arena, s["k_cur"], s["k_loop"], s["s_cl"], s["R_cl"], s["t_cl"],
            s["neigh_pre"], s["loop_i"], s["loop_j"], s["loop_ok"])
        verts = PG.vertex_terms(arena.kf_valid, fixed, state[0].dtype)
        return [own, lm_pos, *state, *verts, *edges, edges[-1].sum()]

    @staticmethod
    def correct_problem(c: List[torch.Tensor], cap: int
                        ) -> List[torch.Tensor]:
        """The solve's edges at capacity ``cap`` from graph C's outputs
        ``c``: the five padded edge tensors, then ``PG.edge_terms``."""
        padded = LoopKernels.padded_edges(c[9:15], cap)
        return [*padded[:-1], *PG.edge_terms(padded[0], padded[1],
                                             padded[-1], c[2].shape[0],
                                             c[2].dtype)]

    @staticmethod
    def correct_step(c: List[torch.Tensor], p: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """One Gauss-Newton iteration on graph C's state (``c``, updated in
        place) and the problem ``p`` of ``correct_problem``; no output."""
        PG.gauss_newton_step(*c[2:5], c[5:9], *p[:5], p[5:])
        return []

    def correct_f(self, arena: SM.MapArena, s: dict,
                  c: List[torch.Tensor]) -> List[torch.Tensor]:
        """Graph F: the remap from the solved state of graph C's outputs
        ``c``, ``loop_member_landmarks``, ``search_and_fuse`` over the
        ``MAX_NEIGH`` masked slots and the landmark statistics over every
        slot of the observation table (no read)."""
        self.remap(arena, *c[:5])
        sel, sel_ok = self.loop_member_landmarks(
            arena, min(MAX_LOOP_LANDMARKS, arena.n_lm_cap), s["k_loop"])
        slots, ok = self.corrected_slots(arena, s["k_cur"], s["neigh_pre"])
        self.search_and_fuse(arena, slots, sel, sel_ok, ok)
        SM.update_landmark_stats_all(arena, self.scale_factors)
        return []


class LoopCloser:
    """The host state machine of loop closing (``loop_closing.py:489-712``):
    ``process(system, slot)`` on each new keyframe. ``system`` has the
    ``arena``, the keyframe counter ``n_kf``, the ``bow_table`` and the
    RANSAC ``generator``, and may hand out loop graphs
    (``fused_loop_for``, ``runtime/fused_loop.py::LoopGraphOwner``).
    ``reads`` and ``eigh_waits`` are the last call's host reads and
    eigen-solve waits; ``timings`` the wall seconds of each event by stage
    (detect, sim3, correct, gba); ``sim3_trace`` the last ComputeSim3's
    device tensors as far as it got (the RANSAC's s, R, t, its inlier
    count, the widened match count, the refinement's s, R, t, inliers and
    count), read by nothing here.

    On the card DetectLoop and ComputeSim3 replay the captured graphs D, M
    and S of the ``FusedLoop`` that the system owns and hands out
    (``system.fused_loop_for``), CorrectLoop the graphs C, the
    Gauss-Newton step at the closure's edge capacity and F of its
    ``FusedCorrect`` (``FusedLoop.correction``), and the global BA the
    graphs B, P, L, X and W at the live count's edge capacity of its
    ``FusedGlobalBA`` (``FusedLoop.global_ba``), each captured on its first
    call and replayed on every later one, across keyframes and closures; a
    system that hands out none (one without ``fused_loop_for``, or any off
    the card) runs them eagerly, but for the two solves: on the card the
    pose graph's iterations run through a ``CapturedLoop`` made for that
    solve and dropped after it (the first iteration eagerly, then captured
    as one CUDA graph and replayed for the others, with the same bits as
    the eager iterations), and the global BA through a ``FusedGlobalBA``
    made for it.
    ``graphs = False``, or a ``system`` whose ``stage_times`` is set
    (``CubemapSLAM``'s eager switch), runs all of them as eager launches;
    so does the sharded global BA. ``graph_counts`` holds the last call's
    captures, replays, capture ms and pool MiB of all these graphs, and
    ``capture_waits`` the host waits of its captures
    (``fused_step.CAPTURE_WAITS`` each); a failed capture or replay
    raises."""

    def __init__(self, cfg: SlamConfig, cam: CubemapCamera):
        self.cfg, self.cam = cfg, cam
        self.k = LoopKernels(cfg, cam)
        self.consistency_th = 3       # mnCovisibilityConsistencyTh
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_counter = -100  # keyframe counter at the last loop
        self.loop_edges: List[Tuple[int, int]] = []
        self.timings: dict = {}
        self.sim3_trace: dict = {}
        self.graphs = True
        self._reset_counts()

    def _reset_counts(self) -> None:
        self.reads = self.eigh_waits = self.capture_waits = 0
        self.graph_counts = dict(captures=0, replays=0, capture_ms=0.0,
                                 capture_mib=0.0)

    def _eager(self, system) -> bool:
        """Whether every loop stage runs eagerly: ``graphs`` off, or a
        ``system`` that times its stages."""
        return not self.graphs \
            or getattr(system, "stage_times", None) is not None

    def _loop(self, system):
        """The runner of one solve's iterations: a new ``CapturedLoop``,
        or None (eager)."""
        if self._eager(system):
            return None
        return CapturedLoop(self.cam.device)

    def _fused_loop(self, system):
        """The ``FusedLoop`` that the system hands this closer
        (``system.fused_loop_for``), or None: eagerly (``_eager``), or where
        the system hands out none."""
        if self._eager(system):
            return None
        ask = getattr(system, "fused_loop_for", None)
        return None if ask is None else ask(self.k)

    @staticmethod
    def _fused_counts(fl):
        """Captures, replays, capture ms and pool MiB so far of the
        ``FusedLoop``, its ``FusedCorrect`` and its ``FusedGlobalBA``."""
        if fl is None:
            return (0, 0, 0.0, 0.0)
        return tuple(sum(x) for x in zip(*(
            (g.captures, g.replays, g.capture_ms, g.capture_mib)
            for g in (fl, fl.correction, fl.global_ba))))

    def _count(self, loop) -> None:
        """Add one solve's captures, replays, capture ms, pool MiB and
        capture waits to the call's counts."""
        if loop is None:
            return
        self._add_counts(loop.captures, loop.replays, loop.capture_ms,
                         loop.capture_mib)

    def _add_counts(self, captures, replays, ms, mib) -> None:
        c = self.graph_counts
        c["captures"] += captures
        c["replays"] += replays
        c["capture_ms"] += ms
        c["capture_mib"] += mib
        self.capture_waits += captures * CAPTURE_WAITS

    def _sync(self) -> None:
        if self.cam.device.type == "cuda":
            torch.cuda.synchronize(self.cam.device)
            self.reads += 1

    def _lap(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.timings.setdefault(name, []).append(now - t0)
        return now

    def reset(self) -> None:
        self.consistent_groups = []
        self.last_loop_counter = -100
        self.loop_edges = []

    def process(self, system, slot: int) -> bool:
        """DetectLoop + ComputeSim3 + CorrectLoop for a new keyframe in
        ``slot``. Returns True if a loop was closed."""
        self._reset_counts()
        fl = self._fused_loop(system)
        before = self._fused_counts(fl)
        try:
            return self._process(system, slot, fl)
        finally:
            self._add_counts(*(b - a for a, b in
                               zip(before, self._fused_counts(fl))))

    def _process(self, system, slot: int, fl) -> bool:
        # >= 10 keyframes in all and since the last loop, on the monotonic
        # counter (slots are recycled)
        if system.n_kf < 10 or system.n_kf - self.last_loop_counter < 10:
            return False
        t0 = time.perf_counter()
        with span("loop.detect"):
            if fl is None:
                host = pack_detection(*self.k.detect_candidates_fused(
                    system.arena, system.bow_table, slot)).tolist()
            else:
                host = fl.detect(system, slot)
            self.reads += 1
        self._lap("detect", t0)
        n = N_CANDIDATES
        K = len(host) // n - 2
        ok = host[:n]
        if not any(ok):
            self.consistent_groups = []
            return False
        # the 3-consecutive-keyframe consistency (LoopClosing.cpp:151-210)
        enough = []
        new_groups: List[Tuple[Set[int], int]] = []
        for r in range(n):
            if not ok[r]:
                continue
            c = host[n + r]
            row = host[2 * n + r * K:2 * n + (r + 1) * K]
            group = {i for i, g in enumerate(row) if g} | {c}
            matched = False
            for prev_set, streak in self.consistent_groups:
                if group & prev_set:
                    new_groups.append((group, streak + 1))
                    if streak + 1 >= self.consistency_th:
                        enough.append(c)
                    matched = True
                    break
            if not matched:
                new_groups.append((group, 0))
        self.consistent_groups = new_groups
        for c in enough:
            if self._try_close(system, slot, c):
                self.last_loop_counter = system.n_kf
                self.consistent_groups = []
                return True
        return False

    def _try_close(self, system, k_cur: int, k_loop: int) -> bool:
        """ComputeSim3 against one consistent candidate, then CorrectLoop
        and the global BA (``loop_closing.py:574-670``)."""
        t0 = time.perf_counter()
        with span("loop.sim3"):
            found = self._compute_sim3(system, k_cur, k_loop)
        if found is None:
            return False
        t0 = self._lap("sim3", t0)
        with span("loop.correct"):
            self._correct(system, k_cur, k_loop, *found)
            self._sync()
        t0 = self._lap("correct", t0)
        with span("loop.gba"):
            self._global_ba(system)
            self._sync()
        self._lap("gba", t0)
        return True

    def _compute_sim3(self, system, k_cur: int, k_loop: int):
        """ComputeSim3 (``loop_closing.py:577-619``): the keyframe-pair
        match, RANSAC, the widening, the refinement and the S_cw gate, each
        gate on one read (through the system's ``FusedLoop``'s graphs M and
        S, two reads in all). Returns (S_cl, loop_assoc, the current
        keyframe's covisible set, the same as host slots) or None."""
        self.sim3_trace = {}
        fl = self._fused_loop(system)
        if fl is not None:
            return self._compute_sim3_graphs(fl, system, k_cur, k_loop)
        k, arena, trace = self.k, system.arena, self.sim3_trace
        with span("loop.sim3.match"):
            idx2, ok = k.match_kf_pair(arena, k_cur, k_loop)
            n_match = int(ok.sum())
        self.reads += 1
        if n_match < 20:
            return None
        with span("loop.sim3.ransac"):
            res = k.sim3_ransac(arena, k_cur, k_loop, idx2, ok,
                                system.generator)
            success = bool(res.success)
        self.reads += 1
        self.eigh_waits += S3.EIGH_WAITS
        if not success:
            return None
        # widen the match set with the RANSAC Sim3 before the refinement
        kept = ok & res.inliers
        with span("loop.sim3.widen"):
            idx2, ok_wide = k.search_by_sim3(arena, k_cur, k_loop, res.s12,
                                             res.R12, res.t12, idx2, kept)
        trace.update(ransac=(res.s12, res.R12, res.t12),
                     ransac_inliers=kept.sum(), widened=ok_wide.sum())
        with span("loop.sim3.refine"):
            s, R, t, inl, n_inl = trace["refined"] = k.refine_sim3(
                arena, k_cur, k_loop, idx2, ok_wide, res.s12, res.R12,
                res.t12)
            n_inl = int(n_inl)
        self.reads += 1
        if n_inl < 20:
            return None
        # the S_cw projection gate, read with the current keyframe's
        # covisible set before fusion (mvpCurrentConnectedKFs)
        with span("loop.sim3.scw"):
            loop_assoc, total, neigh_pre = k.scw_gate(
                arena, k_cur, k_loop, (s, R, t), idx2, ok_wide & inl)
            host = torch.cat([total.reshape(1),
                              neigh_pre.to(torch.int64)]).tolist()
        self.reads += 1
        if host[0] < 40:
            return None
        neigh_np = [i for i, v in enumerate(host[1:]) if v]
        return (s, R, t), loop_assoc, neigh_pre, neigh_np

    def _compute_sim3_graphs(self, fl, system, k_cur: int, k_loop: int):
        """``_compute_sim3`` through ``FusedLoop``: graph M and its read,
        the gate of 20 matches, the RANSAC's scores drawn from
        ``system.generator`` (as the eager RANSAC draws them), graph S and
        its read, then the three gates in the eager order."""
        n_match = fl.match(system, k_cur, k_loop)
        self.reads += 1
        if n_match < 20:
            return None
        scores = draw_scores(system.generator, self.cfg.sim3_ransac_iters,
                             system.arena.n_feat, self.cam.device)
        (success, n_inl, total), neigh, (sim3, loop_assoc, neigh_pre), \
            trace = fl.sim3(system, scores)
        self.reads += 1
        if success:
            self.sim3_trace = trace
        self.eigh_waits += S3.EIGH_WAITS
        if not success or n_inl < 20 or total < 40:
            return None
        neigh_np = [i for i, v in enumerate(neigh) if v]
        return sim3, loop_assoc, neigh_pre, neigh_np

    def _correct(self, system, k_cur: int, k_loop: int, sim3, loop_assoc,
                 neigh_pre, neigh_np) -> None:
        """CorrectLoop (``loop_closing.py:621-661``), in place: loop fusion,
        the propagation and pose graph, SearchAndFuse over the corrected
        neighbourhood, the landmark statistics. Through the system's
        ``FusedCorrect`` (graphs C, a Gauss-Newton step and F) where it
        hands out a ``FusedLoop``, else eagerly."""
        fl = self._fused_loop(system)
        if fl is not None:
            fl.correction.correct(system, k_cur, k_loop, sim3, loop_assoc,
                                  neigh_pre, self.loop_edges,
                                  POSE_GRAPH_ITERS)
            self.reads += 1
            self.loop_edges.append((k_cur, k_loop))
            return
        k, arena = self.k, system.arena
        # fuse the loop landmarks into the current keyframe before the pose
        # graph, so that the covisibility edges it makes take part
        with span("loop.correct.fuse"):
            k.loop_fuse(arena, k_cur, loop_assoc)
        loop = self._loop(system)
        k.propagate_and_pose_graph(arena, k_cur, k_loop, *sim3, neigh_pre,
                                   self.loop_edges, loop)
        self._count(loop)
        del loop                # its graph and pool with it
        self.reads += 1
        self.loop_edges.append((k_cur, k_loop))
        # SearchAndFuse over the whole corrected neighbourhood: the current
        # keyframe and its pre-fusion covisible keyframes
        with span("loop.correct.search_and_fuse"):
            neigh = [k_cur] + [i for i in neigh_np[:MAX_NEIGH - 1]
                               if i != k_cur]
            sel, sel_ok = k.loop_member_landmarks(
                arena, min(MAX_LOOP_LANDMARKS, arena.n_lm_cap), k_loop)
            k.search_and_fuse(arena, neigh, sel, sel_ok)
        with span("loop.correct.stats"):
            SM.update_landmark_stats(arena, k.scale_factors)
            self.reads += 1

    def _global_ba(self, system) -> None:
        """The post-loop global BA (``loop_closing.py:672-712``): two
        phases (5 robust iterations, the chi2 cut, 10 more) of 50 CG
        iterations each step, then the outlier observations removed, in
        place. The problem spans every slot of the observation table (K*N);
        its live count is read once and picks a capacity
        (``LoopKernels.ba_edge_capacity``), and the solve takes the live
        edges padded to it (``padded_ba_problem``), whose segment sums,
        the cost's among them, are those of the masked problem with its
        zeros left out. It runs through a ``FusedGlobalBA``: the system's
        (``FusedLoop.global_ba``) where it hands out a ``FusedLoop``, else
        one made for this solve and dropped after it, its parts captured
        on the card unless ``_eager``; every way gives the same bits. With
        ``torch.distributed`` initialized over more than one rank, rank 0's
        problem is broadcast and its live edges, compacted, are solved
        sharded (``_global_ba_sharded``), where the JAX package shards all
        K*N slots; that branch stays eager, since its collectives do not go
        into a graph."""
        arena = system.arena
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            fl = self._fused_loop(system)
            gba = fl.global_ba if fl is not None else FusedGlobalBA(
                self.k, graphs=not self._eager(system))
            gba.solve(system, GBA_PHASES, GBA_CG_ITERS)
            self.reads += 1
            if fl is None:
                self._count(gba)    # its graphs and pool go with it
            return
        with span("loop.gba.build"):
            prob = D.broadcast_problem(
                D.global_ba_problem_from_arena(self.cam, arena,
                                               self.k.inv_level_sigma2),
                D.make_mesh())
            keep = prob.obs_valid.nonzero()[:, 0]
            self.reads += 1
            live = prob._replace(**{f: getattr(prob, f)[keep]
                                    for f in D.EDGE_FIELDS})
        out, active = self._global_ba_sharded(live)
        with span("loop.gba.write"):
            self.k.write_global_ba(arena, out, active, keep, prob.obs_valid)

    def _global_ba_sharded(self, live):
        """The multi-rank branch of the global BA (``loop_closing.py:684-
        700``): the live-edge problem sharded into one keyframe block a rank
        with landmark ownership, solved SPMD over the default group, the
        inliers scattered back to the live order and the points un-permuted.
        Returns (the solved problem, the live edges' inliers)."""
        mesh = D.make_mesh()
        sharded = D.shard_ba_problem(live, dist.get_world_size(mesh),
                                     shard_points=True)
        self.reads += D.SHARD_READS
        out, inl_s = D.distributed_bundle_adjust(
            self.cam, sharded, mesh, phase_iters=GBA_PHASES,
            cg_iters=GBA_CG_ITERS)
        dev = inl_s.device
        real = np.nonzero(sharded.edge_perm >= 0)[0]
        inl = torch.zeros_like(live.obs_valid).index_copy_(
            0, torch.as_tensor(sharded.edge_perm[real], device=dev),
            inl_s[torch.as_tensor(real, device=dev)])
        X = torch.empty_like(out.X).index_copy_(
            0, torch.as_tensor(sharded.point_perm, device=dev), out.X)
        return out._replace(X=X), inl
