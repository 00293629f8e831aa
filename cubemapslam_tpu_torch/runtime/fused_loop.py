"""Loop closing's DetectLoop, ComputeSim3, CorrectLoop and global BA as
captured CUDA graphs.

``FusedLoop`` is the port's counterpart of the JAX package's jitted loop
stages (``cubemapslam_tpu/runtime/loop_closing.py``:
``detect_candidates_fused`` :43, ``match_kf_pair`` :66, ``search_by_sim3``
:92, ``sim3_candidates`` :155, ``refine_sim3`` :173, whose OptimizeSim3 is a
``lax.fori_loop``, and ``scw_project`` :187), driven there by
``_try_close`` (:574-619), whose ``sim3_ransac`` (:591) runs outside any
jit. ``LoopCloser`` runs them through it on the card, as three graphs in a
pool of their own, captured on first use and replayed on every later call,
across keyframes and across closures:

* graph D, DetectLoop's program: ``LoopKernels.detect_candidates_fused`` of
  the new keyframe's slot, packed into the row (flags, candidates, their
  covisibility groups) that the host reads once; it runs on every keyframe
  from the tenth;
* graph M, the keyframe-pair match (``match_kf_pair``) and its count, read
  once for the gate of 20 matches;
* graph S, the rest of ComputeSim3: ``LoopKernels.sim3_ransac`` on the
  given scores (its two Horn eigen-solves are launches of the ``sym_eig``
  kernel), the SearchBySim3 widening, OptimizeSim3, the covisibility
  matrix, ``scw_project`` and the current keyframe's covisible set; the
  RANSAC verdict, the refined inlier count and the S_cw match count come
  back with that set in one packed read. OptimizeSim3's 15 Gauss-Newton
  steps sit in the graph unrolled: graph S is captured once a system and
  replayed whole, where a ``CapturedLoop`` would launch each step from the
  host. ``scw_project`` takes the landmarks in blocks
  (``loop_closing.SCW_QUERY_CHUNK``), so that the pool, which the system
  keeps for its life, does not hold its (L, N) matrices.

The host applies the three gates in the eager order (the RANSAC verdict,
20 refined inliers, 40 S_cw matches). Graph S also runs its later stages
when an earlier gate fails: they only read the arena and the static
inputs, so they change no arena byte and no generator state, and the host
drops what they computed. ComputeSim3 reads the card twice, where the eager
path reads up to 4 times, and no eigen-solve waits.

Static inputs. The slots are 0-d device tensors written by fills (each
stage takes them through ``index_select`` / ``index_fill_``, so no slot is
baked into a graph). The RANSAC's (n_iters, N) scores are drawn from
``system.generator`` outside the graphs, after the match gate, as the
eager ``sim3_ransac`` draws them, and copied into a static buffer, so the
generator advances as it does eagerly and the graphs give the eager bits.
Graph S reads graph M's outputs, so M is always replayed before S.

``FusedCorrect`` (``FusedLoop.correction``, its own pool) holds the
counterparts of CorrectLoop's jitted programs (``loop_fuse`` :311,
``propagate_and_pose_graph`` :334, one program there over all K + K^2 + 17
masked edges, ``loop_member_landmarks`` :238, ``search_and_fuse`` :258, a
``lax.fori_loop`` over 16 masked slots, and ``slam_map.
update_landmark_stats``), driven there by ``_try_close`` (:621-661):

* graph C: ``loop_fuse``, the seeded Sim3s, the neighbourhood's landmark
  remap, the essential graph's masked edges with their measurements, the
  vertices' constants of the solve and the valid-edge count;
* one host read of that count, which picks the edge capacity
  (``LoopKernels.edge_capacity``: the next power of two, at least 256);
* the solve's edges at that capacity (the valid ones compacted in order,
  masked rows after them, which the pose graph's plans drop) and their
  segment plans, built eagerly into that capacity's static buffers (about
  60 launches, no read);
* the Gauss-Newton step of that capacity, run 12 times: the first run
  captures it (its first iteration eagerly, then the capture), every later
  one, in this closure and the next, replays it; one step graph a
  capacity met, all in this object's pool;
* graph F: the SE3 recovery and the remap of every landmark,
  ``loop_member_landmarks``, ``search_and_fuse`` over the 16 masked slots
  (``LoopKernels.corrected_slots``) and the landmark statistics over every
  slot of the observation table (``slam_map.update_landmark_stats_all``,
  the descriptor bits unpacked in blocks of rows), with no read.

Its static inputs: the slots and the past loop edges by fills, S_cl,
loop_assoc and neigh_pre (graph S's outputs, as ``sim3`` returns them)
copied on the device. The eager path pads the edges to the same capacity,
so both give the same bits.

``FusedGlobalBA`` (``FusedLoop.global_ba``, its own pool) holds the
counterpart of the post-loop global BA (``_global_ba`` :672-712, whose
``bundle_adjust`` runs all K*N masked observation slots through one
compiled program, a ``lax.fori_loop`` a phase, ``optim/ba.py:624``):

* graph B: ``dist.global_ba_problem_from_arena`` over all K*N slots, the
  solve's copies of the poses and points, the scale gauge's entry state
  (fixed (K,) shapes, rows by ``index_select``) and the live count;
* one host read of that count, which picks the edge capacity
  (``LoopKernels.ba_edge_capacity``: the count rounded up to a multiple of
  2^(bit_length - 4), at least 4096);
* graph P at that capacity: the live edges compacted in order on the
  device, masked rows after them (``padded_ba_problem``), the active edges
  and the camera, point and cost plans, which drop the masked rows, so
  every sum of the solve keeps the compacted order;
* the LM phases of ``optim.ba.cg_phases``, the loop that the eager solve
  (``bundle_adjust``) runs too, with its parts as graphs: graph L at that
  capacity, one LM step (``cg_lm_step``), run 15 times: the first run
  ever captures it (an eager step, then the capture), every later one
  replays it, in this closure and the next; the robust flag and the
  damping are filled between the phases, outside the graph; graph X at
  that capacity, the chi2 and FOV cut (``cg_cut``), after each phase;
* graph W at that capacity: the gauge's retraction and the write-back
  (``LoopKernels.write_global_ba``): the inlier verdicts put back on their
  slots, a padded row's on a dump slot past the last, and the arena's
  ``kf_R``, ``kf_t``, ``lm_pos`` and ``kf_obs_lm`` written in place.

One instance serves every closure of the system; a count in another
capacity captures that capacity's P, L, X and W (B is shared), and holds
the graphs of the two capacities used last (``FusedGlobalBA.kept``): a
third drops the older's, whose blocks the pool reuses, so a map that grows
closure by closure holds a bounded pool. A capture synchronizes nothing
and keeps the allocator's cache (``fused_step.CapturedFrame.run``). Every
single-process global BA runs through a ``FusedGlobalBA``: the system's,
one made for the solve where the system hands out none, or one that runs
its parts eagerly (``graphs=False``), so every path gives the same bits.

Graphs D, M and S read the arena and ``system.bow_table`` and write
neither; C, the steps, F and W write the arena in place. Each table is
checked by ``data_ptr`` before a call and a moved one raises. They
also read the ``LoopKernels``' own tensors (the level sigmas, the scale
factors, the camera's), so this object holds the ``LoopKernels`` it was made
with and runs every part on them. The system owns it (``LoopGraphOwner``,
which ``CubemapSLAM`` is): it makes it on its loop closer's first request
on the card, serves it to a loop closer made later with the same
configuration (whose replays read constants that stay alive) and raises for
another, and drops it where it replaces what the graphs read
(``CubemapSLAM.drop_graphs``: ``reset``, ``serialize.load_map``; a
vocabulary retrain, which replaces the BoW table). The outputs the caller
keeps are cloned after the replay. The capture machinery, the launch counts
added back on each replay and the lack of any fallback are
``CapturedFrame``'s (``runtime/fused_step.py``); on the CPU each part runs
eagerly on the same static buffers.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from cubemapslam_tpu_torch._build import cusolver
from cubemapslam_tpu_torch.optim.ba import CHI2_TH, cg_phases
from cubemapslam_tpu_torch.runtime.fused_step import CapturedFrame
from cubemapslam_tpu_torch.spans import span


def pack_detection(cand_idx: torch.Tensor, cand_ok: torch.Tensor,
                   groups: torch.Tensor) -> torch.Tensor:
    """DetectLoop's result as one int64 row for one read: the flags, the
    candidates, then their covisibility groups row by row."""
    return torch.cat([cand_ok.to(torch.int64), cand_idx,
                      groups.reshape(-1).to(torch.int64)])


class FusedLoop(CapturedFrame):
    """Static buffers, graphs D, M and S and their pool for one system's
    loop closing on the ``LoopKernels`` ``k``: ``detect(system, slot)``,
    ``match(system, k_cur, k_loop)`` and ``sim3(system, scores)``."""

    label = "fused loop"
    owner = "loop"

    def __init__(self, k):
        super().__init__(k.cam.device)
        self.k = k
        self.correction = FusedCorrect(k)
        self.global_ba = FusedGlobalBA(k)

    def check_system(self, system) -> None:
        """``check`` on the arena's tables and the BoW table."""
        named = [(f"arena.{f}", getattr(system.arena, f))
                 for f in system.arena._fields]
        self.check(named + [("bow_table", system.bow_table)])

    def _part_d(self, system) -> List[torch.Tensor]:
        return [pack_detection(*self.k.detect_candidates_fused(
            system.arena, system.bow_table, self.inputs["slot"]))]

    def _part_m(self, system) -> List[torch.Tensor]:
        s = self.inputs
        idx2, ok = self.k.match_kf_pair(system.arena, s["k_cur"],
                                        s["k_loop"])
        return [idx2, ok, ok.sum()]

    def _part_s(self, system) -> List[torch.Tensor]:
        """Graph S on graph M's matches: (the refined s, R, t, inliers and
        inlier count, loop_assoc, neigh_pre, the RANSAC's s, R, t, [success,
        n_inliers, total, the RANSAC's inlier count, the widened match
        count, neigh_pre...])."""
        k, a, s = self.k, system.arena, self.inputs
        kc, kl = s["k_cur"], s["k_loop"]
        idx2, ok = self.outputs["m"][:2]
        res = k.sim3_ransac(a, kc, kl, idx2, ok, None, scores=s["scores"])
        idx2, ok_wide = k.search_by_sim3(a, kc, kl, res.s12, res.R12,
                                         res.t12, idx2, ok & res.inliers)
        s12, R12, t12, inl, n_inl = k.refine_sim3(a, kc, kl, idx2, ok_wide,
                                                  res.s12, res.R12, res.t12)
        loop_assoc, total, neigh_pre = k.scw_gate(
            a, kc, kl, (s12, R12, t12), idx2, ok_wide & inl)
        packed = torch.cat([res.success.reshape(1).to(torch.int64),
                            n_inl.reshape(1), total.reshape(1),
                            (ok & res.inliers).sum().reshape(1),
                            ok_wide.sum().reshape(1),
                            neigh_pre.to(torch.int64)])
        return [s12, R12, t12, inl, n_inl, loop_assoc, neigh_pre, res.s12,
                res.R12, res.t12, packed]

    def detect(self, system, slot: int) -> List[int]:
        """Graph D on keyframe ``slot``: the packed row, read to the host
        (one read)."""
        self.check_system(system)
        self._fill("slot", slot, torch.int64)
        return self.run("d", lambda: self._part_d(system))[0].tolist()

    def match(self, system, k_cur: int, k_loop: int) -> int:
        """Graph M on the pair: the match count, read to the host (one
        read); the matches stay in the graph's outputs for graph S."""
        self.check_system(system)
        self._fill("k_cur", k_cur, torch.int64)
        self._fill("k_loop", k_loop, torch.int64)
        return int(self.run("m", lambda: self._part_m(system))[2])

    def sim3(self, system, scores: torch.Tensor):
        """Graph S on the pair and matches of the last ``match``, with the
        RANSAC's ``scores``, after one read. Returns ((success, n_inliers,
        total), the covisible set's flags, (S_cl, loop_assoc, neigh_pre),
        and the trace of ``LoopCloser.sim3_trace``), the tensors cloned."""
        self.check_system(system)
        self._copy("scores", scores)
        out = [x.clone() for x in self.run("s", lambda: self._part_s(system))]
        host = out[-1].tolist()
        trace = dict(ransac=tuple(out[7:10]), ransac_inliers=out[-1][3],
                     widened=out[-1][4], refined=tuple(out[:5]))
        return (tuple(host[:3]), host[5:], (tuple(out[:3]), out[5], out[6]),
                trace)


class FusedCorrect(CapturedFrame):
    """Static buffers, graphs C, F and a Gauss-Newton step a capacity, and
    their pool, for one system's CorrectLoop on the ``LoopKernels`` ``k``:
    ``correct(system, ...)``."""

    label = "fused correct"
    owner = "correct"

    def __init__(self, k):
        super().__init__(k.cam.device)
        self.k = k

    def check_system(self, system) -> None:
        """``check`` on the arena's tables."""
        self.check([(f"arena.{f}", getattr(system.arena, f))
                    for f in system.arena._fields])

    def _load(self, k_cur, k_loop, sim3, loop_assoc, neigh_pre,
              loop_edges) -> None:
        """The closure's inputs into the static buffers: the slots and the
        past loop edges by fills, S_cl, loop_assoc and neigh_pre by copies
        on the device."""
        self._fill("k_cur", k_cur, torch.int64)
        self._fill("k_loop", k_loop, torch.int64)
        for name, x in zip(("s_cl", "R_cl", "t_cl"), sim3):
            self._copy(name, x)
        self._copy("loop_assoc", loop_assoc)
        self._copy("neigh_pre", neigh_pre)
        if "loop_i" not in self.inputs:
            self.inputs.update(zip(("loop_i", "loop_j", "loop_ok"),
                                   self.k.loop_edge_buffers(self.device)))
        self.k.fill_loop_edges(loop_edges, tuple(
            self.inputs[n] for n in ("loop_i", "loop_j", "loop_ok")))

    def correct(self, system, k_cur, k_loop, sim3, loop_assoc, neigh_pre,
                loop_edges, n_iters: int) -> int:
        """CorrectLoop on the system's arena, in place: graph C, the one
        read of the valid-edge count, the problem at its capacity built
        into that capacity's static buffers, ``n_iters`` runs of the step
        graph of that capacity (the first captures it, once a system), then
        graph F. Returns the count."""
        self.check_system(system)
        arena, s = system.arena, self.inputs
        with span("loop.correct.fuse"):
            self._load(k_cur, k_loop, sim3, loop_assoc, neigh_pre,
                       loop_edges)
        with span("loop.correct.propagate"):
            c = self.run("c", lambda: self.k.correct_c(arena, s))
            count = int(c[-1])                          # the one host read
        cap = self.k.edge_capacity(count, c[-2].shape[0])
        with span("loop.correct.pose_graph"), cusolver(self.device):
            names = []
            for i, x in enumerate(self.k.correct_problem(c, cap)):
                names.append(f"p{cap}.{i}")
                self._copy(names[-1], x)
            p = [s[n] for n in names]
            for _ in range(n_iters):
                self.run(f"g{cap}", lambda: self.k.correct_step(c, p))
        with span("loop.correct.remap"):
            self.run("f", lambda: self.k.correct_f(arena, s, c))
        return count

    @property
    def capacities(self) -> List[int]:
        """The edge capacities whose step graph this object holds."""
        return sorted(int(n[1:]) for n in self.outputs if n[0] == "g")


class FusedGlobalBA(CapturedFrame):
    """Static buffers, graphs B, P, L, X and W at the edge capacities met
    last, and their pool, for the post-loop global BA on the
    ``LoopKernels`` ``k``: ``solve(system, phase_iters, cg_iters)``. A
    system holds one for every closure; ``LoopCloser`` makes one for a
    single solve where the system hands out none, and one with
    ``graphs=False`` for the eager path, whose parts run as called."""

    label = "fused global BA"
    owner = "gba"
    # the edge capacities whose graphs P, L, X and W are held: a growing
    # map meets a new capacity every few keyframes, so a new one drops the
    # least recently used beyond these, and the pool takes its blocks back
    kept = 2

    def __init__(self, k, graphs: bool = True):
        super().__init__(k.cam.device, graphs)
        self.k = k
        self._recent: List[int] = []
        # the damping and the robust flag, which cg_phases fills and graph
        # L updates
        self.inputs.update(
            lm_lambda=torch.empty((), dtype=torch.float32, device=self.device),
            robust=torch.empty((), dtype=torch.bool, device=self.device))

    def check_system(self, system) -> None:
        """``check`` on the arena's tables."""
        self.check([(f"arena.{f}", getattr(system.arena, f))
                    for f in system.arena._fields])

    def solve(self, system, phase_iters, cg_iters: int) -> int:
        """The global BA on the system's arena, in place: graph B, the one
        read of the live count, graph P of that count's capacity, the LM
        phases (``optim.ba.cg_phases``: graph L a step, graph X a cut),
        then graph W. Returns the count."""
        self.check_system(system)
        arena, k = system.arena, self.k
        with span("loop.gba.build"):
            b = self.run("b", lambda: k.gba_b(arena))
            count = int(b[-1])                          # the one host read
            cap = k.ba_edge_capacity(count, arena.n_kf_cap * arena.n_feat)
            self._hold(cap)
            p = self.run(f"p{cap}", lambda: k.gba_p(b, cap))
        st = k.gba_solve(b, p, self.inputs["lm_lambda"],
                         self.inputs["robust"])
        cg_phases(k.cam, st, phase_iters, CHI2_TH, cg_iters,
                  lambda name, part: self.run(f"{name}{cap}", part))
        with span("loop.gba.write"):
            self.run(f"w{cap}", lambda: k.gba_w(arena, b, p, st))
        return count

    def _hold(self, cap: int) -> None:
        """Mark capacity ``cap`` the most recently used; one not held drops
        the least recently used capacity's P, L, X and W where ``kept`` are
        held."""
        if cap in self._recent:
            self._recent.remove(cap)
        elif len(self._recent) == self.kept:
            old = self._recent.pop(0)
            self.drop([f"{g}{old}" for g in "plxw"])
        self._recent.append(cap)

    @property
    def capacities(self) -> List[int]:
        """The edge capacities whose graphs this object holds."""
        return sorted(self._recent)


class LoopGraphOwner:
    """A system's side of its loop graphs: it holds one ``FusedLoop`` (with
    its ``FusedCorrect`` and ``FusedGlobalBA``) and hands it to its loop
    closer. ``CubemapSLAM``
    is one; so is ``chip_smoke.py``'s loop-closing system."""

    _fused_loop: Optional[FusedLoop] = None

    @property
    def fused_loop(self) -> Optional[FusedLoop]:
        """The ``FusedLoop``, if one was made."""
        return self._fused_loop

    def fused_loop_for(self, k) -> Optional[FusedLoop]:
        """The ``FusedLoop`` for the ``LoopKernels`` ``k`` on a CUDA device
        (``own_fused_loop``); None elsewhere, where loop closing runs
        eagerly."""
        if k.cam.device.type != "cuda":
            return None
        return self.own_fused_loop(k)

    def own_fused_loop(self, k) -> FusedLoop:
        """The ``FusedLoop`` (with its ``FusedCorrect`` and
        ``FusedGlobalBA``), made on ``k`` on first use. One made on other
        ``LoopKernels`` of the same configuration serves (it runs on its
        own, which its graphs read); another configuration raises. On the
        CPU its parts run eagerly on its static buffers."""
        fl = self._fused_loop
        if fl is None:
            fl = self._fused_loop = FusedLoop(k)
        elif fl.k is not k and fl.k.cfg != k.cfg:
            raise RuntimeError("the system's FusedLoop was captured for a "
                               "loop closer of another configuration; drop "
                               "it (drop_loop_graphs) first")
        return fl

    def drop_loop_graphs(self) -> None:
        """Forget the ``FusedLoop``, its ``FusedCorrect`` and its
        ``FusedGlobalBA``; the next request makes new ones."""
        self._fused_loop = None
