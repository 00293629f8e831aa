"""Relocalization's candidate program and widening pass as captured CUDA
graphs.

``FusedReloc`` is the port's counterpart of the JAX package's two jitted
relocalization programs, ``TrackingKernels.reloc_candidates_fused`` and
``reloc_widen_fused`` (``cubemapslam_tpu/runtime/kernels.py:499-539``,
called from ``runtime/system.py:777-813``). ``CubemapSLAM._relocalize``
runs them through it on the card, as two graphs in a pool of their own,
captured on first use and replayed on every later call:

* graph R, one candidate: ``TrackingKernels.reloc_candidate`` (the
  reference-keyframe match, bearing-EPnP RANSAC with its six eigen-solves
  on the ``sym_eig`` kernel and its LU solves on cuSOLVER / cuBLAS, then
  the pose-only LM kernel), captured on the first ok candidate and
  replayed for every later ok candidate, on this and later frames;
* graph W, the widening pass of a candidate
  (``TrackingKernels.reloc_widen_fused``: local landmarks, the projection
  search, the pose-only LM), replayed for each candidate tried in score
  order.

The host loops over the candidates as the eager path does: a candidate
that is not ok gets its row eagerly, and the host reads the candidates
once, the scores once and each widened candidate's count and pose once.

Static inputs. The frame's keypoints (on the card, a clone of the outputs
of ``FusedLocalization``'s graph X for a LOST frame or of its graph L1 for
an mbVO frame, ``runtime/fused_localization.py``: new tensors every frame)
are copied into buffers that do not move once a frame; before each replay
of graph R the candidate's slot is written by a fill and its RANSAC draws
are copied in, and before each replay of graph W the candidate's
associations, outliers and pose, and the covisibility view (only when it is
not the tensor, at the same version, that was copied last:
``refresh_graph_cache`` replaces it). The draws come from
``CubemapSLAM.generator`` outside the graph, one (n_iters, N) draw an ok
candidate in candidate order, as the eager path draws them, so the
generator advances as it does eagerly and the graph gives the eager bits; a
generator on the host gives the card its draws through the upload, as
eagerly.

The graphs read the arena (not written by either) and the system's
buffers: each is checked by ``data_ptr`` before a call, and a moved one
raises; ``CubemapSLAM.drop_graphs`` (``reset``, ``serialize.load_map``)
forgets this object. Pool: both graphs' outputs stay allocated between
calls and are cloned after each replay; their temporaries are dead between
replays, which run on one stream, so the two share the pool in any order.
The capture machinery, the launch counts added back on each replay and the
lack of any fallback are ``CapturedFrame``'s (``runtime/fused_step.py``);
on the CPU each part runs eagerly on the same static buffers.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.runtime.fused_step import CapturedFrame


class FusedReloc(CapturedFrame):
    """Static buffers, graphs R and W and their pool for one
    ``CubemapSLAM``'s relocalization: ``candidates(system, kp, cand_idx,
    cand_ok)`` and ``widen(system, assoc, outlier, R, t)``."""

    label = "fused reloc"
    owner = "reloc"

    def __init__(self, system):
        super().__init__(system.device)

    def _kp(self) -> Keypoints:
        return Keypoints(*(self.inputs[f"kp.{f}"] for f in Keypoints._fields))

    def _part_r(self, system) -> List[torch.Tensor]:
        s = self.inputs
        return list(system.kernels.reloc_candidate(
            system.arena, self._kp(), s["slot"], s["scores"]))

    def _part_w(self, system) -> List[torch.Tensor]:
        s = self.inputs
        return list(system.kernels.reloc_widen_fused(
            system.arena, self._kp(), s["w.assoc"], s["w.outlier"], s["w.R"],
            s["w.t"], covis=s["covis"]))

    def candidates(self, system, kp: Keypoints, cand_idx: Sequence[int],
                   cand_ok: Sequence[bool]):
        """``TrackingKernels.reloc_candidates_fused`` of the frame ``kp``
        with graph R for each ok candidate; starts the frame's counts of
        captures and replays (``new_frame``), which ``widen`` adds to.
        Returns the stacked (assoc, R, t, outlier, score), clones, on the
        device."""
        self.new_frame()
        self.check_tracker(system)
        for f, x in zip(Keypoints._fields, kp):
            self._copy(f"kp.{f}", x)
        k = system.kernels
        outs = []
        for c, ok_c in zip(cand_idx, cand_ok):
            if not ok_c:
                outs.append(k.reloc_skipped(kp))
                continue
            self._copy("scores", k.reloc_scores(system.generator, kp))
            self._fill("slot", int(c), torch.int64)
            out = self.run("r", lambda: self._part_r(system))
            outs.append([x.clone() for x in out])
        return tuple(torch.stack(x) for x in zip(*outs))

    def widen(self, system, assoc, outlier, R, t):
        """Graph W: ``TrackingKernels.reloc_widen_fused`` of the frame last
        given to ``candidates`` from one candidate's (assoc, outlier, R, t),
        with the system's covisibility view. Returns (assoc, R, t, outlier,
        n_inliers), clones, on the device."""
        self.check_tracker(system)
        self._copy("w.assoc", assoc)
        self._copy("w.outlier", outlier)
        self._copy("w.R", R)
        self._copy("w.t", t)
        self._copy_if_new("covis", system.covis)
        return tuple(x.clone()
                     for x in self.run("w", lambda: self._part_w(system)))
