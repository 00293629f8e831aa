"""Localization-mode frames and the LOST frame's front end as captured CUDA
graphs.

``FusedLocalization`` is the port's counterpart of the JAX package's jitted
programs of a localization-mode frame, which ``_track_frame_localization``
(``cubemapslam_tpu/runtime/system.py:620-707``) drives: the front end
(``frontend``, ``system.py:248-256``, and the extractor's ``run_impl``,
``features/extractor.py:769``), ``track_motion_fused``
(``runtime/kernels.py:297``) at 15 px and, when widened, at 30 px, the
reference-keyframe fallback (``track_reference_kf`` and ``optimize_pose``,
``system.py:653-660``) and ``track_local_fused`` (``:323``).
``CubemapSLAM.track_fisheye`` runs a frame through it on the card
(``CubemapSLAM._localization_frame``), as graphs in a pool of their own,
each captured on first use and replayed on every later call:

* graph L1: the front end (``CapturedFrame.front_end``: kernel W, then
  ``extract`` with kernel D's two launches and the describe kernel), then
  ``TrackingKernels.localization_motion`` at 15 px (the re-anchoring, the
  prediction, the projection search and the pose-only LM) and its packed
  [matches, inliers, pose];
* host read 1, of that packed vector;
* graph L2, below ``MIN_MATCHES`` matches: ``localization_motion`` at
  30 px on L1's keypoints, and host read 2;
* graph LR, below ``MIN_MATCHES`` matches still and out of mbVO:
  ``TrackingKernels.localization_reference`` (the reference-keyframe match
  and a pose solve from L1's last pose) and its packed [matches, inliers,
  pose], and host read 3;
* the branches on the host, as ``_track_frame_localization`` takes them:
  the mbVO / VO branches end the frame without graph L3;
* graph L3, when the frame tracks against the map:
  ``TrackingKernels.localization_local`` (TrackLocalMap, the arena's
  visible/found counters updated in place, then the velocity and the pose
  relative to the new reference keyframe) on the stage tuple in L1's
  outputs, into which L2's or LR's stage tuple was copied first,
  then the last host read, of its packed [n_final, pkf_max, pkf_votes,
  pose];
* graph X, a LOST frame's front end alone (in SLAM and in localization
  mode), before ``CubemapSLAM._relocalize``.

Static inputs: the fisheye frame and the mask (``load_front_end``), then
``CubemapSLAM._localization_inputs``: the last frame's associations,
outliers, keypoint levels and angles, its pose relative to its keyframe,
that keyframe's slot, the velocity and whether there is one (0-d, in place
of the host's ``None`` branch); before graph LR or L3 the reference
keyframe's slot (a fill), and before L3 the covisibility view (only when
it is not the tensor, at the same version, copied last). The eager path
calls the same ``localization_motion``, ``localization_reference`` and
``localization_local`` on the same inputs, so eager = graph.

Outputs. The next replay of a graph writes over its outputs, so the host
takes clones of what outlives the frame: the keypoints of graphs L1 and X
once a frame (the last frame keeps them; ``_relocalize`` hands them to
``FusedReloc``, which copies them into its own buffers), and the stage
tuple, velocity and relative pose a frame keeps (``keep``). The graphs read
the arena and update its counters in place, and read the system's buffers:
each is checked by ``data_ptr`` before a frame, and a moved one raises;
``CubemapSLAM.drop_graphs`` (``reset``, ``serialize.load_map``) forgets
this object. Pool: the five graphs share one; a graph captured later may
put its outputs where an earlier one keeps its temporaries, and each output
is used before a graph captured earlier replays (X's and L3's at once, L2's
and LR's before L3, L1's within its frame, where X does not run), so they
replay in any order. The capture machinery, the launch counts added back
on each replay and the lack of any fallback are ``CapturedFrame``'s
(``runtime/fused_step.py``); on the CPU each part runs eagerly on the
same static buffers.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.runtime.fused_step import N_KP, CapturedFrame
from cubemapslam_tpu_torch.spans import span

# the static inputs of localization_motion after the keypoints, in
# CubemapSLAM._localization_inputs' order
MOTION_INPUTS = ("last_assoc", "last_outlier", "last_level", "last_angle",
                 "rel_R", "rel_t", "last_ref", "vel_R", "vel_t", "has_vel")
# where the stage tuple (assoc, n, R, t, outlier, n_inl) that graph L3
# reads (assoc, outlier, R, t) lies in graph L1's outputs
L3_STAGE = (N_KP, N_KP + 4, N_KP + 2, N_KP + 3)


class FusedLocalization(CapturedFrame):
    """Static buffers, graphs L1, L2, LR, L3 and X and their pool for one
    ``CubemapSLAM``'s localization-mode and LOST frames: ``start(system,
    fisheye, mask)`` then ``motion(system, radius)``,
    ``reference(system)`` and ``local(system, assoc, outlier, R, t)``;
    ``front_end_frame(system, fisheye, mask)``."""

    label = "fused localization"
    owner = "loc"

    def __init__(self, system):
        super().__init__(system.device)

    def _motion_inputs(self) -> List[torch.Tensor]:
        return [self.inputs[name] for name in MOTION_INPUTS]

    def _kp(self, name: str) -> Keypoints:
        return Keypoints(*self.outputs[name][:N_KP])

    def _part_l1(self, system) -> List[torch.Tensor]:
        """The front end, then the 15 px motion search, flat: the
        keypoints' fields, the stage tuple, R_last, t_last, packed."""
        kp = self.front_end(system)
        st, R_last, t_last, packed = system.kernels.localization_motion(
            system.arena, kp, *self._motion_inputs(), radius=15.0)
        return [*kp, *st, R_last, t_last, packed]

    def _part_l2(self, system) -> List[torch.Tensor]:
        st, R_last, t_last, packed = system.kernels.localization_motion(
            system.arena, self._kp("l1"), *self._motion_inputs(),
            radius=30.0)
        return [*st, R_last, t_last, packed]

    def _part_lr(self, system) -> List[torch.Tensor]:
        l1 = self.outputs["l1"]
        return system.kernels.localization_reference(
            system.arena, self._kp("l1"), self.inputs["ref_kf"], l1[N_KP + 6],
            l1[N_KP + 7])

    def _part_l3(self, system) -> List[torch.Tensor]:
        l1 = self.outputs["l1"]
        return list(system.kernels.localization_local(
            system.arena, self._kp("l1"), *(l1[i] for i in L3_STAGE),
            self.inputs["covis"], l1[N_KP + 6], l1[N_KP + 7],
            self.inputs["ref_kf"]))

    def _start(self, system, fisheye, mask) -> None:
        self.new_frame()
        self.check_tracker(system)
        self.load_front_end(system, fisheye, mask)

    def start(self, system, fisheye, mask) -> Keypoints:
        """A localization-mode frame's graph L1 on ``fisheye`` (what
        ``load_front_end`` takes) and the system's last frame and velocity;
        starts the frame's counts of captures and replays. Returns the
        keypoints, clones."""
        with span("host.inputs"):
            self._start(system, fisheye, mask)
            for name, x in zip(MOTION_INPUTS, system._localization_inputs()):
                self._copy(name, x)
        l1 = self.run("l1", lambda: self._part_l1(system))
        return Keypoints(*(x.clone() for x in l1[:N_KP]))

    def front_end_frame(self, system, fisheye, mask) -> Keypoints:
        """A LOST frame's graph X; starts the frame's counts. Returns the
        keypoints, clones."""
        with span("host.inputs"):
            self._start(system, fisheye, mask)
        x = self.run("x", lambda: list(self.front_end(system)))
        return Keypoints(*(t.clone() for t in x))

    def motion(self, system, radius: float):
        """``localization_motion``'s (stage tuple, R_last, t_last, packed)
        of the frame: graph L1's at 15 px, graph L2 at 30 px."""
        if radius == 15.0:
            out = self.outputs["l1"][N_KP:]
        elif radius == 30.0:
            out = self.run("l2", lambda: self._part_l2(system))
        else:
            raise ValueError(f"{self.label}: no graph searches at {radius} "
                             f"px")
        return tuple(out[:6]), out[6], out[7], out[8]

    def reference(self, system):
        """Graph LR: the reference-keyframe fallback against the system's
        reference keyframe from L1's (R_last, t_last). Returns
        ``localization_reference``'s (stage tuple, packed)."""
        with span("host.inputs"):
            self._fill("ref_kf", system.ref_kf, torch.int64)
        out = self.run("lr", lambda: self._part_lr(system))
        return tuple(out[:6]), out[6]

    def local(self, system, assoc, outlier, R, t) -> Tuple[torch.Tensor, ...]:
        """Graph L3 on the stage (assoc, outlier, R, t), copied into graph
        L1's outputs where it is another tensor, with L1's (R_last,
        t_last) and the system's reference keyframe. Returns
        ``localization_local``'s (assoc, outlier, R, t, packed, vel_R,
        vel_t, rel_R, rel_t)."""
        l1 = self.outputs["l1"]
        with span("host.inputs"):
            for i, src in zip(L3_STAGE, (assoc, outlier, R, t)):
                if l1[i] is not src:
                    l1[i].copy_(src)
            self._copy_if_new("covis", system.covis)
            self._fill("ref_kf", system.ref_kf, torch.int64)
        return tuple(self.run("l3", lambda: self._part_l3(system)))

    @staticmethod
    def keep(*x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Clones of graph outputs that outlive the frame."""
        return tuple(t.clone() for t in x)
