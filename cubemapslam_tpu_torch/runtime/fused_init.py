"""Initialization's attempt as captured CUDA graphs.

``FusedInit`` is the port's counterpart of the JAX package's two jitted
initialization programs, ``TrackingKernels.match_for_initialization`` and
``two_view_init`` (``cubemapslam_tpu/runtime/kernels.py:47-75``), which
``_try_initialize`` (``cubemapslam_tpu/runtime/system.py:387-410``) drives,
and of the front end before them. ``CubemapSLAM.track_fisheye`` runs a
pre-initialization frame through it on the card
(``CubemapSLAM._init_frame``), as graphs in a pool of their own, each
captured on first use and replayed on every later call:

* graph I0, a frame without a reference: the front end (kernel W, then the
  6000-feature ``extractor_init`` with kernel D's two launches and the
  describe kernel) and ``TrackingKernels.init_count``;
* graph I1, a frame with a reference: the same front end, then
  ``TrackingKernels.init_match`` against the reference keypoints, which
  also writes the matched window centres into the static ``prev_rays`` in
  place, as the JAX package's ``new_prev`` is kept even by an attempt that
  fails later;
* host read 1, of the counts [valid keypoints (, matches)]: the host drops
  the reference or takes the frame as the new one, as the eager path does;
* the RANSAC's (n_iters, N) uniform scores, drawn from
  ``CubemapSLAM.generator`` outside the graphs, as the eager path draws
  them, and copied into a static buffer;
* graph I2: ``TrackingKernels.init_two_view`` on I1's outputs (the 8-point
  RANSAC with its eigen-solves on the ``sym_eig`` kernel, the
  decomposition, ``reconstruct_e``'s one triangulation launch) and its
  packed [success, n_good, (p3d, good) a match];
* host read 2, of that vector. A successful attempt then builds the map
  eagerly (``_create_initial_map``): it runs once a run, where a capture
  would cost more than it saves.

Static inputs: the fisheye frame and the mask (``load_front_end``), the
reference keypoints and ``prev_rays`` (copied only when the system's are
not the tensors, at the same version, copied last; ``prev_rays`` stays the
static buffer between attempts) and the scores. The eager path calls the
same ``init_count``, ``init_match`` and ``init_two_view`` on the same
inputs and draws the same scores, so eager = graph.

Outputs. The next replay of a graph writes over its outputs, so the host
clones the keypoints once a frame (a frame that becomes the reference
keeps them). The other outputs are read or used within their frame. The
graphs read no arena, only the system's buffers (the warp map, the FOV
mask, the extractors' operators), which are checked by ``data_ptr`` before
a frame, and a moved one raises. So ``CubemapSLAM.reset`` keeps this
object, as the JAX package's compiled programs outlive a reset, and the
next attempts replay; ``CubemapSLAM.drop_graphs`` (``serialize.load_map``)
forgets it. Pool: the three graphs share one; a graph captured later may
put its outputs where an earlier one keeps its temporaries, and every
output is used before another graph replays (I2's within its frame, I1's
by I2), so they replay in any order. The capture machinery, the launch
counts added back on each replay and the lack of any fallback are
``CapturedFrame``'s (``runtime/fused_step.py``); on the CPU, or made with
``graphs=False``, each part runs eagerly on the same static buffers.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.runtime.fused_step import N_KP, CapturedFrame
from cubemapslam_tpu_torch.runtime.kernels import InitMatch
from cubemapslam_tpu_torch.solvers.essential import TwoViewResult

N_RES = len(TwoViewResult._fields)


class FusedInit(CapturedFrame):
    """Static buffers, graphs I0, I1 and I2 and their pool for one
    ``CubemapSLAM``'s initialization: ``start(system, fisheye, mask,
    with_ref)``, then ``counts`` (graph I0's) or ``match`` (graph I1's
    ``InitMatch``), then ``two_view(system, scores)``."""

    label = "fused init"
    owner = "init"

    def __init__(self, system, graphs: bool = True):
        super().__init__(system.device, graphs)
        self.counts = None
        self.match = None

    def _ref(self) -> Keypoints:
        return Keypoints(*(self.inputs[f"ref.{f}"]
                           for f in Keypoints._fields))

    def _front(self, system) -> Keypoints:
        """Kernel W on the static fisheye buffer, then the init extractor
        with the static mask."""
        s = self.inputs
        return system.extractor_init(system.warp(s["fisheye"]), s["mask"])

    def _part_i0(self, system) -> List[torch.Tensor]:
        kp = self._front(system)
        return [*kp, system.kernels.init_count(kp)]

    def _part_i1(self, system) -> List[torch.Tensor]:
        kp = self._front(system)
        prev = self.inputs["prev_rays"]
        m = system.kernels.init_match(self._ref(), kp, prev)
        prev.copy_(m.prev_rays)
        return [*kp, m.idx, m.ok, m.counts]

    def _part_i2(self, system) -> List[torch.Tensor]:
        i1 = self.outputs["i1"]
        res, E, packed = system.kernels.init_two_view(
            self._ref(), Keypoints(*i1[:N_KP]), i1[N_KP], i1[N_KP + 1],
            self.inputs["scores"])
        return [*res, E, packed]

    def start(self, system, fisheye, mask, with_ref: bool) -> Keypoints:
        """A pre-initialization frame's graph I1 on ``fisheye`` (what
        ``load_front_end`` takes) against ``system.init_ref`` and
        ``system.init_prev_rays`` when ``with_ref``, else graph I0; starts
        the frame's counts of captures and replays. Sets ``counts`` (the
        (1,) or (2,) vector the host reads) and, with a reference,
        ``match``. Returns the keypoints, clones."""
        self.new_frame()
        self.check(list(system.named_buffers()))
        self.load_front_end(system, fisheye, mask)
        self.match = None
        if not with_ref:
            out = self.run("i0", lambda: self._part_i0(system))
            self.counts = out[N_KP]
        else:
            for f, x in zip(Keypoints._fields, system.init_ref.kp):
                self._copy_if_new(f"ref.{f}", x)
            if system.init_prev_rays is not self.inputs.get("prev_rays"):
                self._copy("prev_rays", system.init_prev_rays)
            out = self.run("i1", lambda: self._part_i1(system))
            self.counts = out[N_KP + 2]
            self.match = InitMatch(out[N_KP], out[N_KP + 1],
                                   self.inputs["prev_rays"], self.counts)
        return Keypoints(*(x.clone() for x in out[:N_KP]))

    def two_view(self, system, scores: torch.Tensor
                 ) -> Tuple[TwoViewResult, torch.Tensor, torch.Tensor]:
        """Graph I2 on the frame's graph I1 outputs and the RANSAC's
        ``scores``: ``TrackingKernels.init_two_view``'s (result, E21,
        packed)."""
        self._copy("scores", scores)
        out = self.run("i2", lambda: self._part_i2(system))
        return TwoViewResult(*out[:N_RES]), out[N_RES], out[N_RES + 1]
