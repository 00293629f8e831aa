"""The keyframe frame's mapping and the deferred-BA frame as captured CUDA
graphs.

``FusedMapping`` is the port's counterpart of the JAX package's jitted
mapping programs: ``TrackingKernels.insert_keyframe``
(``cubemapslam_tpu/runtime/kernels.py:546``), ``MappingKernels.mapping_step``
(``cubemapslam_tpu/runtime/mapping.py:478``) and ``MappingKernels.ba_step``
(``mapping.py:618``). ``CubemapSLAM`` runs them through it on a graph frame
(one whose tracking replayed ``FusedStep``'s graphs), as two graphs in a
pool of their own, captured on first use and replayed on every later such
frame:

* graph K, the keyframe half of ``CubemapSLAM._create_keyframe``:
  ``insert_keyframe``, the keyframe's BoW row, then
  ``mapping_step(run_ba=False, run_cull=True)`` (the ``_local_mapping`` of
  ``runtime/system.py``); its output is the mapping step's diagnostics;
* graph BA, ``ba_step`` around the pending keyframe (the deferred local BA,
  on the frame after a keyframe that inserts none, or on a keyframe frame
  that supersedes a pending BA for the second time); it has no output.

Static inputs. Before a replay the frame's keypoints, associations,
outliers and pose (``FusedStep``'s clones, new tensors every frame) are
copied into buffers that do not move, and the slots, the keyframe counter,
the frame id and the timestamp are written by fills: the mapping kernels
take them as 0-d device tensors, so no value is baked into a graph and no
input makes the host wait.

What stays eager, because it reads the host or reassigns state: the
retraining of a bootstrap vocabulary (which replaces the vocabulary and
the BoW table: that keyframe frame runs its mapping eagerly and drops this
object), loop closing (``LoopCloser.process``, which writes the arena in
place, between graph K and the next frame), and ``refresh_graph_cache``
(whose new tensors ``FusedStep`` then copies). Every tensor the graphs read
that the system owns (the arena's tables, the system's buffers, the BoW
table and the vocabulary's tensors) is checked by ``data_ptr`` before each
call, and a moved one raises; ``CubemapSLAM.drop_graphs`` (``seed``,
``reset``, ``serialize.load_map``) forgets this object.

Pool. Graph K's one output stays allocated and graph BA has none, so
neither writes over what the other keeps; their temporaries are dead
between replays, which run on one stream, so the two may share a pool
whatever the order of their frames. The diagnostics are cloned after each
replay of graph K. The capture machinery, the launch counts added back on
each replay and the lack of any fallback are ``CapturedFrame``'s
(``runtime/fused_step.py``); on the CPU each part runs eagerly on the same
static buffers.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.runtime.fused_step import CapturedFrame


class FusedMapping(CapturedFrame):
    """Static buffers, graphs K and BA and their pool for one
    ``CubemapSLAM``'s keyframe and deferred-BA frames:
    ``keyframe(system, ...)`` and ``deferred_ba(system, slot)``."""

    label = "fused mapping"
    owner = "map"

    def __init__(self, system):
        super().__init__(system.device)

    def check_system(self, system) -> None:
        """``check`` on the arena's tables, the system's buffers, the BoW
        table and the vocabulary's tensors."""
        named: List[Tuple[str, torch.Tensor]] = [
            (f"arena.{k}", getattr(system.arena, k))
            for k in system.arena._fields]
        named += list(system.named_buffers())
        named.append(("bow_table", system.bow_table))
        v = system.vocab
        named += [(f"vocab.centers.{i}", c) for i, c in enumerate(v.centers)]
        named += [(f"vocab.bits.{i}", b) for i, b in enumerate(v.bits)]
        named.append(("vocab.idf", v.idf))
        self.check(named)

    def _part_k(self, system) -> List[torch.Tensor]:
        s = self.inputs
        kp = Keypoints(*(s[f"kp.{f}"] for f in Keypoints._fields))
        system.kernels.insert_keyframe(
            system.arena, s["slot"], kp, s["assoc"], s["outlier"], s["R"],
            s["t"], s["frame_id"], s["timestamp"])
        system._update_bow(s["slot"], kp)
        return [system._mapping_step(s["slot"], s["n_kf"], s["frame_id"])]

    def _part_ba(self, system) -> List[torch.Tensor]:
        system.mapping.ba_step(system.arena, self.inputs["ba_slot"],
                               max_cams=system.ba_cams)
        return []

    def keyframe(self, system, slot: int, kp: Keypoints, assoc, outlier, R,
                 t, frame_id: int, timestamp: float) -> torch.Tensor:
        """Graph K: insert the frame into ``slot``, write its BoW row and run
        the mapping step, with ``system.n_kf`` (already counting this
        keyframe) as the keyframe counter. Returns the mapping step's
        diagnostics (12,), a clone, on the device."""
        self.new_frame()
        self.check_system(system)
        for f, x in zip(Keypoints._fields, kp):
            self._copy(f"kp.{f}", x)
        self._copy("assoc", assoc)
        self._copy("outlier", outlier)
        self._copy("R", R)
        self._copy("t", t)
        self._fill("slot", slot, torch.int64)
        self._fill("n_kf", system.n_kf, torch.int64)
        self._fill("frame_id", frame_id, torch.int64)
        self._fill("timestamp", timestamp, torch.float32)
        return self.run("k", lambda: self._part_k(system))[0].clone()

    def deferred_ba(self, system, slot: int) -> None:
        """Graph BA: ``ba_step`` around keyframe ``slot``."""
        self.new_frame()
        self.check_system(system)
        self._fill("ba_slot", slot, torch.int64)
        self.run("ba", lambda: self._part_ba(system))
