"""The steady-state tracked frame against the map arena.

``MapTracker`` runs the port's counterpart of the fused steady-state frame
of the JAX package (``CubemapSLAM._build_fused_step`` and
``_track_fisheye_fused``, ``cubemapslam_tpu/runtime/system.py:278-332``):
warp -> extract -> ``TrackingKernels.track_frame_full`` -> one read of the
packed (23,) result, then the tracking half of ``_consume_track_outputs``
(``system.py:578-609``). It holds the arena, the cached covisibility and
observation-count views, the last frame and the motion model.

On a CUDA device, once seeded, ``track_fisheye`` runs the frame as the
JAX package dispatches its one jitted program: through ``FusedStep``
(``runtime/fused_step.py``), CUDA graphs each captured on the first frame
that runs it and replayed on every later one (A; W, Z and R for the
fallbacks; B, or S for a frame that does not track), with the same host
reads and the same bits as the eager frame. With ``stage_times`` set to a
dict the frame runs eagerly, as in the JAX package, and each stage
(``extract``, ``track``) is synchronised and its wall ms recorded there;
``track_cubemap`` and the CPU always run eagerly.

The keyframe decision, keyframe creation, deferred BA and the reset of a
small map are ``CubemapSLAM``'s (``runtime/system.py``), which builds on
this class; here a lost frame leaves the last tracked state as it was.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.runtime.frame_step import FrameFrontend
from cubemapslam_tpu_torch.runtime.fused_step import FusedStep
from cubemapslam_tpu_torch.runtime.kernels import FrameTrack, TrackingKernels
from cubemapslam_tpu_torch.spans import frame, host_read, span

PACKED_NAMES = ("matches", "inliers_mm", "inliers", "n_ref", "live_kf",
                "first_free", "track_ok", "new_ref", "local_frustum",
                "local_queried", "local_matched")
# a metrics row's ``kind``, set in the branch that decides it: an
# initialization attempt; a frame tracked against the map that inserts no
# keyframe and runs no deferred BA, one that inserts a keyframe, one that
# runs the deferred BA; a LOST frame's relocalization (or mbVO's, when it
# wins); a frame that lost tracking; a localization-mode frame tracked
# against the frozen map; one tracked as visual odometry (mbVO)
FRAME_KINDS = ("init", "tracked", "keyframe", "ba", "reloc", "lost",
               "localization", "vo")


class LastFrame(NamedTuple):
    """The last tracked frame (``FrameState``, ``system.py:44-63``): its
    pose is kept relative to keyframe ``ref_kf`` so that it follows the
    keyframe when mapping moves it."""

    kp: Keypoints
    assoc: torch.Tensor
    outlier: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    rel_R: torch.Tensor
    rel_t: torch.Tensor
    ref_kf: int
    frame_id: int
    timestamp: float


class MapTracker(FrameFrontend):
    """Tracks fisheye frames against a map arena, one ``track_fisheye`` call
    a frame. Seed it with ``seed`` (an arena and a last frame) first.

    ``metrics`` holds a row per tracked frame: its ``kind``
    (``FRAME_KINDS``: ``tracked`` or ``lost`` here), the packed counts
    (``PACKED_NAMES``), the branches taken, the host reads made and the
    CUDA graphs captured and replayed (``graph_captures``,
    ``graph_replays``; both 0 on an eager frame) with the names of those
    replayed (``graph_replayed``, e.g. ``("A", "W", "Z", "R", "B")``);
    while a profiler records, ``graph_stages`` (``spans.frame``).
    ``stage_times``, when a dict, keeps every frame eager and records each
    stage's synchronised wall ms."""

    def __init__(self, cfg: Optional[SlamConfig] = None, device=None):
        super().__init__(cfg, device)
        cfg = self.cfg
        self.kernels = TrackingKernels(cfg, self.cam)
        self.arena = SM.make_arena(cfg.max_keyframes, cfg.n_features,
                                   cfg.max_landmarks, self.device)
        self.covis: Optional[torch.Tensor] = None
        self.cnt: Optional[torch.Tensor] = None
        self.last: Optional[LastFrame] = None
        self.velocity = None          # (R, t) frame-to-frame motion
        self.ref_kf = 0
        self.frame_id = 0
        self.metrics = []
        self.stage_times: Optional[dict] = None
        self._stage_t0 = 0.0
        self._fused: Optional[FusedStep] = None

    # ------------------------------------------------------------------
    # Stage timing (system.py:162-186)
    # ------------------------------------------------------------------

    def _stage_start(self) -> None:
        if self.stage_times is not None:
            self._stage_t0 = time.perf_counter()

    def _stage(self, name: str) -> Optional[float]:
        """Synchronise and record the wall ms since the last stage under
        ``name``, when ``stage_times`` is set. Returns the ms, else None."""
        if self.stage_times is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        ms = (now - self._stage_t0) * 1e3
        self.stage_times.setdefault(name, []).append(ms)
        self._stage_t0 = now
        return ms

    # ------------------------------------------------------------------
    # The captured frame
    # ------------------------------------------------------------------

    def drop_graphs(self) -> None:
        """Forget the captured frame; the next graph frame captures anew.
        Whoever replaces the arena calls it."""
        self._fused = None

    @property
    def fused_step(self) -> Optional[FusedStep]:
        """The captured frame's ``FusedStep``, if one was made."""
        return self._fused

    def _graph_frame(self) -> bool:
        """Whether ``track_fisheye`` runs this frame through the graphs: on
        a CUDA device, once seeded, with ``stage_times`` unset."""
        return (self.device.type == "cuda" and self.last is not None
                and self.stage_times is None)

    def _graph_counts(self):
        """(graphs captured, graphs replayed, the names of those replayed)
        by the last fused frame."""
        fs = self._fused
        return fs.frame_captures, fs.frame_replays, tuple(fs.frame_replayed)

    def _fused_frame(self, fisheye_u8, mask):
        """Warp, extract and ``track_frame_full`` through ``FusedStep``.
        Returns (keypoints, ``FrameTrack``)."""
        if self.covis is None:
            self.refresh_graph_cache()
        if self._fused is None:
            self._fused = FusedStep(self)
        vel_R, vel_t, gain = self._velocity_args()
        return self._fused(self, fisheye_u8, mask, self.last, (vel_R, vel_t),
                           gain, self.ref_kf)

    def refresh_graph_cache(self) -> None:
        """Recompute the cached (covisibility, observation count) views
        (``system.py:933-937``); call it whenever the graph changes."""
        self.covis, self.cnt = self.kernels.graph_cache(self.arena)

    def seed(self, arena: SM.MapArena, kp: Keypoints, assoc, outlier, R, t,
             ref_kf: int, frame_id: int = 0, timestamp: float = 0.0
             ) -> None:
        """Start from ``arena`` (copied to this tracker's device if it lies
        elsewhere) with a last frame (keypoints, associations, outliers and
        world->camera pose) that refers to keyframe slot ``ref_kf``, and no
        motion model."""
        dev = self.device
        self.arena = arena if arena.device == dev else arena.to(dev)
        kp = Keypoints(*(x.to(dev) for x in kp))
        R, t = R.to(dev), t.to(dev)
        R_ri, t_ri = G.se3_inverse(self.arena.kf_R[ref_kf],
                                   self.arena.kf_t[ref_kf])
        rel_R, rel_t = G.se3_compose(R, t, R_ri, t_ri)
        self.last = LastFrame(kp, assoc.to(dev), outlier.to(dev), R, t,
                              rel_R, rel_t, int(ref_kf), frame_id,
                              timestamp)
        self.ref_kf = int(ref_kf)
        self.velocity = None
        self.frame_id = frame_id + 1
        self.refresh_graph_cache()
        self.drop_graphs()

    def _velocity_args(self):
        """(vel_R, vel_t, gain) of ``system.py:552-556``."""
        if self.velocity is not None:
            return (*self.velocity, float(self.cfg.motion_model_damping))
        return (torch.eye(3, device=self.device),
                torch.zeros(3, device=self.device), 0.0)

    @frame
    def track_fisheye(self, fisheye_u8, timestamp: float, mask=None
                      ) -> Optional[np.ndarray]:
        """Track one (H, W) uint8 fisheye frame (an array, or a tensor such
        as ``prefetch_image`` returns): the warp on the device, then
        ``track_cubemap`` with ``mask``; on the card, through the captured
        graphs (see the module docstring)."""
        if self._graph_frame():
            fid = self.frame_id
            self.frame_id += 1
            kp, out = self._fused_frame(fisheye_u8, mask)
            return self._consume(kp, out, fid, timestamp,
                                 self._graph_counts())[0]
        with span("warp"):
            img = torch.as_tensor(fisheye_u8, device=self.device)
            cube = self.warp(img)
        return self.track_cubemap(cube, timestamp, mask)

    @frame
    def track_cubemap(self, cube: torch.Tensor, timestamp: float, mask=None
                      ) -> Optional[np.ndarray]:
        """Track one cubemap cross. ``mask`` (3Hf, 3Wf), array or tensor,
        culls the keypoints on its zero pixels in place of the FOV mask;
        ``None`` keeps the FOV mask (``FrameFrontend.extract``). Returns the
        4x4 float64 world->camera pose, or ``None`` when the frame is lost
        (fewer than 15 matches or 10 inliers, or fewer than
        ``min_track_inliers`` after the local map)."""
        if self.last is None:
            raise RuntimeError("seed the tracker with a map first")
        fid = self.frame_id
        self.frame_id += 1
        self._stage_start()
        with span("extract"):
            kp = self.extract(cube, mask)
        self._stage("extract")
        T = self._track_steady(kp, fid, timestamp)[0]
        self._stage("track")
        return T

    def _track_steady(self, kp: Keypoints, fid: int, timestamp: float):
        """``track_frame_full`` on the eager path, then ``_consume``.
        Returns (pose or None, the ``FrameTrack``, the frame's metrics
        row)."""
        if self.covis is None:
            self.refresh_graph_cache()
        last = self.last
        out = self.kernels.track_frame_full(
            self.arena, kp, last.assoc, last.outlier, last.kp.level,
            last.kp.angle, last.rel_R, last.rel_t, last.ref_kf,
            *self._velocity_args(), self.ref_kf, self.covis, self.cnt)
        return self._consume(kp, out, fid, timestamp)

    def _consume(self, kp: Keypoints, out: FrameTrack, fid: int,
                 timestamp: float, graphs=(0, 0, ())):
        """The one read of the packed result and the tracking half of
        ``_consume_track_outputs``; ``graphs`` is ``_graph_counts()`` of
        the frame. Returns (pose or None, ``out``, the frame's metrics row)."""
        with span("epilogue"):
            pk = host_read(out.packed)
            counts = dict(zip(PACKED_NAMES, (int(x) for x in pk[:11])))
            row = dict(frame=fid, kind="tracked", **counts, path=out.path,
                       host_reads=out.host_reads + 1,
                       graph_captures=graphs[0], graph_replays=graphs[1],
                       graph_replayed=graphs[2])
            self.metrics.append(row)
            if (not counts["track_ok"]
                    or counts["inliers"] < self.cfg.min_track_inliers):
                row["kind"] = "lost"
                return None, out, row
            with span("host.keep"):
                self.ref_kf = counts["new_ref"]
                self.velocity = (out.vel_R, out.vel_t)
                self.last = LastFrame(kp, out.assoc, out.outlier, out.R,
                                      out.t, out.rel_R, out.rel_t,
                                      self.ref_kf, fid, timestamp)
                T = np.eye(4)
                T[:3, :3] = np.asarray(pk[11:20]).reshape(3, 3)
                T[:3, 3] = pk[20:23]
            return T, out, row
