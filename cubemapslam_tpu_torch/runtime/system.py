"""The SLAM system: initialization, tracking, keyframes, local mapping,
loop closing, relocalization and localization mode.

``CubemapSLAM`` is the port's counterpart of the JAX package's system object
(``cubemapslam_tpu/runtime/system.py:65-987``), built on ``MapTracker``'s
steady frame: a sequence goes in from its first frame, one
``track_fisheye`` or ``track_cubemap`` call a frame, and the system
initializes from two views, tracks, inserts keyframes on the cadence of
``_need_new_keyframe`` (each with its BoW row), runs the local-mapping step
and then loop closing (``LoopCloser.process``) on each, and the deferred
local BA on the next frame without an insertion.
A LOST frame relocalizes against the map: BoW candidates, the
reference-keyframe match, bearing-EPnP RANSAC and pose-only LM per
candidate, then the widening pass. With 5 or fewer live keyframes a lost
system resets and initializes again, as the JAX package does. In
localization mode (``activate_localization_mode``) the map is frozen and a
frame with little map support is tracked as visual odometry (mbVO) while
relocalization is tried on every frame. ``serialize.save_map`` /
``load_map`` store and restore the map; a loaded system starts LOST.

The vocabulary comes from ``cfg.vocab_path`` or is trained on the host from
the two initialization frames, and trained once more when
``vocab_retrain_keyframes`` keyframes are live.

Host reads. A tracked frame reads the card twice, as ``MapTracker``'s does
(the motion-match counts and the packed result; one more for each
fallback), whether it replays the captured graphs or runs eagerly; a
keyframe insertion, its BoW row, its mapping step and a deferred BA add
none, because the mapping kernels mask
where the JAX package branches on the device. Loop closing adds its own
(``runtime/loop_closing.py``): from the tenth keyframe on, the loop
detector reads its candidates once a keyframe; a consistent candidate adds
the reads of ComputeSim3 (2 on the card, where DetectLoop and ComputeSim3
replay ``FusedLoop``'s graphs, ``runtime/fused_loop.py``; up to 4 eagerly;
the Sim3 RANSAC's eigen-solves wait ``sim3.EIGH_WAITS`` = 0 times), and a
closure those of the correction and the global BA. A pre-initialization
frame reads its counts once (valid keypoints and, with a reference, the
matches) and an attempt reads its packed RANSAC verdict, with the
triangulated points, once more; the essential solver's eigen-solves (the
``sym_eig`` kernel) make no wait. On the card such a frame replays
``FusedInit``'s graphs I0, or I1 and I2 (``runtime/fused_init.py``),
unless ``init_graphs`` is False or ``stage_times`` is set. Building the
initial map reads the first pose once and, to train a vocabulary, the
descriptors once. A relocalization reads the
candidates once, their scores once and each widened candidate's count and
pose once; its PnP makes the card wait ``pnp.EIGH_WAITS`` = 0 times more
(the eigen-solves are the ``sym_eig`` kernel). On the card its candidates
and widening passes replay ``FusedReloc``'s graphs R and W
(``runtime/fused_reloc.py``), unless ``reloc_graphs`` is False or
``stage_times`` is set. A localization-mode frame reads each stage's counts
with its pose (2 reads on the steady path); on the card it replays
``FusedLocalization``'s graphs L1, L2, LR and L3
(``runtime/fused_localization.py``), unless ``localization_graphs`` is
False or ``stage_times`` is set, and a LOST frame's warp and extract replay
its graph X where ``_relocalize`` replays ``FusedReloc``'s. Each frame's
count is in ``metrics`` (``host_reads``; ``eigh_waits`` where PnP or
Sim3 RANSAC ran).
"""

from __future__ import annotations

import enum
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch import place as PL
from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.features.extractor import (Keypoints,
                                                       build_extractor)
from cubemapslam_tpu_torch.runtime.fused_init import FusedInit
from cubemapslam_tpu_torch.runtime.fused_localization import (
    FusedLocalization)
from cubemapslam_tpu_torch.runtime.fused_loop import LoopGraphOwner
from cubemapslam_tpu_torch.runtime.fused_mapping import FusedMapping
from cubemapslam_tpu_torch.runtime.fused_reloc import FusedReloc
from cubemapslam_tpu_torch.runtime.kernels import (MIN_MATCHES,
                                                   device_scalar, pack,
                                                   pack_two_view)
from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser
from cubemapslam_tpu_torch.runtime.mapping import MappingKernels, _index
from cubemapslam_tpu_torch.runtime.tracking import LastFrame, MapTracker
from cubemapslam_tpu_torch.solvers.essential import TwoViewResult
from cubemapslam_tpu_torch.solvers.pnp import EIGH_WAITS
from cubemapslam_tpu_torch.solvers.sampling import draw_scores
from cubemapslam_tpu_torch.spans import frame, host_read, span

RELOC_CANDIDATES = 5     # BoW candidates tried per relocalization
# keyframe slots per batch when all BoW rows are recomputed: a word_ids
# level of one slot is (2000, 10, 256) float32 at full width, 20 MB
BOW_CHUNK_SLOTS = 8


class TrackState(enum.Enum):
    """Tracking.h:87-93."""

    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class InitRef(NamedTuple):
    """The initialization reference frame (``FrameState`` of the JAX
    package, the fields initialization uses)."""

    kp: Keypoints
    frame_id: int
    timestamp: float


class CubemapSLAM(MapTracker, LoopGraphOwner):
    """Monocular cubemap SLAM from the first frame of a sequence
    (``system.py:65-160``), on ``device`` (the card by default; without one
    it raises; pass ``"cpu"`` for the plain versions). RANSAC draws from a
    ``torch.Generator`` on that device, seeded with ``seed``.

    ``track_fisheye(img_u8, t)`` / ``track_cubemap(cross, t)`` return the
    4x4 world->camera pose of a tracked frame, else ``None``. ``metrics``
    has a row per frame (its ``kind`` one of ``tracking.FRAME_KINDS``, set
    where the frame's branch is taken); ``trajectory`` holds (timestamp,
    R, t) of each tracked frame; ``keyframe_trajectory()`` the live
    keyframes in time order. A steady-state ``track_fisheye`` frame on
    the card (tracking, not in localization mode) replays ``MapTracker``'s
    captured graphs, and its keyframe insertion with the mapping step, or
    its deferred BA, replays ``FusedMapping``'s
    (``runtime/fused_mapping.py``; rows carry ``graph_mapping_captures``,
    ``graph_mapping_replays``).
    Loop closing on the card replays the graphs of the ``FusedLoop`` that
    the system owns and hands its loop closer (``LoopGraphOwner``,
    ``runtime/fused_loop.py``) for DetectLoop and ComputeSim3, and runs a
    closure's two solves' iterations through captured CUDA graphs
    (``LoopCloser``; rows carry ``graph_loop_captures``,
    ``graph_loop_replays`` and ``graph_loop_capture_waits``). A
    localization-mode frame and a LOST frame's front end on the card
    replay ``FusedLocalization``'s graphs (rows carry
    ``graph_localization_captures``, ``graph_localization_replays``), and a
    pre-initialization ``track_fisheye`` frame ``FusedInit``'s (rows carry
    ``graph_init_captures``, ``graph_init_replays``; ``init_graphs =
    False`` keeps it eager). ``init_trace`` holds the last attempt's stage
    outputs (keypoints, matches, window centres, E21 and the result) until
    the next frame.
    With ``stage_times`` set to a dict every frame, its loop closure
    included, runs eagerly, and each
    stage (``extract``, ``init``, ``track``, ``insert+mapping``,
    ``local_ba``, ``reloc``, ``localization``) synchronizes the card and
    records its wall ms there and in the frame's row."""

    def __init__(self, cfg: Optional[SlamConfig] = None, device=None,
                 seed: int = 0):
        super().__init__(cfg, device)
        cfg = self.cfg
        self.mapping = MappingKernels(cfg, self.cam)
        self.loop_closer = LoopCloser(cfg, self.cam)
        self.loop_closing_enabled = True
        self.n_loops_closed = 0
        self.ba_cams = min(48, cfg.max_keyframes)
        # the init-mode extractor: 3x the features (Tracking.cpp:96),
        # downselected to the arena's width after the bootstrap
        self.extractor_init, self.params_init = build_extractor(
            cfg, self.cam, cfg.n_features * cfg.init_features_factor,
            (cfg.cube_h, cfg.cube_w))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = TrackState.NO_IMAGES_YET
        # n_kf is the monotonic keyframe counter; arena slots are recycled
        self.n_kf = 0
        self.arena_full_refusals = 0
        self.init_ref: Optional[InitRef] = None
        self.init_prev_rays = None
        self.init_trace: Optional[dict] = None
        self.last_kf_frame_id = 0
        # deferred local BA: dispatched on the first frame after a keyframe
        # that inserts none, superseded by a newer keyframe (at most twice)
        self._ba_pending_slot: Optional[int] = None
        self._ba_superseded = 0
        self._last_mapping_info = None   # mapping_step diagnostics (device)
        self._kf_inlier_peak = 0
        # the vocabulary (the reference's VOC argument, or trained at the
        # initial map) and the (K, n_words) BoW rows of the keyframe slots
        self.vocab: Optional[PL.Vocabulary] = None
        self._vocab_is_bootstrap = False
        if cfg.vocab_path:
            self.vocab = PL.load_vocabulary(cfg.vocab_path, self.device)
        self.bow_table: Optional[torch.Tensor] = None
        self.localization_only = False
        # mbVO (Tracking.cpp:207-277): in localization mode, the last frame
        # tracked fewer than 10 map landmarks; the frame is tracked as
        # visual odometry and relocalization is tried on every frame
        self.mb_vo = False
        self._row: dict = {}
        self.ba_runs = 0
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.tracked_frames = 0
        self.total_frames = 0
        self._fused_mapping: Optional[FusedMapping] = None
        self.reloc_graphs = True
        self._fused_reloc: Optional[FusedReloc] = None
        self.localization_graphs = True
        self._fused_localization: Optional[FusedLocalization] = None
        self.init_graphs = True
        self._fused_init: Optional[FusedInit] = None

    def _stage(self, name: str) -> Optional[float]:
        """``MapTracker._stage``, with the ms also in the frame's row."""
        ms = super()._stage(name)
        if ms is not None:
            self._row.setdefault("stage_ms", {})[name] = ms
        return ms

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def drop_graphs(self, keep_init: bool = False) -> None:
        """Forget the captured tracked frame and the captured mapping,
        relocalization, localization and loop graphs, and the
        initialization's unless ``keep_init``; the next graph frame
        captures anew."""
        super().drop_graphs()
        self._fused_mapping = None
        self._fused_reloc = None
        self._fused_localization = None
        if not keep_init:
            self._fused_init = None
        self.drop_loop_graphs()

    @property
    def fused_mapping(self) -> Optional[FusedMapping]:
        """The captured keyframe and BA frames' ``FusedMapping``, if one
        was made."""
        return self._fused_mapping

    @property
    def fused_reloc(self) -> Optional[FusedReloc]:
        """The relocalization's ``FusedReloc``, if one was made."""
        return self._fused_reloc

    @property
    def fused_init(self) -> Optional[FusedInit]:
        """The pre-initialization frames' ``FusedInit``, if one was
        made."""
        return self._fused_init

    @property
    def fused_localization(self) -> Optional[FusedLocalization]:
        """The localization-mode and LOST frames' ``FusedLocalization``, if
        one was made."""
        return self._fused_localization

    def _reloc_graph(self) -> bool:
        """Whether ``_relocalize`` runs through ``FusedReloc``: on a CUDA
        device, with ``reloc_graphs`` on and ``stage_times`` unset."""
        return (self.device.type == "cuda" and self.reloc_graphs
                and self.stage_times is None)

    def _pre_init(self) -> bool:
        return self.state in (TrackState.NO_IMAGES_YET,
                              TrackState.NOT_INITIALIZED)

    def _init_graph(self) -> bool:
        """Whether ``track_fisheye`` runs a pre-initialization frame through
        ``FusedInit``'s graphs: with ``init_graphs`` on, on a CUDA device,
        with ``stage_times`` unset."""
        return (self._pre_init() and self.init_graphs
                and self.device.type == "cuda" and self.stage_times is None)

    def _localization_graph(self) -> bool:
        """Whether ``track_fisheye`` runs a frame through
        ``FusedLocalization``'s graphs: a localization-mode frame (state
        OK) with ``localization_graphs`` on, or a LOST frame's front end
        (graph X) with ``_reloc_graph``'s conditions; on a CUDA device,
        with ``stage_times`` unset."""
        if self.state == TrackState.LOST:
            return self._reloc_graph()
        return (self.localization_only and self.state == TrackState.OK
                and self.localization_graphs and self.device.type == "cuda"
                and self.stage_times is None)

    def shutdown(self) -> None:
        """System::Shutdown; nothing runs in the background to stop
        (``system.py:986-987``)."""

    def _graph_frame(self) -> bool:
        """The JAX package's condition for its one-program frame
        (``system.py:227-230``): tracking, not in localization mode, no
        stage timing; and, here, a CUDA device. (The JAX condition also
        asks for a mask; the port's ``None`` is the FOV mask.)"""
        return (self.state == TrackState.OK and not self.localization_only
                and super()._graph_frame())

    @frame
    def track_fisheye(self, fisheye_u8, timestamp: float, mask=None
                      ) -> Optional[np.ndarray]:
        """Track one (H, W) uint8 fisheye frame (an array, or a tensor such
        as ``prefetch_image`` returns). A steady-state frame on the card
        replays the captured graphs (``MapTracker``), a localization-mode
        or LOST frame those of ``FusedLocalization``
        (``_localization_frame``), a pre-initialization frame those of
        ``FusedInit`` (``_init_frame``); every other frame warps and goes
        through ``track_cubemap``."""
        if self._init_graph():
            return self._init_frame(fisheye_u8, timestamp, mask)
        if self._localization_graph():
            return self._localization_frame(fisheye_u8, timestamp, mask)
        if not self._graph_frame():
            return super().track_fisheye(fisheye_u8, timestamp, mask)
        self.total_frames += 1
        self._row = {}
        fid = self.frame_id
        self.frame_id += 1
        kp, out = self._fused_frame(fisheye_u8, mask)
        pose_np = self._keyframe_half(
            kp, fid, timestamp, *self._consume(kp, out, fid, timestamp,
                                               self._graph_counts()),
            fused=True)
        return self._finish_frame(timestamp, pose_np)

    def _init_frame(self, fisheye_u8, timestamp: float, mask):
        """A pre-initialization frame through ``FusedInit``: its front end,
        with the bootstrap match when there is a reference (graph I1), else
        alone (graph I0), then ``_try_initialize`` on its stages (graph
        I2)."""
        self.total_frames += 1
        self._row = {}
        fid = self.frame_id
        self.frame_id += 1
        if self._fused_init is None:
            self._fused_init = FusedInit(self)
        fi = self._fused_init
        kp = fi.start(self, fisheye_u8, mask, self._has_init_ref())
        with span("init"):
            pose_np = self._try_initialize(kp, fid, timestamp, fi)
        self._row.update(graph_init_captures=fi.frame_captures,
                         graph_init_replays=fi.frame_replays)
        return self._finish_frame(timestamp, pose_np)

    def _localization_frame(self, fisheye_u8, timestamp: float, mask):
        """A frame through ``FusedLocalization``: a LOST frame's front end
        as graph X, then ``_relocalize``; a localization-mode frame's front
        end and 15 px motion search as graph L1, then
        ``_track_frame_localization`` on its stages (graphs L2 and L3)."""
        self.total_frames += 1
        self._row = {}
        fid = self.frame_id
        self.frame_id += 1
        if self._fused_localization is None:
            self._fused_localization = FusedLocalization(self)
        fl = self._fused_localization
        if self.state == TrackState.LOST:
            pose_np = self._reloc_frame(fl.front_end_frame(self, fisheye_u8,
                                                           mask), fid,
                                        timestamp)
        else:
            kp = fl.start(self, fisheye_u8, mask)
            with span("localization"):
                pose_np = self._track_frame_localization(kp, fid, timestamp,
                                                         fl)
        self._row.update(graph_localization_captures=fl.frame_captures,
                         graph_localization_replays=fl.frame_replays,
                         graph_localization_replayed=tuple(fl.frame_replayed))
        return self._finish_frame(timestamp, pose_np)

    @frame
    def track_cubemap(self, cube: torch.Tensor, timestamp: float,
                      mask=None) -> Optional[np.ndarray]:
        """Track one cubemap-cross frame, dispatching to initialization,
        tracking or relocalization (``system.py:334-369``). ``mask``
        (3Hf, 3Wf), array or tensor, culls the keypoints on its zero pixels
        in place of the FOV mask; ``None`` keeps the FOV mask, where the JAX
        package's ``None`` means no mask."""
        self.total_frames += 1
        pre_init = self._pre_init()
        self._row = {}
        self._stage_start()
        with span("extract"):
            cube = torch.as_tensor(cube, device=self.device)
            extract = self.extractor_init if pre_init else self.extractor
            kp = extract(cube, self.as_mask(mask))
        self._stage("extract")
        fid = self.frame_id
        self.frame_id += 1
        pose_np = None
        if pre_init:
            with span("init"):
                pose_np = self._try_initialize(kp, fid, timestamp)
            self._stage("init")
        elif self.state == TrackState.LOST:
            pose_np = self._reloc_frame(kp, fid, timestamp)
        else:
            pose_np = self._track_frame(kp, fid, timestamp)
        return self._finish_frame(timestamp, pose_np)

    def _reloc_frame(self, kp: Keypoints, fid: int, ts: float):
        """A LOST frame: its row, then ``_relocalize``."""
        self._row.update(frame=fid, kind="reloc", stage="reloc",
                         host_reads=0)
        self.metrics.append(self._row)
        with span("reloc"):
            pose_np = self._relocalize(kp, fid, ts)
        self._stage("reloc")
        return pose_np

    def _finish_frame(self, timestamp: float, pose_np):
        """The frame's state in its row, and its pose (4x4, also appended to
        ``trajectory``) when tracking."""
        with span("host.keep"):
            self._row.update(state=self.state.name)
            if self.state != TrackState.OK:
                return None
            self.tracked_frames += 1
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = pose_np
            self.trajectory.append((timestamp, T[:3, :3].copy(),
                                    T[:3, 3].copy()))
            return T

    def activate_localization_mode(self) -> None:
        """Freeze the map and track against it
        (System::ActivateLocalizationMode, ``system.py:371-374``)."""
        self.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False
        self.mb_vo = False

    # ------------------------------------------------------------------
    # Initialization (Tracking.cpp:391-565)
    # ------------------------------------------------------------------

    def _has_init_ref(self) -> bool:
        return (self.state != TrackState.NO_IMAGES_YET
                and self.init_ref is not None)

    def _try_initialize(self, kp: Keypoints, fid: int, ts: float,
                        fi: Optional[FusedInit] = None):
        """``system.py:387-410``: the frame's counts (valid keypoints and,
        with a reference, the bootstrap matches) read once; a frame
        without a reference becomes it, a frame with too few keypoints or
        matches drops it; else the RANSAC scores drawn from ``generator``,
        the two-view stage and its packed verdict read once, and on success
        ``_create_initial_map``. ``fi`` is the frame's ``FusedInit``, whose
        graph I0 or I1 ran the first stage and whose graph I2 runs the
        second; without it both run eagerly (``TrackingKernels.init_count``
        / ``init_match``, ``init_two_view``). Returns the host pose (R, t)
        when the initial map was made, else None."""
        row, k, cfg = self._row, self.kernels, self.cfg
        row.update(frame=fid, kind="init", stage="init", host_reads=0)
        self.metrics.append(row)
        self.init_trace = None
        has_ref = self._has_init_ref()
        if fi is not None:
            counts, m = fi.counts, fi.match
        elif has_ref:
            m = k.init_match(self.init_ref.kp, kp, self.init_prev_rays)
            counts = m.counts
        else:
            counts = k.init_count(kp)
        counts = [int(x) for x in counts.tolist()]
        row["host_reads"] += 1
        enough = counts[0] > cfg.min_init_keypoints
        if not has_ref:
            if enough:
                self.init_ref = InitRef(kp, fid, ts)
                self.init_prev_rays = kp.rays
                self.state = TrackState.NOT_INITIALIZED
            return None
        if not enough:
            self.init_ref = None
            return None
        self.init_prev_rays = m.prev_rays
        row["init_matches"] = counts[1]
        self.init_trace = dict(kp=kp, idx=m.idx, ok=m.ok,
                               prev_rays=m.prev_rays)
        if row["init_matches"] < cfg.min_init_matches:
            self.init_ref = None          # retry with a new reference
            return None
        scores = draw_scores(self.generator, cfg.init_ransac_iters,
                             m.ok.shape[0], self.device)
        if fi is not None:
            res, E, packed = fi.two_view(self, scores)
        else:
            res, E, packed = k.init_two_view(self.init_ref.kp, kp, m.idx,
                                             m.ok, scores)
        self.init_trace.update(E=E, **res._asdict())
        host = packed.cpu()
        row["host_reads"] += 1
        if not host[0] > 0:
            return None
        return self._create_initial_map(kp, fid, ts, m.idx, res, host)

    def _create_initial_map(self, kp: Keypoints, fid: int, ts: float,
                            m_idx: torch.Tensor, res: TwoViewResult,
                            host: Optional[torch.Tensor] = None):
        """CreateInitialMapCubemap (``system.py:412-491``): two keyframes,
        landmarks from the triangulated inliers, the scale normalized to a
        median depth of 1, then a local BA around the second keyframe.
        ``host`` is ``pack_two_view(res)`` read to the host (read here when
        not given)."""
        row, dev = self._row, self.device
        if host is None:
            host = pack_two_view(res).cpu()
            row["host_reads"] += 1
        pg = host[2:].reshape(-1, 4).numpy()
        p3d, good = pg[:, :3], pg[:, 3] > 0
        if good.sum() < self.cfg.min_init_matches:
            return None
        # median-depth normalization (KeyFrame::ComputeSceneMedianDepth)
        med = float(np.median(np.linalg.norm(p3d[good], axis=1)))
        if med <= 0:
            return None
        inv = 1.0 / med
        R1, t1 = res.R21, res.t21 * inv
        Xw = res.p3d * inv

        ref, N = self.init_ref, self.cfg.n_features
        k = self.kernels
        # downselect the 3x init keypoint sets to the arena width, the
        # triangulated features first, then by response
        big = res.good.float() * 1e9
        ref_prio = big + ref.kp.response
        cur_prio = torch.zeros(kp.n, device=dev).scatter_reduce(
            0, m_idx, big, reduce="amax", include_self=True) + kp.response
        ref_red, sel_ref = k.downselect_keypoints(ref.kp, ref_prio, N)
        cur_red, sel_cur = k.downselect_keypoints(kp, cur_prio, N)
        inv_cur = torch.full((kp.n,), -1, dtype=torch.int64, device=dev)
        inv_cur[sel_cur] = torch.arange(N, device=dev)
        idx2_red = inv_cur[m_idx[sel_ref]]
        good_red = res.good[sel_ref] & (idx2_red >= 0)

        no_assoc = torch.full((N,), SM.NO_LM, dtype=torch.int64, device=dev)
        no_out = torch.zeros(N, dtype=torch.bool, device=dev)
        a = self.arena
        k.insert_keyframe(a, 0, ref_red, no_assoc, no_out,
                          torch.eye(3, device=dev),
                          torch.zeros(3, device=dev), ref.frame_id,
                          ref.timestamp)
        k.insert_keyframe(a, 1, cur_red, no_assoc, no_out, R1, t1, fid, ts)
        self.n_kf = 2
        self.mapping.commit_new_landmarks(a, 0, 1, Xw[sel_ref], good_red,
                                          idx2_red.clamp(min=0), 0,
                                          ref.frame_id)
        SM.update_landmark_stats_all(a, k.scale_factors)
        self.mapping.local_ba(a, 1, self.ba_cams)
        self.ref_kf = 1
        R, t = a.kf_R[1].clone(), a.kf_t[1].clone()
        rel_R, rel_t = G.se3_compose(R, t, *G.se3_inverse(R, t))
        self.last = LastFrame(cur_red, a.kf_obs_lm[1].clone(),
                              torch.zeros(N, dtype=torch.bool, device=dev),
                              R, t, rel_R, rel_t, 1, fid, ts)
        self.last_kf_frame_id = fid
        self.velocity = None
        self.state = TrackState.OK
        self.refresh_graph_cache()
        if self.vocab is None:
            # train on the two frames' valid descriptors (system.py:479-486)
            both = torch.cat([torch.cat([x.desc, x.valid[:, None].long()], 1)
                              for x in (ref_red, cur_red)]).cpu().numpy()
            row["host_reads"] += 1
            self.vocab = PL.train_vocabulary(
                both[both[:, 8] > 0, :8].astype(np.uint32),
                k=self.cfg.vocab_branching, depth=self.cfg.vocab_depth,
                device=dev)
            self._vocab_is_bootstrap = True
        self.bow_table = torch.zeros(self.cfg.max_keyframes,
                                     self.vocab.n_words, device=dev)
        self._update_bow(0, ref_red)
        self._update_bow(1, cur_red)
        self.init_ref = None
        row["keyframe"] = True
        row["host_reads"] += 1
        pose = torch.cat([R.reshape(-1), t]).tolist()
        return (np.asarray(pose[:9]).reshape(3, 3), np.asarray(pose[9:]))

    # ------------------------------------------------------------------
    # Per-frame tracking and its keyframe half (system.py:574-618)
    # ------------------------------------------------------------------

    def _track_frame(self, kp: Keypoints, fid: int, ts: float):
        if self.localization_only:
            with span("localization"):
                pose_np = self._track_frame_localization(kp, fid, ts)
            self._stage("localization")
            return pose_np
        return self._keyframe_half(kp, fid, ts,
                                   *self._track_steady(kp, fid, ts))

    def _keyframe_half(self, kp: Keypoints, fid: int, ts: float, T, out,
                       row, fused: bool = False):
        """After a tracked frame's read: lost, a new keyframe with its
        mapping, or the deferred BA (``system.py:578-618``); with ``fused``
        (a graph frame) the insertion, BoW row and mapping step and the BA
        replay ``FusedMapping``'s graphs. Returns the host pose (R, t), or
        None when lost."""
        row.update(self._row, keyframe=False, ba=False,
                   graph_mapping_captures=0, graph_mapping_replays=0)
        self._row = row
        self._stage("track")
        if T is None:
            self._set_lost(live_kf=row["live_kf"])
            return None
        n_final = row["inliers"]
        self._kf_inlier_peak = max(self._kf_inlier_peak, n_final)
        if self._need_new_keyframe(n_final, row["n_ref"], row["first_free"]):
            with span("insert+mapping"):
                self._create_keyframe(kp, out.assoc, out.outlier, out.R,
                                      out.t, fid, ts, slot=row["first_free"],
                                      live_kf=row["live_kf"] + 1,
                                      fused=fused)
            row.update(keyframe=True, kind="keyframe")
            self._stage("insert+mapping")
        elif self._ba_pending_slot is not None:
            # no keyframe this frame: run the deferred local BA
            with span("local_ba"):
                self._dispatch_deferred_ba(fused)
            row["kind"] = "ba"
            self._stage("local_ba")
        return T[:3, :3], T[:3, 3]

    def _set_lost(self, live_kf: Optional[int] = None) -> None:
        """``system.py:709-718``: reset when 5 or fewer keyframes are
        live."""
        self.state = TrackState.LOST
        self._row["kind"] = "lost"
        if live_kf is None:
            self._row["host_reads"] = self._row.get("host_reads", 0) + 1
            live_kf = int(host_read(self.arena.kf_valid.sum()))
        if live_kf <= 5:
            self.reset()

    def reset(self) -> None:
        """System reset (``system.py:720-738``). The graphs are dropped but
        ``FusedInit``'s, which read no arena, as the JAX package's compiled
        programs outlive a reset: the next attempts replay them."""
        cfg = self.cfg
        self.arena = SM.make_arena(cfg.max_keyframes, cfg.n_features,
                                   cfg.max_landmarks, self.device)
        self.n_kf = 0
        self.state = TrackState.NO_IMAGES_YET
        self.last = None
        self.init_ref = None
        self.velocity = None
        self.ref_kf = 0
        self._ba_pending_slot = None
        self._ba_superseded = 0
        self._kf_inlier_peak = 0
        self.covis = None
        self.cnt = None
        self.bow_table = None
        self.mb_vo = False
        self.loop_closer.reset()
        self.drop_graphs(keep_init=True)

    # ------------------------------------------------------------------
    # Localization mode (system.py:497-557, 620-707)
    # ------------------------------------------------------------------

    def _read(self, packed: torch.Tensor, k: int):
        """One read of a packed vector of ``k`` counts and a pose
        (``kernels.pack``): (the counts as ints, (R, t) as float64
        numpy)."""
        self._row["host_reads"] += 1
        h = host_read(packed)
        return ([int(x) for x in h[:k]],
                (np.asarray(h[k:k + 9]).reshape(3, 3), np.asarray(h[k + 9:])))

    def _record_frame(self, kp: Keypoints, assoc, outlier, R, t, fid: int,
                      ts: float) -> None:
        """The last frame, with its pose relative to ``ref_kf``."""
        R_ri, t_ri = G.se3_inverse(self.arena.kf_R[self.ref_kf],
                                   self.arena.kf_t[self.ref_kf])
        rel_R, rel_t = G.se3_compose(R, t, R_ri, t_ri)
        self.last = LastFrame(kp, assoc, outlier, R, t, rel_R, rel_t,
                              self.ref_kf, fid, ts)

    def _localization_inputs(self):
        """The inputs of ``TrackingKernels.localization_motion`` after the
        keypoints: the last frame's associations, outliers, keypoint levels
        and angles, its pose relative to its keyframe, that keyframe's slot
        (0-d), the velocity and whether there is one (0-d). The prediction
        (``system.py:528-550``) re-anchors the last pose on its keyframe
        and moves it by the velocity's twist scaled by
        ``motion_model_damping``.

        Both rotations are projected onto SO(3), where the JAX package
        keeps them as composed. With the map frozen no keyframe re-anchors
        the chain, and each frame's composition, with transposes taken as
        inverses, about triples the distance from SO(3) that pose-only LM
        then keeps (ROADMAP Queue 3, "Rotation drift")."""
        last, dev = self.last, self.device
        vel_R, vel_t, _ = self._velocity_args()
        return (last.assoc, last.outlier, last.kp.level, last.kp.angle,
                last.rel_R, last.rel_t,
                device_scalar(last.ref_kf, torch.int64, dev), vel_R, vel_t,
                device_scalar(self.velocity is not None, torch.bool, dev))

    def _vo_frame(self, kp, assoc, outlier, R, t, R_last, t_last, fid, ts,
                  n: int, n_inl: int) -> None:
        """Keep a frame tracked on frame-to-frame matches only (mbVO)."""
        self.velocity = G.se3_compose(R, t, *G.se3_inverse(R_last, t_last))
        self._record_frame(kp, assoc, outlier, R, t, fid, ts)
        self._row.update(inliers=n_inl, matches=n, vo=True, kind="vo")

    def _track_frame_localization(self, kp: Keypoints, fid: int, ts: float,
                                  fused: Optional[FusedLocalization] = None):
        """A frame against the frozen map (``system.py:620-707``): the
        motion-model match (widened below 20 matches), the mbVO dual
        hypothesis, the reference-keyframe fallback, then TrackLocalMap. No
        keyframe is inserted and no BA runs. The motion searches and
        TrackLocalMap run eagerly, or, with ``fused`` (the frame's
        ``FusedLocalization``, whose graph L1 made ``kp``), as its graphs,
        the reference-keyframe fallback as graph LR. Returns the host pose
        or None."""
        k, cfg = self.kernels, self.cfg
        row = self._row
        row.update(frame=fid, kind="localization", stage="localization",
                   host_reads=0, vo=False)
        self.metrics.append(row)
        if fused is None:
            args = self._localization_inputs()

            def motion(radius):
                return k.localization_motion(self.arena, kp, *args,
                                             radius=radius)

            def reference():
                out = k.localization_reference(self.arena, kp, self.ref_kf,
                                               R_last, t_last)
                return tuple(out[:6]), out[6]

            def local(*st):
                return k.localization_local(
                    self.arena, kp, *st, self.covis, R_last, t_last,
                    device_scalar(self.ref_kf, torch.int64, self.device))

            def keep(*x):
                return x
        else:
            def motion(radius):
                return fused.motion(self, radius)

            def reference():
                return fused.reference(self)

            def local(*st):
                return fused.local(self, *st)

            keep = fused.keep

        (assoc, _, R, t, outlier, _), R_last, t_last, packed = motion(15.0)
        (n, n_inl), pose = self._read(packed, 2)
        if n < MIN_MATCHES:
            (assoc, _, R, t, outlier, _), _, _, packed = motion(30.0)
            (n, n_inl), pose = self._read(packed, 2)
        if self.mb_vo:
            # the VO hypothesis is kept while relocalization is tried; the
            # relocalized pose wins when both succeed
            pose_r = self._relocalize(kp, fid, ts)
            if pose_r is not None:
                return pose_r
            if n < MIN_MATCHES:
                self._set_lost()
                return None
            with span("host.keep"):
                self._vo_frame(kp, *keep(assoc, outlier, R, t), R_last,
                               t_last, fid, ts, n, n_inl)
            self.mb_vo = n_inl < 10
            return pose
        if n < MIN_MATCHES:                # the reference keyframe
            (assoc, _, R, t, outlier, _), packed = reference()
            (n, n_inl), pose = self._read(packed, 2)
            if n < 15:
                self._set_lost()
                return None
        if n < 15 or n_inl < 10:
            if n >= MIN_MATCHES:
                # weak map support, live frame-to-frame tracking: VO mode
                self.mb_vo = True
                with span("host.keep"):
                    self._vo_frame(kp, *keep(assoc, outlier, R, t), R_last,
                                   t_last, fid, ts, n, n_inl)
                return pose
            self._set_lost()
            return None
        self.mb_vo = False
        if self.covis is None:
            self.refresh_graph_cache()
        assoc, outlier, R, t, packed, *kept = local(assoc, outlier, R, t)
        (n_final, pkf_max, pkf_votes), pose = self._read(packed, 3)
        row.update(inliers=n_final, matches=n)
        if n_final < cfg.min_track_inliers:
            self._set_lost()
            return None
        with span("host.keep"):
            if pkf_votes > 0:
                self.ref_kf = pkf_max
            assoc, outlier, R, t, vel_R, vel_t, rel_R, rel_t = keep(
                assoc, outlier, R, t, *kept)
            self.velocity = (vel_R, vel_t)
            self.last = LastFrame(kp, assoc, outlier, R, t, rel_R, rel_t,
                                  self.ref_kf, fid, ts)
        return pose

    # ------------------------------------------------------------------
    # Relocalization (Tracking::Relocalization, system.py:777-813)
    # ------------------------------------------------------------------

    def _relocalize(self, kp: Keypoints, fid: int, ts: float):
        """Relocalize the frame against the map: BoW candidates, then per
        candidate the match, PnP RANSAC and pose-only LM, then the widening
        pass for the candidates in score order until one keeps
        ``min_track_inliers_after_reloc`` inliers. Returns the host pose
        (R, t), or None when no candidate holds."""
        row = self._row
        row.update(reloc_candidates=0, relocalized=False)
        if self.vocab is None or self.bow_table is None:
            return None
        k, a = self.kernels, self.arena
        with span("reloc.detect"):
            qbow = PL.bow_vector(self.vocab, kp.desc, kp.valid)
            if self.covis is None:
                self.refresh_graph_cache()
            cand_idx, cand_ok = PL.detect_candidates(
                qbow, self.bow_table, a.kf_valid,
                torch.zeros_like(a.kf_valid), self.covis, 0.0)
            n_c = min(RELOC_CANDIDATES, cand_idx.shape[0])
            host = host_read(torch.cat([cand_idx[:n_c],
                                        cand_ok[:n_c].to(torch.int64)]))
        row["host_reads"] += 1
        idx, ok = host[:n_c], [bool(x) for x in host[n_c:]]
        row["reloc_candidates"] = sum(ok)
        if not any(ok):
            return None
        fr = None
        if self._reloc_graph():
            if self._fused_reloc is None:
                self._fused_reloc = FusedReloc(self)
            fr = self._fused_reloc
        with span("reloc.candidates"):
            if fr is None:
                assoc_c, R_c, t_c, out_c, score_c = k.reloc_candidates_fused(
                    a, kp, idx, ok, self.generator)
            else:
                assoc_c, R_c, t_c, out_c, score_c = fr.candidates(self, kp,
                                                                  idx, ok)
            scores = host_read(score_c)
        row["host_reads"] += 1
        row["eigh_waits"] = row.get("eigh_waits", 0) + EIGH_WAITS * sum(ok)
        row["reloc_scores"] = scores
        pose_out = None
        for i in sorted(range(n_c), key=lambda j: -scores[j]):   # stable
            if scores[i] < 0:
                break
            with span("reloc.widen"):
                args = (assoc_c[i], out_c[i], R_c[i], t_c[i])
                if fr is None:
                    assoc, R, t, outlier, n3 = k.reloc_widen_fused(
                        a, kp, *args, covis=self.covis)
                else:
                    assoc, R, t, outlier, n3 = fr.widen(self, *args)
                (n3,), pose = self._read(pack((n3,), R, t), 1)
            if n3 < self.cfg.min_track_inliers_after_reloc:
                continue
            self.ref_kf = idx[i]
            self._record_frame(kp, assoc, outlier, R, t, fid, ts)
            self.velocity = None
            self.state = TrackState.OK
            self.mb_vo = False
            self._kf_inlier_peak = 0
            row.update(relocalized=True, reloc_inliers=n3, kind="reloc")
            pose_out = pose
            break
        if fr is not None:
            row["graph_reloc_captures"] = fr.frame_captures
            row["graph_reloc_replays"] = fr.frame_replays
        return pose_out

    # ------------------------------------------------------------------
    # The bag of words (system.py:740-771)
    # ------------------------------------------------------------------

    def _update_bow(self, slot, kp: Keypoints) -> None:
        """The BoW row of keyframe ``slot`` (an int, or a 0-d tensor on the
        device), written through a 1-element index."""
        self.bow_table.index_copy_(0, _index(slot, self.device),
                                   PL.bow_vector(self.vocab, kp.desc,
                                                 kp.valid)[None])

    def _retrain_due(self, live_kf: int) -> bool:
        return (self._vocab_is_bootstrap
                and live_kf >= self.cfg.vocab_retrain_keyframes)

    def _maybe_retrain_vocab(self, live_kf: int) -> None:
        """Train a bootstrap vocabulary once more on the live keyframes'
        descriptors when ``vocab_retrain_keyframes`` are live, then
        recompute every BoW row. ``live_kf`` is the count after the
        insertion (the JAX package reads ``kf_valid`` for it). The new
        vocabulary and BoW table are new tensors, so the mapping and loop
        graphs, which read them, are dropped."""
        if not self._retrain_due(live_kf):
            return
        a = self.arena
        data = torch.cat([a.kf_desc, a.kf_kp_valid[..., None].long()],
                         -1)[a.kf_valid].reshape(-1, 9).cpu().numpy()
        self._row["host_reads"] += 2     # the mask's count, then the copy
        self.vocab = PL.train_vocabulary(
            data[data[:, 8] > 0, :8].astype(np.uint32),
            k=self.cfg.vocab_branching, depth=self.cfg.vocab_depth,
            device=self.device)
        self._vocab_is_bootstrap = False
        self.bow_table = self._recompute_bow_table()
        self._fused_mapping = None
        self.drop_loop_graphs()

    def _recompute_bow_table(self) -> torch.Tensor:
        """Every slot's BoW row, in batches of ``BOW_CHUNK_SLOTS`` slots;
        the rows of invalid slots are 0."""
        a, n = self.arena, BOW_CHUNK_SLOTS
        rows = torch.cat([PL.bow_vectors(self.vocab, a.kf_desc[s:s + n],
                                         a.kf_kp_valid[s:s + n])
                          for s in range(0, a.n_kf_cap, n)])
        return torch.where(a.kf_valid[:, None], rows, torch.zeros_like(rows))

    # ------------------------------------------------------------------
    # Keyframe decision and creation (Tracking.cpp:721-792)
    # ------------------------------------------------------------------

    def _free_kf_slot(self) -> int:
        """First free arena slot, or -1 when the arena is full (one read)."""
        free = np.nonzero(~self.arena.kf_valid.cpu().numpy())[0]
        return int(free[0]) if len(free) else -1

    def _need_new_keyframe(self, n_inliers: int, n_ref: int,
                           first_free: int) -> bool:
        """NeedNewKeyFrame (``system.py:827-864``), on the counts of the
        packed result: no read."""
        cfg = self.cfg
        frames_since = self.frame_id - self.last_kf_frame_id
        if frames_since < 2 + cfg.min_keyframe_gap:
            return False
        c1a = frames_since >= cfg.fps
        c2_decay = n_inliers < cfg.keyframe_inlier_decay * self._kf_inlier_peak
        c2_weak = n_inliers < max(
            2 * cfg.min_track_inliers,
            int(cfg.keyframe_health_floor_frac * cfg.n_features))
        c2_young = n_ref < cfg.keyframe_mature_floor
        want = bool((c1a or c2_decay or c2_weak or c2_young)
                    and n_inliers > 15)
        if want and first_free < 0:
            # the arena is truly full (culling freed nothing): refuse loudly
            self.arena_full_refusals += 1
            if self.arena_full_refusals == 1:
                warnings.warn(
                    f"keyframe arena full ({cfg.max_keyframes} slots, none "
                    f"culled) — refusing new keyframes; raise max_keyframes",
                    RuntimeWarning)
            return False
        return want

    def _create_keyframe(self, kp: Keypoints, assoc, outlier, R, t,
                         fid: int, ts: float, slot: int, live_kf: int,
                         fused: bool = False):
        """``system.py:866-898``: insert into the free ``slot``, write the
        BoW row, re-anchor the live frame on the new keyframe, retrain a
        bootstrap vocabulary when due (``live_kf``: the live keyframes after
        the insertion), run local mapping and loop closing, then take the
        frame's associations from the keyframe's row. With ``fused`` the
        insertion, BoW row and mapping step replay graph K, unless a
        retraining falls between them: that frame runs them eagerly."""
        assert slot >= 0
        self.n_kf += 1
        self.ref_kf = slot
        self.last_kf_frame_id = fid
        self._kf_inlier_peak = 0
        if fused and not self._retrain_due(live_kf):
            self._last_mapping_info = self._mapping_graphs(
                lambda fm: fm.keyframe(self, slot, kp, assoc, outlier, R, t,
                                       fid, ts))
            self._supersede_pending_ba(slot, fused)
        else:
            self.kernels.insert_keyframe(self.arena, slot, kp, assoc,
                                         outlier, R, t, fid, ts)
            self._update_bow(slot, kp)
            self._maybe_retrain_vocab(live_kf)
            self._local_mapping(slot, fused)
        dev = self.device
        self.last = self.last._replace(ref_kf=slot,
                                       rel_R=torch.eye(3, device=dev),
                                       rel_t=torch.zeros(3, device=dev))
        if self.loop_closing_enabled:
            self._loop_closing(slot)
        self.last = self.last._replace(
            assoc=self.arena.kf_obs_lm[slot].clone(),
            outlier=torch.zeros_like(self.last.outlier))
        self.refresh_graph_cache()

    def _mapping_step(self, slot, kf_counter, frame_id) -> torch.Tensor:
        """The mapping step without BA of a new keyframe (what
        ``_local_mapping`` runs, and graph K after the insertion and the
        BoW row). Returns its diagnostics (12,), on the device."""
        return self.mapping.mapping_step(
            self.arena, slot, kf_counter, frame_id, max_cams=self.ba_cams,
            run_ba=False, run_cull=True)[1]

    def _local_mapping(self, slot: int, fused: bool = False) -> None:
        """``system.py:904-931``: the mapping step without BA, then the
        rule by which a newer keyframe supersedes a pending deferred BA."""
        self._last_mapping_info = self._mapping_step(slot, self.n_kf,
                                                     self.last_kf_frame_id)
        self._supersede_pending_ba(slot, fused)

    def _supersede_pending_ba(self, slot: int, fused: bool) -> None:
        """A pending deferred BA superseded twice runs now; the new
        keyframe's BA is pending from the third keyframe on."""
        if self._ba_pending_slot is not None:
            self._ba_superseded += 1
            if self._ba_superseded >= 2:
                self._dispatch_deferred_ba(fused)
        if self.n_kf > 2:
            self._ba_pending_slot = slot

    def _mapping_graphs(self, run):
        """``run(fused_mapping)`` on the system's ``FusedMapping`` (made on
        first use); its captures and replays go into the frame's row."""
        if self._fused_mapping is None:
            self._fused_mapping = FusedMapping(self)
        fm = self._fused_mapping
        out = run(fm)
        row = self._row
        row["graph_mapping_captures"] += fm.frame_captures
        row["graph_mapping_replays"] += fm.frame_replays
        return out

    def _loop_closing(self, slot: int) -> None:
        """``LoopCloser.process`` on the new keyframe (``system.py:886-888``);
        its reads, waits and stage times go into the frame's row."""
        lc = self.loop_closer
        n_before = {k: len(v) for k, v in lc.timings.items()}
        with span("loop"):
            closed = lc.process(self, slot)
        row = self._row
        row["host_reads"] = row.get("host_reads", 0) + lc.reads
        if lc.eigh_waits:
            row["eigh_waits"] = row.get("eigh_waits", 0) + lc.eigh_waits
        for k, v in lc.timings.items():
            if len(v) > n_before.get(k, 0):
                row[f"loop_{k}_ms"] = v[-1] * 1e3
        g = lc.graph_counts
        if g["captures"] or g["replays"]:
            row["graph_loop_captures"] = g["captures"]
            row["graph_loop_replays"] = g["replays"]
            row["graph_loop_capture_waits"] = lc.capture_waits
        if closed:
            self.n_loops_closed += 1
            row["loop_closed"] = True

    def _dispatch_deferred_ba(self, fused: bool = False) -> None:
        """``system.py:939-953``: local BA around the pending keyframe (a
        no-op on the device if it was culled meanwhile); with ``fused``, a
        replay of graph BA."""
        slot = self._ba_pending_slot
        self._ba_pending_slot = None
        self._ba_superseded = 0
        if slot is None:
            return
        if fused:
            self._mapping_graphs(lambda fm: fm.deferred_ba(self, slot))
        else:
            self.mapping.ba_step(self.arena, slot, max_cams=self.ba_cams)
        self.ba_runs += 1
        self._row["ba"] = True
        self.refresh_graph_cache()

    # ------------------------------------------------------------------
    # Output (System::SaveKeyFrameTrajectoryTUM, system.py:959-984)
    # ------------------------------------------------------------------

    def keyframe_trajectory(self) -> List[Tuple[float, np.ndarray,
                                                np.ndarray]]:
        """(timestamp, quat_xyzw, t_wc) of each live keyframe in temporal
        order (slots are recycled, so ordered by frame id), camera to
        world."""
        a = self.arena
        valid = a.kf_valid.cpu().numpy()
        Rs, ts_ = a.kf_R.cpu().numpy(), a.kf_t.cpu().numpy()
        stamps, fids = a.kf_timestamp.cpu().numpy(), \
            a.kf_frame_id.cpu().numpy()
        order = np.argsort(np.where(valid, fids, np.iinfo(np.int64).max),
                           kind="stable")
        out = []
        for k in order:
            if not valid[k]:
                continue
            Rwc = Rs[k].T
            q = G.rot_to_quat(torch.as_tensor(Rwc)).numpy()
            out.append((float(stamps[k]), q, -Rwc @ ts_[k]))
        return out

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        with open(path, "w") as f:
            for ts, q, t in self.keyframe_trajectory():
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")
