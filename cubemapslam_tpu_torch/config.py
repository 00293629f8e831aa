"""Configuration: one dataclass holding every tunable of the SLAM engine.

The reference scatters configuration across an OpenCV FileStorage YAML parsed
redundantly in four places (System.cpp:63-91, Tracking.cpp:61-105,
Viewer.cpp:38-56, MapDrawer.cpp:38-46) plus dozens of hard-coded constants
(grid 50x50x5 Frame.h:43-45; TH_LOW/TH_HIGH ORBMatcher.cpp:42-45; covisibility
threshold KeyFrame.cpp:356; chi-square gates 5.991/3.84/9.21; culling ratios).
Here everything is surfaced on one dataclass, and the reference's YAML
calibration files (Config/*.yaml) load unmodified for drop-in compatibility.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional


def parse_opencv_yaml(path: str) -> Dict[str, float]:
    """Parse the flat OpenCV-FileStorage-style YAML used by the reference.

    Handles the ``%YAML:1.0`` directive (which standard YAML parsers reject),
    ``#`` comments, and keys with no space after the colon
    (e.g. ``Viewer.PointSize:2`` in lafida_cam0_params.yaml:69).
    """
    out: Dict[str, float] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%"):
                continue
            m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
            if not m:
                continue
            key, val = m.group(1), m.group(2).strip()
            if val.startswith('"') and val.endswith('"'):
                out[key] = val[1:-1]
                continue
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """All SLAM engine parameters. Defaults mirror the reference's constants."""

    # --- Camera / calibration (System.cpp:63-91) ---
    fisheye_width: int = 754
    fisheye_height: int = 480
    # Scaramuzza forward polynomial a0..a{n-1} (z = -poly(rho))
    poly: tuple = (-209.200757992065, 0.0, 0.00213741670953883,
                   -4.2203617319086e-06, 1.77146086919594e-08)
    # Inverse polynomial rho(theta), pol0..pol{m-1}
    inv_poly: tuple = (293.667187375663, 149.982043337335, -10.448650568161,
                       28.2295300683376, 7.13365723186292, 0.056303218962532,
                       10.4144677485333, 0.166354960773665, -5.86858687381081,
                       1.18165998645705, 3.1108311354746, 0.810799620714366)
    affine_c: float = 0.999626131079017
    affine_d: float = -0.0034775192597376
    affine_e: float = 0.00385134991673147
    u0: float = 392.219508388648
    v0: float = 243.494438476351
    fov_deg: float = 190.0
    cube_face_w: int = 650
    cube_face_h: int = 650
    fps: float = 30.0
    with_fisheye_mask: bool = True

    # --- ORB extractor (Tracking.cpp:61-105) ---
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    init_features_factor: int = 3  # init-mode extractor uses 3x (Tracking.cpp:96)

    # --- Matcher constants (ORBMatcher.cpp:42-45) ---
    # (the reference's 5x50x50 feature grid, Frame.h:43-45, has no analog:
    # windowed search is an angular ray gate, so no grid config exists)
    th_low: int = 50
    th_high: int = 100
    histo_length: int = 12          # rotation-histogram bin width, degrees

    # --- Covisibility / graph (KeyFrame.cpp:356, Optimizer.cpp:648) ---
    covisibility_weight_th: int = 15
    essential_graph_min_weight: int = 100

    # --- Tracking thresholds (Tracking.cpp) ---
    min_init_keypoints: int = 100   # Tracking.cpp:397,416
    min_init_matches: int = 100     # Tracking.cpp:423
    init_min_triangulated: int = 50  # ReconstructE arg (Initializer.cpp:116)
    init_min_parallax_deg: float = 1.0
    init_good_ratio: float = 0.9    # ReconstructE nMinGood (cpp:311)
    min_track_inliers: int = 30     # Tracking.cpp:716
    min_track_inliers_after_reloc: int = 50  # Tracking.cpp:712
    max_local_keyframes: int = 80   # Tracking.cpp:934
    # Keyframe cadence (TPU redesign of NeedNewKeyFrame's c2,
    # Tracking.cpp:754-758): the reference's `inliers < 0.95*nRefMatches`
    # is throttled in practice by its mapper-busy refusal (mono inserts
    # are refused whenever LocalMapping is occupied, Tracking.cpp:761-771)
    # — matcher re-detection recall is well under 95%, so the ratio test
    # alone fires every frame. A deterministic runtime cannot couple
    # cadence to wall clock, and this arena's 6-neighbor triangulation
    # saturates the mature reference count (measured: n_ref ~1300 vs
    # ~400 frame inliers at the Lafida scale => KF every frame). Instead,
    # insert when the frame's tracked-inlier count decays below this
    # fraction of the PEAK inlier count since the last insertion —
    # like-for-like, so invariant to detector recall and map density.
    # Two consecutive frames must be below the bar (single-frame dips are
    # matcher noise, measured +-30% frame to frame). 0.9 (insert on 10%
    # decay) keeps the KF spacing tight enough that triangulation pairs
    # stay descriptor-stable: at 0.6 the working-scale run spaced KFs
    # 10-25 frames apart, raw KF-KF epipolar match yield collapsed
    # 2952 -> 600 across that gap, landmark replenishment fell below the
    # probation-cull rate, and tracking starved to LOST (measured,
    # NOTES_TPU round 5).
    keyframe_inlier_decay: float = 0.9
    # Map-health floor: insert a keyframe whenever tracked inliers fall
    # below this FRACTION of the feature budget (on top of the decay
    # trigger). The system is self-healing in the KF-dense regime (fresh
    # triangulations + fresh observation rows every few frames) and
    # fragile below ~100 inliers at the 2000-feature working scale
    # (low-parallax triangulations get pose-opt-rejected before BA can
    # mature them, probation culls them, and the map starves — measured,
    # NOTES_TPU round 5); the floor keeps the operating point far from
    # the death zone while letting genuinely healthy stretches run
    # keyframe-free at full frame rate. 0.15 (=300 inliers at the
    # 2000-feature working scale) runs keyframe-dense whenever the map is
    # below cruising health — measured as the only setting robust at BOTH
    # the 650^2 bench scale and the 160-px test scale (0.08 starved both).
    keyframe_health_floor_frac: float = 0.15
    # NeedNewKeyFrame's c2 compares tracked inliers against the reference
    # KF's MATURE point count (>=3 obs, Tracking.cpp:741-748). When that
    # count is below this floor, the local map is too young/thin for the
    # ratio to mean "coverage" and the degenerate count itself is treated
    # as insertion urgency (see system._need_new_keyframe). A steady-state
    # map holds several hundred mature points per reference KF, so this
    # only bites young or starving maps.
    keyframe_mature_floor: int = 100
    # constant-velocity extrapolation gain: 1.0 = reference motion model
    # (Tracking.cpp:626-631), 0.0 = predict from the last pose. See
    # runtime/system._predicted_pose for the stability analysis.
    motion_model_damping: float = 1.0
    # minimum frames between keyframes BEYOND the reference's conditions
    # (the mMinFrames=0 quirk admits a keyframe every frame,
    # Tracking.cpp:752 vs ctor 67-71). 0 = reference quirk behavior.
    # Keyframe cadence is otherwise purely map-state-driven; the
    # reference's mapper-busy refusal maps to the deferred-BA protocol
    # (see runtime/system._local_mapping), never to wall-clock time.
    min_keyframe_gap: int = 0

    # --- Chi-square gates ---
    chi2_mono: float = 5.991
    # 2x the reference's single-sided 3.84 (CheckDistEpipolarLine): both
    # rays carry pixel noise (see matching.search_for_triangulation)
    chi2_epipolar: float = 7.68
    chi2_sim3: float = 9.21

    # --- Map-point culling (LocalMapping.cpp:175-206) ---
    mp_found_ratio_th: float = 0.25
    kf_culling_redundant_ratio: float = 0.9  # LocalMapping.cpp:561-619

    # --- RANSAC defaults ---
    init_ransac_iters: int = 200    # Initializer ctor (Tracking.cpp:437)
    pnp_ransac_iters: int = 300     # Tracking.cpp:1035
    sim3_ransac_iters: int = 300    # LoopClosing.cpp:284

    # cap on the landmarks carried by one LOCAL bundle adjustment: the
    # covisible window's points are compacted into this many slots before
    # the solve (the reference's LocalBundleAdjustment graph is likewise
    # bounded by the local observation set, Optimizer.cpp:195-310); the
    # overflow, if any, keeps its old positions for that call
    max_local_ba_points: int = 8192
    # per-camera cap on the observation rows carried into local BA (each
    # keyframe's live observations are compacted to this many; a KF's live
    # obs count is typically a fraction of the feature budget)
    max_local_ba_obs_per_cam: int = 1280

    # --- Arena capacities (fixed shapes; TPU-native addition) ---
    # (observations live in the dense (K, n_features) table kf_obs_lm, so
    # there are no per-KF / per-landmark observation caps to configure)
    max_keyframes: int = 512
    max_landmarks: int = 65536

    # --- BoW / place recognition (ORBVocabulary.h:36-37: the reference's
    # pretrained vocab is k=10, 6 levels; ours is trained on the target
    # domain with the configured shape. BoW matching is a dense score
    # matmul, so there is no DBoW2 FeatureVector levels-up parameter.) ---
    vocab_branching: int = 10
    vocab_depth: int = 4
    vocab_path: Optional[str] = None  # pretrained vocab .npz (VOC argument)
    # without a pretrained vocab, the bootstrap-trained one is re-trained
    # once on accumulated keyframe descriptors at this many live keyframes
    vocab_retrain_keyframes: int = 24

    # --- Viewer / drawing (kept for config-file parity) ---
    viewer_params: Optional[dict] = None
    frame_drawer_margin_x: int = 200
    frame_drawer_margin_y: int = 320

    # -------- derived --------
    @property
    def cube_w(self) -> int:
        """Full cubemap cross width = 3 faces (System.cpp:83-84)."""
        return 3 * self.cube_face_w

    @property
    def cube_h(self) -> int:
        return 3 * self.cube_face_h

    @property
    def face_fx(self) -> float:
        """Shared pinhole intrinsics: fx=fy=cx=cy=W/2 (System.cpp:83-84)."""
        return self.cube_face_w / 2.0

    @property
    def face_fy(self) -> float:
        return self.cube_face_h / 2.0

    @property
    def face_cx(self) -> float:
        return self.cube_face_w / 2.0

    @property
    def face_cy(self) -> float:
        return self.cube_face_h / 2.0

    @property
    def cos_fov_th(self) -> float:
        """FOV gate cos(fov/2) (CamModelGeneral.h:224-229)."""
        return math.cos(self.fov_deg / 2.0 * math.pi / 180.0)

    @property
    def scale_factors(self) -> List[float]:
        return [self.scale_factor ** i for i in range(self.n_levels)]

    @property
    def level_sigma2(self) -> List[float]:
        return [s * s for s in self.scale_factors]


def load_config(yaml_path: str, **overrides) -> SlamConfig:
    """Build a SlamConfig from a reference-format calibration YAML.

    Reads the same keys System.cpp:63-91 and Tracking.cpp:61-105 read.
    """
    kv = parse_opencv_yaml(yaml_path)

    def geti(key, default):
        return int(kv.get(key, default))

    def getf(key, default):
        return float(kv.get(key, default))

    n_pol = geti("Camera.nrpol", 5)
    n_inv = geti("Camera.nrinvpol", 12)
    poly = tuple(getf(f"Camera.a{i}", 0.0) for i in range(n_pol))
    inv_poly = tuple(getf(f"Camera.pol{i}", 0.0) for i in range(n_inv))

    kwargs = dict(
        fisheye_width=geti("Camera.Iw", 754),
        fisheye_height=geti("Camera.Ih", 480),
        poly=poly,
        inv_poly=inv_poly,
        affine_c=getf("Camera.c", 1.0),
        affine_d=getf("Camera.d", 0.0),
        affine_e=getf("Camera.e", 0.0),
        u0=getf("Camera.u0", 0.0),
        v0=getf("Camera.v0", 0.0),
        fov_deg=getf("Camera.fov", 190.0),
        cube_face_w=geti("CubeFace.w", 650),
        cube_face_h=geti("CubeFace.h", 650),
        fps=getf("Camera.fps", 30.0),
        with_fisheye_mask=bool(geti("Camera.withFisheyeMask", 0)),
        n_features=geti("ORBextractor.nFeatures", 2000),
        scale_factor=getf("ORBextractor.scaleFactor", 1.2),
        n_levels=geti("ORBextractor.nLevels", 8),
        ini_th_fast=geti("ORBextractor.iniThFAST", 20),
        min_th_fast=geti("ORBextractor.minThFAST", 7),
        frame_drawer_margin_x=geti("FrameDrawer.MarginX", 0),
        frame_drawer_margin_y=geti("FrameDrawer.MarginY", 0),
        viewer_params={k: v for k, v in kv.items() if k.startswith("Viewer.")},
    )
    kwargs.update(overrides)
    return SlamConfig(**kwargs)
