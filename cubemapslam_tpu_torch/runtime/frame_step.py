"""The per-frame tracking step: raw fisheye -> cubemap -> ORB -> projection
match -> pose.

``FrameTracker`` is the port's counterpart of the steady-state frame of the
JAX package: the device warp and cross assembly of
``CubemapSLAM._build_fused_step`` in front of the ``frame_step`` of
``__graft_entry__.entry`` (extract, ``search_by_projection`` against a
landmark set with radius 15 px and level offsets -1/+1, the scatter-max
association, then ``pose_optimization``). Everything static — camera, warp
map, FOV mask, pyramid and descriptor operators — is built once on the
device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.features.extractor import (
    Keypoints, build_extractor)
from cubemapslam_tpu_torch.matching import search_by_projection
from cubemapslam_tpu_torch.optim.pose_opt import pose_optimization
from cubemapslam_tpu_torch.warp import WarpMap, build_warp_map, fov_mask
from cubemapslam_tpu_torch.warp_cuda import warp_to_cross

SEARCH_RADIUS_PX = 15.0
LEVEL_LO_OFF, LEVEL_HI_OFF = -1, 1


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA card; without one this raises rather
    than dropping to the CPU. Pass ``"cpu"`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain PyTorch versions")
        return torch.device("cuda", 0)
    return torch.device(device)


class FrameTracker(nn.Module):
    """One tracking step per call, for one calibration and landmark set.

    ``forward(fisheye_u8, lm_pos, lm_desc, lm_level, lm_valid, R0, t0)``
    returns ``(kp, assoc, R, t, inliers, n_inliers)``: the frame's
    keypoints, the landmark associated with each keypoint (-1 if none), the
    optimised world->camera pose, the inlier mask over keypoints and its
    count. ``warp``, ``extract``, ``match`` and ``optimize`` are its stages.
    """

    def __init__(self, cfg: Optional[SlamConfig] = None, device=None):
        super().__init__()
        cfg = SlamConfig() if cfg is None else cfg
        dev = resolve_device(device)
        self.cfg = cfg
        self.cam = C.CubemapCamera.from_config(cfg, dev)
        self.extractor, self.params = build_extractor(
            cfg, self.cam, cfg.n_features, (cfg.cube_h, cfg.cube_w))
        wm = build_warp_map(self.cam, cfg.cube_w, cfg.cube_h)
        self.src_wh = wm.src_wh
        self.register_buffer("warp_xy", wm.xy)
        self.register_buffer("mask", fov_mask(self.cam, cfg.cube_w,
                                              cfg.cube_h))
        self.register_buffer("scale_factors", torch.tensor(
            cfg.scale_factors, dtype=torch.float32, device=dev))
        self.register_buffer("inv_sigma2", 1.0 / torch.tensor(
            cfg.level_sigma2, dtype=torch.float32, device=dev))

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def warp_map(self) -> WarpMap:
        return WarpMap(self.warp_xy, self.src_wh)

    def set_warp_map(self, wm: WarpMap) -> None:
        """Replace the warp map (the parity tests load the JAX package's)."""
        self.warp_xy = wm.xy.to(self.device)
        self.src_wh = wm.src_wh

    def warp(self, fisheye_u8: torch.Tensor) -> torch.Tensor:
        """(H, W) uint8 fisheye -> (3Hf, 3Wf) float32 cubemap cross."""
        return warp_to_cross(fisheye_u8, self.warp_map)

    def extract(self, cube: torch.Tensor) -> Keypoints:
        """ORB keypoints of the cross, culled by the FOV mask."""
        return self.extractor(cube, self.mask)

    def match(self, kp: Keypoints, lm_pos: torch.Tensor,
              lm_desc: torch.Tensor, lm_level: torch.Tensor,
              lm_valid: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor
              ) -> torch.Tensor:
        """Project and match the landmarks at (R0, t0): the landmark
        associated with each keypoint, -1 if none (scatter-max)."""
        Xc = G.se3_apply(R0, t0, lm_pos)
        res = search_by_projection(
            Xc, lm_desc, lm_level, lm_valid, kp, self.cam,
            self.scale_factors, SEARCH_RADIUS_PX,
            level_lo_off=LEVEL_LO_OFF, level_hi_off=LEVEL_HI_OFF)
        n_lm = lm_pos.shape[0]
        lm_ids = torch.arange(n_lm, dtype=torch.int64, device=Xc.device)
        cand = torch.where(res.ok, lm_ids, torch.full_like(lm_ids, -1))
        assoc = torch.full((kp.n,), -1, dtype=torch.int64, device=Xc.device)
        return assoc.scatter_reduce(0, res.idx, cand, reduce="amax",
                                    include_self=True)

    def optimize(self, kp: Keypoints, assoc: torch.Tensor,
                 lm_pos: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
        """Pose-only LM from (R0, t0) over the associated keypoints.
        Returns (R, t, inliers, n_inliers)."""
        Xw = lm_pos[assoc.clamp(min=0)]
        uv_face = C.cubemap_uv_to_in_face(self.cam, kp.uv)
        inv_s2 = self.inv_sigma2[kp.level.clamp(0, self.cfg.n_levels - 1)]
        return pose_optimization(self.cam, R0, t0, Xw, kp.face, uv_face,
                                 inv_s2, assoc >= 0)

    def forward(self, fisheye_u8, lm_pos, lm_desc, lm_level, lm_valid, R0,
                t0):
        kp = self.extract(self.warp(fisheye_u8))
        assoc = self.match(kp, lm_pos, lm_desc, lm_level, lm_valid, R0, t0)
        return (kp, assoc) + self.optimize(kp, assoc, lm_pos, R0, t0)
