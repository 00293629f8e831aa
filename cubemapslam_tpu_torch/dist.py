"""The global bundle-adjustment problem of the map arena.

Counterpart of the single-device part of ``cubemapslam_tpu/dist.py``:
``global_ba_problem_from_arena`` (``dist.py:202-220``), which the loop
closer's global BA builds even on one device. The sharded problem and its
collective solve come with the distributed-BA slice.
"""

from __future__ import annotations

import torch

from cubemapslam_tpu_torch import slam_map as SM
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.optim.ba import BAProblem


def global_ba_problem_from_arena(cam: CubemapCamera, arena: SM.MapArena,
                                 inv_level_sigma2: torch.Tensor
                                 ) -> BAProblem:
    """The full-map BA problem (GlobalBundleAdjustemnt analog): every valid
    keyframe and landmark, the temporally first valid keyframe fixed (slots
    are recycled, so "KF 0" is by frame id; ties go to the lower slot). The
    monocular scale gauge is retracted inside ``bundle_adjust``."""
    kf_idx, lm, face, uv_face, inv_s2, live = SM.ba_edges_from_arena(
        cam, arena, arena.kf_valid, inv_level_sigma2)
    ordkey = torch.where(arena.kf_valid, arena.kf_frame_id,
                         torch.full_like(arena.kf_frame_id, SM._BIG))
    # a stable sort's first entry: the first minimum
    first = torch.sort(ordkey, stable=True)[1][:1]
    cam_fixed = torch.zeros(arena.n_kf_cap, dtype=torch.bool,
                            device=arena.device).index_fill_(0, first, True)
    return BAProblem(
        R=arena.kf_R, t=arena.kf_t, cam_fixed=cam_fixed,
        cam_valid=arena.kf_valid, X=arena.lm_pos,
        pt_valid=arena.lm_valid, obs_cam=kf_idx, obs_pt=lm,
        obs_face=face, obs_uv=uv_face, obs_inv_sigma2=inv_s2,
        obs_valid=live)
