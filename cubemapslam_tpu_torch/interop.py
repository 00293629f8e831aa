"""Carry state across from the JAX package, given as numpy arrays.

The parity tests hand the JAX package's camera, warp-map coordinates,
keypoints and landmarks to the port through these functions, so that both
packages compute on identical maps and operators. Nothing here imports JAX: callers
pass numpy arrays (for a JAX NamedTuple, ``{k: np.asarray(v) for k, v in
nt._asdict().items()}``).

Descriptors cross as (N, 8) uint32 on the JAX side and (N, 8) int64 words
in the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.warp import WarpMap, warp_map_from_coords


def _t(x, device, dtype=None) -> torch.Tensor:
    # a writable C-ordered copy that keeps 0-d arrays 0-d
    return torch.as_tensor(np.array(x, order="C"), dtype=dtype,
                           device=device)


def desc_from_numpy(desc: np.ndarray, device="cpu") -> torch.Tensor:
    """(N, 8) uint32 -> (N, 8) int64 words."""
    return _t(np.asarray(desc, np.uint32).astype(np.int64), device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(N, 8) int64 words -> (N, 8) uint32."""
    return desc.detach().cpu().numpy().astype(np.uint32)


def camera_from_numpy(fields: Mapping[str, np.ndarray],
                      device="cpu") -> CubemapCamera:
    """The JAX ``CubemapCamera`` leaves (by field name) -> the port's."""
    return CubemapCamera(**{
        f.name: _t(fields[f.name], device, torch.float32)
        for f in CubemapCamera.__dataclass_fields__.values()})


def warp_map_from_numpy(uv_f: np.ndarray, valid: np.ndarray, src_wh,
                        device="cpu") -> WarpMap:
    """The JAX ``camera.cubemap_to_fisheye`` of the cross grid, the input of
    its ``build_warp_map``, and the fisheye (W, H) -> the port's map. The
    port derives from it the same gather operands as the JAX map holds."""
    W, H = (int(v) for v in np.asarray(src_wh))
    return warp_map_from_coords(_t(uv_f, device, torch.float32),
                                _t(valid, device, torch.bool), (W, H))


def keypoints_from_numpy(fields: Mapping[str, np.ndarray],
                         device="cpu") -> Keypoints:
    """The JAX ``Keypoints`` leaves (by field name) -> the port's."""
    return Keypoints(
        uv=_t(fields["uv"], device, torch.float32),
        response=_t(fields["response"], device, torch.float32),
        angle=_t(fields["angle"], device, torch.float32),
        level=_t(fields["level"], device, torch.int64),
        face=_t(fields["face"], device, torch.int64),
        desc=desc_from_numpy(fields["desc"], device),
        rays=_t(fields["rays"], device, torch.float32),
        valid=_t(fields["valid"], device, torch.bool))


def keypoints_to_numpy(kp: Keypoints) -> Dict[str, np.ndarray]:
    """The port's keypoints -> numpy arrays in the JAX package's dtypes."""
    out = {k: v.detach().cpu().numpy() for k, v in kp._asdict().items()}
    out["level"] = out["level"].astype(np.int32)
    out["face"] = out["face"].astype(np.int32)
    out["desc"] = desc_to_numpy(kp.desc)
    return out


def landmarks_from_numpy(lm_pos: np.ndarray, lm_desc: np.ndarray,
                         lm_level: np.ndarray, lm_valid: np.ndarray,
                         device="cpu"):
    """Landmark arrays -> (lm_pos f32, lm_desc int64 words, lm_level int64,
    lm_valid bool) tensors."""
    return (_t(lm_pos, device, torch.float32),
            desc_from_numpy(lm_desc, device),
            _t(lm_level, device, torch.int64),
            _t(lm_valid, device, torch.bool))
