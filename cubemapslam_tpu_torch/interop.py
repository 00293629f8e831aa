"""Carry state across from the JAX package, given as numpy arrays.

The parity tests hand the JAX package's camera, warp-map coordinates,
keypoints, landmarks, map arena and vocabulary to the port through these
functions (and the arena and vocabulary back), so that both packages compute
on identical maps and operators; ``serialize`` writes maps in the JAX
package's dtypes through them. Nothing here imports JAX: callers pass numpy arrays (for a JAX
NamedTuple, ``{k: np.asarray(v) for k, v in nt._asdict().items()}``).

Descriptors cross as (N, 8) uint32 on the JAX side and (N, 8) int64 words
in the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.place import Vocabulary, vocabulary_from_numpy
from cubemapslam_tpu_torch.slam_map import MapArena
from cubemapslam_tpu_torch.warp import WarpMap, warp_map_from_coords

_ARENA_DESC = ("kf_desc", "lm_desc")


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


def arena_from_numpy(fields: Mapping[str, np.ndarray],
                     device="cpu") -> MapArena:
    """The JAX ``MapArena`` leaves (by field name) -> the port's arena:
    uint32 descriptors become int64 words, int32 tables int64."""
    out = {}
    for name in MapArena._fields:
        a = np.asarray(fields[name])
        if name in _ARENA_DESC:
            out[name] = desc_from_numpy(a.reshape(-1, 8), device).reshape(
                a.shape)
        elif a.dtype == np.int32:
            out[name] = _t(a, device, torch.int64)
        else:
            out[name] = _t(a, device)
    return MapArena(**out)


def arena_to_numpy(arena: MapArena) -> Dict[str, np.ndarray]:
    """The port's arena -> numpy arrays in the JAX package's dtypes."""
    out = {}
    for name, t in arena._asdict().items():
        a = t.detach().cpu().numpy()
        if name in _ARENA_DESC:
            a = a.astype(np.uint32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        out[name] = a
    return out


def vocab_from_numpy(fields: Mapping, device="cpu") -> Vocabulary:
    """The JAX ``Vocabulary`` leaves (by field name: per-level (.., 8)
    uint32 ``centers``, ``idf``, ``k``, ``depth``) -> the port's, with int64
    words."""
    return vocabulary_from_numpy(fields["centers"], fields["idf"],
                                 int(fields["k"]), int(fields["depth"]),
                                 device)


def vocab_to_numpy(vocab: Vocabulary) -> Dict:
    """The port's vocabulary -> the JAX ``Vocabulary`` leaves, uint32
    words."""
    return dict(centers=tuple(desc_to_numpy(c) for c in vocab.centers),
                idf=vocab.idf.detach().cpu().numpy(), k=vocab.k,
                depth=vocab.depth)


def landmarks_from_numpy(lm_pos: np.ndarray, lm_desc: np.ndarray,
                         lm_level: np.ndarray, lm_valid: np.ndarray,
                         device="cpu"):
    """Landmark arrays -> (lm_pos f32, lm_desc int64 words, lm_level int64,
    lm_valid bool) tensors."""
    return (_t(lm_pos, device, torch.float32),
            desc_from_numpy(lm_desc, device),
            _t(lm_level, device, torch.int64),
            _t(lm_valid, device, torch.bool))
