"""Seeded synthetic inputs for driving the frame step without a dataset.

Used by ``chip_smoke.py`` and the tests: a fisheye frame of
textured squares on a mid-grey disc (a few thousand FAST corners at the
Lafida working size), landmarks back-projected from a frame's keypoints at
seeded depths and padded with random distractors, and start poses
perturbed from the identity.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.features.extractor import Keypoints
from cubemapslam_tpu_torch.geometry import so3_exp


def synthetic_fisheye(cfg: SlamConfig, seed: int) -> np.ndarray:
    """Textured squares on a mid-grey fisheye disc, as (H, W) uint8."""
    rng = np.random.default_rng(seed)
    H, W = cfg.fisheye_height, cfg.fisheye_width
    yy, xx = np.mgrid[0:H, 0:W]
    disc = np.hypot(xx - cfg.u0, yy - cfg.v0) < 0.8 * max(H, W) / 2
    img = np.where(disc, 128.0, 0.0).astype(np.float32)
    n = int(6e-3 * disc.sum())
    cy, cx = np.nonzero(disc)
    pick = rng.integers(0, len(cy), n)
    sides = rng.integers(3, 9, n)
    vals = rng.uniform(0, 255, n)
    for y, x, s, v in zip(cy[pick], cx[pick], sides, vals):
        img[y:y + s, x:x + s] = v
    img[~disc] = 0.0
    return img.astype(np.uint8)


def landmarks_from_keypoints(kp: Keypoints, n_total: int,
                             rng: np.random.Generator, n_levels: int = 8):
    """Back-project the valid keypoints at seeded depths 3-8 (identity
    pose), padded with random distractors to ``n_total``. Returns
    (lm_pos, lm_desc, lm_level, lm_valid) on the keypoints' device."""
    dev = kp.uv.device
    idx = np.nonzero(kp.valid.cpu().numpy())[0][:n_total]
    depth = rng.uniform(3.0, 8.0, len(idx)).astype(np.float32)
    pos = kp.rays.cpu().numpy()[idx] * depth[:, None]
    n_d = n_total - len(idx)
    d = rng.normal(size=(n_d, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.concatenate([pos, d * rng.uniform(3, 8, (n_d, 1))])
    desc = np.concatenate([kp.desc.cpu().numpy()[idx],
                           rng.integers(0, 2 ** 32, (n_d, 8))])
    level = np.concatenate([kp.level.cpu().numpy()[idx],
                            rng.integers(0, n_levels, n_d)])
    return (torch.as_tensor(pos.astype(np.float32), device=dev),
            torch.as_tensor(desc.astype(np.int64), device=dev),
            torch.as_tensor(level.astype(np.int64), device=dev),
            torch.ones(n_total, dtype=torch.bool, device=dev))


def perturbed_pose(rng: np.random.Generator, device, deg: float = 1.0,
                   metres: float = 0.02
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A start pose ``deg`` degrees and ``metres`` away from the identity,
    about a seeded axis and along a seeded direction."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    tdir = rng.normal(size=3)
    tdir /= np.linalg.norm(tdir)
    R0 = so3_exp(torch.tensor(axis * math.radians(deg), dtype=torch.float32,
                              device=device))
    t0 = torch.tensor(tdir * metres, dtype=torch.float32, device=device)
    return R0, t0
