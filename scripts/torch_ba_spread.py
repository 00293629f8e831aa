"""Run-to-run spread of the port's ``local_ba`` on a CUDA card.

    python3 scripts/torch_ba_spread.py [--runs 6]

Needs one CUDA card. Builds the small arena of ``chip_smoke.py``'s
card-against-CPU mapping check (``CubemapSLAM`` on the CPU over 9 rendered
frames at 160^2 faces and 600 features, just before its last mapping
step), runs ``local_ba`` on it twice on the CPU and ``--runs`` times on
the card, each from the same arena, and prints one JSON line per card run:
its pose and landmark differences from the first CPU run (the statistics
that check bounds: the largest pose entry, and over the landmarks that 2 or
more keyframes observe the 99% quantile and the largest coordinate
difference, with that landmark's index, observation count and distance
from the BA's keyframe), and its largest landmark difference from the
first card run. A last line gives the CPU's own spread.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM


def small_arena():
    cfg = SlamConfig(cube_face_w=160, cube_face_h=160, n_features=600,
                     n_levels=3, max_keyframes=24, max_landmarks=4096,
                     min_init_keypoints=80, min_init_matches=60,
                     min_track_inliers=20, fps=5.0)
    poses = S.forward_trajectory(9)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    arena, slot, _, _ = S.arena_before_last_mapping(
        CubemapSLAM(cfg, device="cpu"), world, poses)
    return cfg, arena, slot


def local_ba(cfg, arena, slot, dev):
    a, _ = MappingKernels(cfg, device=dev).local_ba(arena.to(dev), slot, 5)
    return a.to("cpu")


def compare(c, g, slot):
    obs = c.kf_obs_lm[c.kf_valid]
    cnt = torch.bincount(obs[obs >= 0], minlength=c.n_lm_cap)
    held = (cnt >= 2) & c.lm_valid
    d = (c.lm_pos - g.lm_pos).abs().amax(dim=1)
    d_held = torch.where(held, d, torch.zeros_like(d))
    worst = int(torch.argmax(d_held))
    centre = -c.kf_R[slot].T @ c.kf_t[slot]
    return dict(
        dpose=max(float((c.kf_R - g.kf_R).abs().max()),
                  float((c.kf_t - g.kf_t).abs().max())),
        q99=float(torch.quantile(d[held], 0.99)), max=float(d[held].max()),
        worst_lm=worst, worst_obs=int(cnt[worst]),
        worst_depth=float(torch.linalg.norm(c.lm_pos[worst] - centre)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg, arena, slot = small_arena()
    cpu = [local_ba(cfg, arena, slot, "cpu") for _ in range(2)]
    first = None
    for r in range(args.runs):
        g = local_ba(cfg, arena, slot, "cuda")
        row = dict(run=r, **compare(cpu[0], g, slot))
        if first is None:
            first = g
        row["max_vs_first_card_run"] = float(
            (g.lm_pos - first.lm_pos).abs().max())
        print(json.dumps(row))
    print(json.dumps(dict(cpu_run_2_vs_1=compare(cpu[0], cpu[1], slot))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
