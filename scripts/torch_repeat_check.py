"""Where the port's map on a CUDA card differs from run to run.

    python3 scripts/torch_repeat_check.py [--runs 2] [--frames 30]
                                          [--deterministic-warnings]

Needs one CUDA card. Renders the ``slam`` phase's sequence of
``chip_smoke.py`` (the seeded world of 1500 billboards, full width, the
repo's vocabulary) and runs ``CubemapSLAM`` over its first ``--frames``
frames ``--runs`` times, each in a fresh system with the same seed. After
every frame it takes ``chip_smoke.map_snapshot`` (the sha256 digest of
each arena table and of the trajectory), and it prints one JSON line a
frame: the tables whose digest differs from the first run's, and the
largest difference of the keyframe poses and landmark positions. The first frame that differs and its tables
say which stage (tracking, keyframe insertion, mapping, local BA) brought
the variance in. A last line sums it up.

With ``--deterministic-warnings`` it first runs the same frames once more
under ``torch.use_deterministic_algorithms(True, warn_only=True)`` and
prints each distinct warning with its count: the operations PyTorch knows
to have no deterministic CUDA implementation. That run is a diagnostic
only; the port itself never switches the flag on.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import sys
import warnings

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from cubemapslam_tpu_torch import SlamConfig  # noqa: E402
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM  # noqa: E402


def run(cfg, frames, n):
    """Per frame: (table digests, keyframe poses, landmark positions, the
    frame's metrics row), from ``chip_smoke.map_snapshot``."""
    slam = CubemapSLAM(cfg, seed=CS.SEED)
    slam.stage_times = {}
    rows = []
    for i in range(n):
        slam.track_fisheye(frames[i], i / cfg.fps)
        snap = CS.map_snapshot(slam)
        t = snap["tables"]
        rows.append((snap["digests"],
                     torch.cat([t["kf_R"].reshape(-1), t["kf_t"].reshape(-1)]),
                     t["lm_pos"], slam.metrics[-1], snap["digest"]))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=CS.SLAM_FRAMES)
    ap.add_argument("--deterministic-warnings", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_repeat_check: needs a CUDA card", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(SlamConfig(), vocab_path=str(CS.VOCAB_PATH))
    poses, frames = CS.slam_sequence(cfg)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{CS.nvidia_smi_line()}", flush=True)
    if args.deterministic_warnings:
        seen = collections.Counter()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run(cfg, frames, args.frames)
        finally:
            torch.use_deterministic_algorithms(False)
        for w in caught:
            seen[str(w.message).splitlines()[0][:300]] += 1
        print(json.dumps({"deterministic_warnings": dict(seen)}), flush=True)
    first = run(cfg, frames, args.frames)
    first_diff = None
    for r in range(1, args.runs):
        other = run(cfg, frames, args.frames)
        for i, (a, b) in enumerate(zip(first, other)):
            tables = [k for k in a[0] if a[0][k] != b[0][k]]
            line = dict(run=r, frame=i, tables_differing=tables,
                        keyframe=bool(a[3].get("keyframe")),
                        ba=bool(a[3].get("ba")),
                        pose_gap=float((a[1] - b[1]).abs().max()),
                        landmark_gap=float((a[2] - b[2]).abs().max()))
            print(json.dumps(line), flush=True)
            if tables and first_diff is None:
                first_diff = (r, i, tables)
    print(json.dumps({"runs": args.runs, "frames": args.frames,
                      "first_difference": first_diff,
                      "final_digest": first[-1][4]}), flush=True)
    return 0 if first_diff is None else 1


if __name__ == "__main__":
    sys.exit(main())
