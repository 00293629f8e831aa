"""Wall time of localization-mode and LOST frames of the PyTorch port on the
card, for a comparison of two checkouts in one run.

Builds the ``slam`` phase's map of ``chip_smoke.py`` (the pretrained
vocabulary, ``SlamConfig()``, the first SLAM_FRAMES frames of its seeded
world), then:

* LOST frames: ``--reps`` times a blank frame (the system goes LOST), then
  the frame at the ground truth of ``RELOC_FRAME``, which relocalizes; the
  synchronised wall ms of that frame;
* localization-mode frames: ``--reps`` times, from the arena and tracker
  state restored in place, the LOC_FRAMES frames after ``RELOC_FRAME`` in
  localization mode; the synchronised wall ms of each frame, eagerly and
  then through the graphs where the checkout has ``localization_graphs``,
  else as the checkout runs them (eagerly).

The first two repetitions of each kind are warm-up (they capture the
graphs) and are left out of the medians. Prints one JSON line with the
medians, the walls and the card's ``nvidia-smi`` name and power limit. Run
it from the root of the checkout to measure (it imports that checkout's
``chip_smoke.py`` and package):

    python scripts/torch_localization_profile.py [--reps 12]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from cubemapslam_tpu_torch import _build  # noqa: E402
from cubemapslam_tpu_torch.runtime.system import (CubemapSLAM,  # noqa: E402
                                                  TrackState)

WARMUP = 2


def timed(slam, img, ts) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.track_fisheye(img, ts)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def state(slam):
    return ({k: getattr(slam.arena, k).clone() for k in slam.arena._fields},
            slam.state, slam.last, slam.ref_kf, slam.velocity, slam.mb_vo,
            slam.frame_id, slam.generator.get_state())


def restore(slam, st):
    (tables, slam.state, slam.last, slam.ref_kf, slam.velocity, slam.mb_vo,
     slam.frame_id, gen) = st
    for k, v in tables.items():
        getattr(slam.arena, k).copy_(v)
    slam.generator.set_state(gen)


def median(walls):
    return float(np.median(walls[WARMUP:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _build.build_all(CS.SOURCES)
    cfg = dataclasses.replace(CS.SlamConfig(), vocab_path=str(CS.VOCAB_PATH))
    poses, frames = CS.slam_sequence(cfg)
    slam = CubemapSLAM(cfg, seed=CS.SEED)
    for i in range(CS.SLAM_FRAMES):
        slam.track_fisheye(frames[i], i / cfg.fps)
    if slam.state != TrackState.OK:
        raise AssertionError("the slam drive did not end tracking")
    blank = np.full(frames[0].shape, 20, np.uint8)
    lost = []
    for r in range(args.reps):
        slam.track_fisheye(blank, 100.0 + 2 * r)
        if slam.state != TrackState.LOST:
            raise AssertionError("a blank frame did not leave the system LOST")
        lost.append(timed(slam, frames[CS.RELOC_FRAME], 101.0 + 2 * r))
        if slam.state != TrackState.OK:
            raise AssertionError("the LOST frame did not relocalize")
    slam.activate_localization_mode()
    start = state(slam)
    first = CS.RELOC_FRAME + 1
    idx = range(first, first + CS.LOC_FRAMES)
    # a checkout without localization_graphs runs these frames eagerly
    kinds = {"eager": None}
    if hasattr(slam, "localization_graphs"):
        kinds = {"eager": False, "graph": True}
    walls = {}
    for kind, graphs in kinds.items():
        if graphs is not None:
            slam.localization_graphs = graphs
        per_rep = []
        for r in range(args.reps):
            restore(slam, start)
            per_rep.append([timed(slam, frames[i], 200.0 + i) for i in idx])
            if slam.state != TrackState.OK:
                raise AssertionError("a localization frame was lost")
        walls[kind] = [w for rep in per_rep for w in rep]
    n = CS.LOC_FRAMES
    out = {
        "card": CS.nvidia_smi_line(),
        "localization_graphs": hasattr(slam, "localization_graphs"),
        "lost_ms_median": median(lost),
        "lost_ms": lost,
        # the first two repetitions of LOC_FRAMES frames are warm-up
        "localization_ms_median": {
            k: float(np.median(w[WARMUP * n:])) for k, w in walls.items()},
        "localization_ms": walls,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
