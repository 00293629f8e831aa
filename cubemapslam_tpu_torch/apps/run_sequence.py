"""Dataset runner: the cubemap_lafida / cubemap_fangshan command line.

Counterpart of ``cubemapslam_tpu/apps/run_sequence.py``, with the same
positional contract as the reference binaries (cubemap_lafida.cpp:67-83):

    python -m cubemapslam_tpu_torch.apps.run_sequence \\
        VOC SETTINGS_YAML IMG_DIR IMG_LIST MASK TRAJ_OUT [PERF_OUT]

* VOC: a pretrained vocabulary npz (scripts/train_vocab.py, the ORBvoc.txt
  analog), a saved map npz (localization on a prebuilt map), or "none"
  (the vocabulary is then trained from the bootstrap keyframes).
* SETTINGS_YAML: a reference-format calibration (Config/*.yaml loads
  unmodified), or "none" for the built-in Lafida cam0 calibration.
* IMG_LIST: Lafida format "id ts path" lines or plain filenames (fangshan
  style, timestamp parsed from the name; cubemap_fangshan.cpp:90-102).
* MASK: a fisheye-space or cubemap-space mask image, or "none" (an FOV-cone
  mask is derived from the calibration).

It runs on the first CUDA card (``main(argv, device="cpu")`` runs the plain
versions). Frames are read by ``native.make_loader``; the frame path takes
8-bit frames (kernel W reads uint8), so a decoded frame is rounded to uint8,
which leaves an 8-bit grayscale image unchanged. Each frame's time is the
host clock around ``track_fisheye`` ended by a synchronisation of the card.
Set ``CUBEMAP_PROFILE=/dir`` to write a ``torch.profiler`` chrome trace of
the first 50 frames there.

Writes the TUM keyframe trajectory and the perf summary the reference
prints at exit (median/mean tracking time, tracked-frames ratio;
cubemap_lafida.cpp:159-179).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

NONE_ARGS = ("none", "None", "")
PROFILE_FRAMES = 50


def read_image_list(img_dir: str, list_path: str
                    ) -> List[Tuple[float, str]]:
    """Lafida 'id ts filename' triplets (cubemap_lafida.cpp:91-107) or bare
    filenames with the timestamp parsed from the stem
    (cubemap_fangshan.cpp:90-102)."""
    out = []
    with open(list_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 3:
                ts = float(parts[1])
                name = parts[2]
            else:
                name = parts[0]
                stem = os.path.splitext(os.path.basename(name))[0]
                digits = "".join(c for c in stem if c.isdigit() or c == ".")
                try:
                    ts = float(digits)
                except ValueError:
                    ts = float(len(out))
            out.append((ts, os.path.join(img_dir, name)))
    return out


def load_gray(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32)


def sequence_mask(slam, mask_path: str) -> torch.Tensor:
    """The keypoint mask of a run (``run_sequence.py:105-118``): a
    cubemap-sized image is used as it is, a fisheye-sized one is warped to
    the cross by ``warp_nearest``; either is binarized and multiplied by the
    FOV-cone mask, which alone is the mask without an image."""
    from cubemapslam_tpu_torch import warp as W

    cfg = slam.cfg
    fov = W.fov_mask(slam.cam, cfg.cube_w, cfg.cube_h)
    if mask_path in NONE_ARGS or not os.path.exists(mask_path):
        return fov
    m = load_gray(mask_path)
    if m.shape == (cfg.cube_h, cfg.cube_w):
        mask = torch.as_tensor((m > 0).astype(np.float32), device=slam.device)
    else:
        wm = slam.warp_map
        if m.shape != (wm.src_wh[1], wm.src_wh[0]):
            raise ValueError(
                f"{mask_path}: a mask is {cfg.cube_h}x{cfg.cube_w} (the "
                f"cross) or {wm.src_wh[1]}x{wm.src_wh[0]} (the fisheye), "
                f"not {m.shape[0]}x{m.shape[1]}")
        mask = (W.warp_nearest(torch.as_tensor(m, device=slam.device), wm)
                > 0).to(torch.float32)
    return mask * fov


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, prof_dir: str) -> None:
    prof.stop()
    path = os.path.join(prof_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def main(argv: Optional[List[str]] = None, device=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 6:
        print(__doc__)
        return 1
    voc_path, settings, img_dir, img_list, mask_path, traj_out = argv[:6]
    perf_out = argv[6] if len(argv) > 6 else None

    from cubemapslam_tpu_torch import place as PL
    from cubemapslam_tpu_torch import serialize
    from cubemapslam_tpu_torch.config import SlamConfig, load_config
    from cubemapslam_tpu_torch.native import make_loader
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM

    # the built-in defaults are the Lafida cam0 calibration
    cfg = SlamConfig() if settings in NONE_ARGS else load_config(settings)
    slam = CubemapSLAM(cfg, device=device)
    if voc_path not in NONE_ARGS and os.path.exists(voc_path):
        with np.load(voc_path) as z:
            is_vocab = "centers_0" in z
        if is_vocab:
            slam.vocab = PL.load_vocabulary(voc_path, slam.device)
            print(f"loaded vocabulary ({slam.vocab.n_words} words) "
                  f"from {voc_path}")
        else:
            serialize.load_map(slam, voc_path)
            print(f"loaded map from {voc_path}")

    images = read_image_list(img_dir, img_list)
    print(f"{len(images)} images in sequence")
    mask = sequence_mask(slam, mask_path)

    loader = make_loader([p for _, p in images],
                         n_workers=int(os.environ.get("DL_WORKERS", "4")))
    print(f"image loader: {type(loader).__name__}")
    prof_dir = os.environ.get("CUBEMAP_PROFILE")
    prof = None
    if prof_dir:
        os.makedirs(prof_dir, exist_ok=True)
        prof = _start_profile(slam.device)
    times = []
    sync = slam.device.type == "cuda"
    try:
        for i, (idx, img) in enumerate(loader):
            ts = images[idx][0]
            if img is None:
                img = load_gray(images[idx][1])
            frame = np.clip(np.rint(img), 0, 255).astype(np.uint8)
            t0 = time.perf_counter()
            slam.track_fisheye(frame, ts, mask=mask)
            if sync:
                torch.cuda.synchronize(slam.device)
            dt = time.perf_counter() - t0
            times.append(dt)
            if i % 50 == 0:
                print(f"frame {i}/{len(images)} state={slam.state.name} "
                      f"kf={slam.n_kf} {dt * 1000:.0f}ms")
            if prof is not None and i == PROFILE_FRAMES:
                _stop_profile(prof, prof_dir)
                prof = None
    finally:
        loader.close()
    if prof is not None:
        _stop_profile(prof, prof_dir)
    slam.save_keyframe_trajectory_tum(traj_out)
    med = float(np.median(times))
    mean = float(np.mean(times))
    ratio = slam.tracked_frames / max(slam.total_frames, 1)
    print(f"median tracking time: {med * 1000:.1f} ms")
    print(f"mean tracking time: {mean * 1000:.1f} ms")
    print(f"tracked frames ratio: {ratio:.3f}")
    if perf_out:
        with open(perf_out, "w") as f:
            f.write(f"median_tracking_time_s {med:.6f}\n")
            f.write(f"mean_tracking_time_s {mean:.6f}\n")
            f.write(f"tracked_frames_ratio {ratio:.6f}\n")
            f.write(f"loops_closed {slam.n_loops_closed}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
