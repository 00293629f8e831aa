#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cubemapslam_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card at the shapes
of the Lafida cam0 working configuration (754x480 fisheye, 650^2 faces, a
1950x1950 cross, 2000 features over 8 levels, 8192 landmarks), times them
(``ms``: a wrapper call as the frame step pays it, host launch cost
included; ``device_ms``: the same calls replayed from a CUDA graph, the
device's time alone), then drives the per-frame tracking step
(``FrameTracker``) on a seeded synthetic fisheye frame and checks the
recovered pose, and that each kernel was launched once a frame (kernel D's
two passes once each). It then runs the same step under ``torch.profiler``
with one range per stage, for the device's busy time and idle share, the
five device operations with the most time in each stage, each kernel's
device time, and a check that the card's extract makes no product with the
dense descriptor operator; and it holds the card's frame step against the
same step on the CPU at a small size.

Then the tracking path against the map arena, at ``SlamConfig()`` defaults
(an arena of 512 keyframes x 2000 features and 65536 landmarks): it builds
a map (``build_map``: 6 keyframes rendered along a forward trajectory
through a seeded world of 1500 billboards), drives ``MapTracker`` over the
8 frames that follow a warm-up frame, checking that every frame tracks
within the stated pose bound of the ground truth, that TrackLocalMap adds
matches on most frames and that each kernel launches once a frame (kernel
D's passes once each) on this path; profiles 2 more frames with one range
per stage; forces the fallback, velocity-gate and blank-frame branches; and
holds ``MapTracker`` on the card against the CPU on a small map.

Then the whole system from its first frame, the ``slam`` phase:
``CubemapSLAM`` at ``SlamConfig()`` defaults (2000 features, 6000 at init)
over a rendered 30-frame sequence through a seeded world of 1500
billboards, one line a frame (state, counts, keyframe, deferred BA, host
reads, the wall ms of each stage), checked for initialization within 10
frames, every later frame tracked, 3 keyframes beyond the first 2, new
landmarks triangulated, a deferred BA, the launches of each kernel (one a
frame, kernel D's passes once each) and the ATE of the Sim3-aligned
trajectory; then one keyframe frame and one deferred-BA frame under the
profiler, whose host waits may not exceed their stated reads and the
upload; the ``repeat`` check (the same 30 frames again in a fresh
``CubemapSLAM``: every arena table and the trajectory bitwise equal to the
first run's, whose sha256 digest is printed on a line of its own so that
runs can be compared across calls); and ``mapping_step`` / ``local_ba`` on
the card against the CPU on a small arena. The ``slam`` phase loads the
repo's pretrained vocabulary (``artifacts/vocab_synth_10k.npz``), and each
keyframe gets its BoW row. The segmented-sum kernel (``csrc/seg_sum.cu``,
which gives the BA, the pose graph and the landmark normals a fixed order
of additions) runs a data-dependent number of times: its launches are
counted from 0 around the drive of each path (the mapping step and the
local BA here, the correction and the global BA of the loop closure, the
runner, the sharded BA), and each of those must launch it.

Then, on the ``slam`` phase's map: the ``reloc`` phase (2 blank frames make
the system LOST without a reset; the frame at the ground-truth pose of a
mid-sequence frame relocalizes, within the stated bound of the ground truth
through the ATE's Sim3 alignment; once more under the profiler, whose host
waits may not exceed the frame's stated reads, its eigen-solve waits and the
upload); the ``localization`` phase (6 frames tracked in localization mode
with the map unchanged, each within the bound, the worst frame and its
margin to the bound printed; perturbed landmarks engage mbVO, restored ones
relocalize and clear it); a save/load check (``save_map``, ``load_map`` into
a fresh ``CubemapSLAM``, whose next frame relocalizes); and ``word_ids`` /
``bow_vector``, ``detect_candidates`` and ``pnp_ransac`` on the card against
the CPU on seeded inputs. The ``slam`` phase runs with loop closing on: its
forward trajectory revisits nothing, so it must close no loop, and each
keyframe from the tenth runs loop detection (its wall ms is printed).

Last, the ``loop`` phase: the constructed-drift arena (14 keyframes,
segment B revisiting segment A under a Sim3 drift) at ``SlamConfig()``
capacities (512 keyframes x 2000 features, 65536 landmarks), with the
repo's vocabulary. On its arena the segmented-sum kernel is held bitwise
against its kernel-order plain version at the global BA's shapes (its live
edges by camera and by point) and at those of the local BA, the pose graph
and the landmark normals, and timed beside ``index_add_``;
``LoopCloser.process`` on slots 12 and 13 must close the
loop and cut the segment-B error to the stated share. A second, warm
closure on a fresh copy prints the wall time of each stage (detect, sim3,
correct, gba), the host reads, the eigen-solve waits and the peak memory;
a third copy is closed under the
profiler by stage (whose host waits may not exceed the stated reads and
eigen-solve waits); and holds the closure on the card against the CPU at
the tier-1 test's size, the correction and the global BA each within its
stated bounds.

Then the ``app`` phase: the ``slam`` phase's rendered frames written as PGM
files with a Lafida "id ts path" list under ``build/``, run through the
dataset runner ``apps.run_sequence.main`` with the reference argv (the
repo's vocabulary, ``SETTINGS_YAML none``: ``SlamConfig()``, ``MASK none``)
on the card, with the kernels' launch counts read around it; checked: the
native loader read the frames, every frame from initialization on is
tracked, no loop is closed, and the tracked frames' Sim3-aligned ATE is
under the ``slam`` bound (the TUM file's keyframes and their ATE are
printed); the median frame time is printed.
Last, the ``dist`` phase: the ``loop`` phase's arena, its global BA problem
on its live edges sharded with landmark ownership and solved by
``dist.distributed_bundle_adjust`` at world size 1 over NCCL (this process)
and 2 over gloo (two spawned ranks sharing the card; gloo stages CUDA
tensors through the host), each held against the single-process
``bundle_adjust`` of the same layout on the card within the stated bounds,
with the wall times and the boundary rows reduced each CG iteration. The
viewer (``viz``) needs matplotlib, which the card's machine lacks, so no
phase draws.

Output: progress lines, then one ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and the last line is missing. Without a CUDA card, or
without the package beside it, it exits non-zero before printing a result.
This script imports nothing of JAX.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import datetime
import hashlib
import io
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from cubemapslam_tpu_torch import (CubemapCamera, SlamConfig, _build,
                                   load_config)
from cubemapslam_tpu_torch import camera as TC
from cubemapslam_tpu_torch import dist as D
from cubemapslam_tpu_torch import interop, native, serialize
from cubemapslam_tpu_torch import place as PL
from cubemapslam_tpu_torch import segment as SG
from cubemapslam_tpu_torch import warp as TW
from cubemapslam_tpu_torch import warp_cuda
from cubemapslam_tpu_torch.apps import run_sequence
from cubemapslam_tpu_torch.features import extractor as TE
from cubemapslam_tpu_torch.geometry import se3_log, so3_exp, so3_log
from cubemapslam_tpu_torch.optim import ba as TBA
from cubemapslam_tpu_torch.optim.ba import BAProblem, bundle_adjust
from cubemapslam_tpu_torch.runtime import FrameTracker
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.synthetic import (
    landmarks_from_keypoints, perturbed_pose, synthetic_fisheye)
from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser
from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
from cubemapslam_tpu_torch.runtime.tracking import MapTracker
from cubemapslam_tpu_torch.solvers import horn_alignment
from cubemapslam_tpu_torch.solvers import pnp as PNP
from cubemapslam_tpu_torch.solvers.sampling import sample_minimal_sets

SEED = 0
N_LANDMARKS = 8192
N_FRAMES = 6                  # the first is a warm-up frame
PROFILE_FRAMES = 3            # frame steps under the profiler
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12    # float32 outside the tensor cores
TIMING_REPS, TIMING_BATCH = 7, 20
SOURCES = ("warp_remap.cu", "orb_detect.cu", "orb_describe.cu",
           "seg_sum.cu")
# launches of each kernel entry in one frame step
LAUNCHES_PER_FRAME = 1

# float operations per valid pixel of kernel W, counted from its source: 2
# floors, 4 subtractions, 8 products and 3 sums (the u8 loads and their
# conversions are not counted)
WARP_OPS_PER_PIXEL = 2 + 4 + 8 + 3
# float operations of kernel D, counted from its source. Every pixel: the
# compass test (4 differences, 6 min/max, 2 compares), the fallback merge (a
# compare and a select), the merged-zero test and one key compare. A pixel that
# passes the compass test: two FAST runs of 42 + 15 min/max, 2 differences,
# 1 max and the any-strong compare. A pixel whose merged response is > 0:
# NMS (9 max, 1 compare), 4 border compares.
DETECT_OPS_PIXEL = 4 + 8 + 2 + 1 + 1
DETECT_OPS_PASSING = 2 * (42 + 15) + 2 + 1 + 1
DETECT_OPS_POSITIVE = 10 + 4
# columns of the dense descriptor+moment operator: 32 bins x 256 bits + 2
DESC_OP_COLS = TE.N_ROT * 256 + 2
# the tracking path against the map arena (MapTracker), at SlamConfig()
# defaults: an arena of K=512 keyframes x N=2000 features, L=65536 landmarks
MAP_BILLBOARDS = 1500
MAP_KEYFRAMES = 6
KF_STRIDE = 3                 # keyframes at frames 0, 3, ..., 15
TRAJ_STEP, TRAJ_YAW = 0.04, 0.003   # per frame: map units, radians
TRACK_FRAMES = 8              # after one warm-up frame
TRACK_PROFILE_FRAMES = 2
# the map build_map must reach: live landmarks per feature of a keyframe,
# and landmarks the newest keyframe shares with each other keyframe
MAP_MIN_LANDMARKS_PER_FEATURE = 2
MAP_MIN_COVIS = 50
# bounds on every tracked frame: the pose against the ground truth, and
# TrackLocalMap adding matches on most frames
POSE_BOUND_DEG, POSE_BOUND_M = 0.1, 0.015
LOCAL_MIN_FRAMES = 6          # of TRACK_FRAMES with local_matched > 0
GATE_ROT_RAD = 0.3            # a velocity above the 0.2 rad gate
TRACK_STAGES = ("warp", "extract", "motion", "local.select", "local.search",
                "local.optimize", "local.counters", "epilogue")
# the whole system from its first frame (CubemapSLAM) at SlamConfig()
# defaults, over a rendered sequence of SLAM_FRAMES frames: the cut against
# the 220 frames of the working-scale run
SLAM_FRAMES = 30
SLAM_BILLBOARDS = 1500
SLAM_INIT_BY = 10             # initialized within the first 10 frames
SLAM_MIN_NEW_KF = 3           # keyframes by the cadence beyond the first 2
SLAM_ATE_FRAC = 0.01          # ATE bound, as a fraction of the path length
SLAM_PROFILE_MAX = 8          # frames profiled to find a keyframe frame and
                              # a deferred-BA frame
SLAM_STAGES = TRACK_STAGES + ("insert+mapping", "loop", "local_ba")
# the pretrained vocabulary the slam phase loads (k=10, depth 4)
VOCAB_PATH = pathlib.Path(__file__).resolve().parent / "artifacts" / \
    "vocab_synth_10k.npz"
# relocalization and localization mode on the slam phase's map: blank frames
# (a constant-20 image) make it LOST, then the frame at the ground-truth pose
# of RELOC_FRAME relocalizes; LOC_FRAMES frames after it in localization
# mode; landmark noise of LOC_SIGMA map units (a quarter of the median depth,
# which the initialization sets to 1: about 80 px at 650^2 faces, far
# outside the chi2 gate of every level) leaves fewer than 10 inliers
RELOC_BLANK = 2
RELOC_FRAME = 15
LOC_FRAMES = 6
LOC_SIGMA = 0.25
SAVELOAD_FRAME = 10
# bound on a relocalized or localization-mode pose against the ground
# truth, through the ATE's Sim3 alignment: degrees, and the camera centre as
# a fraction of the path length
RELOC_BOUND_DEG, RELOC_BOUND_FRAC = 0.5, SLAM_ATE_FRAC
RELOC_STAGES = ("warp", "extract", "reloc", "reloc.detect",
                "reloc.candidates", "reloc.widen")
# loop closing at full width (SlamConfig() capacities) on the
# constructed-drift arena: 14 keyframes, segment B (10-13) revisiting segment
# A (0-5) under a Sim3 drift; LOOP_POINTS world points give each segment
# keyframe row at least LOOP_MIN_ROW observations. The closure must cut the
# summed segment-B centre error to LOOP_ERR_FRAC of its value before.
LOOP_POINTS = 3000
LOOP_MIN_ROW = 1000
LOOP_ERR_FRAC = 0.6
LOOP_STAGES = ("loop.detect", "loop.sim3", "loop.correct", "loop.gba")
# the card-against-CPU closure at the tier-1 test's size, and its bounds:
# the RANSAC Sim3 and the refined rotation and translation (largest entry);
# (pose difference, 99% and largest landmark difference, share of the
# observation table equal) after the correction, and after the global BA
LOOP_SMALL = dict(cube_face_w=160, cube_face_h=160, n_features=600,
                  n_levels=3, max_keyframes=64, max_landmarks=8192)
LOOP_REF_SIM3 = 1e-4
LOOP_REF_CORRECT = (1e-4, 1e-3, 1e-2, 0.995)
LOOP_REF_GBA = (1e-5, 1e-3, 5e-3, 0.995)
# the dataset runner over the slam phase's frames, from files under build/
ROOT = pathlib.Path(__file__).resolve().parent
APP_DIR = ROOT / "build" / "chip_smoke_app"
# the sharded global BA on the loop phase's arena: the loop closer's
# schedule; bounds against the single-process solve of the same layout:
# (pose difference, 99% and largest point difference, share of the live
# edges with the same inlier verdict)
DIST_PHASES, DIST_CG_ITERS = (5, 10), 50
DIST_REF = (1e-4, 1e-3, 5e-3, 0.999)
DIST_TIMEOUT = 600.0
# the port's __global__ kernels, as the profiler names them
PORT_KERNELS = ("warp_remap_kernel", "fast_levels_kernel",
                "select_levels_kernel", "orb_describe_kernel",
                "seg_sum_kernel")
# the segmented-sum kernel at the shapes the main path gives it (full width):
# (rows, segments, lanes, live segments or None for all, share of rows on
# the dump id). The CG global BA of the loop arena (20,160 live edges over 14
# of 512 cameras, about 1,440 rows a camera, and 4,167 of 65,536 points; the
# smoke takes these two from the arena itself, the tests seed them), the
# direct local BA at SlamConfig() capacities (48 free of 96 cameras, 1280 row
# slots a camera, 8192 points), the pose graph's normal matrix over 512
# keyframe slots, and the landmark normals of update_landmark_stats_touched
# (16384 landmarks, 131072 observation slots).
SEG_SHAPES = {
    "gba_cameras": (20160, 512, (6, 6), 14, 0.0),
    "gba_points": (20160, 65536, (3, 3), 4167, 0.0),
    "local_ba_coupling": (48 * 1280, 48 * 8192, (18,), None, 0.0),
    "local_ba_points": (96 * 1280, 8192, (9,), None, 0.0),
    "pose_graph_H": (4 * 300, 512 * 512, (7, 7), 700, 0.0),
    "landmark_normals": (131072, 16384, (3,), None, 0.5),
}


def seg_case(name, device, seed=SEED + 11):
    """A seeded (plan, values) at SEG_SHAPES[name]: rows spread uniformly
    over the live segments, the given share on the dump id, normal
    values."""
    E, n, tail, live, dump = SEG_SHAPES[name]
    rng = np.random.default_rng([seed, len(name)])
    ids = rng.choice(n, live, replace=False) if live else np.arange(n)
    idx = ids[rng.integers(0, len(ids), E)]
    idx[rng.uniform(size=E) < dump] = n
    v = rng.normal(size=(E,) + tail).astype(np.float32)
    return (SG.SegmentPlan(torch.as_tensor(idx).to(device), n),
            torch.as_tensor(v).to(device))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median over TIMING_REPS batches of the per-launch time of a batch of
    TIMING_BATCH launches, between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(TIMING_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TIMING_BATCH):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / TIMING_BATCH)
    return float(np.median(per))


def graph_ms(fn) -> float:
    """Device time of one call of ``fn``, without the host's launch cost:
    TIMING_BATCH calls captured in one CUDA graph, the replay timed as in
    ``time_ms``, divided by TIMING_BATCH."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMING_BATCH):
            fn()
    return time_ms(graph.replay) / TIMING_BATCH


def bound(nbytes: float, nops: float):
    """Least time on an H100 (ms) and what bounds it."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = nops / H100_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pose_error(R, t):
    """(degrees, millimetres) away from the identity pose."""
    ang = math.degrees(float(torch.linalg.norm(so3_log(R))))
    return ang, float(torch.linalg.norm(t)) * 1e3


def check_warp(tracker, frame_u8):
    """Kernel W against warp_bilinear, and grid_sample as the yardstick."""
    wm = tracker.warp_map
    out = warp_cuda.warp_to_cross(frame_u8, wm)
    ref = TW.warp_bilinear(frame_u8, wm)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f"[W] warp {tuple(frame_u8.shape)} u8 -> {tuple(out.shape)}: "
        f"max |kernel - plain| = {err:.3g}")
    if not err <= 1e-3:
        raise AssertionError(f"kernel W disagrees: {err}")
    W, H = wm.src_wh
    valid = wm.valid
    # the same source coordinates as grid_sample's grid; invalid pixels
    # sample far outside the image and come out 0
    grid = torch.stack([wm.xy[..., 0] / (W - 1) * 2 - 1,
                        wm.xy[..., 1] / (H - 1) * 2 - 1], -1)
    grid = torch.where(valid[..., None], grid, torch.full_like(grid, -3.0))
    grid = grid[None].contiguous()
    src = frame_u8.float()[None, None].contiguous()
    n_pix, n_valid = valid.numel(), int(valid.sum())
    b_ms, b_by = bound(frame_u8.numel() + n_pix * (8 + 4),
                       WARP_OPS_PER_PIXEL * n_valid)
    row = dict(
        name="warp_remap", route="cuda",
        source="cubemapslam_tpu_torch/csrc/warp_remap.cu",
        replaces="cubemapslam_tpu/warp_tpu.py:242",
        max_abs_err=err,
        ms=time_ms(lambda: warp_cuda.warp_to_cross(frame_u8, wm)),
        device_ms=graph_ms(lambda: warp_cuda.warp_to_cross(frame_u8, wm)),
        plain_ms=time_ms(lambda: TW.warp_bilinear(frame_u8, wm)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)),
        library_device_ms=graph_ms(lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)),
        calls_per_frame=1)
    return row, out


def detect_work(levels, lo, cell, ini, mn):
    """What kernel D's work depends on in these levels: the pixels, those
    that pass its compass test at ``lo`` (two neighbouring compass points of
    the FAST circle both brighter than c + lo or both darker than c - lo),
    and those whose merged response is > 0 (plain versions, on the card)."""
    n_pix = n_pass = n_pos = 0
    for img in levels:
        d = [torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) - img
             for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
        hit = torch.zeros_like(img, dtype=torch.bool)
        for i in range(4):
            a, b = d[i], d[(i + 1) % 4]
            hit |= ((a > lo) & (b > lo)) | ((a < -lo) & (b < -lo))
        n_pix += img.numel()
        n_pass += int(hit.sum())
        n_pos += int((TE._fast_adaptive(img, ini, mn, cell) > 0).sum())
    return n_pix, n_pass, n_pos


def check_detect(tracker, levels):
    """Kernel D, one launch pair for all levels, against its plain version
    level by level: candidates bitwise, subpixel offsets within 1e-6."""
    p, cfg = tracker.params, tracker.cfg
    ini, mn = cfg.ini_th_fast, cfg.min_th_fast
    kern = TE.detect_cells_levels(levels, p.cell, ini, mn)
    start, err = 0, 0.0
    for lv, img in enumerate(levels):
        plain = TE._detect_cells_plain(img, p.cell, ini, mn)
        n = plain[0].shape[0]
        part = [t[start:start + n] for t in kern]
        for name, a, b in zip(("resp", "y", "x"), part[:3], plain[:3]):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel D level {lv}: {name} differs "
                                     f"at {int((a != b).sum())} entries")
        e = max(float((part[3] - plain[3]).abs().max()),
                float((part[4] - plain[4]).abs().max()))
        if not e <= 1e-6:
            raise AssertionError(f"kernel D level {lv}: subpixel err {e}")
        err = max(err, e)
        start += n
        log(f"[D] level {lv} {tuple(img.shape)}: {n} cells, candidates "
            f"bitwise equal, subpixel err {e:.3g}")
    if start != kern[0].shape[0]:
        raise AssertionError(f"kernel D gave {kern[0].shape[0]} cells, the "
                             f"levels have {start}")
    n_pix, n_pass, n_pos = detect_work(levels, min(ini, mn), p.cell, ini,
                                       mn)
    b_ms, b_by = bound(4 * n_pix + start * TE.PER_CELL * 20,
                       DETECT_OPS_PIXEL * n_pix + DETECT_OPS_PASSING * n_pass
                       + DETECT_OPS_POSITIVE * n_pos)
    log(f"[D] {n_pix} pixels, {n_pass} pass the compass test, {n_pos} "
        f"merge to a response > 0")
    row = dict(
        name="orb_detect", route="cuda",
        source="cubemapslam_tpu_torch/csrc/orb_detect.cu",
        replaces="cubemapslam_tpu/features/extractor.py:369",
        max_abs_err=err,
        ms=time_ms(lambda: TE.detect_cells_levels(levels, p.cell, ini, mn)),
        device_ms=graph_ms(
            lambda: TE.detect_cells_levels(levels, p.cell, ini, mn)),
        plain_ms=time_ms(lambda: [TE._detect_cells_plain(img, p.cell, ini, mn)
                                  for img in levels]),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, calls_per_frame=2)
    log(f"[D] {len(levels)} levels, {start} cells in one launch pair: kernel "
        f"{row['ms']:.5f} ms (device {row['device_ms']:.5f} ms), plain "
        f"{row['plain_ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by})")
    return row, kern


def unpack_bits(desc):
    """(K, 8) int64 words -> (K, 256) bits (bit j of word w = bit 32w+j)."""
    shifts = torch.arange(32, device=desc.device)
    return ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256)


def rot_bin(ang):
    return torch.remainder(torch.round(
        ang * (TE.N_ROT / (2.0 * math.pi))).to(torch.int64), TE.N_ROT)


def check_describe(p, ops, levels, cands, tag="describe"):
    """The describe kernel, one launch for all keypoints, against its plain
    version (raw patches, then the dense product with the descriptor+moment
    operator) on the frame's keypoints, for an extractor plan ``p`` and its
    operators. Both sum in float32 in different orders, so: angles within
    1e-4 rad (mod 2 pi), bins equal on >= 99.5% of keypoints, and on those,
    bits equal wherever the plain score is farther than 1e-2 from 0."""
    ys, xs, _, _, _ = TE._select_levels(cands, ops.sel_index, ops.sel_take)
    args = (levels, ys, xs, p.level_k, ops.desc_table)
    ang_k, desc_k = TE.describe_keypoints(*args)
    ang_p, desc_p = TE._describe_plain(*args)
    K = ys.shape[0]
    # the dense product the kernel removes, on the plain version's operands
    bnd = np.concatenate([[0], np.cumsum(p.level_k)])
    flat = TE._bf16_round(torch.cat([
        TE._gather_patches_plain(img, ys[bnd[i]:bnd[i + 1]],
                                 xs[bnd[i]:bnd[i + 1]])
        for i, img in enumerate(levels)]).reshape(K, -1))
    desc_op = TE.desc_operator(flat.device)
    fused = flat @ desc_op
    d_ang = torch.remainder(ang_k - ang_p + math.pi, 2 * math.pi) - math.pi
    err = float(d_ang.abs().max())
    bin_k, bin_p = rot_bin(ang_k), rot_bin(ang_p)
    same_bin = bin_k == bin_p
    scores = fused[:, :TE.N_ROT * 256].reshape(K, TE.N_ROT, 256)[
        torch.arange(K, device=flat.device), bin_p]
    bits_k, bits_p = unpack_bits(desc_k), unpack_bits(desc_p)
    firm = (scores.abs() > 1e-2) & same_bin[:, None]
    bad_firm = int(((bits_k != bits_p) & firm).sum())
    bins_equal = float(same_bin.float().mean())
    bits_equal = float((bits_k == bits_p).float().mean())
    log(f"[{tag}] {K} keypoints: angle err {err:.3g} rad, bins equal on "
        f"{bins_equal:.5f}, bits equal {bits_equal:.6f} ({bad_firm} firm "
        f"bits differ)")
    if not (err <= 1e-4 and bins_equal >= 0.995 and bad_firm == 0):
        raise AssertionError("the describe kernel disagrees with its plain "
                             "version")
    # bound: each keypoint's window read once (at most the level), the
    # chosen bins' table rows, the coordinates and the outputs; operations:
    # the two moments over the disc and the chosen bins' non-zero taps
    nnz = (ops.desc_table != 0).sum(dim=1)            # (N_ROT, 256)
    win = TE._WIN * TE._WIN
    n_bytes = sum(min(k * win, img.numel()) * 4
                  for k, img in zip(p.level_k, levels))
    n_bytes += int(torch.unique(bin_k).numel()) * ops.desc_table.shape[1] \
        * 256 * 4 + K * (8 + 4 + 64)
    n_mom = int((TE._moment_operator() != 0).sum())
    n_ops = 2 * (K * n_mom + int(nnz[bin_k].sum()))
    b_ms, b_by = bound(n_bytes, n_ops)
    row = dict(
        name="orb_describe", route="cuda",
        source="cubemapslam_tpu_torch/csrc/orb_describe.cu",
        replaces="cubemapslam_tpu/features/extractor.py:257",
        max_abs_err=err, bins_equal=bins_equal, bits_equal=bits_equal,
        ms=time_ms(lambda: TE.describe_keypoints(*args)),
        device_ms=graph_ms(lambda: TE.describe_keypoints(*args)),
        plain_ms=time_ms(lambda: TE._describe_plain(*args)),
        bound_ms=b_ms, bound_by=b_by,
        # the dense product of all 32 bins (a superset of the work)
        library_ms=time_ms(lambda: flat @ desc_op),
        library_device_ms=graph_ms(lambda: flat @ desc_op),
        calls_per_frame=1)
    log(f"[{tag}] kernel {row['ms']:.5f} ms (device "
        f"{row['device_ms']:.5f} ms), plain {row['plain_ms']:.5f} ms, dense "
        f"product {row['library_ms']:.5f} ms (device "
        f"{row['library_device_ms']:.5f} ms), bound {b_ms:.5f} ms ({b_by})")
    return row


def check_kernels(tracker, frame):
    """Every kernel against its plain version at the frame's shapes: the
    kernels' JSON rows, without their main-path launches. The describe
    kernel is also held at the init extractor's shape (3x the features):
    its row's ``init`` entry. Kernel D's work does not depend on the
    feature budget (it scores every cell of every level; the budget
    applies in the selection after it), so its one check covers both
    extractors. What the checks allocate is freed on return, before the
    main path is measured."""
    w_row, cube = check_warp(tracker, frame)
    levels = [cube] + [TE.pyramid_level(cube, A, Bt)
                       for A, Bt in tracker.extractor.ops.pyr]
    d_row, cands = check_detect(tracker, levels)
    g_row = check_describe(tracker.params, tracker.extractor.ops, levels,
                           cands)
    cfg = tracker.cfg
    ext, plan = TE.build_extractor(cfg, tracker.cam,
                                   cfg.n_features * cfg.init_features_factor,
                                   (cfg.cube_h, cfg.cube_w))
    init = check_describe(plan, ext.ops, levels, cands, tag="describe-init")
    g_row["init"] = {k: init[k] for k in (
        "max_abs_err", "bins_equal", "bits_equal", "ms", "device_ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")}
    g_row["init"]["keypoints"] = sum(plan.level_k)
    return [w_row, d_row, g_row]


# the segmented-sum kernel's launches by path: {phase: {"total": n, and by
# the method that launched them}}, each counted from 0 around its drive
SEG_LAUNCHES = {}


def seg_sum_cases(cam, arena, inv_s2):
    """The segmented-sum kernel's inputs at the main path's shapes: the
    loop arena's global BA on its live edges (by camera, the 36 lanes of
    Hcc, 1,440 rows a live camera on average and 2,000 at most; by point,
    the 9 of Hpp; the values of a first LM step) and ``seg_case`` at the
    other SEG_SHAPES. {name: (plan, values)}."""
    prob = D.global_ba_problem_from_arena(cam, arena, inv_s2)
    keep = prob.obs_valid.nonzero()[:, 0]
    live = prob._replace(**{f: getattr(prob, f)[keep] for f in D.EDGE_FIELDS})
    cam_plan, pt_plan = TBA._cg_plans(live)
    _, Hcc_e, Hpp_e, _, _, _ = TBA._edge_terms(cam, live,
                                               live.obs_inv_sigma2)
    cases = {"gba_cameras": (cam_plan, Hcc_e), "gba_points": (pt_plan, Hpp_e)}
    for name in SEG_SHAPES:
        if name not in cases:
            cases[name] = seg_case(name, "cuda")
    return cases


def check_seg_sum(cam, arena, inv_s2):
    """The segmented-sum kernel against its kernel-order plain version on
    the card at each shape of ``seg_sum_cases``, bitwise, and two launches
    on one plan bitwise equal; times at each shape (a wrapper call, the
    device's time from a CUDA graph, and ``index_add_`` into zeros, the
    library call with float atomics), the plain version's at the global
    BA's camera shape, which is the row's. Bound: each value, permutation
    entry and offset read once, each output lane written once; one add a
    value. Returns the kernel's JSON row, without its launches."""
    cases = []
    for name, (plan, v) in seg_sum_cases(cam, arena, inv_s2).items():
        a, b = SG.segment_sum(plan, v), SG.segment_sum(plan, v)
        ref = SG.segment_sum_ordered(plan, v)
        torch.cuda.synchronize()
        E, n, tail = v.shape[0], plan.n, tuple(v.shape[1:])
        lanes = math.prod(tail)

        def lib(plan=plan, v=v, tail=tail):
            # the dump row n takes the dropped rows, as in the plain version
            return torch.zeros((plan.n + 1,) + tail,
                               device="cuda").index_add_(0, plan.idx, v)[:-1]

        b_ms, b_by = bound(E * lanes * 4 + E * 8 + (n + 1) * 8
                           + n * lanes * 4, E * lanes)
        c = dict(name=name, rows=E, segments=n, lanes=lanes,
                 longest=int((plan.order()[1].diff()).max()),
                 bitwise=bool(torch.equal(a, ref) and torch.equal(a, b)),
                 max_abs_err=float((a - ref).abs().max()),
                 index_add_max_abs_diff=float((lib() - a).abs().max()),
                 ms=time_ms(lambda: SG.segment_sum(plan, v)),
                 device_ms=graph_ms(lambda: SG.segment_sum(plan, v)),
                 library_ms=time_ms(lib), library_device_ms=graph_ms(lib),
                 bound_ms=b_ms, bound_by=b_by)
        if name == "gba_cameras":
            c["plain_ms"] = time_ms(lambda: SG.segment_sum_ordered(plan, v))
        log(f"[seg_sum] {name}: {E} rows, {n} segments (longest "
            f"{c['longest']}), {lanes} lanes: bitwise {c['bitwise']} "
            f"(max |err| {c['max_abs_err']:.3g}; index_add_ differs by "
            f"{c['index_add_max_abs_diff']:.3g}); kernel {c['ms']:.5f} ms "
            f"(device {c['device_ms']:.5f}), index_add_ {c['library_ms']:.5f}"
            f" ms (device {c['library_device_ms']:.5f}), bound "
            f"{b_ms:.5f} ms ({b_by})"
            + (f", plain {c['plain_ms']:.5f} ms" if "plain_ms" in c else ""))
        cases.append(c)
    bad = [c["name"] for c in cases if not c["bitwise"]]
    if bad:
        raise AssertionError(f"seg_sum differs from its kernel-order plain "
                             f"version, or from itself, at {bad}")
    head = cases[0]
    row = dict(name="seg_sum", route="cuda",
               source="cubemapslam_tpu_torch/csrc/seg_sum.cu",
               replaces="cubemapslam_tpu/optim/ba.py:447 (the CG BA's "
                        ".at[].add, an XLA scatter; also ba.py:311, 329, "
                        "475-486, 514, optim/pose_graph.py:74-80, "
                        "slam_map.py:203; no pallas_call)",
               shape=f"gba_cameras: {head['rows']} rows x {head['lanes']} "
                     f"lanes into {head['segments']} segments",
               max_abs_err=max(c["max_abs_err"] for c in cases),
               **{k: head[k] for k in ("ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_device_ms")},
               cases=cases)
    return row


@contextlib.contextmanager
def seg_tally(obj, names, tally):
    """Count the segmented-sum launches inside each named method of
    ``obj`` into ``tally`` (by name) while the context is open."""
    orig = {n: getattr(obj, n) for n in names}

    def counted(name, fn):
        def call(*args, **kwargs):
            n0 = SG.SEG_SUM.launches
            try:
                return fn(*args, **kwargs)
            finally:
                tally[name] = tally.get(name, 0) + SG.SEG_SUM.launches - n0
        return call

    for name, fn in orig.items():
        setattr(obj, name, counted(name, fn))
    try:
        yield tally
    finally:
        for name, fn in orig.items():
            setattr(obj, name, fn)


def drive_main_path(tracker, frame_u8, lms, rng):
    """The frame step at full width from perturbed start poses. Per frame:
    the synchronised wall time and the host thread's CPU time (ms)."""
    walls, cpus, results = [], [], []
    for _ in range(N_FRAMES):
        R0, t0 = perturbed_pose(rng, tracker.device)
        torch.cuda.synchronize()
        t_start, c_start = time.perf_counter(), time.thread_time()
        out = tracker(frame_u8, *lms, R0, t0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t_start) * 1e3)
        cpus.append((time.thread_time() - c_start) * 1e3)
        results.append(out)
    return walls, cpus, results


def check_results(results, cfg):
    for i, (kp, assoc, R, t, inl, n) in enumerate(results):
        n_valid = int(kp.valid.sum())
        n_match = int((assoc >= 0).sum())
        n_inl = int(n)
        ang, mm = pose_error(R, t)
        finite = bool(torch.isfinite(R).all() and torch.isfinite(t).all())
        log(f"[path] frame {i}: {n_valid} valid keypoints, {n_match} "
            f"matches, {n_inl} inliers, pose error {ang:.4f} deg / "
            f"{mm:.3f} mm")
        if kp.uv.shape != (cfg.n_features, 2) or not finite:
            raise AssertionError("malformed frame-step output")
        if not (n_valid > 1000 and n_match > 500 and n_inl > 300):
            raise AssertionError("too few keypoints, matches or inliers")
        if not (ang < 0.2 and mm < 5.0):
            raise AssertionError("pose not recovered")


def raw_events(prof):
    """The profiler's events as (name, on the card, start ns, end ns, input
    shapes), read from its raw result: ``prof.events()`` builds a tree of
    Python objects, which takes minutes for a loop closure's 10^5
    operations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                    s + e.duration_ns(), e.shapes()))
    return out


def wait_sources(cpu):
    """A function that names the outermost aten operation around a host
    wait (a span of ``cpu``), else the wait's own name."""
    tops = []
    for name, _, a, b, _ in sorted((e for e in cpu
                                    if e[0].startswith("aten::")),
                                   key=lambda e: (e[2], -e[3])):
        if not tops or a >= tops[-1][2]:
            tops.append((name, a, b))
    starts = [t[1] for t in tops]

    def source(w):
        i = bisect.bisect_right(starts, w[2]) - 1
        return tops[i][0] if i >= 0 and tops[i][2] >= w[3] else w[0]

    return source


def waits_in(waits, spans, n, source):
    """Host waits that start inside ``spans``, per frame: their count and
    their count by ``source``, most first."""
    inside = [w for w in waits if any(a <= w[2] < b for a, b in spans)]
    by_src = {}
    for w in inside:
        src = source(w)
        by_src[src] = by_src.get(src, 0) + 1 / n
    return len(inside) / n, sorted(by_src.items(), key=lambda kv: -kv[1])


def profile_stages(step, stages, n):
    """``n`` calls of ``step`` under torch.profiler, each in a ``frame``
    range and synchronised after it, with one range per stage
    (``record_function``) inside. Returns the per-frame medians of the wall
    time (profiler on), the device's busy time (summed kernel and copy time)
    and the device operations; the host waits of a frame (a call that waits
    for the device: a synchronisation, which every blocking copy between
    host and card makes, or a blocking ``cudaMemcpy``) with their sources;
    per stage the host time, device busy time, device operations, host waits
    and the five device operations with the most time, all per frame; each
    port kernel's device time; and the count of matrix products with the
    dense descriptor operator (its 8194 columns), which must be 0."""
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            torch.cuda.synchronize()
            a = time.perf_counter()
            with record_function("frame"):
                step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - a) * 1e3)
    events = raw_events(prof)
    cpu = [e for e in events if not e[1]]
    dev = [e for e in events if e[1]]
    kernels = [e for e in dev if e[0] not in stages and e[0] != "frame"]
    if not kernels:
        raise AssertionError("the profiler recorded no device operation")
    busy = sum(e[3] - e[2] for e in kernels) / 1e6 / n
    waits = [e for e in cpu
             if "Synchronize" in e[0] or e[0] == "cudaMemcpy"]
    source = wait_sources(cpu)

    def host_spans(name):
        return [(e[2], e[3]) for e in cpu if e[0] == name]

    frame_waits, frame_sources = waits_in(waits, host_spans("frame"), n,
                                          source)
    per_stage = {}
    for st in stages:
        host = host_spans(st)
        spans = [(e[2], e[3]) for e in dev if e[0] == st]
        inside = [k for k in kernels
                  if any(a <= k[2] < b for a, b in spans)]
        by_name = {}
        for k in inside:
            t, c = by_name.get(k[0], (0.0, 0))
            by_name[k[0]] = (t + (k[3] - k[2]) / 1e6 / n, c + 1 / n)
        per_stage[st] = dict(
            host_ms=sum(b - a for a, b in host) / 1e6 / n,
            device_busy_ms=sum(k[3] - k[2] for k in inside) / 1e6 / n,
            device_ops=len(inside) / n,
            host_waits=waits_in(waits, host, n, source)[0],
            top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5])
    port = {}
    for k in kernels:
        name = next((n for n in PORT_KERNELS if n in k[0]), None)
        if name:
            port[name] = port.get(name, 0.0) + (k[3] - k[2]) / 1e6 / n
    dense_products = sum(
        1 for e in cpu
        if e[0] in ("aten::mm", "aten::matmul", "aten::addmm")
        and any(DESC_OP_COLS in s for s in (e[4] or []) if s))
    wall = float(np.median(walls))
    return dict(wall_ms=wall, walls_ms=walls, device_busy_ms=busy,
                idle_share=1.0 - busy / float(np.mean(walls)),
                device_ops=len(kernels) / n, host_waits=frame_waits,
                wait_sources=frame_sources, stages=per_stage,
                port_kernels=port, dense_products=dense_products)


def log_profile(tag, prof, unprofiled_walls):
    """Print a profile_stages result; fail on a dense descriptor product.
    The profiler slows the host, so the idle share is also given against
    the mean wall time of unprofiled frames."""
    n = len(prof["walls_ms"])
    idle_off = 1.0 - prof["device_busy_ms"] / float(np.mean(unprofiled_walls))
    log(f"[{tag}] {n} frames under torch.profiler: wall ms "
        f"{', '.join(f'{w:.3f}' for w in prof['walls_ms'])} (median "
        f"{prof['wall_ms']:.3f}); device busy {prof['device_busy_ms']:.3f} "
        f"ms per frame; idle share {prof['idle_share']:.4f} of the profiled "
        f"wall, {idle_off:.4f} of the unprofiled wall; "
        f"{prof['device_ops']:.0f} device operations per frame")
    log(f"[{tag}] host waits a frame {prof['host_waits']:.2f}, by source: "
        + ", ".join(f"{src} {c:.2f}" for src, c in prof["wait_sources"]))
    for st, v in prof["stages"].items():
        log(f"[{tag}] stage {st:14s}: host {v['host_ms']:.3f} ms, device "
            f"busy {v['device_busy_ms']:.3f} ms, {v['device_ops']:.0f} "
            f"device operations, {v['host_waits']:.0f} host waits per frame")
        for name, (ms, cnt) in v["top"]:
            log(f"[{tag}]   {ms:.5f} ms in {cnt:.0f} x {name[:110]}")
    log(f"[{tag}] the port's kernels, device ms per frame: "
        f"{', '.join(f'{k} {v:.5f}' for k, v in prof['port_kernels'].items())}")
    log(f"[{tag}] matrix products with the dense descriptor operator: "
        f"{prof['dense_products']}")
    if prof["dense_products"]:
        raise AssertionError("the card's extract made a dense descriptor "
                             "product")


def profiled_frames(tracker, frame_u8, lms, rng):
    """PROFILE_FRAMES frame steps of FrameTracker under profile_stages."""
    R0, t0 = perturbed_pose(rng, tracker.device)

    def step():
        with record_function("warp"):
            cube = tracker.warp(frame_u8)
        with record_function("extract"):
            kp = tracker.extract(cube)
        with record_function("match"):
            assoc = tracker.match(kp, *lms, R0, t0)
        with record_function("optimize"):
            tracker.optimize(kp, assoc, lms[0], R0, t0)

    return profile_stages(step, ("warp", "extract", "match", "optimize"),
                          PROFILE_FRAMES)


def small_reference_check():
    """The card's frame step against the CPU's (plain versions) on a small
    configuration, on the same warp map, mask and landmarks: same pose
    within 1e-3, same associations on >= 98% of matched rows."""
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4)
    rng = np.random.default_rng(SEED + 2)
    ref = FrameTracker(cfg, device="cpu")
    card = FrameTracker(cfg, device="cuda")
    card.set_warp_map(ref.warp_map)
    card.mask = ref.mask.to("cuda")
    f = torch.as_tensor(synthetic_fisheye(cfg, SEED + 1))
    lms = landmarks_from_keypoints(ref.extract(ref.warp(f)), 1024, rng,
                                   cfg.n_levels)
    R0, t0 = perturbed_pose(rng, "cpu")
    outs = []
    for tr, dev in ((ref, "cpu"), (card, "cuda")):
        args = [x.to(dev) for x in (f, *lms, R0, t0)]
        outs.append([o.cpu() for o in tr(*args)[1:]])
    (a_c, R_c, t_c, _, n_c), (a_g, R_g, t_g, _, n_g) = outs
    dR = float((R_c - R_g).abs().max())
    dt = float((t_c - t_g).abs().max())
    matched = (a_c >= 0) | (a_g >= 0)
    agree = float((a_c == a_g)[matched].float().mean())
    log(f"[ref] small config, card vs CPU: |dR| {dR:.3g}, |dt| {dt:.3g}, "
        f"associations agree on {agree:.4f} of {int(matched.sum())} "
        f"matched rows, inliers {int(n_g)} vs {int(n_c)}")
    if not (dR < 1e-3 and dt < 1e-3 and agree >= 0.98
            and int(matched.sum()) > 50):
        raise AssertionError("card and CPU frame steps disagree")


# ---------------------------------------------------------------------------
# The tracking path against the map arena
# ---------------------------------------------------------------------------

def gt_error(T, pose):
    """(degrees, map units) between a 4x4 world->camera pose and the
    ground-truth (R, t)."""
    R, t = pose
    dR = torch.as_tensor(T[:3, :3] @ R.T, dtype=torch.float32)
    return (math.degrees(float(torch.linalg.norm(so3_log(dR)))),
            float(np.linalg.norm(T[:3, 3] - t)))


def build_map_phase(cfg):
    """A seeded world and trajectory, and the map that build_map makes from
    MAP_KEYFRAMES rendered keyframes, on the card at full width. Returns
    the tracker, the poses and the rendered frames that follow the last
    keyframe (by trajectory index)."""
    first = (MAP_KEYFRAMES - 1) * KF_STRIDE + 1
    n_after = 1 + TRACK_FRAMES + TRACK_PROFILE_FRAMES
    poses = S.forward_trajectory(first + n_after, step=TRAJ_STEP,
                                 yaw_rate=TRAJ_YAW)
    world = S.make_world(np.random.default_rng(SEED), n=MAP_BILLBOARDS,
                         centers=S.camera_centres(poses),
                         fx=cfg.cube_face_w / 2.0)
    mt = MapTracker(cfg)                    # the card, by default
    a = mt.arena
    arena_mib = sum(t.numel() * t.element_size() for t in a) / 2 ** 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = S.build_map(mt, world, poses, MAP_KEYFRAMES, kf_stride=KF_STRIDE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_kf, n_lm = int(a.kf_valid.sum()), int(a.lm_valid.sum())
    newest = MAP_KEYFRAMES - 1
    weights = mt.covis[newest, :MAP_KEYFRAMES].tolist()
    log(f"[map] arena K={a.n_kf_cap} N={a.n_feat} L={a.n_lm_cap} "
        f"({arena_mib:.1f} MiB); {MAP_BILLBOARDS} billboards; keyframes at "
        f"frames {built.frames}: {n_kf} live keyframes, {n_lm} live "
        f"landmarks; keypoints linked to landmarks {built.linked}, new "
        f"landmarks {built.created}; covisibility of the newest keyframe "
        f"{weights}; built in {secs:.2f} s (rendering included)")
    if not (n_kf == MAP_KEYFRAMES
            and n_lm >= MAP_MIN_LANDMARKS_PER_FEATURE * a.n_feat
            and min(weights[:newest]) >= MAP_MIN_COVIS):
        raise AssertionError("the map was not built")
    render = S.Renderer(mt.cam, cfg)
    frames = {i: S.to_u8(render.render(*world, *poses[i])[0])
              for i in range(first, first + n_after)}
    return mt, poses, frames, first


def track_row_line(i, row, err, extra=""):
    counts = {k: row[k] for k in ("matches", "inliers_mm", "inliers",
                                  "n_ref", "live_kf", "first_free",
                                  "track_ok", "new_ref", "local_frustum",
                                  "local_queried", "local_matched")}
    e = "lost" if err is None else f"{err[0]:.4f} deg / {err[1] * 1e3:.2f} mm"
    return (f"frame {i}: {extra}counts {counts}; path {'>'.join(row['path'])}"
            f"; host reads {row['host_reads']}; pose error {e}")


def check_tracked(mt, T, i, poses):
    row = mt.metrics[-1]
    err = None if T is None else gt_error(T, poses[i])
    if T is None or not row["track_ok"] \
            or row["inliers"] < mt.cfg.min_track_inliers:
        raise AssertionError(f"frame {i} did not track: {row}")
    if not (err[0] < POSE_BOUND_DEG and err[1] < POSE_BOUND_M):
        raise AssertionError(f"frame {i}: pose error {err} beyond the bound")
    return row, err


def drive_tracking_path(mt, poses, frames, first, counters):
    """One warm-up frame, then TRACK_FRAMES frames of MapTracker with the
    launch counters set to 0 just before them. Per frame: the synchronised
    wall time and the host thread's CPU time (ms)."""
    T = mt.track_fisheye(frames[first], first / mt.cfg.fps)
    row, err = check_tracked(mt, T, first, poses)
    log("[track] warm-up " + track_row_line(first, row, err))
    for group in counters.values():
        for c in group:
            c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, cpus, rows = [], [], []
    for i in range(first + 1, first + 1 + TRACK_FRAMES):
        torch.cuda.synchronize()
        t_start, c_start = time.perf_counter(), time.thread_time()
        T = mt.track_fisheye(frames[i], i / mt.cfg.fps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t_start) * 1e3)
        cpus.append((time.thread_time() - c_start) * 1e3)
        row, err = check_tracked(mt, T, i, poses)
        rows.append(row)
        log(f"[track] " + track_row_line(i, row, err) + f"; wall "
            f"{walls[-1]:.3f} ms, host CPU {cpus[-1]:.3f} ms")
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[track] {TRACK_FRAMES} frames: wall ms median "
        f"{float(np.median(walls)):.3f}, host CPU ms median "
        f"{float(np.median(cpus)):.3f}; host reads a frame "
        f"{sorted(set(r['host_reads'] for r in rows))}; peak memory "
        f"{peak:.1f} MiB")
    for name, by_kernel in launches.items():
        log(f"[track] {name}: launches in {TRACK_FRAMES} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * TRACK_FRAMES:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {TRACK_FRAMES} tracked frames")
    n_local = sum(r["local_matched"] > 0 for r in rows)
    if n_local < LOCAL_MIN_FRAMES:
        raise AssertionError(f"TrackLocalMap added matches on only {n_local} "
                             f"of {TRACK_FRAMES} frames")
    return walls, launches


def profiled_tracking(mt, poses, frames, start):
    """TRACK_PROFILE_FRAMES frames of MapTracker under profile_stages."""
    it = iter(range(start, start + TRACK_PROFILE_FRAMES))
    got = []

    def step():
        i = next(it)
        got.append((i, mt.track_fisheye(frames[i], i / mt.cfg.fps)))

    prof = profile_stages(step, TRACK_STAGES, TRACK_PROFILE_FRAMES)
    for i, T in got:
        check_tracked(mt, T, i, poses)
    return prof


def forced_branches(mt, poses, frames, first, seed):
    """Three frames that force the fallbacks, from the map's last keyframe
    again (``seed``, the tracker's state when the map was built): an emptied
    last association (widen -> zero velocity -> reference keyframe, and
    still tracks), a velocity above the 0.2 rad gate (predicts from the last
    pose, so the 15 px match suffices), and a blank frame (lost, None, no
    exception)."""
    fps = mt.cfg.fps
    i = first
    mt.seed(mt.arena, seed.kp, torch.full_like(seed.assoc, -1),
            seed.outlier, seed.R, seed.t, seed.ref_kf,
            frame_id=seed.frame_id)
    T = mt.track_fisheye(frames[i], i / fps)
    row, err = check_tracked(mt, T, i, poses)
    log("[branch] emptied last association: " + track_row_line(i, row, err))
    if row["path"] != ("motion", "widen", "zero_velocity", "reference_kf",
                       "local"):
        raise AssertionError(f"frame {i} took {row['path']}")
    i += 1
    vel = (so3_exp(torch.tensor([0.0, GATE_ROT_RAD, 0.0], device=mt.device)),
           torch.zeros(3, device=mt.device))
    rot = float(torch.linalg.norm(se3_log(*vel)[3:])) \
        * mt.cfg.motion_model_damping
    mt.velocity = vel
    T = mt.track_fisheye(frames[i], i / fps)
    row, err = check_tracked(mt, T, i, poses)
    log(f"[branch] velocity of {rot:.3f} rad (gate 0.2): "
        + track_row_line(i, row, err))
    if not (rot >= 0.2 and row["path"] == ("motion", "local")):
        raise AssertionError(f"the velocity gate did not hold: {row['path']}")
    blank = np.zeros_like(frames[i])
    T = mt.track_fisheye(blank, (i + 1) / fps)
    row = mt.metrics[-1]
    log("[branch] blank frame: " + track_row_line("blank", row, None)
        + f"; returned {T}")
    if T is not None or row["track_ok"] or row["path"][-1] != "skip_local":
        raise AssertionError("the blank frame was not lost")


def small_map_reference_check():
    """MapTracker on the card against MapTracker(device="cpu") on one map
    built on the CPU at a small size (128^2 faces, 256 features, 4 levels,
    K=16, L=2048), same warp map and mask, over 2 frames: poses within
    1e-3, associations equal on >= 98% of matched rows, packed counts
    within 2%."""
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=256,
                     n_levels=4, max_keyframes=16, max_landmarks=2048)
    ref = MapTracker(cfg, device="cpu")
    poses = S.forward_trajectory(12, step=TRAJ_STEP, yaw_rate=TRAJ_YAW)
    world = S.make_world(np.random.default_rng(SEED + 3), n=500,
                         centers=S.camera_centres(poses), fx=64.0)
    S.build_map(ref, world, poses, 4, kf_stride=3)
    card = MapTracker(cfg, device="cuda")
    card.set_warp_map(ref.warp_map)
    card.mask = ref.mask.to("cuda")
    last = ref.last
    card.seed(ref.arena, last.kp, last.assoc, last.outlier, last.R, last.t,
              last.ref_kf, frame_id=last.frame_id)
    render = S.Renderer(ref.cam, cfg)
    worst = (0.0, 1.0, 0.0)
    for i in (10, 11):
        img = S.to_u8(render.render(*world, *poses[i])[0])
        T_c = ref.track_fisheye(img, i / cfg.fps)
        T_g = card.track_fisheye(img, i / cfg.fps)
        if T_c is None or T_g is None:
            raise AssertionError(f"small map check: frame {i} lost")
        r_c, r_g = ref.metrics[-1], card.metrics[-1]
        a_c, a_g = ref.last.assoc, card.last.assoc.cpu()
        matched = (a_c >= 0) | (a_g >= 0)
        agree = float((a_c == a_g)[matched].float().mean())
        dpose = float(np.abs(T_c - T_g).max())
        dcount = max(abs(r_c[k] - r_g[k]) / max(r_c[k], 1)
                     for k in ("matches", "inliers_mm", "inliers",
                               "local_matched"))
        worst = (max(worst[0], dpose), min(worst[1], agree),
                 max(worst[2], dcount))
        log(f"[ref-map] frame {i}: |dpose| {dpose:.3g}, associations agree "
            f"on {agree:.4f} of {int(matched.sum())} matched rows, counts "
            f"card {r_g['matches']}/{r_g['inliers']} vs CPU "
            f"{r_c['matches']}/{r_c['inliers']}, paths {r_g['path']} / "
            f"{r_c['path']}")
    if not (worst[0] < 1e-3 and worst[1] >= 0.98 and worst[2] <= 0.02):
        raise AssertionError(f"card and CPU MapTrackers disagree: {worst}")


# ---------------------------------------------------------------------------
# The whole system from the first frame (CubemapSLAM)
# ---------------------------------------------------------------------------

def slam_sequence(cfg):
    """A seeded world and a forward trajectory of SLAM_FRAMES frames and the
    profiled ones after them, rendered on the host before any timing."""
    n = SLAM_FRAMES + SLAM_PROFILE_MAX
    poses = S.forward_trajectory(n, step=TRAJ_STEP, yaw_rate=TRAJ_YAW)
    world = S.make_world(np.random.default_rng(SEED + 4), n=SLAM_BILLBOARDS,
                         centers=S.camera_centres(poses),
                         fx=cfg.cube_face_w / 2.0)
    render = S.Renderer(CubemapCamera.from_config(cfg, "cpu"), cfg)
    t0 = time.perf_counter()
    frames = [S.to_u8(render.render(*world, *p)[0]) for p in poses]
    log(f"[slam] {n} frames rendered in {time.perf_counter() - t0:.1f} s "
        f"({SLAM_BILLBOARDS} billboards, {TRAJ_STEP} map units and "
        f"{TRAJ_YAW} rad of yaw a frame)")
    return poses, frames


def slam_row_line(i, row, wall):
    keys = ("inliers", "matches", "init_matches", "host_reads", "svd_waits",
            "eigh_waits", "loop_detect_ms")
    counts = {k: row[k] for k in keys if k in row}
    st = ", ".join(f"{k} {v:.3f}" for k, v in row.get("stage_ms", {}).items())
    return (f"frame {i}: {row['state']}; {counts}; keyframe "
            f"{bool(row.get('keyframe'))}, deferred BA "
            f"{bool(row.get('ba'))}; stage ms: {st}; wall {wall:.3f} ms")


def drive_slam(slam, poses, frames, counters):
    """CubemapSLAM over SLAM_FRAMES frames from the first, with stage
    timing (each stage synchronises) and the launch counters set to 0 just
    before. Checks: initialized within SLAM_INIT_BY frames, every frame
    after it tracked, SLAM_MIN_NEW_KF keyframes beyond the first 2, new
    landmarks triangulated, a deferred BA run, the launches, and the ATE of
    the Sim3-aligned trajectory."""
    cfg = slam.cfg
    for group in counters.values():
        for c in group:
            c.launches = 0
    SG.SEG_SUM.launches = 0
    seg = {}
    torch.cuda.reset_peak_memory_stats()
    slam.stage_times = {}
    walls, n_new, first_ok = [], [], None
    with seg_tally(slam.mapping, ("mapping_step", "local_ba"), seg):
        for i in range(SLAM_FRAMES):
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            T = slam.track_fisheye(frames[i], i / cfg.fps)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t_start) * 1e3)
            row = slam.metrics[-1]
            log("[slam] " + slam_row_line(i, row, walls[-1]))
            if T is not None and first_ok is None:
                first_ok = i
            if first_ok is not None and T is None:
                raise AssertionError(f"frame {i} after initialization was "
                                     f"lost")
            if row.get("keyframe") and row.get("stage") != "init":
                n_new.append(int(slam._last_mapping_info[2]))
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    SEG_LAUNCHES["slam"] = dict(total=SG.SEG_SUM.launches, **seg)
    log(f"[slam] seg_sum: launches in {SLAM_FRAMES} frames "
        f"{SEG_LAUNCHES['slam']} (by MappingKernels method)")
    if not (seg.get("mapping_step") and seg.get("local_ba")):
        raise AssertionError("the mapping step or the local BA launched no "
                             "segmented sum")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    times, slam.stage_times = slam.stage_times, None
    for name, by_kernel in launches.items():
        log(f"[slam] {name}: launches in {SLAM_FRAMES} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * SLAM_FRAMES:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {SLAM_FRAMES} frames of CubemapSLAM")
    stages = ", ".join(f"{k} {float(np.median(v)):.3f} (x{len(v)})"
                       for k, v in times.items())
    log(f"[slam] stage wall ms, median (count): {stages}; peak memory "
        f"{peak:.1f} MiB")
    live = int(slam.arena.kf_valid.sum())
    log(f"[slam] initialized at frame {first_ok}; {slam.n_kf} keyframes "
        f"created, {live} live; new landmarks by mapping step {n_new}; "
        f"deferred BAs {slam.ba_runs}; "
        f"{int(slam.arena.lm_valid.sum())} live landmarks")
    detect = [round(r["loop_detect_ms"], 3) for r in slam.metrics
              if "loop_detect_ms" in r]
    log(f"[slam] loop detection wall ms by keyframe (from the tenth): "
        f"{detect}; loops closed {slam.n_loops_closed} (the trajectory "
        f"revisits nothing)")
    if slam.n_loops_closed != 0:
        raise AssertionError("a loop was closed on a trajectory that "
                             "revisits nothing")
    if first_ok is None or first_ok >= SLAM_INIT_BY:
        raise AssertionError(f"not initialized within {SLAM_INIT_BY} frames")
    if slam.n_kf < 2 + SLAM_MIN_NEW_KF:
        raise AssertionError(f"only {slam.n_kf} keyframes")
    if not n_new or max(n_new) <= 0:
        raise AssertionError("mapping triangulated no landmark")
    if slam.ba_runs < 1:
        raise AssertionError("no deferred BA ran")
    err, path, align = trajectory_ate(slam, poses)
    log(f"[slam] ATE {err:.5f} over a path of {path:.5f} ({err / path:.5f} "
        f"of it; bound {SLAM_ATE_FRAC}), {slam.tracked_frames} frames "
        f"tracked")
    if not err < SLAM_ATE_FRAC * path:
        raise AssertionError("the trajectory is beyond the ATE bound")
    return walls, launches, first_ok, (align, path)


def trajectory_ate(slam, poses):
    """RMS distance of the tracked camera centres to the ground truth after
    a Sim3 alignment by the port's horn_alignment, the path length, and the
    alignment from map to world coordinates: (s, R, t) of the centres, and
    the rotation Q with R_map @ Q nearest R_world over the tracked frames
    (the centres of a near-straight path leave the rotation about it
    free)."""
    fps = slam.cfg.fps
    idx = [int(round(ts * fps)) for ts, _, _ in slam.trajectory]
    est = np.stack([-R.T @ t for _, R, t in slam.trajectory])
    gt = S.camera_centres(poses)[idx]
    s, Ra, ta = horn_alignment(torch.as_tensor(gt, dtype=torch.float32),
                               torch.as_tensor(est, dtype=torch.float32))
    al = float(s) * (Ra.numpy() @ est.T).T + ta.numpy()
    err = float(np.sqrt(np.mean(np.sum((al - gt) ** 2, axis=1))))
    m = sum(R.T @ np.asarray(poses[i][0], np.float64)
            for i, (_, R, _) in zip(idx, slam.trajectory))
    u, _, vt = np.linalg.svd(m)
    q = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    return (err, float(np.linalg.norm(gt[-1] - gt[0])),
            (float(s), Ra.numpy().astype(np.float64),
             ta.numpy().astype(np.float64), q))


def aligned_error(T, pose, align):
    """(degrees, world units) between a 4x4 world->camera pose in map
    coordinates and the ground-truth (R, t), through the Sim3 ``align``
    (s, Ra, ta, Q) of ``trajectory_ate``: the rotation, and the distance
    of the camera centres."""
    s, Ra, ta, q = align
    R, t = T[:3, :3], T[:3, 3]
    R_gt, t_gt = pose
    centre = s * Ra @ (-R.T @ t) + ta
    dR = torch.as_tensor((R @ q) @ np.asarray(R_gt, np.float64).T)
    ang = math.degrees(float(torch.linalg.norm(so3_log(dR))))
    return ang, float(np.linalg.norm(centre - (-R_gt.T @ t_gt)))


def profiled_slam(slam, frames, walls):
    """Frames after the driven ones, each under profile_stages on its own,
    until one keyframe frame (insert + mapping_step + loop detection) and
    one deferred-BA frame are found (the frame after the profiled keyframe
    frame has its insertion held, so that its pending BA runs); the host
    waits of each may be no more than its stated reads (loop detection's
    among them), its eigen-solve waits and the frame's upload."""
    want = {"keyframe": None, "ba": None}
    for i in range(SLAM_FRAMES, SLAM_FRAMES + SLAM_PROFILE_MAX):
        held = (want["keyframe"] is not None and want["ba"] is None
                and slam.metrics[-1].get("keyframe", False))
        if held:
            # a forced branch: the keyframe gap rule refuses an insertion
            # on this frame, so the BA pending since the last keyframe
            # runs (frames that keep inserting keyframes would never run it)
            slam.last_kf_frame_id = slam.frame_id
        prof = profile_stages(
            lambda: slam.track_fisheye(frames[i], i / slam.cfg.fps),
            SLAM_STAGES, 1)
        row = slam.metrics[-1]
        kind = ("keyframe" if row.get("keyframe")
                else "ba" if row.get("ba") else None)
        log(f"[slam-profile] frame {i}: {kind or 'tracked'}"
            f"{' (keyframe insertion held)' if held else ''}; host reads "
            f"{row.get('host_reads')}; host waits {prof['host_waits']:.0f}; "
            f"wall {prof['wall_ms']:.3f} ms")
        if row["state"] != "OK":
            raise AssertionError(f"profiled frame {i} was not tracked")
        if kind and want[kind] is None:
            want[kind] = prof
            log_profile(f"slam-profile-{kind}", prof, walls)
            allowed = row["host_reads"] + row.get("eigh_waits", 0) + 1
            if prof["host_waits"] > allowed:
                raise AssertionError(
                    f"the {kind} frame waited {prof['host_waits']:.0f} "
                    f"times; its stated reads, eigen-solve waits and the "
                    f"upload are {allowed}")
        if all(want.values()):
            return want
    raise AssertionError(f"no keyframe frame and deferred-BA frame among "
                         f"{SLAM_PROFILE_MAX} profiled frames: {want}")


def profiled_init(cfg, frames, first_ok, walls):
    """A second CubemapSLAM over the same frames up to the one that
    initialized the first, that frame under profile_stages: its device
    time, operations and host waits (reads, the SVDs' waits and the
    upload), reported beside its stated reads."""
    slam = CubemapSLAM(cfg, seed=SEED)
    for i in range(first_ok):
        slam.track_fisheye(frames[i], i / cfg.fps)
    prof = profile_stages(
        lambda: slam.track_fisheye(frames[first_ok], first_ok / cfg.fps),
        ("warp", "extract", "init"), 1)
    row = slam.metrics[-1]
    if row["state"] != "OK":
        raise AssertionError("the profiled initialization did not succeed")
    log(f"[init-profile] frame {first_ok}: host reads {row['host_reads']}, "
        f"SVD waits {row['svd_waits']}, host waits {prof['host_waits']:.0f}")
    log_profile("init-profile", prof, walls)


INTEGER_VIEWS = ("kf_valid", "kf_frame_id", "kf_face", "kf_level", "kf_desc",
                 "kf_kp_valid", "kf_obs_lm", "lm_valid", "lm_desc",
                 "lm_visible", "lm_found", "lm_first_kf", "lm_birth",
                 "lm_first_frame")


def small_mapping_reference_check():
    """mapping_step (without BA) and local_ba on one small arena on the card
    and on the CPU (plain PyTorch): the integer views exactly equal, poses
    within 1e-4, the landmarks that 2 or more keyframes observe within 2e-3
    for 99% and 2e-2 for all. The arena is CubemapSLAM's on the CPU over 9
    rendered frames (160^2 faces, 600 features), just before its last
    mapping step."""
    cfg = SlamConfig(cube_face_w=160, cube_face_h=160, n_features=600,
                     n_levels=3, max_keyframes=24, max_landmarks=4096,
                     min_init_keypoints=80, min_init_matches=60,
                     min_track_inliers=20, fps=5.0)
    poses = S.forward_trajectory(9)
    world = S.make_world(np.random.default_rng(5), n=600,
                         centers=S.camera_centres(poses), fx=80.0)
    arena, slot, n_kf, fid = S.arena_before_last_mapping(
        CubemapSLAM(cfg, device="cpu"), world, poses)
    for stage in ("mapping_step", "local_ba"):
        outs = []
        for dev in ("cpu", "cuda"):
            mk = MappingKernels(cfg, device=dev)
            a = arena.to(dev)
            if stage == "mapping_step":
                a, info = mk.mapping_step(a, slot, n_kf, fid, max_cams=5,
                                          run_ba=False)
                outs.append((a.to("cpu"), info.tolist()))
            else:
                a, _ = mk.local_ba(a, slot, 5)
                outs.append((a.to("cpu"), None))
        (c, info_c), (g, info_g) = outs
        bad = [k for k in INTEGER_VIEWS
               if not torch.equal(getattr(c, k), getattr(g, k))]
        dpose = max(float((c.kf_R - g.kf_R).abs().max()),
                    float((c.kf_t - g.kf_t).abs().max()))
        obs = c.kf_obs_lm[c.kf_valid]
        held = (torch.bincount(obs[obs >= 0], minlength=c.n_lm_cap) >= 2) \
            & c.lm_valid
        d = (c.lm_pos - g.lm_pos).abs().amax(dim=1)[held]
        q99, dmax = float(torch.quantile(d, 0.99)), float(d.max())
        log(f"[ref-mapping] {stage}, card vs CPU: integer views differing "
            f"{bad}; |dpose| {dpose:.3g}; landmarks seen twice or more "
            f"({int(held.sum())}): 99% within {q99:.3g}, max {dmax:.3g}; "
            f"diagnostics card {info_g} vs CPU {info_c}")
        if bad or info_c != info_g or not (dpose < 1e-4 and q99 < 2e-3
                                           and dmax < 2e-2):
            raise AssertionError(f"card and CPU {stage} disagree")


def map_snapshot(slam):
    """Every arena table and the trajectory on the host, the sha256 digest
    of each (``digests``, the trajectory's under "trajectory") and of all
    of them (``digest``: tables in field order, then each pose's timestamp,
    R and t)."""
    tables = {k: getattr(slam.arena, k).detach().cpu().clone()
              for k in slam.arena._fields}
    traj = [(float(ts), np.asarray(R), np.asarray(t))
            for ts, R, t in slam.trajectory]
    h, digests = hashlib.sha256(), {}
    for k, v in tables.items():
        b = v.contiguous().numpy().tobytes()
        digests[k] = hashlib.sha256(b).hexdigest()
        h.update(k.encode())
        h.update(b)
    ht = hashlib.sha256()
    for ts, R, t in traj:
        b = np.float64(ts).tobytes() + R.tobytes() + t.tobytes()
        ht.update(b)
        h.update(b)
    digests["trajectory"] = ht.hexdigest()
    return dict(tables=tables, traj=traj, digest=h.hexdigest(),
                digests=digests)


def repeat_check(cfg, frames, ref):
    """The slam phase's SLAM_FRAMES frames again in a fresh CubemapSLAM
    (the same seed and stage timing as ``drive_slam``): every arena table
    (keyframe poses, landmark positions, the associations among them) and
    the trajectory bitwise equal to the first run's, ``ref``."""
    t0 = time.perf_counter()
    slam = CubemapSLAM(cfg, seed=SEED)
    slam.stage_times = {}
    for i in range(SLAM_FRAMES):
        slam.track_fisheye(frames[i], i / cfg.fps)
    snap = map_snapshot(slam)
    a, b = ref["tables"], snap["tables"]
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    traj_same = len(ref["traj"]) == len(snap["traj"]) and all(
        x[0] == y[0] and np.array_equal(x[1], y[1])
        and np.array_equal(x[2], y[2])
        for x, y in zip(ref["traj"], snap["traj"]))
    gaps = {k: float((a[k].double() - b[k].double()).abs().max())
            for k in ("kf_R", "kf_t", "lm_pos")}
    log(f"[repeat] the slam phase's {SLAM_FRAMES} frames again in a fresh "
        f"CubemapSLAM: map digest {snap['digest']} (first run "
        f"{ref['digest']}); tables differing {bad}; trajectory bitwise "
        f"equal {traj_same}; largest differences {gaps}; "
        f"{time.perf_counter() - t0:.1f} s")
    if bad or not traj_same:
        raise AssertionError("the slam phase's map differs between two runs "
                             "from the same frames")


def slam_phase(cfg, counters):
    """The whole system at full width from its first frame, with the
    pretrained vocabulary: the driven frames, the profiled keyframe and
    deferred-BA frames, and the small card-against-CPU mapping check.
    Returns the system, the poses and frames, the drive's launches and the
    ATE's (alignment, path length)."""
    cfg = dataclasses.replace(cfg, vocab_path=str(VOCAB_PATH))
    poses, frames = slam_sequence(cfg)
    t0 = time.perf_counter()
    slam = CubemapSLAM(cfg, seed=SEED)          # the card, by default
    torch.cuda.synchronize()
    log(f"[slam] CubemapSLAM at {cfg.cube_w}x{cfg.cube_h}, {cfg.n_features} "
        f"features ({cfg.n_features * cfg.init_features_factor} at init), "
        f"arena K={slam.arena.n_kf_cap} N={slam.arena.n_feat} "
        f"L={slam.arena.n_lm_cap}, vocabulary of {slam.vocab.n_words} words "
        f"({VOCAB_PATH.name}), built in {time.perf_counter() - t0:.1f} s")
    walls, launches, first_ok, ate = drive_slam(slam, poses, frames,
                                                counters)
    snap = map_snapshot(slam)
    log(f"[slam-digest] sha256 of the map after frame {SLAM_FRAMES - 1}: "
        f"{snap['digest']}")
    profiled_slam(slam, frames, walls)
    profiled_init(cfg, frames, first_ok, walls)
    repeat_check(cfg, frames, snap)
    del snap
    small_mapping_reference_check()
    return slam, poses, frames, launches, ate


# ---------------------------------------------------------------------------
# Relocalization, localization mode and map save/load on the slam map
# ---------------------------------------------------------------------------

def zero_launches(counters):
    for group in counters.values():
        for c in group:
            c.launches = 0
    SG.SEG_SUM.launches = 0


def read_launches(counters, tag, n_frames):
    """The launches since ``zero_launches``; each kernel entry must have
    launched once a frame."""
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    SEG_LAUNCHES[tag] = {"total": SG.SEG_SUM.launches}
    log(f"[{tag}] seg_sum: launches in {n_frames} frames "
        f"{SG.SEG_SUM.launches}")
    for name, by_kernel in launches.items():
        log(f"[{tag}] {name}: launches in {n_frames} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * n_frames:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {n_frames} frames of the {tag} "
                                     f"path")
    return launches


def timed_frame(slam, frame, ts):
    """One synchronised ``track_fisheye``: (pose or None, its row, wall
    ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T = slam.track_fisheye(frame, ts)
    torch.cuda.synchronize()
    return T, slam.metrics[-1], (time.perf_counter() - t0) * 1e3


def reloc_row_line(row, wall):
    keys = ("state", "stage", "reloc_candidates", "relocalized",
            "reloc_inliers", "inliers", "matches", "vo", "host_reads",
            "eigh_waits")
    counts = {k: row[k] for k in keys if k in row}
    st = ", ".join(f"{k} {v:.3f}" for k, v in row.get("stage_ms", {}).items())
    return f"{counts}; stage ms: {st}; wall {wall:.3f} ms"


def check_near_truth(tag, T, pose, align, path):
    ang, dist = aligned_error(T, pose, align)
    log(f"[{tag}] against the ground truth (Sim3-aligned): {ang:.4f} deg, "
        f"{dist:.5f} ({dist / path:.5f} of the path; bounds "
        f"{RELOC_BOUND_DEG} deg, {RELOC_BOUND_FRAC})")
    if not (ang < RELOC_BOUND_DEG and dist < RELOC_BOUND_FRAC * path):
        raise AssertionError(f"{tag}: pose beyond the bound of the ground "
                             f"truth")
    return ang, dist


def go_lost(slam, n, ts):
    """``n`` blank frames: each is lost, and the map keeps its keyframes."""
    n_kf = slam.n_kf
    blank = np.full((slam.cfg.fisheye_height, slam.cfg.fisheye_width), 20,
                    np.uint8)
    for k in range(n):
        T, row, wall = timed_frame(slam, blank, ts + k)
        log(f"[reloc] blank frame: " + reloc_row_line(row, wall))
        if T is not None or slam.state != TrackState.LOST \
                or slam.n_kf != n_kf:
            raise AssertionError("a blank frame did not leave the system "
                                 "LOST with its keyframes")


def reloc_phase(slam, poses, frames, ate, counters):
    """Blank frames make the system LOST (more than 5 live keyframes, so no
    reset); the frame at the ground-truth pose of RELOC_FRAME relocalizes
    within the bound, with the launch counters set to 0 just before it; a
    blank frame again, and the same frame relocalizes under the profiler,
    whose host waits may be no more than the frame's stated reads, its
    eigen-solve waits and the upload. Returns the launches."""
    align, path = ate
    live = int(slam.arena.kf_valid.sum())
    fids = slam.arena.kf_frame_id[slam.arena.kf_valid].tolist()
    log(f"[reloc] {live} live keyframes (frames {sorted(fids)}), "
        f"{slam.n_kf} created")
    if live <= 5:
        raise AssertionError("5 or fewer live keyframes: LOST would reset")
    ts = 100.0
    go_lost(slam, RELOC_BLANK, ts)
    zero_launches(counters)
    T, row, wall = timed_frame(slam, frames[RELOC_FRAME], ts + 10)
    launches = read_launches(counters, "reloc", 1)
    log(f"[reloc] frame {RELOC_FRAME} replayed: " + reloc_row_line(row, wall))
    if T is None or slam.state != TrackState.OK or not row["relocalized"]:
        raise AssertionError("the replayed frame did not relocalize")
    near = min(fids, key=lambda f: abs(f - RELOC_FRAME))
    slot = int(torch.nonzero(slam.arena.kf_valid
                             & (slam.arena.kf_frame_id == near))[0])
    d_kf = float(np.linalg.norm(T[:3, 3] - slam.arena.kf_t[slot].cpu().numpy()))
    log(f"[reloc] {d_kf:.5f} map units from the keyframe of frame {near}, "
        f"the live keyframe nearest frame {RELOC_FRAME}")
    check_near_truth("reloc", T, poses[RELOC_FRAME], align, path)
    go_lost(slam, 1, ts + 20)
    prof = profile_stages(
        lambda: slam.track_fisheye(frames[RELOC_FRAME], ts + 30),
        RELOC_STAGES, 1)
    row = slam.metrics[-1]
    log(f"[reloc-profile] frame {RELOC_FRAME}: " + reloc_row_line(
        row, prof["wall_ms"]))
    log_profile("reloc-profile", prof, [wall])
    if slam.state != TrackState.OK or not row["relocalized"]:
        raise AssertionError("the profiled frame did not relocalize")
    allowed = row["host_reads"] + row.get("eigh_waits", 0) + 1
    if prof["host_waits"] > allowed:
        raise AssertionError(f"the reloc frame waited "
                             f"{prof['host_waits']:.0f} times; its stated "
                             f"reads, eigen-solve waits and the upload are "
                             f"{allowed}")
    return launches


def map_counts(slam):
    a = slam.arena
    return slam.n_kf, int(a.kf_valid.sum()), int(a.lm_valid.sum())


def localization_phase(slam, poses, frames, ate, counters):
    """LOC_FRAMES frames after RELOC_FRAME in localization mode, with the
    launch counters set to 0 just before: each tracked within the bound, no
    mbVO, the map's keyframe and landmark counts unchanged. Then landmarks
    perturbed by LOC_SIGMA engage mbVO (a ``vo`` row), and restored, the
    next frame relocalizes and clears it. Returns the launches."""
    align, path = ate
    slam.activate_localization_mode()
    before = map_counts(slam)
    zero_launches(counters)
    walls, errs = [], {}
    first = RELOC_FRAME + 1
    for i in range(first, first + LOC_FRAMES):
        T, row, wall = timed_frame(slam, frames[i], 200.0 + i)
        walls.append(wall)
        log(f"[localization] frame {i}: " + reloc_row_line(row, wall))
        if T is None or row.get("stage") != "localization" or row["vo"]:
            raise AssertionError(f"localization frame {i} was not tracked "
                                 f"against the map")
        errs[i] = check_near_truth("localization", T, poses[i], align, path)
    launches = read_launches(counters, "localization", LOC_FRAMES)
    worst = max(errs, key=lambda i: errs[i][1])
    frac = errs[worst][1] / path
    log(f"[localization] worst frame {worst}: {frac:.5f} of the path, "
        f"{errs[worst][0]:.4f} deg; margin to the bound {RELOC_BOUND_FRAC}: "
        f"{RELOC_BOUND_FRAC - frac:.5f} ({frac / RELOC_BOUND_FRAC:.3f} of "
        f"it); by frame "
        f"{ {i: round(e[1] / path, 5) for i, e in errs.items()} }")
    after = map_counts(slam)
    log(f"[localization] {LOC_FRAMES} frames: wall ms median "
        f"{float(np.median(walls)):.3f}; (keyframes created, live, live "
        f"landmarks) before {before}, after {after}")
    if after != before:
        raise AssertionError("localization mode changed the map")
    a = slam.arena
    clean = a.lm_pos.clone()
    gen = torch.Generator(device=a.lm_pos.device).manual_seed(SEED)
    a.lm_pos.add_(LOC_SIGMA * torch.randn(clean.shape, generator=gen,
                                          device=clean.device))
    i = first + LOC_FRAMES
    T, row, wall = timed_frame(slam, frames[i], 200.0 + i)
    log(f"[localization] frame {i}, landmarks perturbed by sigma "
        f"{LOC_SIGMA}: mbVO {slam.mb_vo}; " + reloc_row_line(row, wall))
    if not (slam.mb_vo and row.get("vo")):
        raise AssertionError("mbVO did not engage on perturbed landmarks")
    a.lm_pos.copy_(clean)
    i += 1
    T, row, wall = timed_frame(slam, frames[i], 200.0 + i)
    log(f"[localization] frame {i}, landmarks restored: mbVO {slam.mb_vo}; "
        + reloc_row_line(row, wall))
    if T is None or slam.mb_vo or not row.get("relocalized"):
        raise AssertionError("the restored map did not relocalize and clear "
                             "mbVO")
    check_near_truth("localization", T, poses[i], align, path)
    if map_counts(slam) != before:
        raise AssertionError("localization mode changed the map")
    slam.deactivate_localization_mode()
    return launches


def save_load_check(slam, poses, frames, ate):
    """``save_map`` the map to a file under the checkout's ``build/``,
    ``load_map`` it into a fresh CubemapSLAM on the card: the arena equal
    table by table, LOST, and the next frame relocalizes within the
    bound."""
    align, path = ate
    out = pathlib.Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as d:
        f = pathlib.Path(d) / "map.npz"
        t0 = time.perf_counter()
        serialize.save_map(slam, str(f))
        t_save = time.perf_counter() - t0
        size = f.stat().st_size / 2 ** 20
        fresh = CubemapSLAM(slam.cfg, device=slam.device, seed=SEED + 1)
        t0 = time.perf_counter()
        serialize.load_map(fresh, str(f))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    bad = [k for k in slam.arena._fields
           if not torch.equal(getattr(slam.arena, k),
                              getattr(fresh.arena, k))]
    bad += [] if torch.equal(slam.bow_table, fresh.bow_table) else ["bow"]
    log(f"[saveload] map saved in {t_save:.2f} s ({size:.1f} MiB), loaded "
        f"in {t_load:.2f} s; tables differing {bad}; state "
        f"{fresh.state.name}")
    if bad or fresh.state != TrackState.LOST \
            or fresh.vocab.n_words != slam.vocab.n_words:
        raise AssertionError("the loaded map differs from the saved one")
    T, row, wall = timed_frame(fresh, frames[SAVELOAD_FRAME], 300.0)
    log(f"[saveload] frame {SAVELOAD_FRAME} on the loaded map: "
        + reloc_row_line(row, wall))
    if T is None or not row.get("relocalized"):
        raise AssertionError("the loaded map did not relocalize")
    check_near_truth("saveload", T, poses[SAVELOAD_FRAME], align, path)


def perturbed_copies(desc, rng, flips):
    """(N, 8) uint32 descriptors with ``flips`` random bits flipped each."""
    out = desc.copy()
    rows = np.repeat(np.arange(len(out)), flips)
    words = rng.integers(0, 8, len(rows))
    bits = rng.integers(0, 32, len(rows)).astype(np.uint32)
    np.bitwise_xor.at(out, (rows, words), np.uint32(1) << bits)
    return out


def pnp_scene(cam, rng, n=150, n_out=0):
    """``n`` points in front of ``cam`` at a known pose, their bearings
    and cross pixels (noise-free), ``n_out`` of the matches scrambled:
    (R, t, pts, rays, uv, valid) on the CPU."""
    pts = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    R = so3_exp(torch.tensor([0.2, -0.3, 0.1]))
    t = torch.tensor([0.4, -0.2, 0.6])
    pw = torch.as_tensor(pts)
    pc = pw @ R.T + t
    rays = pc / torch.linalg.norm(pc, dim=1, keepdim=True)
    uv, face = TC.ray_to_cubemap(cam, rays)
    valid = face != TC.UNKNOWN_FACE
    if n_out:
        idx = rng.choice(np.nonzero(valid.numpy())[0], n_out, replace=False)
        perm = torch.as_tensor(rng.permutation(idx))
        idx = torch.as_tensor(idx)
        rays[idx], uv[idx] = rays[perm].clone(), uv[perm].clone()
    return R, t, pw, rays, uv, valid


def small_reloc_reference_check(card="cuda"):
    """Place recognition and PnP on the card against the CPU (plain
    PyTorch) on seeded inputs: ``word_ids`` exactly equal and
    ``bow_vector`` rows within 1e-6 (the pretrained vocabulary, 500
    descriptors); ``detect_candidates`` the same candidates and flags (a
    K=32 table, 4 keyframes near the query, covisibility with ties);
    ``pnp_ransac`` with the same CPU-drawn minimal sets on noise-free
    scenes: both succeed with inlier counts within 5%, each pose within 1
    deg and 50 mm of the truth (the bounds of the JAX package's PnP test),
    and with no scrambled match the two poses within 0.05 deg and 1 mm.
    With 30% of the matches scrambled the two are held to the outcome
    only: each hypothesis starts from a null basis of its own (cuSOLVER's,
    LAPACK's), so the best inlier set can differ, and its linear refit
    moves with a scrambled match that lands near its true pixel."""
    rng = np.random.default_rng(SEED + 6)
    voc = PL.load_vocabulary(str(VOCAB_PATH), "cpu")
    voc_g = voc.to(card)
    desc = rng.integers(0, 2 ** 32, (500, 8), dtype=np.uint32)
    valid = torch.as_tensor(rng.uniform(size=500) < 0.9)
    d_c = interop.desc_from_numpy(desc)
    w_c, w_g = PL.word_ids(voc, d_c), PL.word_ids(voc_g, d_c.to(card))
    b_c = PL.bow_vector(voc, d_c, valid)
    b_g = PL.bow_vector(voc_g, d_c.to(card), valid.to(card))
    ids_equal = torch.equal(w_c, w_g.cpu())
    d_bow = float((b_c - b_g.cpu()).abs().max())
    # a K=32 table: 4 keyframes near the query, two covisible pairs
    K = 32
    query = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    kf = [rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
          for _ in range(K)]
    for s, flips in ((5, 1), (6, 2), (17, 1), (23, 2)):
        kf[s] = perturbed_copies(query, rng, flips)
    ones = torch.ones(K, 300, dtype=torch.bool)
    table = PL.bow_vectors(voc, interop.desc_from_numpy(np.stack(kf)), ones)
    qb = PL.bow_vector(voc, interop.desc_from_numpy(
        perturbed_copies(query, rng, 1)), ones[0])
    kf_valid = torch.ones(K, dtype=torch.bool)
    kf_valid[[11, 30, 31]] = False
    covis = np.triu(rng.integers(0, 4, (K, K)), 1)
    covis = covis + covis.T
    covis[5, 6] = covis[6, 5] = covis[17, 23] = covis[23, 17] = 40
    args = (qb, table, kf_valid, torch.zeros(K, dtype=torch.bool),
            torch.as_tensor(covis))
    i_c, ok_c = PL.detect_candidates(*args, 0.0)
    i_g, ok_g = PL.detect_candidates(*(x.to(card) for x in args), 0.0)
    cand_equal = torch.equal(ok_c, ok_g.cpu()) and torch.equal(
        i_c[ok_c], i_g.cpu()[ok_c])
    # PnP RANSAC with the same minimal sets: a clean scene, where every
    # hypothesis and the refit are exact, and one with scrambled matches
    cfg = SlamConfig()
    cams = {"cpu": CubemapCamera.from_config(cfg, "cpu"),
            "card": CubemapCamera.from_config(cfg, card)}

    def apart(R1, t1, R2, t2):
        return (math.degrees(float(torch.linalg.norm(so3_log(R1 @ R2.T)))),
                float(torch.linalg.norm(t1 - t2)) * 1e3)

    ok_pnp = True
    for n_out in (0, 45):
        R, t, pw, rays, uv, pvalid = pnp_scene(cams["cpu"], rng, n_out=n_out)
        sets = sample_minimal_sets(torch.Generator().manual_seed(SEED),
                                   pvalid, cfg.pnp_ransac_iters, PNP.MIN_SET)
        res = {}
        for d, cam in cams.items():
            r = PNP.pnp_ransac(cam, None, *(x.to(cam.device) for x in (
                pw, rays, uv, torch.ones(pw.shape[0]), pvalid)),
                n_iters=cfg.pnp_ransac_iters, sets=sets)
            res[d] = (bool(r.success), int(r.n_inliers), r.R.cpu(),
                      r.t.cpu())
        pair = apart(res["cpu"][2], res["cpu"][3], res["card"][2],
                     res["card"][3])
        truth = [apart(r[2], r[3], R, t) for r in res.values()]
        n_c, n_g = res["cpu"][1], res["card"][1]
        log(f"[ref-reloc] pnp_ransac, {n_out} of 150 matches scrambled: "
            f"success and inliers card {res['card'][:2]} vs CPU "
            f"{res['cpu'][:2]}, poses apart {pair[0]:.4g} deg / "
            f"{pair[1]:.4g} mm, from the truth "
            + ", ".join(f"{a:.4g} deg / {m:.4g} mm" for a, m in truth))
        ok_pnp &= res["cpu"][0] and res["card"][0] \
            and abs(n_c - n_g) <= 0.05 * n_c
        if n_out == 0:
            ok_pnp &= pair[0] < 0.05 and pair[1] < 1.0
        ok_pnp &= all(a < 1.0 and m < 50.0 for a, m in truth)
    log(f"[ref-reloc] card vs CPU: word ids equal {ids_equal}, BoW rows "
        f"within {d_bow:.3g}; candidates {i_g[ok_g].tolist()} vs "
        f"{i_c[ok_c].tolist()}, equal {cand_equal}")
    if not (ids_equal and d_bow <= 1e-6 and cand_equal and ok_c.any()):
        raise AssertionError("card and CPU place recognition disagree")
    if not ok_pnp:
        raise AssertionError("card and CPU pnp_ransac disagree")


# ---------------------------------------------------------------------------
# Loop closing at full width on the constructed-drift arena
# ---------------------------------------------------------------------------

def loop_system(cfg, device, vocab, n_pts, seed):
    """The constructed-drift arena at ``cfg``'s capacities on ``device``,
    the BoW rows of its keyframes, and the system fields that
    ``LoopCloser.process`` reads."""
    arena, _, desc, _ = S.build_drifted_loop_arena(
        cfg, np.random.default_rng(seed), n_pts=n_pts, device=device)
    if vocab is None:
        vocab = PL.train_vocabulary(desc, k=8, depth=3, device=device)
    n = S.LOOP_KEYFRAMES
    bow = torch.zeros(cfg.max_keyframes, vocab.n_words, device=device)
    bow[:n] = PL.bow_vectors(vocab, arena.kf_desc[:n], arena.kf_kp_valid[:n])
    gen = torch.Generator(device=device).manual_seed(SEED)
    return types.SimpleNamespace(arena=arena, n_kf=n, bow_table=bow,
                                 generator=gen)


def segment_b_error(arena) -> float:
    """Summed distance of the segment-B keyframes' t to the ground truth."""
    t = arena.kf_t[10:14].cpu().numpy()
    return float(sum(np.linalg.norm(t[j] - S.loop_gt_pose(j)[1])
                     for j in range(4)))


def close_constructed_loop(cfg, system, seg=None):
    """``LoopCloser.process`` on slots 12 then 13 at consistency_th = 1,
    with the segmented sums of the correction and the global BA counted
    into ``seg`` when given. Returns (the closer, the closure's wall ms,
    what each call returned)."""
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg,
                                                   system.arena.device))
    lc.consistency_th = 1
    with (contextlib.nullcontext() if seg is None else
          seg_tally(lc, ("_correct", "_global_ba"), seg)):
        closed = [lc.process(system, 12)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        closed.append(lc.process(system, 13))
        torch.cuda.synchronize()
    return lc, (time.perf_counter() - t0) * 1e3, closed


def loop_phase(cfg):
    """The constructed-drift closure at SlamConfig() capacities: checks the
    rows hold LOOP_MIN_ROW observations, closes the loop, and requires the
    segment-B error to fall to LOOP_ERR_FRAC; closes a fresh copy again,
    warm, for the stage times, host reads, eigen-solve waits and peak
    memory; then closes a third copy under the profiler by stage (its host
    waits may not exceed the stated reads and eigen-solve waits)."""
    vocab = PL.load_vocabulary(str(VOCAB_PATH))
    t0 = time.perf_counter()
    system = loop_system(cfg, "cuda", vocab, LOOP_POINTS, SEED + 7)
    a = system.arena
    rows = (a.kf_obs_lm[:S.LOOP_KEYFRAMES] >= 0).sum(1).tolist()
    log(f"[loop] constructed-drift arena K={a.n_kf_cap} N={a.n_feat} "
        f"L={a.n_lm_cap}: {int(a.lm_valid.sum())} landmarks, observations "
        f"by keyframe {rows}, built in {time.perf_counter() - t0:.1f} s")
    if min(rows[:6] + rows[10:14]) < LOOP_MIN_ROW:
        raise AssertionError("a segment keyframe holds fewer than "
                             f"{LOOP_MIN_ROW} observations")
    inv_s2 = 1.0 / torch.tensor(cfg.level_sigma2, dtype=torch.float32,
                                device="cuda")
    seg_row = check_seg_sum(CubemapCamera.from_config(cfg, "cuda"), a,
                            inv_s2)
    before = segment_b_error(a)
    SG.SEG_SUM.launches = 0
    seg = {}
    lc, cold, closed = close_constructed_loop(cfg, system, seg)
    SEG_LAUNCHES["loop"] = dict(total=SG.SEG_SUM.launches, **seg)
    log(f"[loop] seg_sum: launches in the closure {SEG_LAUNCHES['loop']} "
        f"(by LoopCloser stage)")
    if not (seg.get("_correct") and seg.get("_global_ba")):
        raise AssertionError("the correction or the global BA launched no "
                             "segmented sum")
    after = segment_b_error(system.arena)
    log(f"[loop] process(12), process(13): {closed}; the first closure's "
        f"wall {cold:.3f} ms (cold: first use of its operations)")
    log(f"[loop] segment-B centre error {before:.5f} -> {after:.5f} "
        f"({after / before:.4f} of it; bound {LOOP_ERR_FRAC}); loop edges "
        f"{lc.loop_edges}")
    if closed != [False, True] or not after <= LOOP_ERR_FRAC * before:
        raise AssertionError("the constructed loop was not closed and "
                             "corrected")
    del system, lc
    system = loop_system(cfg, "cuda", vocab, LOOP_POINTS, SEED + 7)
    torch.cuda.reset_peak_memory_stats()
    lc, wall, closed = close_constructed_loop(cfg, system)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    times = {k: [round(x * 1e3, 3) for x in v] for k, v in lc.timings.items()}
    log(f"[loop] warm closure on a fresh copy: {closed}; wall {wall:.3f} ms; "
        f"stage wall ms {times}; host reads {lc.reads}, eigen-solve waits "
        f"{lc.eigh_waits}; peak memory {peak:.1f} MiB")
    if closed != [False, True]:
        raise AssertionError("the warm closure did not close")
    del system, lc
    fresh = loop_system(cfg, "cuda", vocab, LOOP_POINTS, SEED + 7)
    lc2 = LoopCloser(cfg, CubemapCamera.from_config(cfg, "cuda"))
    lc2.consistency_th = 1
    lc2.process(fresh, 12)
    prof = profile_stages(lambda: lc2.process(fresh, 13), LOOP_STAGES, 1)
    log_profile("loop-profile", prof, [wall])
    allowed = lc2.reads + lc2.eigh_waits
    log(f"[loop-profile] host reads {lc2.reads}, eigen-solve waits "
        f"{lc2.eigh_waits}; host waits {prof['host_waits']:.0f}")
    if not lc2.loop_edges:
        raise AssertionError("the profiled closure did not close")
    if prof["host_waits"] > allowed:
        raise AssertionError(f"the closure waited {prof['host_waits']:.0f} "
                             f"times; its stated reads and eigen-solve waits "
                             f"are {allowed}")
    return seg_row


def arena_gap(c, g):
    """(pose difference, 99% and largest landmark difference over the
    landmarks live in both, share of the live observation table equal) of
    two arenas on the CPU."""
    v = c.kf_valid
    dpose = max(float((c.kf_R - g.kf_R)[v].abs().max()),
                float((c.kf_t - g.kf_t)[v].abs().max()))
    live = c.lm_valid & g.lm_valid
    d = (c.lm_pos - g.lm_pos).abs().amax(dim=1)[live]
    obs_c, obs_g = c.kf_obs_lm[v], g.kf_obs_lm[v]
    either = (obs_c >= 0) | (obs_g >= 0)
    return (dpose, float(torch.quantile(d, 0.99)), float(d.max()),
            float((obs_c == obs_g)[either].float().mean()))


def small_loop_closure(cfg, dev, refined=None):
    """The small constructed-drift closure (``process`` on slots 12 and 13
    at consistency_th = 1) on ``dev`` with the global BA held back. Records
    the RANSAC Sim3 (as the widening receives it) with its inlier count,
    the widened match count, and the refinement's output; with
    ``refined`` (another run's refinement, on the CPU) the closer goes on
    from that Sim3 in place of its own. Returns (what each call returned,
    the corrected arena on the CPU, the records on the CPU, the closer)."""
    system = loop_system(cfg, dev, None, 500, SEED + 8)
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, dev))
    lc.consistency_th = 1
    lc._global_ba = lambda system: None
    k, rec = lc.k, {}
    widen, refine = k.search_by_sim3, k.refine_sim3

    def widen_rec(arena, k1, k2, s12, R12, t12, idx2, ok):
        rec["ransac"] = [x.cpu() for x in (s12, R12, t12)]
        rec["ransac_inliers"] = int(ok.sum())
        out = widen(arena, k1, k2, s12, R12, t12, idx2, ok)
        rec["widened"] = int(out[1].sum())
        return out

    def refine_rec(*args):
        out = refine(*args)
        rec["refined"] = [x.cpu() for x in out]
        if refined is None:
            return out
        return tuple(x.to(dev) for x in refined)

    k.search_by_sim3, k.refine_sim3 = widen_rec, refine_rec
    closed = [lc.process(system, slot) for slot in (12, 13)]
    return closed, system.arena.to("cpu"), rec, lc


def small_loop_reference_check(card="cuda"):
    """The constructed-drift closure at the tier-1 test's size (K=64, N=600,
    L=8192, 500 points) on the card against the CPU, in three parts.

    ComputeSim3: the RANSAC Sim3 within LOOP_REF_SIM3 with the same inlier
    count (each device draws its own sets; on this exact scene every
    all-inlier set gives the drift up to rounding), the widened and refined
    match counts equal, and the refined rotation and translation within
    LOOP_REF_SIM3. The refined scale is not held: segment B revisits
    segment A's viewpoints exactly, so the loop keyframes' relative
    translation is 0 and no reprojection constrains the scale (only the
    1e-6 damping does); each device's rounding moves it its own way.

    The correction, from the CPU's refined Sim3 on both devices: both
    close, keyframe poses within LOOP_REF_CORRECT[0], the landmarks live in
    both within [1] for 99% and [2] for all, the live observation table
    equal on [3] of its entries. Then the global BA from the CPU's
    corrected arena on each device, within LOOP_REF_GBA: the card's
    scatter-adds sum in their own order, and LM and CG carry the
    difference along."""
    cfg = SlamConfig(**LOOP_SMALL)
    c_closed, c, c_rec, _ = small_loop_closure(cfg, "cpu")
    _, _, g_rec, _ = small_loop_closure(cfg, card)
    d_ransac = max(float((a - b).abs().max())
                   for a, b in zip(c_rec["ransac"], g_rec["ransac"]))
    d_rt = max(float((a - b).abs().max())
               for a, b in zip(c_rec["refined"][1:3], g_rec["refined"][1:3]))
    counts = {key: (c_rec[key], g_rec[key])
              for key in ("ransac_inliers", "widened")}
    counts["refined_inliers"] = (int(c_rec["refined"][4]),
                                 int(g_rec["refined"][4]))
    log(f"[ref-loop] ComputeSim3, card vs CPU: RANSAC Sim3 within "
        f"{d_ransac:.3g}; refined R, t within {d_rt:.3g} (bound "
        f"{LOOP_REF_SIM3}); refined scale CPU "
        f"{float(c_rec['refined'][0]):.6f}, card "
        f"{float(g_rec['refined'][0]):.6f} (RANSAC "
        f"{float(c_rec['ransac'][0]):.6f}); counts (CPU, card) {counts}")
    sim3_ok = (d_ransac < LOOP_REF_SIM3 and d_rt < LOOP_REF_SIM3
               and all(a == b for a, b in counts.values()))

    g_closed, g, _, _ = small_loop_closure(cfg, card,
                                           refined=c_rec["refined"])
    gap = arena_gap(c, g)
    log(f"[ref-loop] correction from the CPU's refined Sim3, card "
        f"{g_closed} vs CPU {c_closed}: |dpose| {gap[0]:.3g}; landmarks 99% "
        f"within {gap[1]:.3g}, max {gap[2]:.3g}; observation table equal on "
        f"{gap[3]:.5f} (bounds {LOOP_REF_CORRECT})")
    after = {}
    for dev in ("cpu", card):
        system = types.SimpleNamespace(arena=c.to(dev))
        LoopCloser(cfg, CubemapCamera.from_config(cfg, dev))._global_ba(
            system)
        after[dev] = system.arena.to("cpu")
    gap_b = arena_gap(after["cpu"], after[card])
    log(f"[ref-loop] global BA from the CPU's corrected arena, card vs CPU: "
        f"|dpose| {gap_b[0]:.3g}; landmarks 99% within {gap_b[1]:.3g}, max "
        f"{gap_b[2]:.3g}; observation table equal on {gap_b[3]:.5f} (bounds "
        f"{LOOP_REF_GBA})")

    def within(gap, bounds):
        return (gap[0] < bounds[0] and gap[1] < bounds[1]
                and gap[2] < bounds[2] and gap[3] >= bounds[3])

    if not (sim3_ok and c_closed == g_closed == [False, True]
            and within(gap, LOOP_REF_CORRECT) and within(gap_b, LOOP_REF_GBA)):
        raise AssertionError("card and CPU loop closures disagree")


# ---------------------------------------------------------------------------
# The dataset runner and the sharded global BA
# ---------------------------------------------------------------------------

def write_pgm(path, img) -> None:
    with open(path, "wb") as f:
        f.write(f"P5 {img.shape[1]} {img.shape[0]} 255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def centre_ate(idx, est, poses):
    """RMS distance of camera centres ``est`` of frames ``idx`` to the
    ground truth after a Sim3 alignment, and the path length between the
    first and last."""
    gt = S.camera_centres(poses)[idx]
    s, Ra, ta = horn_alignment(torch.as_tensor(gt, dtype=torch.float32),
                               torch.as_tensor(est, dtype=torch.float32))
    al = float(s) * (Ra.numpy() @ est.T).T + ta.numpy()
    return (float(np.sqrt(np.mean(np.sum((al - gt) ** 2, axis=1)))),
            float(np.linalg.norm(gt[-1] - gt[0])))


def app_phase(poses, frames, counters, settings="none", device=None):
    """``run_sequence.main`` over ``frames`` written as PGM with a Lafida
    list, with the launch counters set to 0 just before and read just
    after (each kernel entry once a frame). Checks the loader, that every
    frame from the first tracked one on was tracked (the system's
    ``track_fisheye`` results are recorded), and that the perf file's ratio
    says so, no loop, and the ATE of the tracked frames (the keyframes' ATE
    from the TUM file is printed). Returns the launches."""
    shutil.rmtree(APP_DIR, ignore_errors=True)
    APP_DIR.mkdir(parents=True)
    fps = (SlamConfig() if settings == "none" else
           load_config(settings)).fps
    lines = []
    for i, img in enumerate(frames):
        write_pgm(APP_DIR / f"frame_{i:04d}.pgm", img)
        lines.append(f"{i} {i / fps:.6f} frame_{i:04d}.pgm")
    (APP_DIR / "list.txt").write_text("\n".join(lines) + "\n")
    traj, perf = APP_DIR / "kf.tum", APP_DIR / "perf.txt"
    argv = [str(VOCAB_PATH), settings, str(APP_DIR), str(APP_DIR / "list.txt"),
            "none", str(traj), str(perf)]
    log(f"[app] python -m cubemapslam_tpu_torch.apps.run_sequence "
        f"{' '.join(argv)}")
    out = io.StringIO()
    # the pose the runner's system returned for each frame (None: lost)
    returned = []
    track = CubemapSLAM.track_fisheye

    def recorded(self, *args, **kwargs):
        T = track(self, *args, **kwargs)
        returned.append(T)
        return T

    zero_launches(counters)
    t0 = time.perf_counter()
    CubemapSLAM.track_fisheye = recorded
    try:
        with contextlib.redirect_stdout(out):
            rc = run_sequence.main(argv, device=device)
    finally:
        CubemapSLAM.track_fisheye = track
    wall = time.perf_counter() - t0
    launches = read_launches(counters, "app", len(frames))
    if not SEG_LAUNCHES["app"]["total"]:
        raise AssertionError("the runner's mapping launched no segmented "
                             "sum")
    for line in out.getvalue().splitlines():
        log(f"[app] | {line}")
    if rc != 0:
        raise AssertionError(f"run_sequence.main returned {rc}")
    loader = [ln for ln in out.getvalue().splitlines()
              if ln.startswith("image loader:")]
    kv = dict(ln.split() for ln in perf.read_text().splitlines())
    rows = [np.array(ln.split(), np.float64)
            for ln in traj.read_text().splitlines()]
    if list(kv) != ["median_tracking_time_s", "mean_tracking_time_s",
                    "tracked_frames_ratio", "loops_closed"] \
            or any(len(r) != 8 for r in rows) or len(rows) < 2:
        raise AssertionError("malformed perf or TUM file")
    kf_idx = [int(round(r[0] * fps)) for r in rows]
    kf_ate, kf_path = centre_ate(kf_idx, np.stack([r[1:4] for r in rows]),
                                 poses)
    tracked = [T is not None for T in returned]
    n = len(frames)
    first_ok = tracked.index(True) if True in tracked else n
    idx = [i for i, ok in enumerate(tracked) if ok]
    ate, path = centre_ate(idx, np.stack([
        -returned[i][:3, :3].T @ returned[i][:3, 3] for i in idx]), poses)
    ratio = float(kv["tracked_frames_ratio"])
    log(f"[app] {loader[0] if loader else 'no loader line'}; initialized at "
        f"frame {first_ok}; tracked ratio {ratio:.6f} (every frame from it "
        f"on: {(n - first_ok) / n:.6f}); loops {kv['loops_closed']}; median "
        f"frame {float(kv['median_tracking_time_s']) * 1e3:.3f} ms, mean "
        f"{float(kv['mean_tracking_time_s']) * 1e3:.3f} ms; ATE of the "
        f"tracked frames {ate:.5f} over {path:.5f} ({ate / path:.5f} of it; "
        f"bound {SLAM_ATE_FRAC}); {len(rows)} live keyframes in the TUM file "
        f"(frames {kf_idx}), their ATE {kf_ate / kf_path:.5f} of their path; "
        f"main's wall {wall:.1f} s")
    variant = next((c for c in native.CODECS
                    if native.load_library(c) is not None), None)
    log(f"[app] native loader variant: "
        f"{'PGM only' if variant == () else variant} (the first of "
        f"{native.CODECS} that builds and loads here)")
    if loader != ["image loader: NativeImageLoader"]:
        raise AssertionError(f"the native loader was not taken: {loader}")
    if first_ok >= SLAM_INIT_BY or not all(tracked[first_ok:]) \
            or len(tracked) != n or abs(ratio - (n - first_ok) / n) > 1e-6:
        raise AssertionError("not initialized in time, or a frame after "
                             "initialization was not tracked")
    if int(kv["loops_closed"]) != 0:
        raise AssertionError("the runner closed a loop on a trajectory that "
                             "revisits nothing")
    if not ate < SLAM_ATE_FRAC * path:
        raise AssertionError("the runner's trajectory is beyond the ATE "
                             "bound")
    return launches


def sharded_gap(res, ref, ref_inl, live_valid):
    """(pose difference, 99% and largest point difference, share of the
    live edges with the same inlier verdict) of a sharded solve's host
    result against the single-process one."""
    dpose = max(float((res["R"] - ref.R.cpu()).abs().max()),
                float((res["t"] - ref.t.cpu()).abs().max()))
    d = (res["X"] - ref.X.cpu()).abs().amax(dim=1)
    live = live_valid.cpu()
    same = (res["inl"] == ref_inl.cpu())[live].float().mean()
    return dpose, float(torch.quantile(d, 0.99)), float(d.max()), float(same)


def check_sharded(tag, res, ref, ref_inl, valid, ref_ms):
    gap = sharded_gap(res, ref, ref_inl, valid)
    log(f"[dist] {tag}: wall {res['wall_s'] * 1e3:.3f} ms against "
        f"{ref_ms:.3f} ms single-process; pose gap {gap[0]:.3e}, point gap "
        f"99% {gap[1]:.3e} / max {gap[2]:.3e}, inlier verdicts equal on "
        f"{gap[3]:.6f} of the live edges (bounds {DIST_REF})")
    if not (gap[0] < DIST_REF[0] and gap[1] < DIST_REF[1]
            and gap[2] < DIST_REF[2] and gap[3] >= DIST_REF[3]):
        raise AssertionError(f"the {tag} sharded solve disagrees with the "
                             "single-process one")


def single_solve(cam, sharded, dev):
    """The single-process solve of a sharded layout and its wall ms."""
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    ref, inl = bundle_adjust(cam, sharded.prob, phase_iters=DIST_PHASES,
                             solver="cg", cg_iters=DIST_CG_ITERS)
    sync()
    return ref, inl, (time.perf_counter() - t0) * 1e3


def dist_phase(cfg, dev="cuda", n_pts=LOOP_POINTS):
    """The sharded global BA of the loop phase's arena at world size 1 over
    NCCL in this process (gloo off the card) and 2 over gloo in two spawned
    ranks, each against the single-process solve of its layout."""
    vocab = PL.load_vocabulary(str(VOCAB_PATH), dev)
    arena = loop_system(cfg, dev, vocab, n_pts, SEED + 7).arena
    cam = CubemapCamera.from_config(cfg, dev)
    inv_s2 = 1.0 / torch.tensor(cfg.level_sigma2, dtype=torch.float32,
                                device=dev)
    prob = D.global_ba_problem_from_arena(cam, arena, inv_s2)
    keep = prob.obs_valid.nonzero()[:, 0]
    live = prob._replace(**{f: getattr(prob, f)[keep] for f in D.EDGE_FIELDS})
    M, P = prob.R.shape[0], prob.X.shape[0]
    log(f"[dist] the loop arena's global BA: {M} camera slots "
        f"({int(prob.cam_valid.sum())} live), {P} point slots "
        f"({int(prob.pt_valid.sum())} live), {keep.numel()} live edges of "
        f"{prob.obs_valid.numel()}; LM steps by phase {DIST_PHASES}, "
        f"{DIST_CG_ITERS} CG iterations each")

    # world size 1 over NCCL, in this process
    sharded = D.shard_ba_problem(live, 1, shard_points=True)
    ref, ref_inl, ref_ms = single_solve(cam, sharded, dev)
    backend = "nccl" if dev == "cuda" else "gloo"
    SG.SEG_SUM.launches = 0
    store_dir = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(f"{store_dir}/store", 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=DIST_TIMEOUT),
            device_id=torch.device(dev, 0) if dev == "cuda" else None)
        try:
            res = D.rank_bundle_adjust(D.make_mesh(), cam, sharded, dev,
                                       DIST_PHASES, DIST_CG_ITERS)
            launches = SG.SEG_SUM.launches
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    SEG_LAUNCHES["dist"] = {"total": launches}
    log(f"[dist] world size 1 over {backend}: boundary rows reduced each CG "
        f"iteration {sharded.n_boundary} (and the {M}x6 camera table); "
        f"seg_sum launches of the rank's solve {launches}")
    if not launches:
        raise AssertionError("the sharded BA launched no segmented sum")
    check_sharded(f"world size 1 ({backend})", res, ref, ref_inl,
                  sharded.prob.obs_valid, ref_ms)

    # world size 2 over gloo, two spawned ranks on the same device
    sharded = D.shard_ba_problem(live, 2, shard_points=True)
    ref, ref_inl, ref_ms = single_solve(cam, sharded, dev)
    host = sharded._replace(
        prob=BAProblem(*(t.cpu() for t in sharded.prob)),
        owner_shard=sharded.owner_shard.cpu())
    t0 = time.perf_counter()
    ranks = D.run_ranks(D.rank_bundle_adjust, 2,
                        args=(CubemapCamera.from_config(cfg, "cpu"), host, dev,
                              DIST_PHASES, DIST_CG_ITERS),
                        timeout=DIST_TIMEOUT,
                        workdir=str(ROOT / "build"))
    spawn_s = time.perf_counter() - t0
    log(f"[dist] world size 2 over gloo: {sharded.n_boundary} boundary rows "
        f"of {P} reduced each CG iteration (and the {M}x6 camera table); "
        f"edge blocks of {sharded.prob.obs_cam.numel() // 2}; ranks' walls "
        f"{[round(r['wall_s'] * 1e3, 3) for r in ranks]} ms; spawn to join "
        f"{spawn_s:.1f} s")
    for k in ("R", "t", "X", "inl"):
        if not torch.equal(ranks[0][k], ranks[1][k]):
            raise AssertionError(f"the two ranks' {k} differ")
    res = dict(ranks[0], wall_s=max(r["wall_s"] for r in ranks))
    check_sharded("world size 2 (gloo)", res, ref, ref_inl,
                  sharded.prob.obs_valid, ref_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_run = time.perf_counter()

    def done(phase):
        log(f"[time] {phase} done, {time.perf_counter() - t_run:.1f} s into "
            f"the run")

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    t_b = time.perf_counter()
    logs = _build.build_all(SOURCES)
    log(f"[build] {len(logs)} kernel sources built in "
        f"{time.perf_counter() - t_b:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    cfg = SlamConfig()
    t_s = time.perf_counter()
    tracker = FrameTracker(cfg)            # the card, by default
    torch.cuda.synchronize()
    log(f"[setup] FrameTracker at {cfg.cube_w}x{cfg.cube_h}, "
        f"{cfg.n_features} features, {cfg.n_levels} levels built in "
        f"{time.perf_counter() - t_s:.1f} s")
    frame = torch.as_tensor(synthetic_fisheye(cfg, SEED), device="cuda")

    rows = check_kernels(tracker, frame)
    done("kernel checks")
    # kernel D is two launches, each counted by its own wrapper
    counters = {"warp_remap": (warp_cuda.WARP_REMAP,),
                "orb_detect": (TE.ORB_FAST, TE.ORB_SELECT),
                "orb_describe": (TE.ORB_DESCRIBE,)}

    rng = np.random.default_rng(SEED)
    kp0 = tracker.extract(tracker.warp(frame))
    lms = landmarks_from_keypoints(kp0, N_LANDMARKS, rng, cfg.n_levels)
    log(f"[path] {int(kp0.valid.sum())} valid keypoints on frame 0; "
        f"{N_LANDMARKS} landmarks")
    for group in counters.values():
        for c in group:
            c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, cpus, results = drive_main_path(tracker, frame, lms, rng)
    launches = {name: {c.symbol: c.launches for c in group}
                for name, group in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check_results(results, cfg)
    log(f"[path] frame step wall ms (synchronised): "
        f"{', '.join(f'{w:.3f}' for w in walls)}; median of the last "
        f"{N_FRAMES - 1} {float(np.median(walls[1:])):.3f}; host thread CPU "
        f"ms: {', '.join(f'{c:.3f}' for c in cpus)}; peak memory "
        f"{peak:.1f} MiB")
    for name, by_kernel in launches.items():
        log(f"[path] {name}: launches in {N_FRAMES} frames {by_kernel}")
        for sym, n in by_kernel.items():
            if n != LAUNCHES_PER_FRAME * N_FRAMES:
                raise AssertionError(f"{name} ({sym}) was launched {n} times "
                                     f"in {N_FRAMES} frames on the main path")
    prof = profiled_frames(tracker, frame, lms, rng)
    log_profile("profile", prof, walls[1:])

    small_reference_check()
    done("frame step")

    mt, poses, frames, first = build_map_phase(cfg)
    seed = mt.last
    t_walls, t_launches = drive_tracking_path(mt, poses, frames, first,
                                              counters)
    start = first + 1 + TRACK_FRAMES
    t_prof = profiled_tracking(mt, poses, frames, start)
    log_profile("track-profile", t_prof, t_walls)
    reads = [r["host_reads"] for r in mt.metrics[-TRACK_PROFILE_FRAMES:]]
    log(f"[track] host reads a frame, counted by the tracker: "
        f"{sorted(set(reads))}; host waits a frame, from the profiler: "
        f"{t_prof['host_waits']:.2f}")
    # every read is a wait, so the profiler must see at least as many
    if t_prof["host_waits"] < max(reads):
        raise AssertionError("the profiler saw fewer host waits than the "
                             "tracker's own reads")
    forced_branches(mt, poses, frames, first, seed)
    small_map_reference_check()
    done("map tracking")
    del mt, seed
    slam, s_poses, s_frames, s_launches, ate = slam_phase(cfg, counters)
    done("slam")
    r_launches = reloc_phase(slam, s_poses, s_frames, ate, counters)
    done("reloc")
    l_launches = localization_phase(slam, s_poses, s_frames, ate, counters)
    done("localization")
    save_load_check(slam, s_poses, s_frames, ate)
    del slam
    small_reloc_reference_check()
    done("save/load and the reloc reference check")
    seg_row = loop_phase(cfg)
    done("loop")
    small_loop_reference_check()
    done("the loop reference check")
    a_launches = app_phase(s_poses, s_frames, counters)
    done("app")
    del s_frames
    dist_phase(cfg)
    done("dist")

    for r in rows:
        r["launches"] = sum(launches[r["name"]].values())
        r["launches_by_kernel"] = launches[r["name"]]
        r["launches_tracking"] = sum(t_launches[r["name"]].values())
        r["launches_tracking_by_kernel"] = t_launches[r["name"]]
        r["launches_slam"] = sum(s_launches[r["name"]].values())
        r["launches_slam_by_kernel"] = s_launches[r["name"]]
        r["launches_reloc"] = sum(r_launches[r["name"]].values())
        r["launches_localization"] = sum(l_launches[r["name"]].values())
        r["launches_app"] = sum(a_launches[r["name"]].values())
    # the segmented sum runs a data-dependent number of times: on the slam
    # path (mapping and local BA), the loop closure, the runner and the
    # sharded BA, each counted from 0 around its drive
    seg_row["launches"] = SEG_LAUNCHES["slam"]["total"]
    seg_row["launches_by_path"] = SEG_LAUNCHES
    rows.append(seg_row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
