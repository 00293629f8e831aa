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
recovered pose. It then runs the same step under ``torch.profiler`` with one
range per stage, for the device's busy time and idle share, and holds the
card's frame step against the same step on the CPU at a small size.

Output: progress lines, then one ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and the last line is missing. Without a CUDA card, or
without the package beside it, it exits non-zero before printing a result.
This script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from cubemapslam_tpu_torch import SlamConfig, _build
from cubemapslam_tpu_torch import warp as TW
from cubemapslam_tpu_torch import warp_cuda
from cubemapslam_tpu_torch.features import extractor as TE
from cubemapslam_tpu_torch.geometry import so3_log
from cubemapslam_tpu_torch.runtime import FrameTracker
from cubemapslam_tpu_torch.runtime.synthetic import (
    landmarks_from_keypoints, perturbed_pose, synthetic_fisheye)

SEED = 0
N_LANDMARKS = 8192
N_FRAMES = 6                  # the first is a warm-up frame
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12    # float32 outside the tensor cores
TIMING_REPS, TIMING_BATCH = 7, 20
SOURCES = ("warp_remap.cu", "orb_detect.cu", "patch_gather.cu")

# float operations per valid pixel of kernel W, counted from its source: 2
# floors, 4 subtractions, 8 products and 3 sums (the u8 loads and their
# conversions are not counted)
WARP_OPS_PER_PIXEL = 2 + 4 + 8 + 3
# operations per pixel of kernel D, counted from its source: 16
# differences, 16 negations, 2 x (4 x 16 min + 15 max) for the two FAST
# runs, 1 max, 2 for the fallback merge, 10 for NMS, 4 border compares and
# 4 key compares of the per-cell top-4
DETECT_OPS_PER_PIXEL = 16 + 16 + 2 * (4 * 16 + 15) + 1 + 2 + 10 + 4 + 4


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


def check_detect_and_gather(tracker, cube):
    """Kernels D and G against their plain versions on the 8 levels of the
    frame's pyramid; times and bounds are summed over the levels."""
    p, cfg = tracker.params, tracker.cfg
    ini, mn = cfg.ini_th_fast, cfg.min_th_fast
    levels = [cube] + [TE.pyramid_level(cube, A, Bt)
                       for A, Bt in tracker.extractor.pyr_ops]
    d = dict(err=0.0, ms=0.0, dev=0.0, plain=0.0, bytes=0.0, ops=0.0)
    g = dict(ms=0.0, dev=0.0, plain=0.0, bytes=0.0, k=0)
    for lv, img in enumerate(levels):
        img = img.contiguous()
        Hl, Wl = img.shape
        kern = TE.detect_cells(img, p.cell, ini, mn)
        plain = TE._detect_cells_plain(img, p.cell, ini, mn)
        for name, a, b in zip(("resp", "y", "x"), kern[:3], plain[:3]):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel D level {lv}: {name} differs "
                                     f"at {int((a != b).sum())} entries")
        err = max(float((kern[3] - plain[3]).abs().max()),
                  float((kern[4] - plain[4]).abs().max()))
        if not err <= 1e-6:
            raise AssertionError(f"kernel D level {lv}: subpixel err {err}")
        t_k = time_ms(lambda: TE.detect_cells(img, p.cell, ini, mn))
        t_kd = graph_ms(lambda: TE.detect_cells(img, p.cell, ini, mn))
        t_p = time_ms(lambda: TE._detect_cells_plain(img, p.cell, ini, mn))
        n_cells = kern[0].shape[0]
        d["err"] = max(d["err"], err)
        d["ms"] += t_k
        d["dev"] += t_kd
        d["plain"] += t_p
        d["bytes"] += 4 * Hl * Wl + n_cells * 4 * 20
        d["ops"] += DETECT_OPS_PER_PIXEL * Hl * Wl

        ys, xs, _, _, _ = TE._detect_level(img, p.level_k[lv], p.cell, ini,
                                           mn)
        gk = TE.gather_patches(img, ys, xs)
        gp = TE._gather_patches_plain(img, ys, xs)
        if not torch.equal(gk, gp):
            raise AssertionError(f"kernel G level {lv} differs at "
                                 f"{int((gk != gp).sum())} entries")
        t_g = time_ms(lambda: TE.gather_patches(img, ys, xs))
        t_gd = graph_ms(lambda: TE.gather_patches(img, ys, xs))
        t_gp = time_ms(lambda: TE._gather_patches_plain(img, ys, xs))
        K = ys.shape[0]
        g["ms"] += t_g
        g["dev"] += t_gd
        g["plain"] += t_gp
        g["bytes"] += K * 48 * 48 * 4 + min(K * 48 * 48, Hl * Wl) * 4 + 16 * K
        g["k"] += K
        log(f"[D] level {lv} {Hl}x{Wl}: {n_cells} cells, candidates bitwise "
            f"equal, subpixel err {err:.3g}; kernel {t_k:.4f} ms "
            f"(device {t_kd:.4f} ms), plain {t_p:.4f} ms")
        log(f"[G] level {lv}: {K} patches bitwise equal; kernel "
            f"{t_g:.4f} ms (device {t_gd:.4f} ms), plain {t_gp:.4f} ms")
    if g["k"] != p.n_features:
        raise AssertionError(f"gathered {g['k']} patches, want "
                             f"{p.n_features}")
    d_ms, d_by = bound(d["bytes"], d["ops"])
    g_ms, g_by = bound(g["bytes"], 0.0)
    return [
        dict(name="orb_detect", route="cuda",
             source="cubemapslam_tpu_torch/csrc/orb_detect.cu",
             replaces="cubemapslam_tpu/features/extractor.py:369",
             max_abs_err=d["err"], ms=d["ms"], device_ms=d["dev"],
             plain_ms=d["plain"], bound_ms=d_ms, bound_by=d_by,
             library_ms=None, calls_per_frame=2 * len(levels)),
        dict(name="patch_gather", route="cuda",
             source="cubemapslam_tpu_torch/csrc/patch_gather.cu",
             replaces="cubemapslam_tpu/features/extractor.py:257",
             max_abs_err=0.0, ms=g["ms"], device_ms=g["dev"],
             plain_ms=g["plain"],
             bound_ms=g_ms, bound_by=g_by, library_ms=None,
             calls_per_frame=len(levels))]


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


def profiled_frames(tracker, frame_u8, lms, rng):
    """N_FRAMES frame steps under torch.profiler, one range per stage, each
    frame synchronised at its end. Returns the per-frame medians of the
    wall time (profiler on), the device's busy time (summed kernel and copy
    time) and the device operations, and per stage the host time, device
    busy time, device operations and host waits (a synchronisation, or a
    copy that returns a value to the host), all per frame."""
    R0, t0 = perturbed_pose(rng, tracker.device)
    stages = ("warp", "extract", "match", "optimize")

    def step():
        with record_function("warp"):
            cube = tracker.warp(frame_u8)
        with record_function("extract"):
            kp = tracker.extract(cube)
        with record_function("match"):
            assoc = tracker.match(kp, *lms, R0, t0)
        with record_function("optimize"):
            tracker.optimize(kp, assoc, lms[0], R0, t0)

    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(N_FRAMES):
            torch.cuda.synchronize()
            a = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - a) * 1e3)
    n = N_FRAMES
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if e.name not in stages]
    if not kernels:
        raise AssertionError("the profiler recorded no device operation")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    waits = [e for e in events if e.device_type == DeviceType.CPU
             and ("Synchronize" in e.name or e.name.startswith("cudaMemcpy"))]
    per_stage = {}
    for st in stages:
        host = [(e.time_range.start, e.time_range.end) for e in events
                if e.name == st and e.device_type == DeviceType.CPU]
        spans = [(e.time_range.start, e.time_range.end) for e in dev
                 if e.name == st]
        inside = [k for k in kernels
                  if any(a <= k.time_range.start < b for a, b in spans)]
        per_stage[st] = dict(
            host_ms=sum(b - a for a, b in host) / 1e3 / n,
            device_busy_ms=sum(k.time_range.elapsed_us()
                               for k in inside) / 1e3 / n,
            device_ops=len(inside) / n,
            host_waits=sum(any(a <= w.time_range.start < b for a, b in host)
                           for w in waits) / n)
    wall = float(np.median(walls))
    return dict(wall_ms=wall, walls_ms=walls, device_busy_ms=busy,
                idle_share=1.0 - busy / float(np.mean(walls)),
                device_ops=len(kernels) / n, stages=per_stage)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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

    w_row, cube = check_warp(tracker, frame)
    rows = [w_row] + check_detect_and_gather(tracker, cube)
    # kernel D is two launches, each counted by its own wrapper
    counters = {"warp_remap": (warp_cuda.WARP_REMAP,),
                "orb_detect": (TE.ORB_FAST, TE.ORB_SELECT),
                "patch_gather": (TE.PATCH_GATHER,)}

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
            if n == 0:
                raise AssertionError(f"{name} ({sym}) was not launched on "
                                     f"the main path")
    prof = profiled_frames(tracker, frame, lms, rng)
    # the profiler slows the host, so the idle share is also given against
    # the wall time of the unprofiled frames above (after the warm-up)
    idle_off = 1.0 - prof["device_busy_ms"] / float(np.mean(walls[1:]))
    log(f"[profile] {N_FRAMES} frames under torch.profiler: wall ms "
        f"{', '.join(f'{w:.3f}' for w in prof['walls_ms'])} (median "
        f"{prof['wall_ms']:.3f}); device busy {prof['device_busy_ms']:.3f} "
        f"ms per frame; idle share {prof['idle_share']:.4f} of the profiled "
        f"wall, {idle_off:.4f} of the unprofiled wall; "
        f"{prof['device_ops']:.0f} device operations per frame")
    for st, v in prof["stages"].items():
        log(f"[profile] stage {st:9s}: host {v['host_ms']:.3f} ms, device "
            f"busy {v['device_busy_ms']:.3f} ms, {v['device_ops']:.0f} "
            f"device operations, {v['host_waits']:.0f} host waits per frame")

    small_reference_check()

    for r in rows:
        r["launches"] = sum(launches[r["name"]].values())
        r["launches_by_kernel"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
