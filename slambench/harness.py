"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a traffic kind, a cell or a
per-layer metric is a file found by its name:

* ``configs/<config>.json``: the ``SlamConfig`` fields, the mode, the
  source and what was assumed or cut;
* ``workloads/<cell>.json``: the configuration, the traffic kind and its
  parameters, the frames traced, the limit of every compared number, and
  optionally the seed of the program's own draws;
* ``traffic/<kind>.py``: ``make(params, seed, seconds, camera, device)``
  returns the cell's ``Traffic`` (``traffic/common.py``);
* ``metrics/<name>.py``: ``read(trace)`` returns the metric from a traced
  window (``measure/window.py``), or None where there is nothing to read.

The window drives ``CubemapSLAM.track_fisheye`` frame after frame in a
closed loop, each frame uploaded one frame ahead through
``prefetch_image``; a frame's latency is the host clock around its call,
which returns once the program has read the pose.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from slambench.reference import judge as J

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# the program's import names that a run may not load; the port's own name
# starts with the JAX package's, so names are compared whole, before the
# first dot
FORBIDDEN = ("jax", "jaxlib", "flax", "cubemapslam_tpu")
# arena tables that localization mode must leave as they are
FROZEN = ("kf_R", "kf_t", "kf_valid", "kf_obs_lm", "kf_uv", "kf_desc",
          "lm_pos", "lm_valid", "lm_desc")
# arena tables the check reads
CHECKED = ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_rays", "kf_level",
           "kf_kp_valid", "kf_obs_lm", "lm_pos", "lm_valid")
SAMPLED_FRAMES = 2          # window frames whose keypoints are kept
SAMPLE_FROM = (10, 60)      # ... drawn from these window ordinals


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A workload with its configuration, resolved."""

    def __init__(self, name: str, overrides: Optional[dict] = None):
        self.name = name
        self.workload = load("workloads", name)
        self.config = load("configs", self.workload["config"])
        fields = dict(self.config["slam_config"])
        params = dict(self.workload["params"])
        for key, val in (overrides or {}).items():
            (fields if key in fields or key.startswith("cfg.") else params)[
                key.removeprefix("cfg.")] = val
        if fields.get("vocab_path"):
            fields["vocab_path"] = str(ROOT / fields["vocab_path"])
        self.fields = fields
        self.params = params

    @property
    def localize(self) -> bool:
        return self.config["mode"] == "localization"


def _kp_copy(kp) -> dict:
    """Every keypoint row of a frame (all pyramid levels), copied where
    they are."""
    return {k: getattr(kp, k).clone()
            for k in ("uv", "valid", "desc", "angle", "response")}


class Feeder:
    """Feeds traffic frames to the system, each uploaded one frame ahead,
    and keeps which traffic frame each program frame id was."""

    def __init__(self, slam, traffic):
        self.slam, self.traffic = slam, traffic
        self.frame_of: List[int] = []
        self.pending = None

    def prefetch(self, frame: int) -> None:
        self.pending = (frame, self.slam.prefetch_image(
            self.traffic.frames[frame]))

    def step(self, next_frame: Optional[int]):
        """Track the prefetched frame, after starting the next one's
        upload. Returns (frame, pose or None, latency s)."""
        frame, img = self.pending
        if next_frame is not None:
            self.prefetch(next_frame)
        fid = len(self.frame_of)
        self.frame_of.append(frame)
        t0 = time.perf_counter()
        pose = self.slam.track_fisheye(img, fid / self.slam.cfg.fps)
        return frame, pose, time.perf_counter() - t0

    def run(self, frames: List[int]) -> None:
        if not frames:
            return
        self.prefetch(frames[0])
        for i in range(len(frames)):
            self.step(frames[i + 1] if i + 1 < len(frames) else None)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        overrides: Optional[dict] = None, fault: Optional[str] = None,
        keep_outputs: bool = False) -> dict:
    """One run; returns the result line's fields, with ``_outputs`` (the
    program's outputs and the traffic) when ``keep_outputs``. ``fault``
    names a fault planted under the timed path (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cell_name, overrides)
    from cubemapslam_tpu_torch.config import SlamConfig
    from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
    from slambench.reference.camera import Camera

    fields = cell.fields
    cfg = SlamConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in fields.items()})
    traffic = importlib.import_module(
        f"slambench.traffic.{cell.workload['traffic']}").make(
        cell.params, seed, seconds, Camera.from_fields(fields), device)
    # the program's own draws (RANSAC) from the cell's fixed seed where it
    # gives one: then every seed builds the same map and does the same work
    slam = CubemapSLAM(cfg, device=device,
                       seed=cell.workload.get("program_seed", seed))
    if fault is not None:
        _plant(slam, fault)
    feeder = Feeder(slam, traffic)
    feeder.run(traffic.slam)
    before = None
    if cell.localize:
        slam.activate_localization_mode()
        before = {k: getattr(slam.arena, k).to("cpu", copy=True)
                  for k in FROZEN}
    feeder.run(traffic.warmup)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # the window: one host thread, and set-up's objects out of the
    # collector's way, so that other work of this process does not move it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    rng = np.random.default_rng([seed, 1])
    sample = set(int(x) for x in rng.choice(np.arange(*SAMPLE_FROM),
                                            SAMPLED_FRAMES, replace=False))
    kps, poses, lat, rows = [], [], [], []
    max_frames = cell.workload["trace_frames"] if trace else None
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device != "cpu" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    n_rows = len(slam.metrics)
    t0 = time.perf_counter()
    i = 0
    feeder.prefetch(traffic.window_frame(0))
    try:
        while True:
            if trace:
                with record_function("frame"):
                    frame, pose, dt = feeder.step(traffic.window_frame(i + 1))
            else:
                frame, pose, dt = feeder.step(traffic.window_frame(i + 1))
            lat.append(dt)
            rows.append(slam.metrics[-1] if len(slam.metrics) > n_rows
                        else {})
            n_rows = len(slam.metrics)
            if pose is not None:
                poses.append((frame, pose[:3, :3].copy(), pose[:3, 3].copy()))
                if i in sample:     # copied on the card, read after
                    kps.append((frame, _kp_copy(slam.last.kp)))
            i += 1
            if time.perf_counter() - t0 >= seconds or (
                    max_frames is not None and i >= max_frames):
                break
    finally:
        _sync(device)
        t1 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        gc.unfreeze()
        torch.set_num_threads(threads)
    window_s = t1 - t0
    if poses and poses[-1][0] == frame:
        kps.append((frame, _kp_copy(slam.last.kp)))
    kps = [(f, {k: v.cpu().numpy() for k, v in kp.items()}) for f, kp in kps]
    peak = (torch.cuda.max_memory_allocated(device) if device != "cpu"
            else 0)
    arena = {k: getattr(slam.arena, k).cpu().numpy() for k in CHECKED}
    map_changed = None
    if before is not None:
        map_changed = int(sum(
            int((getattr(slam.arena, k).cpu() != v).sum())
            for k, v in before.items()))
    out = J.Outputs(poses, kps, arena, list(feeder.frame_of), map_changed)
    trace_data = None
    if prof is not None:
        from slambench.measure.window import TraceWindow
        trace_data = TraceWindow.from_profile(prof, rows, fields)
        prof = None
    del slam, feeder
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    n = len(lat)
    failed = n - len(poses)
    metrics = {}
    if not trace:
        lat_ms = [x * 1e3 for x in lat]
        metrics = {
            "fps": {"value": n / window_s, "unit": "frames/s"},
            "frame_ms.p95": {"value": float(np.percentile(lat_ms, 95)),
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    limits = cell.workload["limits"]
    t_ref = time.perf_counter()
    nums = J.numbers(out, traffic, fields, want=set(limits), device=device)
    t_ref = time.perf_counter() - t_ref
    correct, check = J.verdict(nums, limits)
    res = {"correct": bool(correct), "attempted": n, "failed": failed,
           "metrics": metrics,
           "device": _device(device, peak)}
    if trace_data is not None:
        per_layer = read_per_layer(cell_name, trace_data)
        res["metrics"] = per_layer
        res["device"]["busy_s"] = trace_data.busy_s
        res["device"]["window_s"] = trace_data.window_s
        res["breakdown"] = trace_data.breakdown()
    res["reference_s"] = t_ref
    res["check"] = {k: {"value": v, "limit": lim} for k, v, lim in check}
    if keep_outputs:
        res["_outputs"] = (out, traffic, fields)
    return res


def read_per_layer(cell_name: str, tw) -> Dict[str, dict]:
    """Each per-layer metric of BENCHMARK.json that this cell reports, read
    by its own module; a reader that finds nothing is left out."""
    out = {}
    for m in benchmark()["per_layer"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        v = metric_reader(m["name"])(tw)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _device(device: str, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def _plant(slam, fault: str) -> None:
    """Break the timed path under the harness, for the tests that show the
    check failing: ``frozen`` returns the state (the first pose) unchanged
    on every frame; ``altered`` moves every seventh returned pose;
    ``dropped`` drops one valid keypoint in ten of every frame."""
    track = slam.track_fisheye
    state = {"n": 0, "first": None}

    def frozen(img, ts, mask=None):
        T = track(img, ts, mask)
        if T is not None and state["first"] is None:
            state["first"] = T.copy()
        return None if T is None else state["first"].copy()

    def altered(img, ts, mask=None):
        T = track(img, ts, mask)
        state["n"] += 1
        if T is not None and state["n"] % 7 == 0:
            T = T.copy()
            T[:3, 3] += 0.5
        return T

    def dropped(img, ts, mask=None):
        T = track(img, ts, mask)
        if slam.last is not None:
            v = slam.last.kp.valid
            v[torch.nonzero(v).flatten()[::10]] = False
        return T

    slam.track_fisheye = {"frozen": frozen, "altered": altered,
                          "dropped": dropped}[fault]
