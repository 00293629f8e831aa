"""The trace arithmetic on a recorded small event list, the renderer on the
card's path against the frozen host renderer, and the check's control."""

import pathlib

import numpy as np
import pytest
import torch

from slambench import harness
from slambench.measure import kernels as K
from slambench.measure import trace as TR
from slambench.measure.window import TraceWindow, plain_frame
from slambench.reference import camera as C
from slambench.reference import extract as X
from slambench.traffic import world as Wd

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _events():
    """Two traced frames, as (name, on the device, start, end, shapes,
    correlation id): frame 0 tracks (2 kernels, one wait), frame 1 is a
    keyframe (a kernel launched in insert+mapping, one in the loop range
    nested there) with its device span running past its host span."""
    cpu = [("frame", False, 0, 1000, [], 0),
           ("cudaLaunchKernel", False, 10, 20, [], 1),
           ("cudaGraphLaunch", False, 30, 40, [], 2),
           ("aten::item", False, 500, 700, [], 0),
           ("cudaStreamSynchronize", False, 600, 690, [], 0),
           ("frame", False, 2000, 3000, [], 0),
           ("insert+mapping", False, 2100, 2900, [], 0),
           ("cudaLaunchKernel", False, 2150, 2160, [], 3),
           ("loop", False, 2500, 2800, [], 0),
           ("cudaLaunchKernel", False, 2550, 2560, [], 4)]
    dev = [("frame", True, 0, 1000, [], 0),   # the range's device side
           ("warp_remap_kernel", True, 100, 300, [], 1),
           ("fast_levels_kernel", True, 250, 400, [], 2),
           ("select_levels_kernel", True, 2200, 2600, [], 3),
           ("other_kernel", True, 2600, 3200, [], 4)]
    return cpu + dev


def test_trace_window_arithmetic():
    rows = [{"state": "OK", "keyframe": False},
            {"state": "OK", "keyframe": True}]
    tw = TraceWindow(_events(), rows, {})
    assert tw.n == 2 and len(tw.ops) == 4
    assert tw.window_s == pytest.approx(3000e-9)
    # busy: [100, 400] and [2200, 3000] (clipped to the window's end)
    assert tw.busy_s == pytest.approx(1100e-9)
    assert tw.op_frame == [0, 0, 1, 1]
    assert [len(f) for f in tw.frame_ops(plain_frame)] == [2]
    assert [k[0] for k in tw.launched_in("loop", "loop.")] == ["other_kernel"]
    assert len(tw.launched_in("insert+mapping")) == 2
    waits, by = TR.waits_in(tw.waits(), tw.frames, tw.n,
                            TR.wait_sources(tw.cpu))
    assert waits == 0.5 and by == [("aten::item", 0.5)]
    gaps = tw.breakdown()["idle_gaps"]
    assert gaps[0] == ["frame", pytest.approx(1800e-9)]
    readers = {m: harness.metric_reader(m) for m in (
        "track.busy_ms", "track.device_ops", "device.idle_share",
        "system.host_waits")}
    got = {m: r(tw) for m, r in readers.items()}
    assert got["track.busy_ms"] == pytest.approx(300e-6)
    assert got["track.device_ops"] == 2
    assert got["device.idle_share"] == pytest.approx(100 * (1 - 1100 / 3000))
    assert got["system.host_waits"] == 0.5


def test_union_and_bound():
    assert TR.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    ms, by = TR.bound(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    # kernel W at Lafida: chip_smoke.py's count, 0.01373 ms
    nbytes, _ = K.warp_work(754, 480, 650, 0)
    assert TR.bound(nbytes, 0)[0] == pytest.approx(0.01373, abs=5e-6)


def _camera(**kw):
    cell = harness.Cell("lafida_loc.patrol")
    return C.Camera.from_fields(dict(cell.fields, **kw))


def test_card_renderer_matches_host_renderer():
    """The batched renderer (on the CPU here) draws what the frozen host
    renderer draws, frame by frame, to the rounding of a grey level."""
    cam = _camera()
    poses = Wd.forward_trajectory(4, step=0.05, yaw_rate=0.01)
    world = Wd.make_world(np.random.default_rng(3), n=400,
                          centers=Wd.camera_centres(poses), fx=cam.focal)
    got = Wd.render_frames(cam, world, poses, "cpu", frames_per_batch=3)
    host = Wd.HostRenderer(cam)
    for k, p in enumerate(poses):
        want = Wd.to_u8(host.render(*world, *p)).astype(int)
        d = np.abs(got[k].numpy().astype(int) - want)
        assert d.max() <= 1 and (d > 0).mean() < 1e-4
        assert (want != Wd.BACKGROUND).mean() > 0.05


# a smaller cross and budget than the cells', so that the plain versions
# extract on the CPU; every pyramid level as the cells have them
SMALL = {"cfg.cube_face_w": 160, "cfg.cube_face_h": 160,
         "cfg.n_features": 600}


def _extract(cell, frame):
    from cubemapslam_tpu_torch.config import SlamConfig
    from cubemapslam_tpu_torch.runtime.frame_step import FrameFrontend
    cfg = SlamConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in cell.fields.items()})
    fe = FrameFrontend(cfg, "cpu")
    kp = fe.extract(fe.warp(frame))
    return kp.level.numpy(), {k: getattr(kp, k).numpy() for k in (
        "uv", "valid", "desc", "angle", "response")}


@pytest.mark.parametrize("name", ["lafida_loc.patrol"])
def test_control_fails_and_program_passes_the_extract_check(name):
    """On one rendered frame at a small size: the program's keypoints on
    every pyramid level (its plain versions, which its kernels repeat bit
    for bit) meet every extract limit of the cell, and the reference
    computed a precision below the stated one fails at least one; one
    keypoint in ten dropped fails ``kp_set``."""
    cell = harness.Cell(name, SMALL)
    f = cell.fields
    cam = C.Camera.from_fields(f)
    poses = Wd.forward_trajectory(2, step=0.02, yaw_rate=0.002)
    world = Wd.make_world(np.random.default_rng(11), n=600,
                          centers=Wd.camera_centres(poses), fx=cam.focal)
    frame = Wd.render_frames(cam, world, poses[1:], "cpu")[0]
    p = X.plan(f)
    level, got = _extract(cell, frame)
    assert tuple(np.bincount(level)) == p.k
    wp, w8 = X.make_warp(cam), torch.as_tensor(X.comparison_weights())
    ops = [torch.as_tensor(A) for A in X.pyramid_operators(p)]
    args = (frame.numpy(), wp, p, ops, f["ini_th_fast"], f["min_th_fast"],
            w8)
    ref = X.levels(*args)
    ctl = X.levels(*args, "control")
    sound = X.compare(X.split(got, p), ref)
    control = X.compare([dict(uv=c.uv, valid=c.valid, bits=c.desc,
                              angle=c.angle, response=c.response)
                         for c in ctl], ref)
    v = got["valid"].copy()
    v[np.nonzero(v)[0][::10]] = False
    dropped = X.compare(X.split(dict(got, valid=v), p), ref)
    limits = cell.workload["limits"]
    keys = [k for k in sound if k in limits]
    assert "kp_set" in keys and "resp_off" in keys
    assert all(sound[k] <= limits[k] for k in keys), (sound, limits)
    assert any(control[k] > limits[k] for k in keys), (control, limits)
    assert dropped["kp_set"] > limits["kp_set"], (dropped, limits)


@pytest.mark.parametrize("kind,params", [
    ("patrol", {"radius": 0.2, "step": 0.04, "laps": 3, "lateral_offset":
                0.03, "billboards": 60, "world_seed": 5,
                "warmup_frames": 4})])
def test_traffic_kinds(kind, params):
    """Each traffic kind gives one frame a pose, from the seed alone, and a
    window that goes on, cycling."""
    import importlib

    mod = importlib.import_module(f"slambench.traffic.{kind}")
    cam = _camera()
    a = mod.make(params, 7, 2.0, cam, "cpu")
    b = mod.make(params, 7, 2.0, cam, "cpu")
    assert a.frames.shape == (len(a.poses), cam.fisheye_h, cam.fisheye_w)
    assert a.frames.dtype == torch.uint8 and torch.equal(a.frames, b.frames)
    fed = a.slam + a.warmup + [a.window_frame(i)
                               for i in range(len(a.window))]
    assert set(fed) <= set(range(len(a.poses)))
    if "world_seed" in params:      # another seed: the same site and map
        c = mod.make(params, 8, 2.0, cam, "cpu")
        assert torch.equal(a.frames[a.slam], c.frames[c.slam])
        assert not torch.equal(a.frames, c.frames)
    assert a.window_frame(len(a.window)) == a.window[0]
