"""Port parity for the whole slice, and the port's import isolation.

FrameTracker(device="cpu") is held against the same composition of JAX
functions: warp_bilinear -> extract_orb with the FOV mask -> the frame-step
body of __graft_entry__.entry (search_by_projection with radius 15 px and
level offsets -1/+1, the scatter-max association, pose_optimization). Both
run on the JAX warp map, carried across as its source coordinates. The
landmarks are a rendered frame's keypoints, back-projected at seeded
depths, so that most of them match in the next frame (a pure rotation,
which keeps any depth exact).
Tolerances: pose within 1e-3, associations equal on >= 98% of matched
landmarks, inlier counts within 2%. Both of FrameTracker's paths are held
so: its graph F path (static buffers, run eagerly on the CPU), which a call
takes by default, and ``FrameTracker(graphs=False)``, which the graph path
equals bit for bit over three calls.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu import matching as JM
from cubemapslam_tpu import synth
from cubemapslam_tpu import warp as JW
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.features.extractor import build_extractor
from cubemapslam_tpu.optim.pose_opt import pose_optimization
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime import FrameTracker, resolve_device
from cubemapslam_tpu_torch.runtime.tracking import MapTracker
from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4)


def jax_frame_step(cfg, cam, extract, wm, mask, fisheye, lm_pos, lm_desc,
                   lm_level, lm_valid, R0, t0):
    """warp_bilinear -> extract_orb -> the __graft_entry__ frame-step body."""
    cube = JW.warp_bilinear(jnp.asarray(fisheye), wm)
    kp = extract(cube, mask)
    scale_factors = jnp.asarray(cfg.scale_factors, jnp.float32)
    inv_sigma2 = 1.0 / jnp.asarray(cfg.level_sigma2, jnp.float32)
    Xc = JG.se3_apply(R0, t0, lm_pos)
    res = JM.search_by_projection(
        Xc, lm_desc, lm_level, lm_valid, kp, cam, scale_factors,
        15.0, level_lo_off=-1, level_hi_off=1)
    assoc = jnp.full((kp.n,), -1, jnp.int32).at[res.idx].max(
        jnp.where(res.ok, jnp.arange(lm_pos.shape[0], dtype=jnp.int32), -1))
    has = assoc >= 0
    Xw = lm_pos[jnp.maximum(assoc, 0)]
    uv_face = JC.cubemap_uv_to_in_face(cam, kp.uv)
    inv_s2 = inv_sigma2[jnp.clip(kp.level, 0, cfg.n_levels - 1)]
    R, t, inl, n = pose_optimization(cam, R0, t0, Xw, kp.face, uv_face,
                                     inv_s2, has)
    return kp, assoc, R, t, inl, n


def lm_to_uv(assoc, uv, n_lm):
    """(n_lm, 2) position of the keypoint each landmark is associated
    with; NaN for a landmark without one."""
    out = np.full((n_lm, 2), np.nan, np.float32)
    rows = np.nonzero(assoc >= 0)[0]
    out[assoc[rows]] = uv[rows]
    return out


@pytest.fixture(scope="module")
def jax_step():
    """The world, the landmarks and frame 1 with its start pose, the JAX
    composition's outputs on them, and the port's inputs (the JAX warp map
    carried across)."""
    cfg = JConfig(**SMALL)
    cam = JC.CubemapCamera.from_config(cfg)
    rng = np.random.default_rng(11)
    pts, patches = synth.make_world(rng, n=500, fx=cfg.cube_face_w / 2.0)
    render = synth.Renderer(cam, cfg, target="fisheye")

    def frame(R):
        img = render.render(pts, patches, R, np.zeros(3, np.float32))
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    wm = JW.build_warp_map(cam, cfg.cube_w, cfg.cube_h)
    mask = JW.fov_mask(cam, cfg.cube_w, cfg.cube_h)
    extract, _ = build_extractor(cfg, cam, cfg.n_features,
                                 (cfg.cube_h, cfg.cube_w))
    # landmarks: frame-0 keypoints at seeded depths, plus distractors
    fish0 = frame(np.eye(3))
    kp0 = extract(JW.warp_bilinear(jnp.asarray(fish0), wm), mask)
    v0 = np.asarray(kp0.valid)
    n_lm = 1024
    depth = rng.uniform(3, 8, v0.sum()).astype(np.float32)
    d = rng.normal(size=(n_lm - v0.sum(), 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lm_pos = np.concatenate([np.asarray(kp0.rays)[v0] * depth[:, None],
                             d * 5.0]).astype(np.float32)
    lm_desc = np.concatenate([
        np.asarray(kp0.desc)[v0],
        rng.integers(0, 2 ** 32, (len(d), 8), dtype=np.uint32)])
    lm_level = np.concatenate([np.asarray(kp0.level)[v0],
                               rng.integers(0, 4, len(d))]).astype(np.int32)
    lm_valid = np.ones(n_lm, bool)
    # frame 1: the camera turned by 0.6 degrees; start 1 degree and 2 cm off
    R1 = np.asarray(JG.so3_exp(jnp.asarray([0.0, 0.0105, 0.002],
                                           jnp.float32)))
    fish1 = frame(R1)
    R0 = np.asarray(JG.so3_exp(jnp.asarray([0.01, -0.012, 0.004],
                                           jnp.float32))) @ R1
    R0 = R0.astype(np.float32)
    t0 = np.array([0.012, -0.01, 0.012], np.float32)

    out = jax_frame_step(
        cfg, cam, extract, wm, mask, fish1, jnp.asarray(lm_pos),
        jnp.asarray(lm_desc), jnp.asarray(lm_level), jnp.asarray(lm_valid),
        jnp.asarray(R0), jnp.asarray(t0))
    uu, vv = jnp.meshgrid(jnp.arange(cfg.cube_w, dtype=jnp.float32),
                          jnp.arange(cfg.cube_h, dtype=jnp.float32))
    uv_f, valid = JC.cubemap_to_fisheye(cam, jnp.stack([uu, vv], axis=-1))
    warp = interop.warp_map_from_numpy(np.asarray(uv_f), np.asarray(valid),
                                       np.asarray(wm.src_wh))
    lms = interop.landmarks_from_numpy(lm_pos, lm_desc, lm_level, lm_valid)
    return dict(cfg=cfg, jax=out, warp=warp, lms=lms, R1=R1,
                fish=(torch.as_tensor(fish0), torch.as_tensor(fish1)),
                pose=(torch.as_tensor(R0), torch.as_tensor(t0)))


def port_tracker(jax_step, graphs=True):
    tracker = FrameTracker(TConfig(**SMALL), device="cpu", graphs=graphs)
    tracker.set_warp_map(jax_step["warp"])
    return tracker


def assert_close_to_jax(jax_step, port):
    """The tolerances of the module docstring, and the pose recovered."""
    jkp, jassoc, jR, jt, jinl, jn = jax_step["jax"]
    tkp, tassoc, tR, tt, tinl, tn = port
    n_lm = jax_step["lms"][0].shape[0]
    # keypoints with nearly tied responses may swap rows between the two
    # (the warped images differ by float32 rounding), so associations are
    # compared per landmark: the position of the keypoint it went to
    j_uv = lm_to_uv(np.asarray(jassoc), np.asarray(jkp.uv), n_lm)
    t_uv = lm_to_uv(tassoc.numpy(), tkp.uv.numpy(), n_lm)
    matched = np.isfinite(j_uv[:, 0]) | np.isfinite(t_uv[:, 0])
    same = (np.abs(j_uv - t_uv) <= 1e-3).all(axis=1)
    agree = same[matched].mean()
    print(f"matched landmarks {matched.sum()}, agreement {agree:.4f}, "
          f"inliers {int(tn)} vs {int(jn)}")
    assert matched.sum() > 100
    assert agree >= 0.98
    dR = np.asarray(JG.so3_log(jnp.asarray(tR.numpy() @ np.asarray(jR).T)))
    assert np.linalg.norm(dR) < 1e-3
    assert np.abs(tt.numpy() - np.asarray(jt)).max() < 1e-3
    assert abs(int(tn) - int(jn)) <= 0.02 * int(jn)
    # the pose was recovered: 0.6 degree turn, no translation
    assert np.linalg.norm(np.asarray(JG.so3_log(
        jnp.asarray(tR.numpy() @ jax_step["R1"].T)))) < 2e-3
    assert np.abs(tt.numpy()).max() < 5e-3
    assert tkp.uv.shape == (jax_step["cfg"].n_features, 2)


def test_frame_step_against_jax(jax_step):
    """``FrameTracker`` as called by default (its graph F's part, eagerly
    on the CPU's static buffers) against the JAX composition."""
    tracker = port_tracker(jax_step)
    out = tracker(jax_step["fish"][1], *jax_step["lms"], *jax_step["pose"])
    assert tracker.step_graph is not None
    assert_close_to_jax(jax_step, out)


def test_frame_step_graph_path_bitwise_eager(jax_step):
    """``FrameTracker``'s graph F path (static buffers; on the CPU each
    call runs the part eagerly) against ``FrameTracker(graphs=False)`` on
    the same calls: frame 1 from its start pose, frame 0 from the identity,
    frame 1 again from a pose 2 degrees off: every output bitwise equal,
    no graph captured or replayed, and the eager path against the JAX
    composition within the module's tolerances. A landmark set of another
    shape or type, and a frame that is not (H, W) uint8, raise."""
    graph, eager = port_tracker(jax_step), port_tracker(jax_step, False)
    lms = jax_step["lms"]
    fish0, fish1 = jax_step["fish"]
    R0, t0 = jax_step["pose"]
    off = torch.tensor(np.array(JG.so3_exp(jnp.asarray(
        [0.02, 0.025, -0.01], jnp.float32)))) @ R0
    calls = ((fish1, R0, t0), (fish0, torch.eye(3), torch.zeros(3)),
             (fish1, off, t0))
    for k, (img, R, t) in enumerate(calls):
        g = graph(img, *lms, R, t)
        e = eager(img, *lms, R, t)
        assert all(torch.equal(x, y) for x, y in zip(g[0], e[0]))
        assert all(torch.equal(x, y) for x, y in zip(g[1:], e[1:]))
        assert int(e[5]) > 100
        if k == 0:
            assert_close_to_jax(jax_step, e)
    assert eager.step_graph is None
    cf = graph.step_graph
    assert cf.captures == cf.replays == 0 and list(cf.outputs) == ["f"]
    with pytest.raises(ValueError, match="lm_pos"):
        graph(fish1, lms[0][:-1], *lms[1:], R0, t0)
    with pytest.raises(ValueError, match="lm_level"):
        graph(fish1, lms[0], lms[1], lms[2].to(torch.int32), lms[3], R0, t0)
    with pytest.raises(ValueError, match="uint8"):
        graph(fish1.to(torch.float32), *lms, R0, t0)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError):
            FrameTracker(TConfig(**SMALL))
        with pytest.raises(RuntimeError):
            MapTracker(TConfig(**SMALL))
        with pytest.raises(RuntimeError):
            CubemapSLAM(TConfig(**SMALL))
        with pytest.raises(RuntimeError):
            MappingKernels(TConfig(**SMALL))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "cubemapslam_tpu", "__graft_entry__")


def test_port_sources_import_no_jax():
    files = sorted((REPO / "cubemapslam_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 10
    for f in files:
        bad = [m for m in _imported_modules(f) if _foreign(m)]
        assert not bad, (f, bad)


def test_port_runs_without_jax_loaded():
    """In a fresh interpreter: import the port and chip_smoke, run a tiny
    frame step, map build, tracked frame and two frames of CubemapSLAM on
    the CPU, train a tiny vocabulary and make a BoW row, import the loop
    closing modules and run a tiny global CG BA, import the apps, the
    native loader and the viewer, and find no JAX module loaded."""
    code = """
import sys
import numpy as np, torch
import chip_smoke
from cubemapslam_tpu_torch import SlamConfig
from cubemapslam_tpu_torch.runtime import FrameTracker
from cubemapslam_tpu_torch.runtime import synthetic
cfg = SlamConfig(cube_face_w=64, cube_face_h=64, n_features=64, n_levels=2)
tr = FrameTracker(cfg, device="cpu")
img = torch.as_tensor(synthetic.synthetic_fisheye(cfg, 0))
rng = np.random.default_rng(0)
kp = tr.extract(tr.warp(img))
lms = synthetic.landmarks_from_keypoints(kp, 128, rng, cfg.n_levels)
if not torch.cuda.is_available():
    assert chip_smoke.main() == 2      # without a card nothing is run
out = tr(img, *lms, torch.eye(3), torch.zeros(3))
assert out[2].shape == (3, 3)
# the map arena and the tracked frame against it
from cubemapslam_tpu_torch import interop, slam_map
from cubemapslam_tpu_torch.runtime.kernels import TrackingKernels
from cubemapslam_tpu_torch.runtime.tracking import MapTracker
cfg = SlamConfig(cube_face_w=64, cube_face_h=64, n_features=64, n_levels=2,
                 max_keyframes=4, max_landmarks=256)
mt = MapTracker(cfg, device="cpu")
poses = synthetic.forward_trajectory(4, step=0.04)
world = synthetic.make_world(rng, n=200, fx=32.0)
synthetic.build_map(mt, world, poses, 2, kf_stride=2)
ren = synthetic.Renderer(mt.cam, cfg)
mt.track_fisheye(synthetic.to_u8(ren.render(*world, *poses[3])[0]), 0.1)
assert len(mt.metrics) == 1 and isinstance(mt.kernels, TrackingKernels)
assert interop.arena_to_numpy(mt.arena)["kf_desc"].dtype == np.uint32
# the whole system from its first frame, and the mapping stages
from cubemapslam_tpu_torch.runtime.mapping import MappingKernels
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
slam = CubemapSLAM(cfg, device="cpu")
for k in range(2):
    slam.track_fisheye(synthetic.to_u8(ren.render(*world, *poses[k])[0]),
                       k / 10)
assert slam.total_frames == 2 and isinstance(slam.mapping, MappingKernels)
# the vocabulary, the bag of words, PnP and map save/load
from cubemapslam_tpu_torch import place, serialize
from cubemapslam_tpu_torch.solvers import pnp
voc = place.train_vocabulary(
    rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32), k=2, depth=2,
    device="cpu")
assert place.bow_vector(voc, kp.desc, kp.valid).shape == (4,)
assert callable(pnp.pnp_ransac) and callable(serialize.load_map)
# loop closing: Sim3, the pose graph, the global CG BA and the loop closer
from cubemapslam_tpu_torch import dist
from cubemapslam_tpu_torch.optim import ba, pose_graph, sim3_opt
from cubemapslam_tpu_torch.runtime import loop_closing
from cubemapslam_tpu_torch.solvers import sim3
assert isinstance(slam.loop_closer, loop_closing.LoopCloser)
assert callable(sim3.sim3_ransac) and callable(sim3_opt.optimize_sim3)
assert callable(pose_graph.optimize_essential_graph)
prob = dist.global_ba_problem_from_arena(mt.cam, mt.arena, mt.inv_sigma2)
out, inl = ba.bundle_adjust(mt.cam, prob, phase_iters=(1, 1), solver="cg",
                            cg_iters=2)
assert torch.isfinite(out.X).all()
# the apps, the native loader (never the committed native/_build binary),
# the viewer and the sharded BA
from cubemapslam_tpu_torch import native, viz
from cubemapslam_tpu_torch.apps import run_fangshan, run_lafida, run_sequence
lib = native._load_lib()
assert lib is None or "native/_build" not in lib._name, lib._name
assert run_lafida.main is run_sequence.main is run_fangshan.main
assert callable(viz.Viewer) and callable(dist.distributed_bundle_adjust)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cubemapslam_tpu"))
print("FOREIGN", bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FOREIGN []" in r.stdout
