"""Initialization's attempt as the captured CUDA graphs run it
(``runtime/fused_init.py``), held on the CPU, where each captured part runs
eagerly on the same static buffers.

The world is ``tests/test_torch_fused_localization.py``'s (the JAX
package's renderer, seeded, drawn as raw fisheye images: 160^2 faces, 600
features, 3 levels, K=24, L=4096, the pretrained vocabulary), fed from the
first frame through ``track_fisheye``.

* ``FusedInit`` on the CPU (``CubemapSLAM._init_graph`` lifted by a
  monkeypatch: graphs I0, I1 and I2 each run eagerly on the static
  buffers) against the eager ``track_fisheye`` init (``init_graphs =
  False``) over a pre-initialization sequence that takes every branch: a
  reference taken (I0), dropped for too few keypoints (a blank frame, I1),
  an attempt that fails (no parallax: the reference again, I1 and I2), a
  reference dropped for too few matches, the attempt that succeeds and
  builds the map; then ``reset``, which keeps the ``FusedInit``, and the
  bootstrap again through it. Each frame's row and pose, the attempt's
  keypoints, matches, window centres, E21 and result (``init_trace``),
  the generator's state and, at the end, every arena table and the last
  frame bitwise equal.
* ``TrackingKernels.init_two_view`` against the JAX package's
  ``two_view_init`` on the same bootstrap matches (each with its own
  RANSAC draws): both succeed; the rotations within 1 degree of each
  other and of the truth; the translation directions within 25 degrees of
  each other and of the truth (a one-frame baseline holds the direction
  weakly, for JAX's draws as for the port's); the counts of good points
  within 5% of each other, and the good masks equal on >= 99% of the
  matches.
* A moved buffer raises; ``load_map`` drops the ``FusedInit``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.features.extractor import Keypoints as JKeypoints
from cubemapslam_tpu.runtime.kernels import TrackingKernels as JKernels
from cubemapslam_tpu.synth import Renderer, forward_trajectory, make_world
from cubemapslam_tpu_torch import interop, serialize
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime.fused_init import FusedInit
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
from cubemapslam_tpu_torch.solvers.sampling import draw_scores

VOCAB = str(pathlib.Path(__file__).resolve().parents[1] / "artifacts"
            / "vocab_synth_10k.npz")
SMALL = dict(cube_face_w=160, cube_face_h=160, n_features=600, n_levels=3,
             max_keyframes=24, max_landmarks=4096, min_init_keypoints=80,
             min_init_matches=60, min_track_inliers=20,
             min_track_inliers_after_reloc=30, fps=5.0, vocab_path=VOCAB)
N_FRAMES = 6
BLANK = -1
# frame indices (BLANK: an all-zero image): 0 the reference; the blank
# frame drops it (too few keypoints); 0 again the reference, 0 once more an
# attempt that fails (no parallax); 5 drops it (too few matches); 1 the
# reference, 2 the attempt that succeeds; 3 a tracked frame. Then a reset,
# and 0, 1 (the bootstrap again), 2 tracked.
SEQUENCE = (0, BLANK, 0, 0, 5, 1, 2, 3)
AFTER_RESET = (0, 1, 2)
TRACE = ("kp", "idx", "ok", "prev_rays", "E", "success", "R21", "t21",
         "p3d", "good", "n_good", "inliers")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The fisheye frames and their poses."""
    jcfg = JConfig(**SMALL)
    pts, patches = make_world(np.random.default_rng(42), n=600)
    fish = Renderer(JCam.from_config(jcfg), jcfg, "fisheye")
    poses = forward_trajectory(N_FRAMES)
    frames = [np.clip(np.rint(np.asarray(fish.render(pts, patches, R, t))),
                      0, 255).astype(np.uint8) for R, t in poses]
    return dict(frames=frames, poses=poses, jcfg=jcfg)


def lifted_init_graph(self):
    """``CubemapSLAM._init_graph`` without its card condition."""
    return self._pre_init() and self.init_graphs and self.stage_times is None


def image(world, k):
    frames = world["frames"]
    return np.zeros_like(frames[0]) if k == BLANK else frames[k]


def trace_record(slam):
    """Clones of the last attempt's ``init_trace`` (None without one)."""
    tr = slam.init_trace
    if tr is None:
        return None
    out = {}
    for k, v in tr.items():
        out[k] = (tuple(x.clone() for x in v) if k == "kp" else v.clone())
    return out


def frame_record(slam, T):
    row = {k: v for k, v in slam.metrics[-1].items()
           if not k.startswith("graph_")}
    return dict(T=None if T is None else T.copy(), row=row,
                state=slam.state, trace=trace_record(slam),
                gen=slam.generator.get_state().clone())


def drive(world, graphs, monkeypatch):
    """The port system over SEQUENCE, a reset, then AFTER_RESET, eagerly
    (``init_graphs`` off) or through ``FusedInit`` on the CPU. Returns the
    system and each frame's record."""
    with monkeypatch.context() as m:
        if graphs:
            m.setattr(CubemapSLAM, "_init_graph", lifted_init_graph)
        slam = CubemapSLAM(TConfig(**SMALL), device="cpu")
        slam.init_graphs = graphs
        recs, fused = [], []
        for i, k in enumerate(SEQUENCE):
            T = slam.track_fisheye(image(world, k), i / 10.0)
            recs.append(frame_record(slam, T))
            fused.append(slam.fused_init)
        before = slam.fused_init
        slam.reset()
        assert slam.fused_init is before
        for i, k in enumerate(AFTER_RESET, start=len(SEQUENCE)):
            T = slam.track_fisheye(image(world, k), i / 10.0)
            recs.append(frame_record(slam, T))
            fused.append(slam.fused_init)
    return slam, recs, fused


def same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_fused_init_on_cpu_equals_eager(world, monkeypatch):
    se, e = drive(world, False, monkeypatch)[:2]
    sg, g, fused = drive(world, True, monkeypatch)
    stages = [r["row"].get("stage") for r in e]
    states = [r["state"] for r in e]
    # the sequence takes every branch
    assert stages[:7] == ["init"] * 7 and stages[7] != "init"
    assert states[6] == TrackState.OK and states[7] == TrackState.OK
    assert [r["row"].get("init_matches") for r in e[:7]] == [
        None, None, None, e[3]["row"]["init_matches"],
        e[4]["row"]["init_matches"], None, e[6]["row"]["init_matches"]]
    assert e[3]["row"]["init_matches"] >= SMALL["min_init_matches"]
    assert e[4]["row"]["init_matches"] < SMALL["min_init_matches"]
    assert e[3]["trace"]["success"].item() is False
    assert e[6]["trace"]["success"].item() is True
    assert e[len(SEQUENCE) + 1]["state"] == TrackState.OK
    # the pre-init frames went through one FusedInit, kept by the reset
    fi = sg.fused_init
    assert isinstance(fi, FusedInit) and not fi.graphs
    assert fused[0] is fi and fused[-1] is fi
    assert se.fused_init is None
    pre = [i for i, r in enumerate(e) if r["row"].get("stage") == "init"]
    for i, (a, b) in enumerate(zip(e, g)):
        assert a["row"] == b["row"], i
        assert a["state"] == b["state"], i
        assert (a["T"] is None) == (b["T"] is None), i
        if a["T"] is not None:
            assert np.array_equal(a["T"], b["T"]), i
        assert torch.equal(a["gen"], b["gen"]), i
        assert (a["trace"] is None) == (b["trace"] is None), i
        if a["trace"] is not None:
            assert set(a["trace"]) == set(b["trace"])
            assert set(a["trace"]) == set(
                TRACE if "E" in a["trace"] else TRACE[:4])
            for k in a["trace"]:
                assert same(a["trace"][k], b["trace"][k]), (i, k)
    assert all(sg.metrics[i]["graph_init_captures"] == 0
               and sg.metrics[i]["graph_init_replays"] == 0 for i in pre)
    # the attempts' reads: the counts, and with a RANSAC its verdict
    assert [r["row"]["host_reads"] for r in e[:6]] == [1, 1, 1, 2, 1, 1]
    ta, tb = interop.arena_to_numpy(se.arena), interop.arena_to_numpy(sg.arena)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    for x, y in zip(se.last, sg.last):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, tuple):
            assert same(x, y)
        else:
            assert x == y


def jkp(kp):
    return JKeypoints(**{k: jnp.asarray(v) for k, v in
                         interop.keypoints_to_numpy(kp).items()})


def rot_deg(R):
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1,
                                              1))))


def test_init_two_view_against_jax(world):
    """The port's ``init_two_view`` and JAX's ``two_view_init`` on the same
    bootstrap matches of frames 1 and 2, each with its own RANSAC draws,
    held to the same outcome and to the truth."""
    slam = CubemapSLAM(TConfig(**SMALL), device="cpu")
    k = slam.kernels
    kps = [slam.extractor_init(slam.warp(torch.as_tensor(world["frames"][i])),
                               slam.mask) for i in (1, 2)]
    m = k.init_match(kps[0], kps[1], kps[0].rays)
    assert int(m.counts[1]) >= SMALL["min_init_matches"]
    scores = draw_scores(torch.Generator().manual_seed(0),
                         slam.cfg.init_ransac_iters,
                         kps[0].n, "cpu")
    rt, E, packed = k.init_two_view(kps[0], kps[1], m.idx, m.ok, scores)
    jk = JKernels(world["jcfg"], JCam.from_config(world["jcfg"]))
    rj = jk.two_view_init(jax.random.PRNGKey(0), jkp(kps[0]), jkp(kps[1]),
                          jnp.asarray(m.idx.numpy().astype(np.int32)),
                          jnp.asarray(m.ok.numpy()))
    assert bool(rt.success) and bool(rj.success)
    (R1, t1), (R2, t2) = world["poses"][1:3]
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    Rt, Rj = rt.R21.numpy(), np.asarray(rj.R21)
    assert rot_deg(Rt @ Rj.T) < 1.0
    assert rot_deg(Rt @ R21.T) < 1.0 and rot_deg(Rj @ R21.T) < 1.0
    tt, tj = rt.t21.numpy(), np.asarray(rj.t21)
    for a, b in ((tt, tj), (tt, t21), (tj, t21)):
        cos = a @ b / np.linalg.norm(a) / np.linalg.norm(b)
        assert cos > np.cos(np.radians(25.0)), cos
    nt, nj = int(rt.n_good), int(rj.n_good)
    assert abs(nt - nj) <= 0.05 * nj, (nt, nj)
    assert (rt.good.numpy() == np.asarray(rj.good)).mean() >= 0.99
    # the packed vector is what the host reads
    assert packed[0] == 1.0 and packed[1] == nt
    pg = packed[2:].reshape(-1, 4)
    assert torch.equal(pg[:, :3], rt.p3d)
    assert torch.equal(pg[:, 3] > 0, rt.good)
    assert E.shape == (3, 3)


def test_moved_buffer_raises_and_load_map_drops(world, monkeypatch,
                                                tmp_path):
    monkeypatch.setattr(CubemapSLAM, "_init_graph", lifted_init_graph)
    slam = CubemapSLAM(TConfig(**SMALL), device="cpu")
    slam.track_fisheye(world["frames"][0], 0.0)
    fi = slam.fused_init
    assert isinstance(fi, FusedInit)
    slam.extractor_init.desc_table = slam.extractor_init.desc_table.clone()
    with pytest.raises(RuntimeError, match="moved"):
        slam.track_fisheye(world["frames"][1], 0.1)
    other = CubemapSLAM(TConfig(**SMALL), device="cpu")
    for i in range(4):
        other.track_fisheye(world["frames"][i], i / 10.0)
    assert other.state == TrackState.OK
    path = str(tmp_path / "map.npz")
    serialize.save_map(other, path)
    fresh = CubemapSLAM(TConfig(**SMALL), device="cpu")
    fresh.track_fisheye(world["frames"][0], 0.0)
    assert fresh.fused_init is not None
    serialize.load_map(fresh, path)
    assert fresh.fused_init is None
