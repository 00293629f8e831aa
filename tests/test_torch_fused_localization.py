"""Localization-mode frames and the LOST frame's front end as the captured
CUDA graphs run them (``runtime/fused_localization.py``), held on the CPU,
where each captured part runs eagerly on the same static buffers.

The map is made as ``tests/test_torch_reloc.py`` makes it (the port's
``CubemapSLAM`` on the CPU over 12 frames of the same seeded world drawn by
the JAX package's renderer: 160^2 faces, 600 features, 3 levels, K=24,
L=4096, the pretrained vocabulary), but from the world drawn as raw fisheye
images through ``track_fisheye``, whose front end the graphs hold; it is
saved once and each test loads it.

* ``FusedLocalization`` on the CPU (``CubemapSLAM._localization_graph``
  lifted by a monkeypatch: graphs L1, L2, L3 and X each run eagerly on the
  static buffers; ``_reloc_graph`` lifted too, so a LOST frame's
  relocalization runs through ``FusedReloc``) against the parent's eager
  ``_track_frame_localization`` (a copy here) on the loaded map, in each
  branch: the plain 15 px frame, a frame widened to 30 px, the
  reference-keyframe fallback (graph LR), mbVO (a VO frame on perturbed
  landmarks, then the relocalization that clears it) and a LOST frame
  (graph X, then the relocalization). Poses, rows, the last frame's
  tensors, the velocity, ``mb_vo``, every arena table and the generator
  state bitwise equal; and graph LR's part alone bitwise the eager
  fallback on the same keypoints and last pose.
* ``TrackingKernels.localization_motion`` against the JAX package's
  ``_predicted_pose`` composition and ``track_motion_fused``
  (``system.py:528-550``, ``kernels.py:297``) on the same carried-over
  arena, keypoints and last frame, at 15 and 30 px, with and without a
  velocity: associations equal on >= 98% of the keypoints, the pose within
  1e-4, the match count within 2%.
* A moved arena tensor raises; ``reset`` and ``load_map`` drop the graphs.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.features.extractor import Keypoints as JKeypoints
from cubemapslam_tpu.runtime.kernels import TrackingKernels as JKernels
from cubemapslam_tpu.synth import Renderer, forward_trajectory, make_world
from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch import interop, serialize
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime.fused_localization import (
    FusedLocalization)
from cubemapslam_tpu_torch.runtime.kernels import MIN_MATCHES, pack
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
from cubemapslam_tpu_torch.runtime.tracking import FRAME_KINDS
from slambench.measure.window import plain_frame

VOCAB = str(pathlib.Path(__file__).resolve().parents[1] / "artifacts"
            / "vocab_synth_10k.npz")
SMALL = dict(cube_face_w=160, cube_face_h=160, n_features=600, n_levels=3,
             max_keyframes=24, max_landmarks=4096, min_init_keypoints=80,
             min_init_matches=60, min_track_inliers=20,
             min_track_inliers_after_reloc=30, fps=5.0, vocab_path=VOCAB)
N_FRAMES = 12
RELOC_AT = 6                # the frame that relocalizes the loaded map
WIDEN_PITCH = 0.19          # rad: a velocity this far off widens the search
MBVO_SIGMA = 0.12           # landmark noise that leaves < 10 inliers


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """``test_torch_reloc.py``'s map, saved, and its frames drawn as raw
    fisheye images."""
    jcfg = JConfig(**SMALL)
    pts, patches = make_world(np.random.default_rng(42), n=600)
    fish = Renderer(JCam.from_config(jcfg), jcfg, "fisheye")
    frames = [np.clip(np.rint(np.asarray(fish.render(pts, patches, R, t))),
                      0, 255).astype(np.uint8)
              for R, t in forward_trajectory(N_FRAMES)]
    slam = CubemapSLAM(TConfig(**SMALL), device="cpu")
    for k, img in enumerate(frames):
        slam.track_fisheye(img, k / 10.0)
    assert slam.state == TrackState.OK
    snap = str(tmp_path_factory.mktemp("map") / "map.npz")
    serialize.save_map(slam, snap)
    return dict(snap=snap, frames=frames, jcfg=jcfg)


def fresh(mapped):
    """A new port system with the saved map loaded (LOST)."""
    s = CubemapSLAM(TConfig(**SMALL), device="cpu")
    serialize.load_map(s, mapped["snap"])
    assert s.state == TrackState.LOST
    return s


# ---------------------------------------------------------------------------
# The parent's eager localization frame
# ---------------------------------------------------------------------------

def parent_track_frame_localization(self, kp, fid, ts):
    """``CubemapSLAM._track_frame_localization`` with its ``_predicted_pose``
    and ``_read`` as written before the frame's stages could be captured:
    the host's ``None`` branch for the velocity, the keyframe's pose read
    through an int slot, each read's vector built where it is read."""
    k, cfg, last = self.kernels, self.cfg, self.last
    row = self._row
    row.update(frame=fid, kind="localization", stage="localization",
               host_reads=0, vo=False)
    self.metrics.append(row)

    def read(counts, R, t):
        self._row["host_reads"] += 1
        n = len(counts)
        h = torch.cat([torch.stack([c.to(torch.float32) for c in counts]),
                       R.reshape(-1), t]).tolist()
        return ([int(x) for x in h[:n]],
                (np.asarray(h[n:n + 9]).reshape(3, 3), np.asarray(h[n + 9:])))

    R_last, t_last = G.se3_compose(last.rel_R, last.rel_t,
                                   self.arena.kf_R[last.ref_kf],
                                   self.arena.kf_t[last.ref_kf])
    R_last = G.so3_project(R_last)
    a = float(self.cfg.motion_model_damping)
    if self.velocity is None or a <= 0.0:
        R_pred, t_pred = R_last, t_last
    else:
        Rv, tv = self.velocity
        if a < 1.0:
            Rv, tv = G.se3_exp(a * G.se3_log(Rv, tv))
        R_pred, t_pred = G.se3_compose(Rv, tv, R_last, t_last)
        R_pred = G.so3_project(R_pred)

    def motion(radius):
        st = k.track_motion_fused(self.arena, kp, last.assoc, last.outlier,
                                  last.kp.level, last.kp.angle, R_pred,
                                  t_pred, radius=radius)
        (n, n_inl), pose = read((st[1], st[5]), st[2], st[3])
        return st, n, n_inl, pose

    (assoc, _, R, t, outlier, _), n, n_inl, pose = motion(15.0)
    if n < MIN_MATCHES:
        (assoc, _, R, t, outlier, _), n, n_inl, pose = motion(30.0)
    if self.mb_vo:
        pose_r = self._relocalize(kp, fid, ts)
        if pose_r is not None:
            return pose_r
        if n < MIN_MATCHES:
            self._set_lost()
            return None
        self._vo_frame(kp, assoc, outlier, R, t, R_last, t_last, fid, ts,
                       n, n_inl)
        self.mb_vo = n_inl < 10
        return pose
    if n < MIN_MATCHES:
        assoc, n_t = k.track_reference_kf(self.arena, kp, self.ref_kf)
        R, t, outlier, n_inl_t = k.optimize_pose(self.arena, kp, assoc,
                                                 R_last, t_last)
        (n, n_inl), pose = read((n_t, n_inl_t), R, t)
        if n < 15:
            self._set_lost()
            return None
    if n < 15 or n_inl < 10:
        if n >= MIN_MATCHES:
            self.mb_vo = True
            self._vo_frame(kp, assoc, outlier, R, t, R_last, t_last, fid,
                           ts, n, n_inl)
            return pose
        self._set_lost()
        return None
    self.mb_vo = False
    (self.arena, assoc, outlier, R, t, n_final, pkf_max, pkf_votes,
     _) = k.track_local_fused(self.arena, kp, assoc, outlier, R, t,
                              covis=self.covis)
    (n_final, pkf_max, pkf_votes), pose = read(
        (n_final, pkf_max, pkf_votes), R, t)
    row.update(inliers=n_final, matches=n)
    if n_final < cfg.min_track_inliers:
        self._set_lost()
        return None
    if pkf_votes > 0:
        self.ref_kf = pkf_max
    self.velocity = G.se3_compose(R, t, *G.se3_inverse(R_last, t_last))
    self._record_frame(kp, assoc, outlier, R, t, fid, ts)
    return pose


def lifted_localization_graph(self):
    """``CubemapSLAM._localization_graph`` without its CUDA condition."""
    if self.state == TrackState.LOST:
        return self._reloc_graph()
    return (self.localization_only and self.state == TrackState.OK
            and self.localization_graphs and self.stage_times is None)


def frame_state(s, T):
    row = {k: v for k, v in s.metrics[-1].items()
           if not k.startswith("graph_") and not k.endswith("_ms")}
    tensors = [getattr(s.arena, k) for k in s.arena._fields]
    if s.last is not None:
        tensors += [*s.last.kp, s.last.assoc, s.last.outlier, s.last.R,
                    s.last.t, s.last.rel_R, s.last.rel_t]
    if s.velocity is not None:
        tensors += list(s.velocity)
    return (T, row, [x.clone() for x in tensors], s.mb_vo, s.state,
            s.ref_kf, s.generator.get_state())


def same_states(a, b):
    for (Ta, ra, xa, *ma, ga), (Tb, rb, xb, *mb, gb) in zip(a, b):
        assert (Ta is None) == (Tb is None)
        assert Ta is None or np.array_equal(Ta, Tb)
        assert ra == rb
        assert ma == mb
        assert len(xa) == len(xb)
        assert all(torch.equal(x, y) for x, y in zip(xa, xb))
        assert torch.equal(ga, gb)


def run_case(mapped, case, graphs, monkeypatch):
    """The loaded map relocalized on frame RELOC_AT, localization mode on,
    then the case's frames; eagerly through the parent's frame, or through
    ``FusedLocalization`` on the CPU. Returns (system, per-frame states)."""
    frames = mapped["frames"]
    with monkeypatch.context() as m:
        if graphs:
            m.setattr(CubemapSLAM, "_localization_graph",
                      lifted_localization_graph)
            m.setattr(CubemapSLAM, "_reloc_graph", lambda self: True)
        else:
            m.setattr(CubemapSLAM, "_track_frame_localization",
                      parent_track_frame_localization)
        s = fresh(mapped)
        states = []

        def track(i, ts):
            states.append(frame_state(s, s.track_fisheye(frames[i], ts)))

        track(RELOC_AT, 0.0)
        assert s.state == TrackState.OK
        s.activate_localization_mode()
        track(RELOC_AT + 1, 1.0)
        if case == "plain":
            for i in (RELOC_AT + 2, RELOC_AT + 3):
                track(i, float(i))
        elif case == "widen":
            s.velocity = (G.so3_exp(torch.tensor([WIDEN_PITCH, 0.0, 0.0])),
                          torch.zeros(3))
            track(RELOC_AT + 2, 2.0)
            track(RELOC_AT + 3, 3.0)
        elif case == "reference":
            s.last = s.last._replace(assoc=torch.full_like(s.last.assoc, -1))
            track(RELOC_AT + 2, 2.0)
            track(RELOC_AT + 3, 3.0)
        elif case == "mbvo":
            a = s.arena
            clean = a.lm_pos.clone()
            a.lm_pos.add_(MBVO_SIGMA * torch.randn(
                clean.shape, generator=torch.Generator().manual_seed(0)))
            track(RELOC_AT + 2, 2.0)
            a.lm_pos.copy_(clean)
            track(RELOC_AT + 3, 3.0)
        elif case == "lost":
            blank = np.full_like(frames[0], 20)
            states.append(frame_state(s, s.track_fisheye(blank, 2.0)))
            assert s.state == TrackState.LOST
            track(RELOC_AT + 3, 3.0)
    return s, states


# each case's frames' kinds after the relocalizing frame and the first
# localization-mode frame
CASE_KINDS = {"plain": ("localization", "localization"),
              "widen": ("localization", "localization"),
              "reference": ("localization", "localization"),
              "mbvo": ("vo", "reloc"), "lost": ("lost", "reloc")}
# kinds of the frames that only tracked, which the benchmark's plain_frame
# picks from the rows' other fields
PLAIN_KINDS = ("tracked", "localization", "vo")


@pytest.mark.parametrize("case", ["plain", "widen", "reference", "mbvo",
                                  "lost"])
def test_fused_localization_on_cpu_equals_parent(mapped, monkeypatch, case):
    """Each branch through ``FusedLocalization`` (on the CPU) bitwise equal
    to the parent's eager frame; which parts ran shows the branch, and each
    row's ``kind`` names it. ``plain_frame`` agrees with the kind on every
    frame but mbVO's relocalized one, which it counts as a plain frame
    (its row reads stage ``localization``, state OK)."""
    se, e = run_case(mapped, case, False, monkeypatch)
    sg, g = run_case(mapped, case, True, monkeypatch)
    same_states(e, g)
    assert se.fused_localization is None
    fl = sg.fused_localization
    assert fl is not None and fl.captures == fl.replays == 0
    rows = [r for r in sg.metrics if "frame" in r]
    loc = [r for r in rows if r.get("stage") == "localization"]
    assert all("graph_localization_captures" in r for r in rows[1:])
    assert all(r["stage"] == "localization" for r in rows[1:3])
    assert set(fl.outputs) >= {"l1"}
    if case == "plain":
        assert all(not r["vo"] and r["host_reads"] == 2 for r in loc)
        assert sg.state == TrackState.OK and not sg.mb_vo
    elif case == "widen":
        # the wrong velocity's frame reads L1's and L2's counts, then L3's
        assert loc[1]["host_reads"] == 3 and "l2" in fl.outputs
        assert sg.state == TrackState.OK
    elif case == "reference":
        # L1's, L2's and LR's reads, then L3's
        assert loc[1]["host_reads"] == 4 and not loc[1]["vo"]
        assert sg.state == TrackState.OK
        assert {"l2", "lr", "l3"} <= set(fl.outputs)
    elif case == "mbvo":
        assert loc[1]["vo"] and loc[2]["relocalized"]
        assert sg.state == TrackState.OK and not sg.mb_vo
        assert sg.fused_reloc is not None
    elif case == "lost":
        assert rows[-1]["stage"] == "reloc" and rows[-1]["relocalized"]
        assert "x" in fl.outputs and sg.state == TrackState.OK
    kinds = [r["kind"] for r in rows]
    assert kinds == ["reloc", "localization", *CASE_KINDS[case]]
    assert set(kinds) <= set(FRAME_KINDS)
    agree = [plain_frame(r) == (r["kind"] in PLAIN_KINDS) for r in rows]
    assert agree == [True, True, True, case != "mbvo"]


def test_reference_part_bitwise_eager_fallback(mapped):
    """Graph LR's part (``FusedLocalization.reference`` on the CPU, on
    graph L1's keypoints and last pose, after graphs L1 and L2 on a frame
    whose last association was emptied) against the eager
    reference-keyframe fallback as the parent ran it: ``track_reference_kf``
    against the system's reference keyframe, then ``optimize_pose`` from
    the last pose, and the packed vector of its read; bit for bit, and the
    arena untouched."""
    frames = mapped["frames"]
    s = fresh(mapped)
    assert s.track_fisheye(frames[RELOC_AT], 0.0) is not None
    s.activate_localization_mode()
    assert s.track_fisheye(frames[RELOC_AT + 1], 1.0) is not None
    s.last = s.last._replace(assoc=torch.full_like(s.last.assoc, -1))
    tables = [t.clone() for t in s.arena]
    fl = FusedLocalization(s)
    kp = fl.start(s, frames[RELOC_AT + 2], None)
    _, R_last, t_last, packed = fl.motion(s, 15.0)
    assert packed[0] < MIN_MATCHES and fl.motion(s, 30.0)[3][0] < MIN_MATCHES
    st, packed = fl.reference(s)
    k = s.kernels
    assoc, n = k.track_reference_kf(s.arena, kp, s.ref_kf)
    R, t, outlier, n_inl = k.optimize_pose(s.arena, kp, assoc, R_last,
                                           t_last)
    assert int(n) >= 15
    for x, y in zip(st, (assoc, n, R, t, outlier, n_inl)):
        assert torch.equal(x, y)
    assert torch.equal(packed, pack((n, n_inl), R, t))
    assert list(fl.outputs) == ["l1", "l2", "lr"]
    assert all(torch.equal(a, b) for a, b in zip(tables, s.arena))


# ---------------------------------------------------------------------------
# localization_motion against the JAX composition
# ---------------------------------------------------------------------------

def _j(x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def _jkp(kp):
    return JKeypoints(**{k: jnp.asarray(v)
                         for k, v in interop.keypoints_to_numpy(kp).items()})


@pytest.mark.parametrize("velocity", [False, True])
def test_localization_motion_against_jax(mapped, velocity):
    """The port's stage against ``system.py:528-550`` (``_predicted_pose``:
    the last pose re-anchored on its keyframe, the velocity composed in
    front, no SO(3) projection) and ``track_motion_fused`` on the arena,
    keypoints and last frame carried to JAX, at 15 and 30 px."""
    s = fresh(mapped)
    frames = mapped["frames"]
    assert s.track_fisheye(frames[RELOC_AT], 0.0) is not None
    s.activate_localization_mode()
    assert s.track_fisheye(frames[RELOC_AT + 1], 1.0) is not None
    if not velocity:
        s.velocity = None
    assert (s.velocity is not None) == velocity
    kp = s.extract(s.warp(torch.as_tensor(frames[RELOC_AT + 2])))
    jcfg = mapped["jcfg"]
    jk = JKernels(jcfg, JCam.from_config(jcfg))
    ja = JSM.MapArena(**{k: jnp.asarray(v) for k, v in
                         interop.arena_to_numpy(s.arena).items()})
    last = s.last
    R_last, t_last = JG.se3_compose(_j(last.rel_R), _j(last.rel_t),
                                    ja.kf_R[last.ref_kf],
                                    ja.kf_t[last.ref_kf])
    R_pred, t_pred = R_last, t_last
    if velocity:
        Rv, tv = (_j(x) for x in s.velocity)
        a = float(jcfg.motion_model_damping)
        if a < 1.0:
            Rv, tv = JG.se3_exp(a * JG.se3_log(Rv, tv))
        R_pred, t_pred = JG.se3_compose(Rv, tv, R_last, t_last)
    jkp_ = _jkp(kp)
    for radius in (15.0, 30.0):
        st, R_l, t_l, packed = s.kernels.localization_motion(
            s.arena, kp, *s._localization_inputs(), radius=radius)
        assoc_j, n_j, R_j, t_j, _, _ = jk.track_motion_fused(
            ja, jkp_, _j(last.assoc), _j(last.outlier), _j(last.kp.level),
            _j(last.kp.angle), R_pred, t_pred, radius=radius)
        # the port projects R_last onto SO(3); JAX's keeps the composed
        # rotation, which this map's chain has moved ~2e-5 from SO(3)
        np.testing.assert_allclose(R_l.numpy(), np.asarray(R_last),
                                   atol=1e-4)
        np.testing.assert_allclose(t_l.numpy(), np.asarray(t_last),
                                   atol=1e-5)
        assoc_t = st[0].numpy()
        assoc_j = np.asarray(assoc_j)
        rows = (assoc_t >= 0) | (assoc_j >= 0)
        assert rows.sum() >= MIN_MATCHES
        assert (assoc_t == assoc_j)[rows].mean() >= 0.98, radius
        n_t = int(st[1])
        assert abs(n_t - int(n_j)) <= 0.02 * int(n_j)
        np.testing.assert_allclose(st[2].numpy(), np.asarray(R_j),
                                   atol=1e-4)
        np.testing.assert_allclose(st[3].numpy(), np.asarray(t_j),
                                   atol=1e-4)
        h = packed.tolist()
        assert h[:2] == [float(st[1]), float(st[5])]
        assert h[2:] == st[2].reshape(-1).tolist() + st[3].tolist()


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

def test_moved_arena_raises_and_owners_drop_graphs(mapped, monkeypatch,
                                                   tmp_path):
    """A ``FusedLocalization`` whose arena was replaced raises before it
    runs; ``reset`` and ``load_map`` drop it."""
    monkeypatch.setattr(CubemapSLAM, "_localization_graph",
                        lifted_localization_graph)
    frames = mapped["frames"]
    s = fresh(mapped)
    assert s.track_fisheye(frames[RELOC_AT], 0.0) is not None
    s.activate_localization_mode()
    assert s.track_fisheye(frames[RELOC_AT + 1], 1.0) is not None
    fl = s.fused_localization
    assert isinstance(fl, FusedLocalization)
    s.arena = s.arena._replace(lm_visible=s.arena.lm_visible.clone())
    with pytest.raises(RuntimeError, match="moved"):
        s.track_fisheye(frames[RELOC_AT + 2], 2.0)
    s.drop_graphs()
    assert s.fused_localization is None
    assert s.track_fisheye(frames[RELOC_AT + 2], 2.0) is not None
    assert s.fused_localization is not None
    path = str(tmp_path / "map.npz")
    serialize.save_map(s, path)
    serialize.load_map(s, path)
    assert s.fused_localization is None
    s._fused_localization = FusedLocalization(s)
    s.reset()
    assert s.fused_localization is None


LOCALIZATION_SPANS = ("slam.frame", "warp", "extract", "extract.pyramid",
                      "extract.detect", "extract.select", "extract.describe",
                      "extract.rays", "localization", "pose_lm",
                      "local.select", "local.search", "local.optimize",
                      "local.counters", "host.read", "host.keep")


def test_eager_localization_frame_spans(mapped, monkeypatch):
    """A localization-mode frame on the CPU (the eager path) with no
    profiler calls no ``record_function``; under ``torch.profiler`` one
    ``slam.frame`` holds every span of the frame: ``warp``, ``extract``
    with its five steps, then ``localization`` with the 15 px search's pose
    LM, both reads (one ``host.read`` for each read the row counts),
    TrackLocalMap's ``local.*`` (the pose LM in ``local.optimize``) and the
    ``host.keep`` of what the frame keeps; the row's ``host.keep`` after
    it. The row's ``kind`` is ``localization``."""
    from test_torch_spans import host_spans, inside, raise_on_span
    from cubemapslam_tpu_torch import spans
    frames = mapped["frames"]
    s = fresh(mapped)
    with monkeypatch.context() as m:
        m.setattr(spans, "record_function", raise_on_span)
        assert s.track_fisheye(frames[RELOC_AT], 0.0) is not None
        s.activate_localization_mode()
        assert s.track_fisheye(frames[RELOC_AT + 1], 1.0) is not None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert s.track_fisheye(frames[RELOC_AT + 2], 2.0) is not None
    row = s.metrics[-1]
    assert row["kind"] == "localization" and row["graph_stages"] == {}
    ev = host_spans(prof, set(LOCALIZATION_SPANS))
    assert {n for n, _, _ in ev} == set(LOCALIZATION_SPANS)
    frame = [e for e in ev if e[0] == "slam.frame"]
    assert len(frame) == 1 and all(inside(e, frame[0]) for e in ev)
    (loc,) = [e for e in ev if e[0] == "localization"]
    (extract,) = [e for e in ev if e[0] == "extract"]
    assert all(inside(e, extract) for e in ev if e[0].startswith("extract."))
    assert extract[2] <= loc[1]
    reads = [e for e in ev if e[0] == "host.read"]
    assert len(reads) == row["host_reads"] == 2
    assert all(inside(e, loc) for e in reads)
    (optimize,) = [e for e in ev if e[0] == "local.optimize"]
    lm = [e for e in ev if e[0] == "pose_lm"]
    assert len(lm) == 2 and inside(lm[1], optimize)
    keep = [e for e in ev if e[0] == "host.keep"]
    assert len(keep) == 2 and inside(keep[0], loc)
    assert keep[1][1] >= loc[2]
