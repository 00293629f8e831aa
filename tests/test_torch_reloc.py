"""Port parity: relocalization, localization mode and map save/load.

One small map is made once by the port's ``CubemapSLAM`` on the CPU (160^2
faces, 600 features, 3 levels, K=24, L=4096, the repo's pretrained
vocabulary ``artifacts/vocab_synth_10k.npz``) over 12 cubemap frames that
the JAX package's renderer draws along ``forward_trajectory`` through a
seeded world, and saved with ``serialize.save_map``; the tests share it.

* ``reloc_candidates_fused`` on the map carried to JAX
  (``interop.arena_to_numpy``), for the 5 live keyframes nearest the
  replayed frame as candidates and
  the port's keypoints of a replayed frame, each candidate's PnP fed the
  minimal sets JAX draws with its keys: the same candidates pass, and each
  passing candidate's pose agrees within 1e-3 (rad, map units), its LM
  inlier count within 2%. ``reloc_widen_fused`` from the same input:
  associations equal on >= 98% of matched rows, pose within 1e-3, ``n3``
  within 2%.
* The port of ``tests/test_loop.py``'s relocalization: blackout -> LOST
  (no reset, the keyframe count unchanged) -> the replayed frame
  relocalizes, within 0.2 map units of the keyframe nearest it; the
  frame's host reads and eigh waits as stated.
* The port of ``tests/test_localization_mode.py``'s mbVO case: localization
  mode on a loaded map, relocalized at the replayed frame, tracks frames
  with the map unchanged; landmarks perturbed by sigma 0.5 engage mbVO (a
  ``vo`` row); restored, the next frame relocalizes and clears it.
* A fault of the reference, held so that it shows: on this map frame 7's
  only candidate, its own keyframe, fails in JAX and in the port alike,
  though its PnP keeps >= 100 inliers, because the pose-only LM after the
  PnP runs over all the candidate's matches (ORB-SLAM2's Relocalization
  keeps the PnP inliers only; ROADMAP Queue 3).
* 8 localization-mode frames keep every pose a rotation; without the
  projection of the predicted rotations onto SO(3) (the JAX package's
  numerics) the distance from SO(3) grows about 3x a frame.
* The vocabulary retrain on the live keyframes is bit-identical to JAX's
  training on the same descriptors, and the recomputed BoW table within
  1e-6 of JAX's rows.
* A map saved by JAX's ``save_map`` relocalizes in the port after
  ``load_map``; a map saved by the port loads in JAX's, equal table by
  table.
* The split of the candidate program: ``reloc_candidates_fused`` as a loop
  over ``reloc_candidate`` (each ok candidate's scores drawn from the
  generator, in candidate order) bitwise equal to the parent's
  formulation (a copy here), outputs and generator state; and
  ``sample_minimal_sets`` as ``draw_scores`` then ``select_minimal_sets``
  bitwise equal to its parent's body (a copy here).
* ``FusedReloc`` on the CPU (``CubemapSLAM._reloc_graph`` lifted by a
  monkeypatch; no graph, each part eagerly on the static buffers) bitwise
  equal to the eager ``_relocalize`` on the loaded map: the pose, the row
  (reads, scores), the last frame, every arena table and the generator
  state, over a relocalizing frame, a blank frame and a second
  relocalization; a moved arena raises and ``drop_graphs`` forgets it.
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import place as JPL
from cubemapslam_tpu import serialize as JSER
from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.features.extractor import Keypoints as JKeypoints
from cubemapslam_tpu.runtime.kernels import TrackingKernels as JKernels
from cubemapslam_tpu.solvers import sampling as JS
from cubemapslam_tpu.synth import Renderer, forward_trajectory, make_world
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu_torch import interop, serialize
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
from cubemapslam_tpu_torch import slam_map as TSM
from cubemapslam_tpu_torch.solvers import sampling as TS
from cubemapslam_tpu_torch.solvers.pnp import EIGH_WAITS, pnp_ransac

VOCAB = str(pathlib.Path(__file__).resolve().parents[1] / "artifacts"
            / "vocab_synth_10k.npz")
SMALL = dict(cube_face_w=160, cube_face_h=160, n_features=600, n_levels=3,
             max_keyframes=24, max_landmarks=4096, min_init_keypoints=80,
             min_init_matches=60, min_track_inliers=20,
             min_track_inliers_after_reloc=30, fps=5.0, vocab_path=VOCAB)
N_FRAMES = 12
REPLAY = 6
# landmark noise of the mbVO case: about 10 px at 3-6 map units on a
# 160-px face. At the JAX test's 0.12 (about 2.4 px) this map's frame 10
# keeps 10 or more pose inliers (no mbVO) and then goes LOST in
# TrackLocalMap, in JAX and in the port alike (test_mbvo_case_against_jax)
MBVO_SIGMA = 0.5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores, where more
    threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    jcfg = JConfig(**SMALL)
    pts, patches = make_world(np.random.default_rng(42), n=600)
    ren = Renderer(JCam.from_config(jcfg), jcfg, "cubemap")
    poses = forward_trajectory(N_FRAMES)
    imgs = [np.asarray(ren.render(pts, patches, R, t)) for R, t in poses]
    slam = CubemapSLAM(TConfig(**SMALL), device="cpu")
    for k, img in enumerate(imgs):
        slam.track_cubemap(torch.as_tensor(img), k / 10.0)
    assert slam.state == TrackState.OK
    snap = str(tmp_path_factory.mktemp("map") / "map.npz")
    serialize.save_map(slam, snap)
    # a copy: the arena's tensors change in place as later tests track
    arena_np = {k: v.copy()
                for k, v in interop.arena_to_numpy(slam.arena).items()}
    return dict(slam=slam, imgs=imgs, snap=snap, jcfg=jcfg,
                arena_np=arena_np)


def fresh(mapped, path=None):
    """A new port system with the saved map loaded (LOST)."""
    s = CubemapSLAM(TConfig(**SMALL), device="cpu")
    serialize.load_map(s, path or mapped["snap"])
    assert s.state == TrackState.LOST
    return s


def jarena(f):
    return JSM.MapArena(**{k: jnp.asarray(v) for k, v in f.items()})


def jkp(kp):
    return JKeypoints(**{k: jnp.asarray(v)
                         for k, v in interop.keypoints_to_numpy(kp).items()})


def j2t(x):
    a = np.array(x)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def pose_close(Rt, tt, Rj, tj, tol=1e-3):
    dR = np.asarray(Rt) @ np.asarray(Rj).T
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    return ang < tol and np.abs(np.asarray(tt) - np.asarray(tj)).max() < tol


def within_2pct(a, b):
    return abs(int(a) - int(b)) <= 0.02 * abs(int(b))


def near_live(arena_np, n=5):
    """The ``n`` live keyframe slots nearest the replayed frame by frame id
    (ties to the lower slot), in slot order: the keyframes that can
    relocalize it, as BoW would propose them. On this map the first 5 live
    slots give one passing candidate, in JAX and in the port alike
    (``test_first_live_slots_pass_one_candidate``), too few for the
    parity tests."""
    live = np.nonzero(arena_np["kf_valid"])[0]
    fids = arena_np["kf_frame_id"]
    near = sorted(live, key=lambda s: (abs(int(fids[s]) - REPLAY), s))[:n]
    return sorted(int(s) for s in near)


@pytest.fixture(scope="module")
def candidates(mapped):
    """The JAX reloc_candidates_fused over the 5 live keyframes nearest the
    replayed frame (``near_live``), the port's keypoints and the JAX-drawn
    minimal sets."""
    slam = mapped["slam"]
    kp = slam.extract(torch.as_tensor(mapped["imgs"][REPLAY]))
    cand = np.asarray(near_live(mapped["arena_np"]), np.int32)
    ok = np.ones(5, bool)
    ok[1] = False                                  # one skipped candidate
    jk = JKernels(mapped["jcfg"], JCam.from_config(mapped["jcfg"]))
    ja, jkpt = jarena(mapped["arena_np"]), jkp(kp)
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    out_j = jk.reloc_candidates_fused(ja, jkpt, jnp.asarray(cand),
                                      jnp.asarray(ok), keys)
    sets = []
    for c, key in zip(cand, keys):
        assoc, _ = jk.track_reference_kf(ja, jkpt, jnp.int32(c))
        has = (assoc >= 0) & jkpt.valid
        sets.append(j2t(JS.sample_minimal_sets(
            key, has, mapped["jcfg"].pnp_ransac_iters, 4)))
    return dict(kp=kp, cand=cand, ok=ok, out_j=out_j, sets=sets, jk=jk,
                ja=ja)


def test_reloc_candidates_fused(mapped, candidates):
    c = candidates
    tk = mapped["slam"].kernels
    ta = interop.arena_from_numpy(mapped["arena_np"])
    out_t = tk.reloc_candidates_fused(ta, c["kp"], c["cand"].tolist(),
                                      c["ok"].tolist(), None, sets=c["sets"])
    score_j = np.asarray(c["out_j"][4])
    score_t = out_t[4].numpy()
    np.testing.assert_array_equal(score_t >= 0, score_j >= 0)
    assert score_j[1] == -1 and (score_j >= 0).sum() >= 2
    for i in np.nonzero(score_j >= 0)[0]:
        assert pose_close(out_t[1][i], out_t[2][i], c["out_j"][1][i],
                          c["out_j"][2][i]), i
        assert within_2pct(score_t[i], score_j[i]), (score_t, score_j)


def test_reloc_widen_fused(mapped, candidates):
    c = candidates
    tk = mapped["slam"].kernels
    score_j = np.asarray(c["out_j"][4])
    i = int(np.argmax(score_j))
    assoc, R, t, outl = (c["out_j"][k][i] for k in range(4))
    a_j, R_j, t_j, _, n3_j = c["jk"].reloc_widen_fused(c["ja"], jkp(c["kp"]),
                                                       assoc, outl, R, t)
    a_t, R_t, t_t, _, n3_t = tk.reloc_widen_fused(
        interop.arena_from_numpy(mapped["arena_np"]), c["kp"], j2t(assoc),
        j2t(outl), j2t(R), j2t(t))
    a_j = np.asarray(a_j)
    matched = (a_t.numpy() >= 0) | (a_j >= 0)
    assert (a_t.numpy() == a_j)[matched].mean() >= 0.98
    assert pose_close(R_t, t_t, R_j, t_j)
    assert within_2pct(n3_t, n3_j) and int(n3_j) > \
        SMALL["min_track_inliers_after_reloc"]


def test_blackout_lost_replay(mapped):
    """``tests/test_loop.py:35-74`` on the port."""
    slam = mapped["slam"]
    live = int(slam.arena.kf_valid.sum())
    n_kf = slam.n_kf
    assert live > 5
    black = np.full(mapped["imgs"][0].shape, 20.0, np.float32)
    for k in range(2):
        assert slam.track_cubemap(torch.as_tensor(black), 2.0 + k) is None
    assert slam.state == TrackState.LOST and slam.n_kf == n_kf
    assert slam.metrics[-1]["reloc_candidates"] == 0
    T = slam.track_cubemap(torch.as_tensor(mapped["imgs"][REPLAY]), 4.0)
    assert slam.state == TrackState.OK and T is not None
    row = slam.metrics[-1]
    assert row["relocalized"] and row["stage"] == "reloc"
    assert row["host_reads"] == 3          # candidates, scores, one widening
    assert row["eigh_waits"] == EIGH_WAITS * row["reloc_candidates"]
    np.testing.assert_allclose(T[:3, 3], slam.last.t.numpy(), atol=1e-6)
    fids = slam.arena.kf_frame_id.numpy()
    valid = slam.arena.kf_valid.numpy()
    k_near = int(np.argmin(np.where(valid, np.abs(fids - REPLAY), 1e9)))
    assert np.linalg.norm(slam.last.t.numpy()
                          - slam.arena.kf_t[k_near].numpy()) < 0.2
    # tracking goes on from the relocalized pose
    assert slam.track_cubemap(torch.as_tensor(mapped["imgs"][REPLAY + 1]),
                              4.1) is not None


def test_localization_mode_and_mbvo(mapped):
    """``tests/test_localization_mode.py:98-147`` on the port, on the loaded
    map, relocalized at the replayed frame. The landmarks are moved by
    sigma ``MBVO_SIGMA``, decisively outside the chi2 gate (the JAX test's
    intent), so that fewer than 10 of the frame's matches stay inliers."""
    slam = fresh(mapped)
    imgs = mapped["imgs"]
    assert slam.track_cubemap(torch.as_tensor(imgs[REPLAY]), 0.0) \
        is not None
    slam.activate_localization_mode()
    a = slam.arena
    before = (slam.n_kf, int(a.kf_valid.sum()), int(a.lm_valid.sum()))
    for k in range(REPLAY + 1, 11):
        assert slam.track_cubemap(torch.as_tensor(imgs[k]), k) is not None
        row = slam.metrics[-1]
        assert row["stage"] == "localization" and not row["vo"]
    a = slam.arena
    assert (slam.n_kf, int(a.kf_valid.sum()), int(a.lm_valid.sum())) \
        == before
    clean = a.lm_pos.clone()
    a.lm_pos.add_(MBVO_SIGMA * torch.randn(
        clean.shape, generator=torch.Generator().manual_seed(0)))
    slam.track_cubemap(torch.as_tensor(imgs[10]), 11.0)
    assert slam.mb_vo and slam.metrics[-1]["vo"]
    a.lm_pos.copy_(clean)
    slam.track_cubemap(torch.as_tensor(imgs[10]), 12.0)
    assert slam.state == TrackState.OK and not slam.mb_vo
    assert slam.metrics[-1]["relocalized"]
    slam.deactivate_localization_mode()
    assert not slam.localization_only


def _perturbed_frame(system, imgs, noise, to_img, perturb):
    """Relocalize ``system`` (a loaded map) at the replayed frame, track
    frames up to 10 in localization mode, move the landmarks by ``noise``
    (``perturb``) and track frame 10 again: (whether each earlier frame
    tracked, the state and mbVO after the perturbed frame)."""
    ok = [system.track_cubemap(to_img(imgs[REPLAY]), 0.0) is not None]
    system.activate_localization_mode()
    ok += [system.track_cubemap(to_img(imgs[k]), k) is not None
           for k in range(REPLAY + 1, 11)]
    perturb(system, noise)
    system.track_cubemap(to_img(imgs[10]), 11.0)
    return ok, system.state.name, bool(system.mb_vo)


@pytest.mark.parametrize("sigma", [0.12, MBVO_SIGMA])
def test_mbvo_case_against_jax(mapped, sigma):
    """The mbVO case's perturbed frame on this map, in the port and in the
    JAX system on the same saved map and the same landmark noise: the same
    outcome and counts. At the JAX test's sigma 0.12 the motion search's
    pose keeps at least 10 inliers (no mbVO) and TrackLocalMap then ends
    below min_track_inliers (LOST) in both, with the port's matches and
    final inliers those of JAX, which is why the port's mbVO case takes
    ``MBVO_SIGMA``; there both engage mbVO with the same inliers."""
    from cubemapslam_tpu.runtime.system import CubemapSLAM as JSLAM
    noise = sigma * torch.randn(
        mapped["slam"].arena.lm_pos.shape,
        generator=torch.Generator().manual_seed(0))

    def perturb_t(s, n):
        s.arena.lm_pos.add_(n)

    stages = {}

    def perturb_j(s, n):
        stages.clear()
        s.arena = s.arena._replace(lm_pos=s.arena.lm_pos
                                   + jnp.asarray(n.numpy()))

    st = fresh(mapped)
    out_t = _perturbed_frame(st, mapped["imgs"], noise, torch.as_tensor,
                             perturb_t)
    row_t = st.metrics[-1]
    js = JSLAM(mapped["jcfg"])
    JSER.load_map(js, mapped["snap"])
    k = js.kernels
    motion, local = k.track_motion_fused, k.track_local_fused

    def motion_rec(*a, **kw):
        out = motion(*a, **kw)
        stages["motion"] = (int(out[1]), int(out[5]))    # matches, inliers
        return out

    def local_rec(*a, **kw):
        out = local(*a, **kw)
        stages["local"] = int(out[5])
        return out

    k.track_motion_fused, k.track_local_fused = motion_rec, local_rec
    out_j = _perturbed_frame(js, mapped["imgs"], noise, jnp.asarray,
                             perturb_j)
    assert out_t == out_j, (out_t, out_j)
    assert all(out_t[0])
    if sigma == 0.12:
        assert out_t[1:] == ("LOST", False), out_t
        n_j, inl_j = stages["motion"]
        assert inl_j >= 10 and stages["local"] < SMALL["min_track_inliers"]
        assert (row_t["matches"], row_t["inliers"]) == \
            (n_j, stages["local"]), (row_t, stages)
    else:
        assert out_t[1:] == ("OK", True), out_t
        row_j = js.metrics[-1]
        assert row_t["vo"] and row_j["vo"]
        assert row_t["inliers"] == row_j["inliers"] < 10, (row_t, row_j)


def test_first_live_slots_pass_one_candidate(mapped, candidates):
    """Why the parity tests take ``near_live``: on this map the first 5
    live slots as candidates (the second skipped) leave one passing
    candidate in JAX and in the port alike (on the same JAX-drawn minimal
    sets), where those tests need at least two."""
    live = np.nonzero(mapped["arena_np"]["kf_valid"])[0][:5]
    cand = np.asarray(live, np.int32)
    jk, ja, kp = candidates["jk"], candidates["ja"], candidates["kp"]
    jkpt = jkp(kp)
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    out_j = jk.reloc_candidates_fused(ja, jkpt, jnp.asarray(cand),
                                      jnp.asarray(candidates["ok"]), keys)
    sets = []
    for c, key in zip(cand, keys):
        assoc, _ = jk.track_reference_kf(ja, jkpt, jnp.int32(c))
        has = (assoc >= 0) & jkpt.valid
        sets.append(j2t(JS.sample_minimal_sets(
            key, has, mapped["jcfg"].pnp_ransac_iters, 4)))
    out_t = mapped["slam"].kernels.reloc_candidates_fused(
        interop.arena_from_numpy(mapped["arena_np"]), kp, cand.tolist(),
        candidates["ok"].tolist(), None, sets=sets)
    score_j, score_t = np.asarray(out_j[4]), out_t[4].numpy()
    np.testing.assert_array_equal(score_t >= 0, score_j >= 0)
    assert (score_j >= 0).sum() == 1, score_j


def test_reloc_lm_over_all_matches_fails_as_jax(mapped):
    """A known fault of the reference, held so that it shows (ROADMAP
    Queue 3). On this map frame 7 is a keyframe, and its only BoW
    candidate on a loaded map is that keyframe, whose observations hold
    gross outliers (points far off or behind the face they were matched
    on). The candidate's PnP RANSAC keeps >= 100 inliers, but the pose-only
    LM after it runs over all the candidate's matches (JAX
    ``runtime/kernels.py:515-518``) and ends below 10 inliers, in JAX and
    in the port alike, so the frame does not relocalize; the same LM over
    the PnP inliers only (ORB-SLAM2's Relocalization) keeps >= 100."""
    from cubemapslam_tpu.optim import pose_opt as JPO
    from cubemapslam_tpu_torch import camera as TC
    slam = fresh(mapped)
    imgs = mapped["imgs"]
    assert slam.track_cubemap(torch.as_tensor(imgs[7]), 0.0) is None
    row = slam.metrics[-1]
    assert row["reloc_candidates"] == 1 and row["reloc_scores"][0] == -1
    k, a = slam.kernels, slam.arena
    kp = slam.extract(torch.as_tensor(imgs[7]))
    fids = a.kf_frame_id.numpy()
    slot = int(np.nonzero(a.kf_valid.numpy() & (fids == 7))[0][0])
    assoc, n = k.track_reference_kf(a, kp, slot)
    has = (assoc >= 0) & kp.valid
    lvl_sig2 = k.level_sigma2[kp.level.clamp(0, SMALL["n_levels"] - 1)]
    res = pnp_ransac(slam.cam, torch.Generator().manual_seed(0),
                     a.lm_pos[assoc.clamp(min=0)], kp.rays, kp.uv, lvl_sig2,
                     has, n_iters=slam.cfg.pnp_ransac_iters)
    assert bool(res.success) and int(res.n_inliers) >= 100
    n2 = int(k.optimize_pose(a, kp, assoc, res.R, res.t)[3])
    jcam = JCam.from_config(mapped["jcfg"])
    valid = has & a.lm_valid[assoc.clamp(min=0)]
    jn2 = int(JPO.pose_optimization(
        jcam, jnp.asarray(res.R.numpy()), jnp.asarray(res.t.numpy()),
        jnp.asarray(a.lm_pos[assoc.clamp(min=0)].numpy()),
        jnp.asarray(kp.face.numpy().astype(np.int32)),
        jnp.asarray(TC.cubemap_uv_to_in_face(slam.cam, kp.uv).numpy()),
        jnp.asarray(k.inv_level_sigma2[kp.level.clamp(
            0, SMALL["n_levels"] - 1)].numpy()),
        jnp.asarray(valid.numpy()))[3])
    assert n2 < 10 and jn2 < 10, (n2, jn2)
    inl = torch.where(res.inliers, assoc, torch.full_like(assoc, -1))
    assert int(k.optimize_pose(a, kp, inl, res.R, res.t)[3]) >= 100


@pytest.mark.parametrize("projected", [True, False])
def test_localization_poses_stay_rotations(mapped, monkeypatch, projected):
    """8 localization-mode frames on the loaded map: each pose's rotation is
    orthonormal to float32 rounding. Without the projection of the
    predicted rotations onto SO(3) (the JAX package's numerics), its
    distance from SO(3) grows about 3x a frame (ROADMAP Queue 3)."""
    from cubemapslam_tpu_torch import geometry
    if not projected:
        monkeypatch.setattr(geometry, "so3_project", lambda R: R)
    s = fresh(mapped)
    assert s.track_cubemap(torch.as_tensor(mapped["imgs"][3]), 0.0) \
        is not None
    s.activate_localization_mode()
    errs = []
    for k in range(4, 12):
        T = s.track_cubemap(torch.as_tensor(mapped["imgs"][k]), float(k))
        assert T is not None
        errs.append(np.abs(T[:3, :3].T @ T[:3, :3] - np.eye(3)).max())
    if projected:
        assert max(errs) < 1e-6, errs
    else:
        assert errs[-1] > 1e-4 and errs[-1] > 100 * errs[0], errs


def test_vocabulary_retrain_and_bow_table(mapped):
    """``_maybe_retrain_vocab`` on the loaded map (as if its vocabulary were
    the bootstrap one): the vocabulary JAX trains on the same live
    keyframes' descriptors (``system.py:757-766``), bit for bit, and every
    slot's BoW row within 1e-6 of JAX's ``vmap`` of ``bow_vector``."""
    s = fresh(mapped)
    s._vocab_is_bootstrap = True
    s._row = dict(host_reads=0)
    s._maybe_retrain_vocab(live_kf=s.cfg.vocab_retrain_keyframes - 1)
    assert s._vocab_is_bootstrap                  # below the gate
    s._maybe_retrain_vocab(live_kf=s.cfg.vocab_retrain_keyframes)
    assert not s._vocab_is_bootstrap and s._row["host_reads"] == 2
    a = mapped["arena_np"]
    train = a["kf_desc"][a["kf_valid"]].reshape(-1, 8)[
        a["kf_kp_valid"][a["kf_valid"]].reshape(-1)]
    vj = JPL.train_vocabulary(train, k=s.cfg.vocab_branching,
                              depth=s.cfg.vocab_depth)
    vt = interop.vocab_to_numpy(s.vocab)
    for cj, ct in zip(vj.centers, vt["centers"]):
        np.testing.assert_array_equal(ct, np.asarray(cj))
    rows = jax.vmap(lambda d, v: JPL.bow_vector(vj, d, v))(
        jnp.asarray(a["kf_desc"]), jnp.asarray(a["kf_kp_valid"]))
    rows = np.where(a["kf_valid"][:, None], np.asarray(rows), 0.0)
    np.testing.assert_allclose(s.bow_table.numpy(), rows, atol=1e-6)


def test_map_files_cross(mapped, tmp_path):
    slam = mapped["slam"]
    snap = np.load(mapped["snap"])
    # the port's file in JAX's load_map, table by table
    sys_j = types.SimpleNamespace()
    JSER.load_map(sys_j, mapped["snap"])
    for k, v in sys_j.arena._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), snap[f"arena_{k}"], k)
        assert np.asarray(v).dtype == snap[f"arena_{k}"].dtype
    assert np.asarray(sys_j.arena.kf_desc).dtype == np.uint32
    assert sys_j.vocab.n_words == 10000 and sys_j.n_kf == int(snap["n_kf"])
    np.testing.assert_array_equal(np.asarray(sys_j.bow_table),
                                  snap["bow_table"])
    # JAX's save_map of the same map relocalizes in the port
    v = interop.vocab_to_numpy(slam.vocab)
    src = types.SimpleNamespace(
        arena=jarena(mapped["arena_np"]), n_kf=slam.n_kf,
        frame_id=slam.frame_id, bow_table=jnp.asarray(snap["bow_table"]),
        vocab=JPL.Vocabulary(tuple(jnp.asarray(c) for c in v["centers"]),
                             jnp.asarray(v["idf"]), v["k"], v["depth"]))
    path = str(tmp_path / "jax_map.npz")
    JSER.save_map(src, path)
    port = fresh(mapped, path)
    assert port.track_cubemap(torch.as_tensor(mapped["imgs"][8]), 0.0) \
        is not None
    assert port.metrics[-1]["relocalized"]


def parent_reloc_candidates_fused(k, arena, kp_cur, cand_idx, cand_ok,
                                  generator):
    """``TrackingKernels.reloc_candidates_fused`` as it was before the
    split (a copy): the candidates' PnP drawing its own sets."""
    n_kp, dev = kp_cur.n, kp_cur.uv.device
    lvl_sig2 = k.level_sigma2[kp_cur.level.clamp(0, k.cfg.n_levels - 1)]
    outs = []
    for c, ok_c in zip(cand_idx, cand_ok):
        if not ok_c:
            outs.append((
                torch.full((n_kp,), TSM.NO_LM, dtype=torch.int64,
                           device=dev),
                torch.eye(3, device=dev), torch.zeros(3, device=dev),
                torch.zeros(n_kp, dtype=torch.bool, device=dev),
                torch.full((), -1, dtype=torch.int64, device=dev)))
            continue
        assoc, n = k.track_reference_kf(arena, kp_cur, int(c))
        has = (assoc >= 0) & kp_cur.valid
        res = pnp_ransac(k.cam, generator,
                         arena.lm_pos[assoc.clamp(min=0)], kp_cur.rays,
                         kp_cur.uv, lvl_sig2, has,
                         n_iters=k.cfg.pnp_ransac_iters)
        R, t, outlier, n2 = k.optimize_pose(arena, kp_cur, assoc, res.R,
                                            res.t)
        good = (n >= 15) & res.success & (n2 >= 10)
        outs.append((assoc, R, t, outlier,
                     torch.where(good, n2, torch.full_like(n2, -1))))
    return tuple(torch.stack(x) for x in zip(*outs))


def parent_sample_minimal_sets(generator, valid, n_iters, k):
    """``sample_minimal_sets`` as it was before the split (a copy)."""
    n = valid.shape[0]
    scores = torch.rand((n_iters, n), generator=generator,
                        device=generator.device).to(valid.device)
    scores = torch.where(valid[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    return idx[:, :k]


@pytest.mark.parametrize("n_valid", [0, 3, 150, 600])
def test_sample_minimal_sets_split(n_valid):
    rng = np.random.default_rng(n_valid)
    valid = torch.zeros(600, dtype=torch.bool)
    valid[torch.as_tensor(rng.permutation(600)[:n_valid])] = True
    gens = [torch.Generator().manual_seed(3) for _ in range(3)]
    a = parent_sample_minimal_sets(gens[0], valid, 300, 4)
    b = TS.sample_minimal_sets(gens[1], valid, 300, 4)
    c = TS.select_minimal_sets(TS.draw_scores(gens[2], 300, 600, "cpu"),
                               valid, 4)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert all(torch.equal(gens[0].get_state(), g.get_state())
               for g in gens[1:])


def test_reloc_candidate_loop_against_parent(mapped):
    """The split loop against the parent's formulation on the map: the 5
    live keyframes nearest the replayed frame as candidates, one not ok,
    the replayed frame's keypoints, each run from a generator seeded
    alike."""
    slam = mapped["slam"]
    kp = slam.extract(torch.as_tensor(mapped["imgs"][REPLAY]))
    live = near_live(mapped["arena_np"])
    ok = [True, False, True, True, True]
    arena = interop.arena_from_numpy(mapped["arena_np"])
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    new = slam.kernels.reloc_candidates_fused(arena, kp, live, ok, gens[0])
    old = parent_reloc_candidates_fused(slam.kernels, arena, kp, live, ok,
                                        gens[1])
    assert all(torch.equal(x, y) for x, y in zip(new, old))
    assert (new[4] >= 0).sum() >= 2 and int(new[4][1]) == -1
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def _reloc_state(s, T):
    row = {k: v for k, v in s.metrics[-1].items()
           if not k.startswith("graph_") and not k.endswith("_ms")}
    tensors = [getattr(s.arena, k) for k in s.arena._fields]
    if s.last is not None:
        tensors += [s.last.assoc, s.last.outlier, s.last.R, s.last.t]
    return T, row, tensors, s.generator.get_state()


def test_fused_reloc_on_cpu_equals_eager(mapped, monkeypatch):
    imgs = mapped["imgs"]
    black = np.full(imgs[0].shape, 20.0, np.float32)
    frames = [(imgs[REPLAY], 4.0), (black, 5.0), (imgs[REPLAY + 2], 6.0)]
    runs = {}
    for graph in (False, True):
        s = fresh(mapped)
        if graph:
            monkeypatch.setattr(CubemapSLAM, "_reloc_graph",
                                lambda self: True)
        runs[graph] = (s, [_reloc_state(
            s, s.track_cubemap(torch.as_tensor(img), ts))
            for img, ts in frames])
    (se, e), (sg, g) = runs[False], runs[True]
    assert se.fused_reloc is None and sg.fused_reloc is not None
    for (Te, re, xe, ge), (Tg, rg, xg, gg) in zip(e, g):
        assert (Te is None) == (Tg is None)
        assert Te is None or np.array_equal(Te, Tg)
        assert re == rg
        assert all(torch.equal(x, y) for x, y in zip(xe, xg))
        assert torch.equal(ge, gg)
    relocs = [m for m in sg.metrics if m.get("stage") == "reloc"]
    assert [m["relocalized"] for m in relocs] == [True, True]
    assert all(m["graph_reloc_captures"] == m["graph_reloc_replays"] == 0
               for m in relocs)
    fr = sg.fused_reloc
    assert fr.inputs["scores"].shape == (sg.cfg.pnp_ransac_iters,
                                         sg.cfg.n_features)
    # a moved arena raises; drop_graphs forgets the graphs
    sg.state = TrackState.LOST
    sg.arena = sg.arena._replace(lm_pos=sg.arena.lm_pos.clone())
    with pytest.raises(RuntimeError, match="moved"):
        sg.track_cubemap(torch.as_tensor(imgs[REPLAY]), 7.0)
    sg.drop_graphs()
    assert sg.fused_reloc is None
