"""Port parity for the tracking stages and the whole tracked frame.

One map is built once at small size (128^2 faces, 256 features, 4 levels,
K=16, L=2048) with the port's ``build_map`` on a seeded billboard world:
keyframes at frames 0, 3, 6, 9 of a forward trajectory. It is given to both
packages (``interop.arena_to_numpy``), together with the keypoints of the
next rendered frames as the port extracts them, so that every stage of
``TrackingKernels`` runs on identical inputs in both. ``MapTracker`` is then
held over 3 rendered frames against the same chain of JAX calls (warp,
extract, ``track_frame_full``), each package extracting on its own.

Tolerances: poses within 1e-3 (rotation angle in rad, translation in map
units); associations equal on >= 98% of the rows matched by either (in the
chain, compared per landmark by the keypoint position it went to, since
keypoint rows may swap between the two extractors); match counts within
2%; every other count, the local keyframe mask, ``pkf_max`` and the
selected landmark set exactly equal; visible/found counters equal on >= 98%
of the landmarks; arena tables written by ``insert_keyframe`` exactly
equal, the landmark statistics it refreshes within 1e-5 and their
descriptors bitwise.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu import warp as JW
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.features.extractor import Keypoints as JKeypoints
from cubemapslam_tpu.features.extractor import build_extractor
from cubemapslam_tpu.runtime.kernels import TrackingKernels as JKernels
from cubemapslam_tpu_torch import interop
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.geometry import se3_compose, se3_inverse
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.tracking import MapTracker

SMALL = dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4,
             max_keyframes=16, max_landmarks=2048)
KF_STRIDE, N_KF = 3, 4
NEXT = 10                         # the first frame after the last keyframe
MATCH_COUNTS = (0, 1, 2, 8, 9, 10)   # packed entries that count matches


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
def scene():
    tcfg, jcfg = TConfig(**SMALL), JConfig(**SMALL)
    tracker = MapTracker(tcfg, device="cpu")
    poses = S.forward_trajectory(NEXT + 4, step=0.04, yaw_rate=0.003)
    world = S.make_world(np.random.default_rng(11), n=500,
                         centers=S.camera_centres(poses),
                         fx=tcfg.cube_face_w / 2.0)
    built = S.build_map(tracker, world, poses, N_KF, kf_stride=KF_STRIDE)
    render = S.Renderer(tracker.cam, tcfg)
    frames = {i: S.to_u8(render.render(*world, *poses[i])[0])
              for i in range(NEXT, NEXT + 3)}
    frames["blank"] = np.zeros_like(frames[NEXT])
    kps = {k: tracker.extract(tracker.warp(torch.as_tensor(f)))
           for k, f in frames.items()}
    jcam = JC.CubemapCamera.from_config(jcfg)
    return dict(tcfg=tcfg, jcfg=jcfg, tracker=tracker, poses=poses,
                built=built, frames=frames, kps=kps,
                arena_np=interop.arena_to_numpy(tracker.arena),
                jcam=jcam, jk=JKernels(jcfg, jcam))


def jarena(f):
    return JSM.MapArena(**{k: jnp.asarray(v) for k, v in f.items()})


def jkp(kp):
    return JKeypoints(**{k: jnp.asarray(v)
                         for k, v in interop.keypoints_to_numpy(kp).items()})


def t2j(x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def j2t(x):
    a = np.array(x)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def assoc_agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    matched = (a >= 0) | (b >= 0)
    assert matched.sum() > 0
    return (a == b)[matched].mean()


def within_2pct(a, b):
    return abs(int(a) - int(b)) <= 0.02 * abs(int(b))


def pose_close(Rt, tt, Rj, tj, tol=1e-3, tol_t=None):
    dR = np.asarray(JG.so3_log(jnp.asarray(
        np.asarray(Rt, np.float32) @ np.asarray(Rj, np.float32).T)))
    tol_t = tol if tol_t is None else tol_t
    return (np.linalg.norm(dR) < tol
            and np.abs(np.asarray(tt) - np.asarray(tj)).max() < tol_t)


def gt_pose(scene, i):
    R, t = scene["poses"][i]
    return torch.as_tensor(R), torch.as_tensor(t)


def motion_inputs(scene):
    last = scene["tracker"].last
    return (last.assoc, last.outlier, last.kp.level, last.kp.angle)


def test_build_map(scene):
    built, tr = scene["built"], scene["tracker"]
    assert built.frames == (0, 3, 6, 9)
    assert built.n_landmarks == int(tr.arena.lm_valid.sum()) > 150
    assert all(n > 20 for n in built.linked[1:])
    assert int(tr.arena.kf_valid.sum()) == N_KF
    # the newest keyframe shares landmarks with the others
    assert (tr.covis[N_KF - 1, :N_KF - 1] > 20).all()


@pytest.mark.parametrize("radius", [15.0, 30.0])
def test_track_last_frame(scene, radius):
    tk, jk = scene["tracker"].kernels, scene["jk"]
    kp = scene["kps"][NEXT]
    R, t = gt_pose(scene, NEXT - 1)
    ta = interop.arena_from_numpy(scene["arena_np"])
    a_t, n_t = tk.track_last_frame(ta, kp, *motion_inputs(scene), R, t,
                                   radius=radius)
    a_j, n_j = jk.track_last_frame(
        jarena(scene["arena_np"]), jkp(kp),
        *(t2j(x) for x in motion_inputs(scene)), t2j(R), t2j(t),
        radius=radius)
    assert int(n_j) > 30
    assert within_2pct(n_t, n_j)
    assert assoc_agree(a_t.numpy(), a_j) >= 0.98


@pytest.mark.parametrize("ref_kf", [N_KF - 1, 1])
def test_track_reference_kf(scene, ref_kf):
    tk, jk = scene["tracker"].kernels, scene["jk"]
    kp = scene["kps"][NEXT]
    a_t, n_t = tk.track_reference_kf(
        interop.arena_from_numpy(scene["arena_np"]), kp, ref_kf)
    a_j, n_j = jk.track_reference_kf(jarena(scene["arena_np"]), jkp(kp),
                                     jnp.int32(ref_kf))
    assert int(n_j) > 10
    assert within_2pct(n_t, n_j)
    assert assoc_agree(a_t.numpy(), a_j) >= 0.98


@pytest.fixture(scope="module")
def motion_ref(scene):
    """The JAX motion match and pose of frame NEXT, the input of the
    later stages (both packages start from it)."""
    jk, kp = scene["jk"], jkp(scene["kps"][NEXT])
    R, t = gt_pose(scene, NEXT - 1)
    ja = jarena(scene["arena_np"])
    assoc, n = jk.track_last_frame(ja, kp,
                                   *(t2j(x) for x in motion_inputs(scene)),
                                   t2j(R), t2j(t))
    Rj, tj, out, n_inl = jk.optimize_pose(ja, kp, assoc, t2j(R), t2j(t))
    return dict(assoc=assoc, R0=R, t0=t, R=Rj, t=tj, outlier=out,
                n_inl=n_inl)


def test_optimize_pose(scene, motion_ref):
    tk, kp = scene["tracker"].kernels, scene["kps"][NEXT]
    R, t, out, n = tk.optimize_pose(
        interop.arena_from_numpy(scene["arena_np"]), kp,
        j2t(motion_ref["assoc"]), motion_ref["R0"], motion_ref["t0"])
    assert pose_close(R, t, motion_ref["R"], motion_ref["t"])
    assert within_2pct(n, motion_ref["n_inl"])
    assert int(n) > 30
    assert (out.numpy() == np.asarray(motion_ref["outlier"])).mean() >= 0.98
    # the outliers are associated keypoints the solve rejected
    assert not (out & (j2t(motion_ref["assoc"]) < 0)).any()


def _local_inputs(motion_ref):
    assoc = np.where(np.asarray(motion_ref["outlier"]), -1,
                     np.asarray(motion_ref["assoc"])).astype(np.int32)
    return assoc


def test_select_local_landmarks(scene, motion_ref):
    tr, jk = scene["tracker"], scene["jk"]
    assoc = _local_inputs(motion_ref)
    sel, ok, mask, pkf, votes = tr.kernels.select_local_landmarks(
        interop.arena_from_numpy(scene["arena_np"]), j2t(assoc),
        covis=tr.covis)
    jsel, jok, jmask, jpkf, jvotes = jk.select_local_landmarks(
        jarena(scene["arena_np"]), jnp.asarray(assoc))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(pkf) == int(jpkf) and int(votes) == int(jvotes) > 0
    assert int(ok.sum()) == int(jok.sum()) > 50
    assert (set(sel[ok].tolist())
            == set(np.asarray(jsel)[np.asarray(jok)].tolist()))


@pytest.mark.parametrize("radius_scale", [1.0, 3.0])
def test_search_local_points(scene, motion_ref, radius_scale):
    tr, jk = scene["tracker"], scene["jk"]
    kp = scene["kps"][NEXT]
    assoc = _local_inputs(motion_ref)
    ja = jarena(scene["arena_np"])
    jsel, jok, _, _, _ = jk.select_local_landmarks(ja, jnp.asarray(assoc))
    a_j, vis_j, diag_j = jk.search_local_points(
        ja, jkp(kp), jnp.asarray(assoc), jsel, jok, motion_ref["R"],
        motion_ref["t"], radius_scale=radius_scale)
    a_t, vis_t, diag_t = tr.kernels.search_local_points(
        interop.arena_from_numpy(scene["arena_np"]), kp, j2t(assoc),
        j2t(jsel), j2t(jok), j2t(motion_ref["R"]), j2t(motion_ref["t"]),
        radius_scale=radius_scale)
    assert int(diag_j[2]) > 0
    assert all(within_2pct(a, b) for a, b in zip(diag_t, np.asarray(diag_j)))
    assert assoc_agree(a_t.numpy(), a_j) >= 0.98
    assert (vis_t.numpy() == np.asarray(vis_j)).mean() >= 0.98


def test_update_found_counters(scene, motion_ref):
    tr, jk = scene["tracker"], scene["jk"]
    L = scene["arena_np"]["lm_valid"].shape[0]
    vis = np.random.default_rng(4).integers(0, 2, L).astype(np.int32)
    ref = jk.update_found_counters(jarena(scene["arena_np"]),
                                   motion_ref["assoc"],
                                   motion_ref["outlier"], jnp.asarray(vis))
    ta = interop.arena_from_numpy(scene["arena_np"])
    tr.kernels.update_found_counters(ta, j2t(motion_ref["assoc"]),
                                     j2t(motion_ref["outlier"]),
                                     torch.as_tensor(vis, dtype=torch.int64))
    np.testing.assert_array_equal(ta.lm_visible.numpy(),
                                  np.asarray(ref.lm_visible))
    np.testing.assert_array_equal(ta.lm_found.numpy(),
                                  np.asarray(ref.lm_found))
    assert (np.asarray(ref.lm_found) > 1).sum() > 30


def test_insert_keyframe(scene, motion_ref):
    tr, jk = scene["tracker"], scene["jk"]
    kp = scene["kps"][NEXT]
    slot, fid, ts = N_KF, NEXT, NEXT / 30.0
    ref = jk.insert_keyframe(jarena(scene["arena_np"]), jnp.int32(slot),
                             jkp(kp), motion_ref["assoc"],
                             motion_ref["outlier"], motion_ref["R"],
                             motion_ref["t"], jnp.int32(fid),
                             jnp.float32(ts))
    ta = interop.arena_from_numpy(scene["arena_np"])
    tr.kernels.insert_keyframe(ta, slot, kp, j2t(motion_ref["assoc"]),
                               j2t(motion_ref["outlier"]),
                               j2t(motion_ref["R"]), j2t(motion_ref["t"]),
                               fid, ts)
    ours = interop.arena_to_numpy(ta)
    for k, v in ref._asdict().items():
        v = np.asarray(v)
        if k in ("lm_normal", "lm_min_dist", "lm_max_dist"):
            np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert ours["kf_valid"][slot]
    assert not np.array_equal(ours["lm_normal"],
                              scene["arena_np"]["lm_normal"])


def frame_full_inputs(scene, path):
    """(kp, last_assoc, last_outlier, level, angle, rel_R, rel_t, last_ref,
    vel_R, vel_t, gain, ref_kf) of frame NEXT for one branch path."""
    last = scene["tracker"].last
    kp = scene["kps"]["blank" if path == "blank" else NEXT]
    assoc = last.assoc
    if path == "reference_kf":
        assoc = torch.full_like(assoc, -1)
    # one frame of motion along the trajectory as the velocity
    Ra, ta_ = gt_pose(scene, NEXT - 2)
    Rb, tb = gt_pose(scene, NEXT - 1)
    vel_R, vel_t = se3_compose(Rb, tb, *se3_inverse(Ra, ta_))
    return (kp, assoc, last.outlier, last.kp.level, last.kp.angle,
            last.rel_R, last.rel_t, last.ref_kf, vel_R, vel_t, 1.0,
            last.ref_kf)


@pytest.mark.parametrize("path", ["steady", "reference_kf", "blank"])
def test_track_frame_full(scene, path):
    tr, jk = scene["tracker"], scene["jk"]
    (kp, assoc, outl, lev, ang, rel_R, rel_t, last_ref, vel_R, vel_t, gain,
     ref_kf) = frame_full_inputs(scene, path)
    ja = jarena(scene["arena_np"])
    covis, cnt = jk.graph_cache(ja)
    jout = jk.track_frame_full(
        ja, jkp(kp), t2j(assoc), t2j(outl), t2j(lev), t2j(ang), t2j(rel_R),
        t2j(rel_t), jnp.int32(last_ref), t2j(vel_R), t2j(vel_t),
        jnp.float32(gain), jnp.int32(ref_kf), covis, cnt)
    ta = interop.arena_from_numpy(scene["arena_np"])
    out = tr.kernels.track_frame_full(
        ta, kp, assoc, outl, lev, ang, rel_R, rel_t, last_ref, vel_R, vel_t,
        gain, ref_kf, tr.covis, tr.cnt)
    pk_j = np.asarray(jout[5]).astype(np.int64)
    pk_t = out.packed.numpy().astype(np.int64)
    for i in range(11):
        if i in MATCH_COUNTS:
            assert within_2pct(pk_t[i], pk_j[i]), (i, pk_t, pk_j)
        else:
            assert pk_t[i] == pk_j[i], (i, pk_t, pk_j)
    assert pose_close(out.R, out.t, jout[3], jout[4])
    assert out.host_reads == len(out.path) - 1
    if path == "blank":
        assert pk_j[6] == 0 and out.path[-1] == "skip_local"
        assert not (out.assoc >= 0).any()
        return
    assert pk_j[6] == 1 and out.path[-1] == "local"
    assert (path == "reference_kf") == ("reference_kf" in out.path)
    assert assoc_agree(out.assoc.numpy(), jout[1]) >= 0.98
    ja_out = jout[0]
    assert (ta.lm_visible.numpy() == np.asarray(ja_out.lm_visible)).mean() \
        >= 0.98
    assert (ta.lm_found.numpy() == np.asarray(ja_out.lm_found)).mean() \
        >= 0.98
    for a, b in ((out.vel_R, jout[6]), (out.rel_R, jout[8])):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-3


def lm_to_uv(assoc, uv, n_lm):
    out = np.full((n_lm, 2), np.nan, np.float32)
    rows = np.nonzero(assoc >= 0)[0]
    out[assoc[rows]] = uv[rows]
    return out


def test_map_tracker_against_jax_chain(scene):
    """MapTracker.track_fisheye over 3 frames against warp_bilinear ->
    extract -> track_frame_full of the JAX package, each carrying its own
    state from frame to frame."""
    tcfg, jcfg, jcam, jk = (scene[k] for k in ("tcfg", "jcfg", "jcam",
                                               "jk"))
    src = scene["tracker"]
    wm = JW.build_warp_map(jcam, jcfg.cube_w, jcfg.cube_h)
    mask = JW.fov_mask(jcam, jcfg.cube_w, jcfg.cube_h)
    extract, _ = build_extractor(jcfg, jcam, jcfg.n_features,
                                 (jcfg.cube_h, jcfg.cube_w))
    mt = MapTracker(tcfg, device="cpu")
    uu, vv = jnp.meshgrid(jnp.arange(jcfg.cube_w, dtype=jnp.float32),
                          jnp.arange(jcfg.cube_h, dtype=jnp.float32))
    uv_f, valid = JC.cubemap_to_fisheye(jcam, jnp.stack([uu, vv], axis=-1))
    mt.set_warp_map(interop.warp_map_from_numpy(
        np.asarray(uv_f), np.asarray(valid), np.asarray(wm.src_wh)))
    mt.mask = torch.as_tensor(np.asarray(mask))
    last = src.last
    mt.seed(interop.arena_from_numpy(scene["arena_np"]), last.kp,
            last.assoc, last.outlier, last.R, last.t, last.ref_kf,
            frame_id=NEXT - 1)

    ja = jarena(scene["arena_np"])
    covis, cnt = jk.graph_cache(ja)
    j_last = (jkp(last.kp), t2j(last.assoc), t2j(last.outlier),
              t2j(last.rel_R), t2j(last.rel_t), last.ref_kf)
    j_vel = (jnp.eye(3), jnp.zeros(3), jnp.float32(0.0))
    ref_kf = last.ref_kf
    L = scene["arena_np"]["lm_valid"].shape[0]
    for i in range(NEXT, NEXT + 3):
        img = scene["frames"][i]
        T = mt.track_fisheye(img, i / 30.0)
        kp_j = extract(JW.warp_bilinear(jnp.asarray(img), wm), mask)
        lkp, la, lo, lrR, lrt, lref = j_last
        out = jk.track_frame_full(ja, kp_j, la, lo, lkp.level, lkp.angle,
                                  lrR, lrt, jnp.int32(lref), *j_vel,
                                  jnp.int32(ref_kf), covis, cnt)
        ja, pk = out[0], np.asarray(out[5])
        row = mt.metrics[-1]
        assert pk[6] == 1 and pk[2] >= jcfg.min_track_inliers
        assert T is not None and row["track_ok"] == 1
        for k, name in enumerate(("matches", "inliers_mm", "inliers")):
            assert within_2pct(row[name], pk[k]), (i, row, pk)
        assert row["new_ref"] == int(pk[7])
        assert pose_close(T[:3, :3], T[:3, 3], pk[11:20].reshape(3, 3),
                          pk[20:23])
        # against the ground truth, at this size's accuracy (a pixel of a
        # 128^2 face is 0.9 degrees)
        R_gt, t_gt = scene["poses"][i]
        assert pose_close(T[:3, :3], T[:3, 3], R_gt, t_gt, tol=0.05,
                          tol_t=0.1)
        j_uv = lm_to_uv(np.asarray(out[1]), np.asarray(kp_j.uv), L)
        t_uv = lm_to_uv(mt.last.assoc.numpy(), mt.last.kp.uv.numpy(), L)
        matched = np.isfinite(j_uv[:, 0]) | np.isfinite(t_uv[:, 0])
        same = (np.abs(j_uv - t_uv) <= 1e-3).all(axis=1)
        assert same[matched].mean() >= 0.98, (i, same[matched].mean())
        ref_kf = int(pk[7])
        j_last = (kp_j, out[1], out[2], out[8], out[9], ref_kf)
        j_vel = (out[6], out[7], jnp.float32(jcfg.motion_model_damping))
    assert [r["host_reads"] for r in mt.metrics] == [2, 2, 2]


def rect_mask(jcam, jcfg):
    """The FOV mask with a rectangle zeroed: the left half of the front
    face and the right half of the left face."""
    m = np.array(JW.fov_mask(jcam, jcfg.cube_w, jcfg.cube_h))
    f = jcfg.cube_face_w
    m[f:2 * f, f // 2:f + f // 2] = 0
    return m


def test_caller_mask_against_jax(scene):
    """A caller's mask that is not the FOV mask: the port's ``extract`` and
    one ``MapTracker.track_cubemap(..., mask=m)`` against JAX
    ``extract_orb`` / ``track_frame_full`` on the same cross. The keypoint
    rows equal (valid flags exactly, positions within 1e-4, as
    ``test_torch_extractor.py`` holds the extractor), the mask culls
    keypoints that the FOV mask keeps, and the pose within 1e-3."""
    tcfg, jcfg, jcam, jk = (scene[k] for k in ("tcfg", "jcfg", "jcam",
                                               "jk"))
    src = scene["tracker"]
    mask = rect_mask(jcam, jcfg)
    extract, _ = build_extractor(jcfg, jcam, jcfg.n_features,
                                 (jcfg.cube_h, jcfg.cube_w))
    cube = src.warp(torch.as_tensor(scene["frames"][NEXT]))
    kp_t = src.extract(cube, mask)
    kp_j = extract(jnp.asarray(cube.numpy()), jnp.asarray(mask))
    tv, jv = kp_t.valid.numpy(), np.asarray(kp_j.valid)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(kp_t.uv.numpy()[tv], np.asarray(kp_j.uv)[jv],
                               atol=1e-4)
    fov = src.extract(cube).valid.numpy()
    assert (fov & ~tv).sum() > 5 and not (tv & ~fov).any()
    uv = kp_t.uv.numpy()[fov & ~tv].astype(int)
    assert (mask[uv[:, 1], uv[:, 0]] == 0).all()

    mt = MapTracker(tcfg, device="cpu")
    last = src.last
    mt.seed(interop.arena_from_numpy(scene["arena_np"]), last.kp,
            last.assoc, last.outlier, last.R, last.t, last.ref_kf,
            frame_id=NEXT - 1)
    T = mt.track_cubemap(cube, NEXT / 30.0, mask=torch.as_tensor(mask))
    ja = jarena(scene["arena_np"])
    covis, cnt = jk.graph_cache(ja)
    out = jk.track_frame_full(
        ja, kp_j, t2j(last.assoc), t2j(last.outlier), jkp(last.kp).level,
        jkp(last.kp).angle, t2j(last.rel_R), t2j(last.rel_t),
        jnp.int32(last.ref_kf), jnp.eye(3), jnp.zeros(3), jnp.float32(0.0),
        jnp.int32(last.ref_kf), covis, cnt)
    pk = np.asarray(out[5])
    assert T is not None and pk[6] == 1
    assert pose_close(T[:3, :3], T[:3, 3], pk[11:20].reshape(3, 3),
                      pk[20:23])
    np.testing.assert_array_equal(mt.last.kp.valid.numpy(), jv)


def test_prefetch_image_on_the_cpu(scene):
    """``prefetch_image`` on a CPU tracker returns a copy of the frame as a
    CPU tensor, which ``track_fisheye`` takes as it is."""
    src = scene["tracker"]
    img = scene["frames"][NEXT]
    t = src.prefetch_image(img)
    assert t.device.type == "cpu" and t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), img)
    assert t.data_ptr() != img.ctypes.data
    mt = MapTracker(scene["tcfg"], device="cpu")
    last = src.last
    mt.seed(interop.arena_from_numpy(scene["arena_np"]), last.kp,
            last.assoc, last.outlier, last.R, last.t, last.ref_kf,
            frame_id=NEXT - 1)
    T = mt.track_fisheye(t, NEXT / 30.0)
    R_gt, t_gt = scene["poses"][NEXT]
    assert T is not None and pose_close(T[:3, :3], T[:3, 3], R_gt, t_gt,
                                        tol=0.05, tol_t=0.1)
