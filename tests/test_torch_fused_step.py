"""The tracked frame as the captured CUDA graphs run it
(``runtime/fused_step.py``), held on the CPU, where each captured part
runs eagerly on the same static buffers.

One map is built once at small size (128^2 faces, 256 features, 4 levels,
K=16, L=2048) with the port's ``build_map``, as ``test_torch_tracking.py``
builds it, and the frames after it are rendered.

* ``track_frame_full`` with its slots, gain and radius scale as device
  tensors is bitwise the parent formulation (host ints and floats, the
  radius scale chosen on the host; ``parent_track_frame_full`` below) on
  the steady frames and on the forced widen, zero-velocity,
  reference-keyframe, velocity-gate and skip-local branches.
* ``FusedStep``'s fallback graphs' parts (W, Z and R over
  ``fallback_parts``, S over ``frame_skip``; on the CPU parts of a
  ``CapturedFrame`` without graphs) are bitwise the parent formulation in
  each branch case, ``MIN_MATCHES`` set from the frame's own counts.
* ``FusedStep``'s frames (warp, extract, ``frame_motion``, the fallbacks,
  ``frame_local`` / ``frame_skip``) are bitwise ``MapTracker``'s eager
  frames, and against the JAX composition that ``_build_fused_step``
  compiles (``warp_bilinear``, ``extract``, ``track_frame_full``) they
  hold ``test_torch_tracking.py``'s tolerances: poses within 1e-3, match
  counts within 2%, the other counts equal, associations (per landmark, by
  keypoint position) equal on >= 98% of the matched landmarks.
* The bookkeeping: which static inputs are copied each frame, a frame of
  another shape raising, the ``data_ptr`` check raising on a replaced
  arena, and ``seed``, ``CubemapSLAM.reset`` and ``load_map`` dropping the
  graphs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.profiler import ProfilerActivity, profile

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu import slam_map as JSM
from cubemapslam_tpu import warp as JW
from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.features.extractor import build_extractor
from cubemapslam_tpu.features.extractor import Keypoints as JKeypoints
from cubemapslam_tpu.runtime.kernels import TrackingKernels as JKernels
from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch import interop, serialize
from cubemapslam_tpu_torch import matching as M
from cubemapslam_tpu_torch.config import SlamConfig as TConfig
from cubemapslam_tpu_torch.runtime import kernels as K
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.fused_step import FusedStep
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM
from cubemapslam_tpu_torch.runtime.tracking import MapTracker

SMALL = dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4,
             max_keyframes=16, max_landmarks=2048)
KF_STRIDE, N_KF = 3, 4
NEXT = 10                         # the first frame after the last keyframe
N_NEXT = 4
MATCH_COUNTS = (0, 1, 2, 8, 9, 10)   # packed entries that count matches


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    cfg = TConfig(**SMALL)
    tracker = MapTracker(cfg, device="cpu")
    poses = S.forward_trajectory(NEXT + N_NEXT, step=0.04, yaw_rate=0.003)
    world = S.make_world(np.random.default_rng(11), n=500,
                         centers=S.camera_centres(poses),
                         fx=cfg.cube_face_w / 2.0)
    S.build_map(tracker, world, poses, N_KF, kf_stride=KF_STRIDE)
    render = S.Renderer(tracker.cam, cfg)
    frames = [S.to_u8(render.render(*world, *poses[i])[0])
              for i in range(NEXT, NEXT + N_NEXT)]
    return dict(cfg=cfg, tracker=tracker, poses=poses, frames=frames,
                arena_np=interop.arena_to_numpy(tracker.arena))


def seeded(scene, assoc=None):
    """A CPU MapTracker seeded from the map as built."""
    src = scene["tracker"]
    mt = MapTracker(scene["cfg"], device="cpu")
    last = src.last
    mt.seed(interop.arena_from_numpy(scene["arena_np"]), last.kp,
            last.assoc if assoc is None else assoc, last.outlier, last.R,
            last.t, last.ref_kf, frame_id=last.frame_id)
    return mt


def fused_frame(mt, img, ts, mask=None):
    """One frame through ``FusedStep`` (what ``track_fisheye`` runs on the
    card), then the tracker's read of its packed result."""
    fid = mt.frame_id
    mt.frame_id += 1
    kp, out = mt._fused_frame(img, mask)
    return mt._consume(kp, out, fid, ts, mt._graph_counts())[0]


# ---------------------------------------------------------------------------
# The capture-ready track_frame_full against the parent formulation
# ---------------------------------------------------------------------------

def parent_track_frame_full(k, arena, kp_cur, last_assoc, last_outlier,
                            last_kp_level, last_kp_angle, rel_R, rel_t,
                            last_ref: int, vel_R, vel_t, vel_gain: float,
                            ref_kf: int, covis, cnt):
    """``TrackingKernels.track_frame_full`` as written before its stages
    took device tensors: host ints for the slots, a host float for the
    gain, and the radius scale chosen on the host. Returns the FrameTrack
    fields (assoc, outlier, R, t, packed, vel_R, vel_t, rel_R, rel_t), the
    path and the reads."""
    dev = arena.device
    path = []
    R_last, t_last = G.se3_compose(rel_R, rel_t, arena.kf_R[last_ref],
                                   arena.kf_t[last_ref])
    tw = G.se3_log(vel_R, vel_t) * vel_gain
    rot_mag = torch.linalg.norm(tw[3:6])
    tw = torch.where(rot_mag < K.VELOCITY_GATE_RAD, tw, torch.zeros_like(tw))
    Rv, tv = G.se3_exp(tw)
    R_pred, t_pred = G.se3_compose(Rv, tv, R_last, t_last)
    last = (last_assoc, last_outlier, last_kp_level, last_kp_angle)

    def motion(R0, t0, radius):
        st = k.track_motion_fused(arena, kp_cur, *last, R0, t0,
                                  radius=radius)
        n, n_inl = torch.stack([st[1], st[5]]).tolist()
        return st, n, n_inl

    st, n, n_inl = motion(R_pred, t_pred, 15.0)
    path.append("motion")
    reads = 1
    if n < K.MIN_MATCHES:
        st, n, n_inl = motion(R_pred, t_pred, 30.0)
        path.append("widen")
        reads += 1
        if n < K.MIN_MATCHES:
            st2, n2, n_inl2 = motion(R_last, t_last, 30.0)
            path.append("zero_velocity")
            reads += 1
            if n_inl2 > n_inl:
                st, n, n_inl = st2, n2, n_inl2
    if n < K.MIN_MATCHES:
        assoc2, n2 = k.track_reference_kf(arena, kp_cur, ref_kf)
        R2, t2, out2, ni2 = k.optimize_pose(arena, kp_cur, assoc2, R_last,
                                            t_last)
        st = (assoc2, n2, R2, t2, out2, ni2)
        n, n_inl = torch.stack([n2, ni2]).tolist()
        path.append("reference_kf")
        reads += 1
    assoc, n_t, R, t, outlier, n_inl_t = st
    ref_t = torch.full((), ref_kf, dtype=torch.int64, device=dev)
    if n >= 15 and n_inl >= 10:
        rs = 3.0 if n_inl < K.WIDE_LOCAL_INLIERS else 1.0
        (arena, assoc_f, outlier_f, R_f, t_f, n_final, pkf_max, pkf_votes,
         diag) = k.track_local_fused(arena, kp_cur, assoc, outlier, R, t,
                                     covis=covis, radius_scale=rs)
        path.append("local")
    else:
        assoc_f, outlier_f, R_f, t_f = assoc, outlier, R, t
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        n_final, pkf_max, pkf_votes = zero, ref_t, zero
        diag = torch.zeros(3, dtype=torch.int64, device=dev)
        path.append("skip_local")
    new_ref = torch.where(pkf_votes > 0, pkf_max, ref_t)
    live_kf = arena.kf_valid.sum()
    row = K._row(arena.kf_obs_lm, new_ref)
    row0 = row.clamp(min=0)
    row_ok = ((row >= 0) & K._row(arena.kf_kp_valid, new_ref)
              & arena.lm_valid[row0])
    min_obs = torch.where(live_kf > 2, 3, 2)
    n_ref_obs = (row_ok & (cnt[row0] >= min_obs)).sum()
    free = (~arena.kf_valid).to(torch.int64)
    first_free = torch.where(free.any(), torch.argmax(free),
                             torch.full_like(live_kf, -1))
    ok_t = (n_t >= 15) & (n_inl_t >= 10)
    scalars = torch.cat([
        torch.stack([n_t, n_inl_t, n_final, n_ref_obs, live_kf, first_free,
                     ok_t.to(torch.int64), new_ref]), diag]).float()
    R_li, t_li = G.se3_inverse(R_last, t_last)
    vel_R, vel_t = G.se3_compose(R_f, t_f, R_li, t_li)
    R_ri, t_ri = G.se3_inverse(K._row(arena.kf_R, new_ref),
                               K._row(arena.kf_t, new_ref))
    rel_R, rel_t = G.se3_compose(R_f, t_f, R_ri, t_ri)
    packed = torch.cat([scalars, R_f.reshape(-1), t_f])
    return ((assoc_f, outlier_f, R_f, t_f, packed, vel_R, vel_t, rel_R,
             rel_t), tuple(path), reads)


def frame_inputs(scene, case):
    """(kp, last_assoc, last_outlier, level, angle, rel_R, rel_t, last_ref,
    vel_R, vel_t, gain, ref_kf) of one case."""
    mt = scene["tracker"]
    last = mt.last
    i = {"steady1": 1, "steady2": 2}.get(case, 0)
    img = np.zeros_like(scene["frames"][0]) if case == "blank" \
        else scene["frames"][i]
    kp = mt.extract(mt.warp(torch.as_tensor(img)))
    assoc = torch.full_like(last.assoc, -1) if case == "emptied" \
        else last.assoc
    R_a, t_a = (torch.as_tensor(x) for x in scene["poses"][NEXT - 2])
    R_b, t_b = (torch.as_tensor(x) for x in scene["poses"][NEXT - 1])
    vel_R, vel_t = G.se3_compose(R_b, t_b, *G.se3_inverse(R_a, t_a))
    gain = 0.75
    if case == "gate":
        vel_R = G.so3_exp(torch.tensor([0.0, 0.3, 0.0]))
        gain = 1.0
    return (kp, assoc, last.outlier, last.kp.level, last.kp.angle,
            last.rel_R, last.rel_t, last.ref_kf, vel_R, vel_t, gain,
            last.ref_kf)


CASES = ["steady0", "steady1", "steady2", "narrow", "emptied",
         "all_fallbacks", "gate", "blank"]
EXPECT = {"emptied": ("motion", "widen", "zero_velocity", "reference_kf",
                      "local"),
          "all_fallbacks": ("motion", "widen", "zero_velocity",
                            "reference_kf", "local"),
          "blank": ("motion", "widen", "zero_velocity", "reference_kf",
                    "skip_local")}


@pytest.mark.parametrize("as_tensors", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_capture_ready_frame_bitwise_parent(scene, monkeypatch, case,
                                            as_tensors):
    """``track_frame_full`` (its slots and gain as ints / floats or as 0-d
    tensors) against ``parent_track_frame_full`` on the same inputs and
    arena: every output, the path, the reads and the arena's counters
    bitwise equal. ``all_fallbacks`` sets the fallback threshold above any
    match count, so every fallback runs on real matches; ``narrow`` the
    wide-radius threshold below the inlier count."""
    if case == "all_fallbacks":
        monkeypatch.setattr(K, "MIN_MATCHES", 10 ** 6)
    if case == "narrow":
        # this map's frames have fewer than 100 inliers: lower the
        # threshold so that the local search keeps its radius (x 1)
        monkeypatch.setattr(K, "WIDE_LOCAL_INLIERS", 50)
    mt = scene["tracker"]
    (kp, assoc, outl, lev, ang, rel_R, rel_t, last_ref, vel_R, vel_t, gain,
     ref_kf) = frame_inputs(scene, case)
    covis, cnt = mt.kernels.graph_cache(
        interop.arena_from_numpy(scene["arena_np"]))
    a_new = interop.arena_from_numpy(scene["arena_np"])
    a_old = interop.arena_from_numpy(scene["arena_np"])
    args = (last_ref, vel_R, vel_t, gain, ref_kf)
    if as_tensors:
        args = (torch.tensor(last_ref), vel_R, vel_t,
                torch.tensor(gain, dtype=torch.float32), torch.tensor(ref_kf))
    out = mt.kernels.track_frame_full(a_new, kp, assoc, outl, lev, ang,
                                      rel_R, rel_t, *args, covis, cnt)
    ref, path, reads = parent_track_frame_full(
        mt.kernels, a_old, kp, assoc, outl, lev, ang, rel_R, rel_t, last_ref,
        vel_R, vel_t, gain, ref_kf, covis, cnt)
    assert out.path == path and out.host_reads == reads
    if case in EXPECT:
        assert path == EXPECT[case]
    elif case == "gate" or case.startswith("steady"):
        assert path == ("motion", "local")
    for name, x, y in zip(("assoc", "outlier", "R", "t", "packed", "vel_R",
                           "vel_t", "rel_R", "rel_t"), out[1:10], ref):
        assert torch.equal(x, y), name
    for f in a_new._fields:
        assert torch.equal(getattr(a_new, f), getattr(a_old, f)), f


@pytest.mark.parametrize("n_inl", [50, 150])
def test_frame_local_radius_scale(scene, monkeypatch, n_inl):
    """``frame_local`` chooses the local search's radius scale on the
    device from the stage's inlier count (x 3 below 100, else x 1): its
    TrackLocalMap outputs and counters are bitwise ``track_local_fused``
    with the host's scale, from a pose 3 degrees off, where the two scales
    give different associations. At 128^2 faces the search window's floor
    of 6 pixels is wider than either radius, so the floor is lowered."""
    monkeypatch.setattr(M, "WINDOW_FLOOR_PX", 0.5)
    mt = scene["tracker"]
    k = mt.kernels
    kp, assoc, outl, lev, ang = frame_inputs(scene, "steady0")[:5]
    R0 = G.so3_exp(torch.tensor([0.0, 0.05, 0.0])) @ mt.last.R
    st = list(k.track_motion_fused(
        interop.arena_from_numpy(scene["arena_np"]), kp, assoc, outl, lev,
        ang, R0, mt.last.t))
    st[2], st[5] = R0, torch.tensor(n_inl)
    outs = {}
    for rs in (3.0, 1.0, None):
        arena = interop.arena_from_numpy(scene["arena_np"])
        covis, cnt = k.graph_cache(arena)
        if rs is None:
            o = k.frame_local(arena, kp, st, mt.last.R, mt.last.t,
                              torch.tensor(mt.last.ref_kf), covis, cnt)
            got = (o[0], o[1], o[2], o[3])
        else:
            o = k.track_local_fused(arena, kp, st[0], st[4], st[2], st[3],
                                    covis=covis, radius_scale=rs)
            got = o[1:5]
        outs[rs] = (got, arena.lm_visible, arena.lm_found)
    want = outs[3.0 if n_inl < 100 else 1.0]
    assert not torch.equal(outs[3.0][0][0], outs[1.0][0][0])
    got = outs[None]
    assert all(torch.equal(x, y) for x, y in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# ---------------------------------------------------------------------------
# FusedStep's frames
# ---------------------------------------------------------------------------

def frame_state(mt, T):
    row = dict(mt.metrics[-1])
    last = mt.last
    tensors = [*last.kp, last.assoc, last.outlier, last.R, last.t,
               last.rel_R, last.rel_t]
    if mt.velocity is not None:
        tensors += list(mt.velocity)
    return T, row, tensors


@pytest.mark.parametrize("branch", ["steady", "emptied", "gate", "blank"])
def test_fused_frames_bitwise_eager(scene, branch):
    """``FusedStep``'s frames against ``MapTracker.track_fisheye``'s eager
    frames from one seed: poses, rows (but for the graph counts), the last
    frame's tensors, the velocity and the arena bitwise equal. ``emptied``
    copies the fallbacks' stage tuple into graph A's outputs before graph
    B; ``blank`` runs the eager skip after graph A."""
    frames = scene["frames"]
    if branch != "steady":
        frames = frames[:2]
    if branch == "blank":
        frames = [frames[0], np.zeros_like(frames[0])]
    assoc = None
    if branch == "emptied":
        assoc = torch.full_like(scene["tracker"].last.assoc, -1)
    runs = []
    for fused in (False, True):
        mt = seeded(scene, assoc)
        out = []
        for k, img in enumerate(frames):
            if branch == "gate" and k == 1:
                mt.velocity = (G.so3_exp(torch.tensor([0.0, 0.3, 0.0])),
                               torch.zeros(3))
            T = fused_frame(mt, img, k / 30.0) if fused \
                else mt.track_fisheye(img, k / 30.0)
            out.append(frame_state(mt, T))
        runs.append((out, mt))
    (e_out, e_mt), (f_out, f_mt) = runs
    for (Te, re, xe), (Tf, rf, xf) in zip(e_out, f_out):
        assert (Te is None) == (Tf is None)
        assert Te is None or np.array_equal(Te, Tf)
        assert re == rf
        assert len(xe) == len(xf)
        assert all(torch.equal(x, y) for x, y in zip(xe, xf))
    for f in e_mt.arena._fields:
        assert torch.equal(getattr(e_mt.arena, f), getattr(f_mt.arena, f)), f
    paths = [r["path"] for r in f_mt.metrics]
    if branch == "emptied":
        assert paths[0][1:4] == ("widen", "zero_velocity", "reference_kf")
    if branch == "blank":
        assert paths[1][-1] == "skip_local"
    # on the CPU no graph is captured or replayed, and MapTracker's own
    # frames are eager
    assert all(r["graph_captures"] == r["graph_replays"] == 0
               for r in f_mt.metrics)
    assert not f_mt._graph_frame()


# the fallback cases of FusedStep's parts: the velocity (None, or a turn of
# that many rad about y, inside the 0.2 rad gate, so that the prediction is
# off: by 0.15 rad the 15 px match keeps 52 of its 99 matches and the 30 px
# search 72; by 0.1 the last pose's search has more inliers than the
# prediction's), whether the frame is blank, and the graphs the frame runs
FALLBACK_CASES = {
    "widen": (0.15, False, ("a", "w", "b")),
    "zero_kept": (0.1, False, ("a", "w", "z", "b")),
    "zero_not_kept": (None, False, ("a", "w", "z", "r", "b")),
    "reference": (0.1, False, ("a", "w", "z", "r", "b")),
    "skip": (None, True, ("a", "w", "z", "r", "s")),
}


def fallback_threshold(mt, kp, case):
    """The ``MIN_MATCHES`` that makes the frame take ``case``'s branches,
    from the counts of its motion searches (the 15 px match, W from the
    prediction and Z from the last pose), and those counts."""
    k, last = mt.kernels, mt.last
    vel_R, vel_t, gain = mt._velocity_args()
    pose = k.predict_pose(mt.arena, last.rel_R, last.rel_t,
                          torch.tensor(last.ref_kf), vel_R, vel_t,
                          torch.tensor(float(gain)))
    lst = (last.assoc, last.outlier, last.kp.level, last.kp.angle)
    counts = {}
    for name, (R0, t0), radius in (("m", pose[2:], 15.0),
                                   ("w", pose[2:], 30.0),
                                   ("z", pose[:2], 30.0)):
        st = k.track_motion_fused(mt.arena, kp, *lst, R0, t0, radius=radius)
        counts[name] = (int(st[1]), int(st[5]))
    (m, _), (w, w_inl), (z, z_inl) = counts["m"], counts["w"], counts["z"]
    if case == "widen":
        assert m < w, counts
        return w, counts
    if case == "zero_kept":
        assert max(m, w) < z and z_inl > w_inl, counts
        return z, counts
    if case == "zero_not_kept":
        assert z_inl <= w_inl, counts
    if case == "reference":
        assert z_inl > w_inl, counts
    return 10 ** 6, counts


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_fallback_graphs_bitwise_parent(scene, monkeypatch, case):
    """``FusedStep``'s fallbacks as it runs them on the CPU (graphs W, Z, R
    and S as parts of a ``CapturedFrame`` without graphs, the stage tuple
    copied into graph A's outputs) against ``parent_track_frame_full`` on
    the same frame's keypoints and inputs: every output, the path, the
    reads and the arena's counters bitwise equal. ``MIN_MATCHES`` is set
    from the frame's own counts so that each case takes its branches:
    widened only (a wrong velocity); widened and retried from the last
    pose, the retry kept (more inliers) and the frame tracked; the retry
    not kept (the same pose as the widened search: no velocity) and the
    reference keyframe; a wrong velocity's kept retry and then the
    reference keyframe; a blank frame through every fallback into graph
    S."""
    turn, blank, parts = FALLBACK_CASES[case]
    img = np.zeros_like(scene["frames"][0]) if blank else scene["frames"][0]
    mt = seeded(scene)
    if turn is not None:
        mt.velocity = (G.so3_exp(torch.tensor([0.0, turn, 0.0])),
                       torch.zeros(3))
    kp = mt.extract(mt.warp(torch.as_tensor(img)))
    limit, counts = fallback_threshold(mt, kp, case)
    monkeypatch.setattr(K, "MIN_MATCHES", limit)
    last, (vel_R, vel_t, gain) = mt.last, mt._velocity_args()
    a_old = interop.arena_from_numpy(scene["arena_np"])
    ref, path, reads = parent_track_frame_full(
        mt.kernels, a_old, kp, last.assoc, last.outlier, last.kp.level,
        last.kp.angle, last.rel_R, last.rel_t, last.ref_kf, vel_R, vel_t,
        gain, mt.ref_kf, mt.covis, mt.cnt)
    kp_f, out = mt._fused_frame(img, None)
    assert all(torch.equal(x, y) for x, y in zip(kp_f, kp))
    assert out.path == path and out.host_reads == reads, counts
    assert len(path) - 1 == len(parts) - 1 == reads
    assert tuple(mt.fused_step.outputs) == parts
    for name, x, y in zip(("assoc", "outlier", "R", "t", "packed", "vel_R",
                           "vel_t", "rel_R", "rel_t"), out[1:10], ref):
        assert torch.equal(x, y), name
    for f in a_old._fields:
        assert torch.equal(getattr(mt.arena, f), getattr(a_old, f)), f


def jarena(f):
    return JSM.MapArena(**{k: jnp.asarray(v) for k, v in f.items()})


def t2j(x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def jkp(kp):
    return JKeypoints(**{k: jnp.asarray(v)
                         for k, v in interop.keypoints_to_numpy(kp).items()})


def pose_close(Rt, tt, Rj, tj, tol=1e-3):
    dR = np.asarray(JG.so3_log(jnp.asarray(
        np.asarray(Rt, np.float32) @ np.asarray(Rj, np.float32).T)))
    return (np.linalg.norm(dR) < tol
            and np.abs(np.asarray(tt) - np.asarray(tj)).max() < tol)


def lm_to_uv(assoc, uv, n_lm):
    out = np.full((n_lm, 2), np.nan, np.float32)
    rows = np.nonzero(assoc >= 0)[0]
    out[assoc[rows]] = uv[rows]
    return out


def test_fused_frames_against_jax_composition(scene):
    """``FusedStep`` over the rendered frames against the composition that
    the JAX package's ``_build_fused_step`` compiles (``warp_bilinear``,
    ``extract``, ``track_frame_full``), each carrying its own state, on
    the JAX package's warp map and FOV mask."""
    jcfg = JConfig(**SMALL)
    jcam = JC.CubemapCamera.from_config(jcfg)
    jk = JKernels(jcfg, jcam)
    wm = JW.build_warp_map(jcam, jcfg.cube_w, jcfg.cube_h)
    mask = JW.fov_mask(jcam, jcfg.cube_w, jcfg.cube_h)
    extract, _ = build_extractor(jcfg, jcam, jcfg.n_features,
                                 (jcfg.cube_h, jcfg.cube_w))
    mt = MapTracker(scene["cfg"], device="cpu")
    uu, vv = jnp.meshgrid(jnp.arange(jcfg.cube_w, dtype=jnp.float32),
                          jnp.arange(jcfg.cube_h, dtype=jnp.float32))
    uv_f, valid = JC.cubemap_to_fisheye(jcam, jnp.stack([uu, vv], axis=-1))
    mt.set_warp_map(interop.warp_map_from_numpy(
        np.asarray(uv_f), np.asarray(valid), np.asarray(wm.src_wh)))
    mt.mask = torch.as_tensor(np.asarray(mask))
    last = scene["tracker"].last
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
    for k, img in enumerate(scene["frames"][:3]):
        T = fused_frame(mt, img, k / 30.0)
        kp_j = extract(JW.warp_bilinear(jnp.asarray(img), wm), mask)
        lkp, la, lo, lrR, lrt, lref = j_last
        out = jk.track_frame_full(ja, kp_j, la, lo, lkp.level, lkp.angle,
                                  lrR, lrt, jnp.int32(lref), *j_vel,
                                  jnp.int32(ref_kf), covis, cnt)
        ja, pk = out[0], np.asarray(out[5])
        row = mt.metrics[-1]
        assert pk[6] == 1 and T is not None and row["track_ok"] == 1
        pk_t = [row[n] for n in ("matches", "inliers_mm", "inliers",
                                 "n_ref", "live_kf", "first_free",
                                 "track_ok", "new_ref", "local_frustum",
                                 "local_queried", "local_matched")]
        for i in range(11):
            if i in MATCH_COUNTS:
                assert abs(pk_t[i] - int(pk[i])) <= 0.02 * abs(int(pk[i])), \
                    (k, i, pk_t, pk)
            else:
                assert pk_t[i] == int(pk[i]), (k, i, pk_t, pk)
        assert pose_close(T[:3, :3], T[:3, 3], pk[11:20].reshape(3, 3),
                          pk[20:23])
        j_uv = lm_to_uv(np.asarray(out[1]), np.asarray(kp_j.uv), L)
        t_uv = lm_to_uv(mt.last.assoc.numpy(), mt.last.kp.uv.numpy(), L)
        matched = np.isfinite(j_uv[:, 0]) | np.isfinite(t_uv[:, 0])
        same = (np.abs(j_uv - t_uv) <= 1e-3).all(axis=1)
        assert same[matched].mean() >= 0.98, (k, same[matched].mean())
        ref_kf = int(pk[7])
        j_last = (kp_j, out[1], out[2], out[8], out[9], ref_kf)
        j_vel = (out[6], out[7], jnp.float32(jcfg.motion_model_damping))
    assert [r["host_reads"] for r in mt.metrics] == [2, 2, 2]


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

def test_static_inputs_copied_each_frame(scene, monkeypatch):
    """Every frame copies the frame, the last frame's tensors, the velocity
    and the slots into the static buffers; the mask, the covisibility and
    the observation counts only when they are not the tensors, at the same
    version, that were copied last."""
    mt = seeded(scene)
    copied = []
    real = FusedStep._copy

    def spy(self, name, src):
        copied.append(name)
        real(self, name, src)

    monkeypatch.setattr(FusedStep, "_copy", spy)
    every = ["fisheye", "last_assoc", "last_outlier", "last_level",
             "last_angle", "rel_R", "rel_t", "vel_R", "vel_t"]
    frames = scene["frames"]
    fused_frame(mt, frames[0], 0.0)
    assert sorted(copied) == sorted(every + ["mask", "covis", "cnt"])
    fs = mt.fused_step
    last, vel = mt.last, mt.velocity
    copied.clear()
    fused_frame(mt, frames[1], 1 / 30.0)
    assert sorted(copied) == sorted(every)
    s = fs.inputs
    assert torch.equal(s["fisheye"], torch.as_tensor(frames[1]))
    for name, src in (("last_assoc", last.assoc),
                      ("last_outlier", last.outlier),
                      ("last_level", last.kp.level),
                      ("last_angle", last.kp.angle), ("rel_R", last.rel_R),
                      ("rel_t", last.rel_t), ("vel_R", vel[0]),
                      ("vel_t", vel[1]), ("mask", mt.mask),
                      ("covis", mt.covis), ("cnt", mt.cnt)):
        assert torch.equal(s[name], src), name
        assert s[name].data_ptr() != src.data_ptr(), name
    assert int(s["last_ref"]) == last.ref_kf and int(s["ref_kf"]) == \
        last.ref_kf
    assert float(s["gain"]) == float(mt.cfg.motion_model_damping)
    copied.clear()
    mt.refresh_graph_cache()
    mt.mask.mul_(1.0)                  # in place: a new version
    fused_frame(mt, frames[2], 2 / 30.0)
    assert sorted(copied) == sorted(every + ["mask", "covis", "cnt"])
    copied.clear()
    own = torch.as_tensor(np.asarray(mt.mask))
    fused_frame(mt, frames[3], 3 / 30.0, mask=own)
    assert "mask" in copied
    assert [r["host_reads"] for r in mt.metrics] == [2, 2, 2, 2]
    with pytest.raises(ValueError, match="uint8"):
        mt._fused_frame(frames[0].astype(np.float32), None)
    with pytest.raises(ValueError, match="input mask"):
        mt._fused_frame(frames[0], own.to(torch.float64))


def test_moved_arena_raises_and_owners_drop_graphs(scene, tmp_path):
    """A ``FusedStep`` whose arena was replaced raises before it runs;
    ``seed``, ``CubemapSLAM.reset`` and ``serialize.load_map`` drop the
    graphs."""
    mt = seeded(scene)
    fused_frame(mt, scene["frames"][0], 0.0)
    stale = mt.fused_step
    assert stale is not None
    vel = mt._velocity_args()
    mt.arena = type(mt.arena)(*(t.clone() for t in mt.arena))
    with pytest.raises(RuntimeError, match="moved"):
        stale(mt, scene["frames"][1], None, mt.last, vel[:2], vel[2],
              mt.ref_kf)
    last = scene["tracker"].last
    mt.seed(interop.arena_from_numpy(scene["arena_np"]), last.kp,
            last.assoc, last.outlier, last.R, last.t, last.ref_kf,
            frame_id=last.frame_id)
    assert mt.fused_step is None
    slam = CubemapSLAM(scene["cfg"], device="cpu")
    slam._fused = FusedStep(slam)
    slam.reset()
    assert slam.fused_step is None
    path = str(tmp_path / "map.npz")
    serialize.save_map(slam, path)
    slam._fused = FusedStep(slam)
    serialize.load_map(slam, path)
    assert slam.fused_step is None


# the spans of a tracked frame that reads nothing past its fallbacks
TRACKED_SPANS = ("slam.frame", "warp", "extract", "extract.pyramid",
                 "extract.detect", "extract.select", "extract.describe",
                 "extract.rays", "motion", "pose_lm", "local.select",
                 "local.search", "local.optimize", "local.counters",
                 "epilogue", "host.read", "host.keep")


def test_eager_tracked_frame_spans(scene, monkeypatch):
    """``MapTracker``'s eager frame (the CPU's) with no profiler calls no
    ``record_function``; under ``torch.profiler`` one ``slam.frame`` holds
    every span of the frame: ``warp``, ``extract`` with its five steps,
    ``motion`` (the first read and the 15 px pose LM), TrackLocalMap's
    ``local.*`` (the pose LM in ``local.optimize``), the device
    ``epilogue`` and the read's (the last read, then ``host.keep``); one
    ``host.read`` for each read the row counts. The row's ``kind`` is
    ``tracked``."""
    from test_torch_spans import host_spans, inside, raise_on_span
    from cubemapslam_tpu_torch import spans
    mt = seeded(scene)
    with monkeypatch.context() as m:
        m.setattr(spans, "record_function", raise_on_span)
        assert mt.track_fisheye(scene["frames"][0], 0.0) is not None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert mt.track_fisheye(scene["frames"][1], 0.1) is not None
    row = mt.metrics[-1]
    assert row["kind"] == "tracked" and "graph_stages" in row
    ev = host_spans(prof, set(TRACKED_SPANS))
    assert {n for n, _, _ in ev} == set(TRACKED_SPANS)
    frame = [e for e in ev if e[0] == "slam.frame"]
    assert len(frame) == 1 and all(inside(e, frame[0]) for e in ev)

    def one(name):
        (e,) = [e for e in ev if e[0] == name]
        return e

    assert all(inside(e, one("extract")) for e in ev
               if e[0].startswith("extract."))
    reads = [e for e in ev if e[0] == "host.read"]
    assert len(reads) == row["host_reads"] == 2
    assert inside(reads[0], one("motion"))
    epilogue = [e for e in ev if e[0] == "epilogue"]
    assert len(epilogue) == 2 and epilogue[0][2] <= reads[1][1]
    assert inside(reads[1], epilogue[1])
    assert inside(one("host.keep"), epilogue[1])
    lm = [e for e in ev if e[0] == "pose_lm"]
    assert len(lm) == 2 and inside(lm[0], one("motion"))
    assert inside(lm[1], one("local.optimize"))
