"""Port parity: the direct bundle adjustment (dense Schur + Cholesky), its
scale gauge, the matrix-free CG path and the global problem of the arena.

One seeded local problem is given to both packages as numpy arrays: 8
cameras (5 in the free block, slot 0 and the 3 anchors fixed, one
invalid), 150 points, each camera's row of 120 observation slots with
0.5 px noise, 6% gross outliers and padding, compacted to 100 live
entries a row. Tolerances: poses within 1e-4 of JAX's (LM in float32, 15
iterations), the points that 3 or more optimized inlier edges observe
within 1e-4 (a point seen by 1 or 2 is free or nearly free along its ray,
where both packages' rounding moves it apart), the inlier mask of the
edges exactly equal. The building blocks (chi2, robust cost, updates,
lanes, the 3x3 inverse, one LM step) within 1e-4 relative, or the stated
absolute bound. The gauge retraction alone within 1e-5.
A problem whose reduced camera system is not positive definite (negative
edge weights) makes the Cholesky factor fail: both packages reject every
step and return the state they were given, within 1e-5.
The CG path: one LM step within 1e-4 (free cameras and the points seen 3 or
more times), the whole solve held loosely (tolerances in the test, with the
reason), and the outcome of the JAX package's ``test_refines_noisy_map``.
The global problem's fields equal (floats within 1e-6). The CG path's LM
steps on fixed state tensors, through ``CapturedLoop`` or a Python loop,
bitwise the loop as it was before (``tests/torch_parent_loops.py``), on
the small problem after n = 1, 2, 5 robust steps and on the global BA of
the constructed-drift arena at ``chip_smoke.LOOP_SMALL``. That global BA
padded to its edge capacity and to all K*N slots
(``LoopKernels.padded_ba_problem``): within 1e-5 relative of the compacted
solve with the same inlier verdicts, and against the JAX CG solve of all
K*N masked slots within the tolerances stated in the test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubemapslam_tpu import camera as JC
from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.optim import ba as JB
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.optim import ba as TB
from cubemapslam_tpu_torch.runtime.fused_step import CapturedLoop

import chip_smoke
import torch_parent_loops as PARENT

CFG = SlamConfig(cube_face_w=128, cube_face_h=128)
M, N_FREE, P, N = 8, 5, 150, 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its operations are small
    and many, and the test workers share the host's cores, where more
    threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bytes (NaN where NaN)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.numpy().tobytes() == b.numpy().tobytes())


def make_problem(rng, inv_sigma_sign=1.0):
    """(numpy fields of a BAProblem, the true R, t, X)."""
    jcam = JCam.from_config(CFG)
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 8, P)
    Rs, ts = [], []
    for m in range(M):
        R = np.asarray(JG.so3_exp(jnp.asarray(
            [0.0, 0.03 * m, 0.01 * np.sin(m)], jnp.float32)))
        c = np.array([0.15 * m, 0.02 * m, 0.05 * np.cos(m)], np.float32)
        Rs.append(R)
        ts.append(-R @ c)
    R_true, t_true = np.stack(Rs), np.stack(ts).astype(np.float32)
    obs_pt = np.zeros((M, N), np.int32)
    obs_uv = np.zeros((M, N, 2), np.float32)
    obs_face = np.zeros((M, N), np.int32)
    obs_valid = np.zeros((M, N), bool)
    for m in range(M):
        pc = X @ R_true[m].T + t_true[m]
        uv, face = (np.asarray(v) for v in JC.ray_to_face_uv(
            jcam, jnp.asarray(pc)))
        vis = np.nonzero(face >= 0)[0]
        pick = rng.choice(vis, min(len(vis), N - 10), replace=False)
        k = len(pick)
        obs_pt[m, :k] = pick
        obs_uv[m, :k] = uv[pick] + rng.normal(0, 0.5, (k, 2))
        out = rng.uniform(size=k) < 0.06
        obs_uv[m, :k][out] += rng.uniform(15, 30, (out.sum(), 2))
        obs_face[m, :k] = face[pick]
        obs_valid[m, :k] = True
    # perturbed start: free cameras and all points
    R0, t0 = R_true.copy(), t_true.copy()
    for m in range(1, N_FREE):
        dR = np.asarray(JG.so3_exp(jnp.asarray(
            rng.normal(0, 0.004, 3), jnp.float32)))
        R0[m] = dR @ R0[m]
        t0[m] += rng.normal(0, 0.02, 3)
    X0 = (X + rng.normal(0, 0.03, X.shape)).astype(np.float32)
    cam_fixed = np.zeros(M, bool)
    cam_fixed[0] = True
    cam_fixed[N_FREE:] = True
    cam_valid = np.ones(M, bool)
    cam_valid[3] = False
    inv_s2 = inv_sigma_sign * np.where(rng.uniform(size=(M, N)) < 0.3,
                                       1.0 / 1.44, 1.0).astype(np.float32)
    fields = dict(
        R=R0, t=t0, cam_fixed=cam_fixed, cam_valid=cam_valid, X=X0,
        pt_valid=np.ones(P, bool),
        obs_cam=np.repeat(np.arange(M, dtype=np.int32), N),
        obs_pt=obs_pt.reshape(-1), obs_face=obs_face.reshape(-1),
        obs_uv=obs_uv.reshape(-1, 2),
        obs_inv_sigma2=inv_s2.reshape(-1).astype(np.float32),
        obs_valid=obs_valid.reshape(-1))
    return fields, (R_true, t_true, X)


def jprob(f):
    return JB.BAProblem(**{k: jnp.asarray(v) for k, v in f.items()})


def tprob(f):
    return TB.BAProblem(**{
        k: torch.as_tensor(np.array(v).astype(np.int64)
                           if np.asarray(v).dtype == np.int32
                           else np.array(v)) for k, v in f.items()})


@pytest.fixture(scope="module")
def solved():
    f, truth = make_problem(np.random.default_rng(0))
    jout, jinl = JB.bundle_adjust(JCam.from_config(CFG), jprob(f),
                                  solver="direct", n_free=N_FREE,
                                  max_obs_per_cam=100)
    tout, tinl = TB.bundle_adjust(TCam.from_config(CFG, "cpu"), tprob(f),
                                  solver="direct", n_free=N_FREE,
                                  max_obs_per_cam=100)
    return f, truth, (jout, np.asarray(jinl)), (tout, tinl.numpy())


def test_direct_ba_poses_points_inliers(solved):
    f, _, (jout, jinl), (tout, tinl) = solved
    for name in ("R", "t"):
        a = getattr(tout, name).numpy()
        b = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(tinl, jinl)
    # the edges the solve used: compacted, of a valid camera, inliers
    ctx = JB._make_direct_ctx(JCam.from_config(CFG), jprob(f), 100)
    used = np.zeros((M, N), bool)
    for m in range(M):
        used[m, np.asarray(ctx.sel)[m][np.asarray(ctx.valid0)[m]]] = True
    used = (used.reshape(-1) & jinl
            & f["cam_valid"][f["obs_cam"]])
    held = np.bincount(f["obs_pt"][used], minlength=P) >= 3
    assert held.mean() > 0.85
    np.testing.assert_allclose(tout.X.numpy()[held],
                               np.asarray(jout.X)[held], atol=1e-4)
    # the solve did something: fixed cameras kept, the reprojection error
    # of the used edges down, the outliers cut
    free = f["cam_valid"] & ~f["cam_fixed"]
    np.testing.assert_array_equal(tout.R.numpy()[~free], f["R"][~free])
    tcam = TCam.from_config(CFG, "cpu")
    before = TB._chi2(tcam, tprob(f)).numpy()[used]
    after = TB._chi2(tcam, tout).numpy()[used]
    assert after.sum() < 0.5 * before.sum()
    assert 0 < (f["obs_valid"] & ~tinl).sum() < 0.15 * f["obs_valid"].sum()


def test_make_direct_ctx(solved):
    f = solved[0]
    jctx = JB._make_direct_ctx(JCam.from_config(CFG), jprob(f), 100)
    tctx = TB._make_direct_ctx(TCam.from_config(CFG, "cpu"), tprob(f), 100)
    for name in TB._DirectCtx._fields:
        np.testing.assert_array_equal(getattr(tctx, name).numpy(),
                                      np.asarray(getattr(jctx, name)),
                                      err_msg=name)


def test_gauge_retraction():
    """A problem with one fixed camera, its free state scaled about the
    anchor by 1.3: the retraction restores the entry scale."""
    f, _ = make_problem(np.random.default_rng(1))
    f = dict(f)
    f["cam_fixed"] = np.zeros(M, bool)
    f["cam_fixed"][0] = True
    jp, tp = jprob(f), tprob(f)
    ja, ta = JB._gauge_entry(jp), TB._gauge_entry(tp)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    c = -np.einsum("mji,mj->mi", f["R"], f["t"])
    c1 = c[0] + 1.3 * (c - c[0])
    t1 = -np.einsum("mij,mj->mi", f["R"], c1).astype(np.float32)
    X1 = (c[0] + 1.3 * (f["X"] - c[0])).astype(np.float32)
    jr = JB._gauge_retract(jp._replace(t=jnp.asarray(t1),
                                       X=jnp.asarray(X1)), ja)
    tr = TB._gauge_retract(tp._replace(t=torch.as_tensor(t1),
                                       X=torch.as_tensor(X1)), ta)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-5)
    np.testing.assert_allclose(tr.X.numpy(), np.asarray(jr.X), atol=1e-5)
    free = f["cam_valid"] & ~f["cam_fixed"]
    np.testing.assert_allclose(tr.t.numpy()[free], f["t"][free], atol=1e-4)
    np.testing.assert_allclose(tr.X.numpy(), f["X"], atol=1e-4)


def test_failed_cholesky_rejects_the_step():
    f, _ = make_problem(np.random.default_rng(2), inv_sigma_sign=-1.0)
    jcam, tcam = JCam.from_config(CFG), TCam.from_config(CFG, "cpu")
    jp, tp = jprob(f), tprob(f)
    # one step: the factor fails, the candidate is NaN in both
    jctx = JB._make_direct_ctx(jcam, jp, 100)
    tctx = TB._make_direct_ctx(tcam, tp, 100)
    jc = JB._lm_step_direct(jcam, jp, jctx, jctx.valid0, True,
                            jnp.float32(1e-4), N_FREE)
    tc = TB._lm_step_direct(tcam, tp, tctx, tctx.valid0, True,
                            torch.tensor(1e-4), N_FREE)
    free = f["cam_valid"] & ~f["cam_fixed"]
    assert np.isnan(np.asarray(jc[0])[free]).all()
    assert torch.isnan(tc[0][torch.as_tensor(free)]).all()
    # the whole solve keeps the state it was given
    jout, _ = JB.bundle_adjust(jcam, jp, solver="direct", n_free=N_FREE,
                               max_obs_per_cam=100)
    tout, _ = TB.bundle_adjust(tcam, tp, solver="direct", n_free=N_FREE,
                               max_obs_per_cam=100)
    for name in ("R", "t", "X"):
        a = getattr(tout, name).numpy()
        np.testing.assert_allclose(a, f[name], atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(getattr(jout, name)),
                                   atol=1e-5, err_msg=name)


def test_cg_solver_not_in_this_port_yet():
    """The name is from before the CG path was ported: it now checks that
    ``solver="cg"`` runs (fixed cameras kept, every output finite) and that
    an unknown solver is refused."""
    f, _ = make_problem(np.random.default_rng(3))
    tcam = TCam.from_config(CFG, "cpu")
    out, inl = TB.bundle_adjust(tcam, tprob(f), solver="cg")
    fixed = f["cam_fixed"] | ~f["cam_valid"]
    np.testing.assert_array_equal(out.R.numpy()[fixed], f["R"][fixed])
    assert all(torch.isfinite(x).all() for x in (out.R, out.t, out.X))
    assert inl.shape == (M * N,)
    with pytest.raises(AssertionError):
        TB.bundle_adjust(tcam, tprob(f), solver="lu")


@pytest.mark.parametrize("piece", ["chi2_cost", "apply_updates", "lanes",
                                   "inv3", "lm_step"])
def test_direct_pieces(piece):
    """The building blocks on one problem, within 1e-4 relative of JAX:
    edge chi2 and the robust cost, the pose/point update, the residual and
    Jacobian lanes, the damped 3x3 inverse and one LM step (robust, with
    lambda 1e-4) of the free cameras and the points seen 3 or more times."""
    f, _ = make_problem(np.random.default_rng(4))
    jcam, tcam = JCam.from_config(CFG), TCam.from_config(CFG, "cpu")
    jp, tp = jprob(f), tprob(f)

    def close(a, b, rtol=1e-4, atol=1e-4):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)

    if piece == "chi2_cost":
        cj, ct = JB._chi2(jcam, jp), TB._chi2(tcam, tp)
        close(ct.numpy(), cj, atol=1e-3)
        act = f["obs_valid"] & f["cam_valid"][f["obs_cam"]]
        for robust in (True, False):
            cost = TB._robust_cost(ct, torch.as_tensor(act), robust)
            close(float(cost),
                  float(JB._robust_cost(cj, jnp.asarray(act), robust)))
            # the CG path's 0-d device flag selects the same bits
            assert same_bits(TB._robust_cost(ct, torch.as_tensor(act),
                                             torch.tensor(robust)), cost)
    elif piece == "apply_updates":
        rng = np.random.default_rng(5)
        dc = rng.normal(0, 0.01, (M, 6)).astype(np.float32)
        dp = rng.normal(0, 0.01, (P, 3)).astype(np.float32)
        for a, b in zip(TB._apply_updates(tp, torch.as_tensor(dc),
                                          torch.as_tensor(dp)),
                        JB._apply_updates(jp, jnp.asarray(dc),
                                          jnp.asarray(dp))):
            close(a.numpy(), b, rtol=1e-6, atol=1e-6)
    elif piece == "lanes":
        jctx = JB._make_direct_ctx(jcam, jp, 100)
        tctx = TB._make_direct_ctx(tcam, tp, 100)
        ev_j = JB._lanes_eval(jcam, jctx, jp.R, jp.t, jp.X)
        ev_t = TB._lanes_eval(tcam, tctx, tp.R, tp.t, tp.X)
        for a, b in zip(ev_t[:2], ev_j[:2]):
            for x, y in zip(a, b):
                close(x.numpy(), y)
        for x, y in zip(ev_t[2:], ev_j[2:]):
            close(x.numpy(), y, atol=1e-3)
        jac_j = JB._lanes_jac(jcam, jctx, jp.R, ev_j[0], ev_j[1])
        jac_t = TB._lanes_jac(tcam, tctx, tp.R, ev_t[0], ev_t[1])
        for a, b in zip(jac_t, jac_j):
            for row_t, row_j in zip(a, b):
                for x, y in zip(row_t, row_j):
                    close(x.numpy(), y, atol=1e-2)
    elif piece == "inv3":
        rng = np.random.default_rng(6)
        A = rng.normal(size=(P, 3, 3)).astype(np.float32)
        H = np.einsum("pij,pkj->pik", A, A)
        valid = rng.uniform(size=P) < 0.9
        lanes = [[H[:, a, b] for b in range(3)] for a in range(3)]
        it = TB._inv3_lanes([[torch.as_tensor(x) for x in r] for r in lanes],
                            torch.tensor(1e-3), torch.as_tensor(valid))
        ij = JB._inv3_lanes([[jnp.asarray(x) for x in r] for r in lanes],
                            jnp.float32(1e-3), jnp.asarray(valid))
        for rt, rj in zip(it, ij):
            for x, y in zip(rt, rj):
                close(x.numpy(), y, rtol=1e-5, atol=1e-5)
    else:
        jctx = JB._make_direct_ctx(jcam, jp, 100)
        tctx = TB._make_direct_ctx(tcam, tp, 100)
        sj = JB._lm_step_direct(jcam, jp, jctx, jctx.valid0, True,
                                jnp.float32(1e-4), N_FREE)
        st = TB._lm_step_direct(tcam, tp, tctx, tctx.valid0, True,
                                torch.tensor(1e-4), N_FREE)
        close(st[0].numpy(), sj[0], atol=1e-5)
        close(st[1].numpy(), sj[1], atol=1e-5)
        cnt = np.bincount(f["obs_pt"][f["obs_valid"]
                                      & f["cam_valid"][f["obs_cam"]]],
                          minlength=P)
        held = cnt >= 3
        close(st[2].numpy()[held], np.asarray(sj[2])[held], atol=1e-4)


# ---------------------------------------------------------------------------
# The matrix-free CG path and the global problem of the arena
# ---------------------------------------------------------------------------

def cg_problem(rng):
    """``make_problem`` with only camera 0 fixed, the gauge of the global
    BA."""
    f, truth = make_problem(rng)
    f = dict(f)
    f["cam_fixed"] = np.arange(M) == 0
    return f, truth


def test_cg_lm_step():
    """One robust LM step of the CG path (lambda 1e-4, 30 CG iterations):
    the free cameras within 1e-4 of JAX, the points seen 3 or more times
    within 1e-4."""
    f, _ = cg_problem(np.random.default_rng(8))
    jcam, tcam = JCam.from_config(CFG), TCam.from_config(CFG, "cpu")
    jp, tp = jprob(f), tprob(f)
    act = f["obs_valid"]
    sj = JB._lm_step(jcam, jp, jnp.asarray(act), True, jnp.float32(1e-4), 30)
    st = TB._lm_step(tcam, tp, torch.as_tensor(act), True,
                     torch.tensor(1e-4), 30)
    np.testing.assert_allclose(st[0].numpy(), np.asarray(sj[0]), atol=1e-4)
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), atol=1e-4)
    cnt = np.bincount(f["obs_pt"][act & f["cam_valid"][f["obs_cam"]]],
                      minlength=P)
    held = cnt >= 3
    np.testing.assert_allclose(st[2].numpy()[held], np.asarray(sj[2])[held],
                               atol=1e-4)


def test_cg_bundle_adjust_against_jax():
    """The whole two-phase CG solve (15 LM steps of 30 CG iterations). LM
    amplifies last-bit differences of float32 (ROADMAP Queue 3, "Float32 BA
    rounding"), so the two are held loosely: poses within 1e-3, the points
    seen 3 or more times within 1e-3 for 95% of them, the inlier masks equal
    on 99% of the edges."""
    f, _ = cg_problem(np.random.default_rng(9))
    jout, jinl = JB.bundle_adjust(JCam.from_config(CFG), jprob(f),
                                  solver="cg")
    tout, tinl = TB.bundle_adjust(TCam.from_config(CFG, "cpu"), tprob(f),
                                  solver="cg")
    for name in ("R", "t"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=1e-3, err_msg=name)
    cnt = np.bincount(f["obs_pt"][np.asarray(jinl)], minlength=P)
    d = np.abs(tout.X.numpy() - np.asarray(jout.X)).max(axis=1)[cnt >= 3]
    assert np.quantile(d, 0.95) < 1e-3, np.quantile(d, 0.95)
    assert (tinl.numpy() == np.asarray(jinl)).mean() >= 0.99


def test_cg_refines_noisy_map():
    """The analog of TestBundleAdjust::test_refines_noisy_map
    (``tests/test_optim.py:108-165``) on the CG path: 6 cameras, 120 points
    at depth 6, 0.3 px noise, the start perturbed; poses within 0.15 deg and
    0.02, the median point error under 0.02, 90% of the edges inliers."""
    rng = np.random.default_rng(42)
    jcam = JCam.from_config(SlamConfig())
    n_pts, n_cams = 120, 6
    pts = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    poses = []
    for k in range(n_cams):
        R = np.asarray(JG.so3_exp(jnp.asarray(rng.normal(size=3) * 0.05,
                                              jnp.float32)))
        t = np.array([0.4 * k, 0, 0], np.float32) + rng.normal(
            0, 0.02, 3).astype(np.float32)
        poses.append((R, t))
    cam_i, pt_i, face_i, uv_i = [], [], [], []
    for ci, (R, t) in enumerate(poses):
        pc = (R @ pts.T).T + t
        uv, face = JC.ray_to_cubemap(jcam, jnp.asarray(pc, jnp.float32))
        uv_face = np.array(JC.cubemap_uv_to_in_face(jcam, uv))
        face = np.asarray(face)
        for pi in np.nonzero(face >= 0)[0]:
            cam_i.append(ci)
            pt_i.append(pi)
            face_i.append(face[pi])
            uv_i.append(uv_face[pi] + rng.normal(0, 0.3, 2))
    E = len(cam_i)
    R0 = np.stack([p[0] for p in poses])
    t0 = np.stack([p[1] for p in poses])
    R_n, t_n = [R0[0]], [t0[0]]
    for k in range(1, n_cams):
        dR, dt = JG.se3_exp(jnp.asarray(rng.normal(size=6) * 0.01,
                                        jnp.float32))
        Rk, tk = JG.se3_compose(dR, dt, jnp.asarray(R0[k]),
                                jnp.asarray(t0[k]))
        R_n.append(np.asarray(Rk))
        t_n.append(np.asarray(tk))
    X0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    prob = TB.BAProblem(
        R=torch.as_tensor(np.stack(R_n)), t=torch.as_tensor(np.stack(t_n)),
        cam_fixed=torch.as_tensor(np.arange(n_cams) == 0),
        cam_valid=torch.ones(n_cams, dtype=torch.bool),
        X=torch.as_tensor(X0), pt_valid=torch.ones(n_pts, dtype=torch.bool),
        obs_cam=torch.as_tensor(cam_i), obs_pt=torch.as_tensor(pt_i),
        obs_face=torch.as_tensor(np.array(face_i, np.int64)),
        obs_uv=torch.as_tensor(np.array(uv_i, np.float32)),
        obs_inv_sigma2=torch.ones(E), obs_valid=torch.ones(E,
                                                           dtype=torch.bool))
    out, inl = TB.bundle_adjust(TCam.from_config(SlamConfig(), "cpu"), prob,
                                solver="cg")
    for k in range(n_cams):
        assert angle_deg(out.R[k].numpy(), R0[k]) < 0.15, k
        assert np.linalg.norm(out.t[k].numpy() - t0[k]) < 0.02, k
    err = np.linalg.norm(out.X.numpy() - pts, axis=1)
    assert np.median(err) < 0.02
    assert inl.numpy().mean() > 0.9


def angle_deg(Ra, Rb):
    dR = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))


def test_global_ba_problem_from_arena():
    """``slam_map.ba_edges_from_arena`` and
    ``dist.global_ba_problem_from_arena`` on the constructed-drift arena
    (recycled slots: keyframe 0 invalidated, so the fixed keyframe is the
    next by frame id): integer and boolean fields equal, floats within
    1e-6."""
    from cubemapslam_tpu import dist as JD
    from cubemapslam_tpu import slam_map as JSM
    from cubemapslam_tpu_torch import dist as TD
    from cubemapslam_tpu_torch import interop
    from cubemapslam_tpu_torch import slam_map as TSM
    from cubemapslam_tpu_torch.runtime import synthetic as S
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128, n_features=300,
                     n_levels=3, max_keyframes=16, max_landmarks=1024)
    arena, _, _, _ = S.build_drifted_loop_arena(
        cfg, np.random.default_rng(0), n_pts=300)
    arena.kf_valid[0] = False
    arena.kf_level[3, :50] = 2
    f = interop.arena_to_numpy(arena)
    ja = JSM.MapArena(**{k: jnp.asarray(v) for k, v in f.items()})
    inv_s2 = 1.0 / np.asarray(cfg.level_sigma2, np.float32)
    jcam = JCam.from_config(cfg)
    tcam = TCam.from_config(cfg, "cpu")
    jp = JD.global_ba_problem_from_arena(jcam, ja, jnp.asarray(inv_s2))
    tp = TD.global_ba_problem_from_arena(tcam, arena, torch.as_tensor(inv_s2))
    for name in TB.BAProblem._fields:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
    assert np.nonzero(tp.cam_fixed.numpy())[0].tolist() == [1]
    sel = np.zeros(cfg.max_keyframes, bool)
    sel[[2, 11]] = True
    je = JSM.ba_edges_from_arena(jcam, ja, jnp.asarray(sel),
                                 jnp.asarray(inv_s2))
    te = TSM.ba_edges_from_arena(tcam, arena, torch.as_tensor(sel),
                                  torch.as_tensor(inv_s2))
    for a, b in zip(te, je):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_cg_masked_edges_may_be_left_out():
    """The CG solve of a problem with padding edges and of the same problem
    with them left out (the global BA of loop closing solves on the live
    edges): poses and points within 1e-6, the inlier masks equal on the
    live edges."""
    f, _ = cg_problem(np.random.default_rng(10))
    tcam = TCam.from_config(CFG, "cpu")
    full, inl_full = TB.bundle_adjust(tcam, tprob(f), solver="cg")
    keep = np.nonzero(f["obs_valid"])[0]
    g = dict(f)
    for k in ("obs_cam", "obs_pt", "obs_face", "obs_uv", "obs_inv_sigma2",
              "obs_valid"):
        g[k] = f[k][keep]
    part, inl_part = TB.bundle_adjust(tcam, tprob(g), solver="cg")
    for name in ("R", "t", "X"):
        np.testing.assert_allclose(getattr(part, name).numpy(),
                                   getattr(full, name).numpy(), atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(inl_part.numpy(), inl_full.numpy()[keep])
    assert not inl_full.numpy()[~f["obs_valid"]].any()


# ---------------------------------------------------------------------------
# The CG path's LM steps on fixed state tensors, run through CapturedLoop
# ---------------------------------------------------------------------------

def same_solve(new, old):
    (p_new, inl_new), (p_old, inl_old) = new, old
    for name in TB.BAProblem._fields:
        assert same_bits(getattr(p_new, name), getattr(p_old, name)), name
    assert same_bits(inl_new, inl_old)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_captured_loop_runs_n_steps(n):
    """``CapturedLoop.repeat(name, body, n)`` advances the state exactly n
    steps: a counter, and the CG solve with n robust steps and one plain
    one, bitwise the loop as it was before its steps updated fixed state
    tensors (``torch_parent_loops``). On the CPU nothing is captured."""
    count = torch.zeros((), dtype=torch.int64)
    loop = CapturedLoop(torch.device("cpu"))
    loop.repeat("count", lambda: count.add_(1), n)
    assert int(count) == n and (loop.captures, loop.replays) == (0, 0)
    f, _ = cg_problem(np.random.default_rng(11))
    tcam = TCam.from_config(CFG, "cpu")
    prob = tprob(f)
    new = TB.bundle_adjust(tcam, prob, phase_iters=(n, 1), solver="cg",
                           loop=CapturedLoop(torch.device("cpu")))
    same_solve(new, PARENT.bundle_adjust_cg(tcam, tprob(f), (n, 1),
                                            TB.CHI2_TH, 30))
    # the solve works on copies: the problem it was given is unchanged
    for name in TB.BAProblem._fields:
        assert same_bits(getattr(prob, name), getattr(tprob(f), name)), name


@pytest.fixture(scope="module")
def loop_ba_problem():
    """The global BA problem of the constructed-drift arena at
    ``chip_smoke.LOOP_SMALL`` over all its K*N observation slots, masked,
    and its live edges compacted (``LoopCloser._global_ba``'s sharded
    branch solves these): (camera, all slots, live edges, their slots)."""
    from cubemapslam_tpu_torch import dist as TD
    from cubemapslam_tpu_torch.config import SlamConfig as TConfig
    from cubemapslam_tpu_torch.runtime import synthetic as S
    cfg = TConfig(**chip_smoke.LOOP_SMALL)
    arena, _, _, _ = S.build_drifted_loop_arena(cfg,
                                                np.random.default_rng(42))
    tcam = TCam.from_config(cfg, "cpu")
    inv_s2 = 1.0 / torch.tensor(cfg.level_sigma2, dtype=torch.float32)
    prob = TD.global_ba_problem_from_arena(tcam, arena, inv_s2)
    keep = prob.obs_valid.nonzero()[:, 0]
    live = prob._replace(**{k: getattr(prob, k)[keep]
                            for k in TD.EDGE_FIELDS})
    return tcam, prob, live, keep


@pytest.fixture(scope="module")
def loop_ba(loop_ba_problem):
    """The global BA's live-edge problem of ``loop_ba_problem`` and the
    parent loop's solve of it (5 robust and 10 plain LM steps of 50 CG
    iterations)."""
    tcam, _, live, _ = loop_ba_problem
    return tcam, live, PARENT.bundle_adjust_cg(tcam, live, (5, 10),
                                               TB.CHI2_TH, 50)


@pytest.mark.parametrize("runner", ["captured_loop", "python_loop"])
def test_cg_loop_bitwise_parent_loop(loop_ba, runner):
    """The global BA of loop closing at the tier-1 size, its 15 LM steps
    through ``CapturedLoop`` (eager on the CPU) and as a Python loop
    (``loop=None``): every field and the inlier mask bitwise the loop as it
    was before (``torch_parent_loops.bundle_adjust_cg``)."""
    tcam, live, old = loop_ba
    loop = CapturedLoop(torch.device("cpu")) \
        if runner == "captured_loop" else None
    new = TB.bundle_adjust(tcam, live, phase_iters=(5, 10), solver="cg",
                           cg_iters=50, loop=loop)
    same_solve(new, old)


def test_cg_sharded_solve_stays_eager():
    """A solve with a process group does not take a ``CapturedLoop``: its
    collectives are not captured."""
    f, _ = cg_problem(np.random.default_rng(12))
    with pytest.raises(ValueError, match="sharded"):
        TB._bundle_adjust_cg(TCam.from_config(CFG, "cpu"), tprob(f), (1,),
                             TB.CHI2_TH, 2, group=object(),
                             loop=CapturedLoop(torch.device("cpu")))



# ---------------------------------------------------------------------------
# The global BA padded to an edge capacity (runtime/loop_closing.py)
# ---------------------------------------------------------------------------

PAD_CAPS = ("capacity", "all_slots")


@pytest.fixture(scope="module")
def padded_solves(loop_ba_problem):
    """The global BA of ``loop_ba_problem`` (5 + 10 LM steps of 50 CG
    iterations): on its compacted live edges, and on the problem padded by
    ``LoopKernels.padded_ba_problem`` to ``ba_edge_capacity`` of the live
    count and to all K*N slots (the JAX package's shape). Each: (solved
    problem, the inlier verdicts put back on the K*N slots)."""
    from cubemapslam_tpu_torch.runtime.loop_closing import LoopKernels
    tcam, prob, live, keep = loop_ba_problem
    E = prob.obs_valid.shape[0]

    def on_slots(slots, inl):
        out = torch.zeros(E + 1, dtype=torch.bool)
        return out.index_copy_(0, slots, inl)[:-1]

    out, inl = TB.bundle_adjust(tcam, live, solver="cg", cg_iters=50)
    solves = {"compacted": (out, on_slots(keep, inl))}
    count = int(prob.obs_valid.sum())
    for name, cap in zip(PAD_CAPS, (LoopKernels.ba_edge_capacity(count, E),
                                    E)):
        padded, slots = LoopKernels.padded_ba_problem(prob, cap)
        assert padded.obs_valid.shape == (cap,)
        assert int(padded.obs_valid.sum()) == count
        out, inl = TB.bundle_adjust(tcam, padded, solver="cg", cg_iters=50)
        assert not inl[count:].any()
        solves[name] = (out, on_slots(slots, inl))
    return solves


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference of ``a`` and ``b`` over the largest entry of
    ``b``."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("cap", PAD_CAPS)
def test_padded_cg_solve_against_compacted(padded_solves, cap):
    """The loop arena's global BA on its live edges padded to the edge
    capacity (4608 rows for 4294 live edges) and to all 38,400 slots,
    against the compacted solve: poses and points within 1e-5 relative,
    the inlier verdicts equal on every slot. The padded rows are dropped
    by the plans, the cost's sum among them (``_cost_plan``); on this
    problem the CPU gave the same bits."""
    (out, inl), (ref, ref_inl) = padded_solves[cap], padded_solves[
        "compacted"]
    for name in ("R", "t", "X"):
        assert max_rel(getattr(out, name), getattr(ref, name)) <= 1e-5, name
    assert torch.equal(inl, ref_inl)
    assert 0 < int(inl.sum()) < int(ref_inl.numel())


def test_padded_cg_solve_against_jax(loop_ba_problem, padded_solves):
    """The padded solve at the edge capacity against the JAX
    ``bundle_adjust(solver="cg")`` on all K*N masked slots of the same
    problem, both on the CPU: valid poses within 1e-5 (seen: 1.8e-7), the
    valid points within 5e-4 (seen: 5.2e-5 at depths up to 7.3), the
    inlier verdicts equal on every slot (seen: equal). The margins are
    about 10x: LM carries float32 rounding differences along (ROADMAP
    Queue 3, "Float32 BA rounding")."""
    tcam, prob, _, _ = loop_ba_problem
    jp = JB.BAProblem(**{k: jnp.asarray(getattr(prob, k).numpy())
                         for k in TB.BAProblem._fields})
    jout, jinl = JB.bundle_adjust(
        JCam.from_config(SlamConfig(**chip_smoke.LOOP_SMALL)), jp,
        phase_iters=(5, 10), solver="cg", cg_iters=50)
    out, inl = padded_solves["capacity"]
    cv, pv = prob.cam_valid.numpy(), prob.pt_valid.numpy()
    for name, mask, tol in (("R", cv, 1e-5), ("t", cv, 1e-5),
                            ("X", pv, 5e-4)):
        d = np.abs(getattr(out, name).numpy() - np.asarray(
            getattr(jout, name)))[mask]
        assert d.max() <= tol, (name, d.max())
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
