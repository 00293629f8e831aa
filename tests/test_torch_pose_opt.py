"""Port parity: reprojection residuals and pose-only LM.

Residuals and Jacobians agree elementwise within 1e-5 (relative). The
normal equations are summed in another order than XLA's, so the optimised
pose agrees within 1e-4 and the inlier mask is the same except for edges
whose final chi2 lies within 1e-3 of the 5.991 gate.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cubemapslam_tpu import geometry as JG
from cubemapslam_tpu.camera import CubemapCamera as JCam
from cubemapslam_tpu.config import SlamConfig
from cubemapslam_tpu.optim import pose_opt as JP
from cubemapslam_tpu.optim import residuals as JR
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam
from cubemapslam_tpu_torch.optim import pose_opt as TP
from cubemapslam_tpu_torch.optim import residuals as TR


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def cams():
    cfg = SlamConfig(cube_face_w=128, cube_face_h=128)
    return JCam.from_config(cfg), TCam.from_config(cfg, "cpu")


def problem(seed, n=300, noise=0.5, outliers=0.15):
    """Landmarks seen on their own faces from a known pose, with pixel
    noise and gross outliers."""
    rng = np.random.default_rng(seed)
    R = np.asarray(JG.so3_exp(jnp.asarray([0.05, -0.1, 0.03], jnp.float32)))
    t = np.array([0.1, -0.05, 0.2], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Xc = d * rng.uniform(2, 8, (n, 1)).astype(np.float32)
    Xw = ((Xc - t) @ R).astype(np.float32)               # R^T (Xc - t)
    a = np.abs(Xc)
    face = np.select([(Xc[:, 2] >= a[:, 0]) & (Xc[:, 2] >= a[:, 1]),
                      Xc[:, 0] >= a[:, 1], Xc[:, 0] <= -a[:, 1],
                      Xc[:, 1] >= 0], [0, 2, 1, 4], 3).astype(np.int32)
    return rng, R, t, Xw, face, Xc


def test_residuals_and_jacobians(cams):
    jcam, tcam = cams
    rng, R, t, Xw, face, _ = problem(0)
    uv = rng.uniform(0, 128, (len(Xw), 2)).astype(np.float32)
    np.testing.assert_allclose(
        TR.reproj_residual(tcam, T(R), T(t), T(Xw), T(face, torch.int64),
                           T(uv)).numpy(),
        np.asarray(JR.reproj_residual(jcam, R, t, Xw, face, uv)),
        rtol=1e-5, atol=1e-3)
    for a, b in zip(TR.reproj_jacobians(tcam, T(R), T(t), T(Xw),
                                        T(face, torch.int64)),
                    JR.reproj_jacobians(jcam, R, t, Xw, face)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)
    local = np.asarray(JG.mat3_apply(jcam.face_R[face], Xw))
    np.testing.assert_allclose(
        TR._proj_jac_local(tcam, T(local)).numpy(),
        np.asarray(JR._proj_jac_local(jcam, jnp.asarray(local))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pose_optimization(cams, seed):
    jcam, tcam = cams
    rng, R, t, Xw, face, Xc = problem(seed)
    uv = np.asarray(JR.project_to_face(jcam, jnp.asarray(Xc), face))
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    bad = rng.uniform(size=len(uv)) < 0.15
    uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2)).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 3, len(uv))).astype(np.float32)
    valid = rng.uniform(size=len(uv)) < 0.95
    # start 2 degrees and 5 cm off
    dR = np.asarray(JG.so3_exp(jnp.asarray([0.02, 0.02, -0.02],
                                           jnp.float32)))
    R0 = (dR @ R).astype(np.float32)
    t0 = (t + np.array([0.05, -0.03, 0.02], np.float32)).astype(np.float32)
    jR, jt, jinl, jn = JP.pose_optimization(jcam, R0, t0, Xw, face, uv,
                                            inv_s2, valid)
    tR, tt, tinl, tn = TP.pose_optimization(
        tcam, T(R0), T(t0), T(Xw), T(face, torch.int64), T(uv), T(inv_s2),
        T(valid, torch.bool))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    e = np.asarray(JR.reproj_residual(jcam, jR, jt, Xw, face, uv))
    chi2 = (e * e).sum(1) * inv_s2
    edge = np.abs(chi2 - 5.991) < 1e-3
    np.testing.assert_array_equal(tinl.numpy()[~edge],
                                  np.asarray(jinl)[~edge])
    assert abs(int(tn) - int(jn)) <= edge.sum()
    assert int(jn) > 200


# ---------------------------------------------------------------------------
# The pose-LM kernel's order (pose_optimization_ordered) and the CPU path
# ---------------------------------------------------------------------------

import chip_smoke                                           # noqa: E402
import test_torch_tracking as TT                            # noqa: E402
from cubemapslam_tpu_torch.config import SlamConfig as TConfig  # noqa: E402
from cubemapslam_tpu_torch.geometry import (se3_compose,    # noqa: E402
                                            se3_exp)
from cubemapslam_tpu_torch.optim.residuals import (         # noqa: E402
    eval_point, pose_jac_from_state)
from cubemapslam_tpu_torch.runtime import kernels as TK    # noqa: E402

scene = TT.scene                   # the tracking tests' map, built here too
SMALL_FACES = dict(cube_face_w=128, cube_face_h=128)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lm_args(n, seed, **kw):
    """``chip_smoke.lm_problem`` on the CPU at 128^2 faces: (R0, t0, Xw,
    face, uv_face, inv_sigma2, valid); seeds 1-3 at n = 300 are the seeded
    problems of ``test_pose_optimization``."""
    return chip_smoke.lm_problem(TConfig(**SMALL_FACES), n, seed, "cpu", **kw)


def held_to_jax(jcam, tcam, args, out, tol=1e-4):
    """``out`` (R, t, inliers, n) against the JAX solve on the same inputs:
    pose within ``tol``, inliers equal except for edges whose JAX chi2 lies
    within 1e-3 of the 5.991 gate. Returns the JAX iterate's inlier
    count."""
    R0, t0, Xw, face, uv, inv_s2, valid = (a.numpy() for a in args)
    face = face.astype(np.int32)
    jR, jt, jinl, jn = JP.pose_optimization(jcam, R0, t0, Xw, face, uv,
                                            inv_s2, valid)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jR), atol=tol)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jt), atol=tol)
    e = np.asarray(JR.reproj_residual(jcam, jR, jt, Xw, face, uv))
    chi2 = (e * e).sum(1) * inv_s2
    edge = np.abs(chi2 - 5.991) < 1e-3
    np.testing.assert_array_equal(out[2].numpy()[~edge],
                                  np.asarray(jinl)[~edge])
    assert abs(int(out[3]) - int(jn)) <= edge.sum()
    return int(jn)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ordered_against_jax(cams, seed):
    """The kernel's order of sums, solve and step (the plain
    ``pose_optimization_ordered``) against JAX on the seeded problems of
    ``test_pose_optimization``, with its tolerances."""
    jcam, tcam = cams
    args = lm_args(300, seed)
    out = TP.pose_optimization_ordered(tcam, *args)
    assert held_to_jax(jcam, tcam, args, out) > 200
    assert out[4].dtype == torch.int32 and out[4].shape == (4,)
    assert int(out[5][0]) == int(args[6].sum())     # round 1 sums the valid
    assert int(out[5][-1]) == int(out[3])           # later rounds the inliers


def test_ordered_on_tracking_arena(scene, monkeypatch):
    """The first pose-only LM of the tracking tests' frame (its motion
    match against the map, the inputs ``TrackingKernels.optimize_pose``
    hands ``pose_optimization``) through ``pose_optimization_ordered``
    and JAX: the same tolerances."""
    tk, kp = scene["tracker"].kernels, scene["kps"][TT.NEXT]
    R, t = TT.gt_pose(scene, TT.NEXT - 1)
    arena = TT.interop.arena_from_numpy(scene["arena_np"])
    assoc, _ = tk.track_last_frame(arena, kp, *TT.motion_inputs(scene), R, t)
    seen = []

    def recorded(cam, *args):
        seen.append(args)
        return TP.pose_optimization(cam, *args)

    monkeypatch.setattr(TK, "pose_optimization", recorded)
    tk.optimize_pose(arena, kp, assoc, R, t)
    args = seen[0]
    out = TP.pose_optimization_ordered(tk.cam, *args)
    assert held_to_jax(scene["jcam"], tk.cam, args, out) > 30
    assert int(args[6].sum()) > 50


@pytest.mark.parametrize("case", ["no_valid_edge", "no_edge", "n_37",
                                  "n_1000", "at_optimum"])
def test_ordered_edge_cases(cams, case):
    """No valid edge and no edge at all (pose unchanged, no inlier, every
    iteration run: nothing improves); N not a multiple of a warp (37) nor
    of the block (1000), against JAX; a start at the optimum of noise-free
    data, where the early exit fires in round 1 (one iteration), against
    JAX and the truth."""
    jcam, tcam = cams
    if case in ("no_valid_edge", "no_edge"):
        args = list(lm_args(37, 4))
        args[6] = torch.zeros_like(args[6])
        if case == "no_edge":
            args = args[:2] + [a[:0] for a in args[2:]]
        R, t, inl, n, iters, counted = TP.pose_optimization_ordered(
            tcam, *args)
        assert torch.equal(R, args[0]) and torch.equal(t, args[1])
        assert int(n) == 0 and not bool(inl.any())
        assert iters.tolist() == [10] * 4 and counted.tolist() == [0] * 4
        return
    if case == "at_optimum":
        args = list(lm_args(300, 1, noise=0.0, outliers=0.0))
        args[0] = chip_smoke.so3_exp(torch.tensor([0.05, -0.1, 0.03]))
        args[1] = torch.tensor([0.1, -0.05, 0.2])
    else:
        args = lm_args(int(case[2:]), 5)
    out = TP.pose_optimization_ordered(tcam, *args)
    held_to_jax(jcam, tcam, args, out)
    if case == "at_optimum":
        assert int(out[4][0]) == 1
        assert float((out[0] - args[0]).abs().max()) < 1e-5
        assert float((out[1] - args[1]).abs().max()) < 1e-5
    else:
        assert int(out[3]) > 0.6 * len(args[2])


def test_block_sum_order():
    """``_block_sum`` is the kernel's reduction, emulated thread by thread
    in float32: thread k adds rows k, k + 512, ... from 0; each warp's tree
    of offsets 16, 8, 4, 2, 1; the 16 warp sums in warp order."""
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(1300, 5))
         * 10.0 ** rng.uniform(-4, 4, (1300, 5))).astype(np.float32)
    threads = np.zeros((TP.LM_THREADS, 5), np.float32)
    for i in range(len(v)):
        threads[i % TP.LM_THREADS] = threads[i % TP.LM_THREADS] + v[i]
    warps = threads.reshape(TP.LM_WARPS, 32, 5)
    for off in (16, 8, 4, 2, 1):
        warps = warps.copy()
        warps[:, :off] = warps[:, :off] + warps[:, off:2 * off]
    total = warps[0, 0]
    for w in range(1, TP.LM_WARPS):
        total = total + warps[w, 0]
    assert np.array_equal(TP._block_sum(torch.as_tensor(v)).numpy(), total)


def _same_bits(a, b):
    """Equal float32 bits wherever neither is NaN, NaN at the same places
    (a NaN's payload depends on the operand order, which the card does not
    keep: it gives the one canonical NaN)."""
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb) and np.array_equal(
        np.where(na, 0, a.view(np.uint32)), np.where(nb, 0, b.view(np.uint32))))


def _reduce_scatter(a):
    """The kernel's transposed warp reduction, lane by lane: (32 lanes, 32
    values) -> (32,), lane k's sum of value k. At offset o (16, 8, 4, 2, 1)
    lane l keeps the o values whose bit o matches its own, sends the other
    o to lane l ^ o and adds what it receives to what it keeps."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        upper = ((lanes & o) != 0)[:, None]
        lo, hi = a[:, :o], a[:, o:2 * o]
        keep = np.where(upper, hi, lo)
        send = np.where(upper, lo, hi)
        a = keep + send[lanes ^ o]
    return a[:, 0]


def _reduction_values(rng):
    """(1300, 28) float32 edge terms over 8 decades, with lanes whose sums
    cancel (x and -x a thread, huge and tiny terms mixed), lanes with +inf,
    -inf, both (NaN sums) and a NaN term."""
    n = 1300
    v = (rng.normal(size=(n, 28))
         * 10.0 ** rng.uniform(-4, 4, (n, 28))).astype(np.float32)
    v[512:1024, 3] = -v[:512, 3]
    v[:, 4] = np.where(np.arange(n) % 3 == 0, 1e4, -1e4) + v[:, 4] * 1e-4
    v[5, 7] = np.inf
    v[700, 8] = -np.inf
    v[9, 9], v[600, 9] = np.inf, -np.inf
    v[33, 10] = np.nan
    return v


@pytest.mark.parametrize("model", ["reduce_scatter", 1, 2, 4, 8])
def test_kernel_reduction_order(model):
    """The kernel's reduction gives ``_block_sum``'s bits. "reduce_scatter":
    a numpy model of the transposed warp reduction (28 values padded to 32,
    31 shuffles a warp) equals the shuffle tree's warp sums and, added in
    warp order, ``_block_sum``. C = 1, 2, 4, 8: the 16 warps split over a
    cluster of C blocks (virtual thread v = block * 512 / C + thread, warp w
    in block w // (16 / C)), each block's warp sums in its own buffer, and
    every block re-adding all 16 in warp order from the others' buffers,
    gives ``_block_sum``'s bits in every block."""
    rng = np.random.default_rng(0)
    v = _reduction_values(rng)
    want = TP._block_sum(torch.as_tensor(v)).numpy()
    threads = np.zeros((TP.LM_THREADS, 32), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(len(v)):
            threads[i % TP.LM_THREADS, :28] = (
                threads[i % TP.LM_THREADS, :28] + v[i])
        warps = threads.reshape(TP.LM_WARPS, 32, 32)
        if model == "reduce_scatter":
            tree = warps[..., :28]
            for off in (16, 8, 4, 2, 1):
                tree = tree[:, :off] + tree[:, off:2 * off]
            sums = np.stack([_reduce_scatter(w)[:28] for w in warps])
            assert _same_bits(sums, tree[:, 0])
            total = sums[0]
            for w in range(1, TP.LM_WARPS):
                total = total + sums[w]
            assert _same_bits(total, want)
            return
        per_block, per_warp = TP.LM_THREADS // model, TP.LM_WARPS // model
        buffers = []
        for b in range(model):
            own = threads[b * per_block:(b + 1) * per_block]
            buffers.append(np.stack([
                _reduce_scatter(w) for w in own.reshape(per_warp, 32, 32)]))
        for b in range(model):
            total = buffers[0][0]
            for w in range(1, TP.LM_WARPS):
                total = total + buffers[w // per_warp][w % per_warp]
            assert _same_bits(total[:28], want)


def _parent_pose_optimization(cam, R0, t0, Xw, face, uv_face, inv_sigma2,
                              valid, n_rounds=4, n_iters=10):
    """The port's pose_optimization before its CUDA kernel (the CPU body),
    copied verbatim."""
    R_face = cam.face_R[face.clamp(0, 4).long()]
    dev, dt_ = R0.device, R0.dtype
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def eval_at(R, t):
        e, Xc, local = eval_point(cam, R, t, Xw, R_face, uv_face)
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
        return e, chi2, Xc, local

    def rho_cost(chi2, robust, inl):
        if robust:
            rho = torch.where(chi2 <= TP.CHI2_TH, chi2,
                              2.0 * TP.HUBER_DELTA * torch.sqrt(
                                  torch.clamp(chi2, min=1e-20)) - TP.CHI2_TH)
        else:
            rho = chi2
        return torch.sum(torch.where(inl & valid, rho,
                                     torch.zeros_like(rho)))

    def sel(c, a, b):
        return torch.where(c, a, b)

    R, t = R0, t0
    e, chi2, Xc, local = eval_at(R, t)
    inl = valid
    for r in range(n_rounds):
        robust = r < 2  # rounds 3-4 drop the Huber kernel
        cost = rho_cost(chi2, robust, inl)
        lm_lambda = torch.full((), 1e-3, dtype=dt_, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            w = inv_sigma2 * (TP._huber_weight(chi2) if robust else 1.0)
            w = torch.where(inl & valid, w, torch.zeros_like(w))
            Jp = pose_jac_from_state(cam, Xc, local, R_face)    # (N,2,6)
            JW = Jp * w[:, None, None]
            H = torch.sum(JW[..., :, None] * Jp[..., None, :], dim=(0, 1))
            b = -torch.sum(JW * e[..., None], dim=(0, 1))
            H_d = H + lm_lambda * torch.diag(torch.diag(H)) + 1e-9 * eye6
            delta = torch.linalg.solve_ex(H_d, b)[0]
            dR, dt = se3_exp(delta)
            R_new, t_new = se3_compose(dR, dt, R, t)
            e2, chi22, Xc2, local2 = eval_at(R_new, t_new)
            cost2 = rho_cost(chi22, robust, inl)
            improved = cost2 < cost
            take = improved & active
            R = sel(take, R_new, R)
            t = sel(take, t_new, t)
            e = sel(take, e2, e)
            chi2 = sel(take, chi22, chi2)
            Xc = sel(take, Xc2, Xc)
            local = sel(take, local2, local)
            cost = sel(take, cost2, cost)
            lm_new = torch.clamp(sel(improved, lm_lambda * 0.5,
                                     lm_lambda * 4.0), 1e-8, 1e4)
            lm_lambda = sel(active, lm_new, lm_lambda)
            active = active & ~(improved & (torch.sum(delta * delta)
                                            < 1e-12))
        inl = valid & (chi2 <= TP.CHI2_TH)
    return R, t, inl, inl.sum()


@pytest.mark.parametrize("seed", [1, 2, 3, "no_valid_edge"])
def test_cpu_path_is_the_parent_body(cams, seed):
    """On CPU tensors ``pose_optimization`` is bitwise the port's CPU body
    from before the kernel (the masked iterations), so every CPU result and
    parity test stays as it was."""
    _, tcam = cams
    args = list(lm_args(300, 1 if seed == "no_valid_edge" else seed))
    if seed == "no_valid_edge":
        args[6] = torch.zeros_like(args[6])
    got = TP.pose_optimization(tcam, *args)
    want = _parent_pose_optimization(tcam, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert TP.POSE_LM.launches == 0
