"""Bundle adjustment with Schur-complement reduction: the direct and the
matrix-free CG paths.

Counterpart of ``cubemapslam_tpu/optim/ba.py:36-640`` (``axis_name=None``):
Levenberg-Marquardt over a fixed-shape problem (camera table, point table,
COO observations), Huber kernel in the first phase, a chi2 and FOV cut
between phases, points marginalized by the Schur complement, the reduced
camera system assembled densely and solved by Cholesky, and the exact
post-solve retraction of the monocular scale gauge.

PyTorch idiom: the JAX ``fori_loop`` is a Python loop of the same length,
and each LM step is accepted or rejected by ``torch.where`` on the device,
so a solve makes no host read. ``torch.linalg.cholesky_ex`` does not check
its result: a failed factor (a matrix that is not positive definite) makes
the step NaN, whose cost fails ``cost < cost_old``, so LM rejects it and
keeps the old state, as the NaN factor of ``jax.scipy.linalg.cho_factor``
does. The Schur product runs in float32 with TF32 off (set at package
import).

The matrix-free CG path (``_lm_step``, ``ba.py:429-524``) serves the global
BA of loop closing: per-edge normal blocks, the reduced camera system
S = Hcc - W Hpp^-1 Wᵀ applied matrix-free (two gathers, two segment sums
and batched small products a matvec) inside a block-Jacobi preconditioned
CG of a fixed number of iterations, the point blocks inverted by the 3x3
closed form and the 6x6 preconditioner by ``torch.linalg.inv_ex`` (neither
waits). Given a ``torch.distributed`` process ``group``, the CG path is one
rank of an SPMD solve over keyframe-block shards of the edges
(``dist.distributed_bundle_adjust``): every camera-table segment sum and
both cost sums are followed by an ``all_reduce`` (the JAX ``_psum``), every
point-table sum by the boundary-prefix ``all_reduce`` of ``_psum_pts``, so
the reduced system, and with it every update, is the same on all ranks.
Without a group (``None``) no collective runs and the results are those of
the single-device path.

Every scatter-add over the edges (the JAX ``.at[idx].add``) is a
``segment.segment_sum`` on a plan built once a solve: the edge indices do not
change across its LM steps and CG iterations. On the card the plan fixes the
order of the additions, so a solve returns the same bits on every run; on the
CPU it is ``index_add_``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.distributed as dist

from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.geometry import mat3_apply, se3_compose, se3_exp
from cubemapslam_tpu_torch.optim.pose_opt import (CHI2_TH, HUBER_DELTA,
                                                  _huber_weight)
from cubemapslam_tpu_torch.optim.residuals import (reproj_jacobians,
                                                   reproj_residual)
from cubemapslam_tpu_torch.segment import SegmentPlan, segment_sum


class BAProblem(NamedTuple):
    """Fixed-shape BA state: camera table, point table, COO observations."""

    R: torch.Tensor            # (M,3,3) world->camera rotations
    t: torch.Tensor            # (M,3)
    cam_fixed: torch.Tensor    # (M,) bool: gauge and boundary keyframes
    cam_valid: torch.Tensor    # (M,) bool
    X: torch.Tensor            # (P,3) world points
    pt_valid: torch.Tensor     # (P,) bool
    obs_cam: torch.Tensor      # (E,) int64
    obs_pt: torch.Tensor       # (E,) int64
    obs_face: torch.Tensor     # (E,) int64
    obs_uv: torch.Tensor       # (E,2) in-face pixels
    obs_inv_sigma2: torch.Tensor  # (E,)
    obs_valid: torch.Tensor    # (E,) bool


def _chi2(cam: CubemapCamera, prob: BAProblem) -> torch.Tensor:
    e = reproj_residual(cam, prob.R[prob.obs_cam], prob.t[prob.obs_cam],
                        prob.X[prob.obs_pt], prob.obs_face, prob.obs_uv)
    return (e * e).sum(dim=-1) * prob.obs_inv_sigma2


def _robust_cost(chi2: torch.Tensor, active: torch.Tensor,
                 robust: bool) -> torch.Tensor:
    if robust:
        rho = torch.where(chi2 > CHI2_TH,
                          2.0 * HUBER_DELTA * torch.sqrt(
                              torch.clamp(chi2, min=1e-20)) - CHI2_TH, chi2)
    else:
        rho = chi2
    return torch.where(active, rho, torch.zeros_like(rho)).sum()


def _apply_updates(prob: BAProblem, dc: torch.Tensor, dp: torch.Tensor):
    free = prob.cam_valid & ~prob.cam_fixed
    dp = torch.where(prob.pt_valid[:, None], dp, torch.zeros_like(dp))
    dR, dt = se3_exp(dc)
    R_new, t_new = se3_compose(dR, dt, prob.R, prob.t)
    R_new = torch.where(free[:, None, None], R_new, prob.R)
    t_new = torch.where(free[:, None], t_new, prob.t)
    return R_new, t_new, prob.X + dp


# ---------------------------------------------------------------------------
# Direct dense-Schur solver, edges in per-camera row form (M, Nc) and every
# per-edge quantity a separate (M, Nc) "lane"
# ---------------------------------------------------------------------------

class _DirectCtx(NamedTuple):
    """Per-call constants of the compacted local problem (the edge graph is
    fixed across the LM iterations; only R, t and X change)."""

    obs_pt: torch.Tensor      # (M,Nc) point id per row slot
    uv: torch.Tensor          # (2,M,Nc) in-face measurements
    inv_sigma2: torch.Tensor  # (M,Nc) (0 where invalid)
    Rf: torch.Tensor          # (9,M,Nc) per-edge face-rotation lanes
    valid0: torch.Tensor      # (M,Nc) bool
    sel: torch.Tensor         # (M,Nc) original column (for the write-back)


def _make_direct_ctx(cam: CubemapCamera, prob: BAProblem,
                     Nc_max: int) -> _DirectCtx:
    """Compact each camera's observation row to its first <= Nc_max live
    entries (a stable per-row sort, live entries first) and precompute the
    per-edge constants. The flat edges must be row-major over cameras:
    obs_cam == repeat(arange(M), N), as local_ba builds them."""
    M = prob.R.shape[0]
    E0 = prob.obs_cam.shape[0]
    assert E0 % M == 0, "direct solver expects (M, N) row-major edges"
    N = E0 // M
    Nc = min(Nc_max, N)
    ok = prob.obs_valid.reshape(M, N)
    order = torch.argsort((~ok).to(torch.uint8), dim=1,
                          stable=True)[:, :Nc]            # (M,Nc)
    e_ok = torch.gather(ok, 1, order)
    obs_pt = torch.where(e_ok, torch.gather(prob.obs_pt.reshape(M, N), 1,
                                            order), 0)
    uv = torch.stack([torch.gather(prob.obs_uv[:, i].reshape(M, N), 1,
                                   order) for i in range(2)])  # (2,M,Nc)
    inv_s2 = torch.gather(prob.obs_inv_sigma2.reshape(M, N), 1, order)
    inv_s2 = torch.where(e_ok, inv_s2, torch.zeros_like(inv_s2))
    face = torch.gather(prob.obs_face.reshape(M, N), 1, order).clamp(0, 4)
    Rf = cam.face_R.reshape(5, 9).T[:, face]              # (9,M,Nc)
    return _DirectCtx(obs_pt=obs_pt, uv=uv, inv_sigma2=inv_s2, Rf=Rf,
                      valid0=e_ok, sel=order)


def _lanes_eval(cam: CubemapCamera, ctx: _DirectCtx, R, t, X):
    """Residual and camera-frame / face-frame lanes at the current state.
    Returns (Xc [3 x (M,Nc)], local [3 x (M,Nc)], e0, e1, chi2)."""
    M, Nc = ctx.obs_pt.shape
    R9 = R.reshape(M, 9).T[:, :, None]                    # (9,M,1)
    t3 = t.T[:, :, None]                                  # (3,M,1)
    X_e = X.T[:, ctx.obs_pt.reshape(-1)].reshape(3, M, Nc)
    Xc = [R9[3 * i + 0] * X_e[0] + R9[3 * i + 1] * X_e[1]
          + R9[3 * i + 2] * X_e[2] + t3[i] for i in range(3)]
    local = [ctx.Rf[3 * i + 0] * Xc[0] + ctx.Rf[3 * i + 1] * Xc[1]
             + ctx.Rf[3 * i + 2] * Xc[2] for i in range(3)]
    fx, fy, cx, cy = (cam.fxycxy[0], cam.fxycxy[1], cam.fxycxy[2],
                      cam.fxycxy[3])
    z = local[2]
    z_safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    e0 = ctx.uv[0] - (local[0] * fx / z_safe + cx)
    e1 = ctx.uv[1] - (local[1] * fy / z_safe + cy)
    chi2 = (e0 * e0 + e1 * e1) * ctx.inv_sigma2
    return Xc, local, e0, e1, chi2


def _lanes_jac(cam: CubemapCamera, ctx: _DirectCtx, R, Xc, local):
    """Pose (2x6) and point (2x3) Jacobian lanes, analytic and unrolled
    (the math of residuals.pose_jac_from_state / reproj_jacobians)."""
    M = R.shape[0]
    R9 = R.reshape(M, 9).T[:, :, None]                    # (9,M,1)
    fx, fy = cam.fxycxy[0], cam.fxycxy[1]
    lx, ly, lz = local
    z_safe = torch.where(lz.abs() < 1e-12, torch.full_like(lz, 1e-12), lz)
    iz = 1.0 / z_safe
    a0 = fx * iz
    a2 = -fx * lx * iz * iz
    b1 = fy * iz
    b2 = -fy * ly * iz * iz
    JR = [[a0 * ctx.Rf[0 + k] + a2 * ctx.Rf[6 + k] for k in range(3)],
          [b1 * ctx.Rf[3 + k] + b2 * ctx.Rf[6 + k] for k in range(3)]]
    x, y, z = Xc
    Jc, Jp = [], []
    for r in range(2):
        A0, A1, A2 = JR[r]
        h0 = A1 * z - A2 * y
        h1 = -A0 * z + A2 * x
        h2 = A0 * y - A1 * x
        Jc.append([-A0, -A1, -A2, h0, h1, h2])
        Jp.append([-(A0 * R9[0 + j] + A1 * R9[3 + j] + A2 * R9[6 + j])
                   for j in range(3)])
    return Jc, Jp


def _inv3_lanes(H, lm_lambda, pt_valid):
    """Damped symmetric 3x3 inverse in (3,3,P) lane layout, by the
    adjugate (the JAX rounding; ``linalg.inv`` would factorize)."""
    tr = H[0][0] + H[1][1] + H[2][2]
    d = lm_lambda * torch.clamp(tr / 3.0, min=1e-6) + 1e-8
    a, b, c = H[0][0] + d, H[0][1], H[0][2]
    e, f = H[1][1] + d, H[1][2]
    i = H[2][2] + d
    A = e * i - f * f
    B = c * f - b * i
    C = b * f - c * e
    det = a * A + b * B + c * C
    det_s = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    idet = torch.where(pt_valid, 1.0 / det_s, torch.zeros_like(det))
    E = a * i - c * c
    F = b * c - a * f
    I = a * e - b * b
    return [[A * idet, B * idet, C * idet],
            [B * idet, E * idet, F * idet],
            [C * idet, F * idet, I * idet]]


def _direct_plans(ctx: _DirectCtx, m_free: int, P: int):
    """The segment plans of the direct step's two scatters: the point
    sums over all edges, and the coupling of the first ``m_free`` cameras
    by (camera, point). A padding slot (``valid0`` false) has weight 0 in
    every step, so it adds exact zeros: the plans drop it (the JAX package
    adds it to point 0), and no segment collects the padding."""
    ok = ctx.valid0
    pt = torch.where(ok, ctx.obs_pt, P).reshape(-1)
    tgt = torch.where(ok[:m_free], torch.arange(
        m_free, device=ok.device)[:, None] * P + ctx.obs_pt[:m_free],
        m_free * P).reshape(-1)
    return SegmentPlan(pt, P), SegmentPlan(tgt, m_free * P)


def _lm_step_direct(cam: CubemapCamera, prob: BAProblem, ctx: _DirectCtx,
                    active, robust: bool, lm_lambda, m_free: int,
                    lanes_now=None, plans=None):
    """One damped Gauss-Newton step via the dense Schur complement and a
    Cholesky factor. The coupling and Schur blocks are built for the first
    ``m_free`` cameras only: cameras at index >= m_free must be fixed
    anchors (they still constrain the points through Hpp / bp). ``plans``:
    those of ``_direct_plans``, built here when not given."""
    M = prob.R.shape[0]
    Mf = m_free
    P = prob.X.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    pt_plan, w_plan = plans or _direct_plans(ctx, Mf, P)
    if lanes_now is None:
        lanes_now = _lanes_eval(cam, ctx, prob.R, prob.t, prob.X)
    Xc, local, e0, e1, chi2 = lanes_now
    w = ctx.inv_sigma2 * (_huber_weight(chi2) if robust else 1.0)
    w = torch.where(active, w, torch.zeros_like(w))       # (M,Nc)
    Jc, Jp = _lanes_jac(cam, ctx, prob.R, Xc, local)

    # camera side: 21 symmetric Hcc lanes + 6 bc lanes, as row sums
    cam_red = []
    for a in range(6):
        for b in range(a, 6):
            cam_red.append((w * (Jc[0][a] * Jc[0][b]
                                 + Jc[1][a] * Jc[1][b])).sum(dim=-1))
    for a in range(6):
        cam_red.append((-w * (Jc[0][a] * e0 + Jc[1][a] * e1)).sum(dim=-1))
    rows: List[List[torch.Tensor]] = [[None] * 6 for _ in range(6)]
    k = 0
    for a in range(6):
        for b in range(a, 6):
            rows[a][b] = rows[b][a] = cam_red[k][:Mf]
            k += 1
    Hcc = torch.stack([torch.stack(r) for r in rows])     # (6,6,Mf)
    bc = torch.stack([cam_red[21 + a][:Mf] for a in range(6)])  # (6,Mf)
    tr_c = sum(Hcc[a, a] for a in range(6))
    dmp_c = lm_lambda * torch.clamp(tr_c / 6.0, min=1e-6) + 1e-8
    eye6 = torch.eye(6, dtype=f32, device=dev)
    Hcc_d = Hcc + eye6[:, :, None] * dmp_c[None, None, :]

    # point side: 6 symmetric Hpp + 3 bp lanes, one 9-lane segment sum over
    # ALL edges (anchor cameras constrain the points)
    pt_lanes = []
    for b in range(3):
        for c in range(b, 3):
            pt_lanes.append(w * (Jp[0][b] * Jp[0][c] + Jp[1][b] * Jp[1][c]))
    for b in range(3):
        pt_lanes.append(-w * (Jp[0][b] * e0 + Jp[1][b] * e1))
    pt_red = segment_sum(pt_plan, torch.stack(
        [x.reshape(-1) for x in pt_lanes], dim=1)).T         # (9,P)
    Hpp = [[pt_red[0], pt_red[1], pt_red[2]],
           [pt_red[1], pt_red[3], pt_red[4]],
           [pt_red[2], pt_red[4], pt_red[5]]]
    bp = pt_red[6:9]                                      # (3,P)
    Hinv = _inv3_lanes(Hpp, lm_lambda, prob.pt_valid)     # (3,3,P) lanes

    # coupling of the FREE cameras only, scattered per camera into (Mf,18,P)
    Wv = torch.stack([
        w[:Mf] * (Jc[0][a][:Mf] * Jp[0][b][:Mf]
                  + Jc[1][a][:Mf] * Jp[1][b][:Mf])
        for a in range(6) for b in range(3)], dim=-1)     # (Mf,Nc,18)
    Wd = segment_sum(w_plan, Wv.reshape(-1, 18))          # (Mf*P,18)
    Wd = Wd.reshape(Mf, P, 18).permute(0, 2, 1).reshape(Mf, 6, 3, P)
    Hinv_s = torch.stack([torch.stack(r) for r in Hinv])  # (3,3,P)
    Y = torch.einsum("mabp,bcp->macp", Wd, Hinv_s)        # (Mf,6,3,P)
    A = Y.reshape(Mf * 6, 3 * P)
    B = Wd.reshape(Mf * 6, 3 * P)
    U = A @ B.T

    # S = Hcc_d (block diagonal) - U
    blocks = Hcc_d.permute(2, 0, 1)                       # (Mf,6,6)
    eyeM = torch.eye(Mf, dtype=f32, device=dev)
    S = (-U).reshape(Mf, 6, Mf, 6) + eyeM[:, None, :, None] \
        * blocks[:, :, None, :]
    S = S.reshape(Mf * 6, Mf * 6)
    rhs = bc.T.reshape(-1) - A @ bp.reshape(-1)

    # fixed and invalid cameras projected out: identity rows and columns
    free = (prob.cam_valid & ~prob.cam_fixed)[:Mf]
    free6 = free[:, None].expand(Mf, 6).reshape(-1)
    keep = free6[:, None] & free6[None, :]
    S = torch.where(keep, S, torch.zeros_like(S))
    S = S + torch.diag(torch.where(free6, 0.0, 1.0).to(f32))
    rhs = torch.where(free6, rhs, torch.zeros_like(rhs))

    L, info = torch.linalg.cholesky_ex(
        S + 1e-8 * torch.eye(Mf * 6, dtype=f32, device=dev))
    y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
    dcf = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    # a failed factor gives a NaN step, which LM rejects
    dcf = torch.where(info == 0, dcf, torch.full_like(dcf, float("nan")))
    dcf = dcf.reshape(Mf, 6)
    dcf = torch.where(free[:, None], dcf, torch.zeros_like(dcf))
    dc = torch.cat([dcf, torch.zeros(M - Mf, 6, dtype=f32, device=dev)])

    # back-substitution: dp = Hpp^-1 (bp - Wᵀ dc)  (anchor dc = 0)
    s_cp = (B.T @ dcf.reshape(-1)).reshape(3, P)
    r_cp = [bp[c2] - s_cp[c2] for c2 in range(3)]
    dp = torch.stack([Hinv[b][0] * r_cp[0] + Hinv[b][1] * r_cp[1]
                      + Hinv[b][2] * r_cp[2] for b in range(3)]).T  # (P,3)
    return _apply_updates(prob, dc, dp)


def _select(take: torch.Tensor, new, old):
    return torch.where(take.reshape((1,) * new.dim()), new, old)


def _bundle_adjust_direct(cam: CubemapCamera, prob: BAProblem, phase_iters,
                          chi2_cut: float, Nc_max: int, n_free: int):
    """The direct-solver BA loop (see bundle_adjust). Returns (updated
    problem, per-ORIGINAL-edge inlier mask)."""
    ctx = _make_direct_ctx(cam, prob, Nc_max)
    active = ctx.valid0
    Mf = min(n_free, prob.R.shape[0])
    dev, f32 = prob.X.device, prob.X.dtype
    plans = _direct_plans(ctx, Mf, prob.X.shape[0])

    def lm_loop(prob, active, robust, n_iters):
        lanes = list(_lanes_eval(cam, ctx, prob.R, prob.t, prob.X))
        cost = _robust_cost(lanes[4], active, robust)
        lm_lambda = torch.full((), 1e-4, dtype=f32, device=dev)
        for _ in range(n_iters):
            R_n, t_n, X_n = _lm_step_direct(cam, prob, ctx, active, robust,
                                            lm_lambda, Mf, lanes_now=lanes,
                                            plans=plans)
            cand = prob._replace(R=R_n, t=t_n, X=X_n)
            lanes_c = _lanes_eval(cam, ctx, cand.R, cand.t, cand.X)
            cost_c = _robust_cost(lanes_c[4], active, robust)
            improved = cost_c < cost
            prob = prob._replace(R=_select(improved, cand.R, prob.R),
                                 t=_select(improved, cand.t, prob.t),
                                 X=_select(improved, cand.X, prob.X))
            lanes = [[_select(improved, n, o) for n, o in zip(ln, lo)]
                     if isinstance(ln, list) else _select(improved, ln, lo)
                     for ln, lo in zip(lanes_c, lanes)]
            cost = torch.where(improved, cost_c, cost)
            lm_lambda = torch.clamp(torch.where(improved, lm_lambda * 0.5,
                                                lm_lambda * 4.0), 1e-6, 1e4)
        return prob

    anchor_state = _gauge_entry(prob)
    for phase, n in enumerate(phase_iters):
        robust = phase == 0
        prob = lm_loop(prob, active, robust, n)
        Xc, _, _, _, chi2 = _lanes_eval(cam, ctx, prob.R, prob.t, prob.X)
        d = torch.sqrt(Xc[0] ** 2 + Xc[1] ** 2 + Xc[2] ** 2)
        in_fov = Xc[2] / torch.clamp(d, min=1e-12) > cam.cos_fov_th
        active = active & (chi2 <= chi2_cut) & in_fov
    prob = _gauge_retract(prob, anchor_state)

    # the compact inlier verdicts back onto the original edges; row slots
    # dropped by the per-camera cap were never optimized and stay as given
    M = prob.R.shape[0]
    N = prob.obs_cam.shape[0] // M
    base = prob.obs_valid.reshape(M, N)
    upd = torch.where(ctx.valid0, active, torch.gather(base, 1, ctx.sel))
    inl_full = base.clone().scatter_(1, ctx.sel, upd).reshape(-1)
    return prob, inl_full


# ---------------------------------------------------------------------------
# Matrix-free Schur + preconditioned CG (ba.py:53-91, 429-524)
# ---------------------------------------------------------------------------

def _edge_terms(cam: CubemapCamera, prob: BAProblem, w: torch.Tensor):
    """Residuals and weighted normal-equation blocks of all edges."""
    Rc = prob.R[prob.obs_cam]
    tc = prob.t[prob.obs_cam]
    Xp = prob.X[prob.obs_pt]
    e = reproj_residual(cam, Rc, tc, Xp, prob.obs_face, prob.obs_uv)
    Jc, Jp = reproj_jacobians(cam, Rc, tc, Xp, prob.obs_face)
    JcT = Jc.transpose(1, 2) * w[:, None, None]          # (E,6,2)
    JpT = Jp.transpose(1, 2) * w[:, None, None]          # (E,3,2)
    Hcc_e = JcT @ Jc                                     # (E,6,6)
    Hpp_e = JpT @ Jp                                     # (E,3,3)
    W_e = JcT @ Jp                                       # (E,6,3)
    bc_e = -(JcT @ e[..., None])[..., 0]                 # (E,6) = -JᵀWe
    bp_e = -(JpT @ e[..., None])[..., 0]                 # (E,3)
    return e, Hcc_e, Hpp_e, W_e, bc_e, bp_e


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """``ba.py:53-54``: the sum of ``x`` over the ranks of ``group``, in
    place; ``x`` itself without a group."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _psum_pts(x: torch.Tensor, group, n_boundary) -> torch.Tensor:
    """``ba.py:57-75``: a point-table reduction that exchanges only the
    boundary prefix. With landmark ownership by keyframe block
    (``dist.shard_ba_problem(shard_points=True)``), a point seen from one
    block has all its edges on that rank, so its rows are complete there and
    never read elsewhere; only the first ``n_boundary`` rows (points seen
    from >= 2 blocks, permuted to the front) are summed over the ranks.
    ``n_boundary=None`` sums the whole table."""
    if group is None or n_boundary is None:
        return _psum(x, group)
    if n_boundary > 0:
        # a prefix of the first dimension is a contiguous view, reduced in
        # place
        dist.all_reduce(x[:n_boundary], group=group)
    return x


def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n), as a product
    and a sum: a batched GEMM of a million 3x6 blocks runs one tiny matrix
    a thread block on the card."""
    return (A * x[..., None, :]).sum(-1)


def _cg_plans(prob: BAProblem):
    """The segment plans of the CG step: edges by camera and by point. A
    masked edge (``obs_valid`` false: padding, as in a shard) has weight 0
    in every step and adds exact zeros, so the plans drop it."""
    M, P = prob.R.shape[0], prob.X.shape[0]
    ok = prob.obs_valid
    return (SegmentPlan(torch.where(ok, prob.obs_cam, M), M),
            SegmentPlan(torch.where(ok, prob.obs_pt, P), P))


def _lm_step(cam: CubemapCamera, prob: BAProblem, active, robust: bool,
             lm_lambda, cg_iters: int, group=None, n_boundary=None,
             plans=None):
    """One damped Gauss-Newton step via the Schur complement and a
    matrix-free, block-Jacobi preconditioned CG of ``cg_iters`` iterations
    (``ba.py:429-524``), with the edges of this rank's shard when ``group``
    is set. ``plans``: those of ``_cg_plans``, built here when not given.
    Returns the candidate (R, t, X)."""
    M = prob.R.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    cam_plan, pt_plan = plans or _cg_plans(prob)
    chi2 = _chi2(cam, prob)
    w = prob.obs_inv_sigma2 * (_huber_weight(chi2) if robust else 1.0)
    w = torch.where(active, w, torch.zeros_like(w))
    _, Hcc_e, Hpp_e, W_e, bc_e, bp_e = _edge_terms(cam, prob, w)
    Hcc = _psum(segment_sum(cam_plan, Hcc_e), group)
    Hpp = _psum_pts(segment_sum(pt_plan, Hpp_e), group, n_boundary)
    bc = _psum(segment_sum(cam_plan, bc_e), group)
    bp = _psum_pts(segment_sum(pt_plan, bp_e), group, n_boundary)

    # damped point blocks, inverted by the 3x3 closed form (the same damped
    # matrix as the JAX code's jnp.linalg.inv; zero for invalid points)
    Hinv = _inv3_lanes([[Hpp[:, a, b] for b in range(3)] for a in range(3)],
                       lm_lambda, prob.pt_valid)
    Hpp_inv = torch.stack([torch.stack(r, -1) for r in Hinv], -2)  # (P,3,3)

    eye6 = torch.eye(6, dtype=f32, device=dev)
    tr_c = torch.diagonal(Hcc, dim1=1, dim2=2).sum(-1)
    Hcc_d = Hcc + (lm_lambda * eye6)[None] * torch.clamp(
        tr_c[:, None, None] / 6.0, min=1e-6)
    Hcc_d = Hcc_d + 1e-8 * eye6[None]

    free = prob.cam_valid & ~prob.cam_fixed               # (M,)
    fr = free[:, None]
    W_eT = W_e.transpose(1, 2)                            # (E,3,6)

    def schur_matvec(x):
        """x: (M,6) -> S x, with fixed cameras projected out."""
        x = torch.where(fr, x, torch.zeros_like(x))
        hx = _bmv(Hcc_d, x)
        s = _psum_pts(segment_sum(pt_plan, _bmv(W_eT, x[prob.obs_cam])),
                      group, n_boundary)
        y = _bmv(Hpp_inv, s)
        coup = _psum(segment_sum(cam_plan, _bmv(W_e, y[prob.obs_pt])),
                     group)
        return torch.where(fr, hx - coup, x)

    # reduced rhs: bc - W Hpp^-1 bp
    yb = _bmv(Hpp_inv, bp)
    rhs = bc - _psum(segment_sum(cam_plan, _bmv(W_e, yb[prob.obs_pt])),
                     group)
    rhs = torch.where(fr, rhs, torch.zeros_like(rhs))

    # block-Jacobi preconditioner (inv_ex: no error check, no host wait)
    Pinv = torch.linalg.inv_ex(Hcc_d)[0]

    def precond(r):
        return torch.where(fr, _bmv(Pinv, r), r)

    x = torch.zeros(M, 6, dtype=f32, device=dev)
    r = rhs
    z = precond(r)
    p = z
    for _ in range(cg_iters):
        Ap = schur_matvec(p)
        rz = (r * z).sum()
        alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        beta = (r_new * z_new).sum() / torch.clamp(rz, min=1e-20)
        p = z_new + beta * p
        r, z = r_new, z_new
    dc = x

    # back-substitute the point updates
    s = _psum_pts(segment_sum(pt_plan, _bmv(W_eT, dc[prob.obs_cam])),
                  group, n_boundary)
    dp = _bmv(Hpp_inv, bp - s)
    dp = torch.where(prob.pt_valid[:, None], dp, torch.zeros_like(dp))
    dR, dt = se3_exp(dc)
    R_new, t_new = se3_compose(dR, dt, prob.R, prob.t)
    R_new = torch.where(free[:, None, None], R_new, prob.R)
    t_new = torch.where(fr, t_new, prob.t)
    return R_new, t_new, prob.X + dp


def _bundle_adjust_cg(cam: CubemapCamera, prob: BAProblem, phase_iters,
                      chi2_cut: float, cg_iters: int, group=None,
                      n_boundary=None):
    """The CG-solver BA loop (``ba.py:601-640``), one rank of the SPMD
    solve when ``group`` is set. Returns (updated problem, per-edge inlier
    mask)."""
    active = prob.obs_valid
    dev, f32 = prob.X.device, prob.X.dtype
    plans = _cg_plans(prob)

    def lm_loop(prob, active, robust, n_iters):
        lm_lambda = torch.full((), 1e-4, dtype=f32, device=dev)
        for _ in range(n_iters):
            cost = _psum(_robust_cost(_chi2(cam, prob), active, robust),
                         group)
            R_n, t_n, X_n = _lm_step(cam, prob, active, robust, lm_lambda,
                                     cg_iters, group, n_boundary, plans)
            cand = prob._replace(R=R_n, t=t_n, X=X_n)
            cost_n = _psum(_robust_cost(_chi2(cam, cand), active, robust),
                           group)
            improved = cost_n < cost
            prob = prob._replace(R=_select(improved, cand.R, prob.R),
                                 t=_select(improved, cand.t, prob.t),
                                 X=_select(improved, cand.X, prob.X))
            # lambda floor 1e-6: the damping bounds the motion along
            # near-null gauge directions in the CG solve
            lm_lambda = torch.clamp(torch.where(improved, lm_lambda * 0.5,
                                                lm_lambda * 4.0), 1e-6, 1e4)
        return prob

    anchor_state = _gauge_entry(prob)
    for phase, n in enumerate(phase_iters):
        robust = phase == 0
        prob = lm_loop(prob, active, robust, n)
        chi2 = _chi2(cam, prob)
        # outlier cut + FOV cheirality (behind-camera points)
        Xc = mat3_apply(prob.R[prob.obs_cam], prob.X[prob.obs_pt]) \
            + prob.t[prob.obs_cam]
        d = torch.linalg.norm(Xc, dim=-1)
        in_fov = Xc[..., 2] / torch.clamp(d, min=1e-12) > cam.cos_fov_th
        active = active & (chi2 <= chi2_cut) & in_fov
    prob = _gauge_retract(prob, anchor_state)
    return prob, active


# ---------------------------------------------------------------------------
# Scale gauge (ba.py:527-566)
# ---------------------------------------------------------------------------

def _centers(p: BAProblem) -> torch.Tensor:
    return -mat3_apply(p.R.transpose(-1, -2), p.t)


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without reading it to the host."""
    return x.index_select(0, i.reshape(1))[0]


def _gauge_entry(prob: BAProblem):
    """Scale-gauge anchor: with at most one fixed camera, uniform scaling
    about it is an exact null direction of monocular BA. Remember the
    distance from the anchor to the farthest valid camera at entry; the
    retraction removes the pure-scale motion after the solve."""
    fixedv = prob.cam_fixed & prob.cam_valid
    n_fixedv = fixedv.sum()
    anchor = torch.where(fixedv.any(), torch.argmax(fixedv.to(torch.int8)),
                         torch.argmax(prob.cam_valid.to(torch.int8)))
    c0 = _centers(prob)
    ref_d = torch.linalg.norm(c0 - _row(c0, anchor), dim=-1)
    gauge_j = torch.argmax(torch.where(prob.cam_valid, ref_d,
                                       torch.full_like(ref_d, -1.0)))
    return anchor, gauge_j, _row(ref_d, gauge_j), n_fixedv


def _gauge_retract(prob: BAProblem, anchor_state) -> BAProblem:
    anchor, gauge_j, d_in, n_fixedv = anchor_state
    c1 = _centers(prob)
    ca = _row(c1, anchor)
    d_out = torch.linalg.norm(_row(c1, gauge_j) - ca)
    s = torch.where((n_fixedv <= 1) & (d_out > 1e-9) & (d_in > 1e-9),
                    d_in / d_out, torch.ones_like(d_out))
    c_new = ca + s * (c1 - ca)
    t_new = -mat3_apply(prob.R, c_new)
    X_new = ca + s * (prob.X - ca)
    free = prob.cam_valid & ~prob.cam_fixed
    return prob._replace(
        t=torch.where(free[:, None], t_new, prob.t),
        X=torch.where(prob.pt_valid[:, None], X_new, prob.X))


def bundle_adjust(cam: CubemapCamera, prob: BAProblem,
                  phase_iters: Tuple[int, ...] = (5, 10),
                  chi2_cut: float = CHI2_TH,
                  solver: str = "direct",
                  max_obs_per_cam: int = 1024,
                  n_free: int = None,
                  cg_iters: int = 30,
                  group=None,
                  n_boundary: int = None) -> Tuple[BAProblem, torch.Tensor]:
    """Two-phase LM BA (``ba.py:569-640``): 5 robust iterations, the chi2
    and FOV cut, 10 plain iterations, the final cut, then the scale-gauge
    retraction. ``solver="direct"`` is the dense-Schur Cholesky path for
    compact local problems: the edges are row-major (M, N), each camera's
    row compacted to ``max_obs_per_cam`` live entries, and the cameras at
    index >= ``n_free`` fixed anchors. ``solver="cg"`` is the matrix-free
    Schur-CG path (``cg_iters`` CG iterations an LM step) for any COO
    problem, as the global BA after a loop closure uses it. The default
    stays ``"direct"``, where the JAX package's is ``"cg"``. With a
    ``torch.distributed`` ``group`` (the JAX ``axis_name``), ``solver="cg"``
    is this rank's part of the SPMD solve: ``prob`` holds the full camera
    and point tables and this rank's edges, and ``n_boundary`` limits the
    point-table exchange to the boundary prefix (``_psum_pts``).

    Returns (updated problem, per-edge inlier mask)."""
    assert solver in ("cg", "direct"), solver
    assert not (solver == "direct" and group is not None)
    if solver == "cg":
        return _bundle_adjust_cg(cam, prob, phase_iters, chi2_cut, cg_iters,
                                 group, n_boundary)
    nf = prob.R.shape[0] if n_free is None else n_free
    return _bundle_adjust_direct(cam, prob, phase_iters, chi2_cut,
                                 max_obs_per_cam, nf)
