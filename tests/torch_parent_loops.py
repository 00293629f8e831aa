"""The loops of loop closing's two solvers as they were before their bodies
were captured as CUDA graphs: the CG bundle adjustment's LM steps
(``optim/ba.py``, ``_bundle_adjust_cg`` with its ``_lm_step`` and the
robust cost) and the essential graph's Gauss-Newton iterations
(``optim/pose_graph.py``, ``optimize_essential_graph``), each a Python loop
that rebinds its state every iteration and takes ``robust`` as a Python
bool. The tests hold the restructured loops, which update fixed state
tensors in place, bitwise against these. Not a test module: the tests
import it.
"""

from typing import Tuple

import torch

from cubemapslam_tpu_torch import geometry as TG
from cubemapslam_tpu_torch import segment as TSG
from cubemapslam_tpu_torch.optim import ba as TB
from cubemapslam_tpu_torch.optim import pose_graph as TP


def robust_cost(chi2: torch.Tensor, active: torch.Tensor,
                robust: bool) -> torch.Tensor:
    if robust:
        rho = torch.where(chi2 > TB.CHI2_TH,
                          2.0 * TB.HUBER_DELTA * torch.sqrt(
                              torch.clamp(chi2, min=1e-20)) - TB.CHI2_TH,
                          chi2)
    else:
        rho = chi2
    return torch.where(active, rho, torch.zeros_like(rho)).sum()


def lm_step(cam, prob, active, robust: bool, lm_lambda, cg_iters: int,
            group=None, n_boundary=None, plans=None):
    """One LM step of the CG path, ``robust`` a Python bool. Returns the
    candidate (R, t, X)."""
    M = prob.R.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    cam_plan, pt_plan = plans or TB._cg_plans(prob)
    chi2 = TB._chi2(cam, prob)
    w = prob.obs_inv_sigma2 * (TB._huber_weight(chi2) if robust else 1.0)
    w = torch.where(active, w, torch.zeros_like(w))
    _, Hcc_e, Hpp_e, W_e, bc_e, bp_e = TB._edge_terms(cam, prob, w)
    Hcc = TB._psum(TB.segment_sum(cam_plan, Hcc_e), group)
    Hpp = TB._psum_pts(TB.segment_sum(pt_plan, Hpp_e), group, n_boundary)
    bc = TB._psum(TB.segment_sum(cam_plan, bc_e), group)
    bp = TB._psum_pts(TB.segment_sum(pt_plan, bp_e), group, n_boundary)

    # damped point blocks, inverted by the 3x3 closed form (the same damped
    # matrix as the JAX code's jnp.linalg.inv; zero for invalid points)
    Hinv = TB._inv3_lanes([[Hpp[:, a, b] for b in range(3)]
                           for a in range(3)], lm_lambda, prob.pt_valid)
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
        hx = TB._bmv(Hcc_d, x)
        s = TB._psum_pts(TB.segment_sum(
            pt_plan, TB._bmv(W_eT, x[prob.obs_cam])), group, n_boundary)
        y = TB._bmv(Hpp_inv, s)
        coup = TB._psum(TB.segment_sum(
            cam_plan, TB._bmv(W_e, y[prob.obs_pt])), group)
        return torch.where(fr, hx - coup, x)

    # reduced rhs: bc - W Hpp^-1 bp
    yb = TB._bmv(Hpp_inv, bp)
    rhs = bc - TB._psum(TB.segment_sum(
        cam_plan, TB._bmv(W_e, yb[prob.obs_pt])), group)
    rhs = torch.where(fr, rhs, torch.zeros_like(rhs))

    # block-Jacobi preconditioner (inv_ex: no error check, no host wait)
    Pinv = torch.linalg.inv_ex(Hcc_d)[0]

    def precond(r):
        return torch.where(fr, TB._bmv(Pinv, r), r)

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
    s = TB._psum_pts(TB.segment_sum(
        pt_plan, TB._bmv(W_eT, dc[prob.obs_cam])), group, n_boundary)
    dp = TB._bmv(Hpp_inv, bp - s)
    dp = torch.where(prob.pt_valid[:, None], dp, torch.zeros_like(dp))
    dR, dt = TB.se3_exp(dc)
    R_new, t_new = TB.se3_compose(dR, dt, prob.R, prob.t)
    R_new = torch.where(free[:, None, None], R_new, prob.R)
    t_new = torch.where(fr, t_new, prob.t)
    return R_new, t_new, prob.X + dp


def bundle_adjust_cg(cam, prob, phase_iters, chi2_cut: float, cg_iters: int,
                     group=None, n_boundary=None):
    """The CG path's two-phase LM loop. Returns (updated problem, per-edge
    inlier mask)."""
    active = prob.obs_valid
    dev, f32 = prob.X.device, prob.X.dtype
    plans = TB._cg_plans(prob)

    def lm_loop(prob, active, robust, n_iters):
        lm_lambda = torch.full((), 1e-4, dtype=f32, device=dev)
        for _ in range(n_iters):
            cost = TB._psum(robust_cost(TB._chi2(cam, prob), active,
                                        robust), group)
            R_n, t_n, X_n = lm_step(cam, prob, active, robust, lm_lambda,
                                    cg_iters, group, n_boundary, plans)
            cand = prob._replace(R=R_n, t=t_n, X=X_n)
            cost_n = TB._psum(robust_cost(TB._chi2(cam, cand), active,
                                          robust), group)
            improved = cost_n < cost
            prob = prob._replace(R=TB._select(improved, cand.R, prob.R),
                                 t=TB._select(improved, cand.t, prob.t),
                                 X=TB._select(improved, cand.X, prob.X))
            # lambda floor 1e-6: the damping bounds the motion along
            # near-null gauge directions in the CG solve
            lm_lambda = torch.clamp(torch.where(improved, lm_lambda * 0.5,
                                                lm_lambda * 4.0), 1e-6, 1e4)
        return prob

    anchor_state = TB._gauge_entry(prob)
    for phase, n in enumerate(phase_iters):
        robust = phase == 0
        prob = lm_loop(prob, active, robust, n)
        chi2 = TB._chi2(cam, prob)
        # outlier cut + FOV cheirality (behind-camera points)
        Xc = TB.mat3_apply(prob.R[prob.obs_cam], prob.X[prob.obs_pt]) \
            + prob.t[prob.obs_cam]
        d = torch.linalg.norm(Xc, dim=-1)
        in_fov = Xc[..., 2] / torch.clamp(d, min=1e-12) > cam.cos_fov_th
        active = active & (chi2 <= chi2_cut) & in_fov
    prob = TB._gauge_retract(prob, anchor_state)
    return prob, active


def optimize_essential_graph(
        s: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
        vert_valid: torch.Tensor, vert_fixed: torch.Tensor,
        edge_i: torch.Tensor, edge_j: torch.Tensor,
        meas_s: torch.Tensor, meas_R: torch.Tensor, meas_t: torch.Tensor,
        edge_valid: torch.Tensor,
        n_iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The essential graph's Gauss-Newton loop. Returns the optimized
    (s, R, t)."""
    M = s.shape[0]
    dev, f32 = s.device, s.dtype
    E = edge_i.shape[0]
    w = edge_valid.to(f32)
    free = vert_valid & ~vert_fixed
    free7 = free[:, None].expand(M, 7).reshape(-1)
    keep = free7[:, None] & free7[None, :]
    diag = torch.diag(torch.where(free7, 1e-6, 1.0).to(f32))
    x0 = torch.zeros(E, 14, dtype=f32, device=dev)
    # the blocks' keys in the order of the JAX package's four scatters
    h_plan = TSG.SegmentPlan(torch.cat([edge_i * M + edge_i,
                                        edge_j * M + edge_j,
                                        edge_i * M + edge_j,
                                        edge_j * M + edge_i]), M * M)
    b_plan = TSG.SegmentPlan(torch.cat([edge_i, edge_j]), M)
    for _ in range(n_iters):
        s_i, R_i, t_i = s[edge_i], R[edge_i], t[edge_i]
        s_j, R_j, t_j = s[edge_j], R[edge_j], t[edge_j]

        def f(xi2):
            return TP._edge_residual(xi2[:, :7], xi2[:, 7:], s_i, R_i, t_i,
                                     s_j, R_j, t_j, meas_s, meas_R, meas_t)

        e0 = f(x0)                                        # (E,7)
        J = TP.jacobian_fwd(f, 14, x0).permute(1, 2, 0)   # (E,7,14)
        Ji, Jj = J[..., :7], J[..., 7:]
        JiT = Ji.transpose(1, 2) * w[:, None, None]
        JjT = Jj.transpose(1, 2) * w[:, None, None]
        # dense (M, M, 7, 7) normal matrix by segment sum, then (7M, 7M)
        H = TSG.segment_sum(h_plan, torch.cat(
            [JiT @ Ji, JjT @ Jj, JiT @ Jj, JjT @ Ji])).view(M, M, 7, 7)
        b = TSG.segment_sum(b_plan, torch.cat(
            [-(JiT @ e0[..., None])[..., 0],
             -(JjT @ e0[..., None])[..., 0]]))
        Hd = H.permute(0, 2, 1, 3).reshape(M * 7, M * 7)
        Hd = torch.where(keep, Hd, torch.zeros_like(Hd)) + diag
        bd = torch.where(free7, b.reshape(-1), torch.zeros_like(free7,
                                                                dtype=f32))
        dx = torch.linalg.solve_ex(Hd, bd[:, None])[0].reshape(M, 7)
        dx = torch.where(free[:, None], dx, torch.zeros_like(dx))
        ds, dR, dt = TG.sim3_exp(dx)
        s, R, t = TG.sim3_compose(ds, dR, dt, s, R, t)
    return s, R, t
