"""Essential-graph Sim3 pose-graph optimization.

Counterpart of ``cubemapslam_tpu/optim/pose_graph.py`` (Optimizer::
OptimizeEssentialGraph): per-keyframe Sim3 vertices S_iw, edges with a
relative measurement S_ji frozen at graph-build time and identity
information, the loop keyframe fixed. Each Gauss-Newton iteration takes the
per-edge residual e = log(S_ji * S_i * S_j^-1) and its 7x14 Jacobian by
forward-mode autodiff through the Sim3 exp and log (``torch.func.jvp`` along
the 14 tangent directions of every edge at once, as ``jax.vmap(jax.jacfwd)``
takes it), sums the blocks into a dense (M, M, 7, 7) normal matrix by one
``segment.segment_sum`` over the (i,i), (j,j), (i,j) and (j,i) block keys (a
plan built once a solve, so the card adds in the same order on every run)
and solves it with ``torch.linalg.solve_ex`` (an LU solve, as
``jnp.linalg.solve``; no host wait).

A masked edge adds exact zeros to the normal matrix, so a caller may pass
only its valid edges (``loop_closing.LoopKernels.propagate_and_pose_graph``
does).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import func

from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch.segment import SegmentPlan, segment_sum


def jacobian_fwd(f, n: int, x0: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of ``f`` at ``x0`` (..., n): one JVP per
    tangent direction, batched by ``torch.func.vmap``, as ``jax.jacfwd``
    takes it. Returns (n, *f(x0).shape). Keep ``x0`` batched: forward-mode
    AD of a 0-d tensor and a Python number rounds its tangent to float64 in
    PyTorch."""
    basis = torch.eye(n, dtype=x0.dtype, device=x0.device)
    basis = basis.reshape((n,) + (1,) * (x0.dim() - 1) + (n,)).expand(
        (n,) + tuple(x0.shape))
    return func.vmap(lambda v: func.jvp(f, (x0,), (v,))[1])(basis)


def _edge_residual(xi_i, xi_j, s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    """e = log( S_ji_meas * (exp(xi_i) S_i) * (exp(xi_j) S_j)^-1 ), batched
    over the leading edge dimension."""
    ds_i, dR_i, dt_i = G.sim3_exp(xi_i)
    ds_j, dR_j, dt_j = G.sim3_exp(xi_j)
    Si = G.sim3_compose(ds_i, dR_i, dt_i, s_i, R_i, t_i)
    Sj = G.sim3_compose(ds_j, dR_j, dt_j, s_j, R_j, t_j)
    Sj_inv = G.sim3_inverse(*Sj)
    err = G.sim3_compose(s_m, R_m, t_m, *G.sim3_compose(*Si, *Sj_inv))
    return G.sim3_log(*err)


def optimize_essential_graph(
        s: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
        vert_valid: torch.Tensor, vert_fixed: torch.Tensor,
        edge_i: torch.Tensor, edge_j: torch.Tensor,
        meas_s: torch.Tensor, meas_R: torch.Tensor, meas_t: torch.Tensor,
        edge_valid: torch.Tensor,
        n_iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimize the Sim3 vertices S_iw (s (M,), R (M,3,3), t (M,3)) over
    relative-Sim3 edges (``pose_graph.py:39-94``): edge e joins vertices
    edge_i[e] and edge_j[e] with the measurement S_ji, so that
    e = log(S_meas * S_i * S_j^-1) vanishes when consistent. Returns the
    optimized (s, R, t); no host read."""
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
    h_plan = SegmentPlan(torch.cat([edge_i * M + edge_i, edge_j * M + edge_j,
                                    edge_i * M + edge_j,
                                    edge_j * M + edge_i]), M * M)
    b_plan = SegmentPlan(torch.cat([edge_i, edge_j]), M)
    for _ in range(n_iters):
        s_i, R_i, t_i = s[edge_i], R[edge_i], t[edge_i]
        s_j, R_j, t_j = s[edge_j], R[edge_j], t[edge_j]

        def f(xi2):
            return _edge_residual(xi2[:, :7], xi2[:, 7:], s_i, R_i, t_i,
                                  s_j, R_j, t_j, meas_s, meas_R, meas_t)

        e0 = f(x0)                                        # (E,7)
        J = jacobian_fwd(f, 14, x0).permute(1, 2, 0)      # (E,7,14)
        Ji, Jj = J[..., :7], J[..., 7:]
        JiT = Ji.transpose(1, 2) * w[:, None, None]
        JjT = Jj.transpose(1, 2) * w[:, None, None]
        # dense (M, M, 7, 7) normal matrix by segment sum, then (7M, 7M)
        H = segment_sum(h_plan, torch.cat([JiT @ Ji, JjT @ Jj, JiT @ Jj,
                                           JjT @ Ji])).view(M, M, 7, 7)
        b = segment_sum(b_plan, torch.cat([-(JiT @ e0[..., None])[..., 0],
                                           -(JjT @ e0[..., None])[..., 0]]))
        Hd = H.permute(0, 2, 1, 3).reshape(M * 7, M * 7)
        Hd = torch.where(keep, Hd, torch.zeros_like(Hd)) + diag
        bd = torch.where(free7, b.reshape(-1), torch.zeros_like(free7,
                                                                dtype=f32))
        dx = torch.linalg.solve_ex(Hd, bd[:, None])[0].reshape(M, 7)
        dx = torch.where(free[:, None], dx, torch.zeros_like(dx))
        ds, dR, dt = G.sim3_exp(dx)
        s, R, t = G.sim3_compose(ds, dR, dt, s, R, t)
    return s, R, t


def remap_points_through_sim3(X: torch.Tensor,
                              s_old: torch.Tensor, R_old: torch.Tensor,
                              t_old: torch.Tensor,
                              s_new: torch.Tensor, R_new: torch.Tensor,
                              t_new: torch.Tensor) -> torch.Tensor:
    """Remap world points owned by a keyframe after its Sim3 changed:
    X' = S_new^-1 (S_old X) (``pose_graph.py:97-106``)."""
    p_cam = G.sim3_apply(s_old, R_old, t_old, X)
    return G.sim3_apply(*G.sim3_inverse(s_new, R_new, t_new), p_cam)
