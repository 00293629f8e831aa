"""Pose-only optimization (motion-only BA), in PyTorch.

Counterpart of ``cubemapslam_tpu/optim/pose_opt.py``: one SE3 pose, unary
multipinhole edges with Huber delta = sqrt(5.991), 4 rounds of 10 LM
iterations, outliers reclassified by chi2 after each round, robust kernel
dropped from round 3.

The JAX version leaves a round's LM loop early once an accepted step is
tiny. Here every round runs a fixed 10 iterations under an ``active`` mask:
once the exit condition fires no state changes, which is exactly
equivalent and needs no host synchronisation per iteration.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.geometry import se3_compose, se3_exp
from cubemapslam_tpu_torch.optim.residuals import (eval_point,
                                                    pose_jac_from_state)

CHI2_TH = 5.991
HUBER_DELTA = float(torch.sqrt(torch.tensor(CHI2_TH, dtype=torch.float32)))


def _huber_weight(chi2: torch.Tensor) -> torch.Tensor:
    """IRLS weight of the Huber kernel on the whitened residual norm."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-20))
    return torch.where(r <= HUBER_DELTA, torch.ones_like(r), HUBER_DELTA / r)


def pose_optimization(cam: CubemapCamera, R0: torch.Tensor, t0: torch.Tensor,
                      Xw: torch.Tensor, face: torch.Tensor,
                      uv_face: torch.Tensor, inv_sigma2: torch.Tensor,
                      valid: torch.Tensor,
                      n_rounds: int = 4, n_iters: int = 10
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Optimize (R0,t0) world->camera against N fixed landmarks.

    Returns (R, t, inliers, n_inliers). Edges with chi2 > 5.991 after a
    round are excluded from the next round and reported as outliers.
    """
    R_face = cam.face_R[face.clamp(0, 4).long()]
    dev, dt_ = R0.device, R0.dtype
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def eval_at(R, t):
        e, Xc, local = eval_point(cam, R, t, Xw, R_face, uv_face)
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
        return e, chi2, Xc, local

    def rho_cost(chi2, robust, inl):
        if robust:
            rho = torch.where(chi2 <= CHI2_TH, chi2,
                              2.0 * HUBER_DELTA * torch.sqrt(
                                  torch.clamp(chi2, min=1e-20)) - CHI2_TH)
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
        lm_lambda = torch.tensor(1e-3, dtype=dt_, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            w = inv_sigma2 * (_huber_weight(chi2) if robust else 1.0)
            w = torch.where(inl & valid, w, torch.zeros_like(w))
            Jp = pose_jac_from_state(cam, Xc, local, R_face)    # (N,2,6)
            JW = Jp * w[:, None, None]
            H = torch.sum(JW[..., :, None] * Jp[..., None, :], dim=(0, 1))
            b = -torch.sum(JW * e[..., None], dim=(0, 1))
            H_d = H + lm_lambda * torch.diag(torch.diag(H)) + 1e-9 * eye6
            # solve_ex: no error check, so no host synchronisation
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
            # converged: the accepted step is tiny
            active = active & ~(improved & (torch.sum(delta * delta)
                                            < 1e-12))
        inl = valid & (chi2 <= CHI2_TH)
    return R, t, inl, inl.sum()

