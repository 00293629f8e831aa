"""Single-vertex Sim3 refinement over matched point pairs.

Counterpart of ``cubemapslam_tpu/optim/sim3_opt.py`` (Optimizer::
OptimizeSim3): one Sim3 vertex S12, fixed 3D point pairs in each keyframe's
camera frame, a forward edge projecting S12 p2 onto KF1's face of the
matched keypoint and an inverse edge projecting S12^-1 p1 onto KF2's, both
with Huber sqrt(th2); Gauss-Newton, the inliers cut at chi2 > th2 after the
first phase, then more iterations without the kernel.

The JAX code takes the Jacobian by ``jax.jacfwd`` through the Sim3
exponential at the zero tangent xi = [rho, phi, sigma]. Its value there is
closed-form, and this module computes it so: exp(xi) moves a point q by
rho + phi x q + sigma q, so the forward edge's point S12 p2 = q has
d/dxi = [I | -hat(q) | q], and the inverse edge's S12^-1 exp(-xi) p1 has
d/dxi = -(1/s) Rᵀ [I | -hat(p1) | p1]; each is chained with the pinhole
Jacobian of its face. On the card that is a few dozen launches a step,
where forward-mode autodiff (``torch.func``) took about a thousand.

The scale columns are written in their exact form. A pinhole is blind
to a scaling of the point, J_proj(q) q = 0, so the forward edge's column
is 0; and as (1/s) Rᵀ p1 = q2 + (1/s) Rᵀ t, the inverse edge's is
J_proj(q2) (1/s) Rᵀ t: the scale is seen only through the translation.
Taken as the products above (as ``jax.jacfwd`` takes them), each column
is the float32 rounding of a cancellation. Where the two keyframes share
a viewpoint (t ~ 0) that rounding outweighs the true column, and the
absolute 1e-6 damping lets it steer the scale: on ``chip_smoke.py``'s
constructed-drift closure (650-px faces, an exact revisit) the products
walked the RANSAC's s = 1.06 to 0.34 on the card, and JAX's float32 code
replayed on the same inputs walks it to 0.80
(``scripts/sim3_refine_witness.py``). The exact columns leave the drift
that the float32 inputs themselves cause (1.29-1.36 on the card; JAX's
code in float64: 1.13). Where t is not small, the exact columns and the
products agree to rounding.

``torch.linalg.solve_ex`` solves the 7x7 system on cuSOLVER
(``_build.cusolver``), which checks no error flag, so the 15 steps make no
host wait and read no Python value of a device tensor (the Huber width is a
float32 square root taken on the host): a CUDA graph holds them unrolled
(graph S of ``runtime/fused_loop.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cubemapslam_tpu_torch import geometry as G
from cubemapslam_tpu_torch._build import cusolver
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.optim.residuals import (_face_R, _jproj_rface,
                                                   project_to_face)


def _point_tangent(q: torch.Tensor) -> torch.Tensor:
    """(n, 3, 6) derivative of exp(xi) q at xi = 0 in the translation and
    rotation coordinates: [I | -hat(q)] (the scale's column, q, is taken
    apart: see the module docstring)."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(
        q.shape[0], 3, 3)
    return torch.cat([eye, -G.hat(q)], dim=2)


def _proj_jac(cam: CubemapCamera, X: torch.Tensor,
              face: torch.Tensor) -> torch.Tensor:
    """(n, 2, 3) derivative of the in-face projection of camera points X
    on the given faces."""
    Rf = _face_R(cam, face)
    local = G.mat3_apply(Rf, X)
    rows = _jproj_rface(cam, local, Rf)
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def edge_jacobians(cam: CubemapCamera, s: torch.Tensor, R: torch.Tensor,
                   t: torch.Tensor, T1: torch.Tensor, q1: torch.Tensor,
                   face1: torch.Tensor, q2: torch.Tensor, face2: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J1, J2), each (n, 2, 7): the derivatives at xi = 0 of the forward
    edge's residual (camera-1 points ``q1`` = S12 p2 on ``face1``) and of
    the inverse edge's (camera-2 points ``q2`` = S12^-1 p1 on ``face2``),
    with ``T1`` = ``_point_tangent(p1)``; the scale columns in their exact
    form (module docstring)."""
    P1 = _proj_jac(cam, q1, face1)
    A2 = _proj_jac(cam, q2, face2) @ (R.transpose(-1, -2) / s)
    J1 = torch.cat([-P1 @ _point_tangent(q1), torch.zeros_like(P1[..., :1])],
                   dim=2)
    J2 = torch.cat([A2 @ T1, A2 @ t[:, None]], dim=2)
    return J1, J2


def optimize_sim3(cam: CubemapCamera,
                  s12: torch.Tensor, R12: torch.Tensor, t12: torch.Tensor,
                  p1: torch.Tensor, p2: torch.Tensor,
                  uv1: torch.Tensor, face1: torch.Tensor,
                  uv2: torch.Tensor, face2: torch.Tensor,
                  inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
                  valid: torch.Tensor,
                  th2: float = 10.0, fix_scale: bool = False,
                  n_iters_a: int = 5, n_iters_b: int = 10
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """Refine S12 (p1 ~= S12 p2), ``sim3_opt.py:25-101``. Returns (s, R, t,
    inliers, n_inliers); no host read."""
    dev, f32 = p1.device, p1.dtype
    # the float32 square root, as JAX rounds it, of a host number
    delta = torch.sqrt(torch.tensor(th2, dtype=torch.float32)).item()
    T1 = _point_tangent(p1)                                # (n,3,6)

    def residuals(s, R, t):
        """(e1, e2, the camera-1 point of p2, the camera-2 point of p1)."""
        p2_in1 = G.sim3_apply(s, R, t, p2)
        e1 = uv1 - project_to_face(cam, p2_in1, face1)
        si, Ri, ti = G.sim3_inverse(s, R, t)
        p1_in2 = G.sim3_apply(si, Ri, ti, p1)
        e2 = uv2 - project_to_face(cam, p1_in2, face2)
        return e1, e2, p2_in1, p1_in2

    def chi2_of(s, R, t):
        e1, e2, _, _ = residuals(s, R, t)
        return ((e1 * e1).sum(dim=-1) * inv_sigma2_1,
                (e2 * e2).sum(dim=-1) * inv_sigma2_2)

    def hw(c, robust):
        if not robust:
            return torch.ones_like(c)
        r = torch.sqrt(torch.clamp(c, min=1e-20))
        return torch.where(r > delta, delta / r, torch.ones_like(r))

    eye7 = torch.eye(7, dtype=f32, device=dev)

    def gn_phase(state, active, n_iters, robust):
        for _ in range(n_iters):
            s, R, t = state
            e1, e2, q1, q2 = residuals(s, R, t)
            J1, J2 = edge_jacobians(cam, s, R, t, T1, q1, face1, q2, face2)
            c1 = (e1 * e1).sum(dim=-1) * inv_sigma2_1
            c2 = (e2 * e2).sum(dim=-1) * inv_sigma2_2
            w1 = inv_sigma2_1 * hw(c1, robust) * active
            w2 = inv_sigma2_2 * hw(c2, robust) * active
            H = (torch.einsum("nik,n,nil->kl", J1, w1, J1)
                 + torch.einsum("nik,n,nil->kl", J2, w2, J2))
            b = -(torch.einsum("nik,n,ni->k", J1, w1, e1)
                  + torch.einsum("nik,n,ni->k", J2, w2, e2))
            if fix_scale:
                # freeze the scale coordinate of the tangent
                keep = torch.arange(7, device=dev) < 6
                H = torch.where(keep[:, None] & keep[None, :], H,
                                torch.zeros_like(H)) + torch.diag(
                    (~keep).to(f32))
                b = torch.where(keep, b, torch.zeros_like(b))
            H = H + 1e-6 * eye7
            dx = torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
            ds, dR, dt = G.sim3_exp(dx)
            state = G.sim3_compose(ds, dR, dt, s, R, t)
        return state

    state = (s12, R12, t12)
    with cusolver(dev):
        state = gn_phase(state, valid.to(f32), n_iters_a, True)
        c1, c2 = chi2_of(*state)
        inl = valid & (c1 <= th2) & (c2 <= th2)
        state = gn_phase(state, inl.to(f32), n_iters_b, False)
    c1, c2 = chi2_of(*state)
    inl = valid & (c1 <= th2) & (c2 <= th2)
    s, R, t = state
    return s, R, t, inl, inl.sum()
