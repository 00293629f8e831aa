"""Bearing EPnP + RANSAC, batched over the hypotheses.

Counterpart of ``cubemapslam_tpu/solvers/pnp.py`` (the reference's
PnPsolver): Lepetit EPnP on bearing rays, whose M-matrix rows are cross
products of the bearing with the barycentric combination of the control
points; 4 control points by PCA; camera-frame control points from the
4-dimensional null space of MᵀM, with the three beta approximations each
refined by 5 Gauss-Newton iterations; R, t by Horn's alignment per
candidate, the best of the three by inlier count. Inliers are cubemap
reprojections within chi2 * sigma2, and the best hypothesis is refit on its
inlier set.

Where the JAX package ``vmap``s over the hypotheses, they are a batch
dimension here. A hypothesis gathers its 4 points before M is built (the
JAX code weights all N rows by 0/1, which adds only zero rows); the refit
uses all N points.

The six eigen-solves of a call go through ``solvers.sym_eig.sym_eig``
(``_eigh``): the hypotheses' PCA (n_iters, 3, 3), the null space of their
MᵀM (n_iters, 12, 12) and Horn's 4x4 (n_iters, 3, 4, 4), then the refit's
(3, 3), (12, 12) and (3, 4, 4). On CUDA tensors each is one launch of the
hand-written batched Jacobi kernel (``csrc/sym_eig.cu``), which reads
nothing back, and the LU solves run on cuSOLVER / cuBLAS's batched LU
(``_build.cusolver``), which check no error flag: ``pnp_ransac`` makes the
host wait ``EIGH_WAITS`` = 0 times, whatever the number of points or
hypotheses, and a CUDA graph can hold it (``runtime/fused_reloc.py``). On
CPU tensors they are ``torch.linalg.eigh`` on the host (``eigh_nan``),
where nothing waits on a device. (With ``torch.linalg.eigh`` on the card
one call waited 8 times: the four batched solves once each, the refit's
single 3x3 and 12x12 twice each; ``scripts/torch_eigh_waits.py`` reads
both solvers per call site on a card.) The null space of a minimal
set is exactly 4-dimensional, so its basis (and with it each hypothesis)
differs between LAPACK, the kernel and JAX; ``pnp_ransac`` is held to its
outcome.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch._build import cusolver
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.geometry import hat
from cubemapslam_tpu_torch.solvers.horn import horn_alignment
from cubemapslam_tpu_torch.solvers.sampling import (draw_scores,
                                                    select_minimal_sets)
from cubemapslam_tpu_torch.solvers.sym_eig import sym_eig

MIN_SET = 4
# host waits of one pnp_ransac call on CUDA tensors, in its 6 eigen-solves
# (the sym_eig kernel reads nothing back; torch.linalg.eigh waited 8 times
# there). On CPU tensors the solves run on the host: no device to wait for.
EIGH_WAITS = 0

# symmetric products beta_a*beta_b in the order of the reference's L_6x10
# columns: [b11 b12 b22 b13 b23 b33 b14 b24 b34 b44]
_SYM_PAIRS = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
              (0, 3), (1, 3), (2, 3), (3, 3))
# the 6 control-point pairs, in the order of jnp.triu_indices(4, 1)
_CP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without reading it to the host."""
    return x.index_select(0, i.reshape(1))[0]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _eigh(A: torch.Tensor):
    """The symmetric eigen-solve of every call site: ``sym_eig`` (NaN for a
    non-finite matrix, raising nothing, as JAX's does)."""
    return sym_eig(A)


def _control_points(pw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """4 control points: the weighted centroid and the PCA axes scaled by
    sqrt(eigenvalue), largest first (``pnp.py:44-54``). pw (..., n, 3), w
    (..., n) -> (..., 4, 3)."""
    wn = torch.clamp(w.sum(dim=-1), min=1e-12)[..., None]
    c0 = (pw * w[..., None]).sum(dim=-2) / wn
    q = (pw - c0[..., None, :]) * w[..., None]
    cov = q.transpose(-1, -2) @ q / wn[..., None]
    evals, evecs = _eigh(cov)                              # ascending
    axes = evecs.transpose(-1, -2) \
        * torch.sqrt(torch.clamp(evals, min=1e-12))[..., :, None]
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes.flip(-2)],
                     dim=-2)


def _barycentric(pw: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """alphas with p = sum_j alpha_j c_j (``pnp.py:57-64``). pw (..., n, 3),
    cw (..., 4, 3) -> (..., n, 4)."""
    B = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)
    # inv_ex: no error check, so no host synchronisation on the card
    Binv = torch.linalg.inv_ex(B + 1e-12 * _eye(3, B))[0]
    a123 = (pw - cw[..., :1, :]) @ Binv.transpose(-1, -2)
    return torch.cat([1.0 - a123.sum(dim=-1, keepdim=True), a123], dim=-1)


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Damped least squares by the normal equations, batched."""
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-9 * _eye(A.shape[-1], A)
    return torch.linalg.solve_ex(AtA, (At @ b[..., None]))[0][..., 0]


def _betas_candidates(L: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """The three EPnP beta initializations from the (..., 6, 10) product
    matrix (``pnp.py:73-99``). Returns (..., 3, 4)."""
    zero = torch.zeros_like(rho[..., 0])
    one = torch.ones_like(zero)
    # approx 1: unknowns [b11 b12 b13 b14]
    x = _lstsq(torch.stack([L[..., 0], L[..., 1], L[..., 3], L[..., 6]],
                           dim=-1), rho)
    b0 = torch.sqrt(x[..., 0].abs())
    sgn = torch.where(x[..., 0] < 0, -one, one)
    safe = torch.where(b0 > 0, b0, one)
    beta1 = torch.stack([b0, sgn * x[..., 1] / safe, sgn * x[..., 2] / safe,
                         sgn * x[..., 3] / safe], dim=-1)
    # approx 2: unknowns [b11 b12 b22]
    y = _lstsq(L[..., :3], rho)
    b0 = torch.sqrt(y[..., 0].abs())
    b1 = torch.where(y[..., 0] * y[..., 2] > 0, torch.sqrt(y[..., 2].abs()),
                     zero)
    b0 = torch.where(y[..., 1] < 0, -b0, b0)
    beta2 = torch.stack([b0, b1, zero, zero], dim=-1)
    # approx 3: unknowns [b11 b12 b22 b13 b23]
    z = _lstsq(L[..., :5], rho)
    b0 = torch.sqrt(z[..., 0].abs())
    b1 = torch.where(z[..., 0] * z[..., 2] > 0, torch.sqrt(z[..., 2].abs()),
                     zero)
    b0s = torch.where(z[..., 1] < 0, -b0, b0)
    b2 = z[..., 3] / torch.where(b0s != 0, b0s, one)
    beta3 = torch.stack([b0s, b1, b2, zero], dim=-1)
    return torch.stack([beta1, beta2, beta3], dim=-2)


def _gauss_newton(dv: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                  n_iters: int = 5) -> torch.Tensor:
    """Refine betas on the distance residuals r_p = |sum_a beta_a dv[a,p]|^2
    - rho_p (``pnp.py:102-114``). dv (..., 4, 6, 3), rho (..., 6), beta
    (..., 4), broadcast together."""
    eye4 = _eye(4, beta)
    for _ in range(n_iters):
        q = (beta[..., :, None, None] * dv).sum(dim=-3)          # (..., 6, 3)
        r = (q * q).sum(dim=-1) - rho                              # (..., 6)
        J = 2.0 * (q[..., None, :, :] * dv).sum(dim=-1)            # (..., 4, 6)
        JtJ = J @ J.transpose(-1, -2) + 1e-9 * eye4
        db = torch.linalg.solve_ex(JtJ, -(J @ r[..., None]))[0][..., 0]
        beta = beta + db
    return beta


def _solve_epnp_candidates(pw: torch.Tensor, bearings: torch.Tensor,
                           w: torch.Tensor):
    """EPnP over weighted correspondences, one pose per refined beta
    candidate (``pnp.py:117-159``). pw (..., n, 3) world points, bearings
    (..., n, 3) unit rays in the camera frame, w (..., n) {0,1} weights.
    Returns world->camera (R (..., 3, 3, 3), t (..., 3, 3))."""
    batch = pw.shape[:-2]
    n = pw.shape[-2]
    cw = _control_points(pw, w)
    alphas = _barycentric(pw, cw)                          # (..., n, 4)
    # M rows: [b]x sum_j alpha_j cc_j = 0 -> (..., 3n, 12)
    M = alphas[..., :, None, :, None] * hat(bearings)[..., :, :, None, :]
    M = M.reshape(*batch, 3 * n, 12) \
        * w.repeat_interleave(3, dim=-1)[..., None]
    _, evecs = _eigh(M.transpose(-1, -2) @ M)
    V = evecs[..., :4]                                     # (..., 12, 4)
    v = V.transpose(-1, -2).reshape(*batch, 4, 4, 3)   # basis a: 4 points
    dv = torch.stack([v[..., :, i, :] - v[..., :, j, :]
                      for i, j in _CP_PAIRS], dim=-2)      # (..., 4, 6, 3)
    rho = torch.stack([((cw[..., i, :] - cw[..., j, :]) ** 2).sum(dim=-1)
                       for i, j in _CP_PAIRS], dim=-1)     # (..., 6)
    L = torch.stack([(1.0 if a == b else 2.0)
                     * (dv[..., a, :, :] * dv[..., b, :, :]).sum(dim=-1)
                     for a, b in _SYM_PAIRS], dim=-1)      # (..., 6, 10)
    betas = _gauss_newton(dv[..., None, :, :, :], rho[..., None, :],
                          _betas_candidates(L, rho))       # (..., 3, 4)
    cc = (V[..., None, :, :] @ betas[..., :, :, None]).reshape(
        *batch, 3, 4, 3)
    pc = alphas[..., None, :, :] @ cc                      # (..., 3, n, 3)
    # sign: the bearings point toward the points (weighted majority)
    sgn = torch.sign(((pc * bearings[..., None, :, :]).sum(dim=-1)
                      * w[..., None, :]).sum(dim=-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    pc = pc * sgn[..., None, None]
    # a NaN hypothesis gets a NaN pose (its eigen-solve gives NaN), which
    # counts no inlier, as JAX's NaN does
    _, R, t = horn_alignment(pc, pw[..., None, :, :].expand_as(pc),
                             weights=w[..., None, :].expand(pc.shape[:-1]),
                             fix_scale=True, eigh=_eigh)
    return R, t


class PnPResult(NamedTuple):
    success: torch.Tensor    # () bool
    R: torch.Tensor          # (3,3) world->camera
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int64


def _count_inliers(cam: CubemapCamera, R, t, pw, uv, max_err2, valid):
    """Inliers of pose(s) R (..., 3, 3), t (..., 3) over the N points:
    cubemap reprojections within ``max_err2`` (``pnp.py:170-175``).
    Returns (inliers (..., N), count (...,))."""
    pc = pw @ R.transpose(-1, -2) + t[..., None, :]
    uvp, face = C.ray_to_cubemap(cam, pc)
    err2 = ((uvp - uv) ** 2).sum(dim=-1)
    inl = valid & (face != C.UNKNOWN_FACE) & (err2 < max_err2)
    return inl, inl.sum(dim=-1)


def _best_candidate(cam, Rs, ts, pw, uv, max_err2, valid):
    """The candidate pose with the most inliers, the first among equals
    (``pnp.py:178-185``). Rs (..., 3, 3, 3), ts (..., 3, 3). Returns (R, t,
    inliers, count) of the batch."""
    inls, ns = _count_inliers(cam, Rs, ts, pw, uv, max_err2, valid)
    b = torch.argmax(ns, dim=-1)[..., None]
    return (torch.take_along_dim(Rs, b[..., None, None], dim=-3)[..., 0, :, :],
            torch.take_along_dim(ts, b[..., None], dim=-2)[..., 0, :],
            torch.take_along_dim(inls, b[..., None], dim=-2)[..., 0, :],
            torch.take_along_dim(ns, b, dim=-1)[..., 0])


def pnp_ransac(cam: CubemapCamera, generator: torch.Generator,
               pw: torch.Tensor, bearings: torch.Tensor, uv: torch.Tensor,
               level_sigma2: torch.Tensor, valid: torch.Tensor,
               n_iters: int = 300, chi2_th: float = 5.991,
               min_inliers: int = 10,
               sets: Optional[torch.Tensor] = None,
               scores: Optional[torch.Tensor] = None) -> PnPResult:
    """RANSAC bearing EPnP over all hypotheses at once (``pnp.py:188-219``,
    with the parameters Tracking.cpp:1035 passes). pw (N, 3) world points;
    bearings (N, 3) the matched keypoints' unit rays, uv their cross
    pixels, level_sigma2 their scale variance; valid (N,). The minimal sets
    are ``sets`` (n_iters, 4) if given, else selected from ``scores``
    (n_iters, N) uniform draws if given, else from scores drawn from
    ``generator`` (``solvers/sampling.py``). On CUDA tensors the call reads
    nothing back to the host."""
    with cusolver(pw.device):
        return _pnp_ransac(cam, generator, pw, bearings, uv, level_sigma2,
                           valid, n_iters, chi2_th, min_inliers, sets,
                           scores)


def _pnp_ransac(cam, generator, pw, bearings, uv, level_sigma2, valid,
                n_iters, chi2_th, min_inliers, sets, scores) -> PnPResult:
    max_err2 = chi2_th * level_sigma2
    if sets is None:
        if scores is None:
            scores = draw_scores(generator, n_iters, valid.shape[0],
                                 valid.device)
        sets = select_minimal_sets(scores, valid, MIN_SET)
    sets = sets.to(pw.device, torch.int64)
    Rs, ts = _solve_epnp_candidates(pw[sets], bearings[sets],
                                    valid[sets].to(pw.dtype))
    R_h, t_h, inl_h, n_h = _best_candidate(cam, Rs, ts, pw, uv, max_err2,
                                           valid)
    best = torch.argmax(n_h)                           # the first maximum
    R_b, t_b, inl_b, n_b = (_take(x, best) for x in (R_h, t_h, inl_h, n_h))
    # refit on the best inlier set (Refine, PnPsolver.cpp:263-309)
    Rc, tc = _solve_epnp_candidates(pw, bearings, inl_b.to(pw.dtype))
    R_r, t_r, inl_r, n_r = _best_candidate(cam, Rc, tc, pw, uv, max_err2,
                                           valid)
    use_ref = n_r >= n_b
    n = torch.where(use_ref, n_r, n_b)
    return PnPResult(success=n >= min_inliers,
                     R=torch.where(use_ref, R_r, R_b),
                     t=torch.where(use_ref, t_r, t_b),
                     inliers=torch.where(use_ref, inl_r, inl_b),
                     n_inliers=n)
