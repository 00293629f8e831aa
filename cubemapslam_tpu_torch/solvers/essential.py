"""Ray-based two-view initialization: batched 8-point essential RANSAC.

Counterpart of ``cubemapslam_tpu/solvers/essential.py:33-206``: the
essential matrix on bearing rays, scored by a symmetric angular-epipolar
chi-square with per-keypoint anisotropic sigma, decomposed into 4 (R,t)
hypotheses and disambiguated by triangulation cheirality, reprojection and
parallax. The JAX ``vmap``s over hypotheses are batch dimensions here; the
4 hypotheses keep the JAX order (R1, R2, R1, R2) / (t, t, -t, -t) and
``argmax`` takes the first maximum.

No SVD: where the JAX package takes three (``essential.py:42, :44, :100``),
the port solves symmetric eigenproblems with ``solvers.sym_eig.sym_eig``,
one launch of the hand-written Jacobi kernel each on the card, which reads
nothing back (``torch.linalg.svd`` waited for the card twice a call), so
that a CUDA graph holds the whole attempt (``runtime/fused_init.py``):

* ``compute_e21``: the null vector of each 8x9 system A is the eigenvector
  of the smallest eigenvalue of the 9x9 normal matrix AᵀA, formed in
  float64 from the float32 rays (each product exact; in float32 the normal
  matrix squares A's condition number into float32's precision and the
  null vector is lost); the rank-2 projection is ``E - (E v3) v3ᵀ`` with v3
  the eigenvector of the smallest eigenvalue of EᵀE: U diag(s1, s2, 0) Vᵀ
  without U.
* ``decompose_e``: V from EᵀE, largest first; ``u_i = E v_i / s_i`` (s_i =
  |E v_i|) for i = 1, 2, ``u3 = u1 x u2``, ``v3 = v1 x v2``. ``R = U W Vᵀ``
  does not change under a rotation of (v1, v2) inside a repeated singular
  value, so an essential matrix's equal pair needs no special case.

The normal and Gram matrices are sums of elementwise products (no matrix
product library call, exactly symmetric). The RANSAC's uniform scores are
drawn by the caller (``sampling.draw_scores``), so a graph holds no
generator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.solvers.sampling import select_minimal_sets
from cubemapslam_tpu_torch.solvers.sym_eig import sym_eig
from cubemapslam_tpu_torch.solvers.triangulate import (triangulate_pairs,
                                                       triangulate_rays)

CHI2_TH = 3.841
SCORE_TH = 5.991
PARALLAX_COS_TH = 0.99998


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without reading it to the host."""
    return x.index_select(0, i.reshape(1))[0]


def _det3(R: torch.Tensor) -> torch.Tensor:
    """Determinant of (...,3,3) by cofactors (``linalg.det`` factorizes)."""
    return (R[..., 0, 0] * (R[..., 1, 1] * R[..., 2, 2]
                            - R[..., 1, 2] * R[..., 2, 1])
            - R[..., 0, 1] * (R[..., 1, 0] * R[..., 2, 2]
                              - R[..., 1, 2] * R[..., 2, 0])
            + R[..., 0, 2] * (R[..., 1, 0] * R[..., 2, 1]
                              - R[..., 1, 1] * R[..., 2, 0]))


def _gram(A: torch.Tensor) -> torch.Tensor:
    """AᵀA of (..., r, c) as a sum over the rows of elementwise products:
    (..., c, c), exactly symmetric, in A's dtype."""
    return (A[..., :, :, None] * A[..., :, None, :]).sum(dim=-3)


def _apply(E: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """E v of (..., 3, 3) and (..., 3), elementwise."""
    return (E * v[..., None, :]).sum(dim=-1)


def normal_matrix(rays1: torch.Tensor, rays2: torch.Tensor) -> torch.Tensor:
    """The 8-point systems' normal matrices AᵀA, (B,9,9) float64: A's rows
    are kron(ray2, ray1) of the (B,8,3) rays, widened to float64 first, so
    each entry of A is the exact product."""
    x1 = rays1.to(torch.float64)[..., None, :]       # (B,8,1,3)
    x2 = rays2.to(torch.float64)[..., :, None]       # (B,8,3,1)
    return _gram((x2 * x1).reshape(*rays1.shape[:-2], 8, 9))


def compute_e21(rays1: torch.Tensor, rays2: torch.Tensor) -> torch.Tensor:
    """8-point essential on rays, batched over hypothesis sets.

    rays1/rays2: (B,8,3). Returns (B,3,3): the null vector of each system
    (the eigenvector of the smallest eigenvalue of its float64 normal
    matrix), projected to rank 2 as E - (E v3) v3ᵀ, v3 the eigenvector of
    the smallest eigenvalue of EᵀE. Constraint: ray2ᵀ E21 ray1 = 0."""
    e = sym_eig(normal_matrix(rays1, rays2))[1][..., :, 0]
    E = e.reshape(*rays1.shape[:-2], 3, 3)
    v3 = sym_eig(_gram(E))[1][..., :, 0]
    return E - _apply(E, v3)[..., :, None] * v3[..., None, :]


def check_essential(cam: CubemapCamera, E21: torch.Tensor,
                    rays1: torch.Tensor, rays2: torch.Tensor,
                    uv1: torch.Tensor, uv2: torch.Tensor,
                    valid: torch.Tensor, sigma: float = 1.0):
    """Symmetric angular epipolar score of each hypothesis.

    E21: (B,3,3); rays/uv: (N,...). Returns (inliers (B,N) bool, score
    (B,))."""
    n2 = rays1 @ E21.transpose(-1, -2)         # (B,N,3): E21 ray1
    num2 = (n2 * rays2).sum(dim=-1)
    d2 = (n2 * n2).sum(dim=-1)
    sq1 = num2 * num2 / torch.clamp(d2, min=1e-20)
    s2 = sigma * C.vector_sigma_along_normal(cam, uv2, n2)
    chi1 = sq1 / torch.clamp(s2 * s2, min=1e-20)

    n1 = rays2 @ E21                           # (B,N,3): E21ᵀ ray2
    num1 = (n1 * rays1).sum(dim=-1)
    d1 = (n1 * n1).sum(dim=-1)
    sq2 = num1 * num1 / torch.clamp(d1, min=1e-20)
    s1 = sigma * C.vector_sigma_along_normal(cam, uv1, n1)
    chi2_ = sq2 / torch.clamp(s1 * s1, min=1e-20)

    zero = torch.zeros_like(chi1)
    inl = (chi1 <= CHI2_TH) & (chi2_ <= CHI2_TH) & valid
    score = (torch.where((chi1 <= CHI2_TH) & valid, SCORE_TH - chi1, zero)
             + torch.where((chi2_ <= CHI2_TH) & valid, SCORE_TH - chi2_,
                           zero))
    return inl, score.sum(dim=-1)


def find_essential(cam: CubemapCamera, scores: torch.Tensor,
                   rays1: torch.Tensor, rays2: torch.Tensor,
                   uv1: torch.Tensor, uv2: torch.Tensor,
                   valid: torch.Tensor, sigma: float = 1.0):
    """RANSAC over all iterations at once, one hypothesis a row of the
    (n_iters, N) uniform ``scores`` (``sampling.draw_scores``). Returns
    (E21 (3,3), inliers (N,), score)."""
    sets = select_minimal_sets(scores, valid, 8)
    E = compute_e21(rays1[sets], rays2[sets])
    inl, score = check_essential(cam, E, rays1, rays2, uv1, uv2, valid,
                                 sigma)
    best = torch.argmax(score)
    return _take(E, best), _take(inl, best), _take(score, best)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x), min=1e-30)


def decompose_e(E: torch.Tensor):
    """E -> (R1, R2, t unit), from E's SVD U diag(s1, s2, 0) Vᵀ written as
    V from EᵀE (largest first), u_i = E v_i / s_i, u3 = u1 x u2 and
    v3 = v1 x v2."""
    V = sym_eig(_gram(E))[1]                           # ascending
    v1, v2 = V[:, 2], V[:, 1]
    u1, u2 = _unit(_apply(E, v1)), _unit(_apply(E, v2))
    u3 = torch.linalg.cross(u1, u2)
    Vt = torch.stack([v1, v2, torch.linalg.cross(v1, v2)])
    t = _unit(u3)
    # U W and U Wᵀ for W = [[0,-1,0],[1,0,0],[0,0,1]]: column moves, which
    # is what the products compute (without a copy of W from the host)
    UW = torch.stack([u2, -u1, u3], dim=1)
    UWt = torch.stack([-u2, u1, u3], dim=1)
    R1 = UW @ Vt
    R1 = torch.where(_det3(R1) < 0, -R1, R1)
    R2 = UWt @ Vt
    R2 = torch.where(_det3(R2) < 0, -R2, R2)
    return R1, R2, t


def check_rt(cam: CubemapCamera, R: torch.Tensor, t: torch.Tensor,
             rays1: torch.Tensor, rays2: torch.Tensor,
             uv1: torch.Tensor, uv2: torch.Tensor,
             inliers: torch.Tensor, th2: float,
             p3d: Optional[torch.Tensor] = None):
    """Triangulate (unless given ``p3d``, the hypothesis' points) and gate
    one (R,t) hypothesis. Returns (n_good, p3d (N,3) in frame 1, good (N,),
    parallax_deg)."""
    if p3d is None:
        p3d = triangulate_rays(rays1, rays2, R, t)
    finite = torch.isfinite(p3d).all(dim=-1)
    O2 = -(R.T @ t)
    d1 = torch.linalg.norm(p3d, dim=-1)
    n2 = p3d - O2
    d2 = torch.linalg.norm(n2, dim=-1)
    cos_par = (p3d * n2).sum(dim=-1) / torch.clamp(d1 * d2, min=1e-12)
    low_par = cos_par >= PARALLAX_COS_TH
    # FOV cheirality in both frames, waived at about zero parallax
    cheir1 = (p3d[:, 2] / torch.clamp(d1, min=1e-12)) > cam.cos_fov_th
    p3d2 = p3d @ R.T + t
    cheir2 = (p3d2[:, 2] / torch.clamp(d2, min=1e-12)) > cam.cos_fov_th
    ok = finite & inliers & (cheir1 | low_par) & (cheir2 | low_par)
    uvp1, f1 = C.ray_to_cubemap(cam, p3d)
    uvp2, f2 = C.ray_to_cubemap(cam, p3d2)
    e1 = ((uvp1 - uv1) ** 2).sum(dim=-1)
    e2 = ((uvp2 - uv2) ** 2).sum(dim=-1)
    ok &= (f1 != C.UNKNOWN_FACE) & (e1 <= th2)
    ok &= (f2 != C.UNKNOWN_FACE) & (e2 <= th2)
    n_good = ok.sum()
    # parallax of the 50th-smallest cos among the good points
    cp = torch.where(ok, cos_par, torch.full_like(cos_par, 2.0))
    cp_sorted = torch.sort(cp)[0]
    idx = torch.clamp(n_good - 1, min=0, max=50)
    parallax = torch.rad2deg(torch.arccos(
        torch.clamp(_take(cp_sorted, idx), -1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, torch.zeros_like(parallax))
    good = ok & (cos_par < PARALLAX_COS_TH)
    return n_good, p3d, good, parallax


class TwoViewResult(NamedTuple):
    success: torch.Tensor    # () bool
    R21: torch.Tensor        # (3,3)
    t21: torch.Tensor        # (3,)
    p3d: torch.Tensor        # (N,3) in frame 1
    good: torch.Tensor       # (N,) triangulated inlier mask
    n_good: torch.Tensor     # () int64
    inliers: torch.Tensor    # (N,) epipolar inliers of the best E


def reconstruct_e(cam: CubemapCamera, E: torch.Tensor,
                  rays1, rays2, uv1, uv2, inliers,
                  sigma2: float = 1.0,
                  min_parallax: float = 1.0,
                  min_triangulated: int = 50,
                  good_ratio: float = 0.9) -> TwoViewResult:
    """Disambiguate the 4 (R,t) hypotheses. ``good_ratio`` of the epipolar
    inliers must survive the cheirality and reprojection gates."""
    R1, R2, t = decompose_e(E)
    th2 = 4.0 * sigma2
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    pts = triangulate_pairs(rays1, rays2, Rs, ts)    # one launch on the card
    outs = [check_rt(cam, Rs[h], ts[h], rays1, rays2, uv1, uv2, inliers,
                     th2, p3d=pts[h]) for h in range(4)]
    n_good = torch.stack([o[0] for o in outs])
    p3d = torch.stack([o[1] for o in outs])
    good = torch.stack([o[2] for o in outs])
    parallax = torch.stack([o[3] for o in outs])
    max_good = n_good.max()
    n_inl = inliers.sum()
    n_min_good = torch.clamp((good_ratio * n_inl).to(torch.int64),
                             min=min_triangulated)
    n_similar = (n_good > 0.7 * max_good).sum()
    best = torch.argmax(n_good)                       # the first maximum
    ok = ((max_good >= n_min_good) & (n_similar == 1)
          & (_take(parallax, best) > min_parallax))
    return TwoViewResult(success=ok, R21=_take(Rs, best),
                         t21=_take(ts, best), p3d=_take(p3d, best),
                         good=_take(good, best) & ok,
                         n_good=_take(n_good, best), inliers=inliers)


def initialize_two_view(cam: CubemapCamera, scores: torch.Tensor,
                        rays1, rays2, uv1, uv2, valid, sigma: float = 1.0,
                        min_parallax: float = 1.0,
                        min_triangulated: int = 50,
                        good_ratio: float = 0.9
                        ) -> Tuple[TwoViewResult, torch.Tensor]:
    """The whole two-view bootstrap on aligned match pairs (fixed length,
    with validity), one RANSAC hypothesis a row of ``scores``. Returns the
    result and the RANSAC's best E21."""
    E, inl, _ = find_essential(cam, scores, rays1, rays2, uv1, uv2, valid,
                               sigma)
    return reconstruct_e(cam, E, rays1, rays2, uv1, uv2, inl,
                         sigma * sigma, min_parallax, min_triangulated,
                         good_ratio), E
