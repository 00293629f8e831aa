"""Sim3 RANSAC (loop-closure alignment), batched over the hypotheses.

Counterpart of ``cubemapslam_tpu/solvers/sim3.py`` (the reference's
Sim3Solver): Horn's closed-form Sim3 from 3-point minimal sets, inliers by
projecting both point sets through the candidate transform into both
keyframes' cubemaps with chi2 9.21 * sigma2 gates in each direction, then a
refit on the best hypothesis' inliers. bFixScale is False for monocular.

Where the JAX package ``vmap``s over the hypotheses, they are a batch
dimension here. A hypothesis gathers its 3 points before Horn's alignment
(the JAX code weights all N points by 0/1, which adds only zero rows, so
the result is the same up to summation order); the refit uses all N points
weighted by the inlier mask.

Horn's eigen-solves (``jnp.linalg.eigh`` in the JAX package,
``solvers/horn.py:46``) go through ``eigh``, by default
``solvers.sym_eig.sym_eig``: the hypotheses' (n_iters, 4, 4) batch and the
refit's single 4x4. On CUDA tensors each is one launch of the hand-written
batched Jacobi kernel (``csrc/sym_eig.cu``), which reads nothing back, so
``sim3_ransac`` makes the host wait ``EIGH_WAITS`` = 0 times and a CUDA
graph can hold it (``runtime/fused_loop.py``); on CPU tensors they are
``torch.linalg.eigh`` on the host (``eigh_nan``), where nothing waits on a
device. (With ``torch.linalg.eigh`` on the card one call waited 3 times:
the batch once, the refit twice; ``scripts/torch_eigh_waits.py`` reads both
solvers on a card.) The minimal sets are selected from (n_iters, N) uniform
scores (``solvers/sampling.py``), which the caller may draw itself and
hand in, so that the draw stays outside a graph. For 3 points that are not
collinear the top eigenvalue of Horn's matrix is simple, so each
hypothesis is the same rotation in every backend.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.solvers.horn import horn_alignment
from cubemapslam_tpu_torch.solvers.sampling import (draw_scores,
                                                    select_minimal_sets)
from cubemapslam_tpu_torch.solvers.sym_eig import sym_eig

MIN_SET = 3
# host waits of one sim3_ransac on CUDA tensors, in its 2 eigen-solves (the
# sym_eig kernel reads nothing back; torch.linalg.eigh waited 3 times
# there). On CPU tensors the solves run on the host: no device to wait for.
EIGH_WAITS = 0


class Sim3Result(NamedTuple):
    success: torch.Tensor    # () bool
    s12: torch.Tensor        # () scale: p1 = s12 R12 p2 + t12
    R12: torch.Tensor        # (3,3)
    t12: torch.Tensor        # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int64


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without reading it to the host."""
    return x.index_select(0, i.reshape(1))[0]


def _check_inliers(cam: CubemapCamera, s12, R12, t12, p1, p2, uv1, uv2,
                   max_err1, max_err2, valid):
    """Project p2 through T12 against uv1 and p1 through T21 against uv2
    (``sim3.py:33-47``). s12 (...,), R12 (..., 3, 3), t12 (..., 3) may carry
    a batch of hypotheses. Returns (inliers (..., N), count (...,))."""
    p2_in1 = s12[..., None, None] * (p2 @ R12.transpose(-1, -2)) \
        + t12[..., None, :]
    uvp1, f1 = C.ray_to_cubemap(cam, p2_in1)
    e1 = ((uvp1 - uv1) ** 2).sum(dim=-1)
    s21 = 1.0 / s12
    R21 = R12.transpose(-1, -2)
    t21 = -s21[..., None] * (R21 @ t12[..., None])[..., 0]
    p1_in2 = s21[..., None, None] * (p1 @ R21.transpose(-1, -2)) \
        + t21[..., None, :]
    uvp2, f2 = C.ray_to_cubemap(cam, p1_in2)
    e2 = ((uvp2 - uv2) ** 2).sum(dim=-1)
    inl = (valid & (f1 != C.UNKNOWN_FACE) & (f2 != C.UNKNOWN_FACE)
           & (e1 < max_err1) & (e2 < max_err2))
    return inl, inl.sum(dim=-1)


def sim3_hypotheses(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                    sets: torch.Tensor, fix_scale: bool = False,
                    eigh: Callable = sym_eig):
    """Horn's Sim3 of each minimal set (n_iters, 3): (s, R, t) batched, the
    scale floored at 1e-6 (``sim3.py:64-67``)."""
    s, R, t = horn_alignment(p1[sets], p2[sets],
                             weights=valid[sets].to(p1.dtype),
                             fix_scale=fix_scale, eigh=eigh)
    return torch.clamp(s, min=1e-6), R, t


def sim3_ransac(cam: CubemapCamera, generator: Optional[torch.Generator],
                p1: torch.Tensor, p2: torch.Tensor,
                uv1: torch.Tensor, uv2: torch.Tensor,
                level_sigma2_1: torch.Tensor, level_sigma2_2: torch.Tensor,
                valid: torch.Tensor, n_iters: int = 300,
                fix_scale: bool = False, chi2_th: float = 9.21,
                min_inliers: int = 20,
                sets: Optional[torch.Tensor] = None,
                scores: Optional[torch.Tensor] = None,
                eigh: Callable = sym_eig) -> Sim3Result:
    """p1/p2: (N, 3) matched map points in the KF1/KF2 camera frames; uv1/uv2
    their observed cubemap pixels; the per-point chi2 gates scale with the
    keypoint level sigma (``sim3.py:50-88``). The minimal sets are ``sets``
    (n_iters, 3) if given, else selected from ``scores`` (n_iters, N)
    uniform draws if given, else from scores drawn from ``generator``
    (``solvers/sampling.py``). ``eigh`` solves Horn's 4x4 matrices
    (``sym_eig``; the tests pass ``sym_eig_ordered``). On CUDA tensors the
    call reads nothing back to the host."""
    max_err1 = chi2_th * level_sigma2_1
    max_err2 = chi2_th * level_sigma2_2
    if sets is None:
        if scores is None:
            scores = draw_scores(generator, n_iters, valid.shape[0],
                                 valid.device)
        sets = select_minimal_sets(scores, valid, MIN_SET)
    sets = sets.to(p1.device, torch.int64)
    ss, Rs, ts = sim3_hypotheses(p1, p2, valid, sets, fix_scale, eigh)
    inls, ns = _check_inliers(cam, ss, Rs, ts, p1, p2, uv1, uv2,
                              max_err1, max_err2, valid)
    best = torch.argmax(ns)                            # the first maximum
    s_b, R_b, t_b, inl_b, n_b = (_take(x, best)
                                 for x in (ss, Rs, ts, inls, ns))
    # polish with all inliers of the best hypothesis
    s_r, R_r, t_r = horn_alignment(p1, p2, weights=inl_b.to(p1.dtype),
                                   fix_scale=fix_scale, eigh=eigh)
    s_r = torch.clamp(s_r, min=1e-6)
    inl_r, n_r = _check_inliers(cam, s_r, R_r, t_r, p1, p2, uv1, uv2,
                                max_err1, max_err2, valid)
    use_r = n_r >= n_b
    n = torch.where(use_r, n_r, n_b)
    return Sim3Result(success=n >= min_inliers,
                      s12=torch.where(use_r, s_r, s_b),
                      R12=torch.where(use_r, R_r, R_b),
                      t12=torch.where(use_r, t_r, t_b),
                      inliers=torch.where(use_r, inl_r, inl_b),
                      n_inliers=n)
