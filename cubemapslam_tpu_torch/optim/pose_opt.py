"""Pose-only optimization (motion-only BA), in PyTorch.

Counterpart of ``cubemapslam_tpu/optim/pose_opt.py``: one SE3 pose, unary
multipinhole edges with Huber delta = sqrt(5.991), 4 rounds of 10 LM
iterations, outliers reclassified by chi2 after each round, robust kernel
dropped from round 3. The JAX version leaves a round's LM loop early once an
accepted step is tiny, inside one compiled program.

- ``pose_optimization``: on CPU tensors ``pose_optimization_masked``; on
  CUDA tensors one launch of ``csrc/pose_lm.cu`` (the whole solve, with
  JAX's early exit, no host read, on one cluster of ``LM_CLUSTER``
  blocks), or it raises. ``POSE_LM.launches`` counts the launches.
- ``pose_optimization_masked``: every round runs a fixed 10 iterations under
  an ``active`` mask: once the exit condition fires no state changes, which
  is exactly equivalent and needs no host synchronisation per iteration.
- ``pose_optimization_ordered``: the kernel's arithmetic in plain PyTorch,
  in the kernel's order, on any device: each thread of the 512 sums its
  edges (edge tid + k * 512) in index order, the warps add by a shuffle
  tree, the 16 warp sums are added in warp order; the 6x6 solve is LU with
  partial pivoting written out, ``se3_exp`` and the composition are written
  out; the early exit is a mask. It holds the kernel on the card and that
  order against JAX on the CPU; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cubemapslam_tpu_torch._build import CudaKernel, require_cuda
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.geometry import se3_compose, se3_exp
from cubemapslam_tpu_torch.optim.residuals import (eval_point,
                                                    pose_jac_from_state)
from cubemapslam_tpu_torch.spans import span

CHI2_TH = 5.991
HUBER_DELTA = float(torch.sqrt(torch.tensor(CHI2_TH, dtype=torch.float32)))

LM_THREADS = 512     # the kernel's virtual threads (csrc kThreads)
LM_WARPS = LM_THREADS // 32
LM_CLUSTERS = (1, 2, 4, 8)   # the cluster sizes the kernel is built for
# The cluster size of every solve. Device ms at C = 1, 2, 4, 8
# (``chip_smoke.py``, NVIDIA H100 80GB HBM3 at 700 W): the tracked frame's
# first solve, 2000 edges, 0.26868, 0.17702, 0.14641, 0.11861; 6000 edges
# 0.64254, 0.45694, 0.29467, 0.20636; 37 edges 0.10133, 0.07429, 0.07959,
# 0.07898. A frame's solves take all its features as edges (2000, 6000 at
# init), where 8 is fastest.
LM_CLUSTER = 8

_P = ctypes.c_void_p
POSE_LM = CudaKernel("pose_lm.cu", "pose_lm_launch",
                     [_P] * 9 + [ctypes.c_float, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
                     + [_P] * 5)


def _huber_weight(chi2: torch.Tensor) -> torch.Tensor:
    """IRLS weight of the Huber kernel on the whitened residual norm."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-20))
    return torch.where(r <= HUBER_DELTA, torch.ones_like(r), HUBER_DELTA / r)


def _rho(chi2: torch.Tensor, robust: bool) -> torch.Tensor:
    if not robust:
        return chi2
    return torch.where(chi2 <= CHI2_TH, chi2,
                       2.0 * HUBER_DELTA * torch.sqrt(
                           torch.clamp(chi2, min=1e-20)) - CHI2_TH)


def pose_optimization(cam: CubemapCamera, R0: torch.Tensor, t0: torch.Tensor,
                      Xw: torch.Tensor, face: torch.Tensor,
                      uv_face: torch.Tensor, inv_sigma2: torch.Tensor,
                      valid: torch.Tensor,
                      n_rounds: int = 4, n_iters: int = 10
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Optimize (R0,t0) world->camera against N fixed landmarks.

    Returns (R, t, inliers, n_inliers). Edges with chi2 > 5.991 after a
    round are excluded from the next round and reported as outliers. CPU
    tensors take ``pose_optimization_masked``; CUDA tensors the kernel.
    Either is the span ``pose_lm``."""
    args = (R0, t0, Xw, face, uv_face, inv_sigma2, valid)
    with span("pose_lm"):
        if all(x.device.type == "cpu"
               for x in args + (cam.face_R, cam.fxycxy)):
            return pose_optimization_masked(cam, *args, n_rounds, n_iters)
        return pose_lm(cam, *args, n_rounds, n_iters)[:4]


def pose_lm(cam: CubemapCamera, R0: torch.Tensor, t0: torch.Tensor,
            Xw: torch.Tensor, face: torch.Tensor, uv_face: torch.Tensor,
            inv_sigma2: torch.Tensor, valid: torch.Tensor,
            n_rounds: int = 4, n_iters: int = 10,
            cluster: int = LM_CLUSTER):
    """The whole solve in one launch of the pose-LM kernel: float32 R0 (3,3),
    t0 (3,), Xw (N,3), uv_face (N,2), inv_sigma2 (N,), int64 face (N,),
    bool valid (N,), the camera's float32 face_R (5,3,3) and fxycxy (4,),
    all contiguous on one CUDA device. ``cluster``: the blocks of the
    kernel's cluster, one of LM_CLUSTERS (the same bits at each). Returns
    (R, t, inliers, n_inliers, iters): ``iters`` (n_rounds,) int32, the LM
    iterations each round ran.
    Allocates the outputs, makes no other device operation and reads
    nothing to the host."""
    tensors = (R0, t0, Xw, face, uv_face, inv_sigma2, valid, cam.face_R,
               cam.fxycxy)
    require_cuda("pose_optimization", *tensors)
    n = Xw.shape[0]
    want = {"R0": (R0, (3, 3), torch.float32), "t0": (t0, (3,), torch.float32),
            "Xw": (Xw, (n, 3), torch.float32),
            "face": (face, (n,), torch.int64),
            "uv_face": (uv_face, (n, 2), torch.float32),
            "inv_sigma2": (inv_sigma2, (n,), torch.float32),
            "valid": (valid, (n,), torch.bool),
            "face_R": (cam.face_R, (5, 3, 3), torch.float32),
            "fxycxy": (cam.fxycxy, (4,), torch.float32)}
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"pose_optimization: {name} must be {shape} "
                             f"{dtype}, got {tuple(x.shape)} {x.dtype}")
    if n_rounds < 1 or n_iters < 1 or n >= 2 ** 31:
        raise ValueError(f"pose_optimization takes at least one round and "
                         f"iteration and fewer than 2^31 edges, got "
                         f"{n_rounds}, {n_iters}, {n}")
    if cluster not in LM_CLUSTERS:
        raise ValueError(f"pose_lm: a cluster of {LM_CLUSTERS} blocks, got "
                         f"{cluster}")
    dev = R0.device
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int64, device=dev)
    iters = torch.empty(n_rounds, dtype=torch.int32, device=dev)
    POSE_LM(*(x.data_ptr() for x in (R0, t0, Xw, uv_face, inv_sigma2, face,
                                     valid, cam.face_R, cam.fxycxy)),
            HUBER_DELTA, n, n_rounds, n_iters, cluster, R.data_ptr(),
            t.data_ptr(), inl.data_ptr(), n_inl.data_ptr(), iters.data_ptr())
    return R, t, inl, n_inl, iters


def pose_optimization_masked(cam: CubemapCamera, R0: torch.Tensor,
                             t0: torch.Tensor, Xw: torch.Tensor,
                             face: torch.Tensor, uv_face: torch.Tensor,
                             inv_sigma2: torch.Tensor, valid: torch.Tensor,
                             n_rounds: int = 4, n_iters: int = 10
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """The solve as n_rounds x n_iters masked iterations of plain PyTorch,
    on any device (the CPU's ``pose_optimization``)."""
    R_face = cam.face_R[face.clamp(0, 4).long()]
    dev, dt_ = R0.device, R0.dtype
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def eval_at(R, t):
        e, Xc, local = eval_point(cam, R, t, Xw, R_face, uv_face)
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
        return e, chi2, Xc, local

    def rho_cost(chi2, robust, inl):
        rho = _rho(chi2, robust)
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


# ---------------------------------------------------------------------------
# The kernel's arithmetic, in its order
# ---------------------------------------------------------------------------

def _edge_lanes(cam, R, t, Xw, R_face, uv_face, inv_sigma2, robust):
    """chi2 (N,) at (R, t) and each edge's 28 reduction lanes (N, 28): rho,
    the 21 upper entries of (w J^T J) row by row, the 6 of (w J^T e); each
    entry is its two residual rows' products added."""
    e, Xc, local = eval_point(cam, R, t, Xw, R_face, uv_face)
    e0, e1 = e[:, 0], e[:, 1]
    chi2 = (e0 * e0 + e1 * e1) * inv_sigma2
    w = inv_sigma2 * _huber_weight(chi2) if robust else inv_sigma2
    J = pose_jac_from_state(cam, Xc, local, R_face)          # (N,2,6)
    wJ = J * w[:, None, None]
    lanes = [_rho(chi2, robust)]
    for i in range(6):
        for j in range(i, 6):
            lanes.append(wJ[:, 0, i] * J[:, 0, j] + wJ[:, 1, i] * J[:, 1, j])
    lanes += [wJ[:, 0, i] * e0 + wJ[:, 1, i] * e1 for i in range(6)]
    return chi2, torch.stack(lanes, dim=1)


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """(N, L) -> (L,): the kernel's reduction. Thread tid adds rows tid,
    tid + 512, ... from +0.0; each warp adds its lanes' sums by a tree of
    offsets 16, 8, 4, 2, 1; the 16 warp sums are added in warp order."""
    n, lanes = v.shape
    k = -(-n // LM_THREADS)
    v = torch.cat([v, v.new_zeros((k * LM_THREADS - n, lanes))])
    s = v.new_zeros((LM_THREADS, lanes))
    for j in range(k):
        s = s + v[j * LM_THREADS:(j + 1) * LM_THREADS]
    s = s.view(LM_WARPS, 32, lanes)
    width = 32
    while width > 1:
        width //= 2
        s = s[:, :width] + s[:, width:2 * width]
    s = s[:, 0]
    total = s[0]
    for w in range(1, LM_WARPS):
        total = total + s[w]
    return total


def _solve6(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor, one):
    """The kernel's solve6: (H + lam diag(H) + 1e-9 I) delta = -g from the
    21 upper entries of H, by LU with partial pivoting (the first largest
    pivot); delta (6,) and |delta|^2."""
    iu = torch.triu_indices(6, 6, device=H.device)
    rows = torch.arange(6, device=H.device)
    A = H.new_zeros((6, 6))
    A[iu[0], iu[1]] = H
    A[iu[1], iu[0]] = H
    diag = A[rows, rows]
    A[rows, rows] = diag + lam * diag + 1e-9 * one
    b = -g
    for k in range(5):
        p = k + torch.argmax(A[k:, k].abs())
        swap = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        A, b = A[swap], b[swap]
        f = A[k + 1:, k] / A[k, k]
        A = torch.cat([A[:k + 1], torch.cat(
            [A[k + 1:, :k + 1], A[k + 1:, k + 1:] - f[:, None] * A[k, k + 1:]],
            dim=1)])
        b = torch.cat([b[:k + 1], b[k + 1:] - f * b[k]])
    d = [None] * 6
    for i in range(5, -1, -1):
        s = b[i]
        for j in range(i + 1, 6):
            s = s - A[i, j] * d[j]
        d[i] = s / A[i, i]
    dd = d[0] * d[0]
    for i in range(1, 6):
        dd = dd + d[i] * d[i]
    return d, dd


def _step_pose(d, R: torch.Tensor, t: torch.Tensor, one):
    """The kernel's step_pose: se3_exp(delta) composed on the left of (R,
    t), every product and sum written out."""
    x, y, z = d[3], d[4], d[5]
    zero = 0.0 * one
    theta = torch.sqrt(x * x + y * y + z * z + 1e-24 * one)
    K = [[zero, -z, y], [z, zero, -x], [-y, x, zero]]
    K2 = [[K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j]
           for j in range(3)] for i in range(3)]
    theta2 = theta * theta
    small = theta < 1e-8
    s, c = torch.sin(theta), torch.cos(theta)
    # divisions by device tensors: a division by a Python number may be
    # a product by its reciprocal on the card
    a = torch.where(small, one - theta2 / (6.0 * one), s / theta)
    b = torch.where(small, 0.5 * one - theta2 / (24.0 * one),
                    (one - c) / theta2)
    cc = torch.where(small, one / (6.0 * one) - theta2 / (120.0 * one),
                     (theta - s) / (theta2 * theta))
    dR = [[(one if i == j else zero) + a * K[i][j] + b * K2[i][j]
           for j in range(3)] for i in range(3)]
    V = [[(one if i == j else zero) + b * K[i][j] + cc * K2[i][j]
          for j in range(3)] for i in range(3)]
    dt = [V[i][0] * d[0] + V[i][1] * d[1] + V[i][2] * d[2] for i in range(3)]
    Rn = torch.stack([torch.stack([dR[i][0] * R[0, j] + dR[i][1] * R[1, j]
                                   + dR[i][2] * R[2, j] for j in range(3)])
                      for i in range(3)])
    tn = torch.stack([dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2]
                      + dt[i] for i in range(3)])
    return Rn, tn


def pose_optimization_ordered(cam: CubemapCamera, R0: torch.Tensor,
                              t0: torch.Tensor, Xw: torch.Tensor,
                              face: torch.Tensor, uv_face: torch.Tensor,
                              inv_sigma2: torch.Tensor, valid: torch.Tensor,
                              n_rounds: int = 4, n_iters: int = 10):
    """The pose-LM kernel's arithmetic in plain PyTorch, in its order, on
    any device and with no host read (the early exit is a mask). Returns
    (R, t, inliers, n_inliers, iters, counted): ``iters`` (n_rounds,) int32
    the LM iterations each round ran, ``counted`` (n_rounds,) int64 the
    edges in each round's sums. A round: the edges at the current pose
    give the round's mask (valid, and from the second round chi2 <= 5.991),
    cost and normal equations; each iteration solves, steps, and sums the
    trial's cost and normal equations in one reduction, which an accepted
    trial keeps."""
    R_face = cam.face_R[face.clamp(0, 4).long()]
    dev = R0.device
    one = torch.ones((), dtype=R0.dtype, device=dev)

    def lanes(R, t, robust):
        return _edge_lanes(cam, R, t, Xw, R_face, uv_face, inv_sigma2, robust)

    def sums(v, mask):
        return _block_sum(torch.where(mask[:, None], v, torch.zeros_like(v)))

    R, t = R0, t0
    inl = valid
    iters, counted = [], []
    for r in range(n_rounds):
        robust = r < 2
        chi2, v = lanes(R, t, robust)
        if r > 0:
            inl = valid & (chi2 <= CHI2_TH)
        tot = sums(v, inl)
        counted.append(inl.sum())
        cost, H, g = tot[0], tot[1:22], tot[22:]
        lam = 1e-3 * one
        active = torch.ones((), dtype=torch.bool, device=dev)
        ran = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(n_iters):
            d, dd = _solve6(H, g, lam, one)
            Rn, tn = _step_pose(d, R, t, one)
            tot = sums(lanes(Rn, tn, robust)[1], inl)
            improved = tot[0] < cost
            take = improved & active
            R = torch.where(take, Rn, R)
            t = torch.where(take, tn, t)
            cost = torch.where(take, tot[0], cost)
            H = torch.where(take, tot[1:22], H)
            g = torch.where(take, tot[22:], g)
            lam = torch.where(active, torch.clamp(torch.where(
                improved, lam * 0.5, lam * 4.0), 1e-8, 1e4), lam)
            ran = ran + active.int()
            active = active & ~(improved & (dd < 1e-12))
        iters.append(ran)
    e, _, _ = eval_point(cam, R, t, Xw, R_face, uv_face)
    chi2 = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) * inv_sigma2
    inl = valid & (chi2 <= CHI2_TH)
    return (R, t, inl, inl.sum(), torch.stack(iters),
            torch.stack(counted))
