"""Two-ray linear triangulation, batched.

Counterpart of ``cubemapslam_tpu/solvers/triangulate.py:18``. The constraint
"P_i X is parallel to ray_i" is written as the cross-product rows
[ray]_x P_i, a (6,4) system A whose least-squares null vector is the
homogeneous point.

The JAX package takes that null vector from a batched SVD of A. On a CUDA
tensor ``torch.linalg.svd`` (and ``eigh``) reads an error flag back to the
host, which would make every mapping step wait for the card. Here the null
vector is the eigenvector of the smallest eigenvalue of the 4x4 normal
matrix AᵀA, found by cyclic Jacobi rotations in float64: a fixed count of
sweeps, no host read, and (in float64, even with the squared condition
number) closer to the exact null vector than a float32 SVD of A.

- ``triangulate_rays``: on CPU tensors ``triangulate_rays_matmul``; on CUDA
  tensors one launch of ``csrc/triangulate.cu`` (one thread a
  correspondence, the whole solve in float64 registers), or it raises.
  ``TRIANGULATE.launches`` counts the launches.
- ``triangulate_rays_matmul``: batched 4x4 products and ``null_vector4``,
  the CPU's path.
- ``triangulate_rays_ordered``: the kernel's arithmetic in plain PyTorch, in
  the kernel's order, on any device: the entries of A and M = AᵀA written
  out, each rotation updating rows p, q then columns p, q of M and columns
  p, q of V, the argmin and the division written out. It holds the kernel
  bitwise on the card and that order against JAX on the CPU; nothing on
  the main path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from cubemapslam_tpu_torch._build import CudaKernel, require_cuda
from cubemapslam_tpu_torch.geometry import hat

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
JACOBI_SWEEPS = 6
W_FLOOR = 1e-12       # |w| below this divides by W_FLOOR
TRI_THREADS = 32      # the kernel's block: N = 2000 is 63 blocks

_P = ctypes.c_void_p
TRIANGULATE = CudaKernel("triangulate.cu", "triangulate_launch",
                         [_P] * 5 + [ctypes.c_int, ctypes.c_int])


def _rotate(M: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One Jacobi rotation zeroing M[..., p, q] of the symmetric (...,4,4)
    ``M``, accumulated into the eigenvector columns ``V``."""
    app, aqq, apq = M[..., p, p], M[..., q, q], M[..., p, q]
    nz = apq != 0
    theta = (aqq - app) / (2.0 * torch.where(nz, apq, torch.ones_like(apq)))
    sgn = torch.where(theta >= 0, 1.0, -1.0).to(M.dtype)
    t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
    t = torch.where(nz, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c
    J = torch.eye(4, dtype=M.dtype, device=M.device).expand(
        M.shape).clone()
    J[..., p, p] = c
    J[..., q, q] = c
    J[..., p, q] = s
    J[..., q, p] = -s
    return J.transpose(-1, -2) @ M @ J, V @ J


def null_vector4(M: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (...,4,4)
    ``M`` (float64), by ``JACOBI_SWEEPS`` cyclic Jacobi sweeps."""
    V = torch.eye(4, dtype=M.dtype, device=M.device).expand(M.shape).clone()
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            M, V = _rotate(M, V, p, q)
    lam = torch.diagonal(M, dim1=-2, dim2=-1)
    k = torch.argmin(lam, dim=-1)                     # first minimum
    return torch.take_along_dim(V, k[..., None, None].expand(
        *k.shape, 4, 1), dim=-1)[..., 0]


def triangulate_rays(rays1: torch.Tensor, rays2: torch.Tensor,
                     R21: torch.Tensor, t21: torch.Tensor) -> torch.Tensor:
    """Triangulate N correspondences.

    rays1/rays2: (N,3) unit bearings in each camera frame. (R21, t21) maps
    frame-1 points to frame 2. Returns (N,3) float32 points in frame 1. CPU
    tensors take ``triangulate_rays_matmul``; CUDA tensors the kernel."""
    if all(x.device.type == "cpu" for x in (rays1, rays2, R21, t21)):
        return triangulate_rays_matmul(rays1, rays2, R21, t21)
    return triangulate_cuda(rays1, rays2, R21, t21)


def triangulate_cuda(rays1: torch.Tensor, rays2: torch.Tensor,
                     R21: torch.Tensor, t21: torch.Tensor,
                     threads: int = TRI_THREADS) -> torch.Tensor:
    """One launch of the triangulation kernel (blocks of ``threads``):
    float32 rays1, rays2 (N,3), R21 (3,3), t21 (3,), all contiguous on one
    CUDA device. Allocates the (N,3) float32 output, makes no other device
    operation and reads nothing to the host; N = 0 launches nothing."""
    require_cuda("triangulate_rays", rays1, rays2, R21, t21)
    n = rays1.shape[0] if rays1.dim() == 2 else -1
    want = {"rays1": (rays1, (n, 3)), "rays2": (rays2, (n, 3)),
            "R21": (R21, (3, 3)), "t21": (t21, (3,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"triangulate_rays: {name} must be {shape} "
                             f"float32, got {tuple(x.shape)} {x.dtype}")
    if n >= 2 ** 31:
        raise ValueError(f"triangulate_rays takes fewer than 2^31 "
                         f"correspondences, got {n}")
    out = torch.empty((n, 3), dtype=torch.float32, device=rays1.device)
    if n:
        TRIANGULATE(rays1.data_ptr(), rays2.data_ptr(), R21.data_ptr(),
                    t21.data_ptr(), out.data_ptr(), n, threads)
    return out


def triangulate_rays_matmul(rays1: torch.Tensor, rays2: torch.Tensor,
                            R21: torch.Tensor, t21: torch.Tensor
                            ) -> torch.Tensor:
    """``triangulate_rays`` by batched products: A from ``hat`` products,
    AᵀA by a batched product, ``null_vector4``; on any device (the CPU's
    path, and what the kernel replaced on the card)."""
    f64 = torch.float64
    r1, r2 = rays1.to(f64), rays2.to(f64)
    P1 = torch.cat([torch.eye(3, dtype=f64, device=r1.device),
                    torch.zeros(3, 1, dtype=f64, device=r1.device)], dim=1)
    P2 = torch.cat([R21.to(f64), t21.to(f64).reshape(3, 1)], dim=1)
    A = torch.cat([hat(r1) @ P1, hat(r2) @ P2], dim=-2)      # (N,6,4)
    X = null_vector4(A.transpose(-1, -2) @ A)                # (N,4)
    w = X[:, 3]
    w_safe = torch.where(w.abs() < W_FLOOR, torch.full_like(w, W_FLOOR), w)
    return (X[:, :3] / w_safe[:, None]).to(rays1.dtype)


def normal_matrices(rays1: torch.Tensor, rays2: torch.Tensor,
                    R21: torch.Tensor, t21: torch.Tensor) -> torch.Tensor:
    """The (N,4,4) float64 normal matrices AᵀA as the kernel forms them:
    rows 0-2 of A are hat(r1) with a zero fourth column, row 3 + i sums the
    two non-zero terms of row i of hat(r2) times [R21 | t21], and each entry
    of M adds the six row products left to right."""
    f64 = torch.float64
    r1, r2 = rays1.to(f64), rays2.to(f64)
    P = torch.cat([R21.to(f64), t21.to(f64).reshape(3, 1)], dim=1)  # (3,4)
    x1, y1, z1 = r1[:, 0], r1[:, 1], r1[:, 2]
    x2, y2, z2 = r2[:, 0, None], r2[:, 1, None], r2[:, 2, None]
    zero = torch.zeros_like(x1)
    A = torch.stack([
        torch.stack([zero, -z1, y1, zero], -1),
        torch.stack([z1, zero, -x1, zero], -1),
        torch.stack([-y1, x1, zero, zero], -1),
        (-z2) * P[1] + y2 * P[2],
        z2 * P[0] + (-x2) * P[2],
        (-y2) * P[0] + x2 * P[1]], 1)                        # (N,6,4)
    prod = A[:, :, :, None] * A[:, :, None, :]               # (N,6,4,4)
    M = prod[:, 0]
    for r in range(1, 6):
        M = M + prod[:, r]
    return M


def triangulate_rays_ordered(rays1: torch.Tensor, rays2: torch.Tensor,
                             R21: torch.Tensor, t21: torch.Tensor
                             ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in the kernel's order, on
    any device (float32 in and out, float64 inside): ``normal_matrices``,
    ``JACOBI_SWEEPS`` sweeps of two-sided rotations on rows then columns p,
    q, the first smallest diagonal entry (a NaN the smallest), the division
    by w. Every step is one elementwise operation, so each value rounds as
    the kernel's does."""
    f64 = torch.float64
    M = normal_matrices(rays1, rays2, R21, t21)
    n = M.shape[0]
    V = torch.eye(4, dtype=f64, device=M.device).expand(n, 4, 4).clone()
    one = torch.ones(n, dtype=f64, device=M.device)
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            app, aqq, apq = M[:, p, p], M[:, q, q], M[:, p, q]
            nz = apq != 0
            theta = (aqq - app) / (2.0 * torch.where(nz, apq, one))
            sgn = torch.where(theta >= 0, one, -one)
            t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(nz, t, torch.zeros_like(t))
            c = one / torch.sqrt(t * t + 1.0)
            s = t * c
            c, s = c[:, None], s[:, None]
            mp, mq = M[:, p, :].clone(), M[:, q, :].clone()
            M[:, p, :] = c * mp - s * mq                     # J^T M
            M[:, q, :] = s * mp + c * mq
            mp, mq = M[:, :, p].clone(), M[:, :, q].clone()
            M[:, :, p] = c * mp - s * mq                     # (J^T M) J
            M[:, :, q] = s * mp + c * mq
            vp, vq = V[:, :, p].clone(), V[:, :, q].clone()
            V[:, :, p] = c * vp - s * vq                     # V J
            V[:, :, q] = s * vp + c * vq
    best, X = M[:, 0, 0], V[:, :, 0]
    for k in range(1, 4):
        d = M[:, k, k]
        take = ~torch.isnan(best) & (torch.isnan(d) | (d < best))
        best = torch.where(take, d, best)
        X = torch.where(take[:, None], V[:, :, k], X)
    w = X[:, 3]
    w = torch.where(w.abs() < W_FLOOR, torch.full_like(w, W_FLOOR), w)
    return (X[:, :3] / w[:, None]).to(torch.float32)
