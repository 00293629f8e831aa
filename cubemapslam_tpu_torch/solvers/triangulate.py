"""Two-ray linear triangulation, batched.

Counterpart of ``cubemapslam_tpu/solvers/triangulate.py:18``. The constraint
"P_i X is parallel to ray_i" is written as the cross-product rows
[ray]_x P_i, a (6,4) system A whose least-squares null vector is the
homogeneous point.

The JAX package takes that null vector from a batched SVD of A. On a CUDA
tensor ``torch.linalg.svd`` (and ``eigh``) reads an error flag back to the
host, which would make every mapping step wait for the card. Here the null
vector is the eigenvector of the smallest eigenvalue of the 4x4 normal
matrix AᵀA, found by cyclic Jacobi rotations in float64: elementwise work
with a fixed count of sweeps, no host read, and (in float64, even with the
squared condition number) closer to the exact null vector than a float32
SVD of A.
"""

from __future__ import annotations

import torch

from cubemapslam_tpu_torch.geometry import hat

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
JACOBI_SWEEPS = 6


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
    frame-1 points to frame 2. Returns (N,3) float32 points in frame 1."""
    f64 = torch.float64
    r1, r2 = rays1.to(f64), rays2.to(f64)
    P1 = torch.cat([torch.eye(3, dtype=f64, device=r1.device),
                    torch.zeros(3, 1, dtype=f64, device=r1.device)], dim=1)
    P2 = torch.cat([R21.to(f64), t21.to(f64).reshape(3, 1)], dim=1)
    A = torch.cat([hat(r1) @ P1, hat(r2) @ P2], dim=-2)      # (N,6,4)
    X = null_vector4(A.transpose(-1, -2) @ A)                # (N,4)
    w = X[:, 3]
    w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return (X[:, :3] / w_safe[:, None]).to(rays1.dtype)
