"""SO3 / SE3 / Sim3 Lie-group operations, batched, in PyTorch.

Counterpart of ``cubemapslam_tpu/geometry.py``. Everything operates on
trailing-dim tensors so the same code serves a single pose and a table of
poses.

Conventions: rotations are (...,3,3) matrices; SE3 tangent is (...,6) ordered
[rho(3), phi(3)] (translation first); Sim3 tangent is (...,7)
[rho, phi, log_s]. Poses are world->camera (Tcw) unless noted.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    """Norm over the last axis, well defined at v=0."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """The rotation nearest a near-orthonormal (...,3,3) ``R``: two
    Newton-Schulz steps R <- R (3I - R^T R) / 2, each squaring the distance
    from SO(3)."""
    eye = _eye_like(R)
    for _ in range(2):
        R = 0.5 * R @ (3.0 * eye - R.transpose(-1, -2) @ R)
    return R


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    theta = _safe_norm(phi)[..., None, None]
    K = hat(phi)
    K2 = K @ K
    theta2 = theta * theta
    small = theta < _EPS
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one,
                                                           theta2))
    return _eye_like(K) + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,3) axis-angle (angle in [0, pi]); theta comes from
    atan2(|w|/2, (tr-1)/2)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = 0.5 * _safe_norm(w)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(theta < 1e-5, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * sin_t, min=_EPS))
    generic = w * scale[..., None]
    # near theta = pi: axis from the diagonal of (R + I)/2
    near_pi = theta[..., None] > (math.pi - 1e-3)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis_sq = torch.clamp((diag - cos_t[..., None])
                          / torch.clamp(1.0 - cos_t[..., None], min=_EPS),
                          min=0.0)
    axis = torch.sqrt(axis_sq)
    s12 = R[..., 0, 1] + R[..., 1, 0]
    s13 = R[..., 0, 2] + R[..., 2, 0]
    s23 = R[..., 1, 2] + R[..., 2, 1]
    a0, a1, a2 = axis[..., 0], axis[..., 1], axis[..., 2]
    one = torch.ones_like(a0)
    # the dominant axis is positive, the others' signs follow
    sign1 = torch.where(a0 >= torch.maximum(a1, a2), one,
                        torch.where(a1 >= a2, torch.sign(s12),
                                    torch.sign(s13)))
    sign2 = torch.where(a1 > torch.maximum(a0, a2), one,
                        torch.where(a0 >= a2, torch.sign(s12),
                                    torch.sign(s23)))
    sign3 = torch.where(a2 > torch.maximum(a0, a1), one,
                        torch.where(a0 >= a1, torch.sign(s13),
                                    torch.sign(s23)))
    signs = torch.stack([sign1, sign2, sign3], -1)
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    pi_branch = axis * signs * theta[..., None]
    return torch.where(near_pi, pi_branch, generic)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V matrix such that t = V @ rho in se3 exp."""
    theta = _safe_norm(phi)[..., None, None]
    K = hat(phi)
    K2 = K @ K
    theta2 = theta * theta
    small = theta < _EPS
    one = torch.ones_like(theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one,
                                                           theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (torch.where(small, one, theta) - torch.sin(theta))
                    / torch.where(small, one, theta2 * theta))
    return _eye_like(K) + b * K + c * K2


def se3_exp(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(...,6) [rho, phi] -> (R (...,3,3), t (...,3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp -> (...,6)."""
    phi = so3_log(R)
    V = _so3_left_jacobian(phi)
    # solve_ex: no error check, so no host synchronisation on the card
    rho = torch.linalg.solve_ex(V, t[..., None])[0][..., 0]
    return torch.cat([rho, phi], -1)


def mat3_apply(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(...,3,3) x (...,3) -> (...,3), unrolled elementwise."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [M[..., 0, 0] * x + M[..., 0, 1] * y + M[..., 0, 2] * z,
         M[..., 1, 0] * x + M[..., 1, 1] * y + M[..., 1, 2] * z,
         M[..., 2, 0] * x + M[..., 2, 1] * y + M[..., 2, 2] * z], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -mat3_apply(Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): x -> Ra(Rb x + tb) + ta."""
    return Ra @ Rb, mat3_apply(Ra, tb) + ta


def se3_apply(R, t, x):
    return mat3_apply(R, x) + t


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------

def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) quaternion [qx,qy,qz,qw], qw >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick the numerically best per element
    qw_ = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2.0
    qx_ = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    qy_ = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    qz_ = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0
    case = torch.argmax(torch.stack([qw_, qx_, qy_, qz_], -1), dim=-1)

    def _safe(x):
        return torch.where(x.abs() < _EPS, torch.full_like(x, _EPS), x)

    q_w = torch.stack([qw_, (m21 - m12) / _safe(4 * qw_),
                       (m02 - m20) / _safe(4 * qw_),
                       (m10 - m01) / _safe(4 * qw_)], -1)
    q_x = torch.stack([(m21 - m12) / _safe(4 * qx_), qx_,
                       (m01 + m10) / _safe(4 * qx_),
                       (m02 + m20) / _safe(4 * qx_)], -1)
    q_y = torch.stack([(m02 - m20) / _safe(4 * qy_),
                       (m01 + m10) / _safe(4 * qy_), qy_,
                       (m12 + m21) / _safe(4 * qy_)], -1)
    q_z = torch.stack([(m10 - m01) / _safe(4 * qz_),
                       (m02 + m20) / _safe(4 * qz_),
                       (m12 + m21) / _safe(4 * qz_), qz_], -1)
    wxyz = torch.stack([q_w, q_x, q_y, q_z], -2)        # (...,4 cases,4)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    wxyz = torch.gather(wxyz, -2, idx)[..., 0, :]
    wxyz = wxyz * torch.where(wxyz[..., :1] < 0, -1.0, 1.0)
    return torch.cat([wxyz[..., 1:], wxyz[..., :1]], -1)  # xyzw


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(...,4) [qx,qy,qz,qw] -> (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


# ---------------------------------------------------------------------------
# Sim3 (loop closing): g = (s, R, t); x -> s R x + t
# ---------------------------------------------------------------------------

def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W matrix of the Sim3 exponential, t = W @ rho, with the standard
    four-branch closed form."""
    theta = _safe_norm(phi)
    s = torch.exp(sigma)
    small_t = theta < 1e-5
    small_s = sigma.abs() < 1e-5
    th = torch.where(small_t, torch.ones_like(theta), theta)
    sig = torch.where(small_s, torch.ones_like(sigma), sigma)
    t2 = th * th
    C = torch.where(small_s, torch.ones_like(s), (s - 1.0) / sig)
    # sigma ~ 0 branch
    A_s0 = torch.where(small_t, torch.full_like(th, 0.5),
                       (1.0 - torch.cos(th)) / t2)
    B_s0 = torch.where(small_t, torch.full_like(th, 1.0 / 6.0),
                       (th - torch.sin(th)) / (t2 * th))
    # sigma != 0, theta ~ 0 branch
    A_t0 = ((sig - 1.0) * s + 1.0) / (sig * sig)
    B_t0 = ((0.5 * sig * sig - sig + 1.0) * s - 1.0) / (sig * sig * sig)
    # general branch
    a = s * torch.sin(th)
    b = s * torch.cos(th)
    c = t2 + sig * sig
    A_g = (a * sig + (1.0 - b) * th) / (th * c)
    B_g = (C - ((b - 1.0) * sig + a * th) / c) / t2
    A = torch.where(small_s, A_s0, torch.where(small_t, A_t0, A_g))
    B = torch.where(small_s, B_s0, torch.where(small_t, B_t0, B_g))
    K = hat(phi)
    K2 = K @ K
    return (A[..., None, None] * K + B[..., None, None] * K2
            + C[..., None, None] * _eye_like(K))


def sim3_exp(xi: torch.Tensor):
    """(...,7) [rho, phi, sigma] -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    W = _sim3_W(phi, sigma)
    t = torch.einsum("...ij,...j->...i", W, rho)
    return s, R, t


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * mat3_apply(Rt, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) o (sb,Rb,tb): x -> sa Ra (sb Rb x + tb) + ta."""
    return (sa * sb, Ra @ Rb,
            sa[..., None] * mat3_apply(Ra, tb) + ta)


def sim3_apply(s, R, t, x):
    return s[..., None] * mat3_apply(R, x) + t


def sim3_log(s, R, t) -> torch.Tensor:
    """Inverse of sim3_exp (solve t = W rho for rho) -> (...,7)."""
    sigma = torch.log(s)
    phi = so3_log(R)
    W = _sim3_W(phi, sigma)
    # solve_ex: no error check, so no host synchronisation on the card
    rho = torch.linalg.solve_ex(W, t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)
