"""Multipinhole reprojection residuals + analytic Jacobians, in PyTorch.

Counterpart of ``cubemapslam_tpu/optim/residuals.py``. Each edge stores the
keypoint's face and its in-face pixel measurement; the projection rotates
the camera-frame point into that face's frame and applies the shared
pinhole intrinsics. Tangent convention: left-multiplicative SE3 update
T <- exp([rho, phi]) T, so dXc/d(rho,phi) = [I | -hat(Xc)].
"""

from __future__ import annotations

from typing import Tuple

import torch

from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.geometry import mat3_apply


def _z_safe(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def _face_R(cam: CubemapCamera, face: torch.Tensor) -> torch.Tensor:
    return cam.face_R[face.clamp(0, 4).long()]


def project_to_face(cam: CubemapCamera, Xc: torch.Tensor,
                    face: torch.Tensor) -> torch.Tensor:
    """Camera-frame point(s) -> in-face pixel(s) on the *given* face."""
    local = mat3_apply(_face_R(cam, face), Xc)
    fx, fy, cx, cy = cam.fxycxy[0], cam.fxycxy[1], cam.fxycxy[2], \
        cam.fxycxy[3]
    z = _z_safe(local[..., 2])
    return torch.stack([local[..., 0] * fx / z + cx,
                        local[..., 1] * fy / z + cy], dim=-1)


def reproj_residual(cam: CubemapCamera, R: torch.Tensor, t: torch.Tensor,
                    Xw: torch.Tensor, face: torch.Tensor,
                    uv_face: torch.Tensor) -> torch.Tensor:
    """e = observed - projected, in in-face pixels. Broadcasts over edges."""
    Xc = mat3_apply(R, Xw) + t
    return uv_face - project_to_face(cam, Xc, face)


def _proj_jac_local(cam: CubemapCamera, local: torch.Tensor) -> torch.Tensor:
    """du/dlocal for the shared pinhole: (...,2,3)."""
    fx, fy = cam.fxycxy[0], cam.fxycxy[1]
    x, y = local[..., 0], local[..., 1]
    iz = 1.0 / _z_safe(local[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1),
    ], -2)


def eval_point(cam: CubemapCamera, R: torch.Tensor, t: torch.Tensor,
               Xw: torch.Tensor, R_face: torch.Tensor, uv_face: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shared pass: residual e, camera-frame Xc and face-local point
    (R_face is the pre-gathered per-edge face rotation)."""
    Xc = mat3_apply(R, Xw) + t
    local = mat3_apply(R_face, Xc)
    fx, fy, cx, cy = cam.fxycxy[0], cam.fxycxy[1], cam.fxycxy[2], \
        cam.fxycxy[3]
    z = _z_safe(local[..., 2])
    proj = torch.stack([local[..., 0] * fx / z + cx,
                        local[..., 1] * fy / z + cy], dim=-1)
    return uv_face - proj, Xc, local


def _jproj_rface(cam: CubemapCamera, local: torch.Tensor,
                 R_face: torch.Tensor):
    """(J_proj R_face) as two rows of three entries, using the pinhole
    Jacobian's sparsity."""
    fx, fy = cam.fxycxy[0], cam.fxycxy[1]
    lx, ly = local[..., 0], local[..., 1]
    iz = 1.0 / _z_safe(local[..., 2])
    a0 = fx * iz                    # J_proj[0,0]
    a2 = -fx * lx * iz * iz         # J_proj[0,2]
    b1 = fy * iz                    # J_proj[1,1]
    b2 = -fy * ly * iz * iz         # J_proj[1,2]
    return ([a0 * R_face[..., 0, k] + a2 * R_face[..., 2, k]
             for k in range(3)],
            [b1 * R_face[..., 1, k] + b2 * R_face[..., 2, k]
             for k in range(3)])


def pose_jac_from_state(cam: CubemapCamera, Xc: torch.Tensor,
                        local: torch.Tensor, R_face: torch.Tensor
                        ) -> torch.Tensor:
    """de/dxi (...,2,6) from a cached eval_point state."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    rows = []
    for A0, A1, A2 in _jproj_rface(cam, local, R_face):
        # JR @ hat(Xc): hat = [[0,-z,y],[z,0,-x],[-y,x,0]]
        h0 = A1 * z - A2 * y
        h1 = -A0 * z + A2 * x
        h2 = A0 * y - A1 * x
        rows.append(torch.stack([-A0, -A1, -A2, h0, h1, h2], dim=-1))
    return torch.stack(rows, dim=-2)                    # (...,2,6)


def reproj_jacobians(cam: CubemapCamera, R: torch.Tensor, t: torch.Tensor,
                     Xw: torch.Tensor, face: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic (de/dxi (...,2,6), de/dXw (...,2,3)):
    de/dxi = -J_proj R_face [I | -hat(Xc)], de/dXw = -J_proj R_face R."""
    Xc = mat3_apply(R, Xw) + t
    R_face = _face_R(cam, face)
    local = mat3_apply(R_face, Xc)
    J_pose = pose_jac_from_state(cam, Xc, local, R_face)
    rows = []
    for A0, A1, A2 in _jproj_rface(cam, local, R_face):
        rows.append(torch.stack(
            [-(A0 * R[..., 0, 0] + A1 * R[..., 1, 0] + A2 * R[..., 2, 0]),
             -(A0 * R[..., 0, 1] + A1 * R[..., 1, 1] + A2 * R[..., 2, 1]),
             -(A0 * R[..., 0, 2] + A1 * R[..., 1, 2] + A2 * R[..., 2, 2])],
            dim=-1))
    return J_pose, torch.stack(rows, dim=-2)            # (...,2,3)
