"""Cubemap + Scaramuzza omnidirectional camera model in PyTorch.

Counterpart of ``cubemapslam_tpu/camera.py``. The camera is a small frozen
dataclass of tensors on one device, and every mapping (fisheye<->ray,
ray<->cubemap, face selection, face rotations, angular noise) is a batched
function over ``(..., )`` point tensors. The 5 per-face rotations are one
constant ``(5,3,3)`` tensor so face dispatch is a gather, not a switch.

Face conventions: FRONT=0, LEFT=1, RIGHT=2, UPPER=3, LOWER=4, UNKNOWN=-1.

Cubemap cross layout: one 3W x 3H image; face offsets in face units are
FRONT(1,1), LEFT(0,1), RIGHT(2,1), UPPER(1,0), LOWER(1,2). All faces share
pinhole intrinsics fx=fy=cx=cy=W/2.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cubemapslam_tpu_torch.config import SlamConfig

UNKNOWN_FACE = -1
FRONT = 0
LEFT = 1
RIGHT = 2
UPPER = 3
LOWER = 4

# R_rig_to_face: local = R @ rig
#   FRONT: (x, y, z)   LEFT: (z, y, -x)   RIGHT: (-z, y, x)
#   UPPER: (x, z, -y)  LOWER: (x, -z, y)
_FACE_R_NP = np.array(
    [
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],     # FRONT
        [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],    # LEFT
        [[0, 0, -1], [0, 1, 0], [1, 0, 0]],    # RIGHT
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]],    # UPPER
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]],    # LOWER
    ],
    dtype=np.float32,
)

# Cross-layout offsets in face units (ox, oy)
_FACE_OFFSET_NP = np.array(
    [[1, 1], [0, 1], [2, 1], [1, 0], [1, 2]], dtype=np.float32
)

# Octant-test priority order: front, right, left, lower, upper.
_OCTANT_PRIORITY = (FRONT, RIGHT, LEFT, LOWER, UPPER)

# (column cell i, row cell j) of the 3x3 cross -> face id
_CELL_FACE_NP = np.array(
    [[UNKNOWN_FACE, LEFT, UNKNOWN_FACE],
     [UPPER, FRONT, LOWER],
     [UNKNOWN_FACE, RIGHT, UNKNOWN_FACE]], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class CubemapCamera:
    """Immutable camera parameters; every field is a tensor on one device."""

    poly: torch.Tensor        # (P,)  forward poly, z = -horner(poly, rho)
    inv_poly: torch.Tensor    # (Q,)  inverse poly rho(theta)
    c: torch.Tensor           # affine c (scalar)
    d: torch.Tensor
    e: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    fisheye_wh: torch.Tensor  # (2,) [W, H] as float
    face_wh: torch.Tensor     # (2,) [W, H] face size as float
    fxycxy: torch.Tensor      # (4,) [fx, fy, cx, cy] shared pinhole intrinsics
    cos_fov_th: torch.Tensor  # scalar cos(fov/2)
    face_R: torch.Tensor      # (5,3,3) rig->face rotations
    face_offset: torch.Tensor  # (5,2) face-unit offsets in the cross layout

    @property
    def device(self) -> torch.device:
        return self.poly.device

    @property
    def inv_affine(self) -> torch.Tensor:
        return self.c - self.d * self.e

    @staticmethod
    def from_config(cfg: SlamConfig, device, dtype=torch.float32
                    ) -> "CubemapCamera":
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        return CubemapCamera(
            poly=t(cfg.poly),
            inv_poly=t(cfg.inv_poly),
            c=t(cfg.affine_c),
            d=t(cfg.affine_d),
            e=t(cfg.affine_e),
            u0=t(cfg.u0),
            v0=t(cfg.v0),
            fisheye_wh=t([cfg.fisheye_width, cfg.fisheye_height]),
            face_wh=t([cfg.cube_face_w, cfg.cube_face_h]),
            fxycxy=t([cfg.face_fx, cfg.face_fy, cfg.face_cx, cfg.face_cy]),
            cos_fov_th=t(np.float32(cfg.cos_fov_th)),
            face_R=t(_FACE_R_NP),
            face_offset=t(_FACE_OFFSET_NP),
        )


def _horner(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate sum_i coeffs[i] * x**i, highest coefficient first (the
    reverse scan of the JAX version, same rounding order)."""
    res = torch.zeros_like(x)
    for i in range(coeffs.shape[0] - 1, -1, -1):
        res = res * x + coeffs[i]
    return res


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a trailing axis of 3, summed x, y, z in order."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(x * x + y * y + z * z)


def _face_index(face: torch.Tensor) -> torch.Tensor:
    return torch.clamp(face, 0, 4).long()


# ---------------------------------------------------------------------------
# Fisheye image <-> unit rays (Scaramuzza model)
# ---------------------------------------------------------------------------

def img_to_ray(cam: CubemapCamera, uv: torch.Tensor) -> torch.Tensor:
    """Fisheye pixel(s) (..., 2) -> unit bearing ray(s) (..., 3)."""
    u_t = uv[..., 0] - cam.u0
    v_t = uv[..., 1] - cam.v0
    inv_aff = cam.inv_affine
    x = (u_t - cam.d * v_t) / inv_aff
    y = (-cam.e * u_t + cam.c * v_t) / inv_aff
    rho = torch.sqrt(x * x + y * y)
    z = -_horner(cam.poly, rho)
    X = torch.stack([x, y, z], dim=-1)
    return X / _norm3(X)[..., None]


def ray_to_img(cam: CubemapCamera, rays: torch.Tensor) -> torch.Tensor:
    """Ray(s) -> fisheye pixel(s) via theta=atan(-z/rho) and the inverse
    polynomial."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    norm = torch.sqrt(x * x + y * y)
    norm = torch.where(norm == 0.0, torch.full_like(norm, 1e-14), norm)
    theta = torch.atan(-z / norm)
    rho = _horner(cam.inv_poly, theta)
    uu = x / norm * rho
    vv = y / norm * rho
    u = uu * cam.c + vv * cam.d + cam.u0
    v = uu * cam.e + vv + cam.v0
    return torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------------------
# Face selection
# ---------------------------------------------------------------------------

def face_from_ray(rays: torch.Tensor) -> torch.Tensor:
    """Octant test on rig rays -> face id in priority order. (...,3) -> (...,)
    int64."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    conds = (
        (z > 0) & (ax <= z) & (ay <= z),      # FRONT
        (x > 0) & (ay <= x) & (az <= x),      # RIGHT
        (x < 0) & (ay <= -x) & (az <= -x),    # LEFT
        (y > 0) & (ax <= y) & (az <= y),      # LOWER
        (y < 0) & (ax <= -y) & (az <= -y),    # UPPER
    )
    face = torch.full(x.shape, UNKNOWN_FACE, dtype=torch.int64,
                      device=rays.device)
    # lowest priority first, so the first true condition wins
    for cond, fid in reversed(list(zip(conds, _OCTANT_PRIORITY))):
        face = torch.where(cond, torch.full_like(face, fid), face)
    return face


def face_from_cubemap_uv(cam: CubemapCamera, uv: torch.Tensor
                         ) -> torch.Tensor:
    """Cubemap-cross pixel -> face id by 2D cell. (...,2) -> (...,) int64."""
    i = torch.floor(uv[..., 0] / cam.face_wh[0]).long()
    j = torch.floor(uv[..., 1] / cam.face_wh[1]).long()
    cell_face = torch.as_tensor(_CELL_FACE_NP, device=uv.device)
    inside = (i >= 0) & (i < 3) & (j >= 0) & (j < 3)
    f = cell_face[i.clamp(0, 2), j.clamp(0, 2)]
    return torch.where(inside, f, torch.full_like(f, UNKNOWN_FACE))


# ---------------------------------------------------------------------------
# Rays <-> cubemap
# ---------------------------------------------------------------------------

def rig_to_face(cam: CubemapCamera, rays: torch.Tensor,
                face: torch.Tensor) -> torch.Tensor:
    """Rotate rig-frame points into per-point face frames."""
    R = cam.face_R[_face_index(face)]            # (...,3,3)
    return torch.einsum("...ij,...j->...i", R, rays)


def face_to_rig(cam: CubemapCamera, pts: torch.Tensor,
                face: torch.Tensor) -> torch.Tensor:
    """Inverse of rig_to_face."""
    R = cam.face_R[_face_index(face)]
    return torch.einsum("...ji,...j->...i", R, pts)


def _pinhole(cam: CubemapCamera, local: torch.Tensor):
    fx, fy, cx, cy = cam.fxycxy[0], cam.fxycxy[1], cam.fxycxy[2], \
        cam.fxycxy[3]
    z = local[..., 2]
    z_safe = torch.where(z == 0, torch.full_like(z, 1e-14), z)
    up = local[..., 0] * fx / z_safe + cx
    vp = local[..., 1] * fy / z_safe + cy
    return up, vp


def ray_to_cubemap(cam: CubemapCamera, rays: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rig ray(s)/point(s) -> cubemap-cross pixel + face: octant face select,
    rotate into the face frame, pinhole projection, reject projections
    outside the face, add the cross-layout offset.

    Returns (uv (...,2) cubemap-cross pixels, face (...,) int64; UNKNOWN=-1
    with uv=(-1,-1) where invalid).
    """
    face = face_from_ray(rays)
    local = rig_to_face(cam, rays, face)
    up, vp = _pinhole(cam, local)
    in_face = ((up >= 0) & (up < cam.face_wh[0])
               & (vp >= 0) & (vp < cam.face_wh[1]))
    valid = (face != UNKNOWN_FACE) & in_face
    off = cam.face_offset[_face_index(face)]
    u_cm = up + off[..., 0] * cam.face_wh[0]
    v_cm = vp + off[..., 1] * cam.face_wh[1]
    neg = torch.full_like(u_cm, -1.0)
    uv = torch.stack([torch.where(valid, u_cm, neg),
                      torch.where(valid, v_cm, neg)], dim=-1)
    face = torch.where(valid, face, torch.full_like(face, UNKNOWN_FACE))
    return uv, face


def ray_to_face_uv(cam: CubemapCamera, rays: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like ray_to_cubemap but returns in-face coordinates without the cross
    offset."""
    uv, face = ray_to_cubemap(cam, rays)
    off = cam.face_offset[_face_index(face)]
    in_face = uv - off * cam.face_wh
    in_face = torch.where((face != UNKNOWN_FACE)[..., None], in_face,
                          torch.full_like(in_face, -1.0))
    return in_face, face


def ray_to_target_face(cam: CubemapCamera, rays: torch.Tensor,
                       face: torch.Tensor) -> torch.Tensor:
    """Project onto a *given* face even if the point lies outside it.
    Returns in-face (u,v)."""
    local = rig_to_face(cam, rays, face)
    up, vp = _pinhole(cam, local)
    return torch.stack([up, vp], dim=-1)


def cubemap_to_ray(cam: CubemapCamera, uv: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cubemap-cross pixel -> unit rig ray + face."""
    face = face_from_cubemap_uv(cam, uv)
    fx, fy, cx, cy = cam.fxycxy[0], cam.fxycxy[1], cam.fxycxy[2], \
        cam.fxycxy[3]
    in_u = uv[..., 0] - torch.floor(uv[..., 0] / cam.face_wh[0]) \
        * cam.face_wh[0]
    in_v = uv[..., 1] - torch.floor(uv[..., 1] / cam.face_wh[1]) \
        * cam.face_wh[1]
    local = torch.stack(
        [(in_u - cx) / fx, (in_v - cy) / fy, torch.ones_like(in_u)], dim=-1)
    rig = face_to_rig(cam, local, face)
    n = _norm3(rig)[..., None]
    rig = rig / torch.where(n > 0, n, torch.ones_like(n))
    rig = torch.where((face != UNKNOWN_FACE)[..., None], rig,
                      torch.zeros_like(rig))
    return rig, face


def cubemap_uv_to_in_face(cam: CubemapCamera, uv: torch.Tensor
                          ) -> torch.Tensor:
    """Cross coords -> in-face coords."""
    return uv - torch.floor(uv / cam.face_wh) * cam.face_wh


# ---------------------------------------------------------------------------
# Fisheye <-> cubemap (for warp-map building)
# ---------------------------------------------------------------------------

def cubemap_to_fisheye(cam: CubemapCamera, uv: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cubemap-cross pixel -> fisheye pixel; invalid -> (-1,-1).
    Returns (uv_f, valid)."""
    ray, face = cubemap_to_ray(cam, uv)
    uv_f = ray_to_img(cam, ray)
    inside = ((uv_f[..., 0] >= 0) & (uv_f[..., 0] < cam.fisheye_wh[0])
              & (uv_f[..., 1] >= 0) & (uv_f[..., 1] < cam.fisheye_wh[1]))
    valid = inside & (face != UNKNOWN_FACE)
    uv_f = torch.where(valid[..., None], uv_f, torch.full_like(uv_f, -1.0))
    return uv_f, valid


def fisheye_to_cubemap(cam: CubemapCamera, uv_f: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fisheye pixel -> cubemap pixel + face."""
    ray = img_to_ray(cam, uv_f)
    return ray_to_cubemap(cam, ray)


# ---------------------------------------------------------------------------
# Angular noise model (for the ray-epipolar checks)
# ---------------------------------------------------------------------------

def epipolar_radius(cam: CubemapCamera, uv: torch.Tensor) -> torch.Tensor:
    """Distance of an in-face point from the face center; uv is cross
    coords."""
    in_face = cubemap_uv_to_in_face(cam, uv)
    cx, cy = cam.fxycxy[2], cam.fxycxy[3]
    return torch.sqrt((in_face[..., 0] - cx) ** 2
                      + (in_face[..., 1] - cy) ** 2)


def vector_sigma(cam: CubemapCamera, uv: torch.Tensor,
                 sigma_px: float = 1.0) -> torch.Tensor:
    """1-pixel image noise -> angular sigma on the bearing ray."""
    r = epipolar_radius(cam, uv)
    fx = cam.fxycxy[0]
    return sigma_px * fx / (fx * fx + r * (r + sigma_px))


def _sigma_tail(a, b, nfx, nfy, fx, sigma_px):
    """Shared trigonometric tail of the anisotropic sigma: |a|/|n|, |b|/|n|
    are the in-face offsets along and across the epipolar direction."""
    eps = 1e-12
    s = torch.sqrt(nfx * nfx + nfy * nfy)
    OO1 = a.abs() / torch.clamp(s, min=eps)
    PO1 = b.abs() / torch.clamp(s, min=eps)
    CO1 = torch.sqrt(OO1 * OO1 + fx * fx)
    tan1 = PO1 / CO1
    tan2 = (PO1 + sigma_px) / CO1
    tan3 = (tan2 - tan1) / (1 + tan1 * tan2)
    return 1.0 / torch.sqrt(1.0 / torch.clamp(tan3 * tan3, min=eps) + 1.0)


def vector_sigma_along_normal_pairwise(cam: CubemapCamera,
                                       uv2: torch.Tensor,
                                       normals: torch.Tensor,
                                       sigma_px: float = 1.0
                                       ) -> torch.Tensor:
    """(N1,N2) anisotropic angular sigmas for every (epipolar normal,
    keypoint-2) pair. The per-pair dependence on the normal is linear in the
    normal, so it factors into four (N1,3) @ (3,N2) products against
    per-keypoint vectors, with the trigonometric tail elementwise."""
    face = face_from_cubemap_uv(cam, uv2)
    Rf = cam.face_R[_face_index(face)]                  # (N2,3,3)
    r0 = Rf[:, 0, :]
    r1 = Rf[:, 1, :]
    in_face = cubemap_uv_to_in_face(cam, uv2)
    fx, cx, cy = cam.fxycxy[0], cam.fxycxy[2], cam.fxycxy[3]
    OPx = in_face[..., 0] - cx
    OPy = in_face[..., 1] - cy
    A = OPx[:, None] * r1 - OPy[:, None] * r0           # (N2,3)
    B = OPx[:, None] * r0 + OPy[:, None] * r1
    a = normals @ A.T                                   # (N1,N2)
    b = normals @ B.T
    nfx = normals @ r0.T
    nfy = normals @ r1.T
    return _sigma_tail(a, b, nfx, nfy, fx, sigma_px)


def vector_sigma_along_normal(cam: CubemapCamera, uv: torch.Tensor,
                              normal_rig: torch.Tensor,
                              sigma_px: float = 1.0) -> torch.Tensor:
    """Anisotropic angular sigma: pixel noise projected perpendicular to the
    epipolar direction, given the epipolar-plane normal in the rig frame."""
    face = face_from_cubemap_uv(cam, uv)
    n_cam = rig_to_face(cam, normal_rig, face)
    in_face = cubemap_uv_to_in_face(cam, uv)
    fx, cx, cy = cam.fxycxy[0], cam.fxycxy[2], cam.fxycxy[3]
    OPx = in_face[..., 0] - cx
    OPy = in_face[..., 1] - cy
    nx, ny = n_cam[..., 0], n_cam[..., 1]
    # OP . epi with epi = (ny, -nx, 0); OP . vert with vert = (nx, ny, 0)
    a = OPx * ny + OPy * (-nx)
    b = OPx * nx + OPy * ny
    return _sigma_tail(a, b, nx, ny, fx, sigma_px)
