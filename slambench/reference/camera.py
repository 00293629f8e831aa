"""The Lafida cam0 camera as the benchmark's yardstick sees it: Scaramuzza's
omnidirectional model (forward polynomial z = -poly(rho), inverse
polynomial rho(theta), the affine correction) and the five-face cubemap
cross with the shared pinhole intrinsics fx = fy = cx = cy = face_w / 2.

Written from the model's equations (Scaramuzza, "A Toolbox for Easily
Calibrating Omnidirectional Cameras", IROS 2006; the cubemap layout of
CubemapSLAM, Wang et al., ACCV 2018), in plain PyTorch that runs in any
dtype on any device: the traffic renders with it in float32 on the card,
the reference checks with it in float64 on the host. Faces: FRONT=0,
LEFT=1, RIGHT=2, UPPER=3, LOWER=4, none=-1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# rig -> face rotations (local = R @ rig)
FACE_R = ((((1, 0, 0), (0, 1, 0), (0, 0, 1))),     # FRONT
          (((0, 0, 1), (0, 1, 0), (-1, 0, 0))),    # LEFT
          (((0, 0, -1), (0, 1, 0), (1, 0, 0))),    # RIGHT
          (((1, 0, 0), (0, 0, 1), (0, -1, 0))),    # UPPER
          (((1, 0, 0), (0, 0, -1), (0, 1, 0))))    # LOWER
# each face's cell (column, row) in the 3x3 cross
FACE_CELL = ((1, 1), (0, 1), (2, 1), (1, 0), (1, 2))


class Camera(NamedTuple):
    """The calibration, as plain numbers (a configuration file's fields)."""

    poly: tuple
    inv_poly: tuple
    c: float
    d: float
    e: float
    u0: float
    v0: float
    fisheye_w: int
    fisheye_h: int
    face_w: int
    fov_deg: float

    @staticmethod
    def from_fields(f: dict) -> "Camera":
        return Camera(tuple(f["poly"]), tuple(f["inv_poly"]),
                      f["affine_c"], f["affine_d"], f["affine_e"], f["u0"],
                      f["v0"], f["fisheye_width"], f["fisheye_height"],
                      f["cube_face_w"], f["fov_deg"])

    @property
    def focal(self) -> float:
        """The faces' pinhole focal length (and principal point)."""
        return self.face_w / 2.0

    @property
    def cos_fov(self) -> float:
        return math.cos(math.radians(self.fov_deg) / 2.0)

    @property
    def fisheye_px_per_rad(self) -> float:
        """First-order pixels a radian at the fisheye centre."""
        return abs(self.poly[0]) if self.poly else 250.0


def _poly(coeffs, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    for a in reversed(coeffs):
        out = out * x + a
    return out


def img_to_ray(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Fisheye pixels (..., 2) -> unit rays (..., 3)."""
    du, dv = uv[..., 0] - cam.u0, uv[..., 1] - cam.v0
    det = cam.c - cam.d * cam.e
    x = (du - cam.d * dv) / det
    y = (-cam.e * du + cam.c * dv) / det
    z = -_poly(cam.poly, torch.sqrt(x * x + y * y))
    X = torch.stack([x, y, z], dim=-1)
    return X / torch.linalg.norm(X, dim=-1, keepdim=True)


def ray_to_img(cam: Camera, rays: torch.Tensor) -> torch.Tensor:
    """Rays (..., 3) -> fisheye pixels (..., 2)."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    r = torch.sqrt(x * x + y * y)
    r = torch.where(r == 0, torch.full_like(r, 1e-14), r)
    rho = _poly(cam.inv_poly, torch.atan(-z / r))
    a, b = x / r * rho, y / r * rho
    return torch.stack([a * cam.c + b * cam.d + cam.u0,
                        a * cam.e + b + cam.v0], dim=-1)


def face_of_ray(rays: torch.Tensor) -> torch.Tensor:
    """The face a ray leaves through (octant test, FRONT, RIGHT, LEFT,
    LOWER, UPPER first), -1 for none."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    tests = ((0, (z > 0) & (ax <= z) & (ay <= z)),
             (2, (x > 0) & (ay <= x) & (az <= x)),
             (1, (x < 0) & (ay <= -x) & (az <= -x)),
             (4, (y > 0) & (ax <= y) & (az <= y)),
             (3, (y < 0) & (ax <= -y) & (az <= -y)))
    face = torch.full(x.shape, -1, dtype=torch.int64, device=rays.device)
    for fid, hit in reversed(tests):
        face = torch.where(hit, torch.full_like(face, fid), face)
    return face


def _face_tables(cam: Camera, like: torch.Tensor):
    R = torch.tensor(FACE_R, dtype=like.dtype, device=like.device)
    cell = torch.tensor(FACE_CELL, dtype=like.dtype, device=like.device)
    return R, cell * cam.face_w


def face_of_cross(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """The face of cross pixels (..., 2), -1 off the cross."""
    i = torch.floor(uv[..., 0] / cam.face_w).long()
    j = torch.floor(uv[..., 1] / cam.face_w).long()
    table = torch.full((3, 3), -1, dtype=torch.int64, device=uv.device)
    for fid, (ci, cj) in enumerate(FACE_CELL):
        table[ci, cj] = fid
    inside = (i >= 0) & (i < 3) & (j >= 0) & (j < 3)
    f = table[i.clamp(0, 2), j.clamp(0, 2)]
    return torch.where(inside, f, torch.full_like(f, -1))


def cross_to_ray(cam: Camera, uv: torch.Tensor):
    """Cross pixels (..., 2) -> (unit rig rays (..., 3), face); zero rays off
    the cross."""
    face = face_of_cross(cam, uv)
    R, off = _face_tables(cam, uv)
    fi = face.clamp(min=0)
    local = uv - off[fi]
    f = cam.focal
    loc = torch.stack([(local[..., 0] - f) / f, (local[..., 1] - f) / f,
                       torch.ones_like(local[..., 0])], dim=-1)
    rig = torch.einsum("...ji,...j->...i", R[fi], loc)
    rig = rig / torch.linalg.norm(rig, dim=-1, keepdim=True)
    return torch.where((face >= 0)[..., None], rig, torch.zeros_like(rig)), \
        face


def warp_coords(cam: Camera, dtype=torch.float64, device="cpu"):
    """For every pixel of the (3 face_w)^2 cross: the fisheye (x, y) it
    samples and whether it is on a face and inside the fisheye image."""
    n = 3 * cam.face_w
    ax = torch.arange(n, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(ax, ax, indexing="ij")
    ray, face = cross_to_ray(cam, torch.stack([uu, vv], dim=-1))
    xy = ray_to_img(cam, ray)
    ok = ((face >= 0) & (xy[..., 0] >= 0) & (xy[..., 0] < cam.fisheye_w)
          & (xy[..., 1] >= 0) & (xy[..., 1] < cam.fisheye_h))
    return xy, ok


def fov_cross(cam: Camera, dtype=torch.float64, device="cpu"):
    """(3 face_w)^2 bool: cross pixels whose ray lies inside the fisheye's
    field of view (features are taken only there)."""
    n = 3 * cam.face_w
    ax = torch.arange(n, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(ax, ax, indexing="ij")
    ray, face = cross_to_ray(cam, torch.stack([uu, vv], dim=-1))
    return (face >= 0) & (ray[..., 2] >= cam.cos_fov)
