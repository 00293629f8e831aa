"""Fisheye -> cubemap warping (map building and the plain resamplers).

Counterpart of ``cubemapslam_tpu/warp.py``. A per-pixel table of the fisheye
coordinates each pixel of the 3H x 3W cross samples is precomputed once
through the camera model; every frame is then resampled by a bilinear
gather whose corner and weights follow from those coordinates
(``bilinear_operands``, the formula of the JAX ``build_warp_map``).
``warp_bilinear`` here is the plain PyTorch version of the CUDA remap
kernel in ``warp_cuda.py`` (kernel W); the kernel is held to it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cubemapslam_tpu_torch import camera as C
from cubemapslam_tpu_torch.camera import CubemapCamera


class WarpMap(NamedTuple):
    """Precomputed resampling plan for one calibration (static per run)."""

    xy: torch.Tensor         # (Hc, Wc, 2) float32 fisheye (x, y) each cross
                             # pixel samples; NaN outside the five faces or
                             # the fisheye image
    src_wh: Tuple[int, int]  # fisheye (W, H)

    @property
    def valid(self) -> torch.Tensor:
        """(Hc, Wc) bool: cross cell AND inside the fisheye image."""
        return ~torch.isnan(self.xy[..., 0])


def _cross_grid(cube_w: int, cube_h: int, device) -> torch.Tensor:
    """(Hc, Wc, 2) pixel coordinates (u, v) of the cubemap cross."""
    ju = torch.arange(cube_w, dtype=torch.float32, device=device)
    jv = torch.arange(cube_h, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(jv, ju, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def warp_map_from_coords(uv_f: torch.Tensor, valid: torch.Tensor,
                         src_wh: Tuple[int, int]) -> WarpMap:
    """A map from the fisheye coordinates of each cross pixel and their
    validity (as ``camera.cubemap_to_fisheye`` returns them)."""
    xy = torch.where(valid[..., None], uv_f.to(torch.float32),
                     torch.full_like(uv_f, float("nan")))
    return WarpMap(xy=xy.contiguous(), src_wh=tuple(src_wh))


def build_warp_map(cam: CubemapCamera, cube_w: int, cube_h: int) -> WarpMap:
    """Precompute the cubemap->fisheye reverse-query map (one-time)."""
    uv_f, valid = C.cubemap_to_fisheye(cam, _cross_grid(cube_w, cube_h,
                                                         cam.device))
    return warp_map_from_coords(uv_f, valid, (int(cam.fisheye_wh[0].item()),
                                              int(cam.fisheye_wh[1].item())))


def bilinear_operands(wm: WarpMap) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused gather operands of the JAX ``build_warp_map``: (Hc, Wc)
    int32 flat index of the top-left source texel and (Hc, Wc, 4) float32
    bilinear weights (00, 01, 10, 11), zero where the map is invalid."""
    W, H = wm.src_wh
    valid = wm.valid
    # invalid pixels sample (-1, -1), as camera.cubemap_to_fisheye marks them
    x = torch.nan_to_num(wm.xy[..., 0], nan=-1.0)
    y = torch.nan_to_num(wm.xy[..., 1], nan=-1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # the corner is clipped to the image while fx/fy keep the unclipped floor
    x0i = torch.clamp(x0.to(torch.int32), 0, W - 2)
    y0i = torch.clamp(y0.to(torch.int32), 0, H - 2)
    idx00 = y0i * W + x0i
    w = torch.stack(
        [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], dim=-1)
    w = torch.where(valid[..., None], w, torch.zeros_like(w))
    return idx00, w


def warp_bilinear(fisheye: torch.Tensor, wm: WarpMap) -> torch.Tensor:
    """Resample a grayscale fisheye image into the cubemap cross (bilinear).

    fisheye: (H, W) uint8/float; returns (Hc, Wc) float32 with 0 outside the
    cross/image. Plain version of kernel W.
    """
    flat = fisheye.reshape(-1).to(torch.float32)
    W = wm.src_wh[0]
    idx00, w = bilinear_operands(wm)
    i00 = idx00.long()
    g00 = flat[i00]
    g01 = flat[i00 + 1]
    g10 = flat[i00 + W]
    g11 = flat[i00 + W + 1]
    return (w[..., 0] * g00 + w[..., 1] * g01
            + w[..., 2] * g10 + w[..., 3] * g11)


def warp_nearest(fisheye: torch.Tensor, wm: WarpMap) -> torch.Tensor:
    """Nearest-neighbour variant: the corner with the largest weight."""
    flat = fisheye.reshape(-1).to(torch.float32)
    W = wm.src_wh[0]
    idx00, w = bilinear_operands(wm)
    pick = torch.argmax(w, dim=-1)
    off_choices = torch.tensor([0, 1, W, W + 1], dtype=torch.int64,
                               device=flat.device)
    out = flat[idx00.long() + off_choices[pick]]
    return torch.where(wm.valid, out, torch.zeros_like(out))


def fov_mask(cam: CubemapCamera, cube_w: int, cube_h: int) -> torch.Tensor:
    """(Hc,Wc) {0,1} float mask of cubemap pixels whose ray lies within the
    fisheye FOV cone: regions beyond fov/2 from the optical axis are never
    imaged and must not produce features."""
    ray, face = C.cubemap_to_ray(cam, _cross_grid(cube_w, cube_h,
                                                  cam.device))
    ok = (face != C.UNKNOWN_FACE) & (ray[..., 2] >= cam.cos_fov_th)
    return ok.to(torch.float32)


def extract_faces(cube: torch.Tensor, face_w: int, face_h: int
                  ) -> torch.Tensor:
    """Split the 3Wx3H cross into a (5, face_h, face_w) stack ordered by face
    id (FRONT, LEFT, RIGHT, UPPER, LOWER)."""
    fw, fh = face_w, face_h
    front = cube[fh:2 * fh, fw:2 * fw]
    left = cube[fh:2 * fh, 0:fw]
    right = cube[fh:2 * fh, 2 * fw:3 * fw]
    upper = cube[0:fh, fw:2 * fw]
    lower = cube[2 * fh:3 * fh, fw:2 * fw]
    return torch.stack([front, left, right, upper, lower])
