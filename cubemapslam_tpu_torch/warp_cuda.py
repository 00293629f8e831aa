"""Kernel W: the fisheye -> cubemap-cross warp on the card.

Counterpart of ``cubemapslam_tpu/warp_tpu.py``. The TPU pair ``_h_kernel`` /
``_x_kernel`` plus the cross assembly of the steady-state frame program
become one exact bilinear remap kernel (``csrc/warp_remap.cu``) that reads
the map's source coordinates and writes straight into the cubemap cross.
Its plain version is ``warp.warp_bilinear``; see the source for what bounds
it.
"""

from __future__ import annotations

import ctypes

import torch

from cubemapslam_tpu_torch._build import CudaKernel, require_cuda
from cubemapslam_tpu_torch.warp import WarpMap, warp_bilinear

_P, _I = ctypes.c_void_p, ctypes.c_int

WARP_REMAP = CudaKernel("warp_remap.cu", "warp_remap_launch",
                        [_P, _P, _P, _I, _I, _I])


def warp_to_cross(fisheye: torch.Tensor, wm: WarpMap) -> torch.Tensor:
    """(H, W) uint8 fisheye -> (Hc, Wc) float32 cubemap cross, 0 outside the
    five faces and the fisheye image.

    A CPU tensor takes the plain version (``warp.warp_bilinear``); a CUDA
    tensor launches kernel W.
    """
    W, H = wm.src_wh
    if fisheye.shape != (H, W) or fisheye.dtype != torch.uint8:
        raise ValueError(f"fisheye must be ({H}, {W}) uint8, got "
                         f"{tuple(fisheye.shape)} {fisheye.dtype}")
    if fisheye.device.type == "cpu":
        return warp_bilinear(fisheye, wm)
    fisheye = fisheye.contiguous()
    require_cuda("warp_to_cross", fisheye, wm.xy)
    if wm.xy.dtype != torch.float32 or wm.xy.dim() != 3 \
            or wm.xy.shape[-1] != 2:
        raise ValueError("warp map must hold (Hc, Wc, 2) float32 xy")
    out = torch.empty(wm.xy.shape[:2], dtype=torch.float32,
                      device=fisheye.device)
    WARP_REMAP(fisheye.data_ptr(), wm.xy.data_ptr(), out.data_ptr(),
               out.numel(), W, H)
    return out
