"""Kernel W's share of its roofline: the least time an H100 needs for the
bytes and operations of one launch at the configuration's shapes
(``measure/kernels.py``), over its device time a launch in the trace."""

import torch

from slambench.measure import kernels as K
from slambench.measure import trace as TR
from slambench.measure.window import kernel_ms
from slambench.reference import camera as C


def read(tw):
    got = kernel_ms(tw, "warp_remap_kernel")
    if got is None:
        return None
    ms, launches = got
    cam = C.Camera.from_fields(tw.fields)
    valid = int(C.warp_coords(cam, torch.float64)[1].sum())
    nbytes, nops = K.warp_work(cam.fisheye_w, cam.fisheye_h, cam.face_w,
                               valid)
    return 100.0 * TR.bound(nbytes, nops)[0] / (ms / launches)
