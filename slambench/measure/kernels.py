"""The work of the port's kernels at a configuration's shapes: the bytes a
launch must move and the operations it must do, as ``chip_smoke.py``
counts them for kernel W (``csrc/warp_remap.cu``) and kernel D
(``csrc/orb_detect.cu``), frozen here so that the count stays the same
whatever implements the stage. Counted from shapes alone, never from the
data: a faster implementation cannot lower its own bound."""

from __future__ import annotations

import math

# float operations per valid pixel of kernel W: 2 floors, 4 subtractions,
# 8 products and 3 sums (the u8 loads and their conversions not counted)
WARP_OPS_PER_PIXEL = 2 + 4 + 8 + 3
# float operations of kernel D at every pixel: the compass test (4
# differences, 6 min/max, 2 compares), the fallback merge (a compare and a
# select), the merged-zero test and one key compare
DETECT_OPS_PIXEL = 4 + 8 + 2 + 1 + 1
# candidates kept a cell and the bytes written for each (response, y, x,
# dy, dx)
PER_CELL = 4
CANDIDATE_BYTES = 20


def warp_work(fisheye_w: int, fisheye_h: int, face_w: int,
              valid_pixels: int):
    """(bytes, operations) of one launch of kernel W: the u8 frame read
    once, the (x, y) float32 map read and the float32 cross written for
    every cross pixel, and the arithmetic of every valid one."""
    n_pix = (3 * face_w) ** 2
    return (fisheye_w * fisheye_h + n_pix * (8 + 4),
            WARP_OPS_PER_PIXEL * valid_pixels)


def pyramid_shapes(face_w: int, n_levels: int, scale_factor: float):
    """(H, W) of each level of the cross's ORB pyramid."""
    n = 3 * face_w
    return [(int(round(n / scale_factor ** lv)),) * 2
            for lv in range(n_levels)]


def detect_work(face_w: int, n_levels: int, scale_factor: float,
                cell: int = 32):
    """(bytes, operations) of kernel D's two launches over a frame's
    pyramid: every level pixel read once (float32), the candidates of every
    cell written, and the arithmetic every pixel needs whatever it holds
    (what passes the compass test depends on the data and is not
    counted)."""
    levels = pyramid_shapes(face_w, n_levels, scale_factor)
    n_pix = sum(h * w for h, w in levels)
    cells = sum(math.ceil(h / cell) * math.ceil(w / cell) for h, w in levels)
    return 4 * n_pix + cells * PER_CELL * CANDIDATE_BYTES, \
        DETECT_OPS_PIXEL * n_pix
