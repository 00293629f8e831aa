"""rBRIEF sampling pattern.

The reference uses ORB-SLAM2's learned 256-pair pattern
(``bit_pattern_31_``, ORBExtractor.cpp:121-379). This framework instead
generates its own deterministic pattern — 256 coordinate pairs drawn from the
isotropic Gaussian BRIEF prescription (sigma = patch/5, clipped to the patch)
with a fixed seed. Descriptors only need to be self-consistent within the
framework (the BoW vocabulary is trained on them too), not bit-compatible with
OpenCV.
"""

from __future__ import annotations

import numpy as np

PATCH_RADIUS = 13          # max |coordinate| of a pattern point
N_PAIRS = 256              # 256-bit descriptors (8 x uint32)
_SEED = 20180510           # fixed for reproducibility


def orb_pattern() -> np.ndarray:
    """Return (256, 4) int32 array of (x1, y1, x2, y2) sample offsets.

    Gaussian BRIEF: both points ~ N(0, (patch/5)^2), clipped to
    [-PATCH_RADIUS, PATCH_RADIUS], deduplicated against degenerate pairs.
    """
    rs = np.random.RandomState(_SEED)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pairs = []
    while len(pairs) < N_PAIRS:
        p = np.clip(np.round(rs.normal(0.0, sigma, size=4)),
                    -PATCH_RADIUS, PATCH_RADIUS).astype(np.int32)
        if p[0] == p[2] and p[1] == p[3]:
            continue
        pairs.append(p)
    return np.stack(pairs)
