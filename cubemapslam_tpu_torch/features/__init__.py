"""ORB feature extraction in PyTorch (counterpart of
``cubemapslam_tpu.features``), with the detect and patch-gather kernels."""

from cubemapslam_tpu_torch.features.extractor import (  # noqa: F401
    OrbExtractor,
    OrbParams,
    Keypoints,
    extract_orb,
    build_extractor,
    plan_levels,
)
from cubemapslam_tpu_torch.features.pattern import orb_pattern  # noqa: F401
