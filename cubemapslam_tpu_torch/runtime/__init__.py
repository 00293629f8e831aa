"""Runtime of the port (counterpart of ``cubemapslam_tpu.runtime``): the
per-frame tracking step, the tracked frame against the map arena, local
mapping, and the system object ``CubemapSLAM`` that runs a sequence from its
first frame."""

from cubemapslam_tpu_torch.runtime.frame_step import (  # noqa: F401
    FrameTracker, resolve_device)
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM  # noqa: F401
