"""Runtime of the port: the per-frame tracking step (counterpart of the
steady-state frame of ``cubemapslam_tpu.runtime``)."""

from cubemapslam_tpu_torch.runtime.frame_step import (  # noqa: F401
    FrameTracker, resolve_device)
