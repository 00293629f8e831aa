"""The benchmark of cubemapslam_tpu_torch (see run.py)."""
