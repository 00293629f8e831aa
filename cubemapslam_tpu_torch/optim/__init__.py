"""Nonlinear least squares in PyTorch (counterpart of
``cubemapslam_tpu.optim``): reprojection residuals and pose-only LM."""

from cubemapslam_tpu_torch.optim.residuals import (  # noqa: F401
    project_to_face, reproj_residual, reproj_jacobians,
    eval_point, pose_jac_from_state,
)
from cubemapslam_tpu_torch.optim.pose_opt import pose_optimization  # noqa: F401
