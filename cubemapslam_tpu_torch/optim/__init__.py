"""Nonlinear least squares in PyTorch (counterpart of
``cubemapslam_tpu.optim``): reprojection residuals, pose-only LM, the
bundle adjustment (dense Schur + Cholesky, or matrix-free Schur + CG), the
Sim3 refinement and the essential-graph pose graph."""

from cubemapslam_tpu_torch.optim.residuals import (  # noqa: F401
    project_to_face, reproj_residual, reproj_jacobians,
    eval_point, pose_jac_from_state,
)
from cubemapslam_tpu_torch.optim.pose_opt import pose_optimization  # noqa: F401
from cubemapslam_tpu_torch.optim.ba import BAProblem, bundle_adjust  # noqa: F401
