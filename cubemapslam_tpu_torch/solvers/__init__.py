"""Geometric solvers (counterpart of ``cubemapslam_tpu.solvers``): two-ray
triangulation, Horn alignment, RANSAC sampling and the two-view essential
initialization; PnP (``solvers.pnp``) and Sim3 RANSAC (``solvers.sim3``)
are imported from their modules."""

from cubemapslam_tpu_torch.solvers.horn import horn_alignment  # noqa: F401
from cubemapslam_tpu_torch.solvers.sampling import (  # noqa: F401
    sample_minimal_sets)
from cubemapslam_tpu_torch.solvers.triangulate import (  # noqa: F401
    triangulate_rays)
from cubemapslam_tpu_torch.solvers.essential import (  # noqa: F401
    TwoViewResult, check_essential, check_rt, compute_e21, decompose_e,
    find_essential, initialize_two_view, reconstruct_e)
