"""cubemapslam_tpu_torch — the PyTorch/CUDA port of cubemapslam_tpu.

A second implementation of the monocular fisheye cubemap SLAM framework,
written in PyTorch for an NVIDIA H100. The JAX package ``cubemapslam_tpu``
beside it is the reference: every module here mirrors the JAX module of the
same name and is held against it by the ``tests/test_torch_*.py`` parity
tests. This package imports nothing of JAX and nothing of the JAX package.

Each TPU (Pallas) kernel of the JAX package has a hand-written CUDA C++
counterpart for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``_build.py``). Beside each kernel sits its plain PyTorch version, which
serves CPU tensors; on a CUDA tensor a wrapper launches its kernel or raises.

PROCESS-GLOBAL SIDE EFFECT: importing this package turns TF32 off for CUDA
matmuls and cuDNN convolutions and sets the float32 matmul precision to
'highest' (see below). This changes matmul numerics/perf for any OTHER
PyTorch code in the same process. Embedders who want TF32 elsewhere should
set those flags again after the import, around their own code.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry (point rotation, triangulation, normal equations) is chained
# and gated by pixel-level chi2 thresholds: with reduced-precision products
# the map decays within a few keyframes (the JAX package sets its default
# matmul precision to 'highest' for the same reason). Image-path products
# that tolerate quantization (pyramid, descriptor operator) opt into bf16
# operand rounding explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from cubemapslam_tpu_torch.config import SlamConfig, load_config  # noqa: F401,E402
from cubemapslam_tpu_torch.camera import CubemapCamera  # noqa: F401,E402
