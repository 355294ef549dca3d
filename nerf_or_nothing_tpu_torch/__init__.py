"""nerf_or_nothing_tpu_torch — the MipNeRF renderer ported to PyTorch and
CUDA for one NVIDIA H100, beside the JAX/TPU package it is held against.

The render path (``run eval`` / ``run render``) runs each level as one
hand-written CUDA kernel (``csrc/render_level.cu``); see ROADMAP.md for
what is ported.
"""

__version__ = "0.1.0"

from nerf_or_nothing_tpu_torch.config import Config, DatasetType, RayShape
from nerf_or_nothing_tpu_torch.rays import Rays

__all__ = ["Config", "DatasetType", "RayShape", "Rays", "__version__"]
