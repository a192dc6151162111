"""Compute ops of the port (counterpart of mlx_audio_tpu/ops).

`snake_conv` holds the port of the Pallas kernel `snake_conv_pallas`;
its CUDA source is csrc/snake_conv.cu, built on first use by `cuda_build`.
"""

from .attention import attention
from .interpolate import interpolate1d

__all__ = ["attention", "interpolate1d"]
