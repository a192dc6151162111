"""Compute ops of the port (counterpart of mlx_audio_tpu/ops).

`snake_conv` holds the port of the Pallas kernel `snake_conv_pallas` (K1,
csrc/snake_conv.cu) and `qmm` that of `qmm_pallas` (K2, csrc/qmm.cu), which
`quant.qmatmul` dispatches to; both are built on first use by `cuda_build`.
"""

from .attention import attention
from .interpolate import interpolate1d

__all__ = ["attention", "interpolate1d"]
