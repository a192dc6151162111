"""Layer library of the port (counterpart of mlx_audio_tpu/nn).

Activations are channel-last (B, T, C) as in the JAX package; parameters
live in `nn.Module`s in PyTorch's layouts (see layers.py).
"""

from .layers import (
    Conv1d,
    ConvTranspose1d,
    Embedding,
    LayerNorm,
    Linear,
    conv1d,
    conv_transpose1d,
    layer_norm,
    leaky_relu,
    linear,
)
from .recurrent import BiLSTM

__all__ = [
    "Linear", "Embedding", "LayerNorm", "Conv1d", "ConvTranspose1d", "BiLSTM",
    "linear", "layer_norm", "conv1d", "conv_transpose1d", "leaky_relu",
]
