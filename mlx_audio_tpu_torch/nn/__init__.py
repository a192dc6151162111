"""Layer library of the port (counterpart of mlx_audio_tpu/nn).

Activations are channel-last (B, T, C) as in the JAX package; parameters
live in `nn.Module`s in PyTorch's layouts (see layers.py).
"""

from .layers import (
    BatchNorm,
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    Embedding,
    FpQuantizedLinear,
    GroupedLinear,
    Int8Linear,
    LayerNorm,
    Linear,
    QuantizedLinear,
    RMSNorm,
    StackedTable,
    conv1d,
    conv2d,
    conv_transpose1d,
    layer_norm,
    gelu,
    leaky_relu,
    linear,
    rms_norm,
)
from .recurrent import GRU, LSTM, BiLSTM, LSTMCell

__all__ = [
    "Linear", "QuantizedLinear", "Int8Linear", "FpQuantizedLinear",
    "Embedding", "StackedTable", "LayerNorm",
    "RMSNorm", "Conv1d", "Conv2d", "ConvTranspose1d", "BatchNorm", "BiLSTM",
    "LSTMCell", "LSTM", "GRU", "GroupedLinear",
    "linear", "layer_norm", "rms_norm", "conv1d", "conv2d", "conv_transpose1d",
    "leaky_relu", "gelu",
]
