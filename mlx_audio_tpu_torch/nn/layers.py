"""Core layers on channel-last tensors (B, T, C).

Counterpart of mlx_audio_tpu/nn/layers.py. Activations keep the JAX
package's channel-last layout, so the port's public functions compare like
with like; parameters are held in PyTorch's own layouts:

  * Linear:           weight (out, in)
  * Conv1d:           weight (out, in/groups, width)       [torch Conv1d]
  * ConvTranspose1d:  weight (in, out/groups, width)       [torch ConvTranspose1d]
  * Conv2d:           weight (out, in/groups, kh, kw)       [torch Conv2d]
  * BatchNorm:        weight, bias (dim,); buffers running_mean and
                      running_var f32 (dim,)
  * GroupedLinear:    weight (groups, in/groups, out/groups), as in the
                      JAX tree
  * Embedding:        weight (vocab, dim)
  * QuantizedLinear:  buffers w_q uint8 (out, in), scales/biases f32
                      (out, in/gs); optional bias buffer (out,)
  * Int8Linear:       buffers w_i8 int8 (out, in), scale f32 (out,);
                      optional bias buffer (out,)
  * FpQuantizedLinear: buffers w_fp4 or w_fp8 uint8 (out, in), scales f32
                      (out, in/gs); optional bias buffer (out,)

The JAX package's layouts (WIO and HWIO convs, pre-flipped transposed-conv
kernels) are converted once, in `model.load_jax_params`. Conv2d is the one
layer called channel-first, on torch's (B, C, H, W): the FastConformer's
subsampling runs five of them in a row.

Parameters are cast to the activation's dtype at use, as the JAX layers do
(`params["weight"].astype(x.dtype)`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant

Padding = Union[int, Tuple[int, int]]


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as jax.nn.gelu(approximate=False)."""
    return F.gelu(x, approximate="none")


def _cast(p: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ weight (out, in)^T [+ bias] -> (..., out)."""
    return F.linear(x, weight.to(x.dtype), _cast(bias, x.dtype))


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalise over the last axis (biased variance, as apply_layer_norm)."""
    return F.layer_norm(x, (x.shape[-1],), _cast(weight, x.dtype),
                        _cast(bias, x.dtype), eps)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise the last axis in f32, cast back to x's dtype, then
    scale (apply_rms_norm, mlx_audio_tpu/nn/layers.py:117-124)."""
    xf = x.float()
    y = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)
    return y if weight is None else y * weight


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: Padding = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """1-D conv on (B, T, C_in) with a torch (O, I/g, W) kernel -> (B, T', O).

    `padding` is symmetric (int) or (left, right)."""
    left, right = (padding, padding) if isinstance(padding, int) else padding
    h = x.transpose(1, 2)
    if left or right:
        h = F.pad(h, (left, right))
    y = F.conv1d(h, weight.to(x.dtype), _cast(bias, x.dtype), stride=stride,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """2-D conv on (B, C_in, H, W) with a torch (O, I/g, kh, kw) kernel ->
    (B, O, H', W'); apply_conv2d (mlx_audio_tpu/nn/layers.py:304-317) on
    channel-first activations."""
    return F.conv2d(x, weight.to(x.dtype), _cast(bias, x.dtype),
                    stride=stride, padding=padding, groups=groups)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0,
                     groups: int = 1) -> torch.Tensor:
    """Transposed 1-D conv on (B, T, C_in) with a torch (I, O/g, W) kernel.

    Output length (T-1)*stride - 2*padding + W + output_padding."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight.to(x.dtype),
                           _cast(bias, x.dtype), stride=stride,
                           padding=padding, output_padding=output_padding,
                           groups=groups)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# Modules (parameter holders named after the JAX tree's leaves)
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class QuantizedLinear(nn.Module):
    """An affine group-quantized linear (quantize_weight's layout). The codes,
    their scales/biases and the optional f32 `bias` are buffers, so casting
    the model's parameters leaves them as K2 takes them; the forward is
    ops.quant.qmatmul, which on a CUDA tensor launches kernel K2."""

    def __init__(self, in_features: int, out_features: int,
                 group_size: int = 64, bias: bool = False):
        super().__init__()
        if in_features % group_size:
            raise ValueError(f"in_features {in_features} not a multiple of "
                             f"group size {group_size}")
        self.in_features = in_features
        self.group_size = group_size
        ng = in_features // group_size
        self.register_buffer("w_q", torch.zeros(out_features, in_features,
                                                dtype=torch.uint8))
        self.register_buffer("scales", torch.zeros(out_features, ng))
        self.register_buffer("biases", torch.zeros(out_features, ng))
        self.register_buffer("bias", torch.zeros(out_features) if bias
                             else None)

    @classmethod
    def from_params(cls, params) -> "QuantizedLinear":
        """A QuantizedLinear holding {w_q (out, in), scales, biases[, bias]}
        (quantize_weight's or unpack_mlx_quantized's layout) on their
        device, built there, with no dense weight or host copy in
        between."""
        w_q = params["w_q"]
        out_f, in_f = w_q.shape
        with torch.device(w_q.device):
            m = cls(in_f, out_f, in_f // params["scales"].shape[1],
                    bias=params.get("bias") is not None)
        for k in ("w_q", "scales", "biases", "bias"):
            if params.get(k) is not None:
                getattr(m, k).copy_(params[k])
        return m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant.qmatmul(x, self.w_q, self.scales, self.biases, self.bias)


class FpQuantizedLinear(nn.Module):
    """A microscaling fp linear (quantize_weight_fp's layout): E2M1 codes
    (`w_fp4`, mxfp4 and nvfp4) or E4M3 bytes (`w_fp8`, mxfp8) and their f32
    group scales, held as buffers. It stands where the JAX package's
    `apply_linear` sends a leaf with fp codes to `fp_matmul`
    (nn/layers.py:72-74)."""

    def __init__(self, in_features: int, out_features: int,
                 group_size: int, codes: str = "w_fp4", bias: bool = False):
        super().__init__()
        if codes not in ("w_fp4", "w_fp8"):
            raise ValueError(f"fp codes are w_fp4 or w_fp8, not {codes!r}")
        self.in_features = in_features
        self.codes = codes
        self.register_buffer(codes, torch.zeros(out_features, in_features,
                                                dtype=torch.uint8))
        self.register_buffer("scales", torch.zeros(
            out_features, in_features // group_size))
        self.register_buffer("bias", torch.zeros(out_features) if bias
                             else None)

    @classmethod
    def from_params(cls, params) -> "FpQuantizedLinear":
        """An FpQuantizedLinear holding {w_fp4 | w_fp8 (out, in), scales[,
        bias]} (quantize_weight_fp's layout) on their device."""
        codes = "w_fp4" if "w_fp4" in params else "w_fp8"
        out_f, in_f = params[codes].shape
        m = cls(in_f, out_f, in_f // params["scales"].shape[1], codes,
                bias=params.get("bias") is not None).to(params[codes].device)
        for k in (codes, "scales", "bias"):
            if params.get(k) is not None:
                getattr(m, k).copy_(params[k])
        return m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {self.codes: getattr(self, self.codes),
                  "scales": self.scales}
        if self.bias is not None:
            params["bias"] = self.bias
        return quant.fp_matmul(params, x)


class Int8Linear(nn.Module):
    """A W8A8 linear (to_i8_layout's layout): per-output-channel symmetric
    int8 codes and their f32 scales, held as buffers. It stands where the
    JAX package's `apply_linear` dispatches on "w_i8" (nn/layers.py:63-66);
    the forward is ops.quant.qmatmul_i8."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False):
        super().__init__()
        self.in_features = in_features
        self.register_buffer("w_i8", torch.zeros(out_features, in_features,
                                                 dtype=torch.int8))
        self.register_buffer("scale", torch.zeros(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias
                             else None)

    @classmethod
    def from_quantized(cls, q: QuantizedLinear) -> "Int8Linear":
        """The W8A8 form of an affine-quantized linear."""
        conv = quant.to_i8_layout({"w_q": q.w_q, "scales": q.scales,
                                   "biases": q.biases})
        m = cls(q.in_features, q.w_q.shape[0], bias=q.bias is not None)
        m = m.to(q.w_q.device)
        m.w_i8.copy_(conv["w_i8"])
        m.scale.copy_(conv["scale"])
        if q.bias is not None:
            m.bias.copy_(q.bias)
        return m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant.qmatmul_i8(x, self.w_i8, self.scale, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class StackedTable(nn.Module):
    """n stacked (vocab, dim) tables in one (n, vocab, dim) weight: the code
    predictor's per-group codec embeddings and heads, kept stacked as the
    JAX tree keeps them."""

    def __init__(self, n: int, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, vocab, dim))


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv1d(nn.Module):
    """Weights (O, I/g, W); called on channel-last (B, T, C)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, bias: bool = True,
                 groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor, stride: int = 1, padding: Padding = 0,
                dilation: int = 1) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, stride=stride,
                      padding=padding, dilation=dilation, groups=self.groups)


class ConvTranspose1d(nn.Module):
    """Weights (I, O/g, W), torch's own ConvTranspose1d layout."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, bias: bool = True,
                 groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch // groups, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor, stride: int = 1, padding: int = 0,
                output_padding: int = 0) -> torch.Tensor:
        return conv_transpose1d(x, self.weight, self.bias, stride=stride,
                                padding=padding,
                                output_padding=output_padding,
                                groups=self.groups)


class Conv2d(nn.Module):
    """Weights (O, I/g, kh, kw); called on channel-first (B, C, H, W). A
    kernel of one int is square."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Union[int, Tuple[int, int]], bias: bool = True,
                 groups: int = 1):
        super().__init__()
        self.groups = groups
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kh,
                                               kw))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, stride=stride,
                      padding=padding, groups=self.groups)


class GroupedLinear(nn.Module):
    """A grouped linear (DeepFilterNet's `GroupedLinearEinsum`): weight
    (groups, in/groups, out/groups); (..., in) -> (..., out), each group of
    inputs to its own group of outputs."""

    def __init__(self, in_features: int, out_features: int, groups: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            groups, in_features // groups, out_features // groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, ws, hs = self.weight.shape
        y = torch.einsum("...gi,gih->...gh", x.reshape(*x.shape[:-1], g, ws),
                         self.weight.to(x.dtype))
        return y.reshape(*x.shape[:-1], g * hs)


class BatchNorm(nn.Module):
    """Inference batch norm over the last axis from running statistics
    (apply_batch_norm, mlx_audio_tpu/codec/models/ecapa_tdnn/ecapa_tdnn.py:
    35-43). The statistics are f32 buffers, which `TorchModel.astype` leaves
    in f32; the norm runs in f32, as JAX's promotes against them, and returns
    x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ((x.float() - self.running_mean)
             * torch.rsqrt(self.running_var + self.eps)
             * self.weight.float() + self.bias.float())
        return y.to(x.dtype)
