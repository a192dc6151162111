"""Shared codec blocks: the snake activation, the residual unit,
nearest-codebook search and the time pooling of multi-scale quantizers.

The port's copy of `snake`, `init_snake`, `apply_snake`,
`apply_residual_unit`, `vq_encode`, `avg_pool_time` and `repeat_time` of
mlx_audio_tpu/codec/models/blocks.py (:30-73, :76-103), on channel-last
(B, T, C) tensors, and the checkpoints' weight-norm fold
(`fold_torch_weight_norm`, the JAX package's nn/layers.py:207-240). This
snake divides by alpha + 1e-9, which Kokoro's (fused into kernel K1) does
not.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import Conv1d


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + (1 / (alpha + 1e-9)) sin^2(alpha x); alpha (C,), in x's dtype."""
    alpha = alpha.to(x.dtype)
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


class Snake(nn.Module):
    """The parameter holder of a snake (`{"alpha": (C,)}`, initialised to
    ones as init_snake)."""

    init_fill = {"alpha": 1.0}

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_snake(self, x)


def apply_snake(p: Snake, x: torch.Tensor) -> torch.Tensor:
    return snake(x, p.alpha.reshape(-1))


class ResidualUnit(nn.Module):
    """The parameter holder of a residual unit (init_residual_unit, :46-56):
    `block.0` snake, `block.1` a k-wide conv (grouped: depthwise in SNAC),
    `block.2` snake, `block.3` a 1x1 conv."""

    def __init__(self, dim: int, kernel: int = 7, groups: int = 1):
        super().__init__()
        self.block = nn.ModuleDict({
            "0": Snake(dim), "1": Conv1d(dim, dim, kernel, groups=groups),
            "2": Snake(dim), "3": Conv1d(dim, dim, 1)})


def apply_residual_unit(p: ResidualUnit, x: torch.Tensor,
                        dilation: int) -> torch.Tensor:
    """x + conv1x1(snake(conv_k,dil(snake(x)))), the k-wide conv padded to
    keep the length ((k - 1) * dil // 2 a side); x trimmed to the result's
    length where it is longer (:59-73). The conv's groups are the
    module's."""
    b = p.block
    conv = b["1"]
    pad = ((conv.weight.shape[-1] - 1) * dilation) // 2
    y = conv(apply_snake(b["0"], x), padding=pad, dilation=dilation)
    y = b["3"](apply_snake(b["2"], y))
    trim = (x.shape[-2] - y.shape[-2]) // 2
    if trim > 0:
        x = x[..., trim:-trim, :]
    return x + y


def vq_encode(latents: torch.Tensor, codebook: torch.Tensor,
              normalized: bool = True) -> torch.Tensor:
    """Nearest-codebook-entry indices: latents (B, T, D), codebook (N, D) ->
    int64 (B, T). `normalized` takes the cosine distance (both sides
    L2-normalised, + 1e-8), else the euclidean one. The distance is the
    JAX package's ||x||^2 - 2 x.c + ||c||^2 in f32, and argmin takes the
    first minimum, so ties break as there."""
    x, cb = latents.float(), codebook.float()
    if normalized:
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
        cb = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-8)
    dist = ((x ** 2).sum(-1, keepdim=True)
            - 2 * torch.einsum("btd,nd->btn", x, cb)
            + (cb ** 2).sum(-1)[None, None, :])
    return torch.argmin(dist, dim=-1)


def avg_pool_time(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, T, C) -> (B, T // stride, C): the mean of each `stride` steps
    (a trailing partial window dropped)."""
    b, t, c = x.shape
    t2 = t // stride
    return x[:, :t2 * stride].reshape(b, t2, stride, c).mean(dim=2)


def repeat_time(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, T, C) -> (B, T * stride, C), each step repeated `stride` times."""
    return torch.repeat_interleave(x, stride, dim=-2)


def fold_torch_weight_norm(weights: Dict) -> Dict:
    """Each `X.weight_g`/`X.weight_v` or `X.parametrizations.weight.
    original0/1` pair folded into `X.weight` (w = g v / ||v||, the norm
    over every axis but the first); other keys pass (the JAX package's
    nn/layers.py:207-240)."""
    from ...tts.models.kokoro.istftnet import fold_weight_norm

    out, consumed = {}, set()
    for k in weights:
        for v_suf, g_suf in ((".parametrizations.weight.original1",
                              ".parametrizations.weight.original0"),
                             (".weight_v", ".weight_g")):
            if k.endswith(v_suf):
                base = k[: -len(v_suf)]
                if base + g_suf in weights:
                    out[base + ".weight"] = fold_weight_norm(
                        weights[base + g_suf], weights[k])
                    consumed.update((k, base + g_suf))
    for k, w in weights.items():
        if k not in consumed:
            out.setdefault(k, w)
    return out


__all__ = ["fold_torch_weight_norm", "snake", "Snake", "apply_snake",
           "ResidualUnit", "apply_residual_unit", "vq_encode",
           "avg_pool_time", "repeat_time"]
