"""Shared codec blocks: the snake activation and nearest-codebook search.

The port's copy of `snake`, `init_snake`, `apply_snake` and `vq_encode` of
mlx_audio_tpu/codec/models/blocks.py (:30-40, :76-92), on channel-last
(B, T, C) tensors. This snake divides by alpha + 1e-9, which Kokoro's
(fused into kernel K1) does not.
"""

from __future__ import annotations

import torch
from torch import nn


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


__all__ = ["snake", "Snake", "apply_snake", "vq_encode"]
