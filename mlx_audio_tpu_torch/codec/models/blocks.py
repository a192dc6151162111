"""Shared codec blocks: the snake activation.

The port's copy of `snake`, `init_snake` and `apply_snake` of
mlx_audio_tpu/codec/models/blocks.py (:30-40), on channel-last (B, T, C)
tensors. This snake divides by alpha + 1e-9, which Kokoro's (fused into
kernel K1) does not.
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


__all__ = ["snake", "Snake", "apply_snake"]
