"""Rotary position embeddings (split-half RoPE).

Counterpart of `rope_freqs` and `apply_rope` in mlx_audio_tpu/ops/rope.py
(:18-57). Qwen3-TTS's interleaved MRoPE is plain RoPE here, because its
three position streams are equal for TTS (talker.py:8-11). `rope_cos_sin`
splits the angle tables out so a model computes them once per forward and
not once per layer; the numbers are the same.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Inverse frequencies (head_dim // 2,), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor,
                 inv_freq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., T) -> cos, sin (..., T, 1, head_dim/2) in f32."""
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., T, H, D) by tables from `rope_cos_sin`; f32 math,
    result in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate q/k: x (..., T, H, D), positions (..., T)."""
    return apply_rotary(x, *rope_cos_sin(positions, inv_freq))
