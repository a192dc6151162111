"""Rotary position embeddings: split-half and interleaved.

Counterpart of `rope_freqs`, `apply_rope`, `apply_rope_interleaved` and
`rope_freqs_llama3` in mlx_audio_tpu/ops/rope.py (:18-57, :87-125). Qwen3-TTS's interleaved MRoPE is plain RoPE here, because its
three position streams are equal for TTS (talker.py:8-11). `rope_cos_sin`
splits the angle tables out so a model computes them once per forward and
not once per layer; the numbers are the same. `rope_cis` does the same for
the interleaved layout, whose pairs (2j, 2j+1) rotate as one complex number
each.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Inverse frequencies (head_dim // 2,), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exps)


def rope_freqs_llama3(dim: int, theta: float, factor: float = 8.0,
                      low_freq_factor: float = 1.0,
                      high_freq_factor: float = 4.0,
                      original_max_position: int = 8192) -> torch.Tensor:
    """Llama-3 frequency scaling (HF rope_type="llama3"): wavelengths past
    original_max_position / low_freq_factor are divided by `factor`, those
    under original_max_position / high_freq_factor kept, and the band
    between interpolated. Computed in f64 with numpy as the JAX package
    does, returned (dim // 2,) f32."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    wavelen = 2 * np.pi / inv
    low_wl = original_max_position / low_freq_factor
    high_wl = original_max_position / high_freq_factor
    smooth = (original_max_position / wavelen - low_freq_factor) \
        / (high_freq_factor - low_freq_factor)
    smoothed = (1 - smooth) * inv / factor + smooth * inv
    out = np.where(wavelen < high_wl, inv,
                   np.where(wavelen > low_wl, inv / factor, smoothed))
    return torch.from_numpy(out.astype(np.float32))


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


def rope_cis(positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """positions (..., T) -> exp(i * angle) (..., T, 1, rot/2), complex64:
    the interleaved layout's table."""
    angles = positions[..., None].float() * inv_freq
    return torch.polar(torch.ones_like(angles), angles)[..., None, :]


def apply_rotary_interleaved(x: torch.Tensor, cis: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., T, H, D) by a `rope_cis` table: pair (2j, 2j+1) by
    angle j, i.e. (x1 cos - x2 sin, x2 cos + x1 sin); dimensions past
    2 * cis.shape[-1] pass through. f32 math, result in x's dtype."""
    rot = 2 * cis.shape[-1]
    xr = x[..., :rot].float().reshape(*x.shape[:-1], rot // 2, 2)
    out = torch.view_as_real(torch.view_as_complex(xr) * cis).flatten(-2)
    out = out.to(x.dtype)
    return out if rot == x.shape[-1] else torch.cat([out, x[..., rot:]], -1)


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           inv_freq: torch.Tensor) -> torch.Tensor:
    """Interleaved partial RoPE (GPT-J pairs): x (B, T, H, D), positions
    (T,) or (B, T), inv_freq (rot/2,)."""
    return apply_rotary_interleaved(x, rope_cis(positions, inv_freq))
