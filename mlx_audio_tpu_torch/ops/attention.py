"""Scaled dot-product attention with an additive mask.

Counterpart of `attention` in mlx_audio_tpu/ops/attention.py (:43-71),
restricted to what the slice uses (ALBERT: no GQA, no causal mask, no
soft-cap). Scores and softmax run in float32.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v (B, T, H, D); mask additive, broadcastable to (B, H, T, S).
    Returns (B, T, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q * scale, k).float()
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)
