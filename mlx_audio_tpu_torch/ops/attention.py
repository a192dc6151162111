"""Scaled dot-product attention: additive masks, GQA, cached decode.

Counterpart of `attention` and `decode_attention` in
mlx_audio_tpu/ops/attention.py (:43-106). Plain PyTorch: the JAX package
has no Pallas attention kernel. Grouped-query attention broadcasts each KV
head over its group of query heads without repeating K or V. Scores and
softmax run in float32; the probabilities are cast back to q's dtype before
the product with V, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, T, Hq, D), k (B, S, Hkv, D) -> f32 scores (B, Hq, T, S)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if hq == hkv:
        return torch.einsum("bthd,bshd->bhts", q, k).float()
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k)
    return s.reshape(b, hq, t, k.shape[1]).float()


def _weighted(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B, Hq, T, S), v (B, S, Hkv, D) -> (B, T, Hq, D)."""
    b, hq, t, s = probs.shape
    hkv = v.shape[2]
    if hq == hkv:
        return torch.einsum("bhts,bshd->bthd", probs, v)
    pg = probs.reshape(b, hkv, hq // hkv, t, s)
    o = torch.einsum("bhgts,bshd->bthgd", pg, v)
    return o.reshape(b, t, hq, v.shape[-1])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q (B, T, Hq, D); k, v (B, S, Hkv, D); mask additive, broadcastable to
    (B, Hq, T, S). Returns (B, T, Hq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = _scores(q * scale, k)
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _weighted(probs, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: Union[int, torch.Tensor],
                     scale: Optional[float] = None,
                     lengths_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One query step against a fixed-size cache.

    q (B, 1, Hq, D); k_cache, v_cache (B, max_len, Hkv, D); the first
    `length` entries (an int, or a (B,) tensor: one count per row) are
    valid, unless `lengths_mask` (B, max_len) bool names the valid entries
    of each row instead (continuous batching: each row attends to its own
    columns of a shared timeline). The whole buffer is read and the
    invalid entries masked, so the shapes do not change from step to
    step."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = _scores(q * scale, k_cache)
    if lengths_mask is not None:
        valid = lengths_mask[:, None, None, :]
    else:
        pos = torch.arange(k_cache.shape[1], device=q.device)
        if isinstance(length, torch.Tensor) and length.ndim == 1:
            valid = (pos[None, :] < length[:, None])[:, None, None, :]
        else:
            valid = pos < length
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _weighted(probs, v_cache)
