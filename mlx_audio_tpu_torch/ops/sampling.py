"""Token sampling: repetition penalty, top-k / top-p filtering, and a
categorical draw from an explicit generator.

Counterpart of `apply_repetition_penalty` and `top_k_top_p_filter` in
mlx_audio_tpu/ops/sampling.py (:20-72). The JAX package draws with
`jax.random.categorical` from a key; here the draw takes a
`torch.Generator` on the logits' device, so a seed fixes the stream on one
device (the two packages' streams differ, so only greedy decoding is
compared between them). Nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Penalise logits (B, V) of tokens present in `history` (B, H), padded
    with -1."""
    if penalty == 1.0:
        return logits
    vocab = logits.shape[-1]
    hist = torch.where(history < 0, vocab, history).long()
    seen = torch.zeros(logits.shape[0], vocab + 1, dtype=torch.bool,
                       device=logits.device).scatter_(1, hist, True)[:, :vocab]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """Mask logits (B, V) outside top-k / nucleus top-p to -inf."""
    neg = float("-inf")
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p      # the top-1 always survives
        threshold = torch.where(keep_sorted, sorted_logits,
                                torch.full_like(sorted_logits, float("inf"))
                                ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, neg)
    return logits


def sample(logits: torch.Tensor, temperature: float, top_k: int = 0,
           top_p: float = 1.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Draw one token per row of logits (B, V) -> int64 (B,). Temperature 0
    is argmax; otherwise top-k/top-p filtered softmax sampling."""
    lg = logits.float()
    if temperature == 0.0:
        return lg.argmax(dim=-1)
    lg = top_k_top_p_filter(lg / temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
