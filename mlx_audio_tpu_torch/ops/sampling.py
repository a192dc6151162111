"""Token sampling: repetition penalty, top-k / min-p / top-p filtering,
and a categorical draw from an explicit generator.

Counterpart of `apply_repetition_penalty`, `top_k_top_p_filter` and
`make_sampler` in mlx_audio_tpu/ops/sampling.py (:20-110). The JAX package draws with
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
                       top_p: float = 1.0, min_p: float = 0.0,
                       min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Mask logits (B, V) outside top-k / min-p / nucleus top-p to -inf;
    with `min_tokens_to_keep` > 1 at least that many of the largest
    survive the p-filters."""
    neg = float("-inf")
    unfiltered = logits
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        logits = logits.masked_fill(probs < min_p * pmax, neg)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p      # the top-1 always survives
        threshold = torch.where(keep_sorted, sorted_logits,
                                torch.full_like(sorted_logits, float("inf"))
                                ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, neg)
    if min_tokens_to_keep > 1 and (min_p > 0.0 or top_p < 1.0):
        nth = torch.topk(unfiltered, min(min_tokens_to_keep,
                                         logits.shape[-1]),
                         dim=-1).values[..., -1:]
        logits = torch.where(unfiltered >= nth, unfiltered, logits)
    return logits


def sample(logits: torch.Tensor, temperature: float, top_k: int = 0,
           top_p: float = 1.0,
           generator: Optional[torch.Generator] = None, min_p: float = 0.0,
           min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Draw one token per row of logits (B, V) -> int64 (B,). Temperature 0
    is argmax; otherwise the top-k / min-p / top-p filtered softmax
    draw."""
    lg = logits.float()
    if temperature == 0.0:
        return lg.argmax(dim=-1)
    lg = top_k_top_p_filter(lg / temperature, top_k=top_k, top_p=top_p,
                            min_p=min_p,
                            min_tokens_to_keep=min_tokens_to_keep)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_sampler(temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 min_p: float = 0.0, repetition_penalty: float = 1.0,
                 min_tokens_to_keep: int = 1):
    """`sampler(logits, history=None, generator=None) -> int64 (B,)` over
    the fixed sampling knobs: the repetition penalty over `history` (B, H)
    (padded with -1), then `sample` (make_sampler, :75-98)."""

    def sampler(logits: torch.Tensor, history: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lg = logits.float()
        if history is not None:
            lg = apply_repetition_penalty(lg, history, repetition_penalty)
        return sample(lg, temperature, top_k=top_k, top_p=top_p,
                      generator=generator, min_p=min_p,
                      min_tokens_to_keep=min_tokens_to_keep)

    return sampler
