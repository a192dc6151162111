"""Fixed-capacity KV caches for autoregressive decoding.

Counterpart of `KVCache`, `kv_update`, `kv_update_rows`, `kv_update_row`,
`ring_update` and `ring_mask` in mlx_audio_tpu/ops/kvcache.py (:27-111).
The buffers are preallocated (B, max_len, n_kv_heads, head_dim) and, unlike
the JAX package's functional update, written in place: a decode step
allocates nothing for its cache. A stacked cache (leading layer axis) hands
each layer a view, so per-layer writes land in the one buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KVCache(NamedTuple):
    """k/v: (n_layers, B, max_len, n_kv_heads, head_dim), stacked over the
    layers; `layer(i)` is layer i's (B, max_len, n_kv_heads, head_dim)
    view."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def init(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
             dtype=torch.bfloat16, device=None, *,
             n_layers: int) -> "KVCache":
        shape = (n_layers, batch, max_len, n_kv_heads, head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))

    def layer(self, i: int) -> "KVCache":
        return KVCache(self.k[i], self.v[i])


def kv_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
              offset: int) -> KVCache:
    """Write k_new/v_new (B, S, H, D) at time `offset`, in place; returns
    the same cache."""
    s = k_new.shape[1]
    cache.k[:, offset:offset + s] = k_new
    cache.v[:, offset:offset + s] = v_new
    return cache


def kv_update_rows(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                   offsets: torch.Tensor) -> KVCache:
    """Write k_new/v_new (B, S, H, D) at per-row time offsets (B,), in
    place: one indexed write per tensor, with no read of the offsets on the
    host. Rows admitted at different steps decode through one batched
    streaming codec step, each at its own stream age."""
    b, s = k_new.shape[:2]
    idx = offsets.long()[:, None] + torch.arange(s, device=offsets.device)
    rows = torch.arange(b, device=offsets.device)[:, None]
    cache.k[rows, idx] = k_new.to(cache.k.dtype)
    cache.v[rows, idx] = v_new.to(cache.v.dtype)
    return cache


def kv_update_row(cache: KVCache, row: int, k_new: torch.Tensor,
                  v_new: torch.Tensor, offset: int) -> KVCache:
    """Write one batch row's new kv (..., S, H, D) at (row, offset), in
    place: the continuous-batching admission splices a prompt's prefill
    into a live batch. Works on a layer's cache (B, T, H, D) and on a
    stacked one (L, B, T, H, D) with k_new (L, S, H, D)."""
    s = k_new.shape[-3]
    cache.k[..., row, offset:offset + s, :, :] = k_new.to(cache.k.dtype)
    cache.v[..., row, offset:offset + s, :, :] = v_new.to(cache.v.dtype)
    return cache


def ring_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                offset: int) -> KVCache:
    """Ring-buffer write, in place: positions offset..offset+S-1 of
    k_new/v_new (B, S, H, D) land at slot pos % cap (S <= cap, so the slots
    are distinct). A sliding-window cache of fixed size for a session of
    any length; cap >= window + S, or this write evicts keys still inside
    an earlier query's window."""
    cap, s = cache.k.shape[1], k_new.shape[1]
    slots = (torch.arange(s, device=cache.k.device) + offset) % cap
    cache.k[:, slots] = k_new.to(cache.k.dtype)
    cache.v[:, slots] = v_new.to(cache.v.dtype)
    return cache


def ring_mask(cap: int, window: int, offset: int, n_valid: int, q_len: int,
              device=None) -> torch.Tensor:
    """Additive f32 (1, 1, q_len, cap) mask for ring-cache attention.

    Queries sit at absolute positions offset..offset+q_len-1; slot s holds
    the latest position congruent to s of the offset + n_valid written so
    far, or a negative one when none was (the division floors, as jnp's
    does). A key is visible iff it was written, is not after the query and
    lies inside the sliding window."""
    total = offset + n_valid
    s = torch.arange(cap, device=device)
    key_abs = s + torch.div(total - 1 - s, cap, rounding_mode="floor") * cap
    q_abs = offset + torch.arange(q_len, device=device)
    d = q_abs[:, None] - key_abs[None, :]
    allow = (d >= 0) & (d < window) & (key_abs >= 0)[None, :]
    return torch.zeros(allow.shape, device=device).masked_fill(
        ~allow, float("-inf"))[None, None]
