"""Fixed-capacity KV caches for autoregressive decoding.

Counterpart of `KVCache` and `kv_update` in mlx_audio_tpu/ops/kvcache.py
(:27-47). The buffers are preallocated (B, max_len, n_kv_heads, head_dim)
and, unlike the JAX package's functional update, written in place: a
decode step allocates nothing for its cache. A stacked cache (leading layer
axis) hands each layer a view, so per-layer writes land in the one buffer.
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
