"""LFM2, the hybrid backbone of LFM2-Audio: gated short convolutions and
GQA attention.

Counterpart of mlx_audio_tpu/sts/models/lfm_audio/lfm2.py:

* `LFM2Config` (copied);
* `apply_swiglu` (:90), the `SwiGLU` module;
* the gated causal short conv (`_conv_gate` :193, `_conv_prefill` :199,
  `_conv_step` :214) with its tap cache of the last `conv_L_cache` - 1
  gated inputs;
* GQA attention with per-head Q/K RMSNorm and split-half RoPE
  (`_attn_prefill` :152, `_attn_step` :173);
* `make_lfm2_caches` (:138), `lfm2_forward` (:223) and the weight-tied
  head `lfm2_logits` (:270); `lfm2_embed` (:260) is the `embed_tokens`
  module.

The parameters are `nn.Module`s under the JAX tree's names (`layers.N.
{operator_norm, ffn_norm, feed_forward.{w1, w2, w3}, self_attn.{q_proj,
k_proj, v_proj, out_proj, q_layernorm, k_layernorm} | conv.{in_proj,
weight, out_proj[, bias]}}`, `embed_tokens`, `embedding_norm`); a conv
layer's taps `conv.weight` (K, D) are a raw leaf, no linear, so a
quantization leaves them dense.

The caches stay on the device and are written in place: the attention
layers' keys and values in one stacked `ops.kvcache.KVCache`, the conv
layers' taps in one (n_conv, B, K - 1, D) tensor. A prefill runs the
prompt's rows, unpadded, from position 0 (JAX pads to a bucket and masks
the tail: its valid rows are these); a step at offset `o` writes column
`o` and attends over columns 0..o only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....nn import Embedding, Linear, RMSNorm
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import apply_rope, rope_freqs


@dataclass
class LFM2Config(BaseModelArgs):
    model_type: str = "lfm2"
    vocab_size: int = 65536
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    norm_eps: float = 1e-5
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 128000
    conv_bias: bool = False
    conv_L_cache: int = 3
    block_multiple_of: int = 256
    block_ff_dim: int = 12288
    block_auto_adjust_ff_dim: bool = True
    full_attn_idxs: Optional[List[int]] = None
    layer_types: Optional[List[str]] = None

    def __post_init__(self):
        if self.layer_types is None:
            attn = set(self.full_attn_idxs
                       if self.full_attn_idxs is not None
                       else [2, 5, 8, 10, 12, 14])
            self.layer_types = [
                "full_attention" if i in attn else "conv"
                for i in range(self.num_hidden_layers)]

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ff_dim(self) -> int:
        ff = self.block_ff_dim
        if self.block_auto_adjust_ff_dim:
            ff = int(2 * ff / 3)
            m = self.block_multiple_of
            ff = m * math.ceil(ff / m)
        return ff


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = Linear(dim, hidden, bias=False)
        self.w2 = Linear(hidden, dim, bias=False)
        self.w3 = Linear(dim, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class QKNormAttention(nn.Module):
    """GQA projections with per-head RMS norms (LFM2's `self_attn` and the
    detokenizer's)."""

    def __init__(self, d: int, heads: int, kv_heads: int, head_dim: int,
                 eps: float):
        super().__init__()
        self.q_proj = Linear(d, heads * head_dim, bias=False)
        self.k_proj = Linear(d, kv_heads * head_dim, bias=False)
        self.v_proj = Linear(d, kv_heads * head_dim, bias=False)
        self.out_proj = Linear(heads * head_dim, d, bias=False)
        self.q_layernorm = RMSNorm(head_dim, eps)
        self.k_layernorm = RMSNorm(head_dim, eps)
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim

    def qkv(self, x: torch.Tensor, positions: torch.Tensor,
            inv_freq: torch.Tensor):
        """x (B, T, d) -> q (B, T, H, hd), k, v (B, T, KVH, hd), q and k
        normed and rotated to `positions` (T,)."""
        b, t, _ = x.shape
        q = self.q_layernorm(self.q_proj(x).view(b, t, self.heads,
                                                 self.head_dim))
        k = self.k_layernorm(self.k_proj(x).view(b, t, self.kv_heads,
                                                 self.head_dim))
        v = self.v_proj(x).view(b, t, self.kv_heads, self.head_dim)
        return (apply_rope(q, positions, inv_freq),
                apply_rope(k, positions, inv_freq), v)


class ShortConv(nn.Module):
    """The gated causal short conv: in_proj -> B * x -> depthwise taps over
    the last K inputs -> C * conv -> out_proj. `weight` (K, D) is the JAX
    leaf as it is."""

    def __init__(self, d: int, k: int, bias: bool):
        super().__init__()
        self.in_proj = Linear(d, 3 * d, bias=bias)
        self.weight = nn.Parameter(torch.empty(k, d))
        self.out_proj = Linear(d, d, bias=bias)
        self.bias = nn.Parameter(torch.empty(d)) if bias else None

    def gate(self, x: torch.Tensor):
        b_gate, c_gate, xp = self.in_proj(x).chunk(3, dim=-1)
        return b_gate * xp, c_gate

    def taps(self, window: torch.Tensor) -> torch.Tensor:
        """window (B, T + K - 1, D) -> (B, T, D): the causal depthwise conv
        (its bias added)."""
        k, t = self.weight.shape[0], window.shape[1] - self.weight.shape[0] + 1
        w = self.weight.to(window.dtype)
        out = sum(window[:, j: j + t] * w[j] for j in range(k))
        return out if self.bias is None else out + self.bias.to(out.dtype)

    def forward(self, x: torch.Tensor,
                cache: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, D) from position 0; with `cache` (B, K - 1, D), the
        last K - 1 gated inputs written there in place."""
        bx, c_gate = self.gate(x)
        k = self.weight.shape[0]
        pad = torch.cat([bx.new_zeros(bx.shape[0], k - 1, bx.shape[2]), bx],
                        dim=1)
        if cache is not None:
            cache.copy_(pad[:, pad.shape[1] - (k - 1):])
        return self.out_proj(c_gate * self.taps(pad))

    def step(self, x: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        """x (B, 1, D); rolls `cache` by one in place."""
        bx, c_gate = self.gate(x)
        window = torch.cat([cache.to(bx.dtype), bx], dim=1)
        cache.copy_(window[:, 1:])
        return self.out_proj(c_gate * self.taps(window))


class LFM2Layer(nn.Module):
    def __init__(self, c: LFM2Config, kind: str):
        super().__init__()
        d = c.hidden_size
        self.operator_norm = RMSNorm(d, c.norm_eps)
        self.ffn_norm = RMSNorm(d, c.norm_eps)
        self.feed_forward = SwiGLU(d, c.ff_dim)
        if kind == "full_attention":
            self.self_attn = QKNormAttention(
                d, c.num_attention_heads, c.num_key_value_heads, c.head_dim,
                c.norm_eps)
        else:
            self.conv = ShortConv(d, c.conv_L_cache, c.conv_bias)


class LFM2Caches(NamedTuple):
    """kv: the attention layers' KVCache (n_attn, B, cap, KVH, hd); conv:
    the conv layers' taps (n_conv, B, K - 1, D)."""

    kv: KVCache
    conv: torch.Tensor


class LFM2(nn.Module):
    def __init__(self, c: LFM2Config):
        super().__init__()
        self.config = c
        self.embed_tokens = Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(LFM2Layer(c, kind)
                                    for kind in c.layer_types)
        self.embedding_norm = RMSNorm(c.hidden_size, c.norm_eps)
        # layer i's slot among the attention layers or among the conv layers
        self.slots, counts = [], {"full_attention": 0, "conv": 0}
        for kind in c.layer_types:
            kind = kind if kind == "full_attention" else "conv"
            self.slots.append(counts[kind])
            counts[kind] += 1
        self.n_attn, self.n_conv = counts["full_attention"], counts["conv"]
        self.register_buffer("inv_freq", rope_freqs(c.head_dim, c.rope_theta),
                             persistent=False)


def _generator(p: torch.Tensor, seed: int, on_device: bool):
    dev = p.device if on_device else torch.device("cpu")
    return torch.Generator(device=dev).manual_seed(seed)


def _normal(p: torch.Tensor, gen: torch.Generator,
            on_device: bool) -> torch.Tensor:
    """N(0, 1) of p's shape from `gen`: on p's device in p's dtype, or on
    the CPU in f32 (TorchModel.init_params's two modes)."""
    if on_device:
        return torch.randn(p.shape, generator=gen, device=p.device,
                           dtype=p.dtype)
    return torch.randn(p.shape, generator=gen)


@torch.no_grad()
def init_short_convs(model: nn.Module, seed: int,
                     on_device: bool = False) -> None:
    """The short convs' taps drawn as the JAX package draws them, N(0, 1)
    / K, and their biases 0: leaves `TorchModel.init_params` does not
    know."""
    gen = None
    for m in model.modules():
        if isinstance(m, ShortConv):
            gen = gen or _generator(m.weight, seed + 2, on_device)
            m.weight.copy_(_normal(m.weight, gen, on_device)
                           / m.weight.shape[0])
            if m.bias is not None:
                m.bias.zero_()


def make_lfm2_caches(lfm: LFM2, batch: int, max_len: int,
                     dtype=torch.float32) -> LFM2Caches:
    c = lfm.config
    dev = lfm.embed_tokens.weight.device
    kv = KVCache.init(batch, max_len, c.num_key_value_heads, c.head_dim,
                      dtype, dev, n_layers=max(lfm.n_attn, 1))
    conv = torch.zeros(max(lfm.n_conv, 1), batch, c.conv_L_cache - 1,
                       c.hidden_size, dtype=dtype, device=dev)
    return LFM2Caches(kv, conv)


def _attn(p: QKNormAttention, x: torch.Tensor, cache: KVCache, offset: int,
          inv_freq: torch.Tensor) -> torch.Tensor:
    """Rows offset..offset+T-1 of x (B, T, D): keys and values written at
    those columns, causal attention over columns 0..offset+T-1."""
    b, t, _ = x.shape
    pos = torch.arange(offset, offset + t, device=x.device)
    q, k, v = p.qkv(x, pos, inv_freq)
    kv_update(cache, k.to(cache.k.dtype), v.to(cache.v.dtype), offset)
    end = offset + t
    mask = None
    if t > 1:
        mask = torch.full((t, end), float("-inf"), device=x.device)
        mask = torch.triu(mask, diagonal=offset + 1)
    out = attention(q, cache.k[:, :end].to(q.dtype),
                    cache.v[:, :end].to(q.dtype), mask=mask)
    return p.out_proj(out.reshape(b, t, -1))


def lfm2_forward(lfm: LFM2, emb: torch.Tensor, caches: LFM2Caches,
                 offset: int) -> torch.Tensor:
    """emb (B, T, D) -> hidden (B, T, D), the caches written in place. T > 1
    is a prefill at position 0 (`offset` 0); T == 1 a decode step at
    `offset`."""
    c = lfm.config
    x = emb
    is_step = emb.shape[1] == 1 and offset > 0
    for layer, kind, slot in zip(lfm.layers, c.layer_types, lfm.slots):
        h = layer.operator_norm(x)
        if kind == "full_attention":
            h = _attn(layer.self_attn, h, caches.kv.layer(slot), offset,
                      lfm.inv_freq)
        elif is_step:
            h = layer.conv.step(h, caches.conv[slot])
        else:
            h = layer.conv(h, caches.conv[slot])
        x = x + h
        x = x + layer.feed_forward(layer.ffn_norm(x))
    return lfm.embedding_norm(x)


def lfm2_logits(lfm: LFM2, hidden: torch.Tensor) -> torch.Tensor:
    """The weight-tied LM head, f32 logits."""
    return F.linear(hidden, lfm.embed_tokens.weight.to(hidden.dtype)).float()


__all__ = ["LFM2Config", "LFM2", "LFM2Caches", "SwiGLU", "QKNormAttention",
           "ShortConv", "init_short_convs", "make_lfm2_caches", "lfm2_forward",
           "lfm2_logits"]
