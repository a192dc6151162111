"""The GPT-2 stack of MOSS-TTS's v1.5 local head (and of MOSS-TTS-Nano).

Counterpart of mlx_audio_tpu/tts/models/moss_tts_nano/gpt2.py:
`GPT2Config` (:37, with the HF field names read by `from_dict`),
`gelu_new` (:76), the interleaved RoPE (:81: pairs (2j, 2j + 1) rotate
together, which `ops.rope.apply_rope_interleaved` computes), `init_gpt2`
with and without a token table (:97), `gpt2_forward` (:134: a fused
`c_attn`, `c_proj`, the MLP's `fc_in` and `fc_out`, pre-LayerNorms and
`ln_f`; RoPE or absolute positions) and `gpt2_make_caches` (:206). The
activation "gelu" is the tanh form, `jax.nn.gelu`'s default. The caches
are the port's stacked `KVCache`, written in place at a host-int offset;
attention against a cache runs in the wider of the query's and the
cache's dtypes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import check_device
from ....nn import Embedding, LayerNorm, Linear
from ....ops.attention import attention, decode_attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import apply_rope_interleaved, rope_freqs


@dataclass
class GPT2Config(BaseModelArgs):
    model_type: str = "gpt2"
    vocab_size: int = 16384
    n_positions: int = 32768
    n_ctx: int = 32768
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_inner: int = 3072
    activation_function: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    scale_attn_weights: bool = True
    scale_attn_by_inverse_layer_idx: bool = False
    position_embedding_type: str = "rope"
    rope_base: float = 10000.0
    pad_token_id: int = 3
    bos_token_id: int = 1
    eos_token_id: int = 2
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def from_dict(cls, params):
        params = dict(params or {})
        for hf, gpt in (("hidden_size", "n_embd"),
                        ("num_hidden_layers", "n_layer"),
                        ("num_attention_heads", "n_head"),
                        ("intermediate_size", "n_inner")):
            if hf in params and gpt not in params:
                params[gpt] = params[hf]
        return super().from_dict(params)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


class GPT2(nn.Module):
    """init_gpt2's tree: `h.N` (`ln_1`, `attn.c_attn`, `attn.c_proj`,
    `ln_2`, `mlp.fc_in`, `mlp.fc_out`), `ln_f`, and `wte` (with a token
    table) and `wpe` (absolute positions) where the config has them."""

    def __init__(self, cfg: GPT2Config, use_token_embedding: bool = True):
        super().__init__()
        self.cfg = cfg
        d, inner = cfg.n_embd, cfg.n_inner or 4 * cfg.n_embd
        eps = cfg.layer_norm_epsilon
        if use_token_embedding:
            self.wte = Embedding(cfg.vocab_size, d)
        if cfg.position_embedding_type.lower() == "absolute":
            self.wpe = Embedding(cfg.n_positions, d)
        self.h = nn.ModuleList(nn.ModuleDict(dict(
            ln_1=LayerNorm(d, eps),
            attn=nn.ModuleDict(dict(c_attn=Linear(d, 3 * d),
                                    c_proj=Linear(d, d))),
            ln_2=LayerNorm(d, eps),
            mlp=nn.ModuleDict(dict(fc_in=Linear(d, inner),
                                   fc_out=Linear(inner, d)))))
            for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(d, eps)
        self.register_buffer("inv_freq", rope_freqs(cfg.head_dim,
                                                    cfg.rope_base),
                             persistent=False)


def init_gpt2(cfg: GPT2Config, *, use_token_embedding: bool = True,
              device="cuda") -> GPT2:
    """An empty GPT-2 of `cfg` on `device` (the owner's `init_params` or a
    bind fills it)."""
    device = check_device(device)
    with torch.device(device):
        return GPT2(cfg, use_token_embedding).requires_grad_(False).eval()


def _act(cfg: GPT2Config, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation_function == "gelu_new":
        return gelu_new(x)
    if cfg.activation_function == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def gpt2_forward(p: GPT2, embeds: torch.Tensor, *,
                 caches: Optional[KVCache] = None, offset: int = 0,
                 pad_mask: Optional[torch.Tensor] = None,
                 length_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """embeds (B, T, D) -> (hidden (B, T, D) after `ln_f`, caches).

    caches: stacked per-layer caches written in place at the host int
    `offset` (a T = 1 step reads the offset + 1 columns written so far);
    None = full causal. pad_mask: additive (B/1, 1, T?, S) mask merged into
    the attention. length_mask: bool (B/1, 1, 1, S) or (S,) valid keys (no
    cache)."""
    cfg = p.cfg
    b, t, _ = embeds.shape
    x = embeds
    dev = x.device
    rope = cfg.position_embedding_type.lower() == "rope"
    pos = offset + torch.arange(t, device=dev)
    if not rope and hasattr(p, "wpe"):
        x = x + p.wpe(pos)[None].to(x.dtype)
    hd = cfg.head_dim
    scale0 = hd ** -0.5 if cfg.scale_attn_weights else 1.0
    for i, lp in enumerate(p.h):
        h = lp["ln_1"](x)
        q, k, v = lp["attn"]["c_attn"](h).chunk(3, dim=-1)
        q = q.reshape(b, t, cfg.n_head, hd)
        k = k.reshape(b, t, cfg.n_head, hd)
        v = v.reshape(b, t, cfg.n_head, hd)
        if rope:
            q = apply_rope_interleaved(q, pos, p.inv_freq)
            k = apply_rope_interleaved(k, pos, p.inv_freq)
        scale = scale0 / float(i + 1) \
            if cfg.scale_attn_by_inverse_layer_idx else scale0
        if caches is not None:
            cache = caches.layer(i)
            kv_update(cache, k, v, offset)
            dt = torch.promote_types(q.dtype, cache.k.dtype)
            q, ck, cv = q.to(dt), cache.k.to(dt), cache.v.to(dt)
            if t == 1:
                o = decode_attention(q, ck, cv, offset + 1, scale=scale)
            else:
                s = cache.k.shape[1]
                pos_s = torch.arange(s, device=dev)
                ok = (pos_s[None, :] <= pos[:, None]) & \
                    (pos_s < offset + t)[None, :]
                add = torch.zeros(ok.shape, device=dev).masked_fill(
                    ~ok, float("-inf"))[None, None]
                if pad_mask is not None:
                    add = add + pad_mask
                o = attention(q, ck, cv, mask=add, scale=scale)
            o = o.to(x.dtype)
        else:
            keep = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
            add = torch.zeros(t, t, device=dev).masked_fill(
                ~keep, float("-inf"))
            if length_mask is not None:
                lm = length_mask
                if lm.ndim == 1:
                    lm = lm[None, None, None, :]
                add = add + torch.zeros(lm.shape, device=dev).masked_fill(
                    ~lm, float("-inf"))
            if pad_mask is not None:
                add = add + pad_mask
            o = attention(q, k, v, mask=add, scale=scale)
        x = x + lp["attn"]["c_proj"](o.reshape(b, t, -1))
        h = lp["ln_2"](x)
        x = x + lp["mlp"]["fc_out"](_act(cfg, lp["mlp"]["fc_in"](h)))
    return p.ln_f(x), caches


def gpt2_make_caches(cfg: GPT2Config, batch: int, max_len: int,
                     dtype=torch.float32, device=None) -> KVCache:
    """Stacked (n_layer, batch, max_len, n_head, head_dim) caches."""
    return KVCache.init(batch, max_len, cfg.n_head, cfg.head_dim, dtype,
                        device, n_layers=cfg.n_layer)


__all__ = ["GPT2Config", "GPT2", "init_gpt2", "gpt2_forward",
           "gpt2_make_caches", "gelu_new"]
