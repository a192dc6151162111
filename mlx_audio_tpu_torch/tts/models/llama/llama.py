"""Shared llama-style transformer backbone (GQA, KV-cached).

Counterpart of mlx_audio_tpu/tts/models/llama/llama.py: `ModelConfig`
(:40-68), `_attn_block` and `_mlp` (:115-154), `llama_forward` (:157-203),
`logits_from_hidden`, `init_caches`, `decode_step` and the backbone `Model`
(:206-245). Parameter names are the JAX tree's (HF llama's):
`model.embed_tokens`, `model.layers.N.self_attn.q_proj`, `model.norm`,
`lm_head`. Qwen2 adds biases to q, k and v (`attention_bias`); RoPE is
split-half (`ops/rope.py`) unless `rope_interleaved`; RMSNorm runs in f32.

A config whose `rope_scaling` names `llama3` (Llama-3.x checkpoints:
Orpheus-3B, Sesame's backbones) rotates by `ops.rope.rope_freqs_llama3`
(`llama_inv_freq`). This departs from the JAX package, whose
`ModelConfig` has no `rope_scaling` field and rotates every model by the
plain frequencies; without `rope_scaling` the two agree.

`Model` takes `embed`, `final_norm` and `lm_head` switches, so a consumer
builds exactly the tree it holds: VibeVoice's lower text LM has no final
norm, its TTS LM no token table, and neither has a head.

The KV cache is the port's stacked `ops.kvcache.KVCache`, written in place
at a host-int `offset`. Attention against a cache reads it in the cache's
dtype: an f32 cache under a bf16 model (KugelAudio and VibeVoice keep f32
caches, as the JAX package does) attends in f32 and hands the layer's
dtype back to `o_proj`, where JAX promotes the rest of the residual stream
to f32 too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Embedding, Linear, RMSNorm
from ....ops.attention import attention, decode_attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import (apply_rotary, apply_rotary_interleaved, rope_cis,
                          rope_cos_sin, rope_freqs, rope_freqs_llama3)


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "llama"
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    intermediate_size: int = 8192
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    vocab_size: int = 128256
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 2048
    head_dim: Optional[int] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    model_path: str = ""
    # Granite-style scale hooks; the defaults are exact no-ops
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    # interleaved ("traditional") RoPE; False keeps HF split-half
    rope_interleaved: bool = False
    # HF's rope_scaling; {"rope_type": "llama3", ...} scales the frequencies
    rope_scaling: Optional[Dict] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def llama_inv_freq(cfg: ModelConfig) -> torch.Tensor:
    """The inverse RoPE frequencies (head_dim // 2,), f32: Llama-3's
    scaled ones where `rope_scaling` names llama3 (its `rope_type`, or the
    older `type`), else plain."""
    rs = cfg.rope_scaling or {}
    hd = cfg.resolved_head_dim
    if (rs.get("rope_type") or rs.get("type")) == "llama3":
        return rope_freqs_llama3(
            hd, cfg.rope_theta, factor=rs.get("factor", 8.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position=rs.get(
                "original_max_position_embeddings", 8192))
    return rope_freqs(hd, cfg.rope_theta)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.resolved_head_dim
        qkv_bias = cfg.attention_bias
        self.self_attn = holder(
            q_proj=Linear(d, cfg.num_attention_heads * hd, bias=qkv_bias),
            k_proj=Linear(d, cfg.num_key_value_heads * hd, bias=qkv_bias),
            v_proj=Linear(d, cfg.num_key_value_heads * hd, bias=qkv_bias),
            o_proj=Linear(cfg.num_attention_heads * hd, d, bias=False))
        self.mlp = holder(
            gate_proj=Linear(d, cfg.intermediate_size, bias=False),
            up_proj=Linear(d, cfg.intermediate_size, bias=False),
            down_proj=Linear(cfg.intermediate_size, d, bias=False))
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps)


class Model(TorchModel):
    """The llama LM (init_llama's tree) on `device`: the card by default;
    without CUDA the constructor raises unless given `device="cpu"`.
    `embed`, `final_norm` and `lm_head` leave out the token table, the
    final norm and the head (the head is also absent when the embeddings
    are tied)."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", *, embed: bool = True,
                 final_norm: bool = True, lm_head: bool = True):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        cfg = config
        with torch.device(device):
            parts = {"layers": nn.ModuleList(
                DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))}
            if embed:
                parts["embed_tokens"] = Embedding(cfg.vocab_size,
                                                  cfg.hidden_size)
            if final_norm:
                parts["norm"] = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.model = holder(**parts)
            if lm_head and not cfg.tie_word_embeddings:
                self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                      bias=False)
        self.register_buffer("inv_freq", llama_inv_freq(cfg).to(device),
                             persistent=False)
        self.requires_grad_(False)
        self.eval()

    def sanitize(self, weights):
        return {k: v for k, v in weights.items()
                if not k.endswith("rotary_emb.inv_freq")}


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> KVCache:
    """A stacked (layers, batch, max_len, kv heads, head dim) cache."""
    return KVCache.init(batch, max_len, cfg.num_key_value_heads,
                        cfg.resolved_head_dim, dtype, device,
                        n_layers=cfg.num_hidden_layers)


def _rotate(cfg: ModelConfig, positions: torch.Tensor, inv_freq):
    if cfg.rope_interleaved:
        cis = rope_cis(positions, inv_freq)
        return lambda x: apply_rotary_interleaved(x, cis)
    cos, sin = rope_cos_sin(positions, inv_freq)
    return lambda x: apply_rotary(x, cos, sin)


def _attend(cfg: ModelConfig, sa, x, rotate, cache: Optional[KVCache],
            offset: int, mask, causal: bool) -> torch.Tensor:
    """_attn_block (:115-148): a t == 1 step against a cache takes the
    boolean keep-mask `mask` (B, S) of decode_attention (None: the first
    offset + 1 columns); a longer t the causal window [0, offset + t) plus
    the additive `mask` (B, S); without a cache `mask` is additive,
    broadcast to (B, H, T, S) as given, and `causal` masks the future.
    Against a cache, q, k and v meet in the wider of their dtypes."""
    hd = cfg.resolved_head_dim
    b, t, _ = x.shape
    q = rotate(sa.q_proj(x).reshape(b, t, cfg.num_attention_heads, hd))
    k = rotate(sa.k_proj(x).reshape(b, t, cfg.num_key_value_heads, hd))
    v = sa.v_proj(x).reshape(b, t, cfg.num_key_value_heads, hd)
    scale = cfg.attention_multiplier
    if cache is None:
        add = mask
        if causal:
            keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            cm = torch.zeros(t, t, device=x.device).masked_fill(
                ~keep, float("-inf"))
            add = cm if add is None else add + cm
        out = attention(q, k, v, mask=add, scale=scale)
    else:
        kv_update(cache, k, v, offset)
        dt = torch.promote_types(q.dtype, cache.k.dtype)
        q, ck, cv = q.to(dt), cache.k.to(dt), cache.v.to(dt)
        if t == 1:
            out = decode_attention(q, ck, cv, offset + 1, scale=scale,
                                   lengths_mask=mask)
        else:
            s = cache.k.shape[1]
            pos_s = torch.arange(s, device=x.device)
            keep = ((pos_s[None, :] <= offset
                     + torch.arange(t, device=x.device)[:, None])
                    & (pos_s < offset + t)[None, :])
            add = torch.zeros(keep.shape, device=x.device).masked_fill(
                ~keep, float("-inf"))[None, None]
            if mask is not None:
                add = add + mask[:, None, None, :]
            out = attention(q, ck, cv, mask=add, scale=scale)
        out = out.to(x.dtype)
    return sa.o_proj(out.reshape(b, t, -1))


def llama_forward(lm: Model, tokens_or_embeds: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  caches: Optional[KVCache] = None, offset: int = 0,
                  mask: Optional[torch.Tensor] = None, causal: bool = True,
                  final_norm: bool = True
                  ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Forward the backbone: tokens (B, T) int or embeds (B, T, D) ->
    (hidden (B, T, D), caches). With `caches` (stacked, written in place
    at `offset`, a host int) it attends against the cache: a prefill for
    T > 1, a decode step for T == 1. `positions` (B, T) default to
    offset + arange(T)."""
    cfg = lm.config
    m = lm.model
    x = m.embed_tokens(tokens_or_embeds) if tokens_or_embeds.ndim == 2 \
        else tokens_or_embeds
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    t = x.shape[1]
    if positions is None:
        positions = offset + torch.arange(t, device=x.device)[None, :]
    rotate = _rotate(cfg, positions, lm.inv_freq)
    rm = cfg.residual_multiplier
    for i, layer in enumerate(m.layers):
        h = layer.input_layernorm(x)
        a = _attend(cfg, layer.self_attn, h, rotate,
                    None if caches is None else caches.layer(i), offset,
                    mask, causal)
        x = x + (a if rm == 1.0 else a * rm)
        h = layer.post_attention_layernorm(x)
        mp = layer.mlp
        f = mp.down_proj(F.silu(mp.gate_proj(h)) * mp.up_proj(h))
        x = x + (f if rm == 1.0 else f * rm)
    if final_norm:
        x = m.norm(x)
    return x, caches


def logits_from_hidden(lm: Model, hidden: torch.Tensor) -> torch.Tensor:
    """The head, or the tied token table; divided by logits_scaling."""
    if hasattr(lm, "lm_head"):
        lg = lm.lm_head(hidden)
    else:
        lg = hidden @ lm.model.embed_tokens.weight.to(hidden.dtype).T
    s = lm.config.logits_scaling
    return lg / s if s != 1.0 else lg


def decode_step(lm: Model, token: torch.Tensor, caches: KVCache,
                offset: int, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One AR step: token (B, 1) -> (logits (B, V), caches)."""
    hidden, caches = llama_forward(lm, token, caches=caches, offset=offset,
                                   mask=mask)
    return logits_from_hidden(lm, hidden)[:, -1], caches


__all__ = ["Model", "ModelConfig", "DecoderLayer", "llama_inv_freq",
           "llama_forward",
           "logits_from_hidden", "init_caches", "decode_step"]
