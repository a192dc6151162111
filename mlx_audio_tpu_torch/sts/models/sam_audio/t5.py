"""The T5 encoder that conditions SAM-Audio on its text description.

Counterpart of mlx_audio_tpu/sts/models/sam_audio/t5.py: `T5Config`, the
RMS layer norm without a mean (`_t5_layer_norm` :42), the bidirectional
relative-position buckets (`_relative_position_bucket` :87), `t5_encode`
(:103: layer 0's bias table shared by every layer, unscaled scores, padded
keys masked with -inf, a ReLU or gated FFN, a final norm) and
`sanitize_t5` (:160). Parameter names are the JAX tree's (HF T5's);
linears are the port's `Linear`, so a q8 model runs them on kernel K2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import holder
from ....nn import Embedding, Linear, RMSNorm, rms_norm


@dataclass
class T5Config(BaseModelArgs):
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = False
    dense_act_fn: str = "relu"


class SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.d_kv * cfg.num_heads
        self.q, self.k, self.v = (Linear(cfg.d_model, inner, bias=False)
                                  for _ in range(3))
        self.o = Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)


class DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.is_gated_act:
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False)


class T5Encoder(nn.Module):
    """{shared, encoder: {block.{i}.layer.{0: SelfAttention, layer_norm;
    1: DenseReluDense, layer_norm}, final_layer_norm}}."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = Embedding(cfg.vocab_size, cfg.d_model)
        blocks = nn.ModuleDict({str(i): holder(layer=nn.ModuleDict({
            "0": holder(SelfAttention=SelfAttention(cfg, i == 0),
                        layer_norm=RMSNorm(cfg.d_model)),
            "1": holder(DenseReluDense=DenseReluDense(cfg),
                        layer_norm=RMSNorm(cfg.d_model))}))
            for i in range(cfg.num_layers)})
        self.encoder = holder(block=blocks,
                              final_layer_norm=RMSNorm(cfg.d_model))


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 buckets of `rel_pos` (memory - query), int64."""
    num_buckets //= 2
    ret = (rel_pos > 0).long() * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    log_ratio = torch.log(n.float() / max_exact + 1e-6) \
        / math.log(max_distance / max_exact)
    large = max_exact + (log_ratio * (num_buckets - max_exact)).to(
        torch.int32).long()
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def t5_encode(p: T5Encoder, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L) token ids [and a (B, L) mask, nonzero = a token] -> (B, L,
    d_model) hidden states, in the model's dtype."""
    cfg = p.cfg
    x = p.shared(input_ids.long())
    b, length = input_ids.shape
    h, dk = cfg.num_heads, cfg.d_kv
    pos = torch.arange(length, device=x.device)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    blocks = p.encoder.block
    table = blocks["0"].layer["0"].SelfAttention.relative_attention_bias
    bias = table.weight.float()[buckets].permute(2, 0, 1)[None]
    if attention_mask is not None:
        bias = bias.masked_fill(attention_mask[:, None, None, :] <= 0,
                                float("-inf"))
    eps = cfg.layer_norm_epsilon
    for i in range(cfg.num_layers):
        lay = blocks[str(i)].layer
        a = lay["0"].SelfAttention
        hn = rms_norm(x, lay["0"].layer_norm.weight, eps)
        q, k, v = (f(hn).reshape(b, length, h, dk).transpose(1, 2)
                   for f in (a.q, a.k, a.v))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() + bias
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", w, v).transpose(1, 2).reshape(
            b, length, h * dk)
        x = x + a.o(o)
        f = lay["1"].DenseReluDense
        hn = rms_norm(x, lay["1"].layer_norm.weight, eps)
        if cfg.is_gated_act:
            g = f.wi_0(hn)
            g = (F.gelu(g, approximate="tanh")
                 if cfg.dense_act_fn.startswith("gelu") else F.relu(g))
            hidden = g * f.wi_1(hn)
        else:
            hidden = F.relu(f.wi(hn))
        x = x + f.wo(hidden)
    return rms_norm(x, p.encoder.final_layer_norm.weight, eps)


def sanitize_t5(weights: Dict, prefix: str = "text_encoder.") -> Dict:
    """HF T5 checkpoint names -> the tree's, under `prefix`: a leading
    `model.` dropped, the decoder's keys dropped, the encoder's
    `embed_tokens` taken as `shared`; keys without `prefix` are skipped."""
    out = {}
    for k, v in weights.items():
        if prefix:
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        k = k.replace("model.", "", 1) if k.startswith("model.") else k
        if "decoder" in k:
            continue
        if k == "encoder.embed_tokens.weight":
            k = "shared.weight"
        out[prefix + k] = np.asarray(v)
    return out


__all__ = ["T5Config", "T5Encoder", "t5_encode", "sanitize_t5",
           "relative_position_bucket"]
