"""ALBERT (PL-BERT) encoder for Kokoro.

Counterpart of mlx_audio_tpu/tts/models/kokoro/albert.py: the same layer
loop over shared layer-group parameters, as nn.Modules named after the JAX
tree (`bert.encoder.albert_layer_groups.0.albert_layers.0.attention.query`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....nn import Embedding, LayerNorm, Linear
from ....ops.attention import attention


@dataclass
class AlbertModelArgs(BaseModelArgs):
    num_hidden_layers: int
    num_attention_heads: int
    hidden_size: int
    intermediate_size: int
    max_position_embeddings: int
    model_type: str = "albert"
    embedding_size: int = 128
    inner_group_num: int = 1
    num_hidden_groups: int = 1
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    vocab_size: int = 30522
    dropout: float = 0.0


class _Attention(nn.Module):
    def __init__(self, h: int, eps: float):
        super().__init__()
        self.query = Linear(h, h)
        self.key = Linear(h, h)
        self.value = Linear(h, h)
        self.dense = Linear(h, h)
        self.LayerNorm = LayerNorm(h, eps)


class AlbertLayer(nn.Module):
    def __init__(self, cfg: AlbertModelArgs):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_attention_heads
        self.attention = _Attention(h, eps)
        self.ffn = Linear(h, cfg.intermediate_size)
        self.ffn_output = Linear(cfg.intermediate_size, h)
        self.full_layer_layer_norm = LayerNorm(h, eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        nh = self.num_heads
        a = self.attention
        q = a.query(x).reshape(b, t, nh, h // nh)
        k = a.key(x).reshape(b, t, nh, h // nh)
        v = a.value(x).reshape(b, t, nh, h // nh)
        attn = a.dense(attention(q, k, v, mask=mask).reshape(b, t, h))
        x = a.LayerNorm(x + attn)
        ff = self.ffn_output(F.gelu(self.ffn(x), approximate="none"))
        return self.full_layer_layer_norm(x + ff)


class _Embeddings(nn.Module):
    def __init__(self, cfg: AlbertModelArgs):
        super().__init__()
        e = cfg.embedding_size
        self.word_embeddings = Embedding(cfg.vocab_size, e)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, e)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, e)
        self.LayerNorm = LayerNorm(e, cfg.layer_norm_eps)


class _LayerGroup(nn.Module):
    def __init__(self, cfg: AlbertModelArgs):
        super().__init__()
        self.albert_layers = nn.ModuleList(
            AlbertLayer(cfg) for _ in range(cfg.inner_group_num))


class _Encoder(nn.Module):
    def __init__(self, cfg: AlbertModelArgs):
        super().__init__()
        self.embedding_hidden_mapping_in = Linear(cfg.embedding_size,
                                                  cfg.hidden_size)
        self.albert_layer_groups = nn.ModuleList(
            _LayerGroup(cfg) for _ in range(cfg.num_hidden_groups))


class Albert(nn.Module):
    def __init__(self, cfg: AlbertModelArgs):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        """input_ids (B, T) int; attention_mask (B, T) {0,1}.
        Returns (sequence_output (B, T, H), pooled (B, H))."""
        cfg = self.cfg
        t = input_ids.shape[1]
        emb = self.embeddings
        pos_ids = torch.arange(t, device=input_ids.device)[None, :]
        x = (emb.word_embeddings(input_ids)
             + emb.position_embeddings(pos_ids)
             + emb.token_type_embeddings(torch.zeros_like(input_ids)))
        x = emb.LayerNorm(x)
        mask = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        x = self.encoder.embedding_hidden_mapping_in(x)
        per_group = cfg.num_hidden_layers // cfg.num_hidden_groups
        for i in range(cfg.num_hidden_layers):
            group = self.encoder.albert_layer_groups[i // per_group]
            for layer in group.albert_layers:
                x = layer(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled
