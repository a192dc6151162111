"""The diffusion transformer (DiT) of SAM-Audio.

Counterpart of mlx_audio_tpu/sts/models/sam_audio/dit.py:
`TransformerConfig` (:37-70), `_rms_norm` (:73), the adjacent-pair RoPE
(`_rope_pairs` :79; theta = max(1e4, 2 max_positions), self-attention
only), SAM-Audio's strided head split (`_heads_sam` :93: (B, T, C) -> (B,
T, C/H, H) -> (B, H, T, C/H), which is not the usual view(B, T, H, D)),
`apply_projection` (:111), `_attention` (:191: q and k RMS-normed over the
head dim, keys masked by a padding mask), `_group_norm1` and
`_resnet_block` (:217-232, the `x_embedder`: GroupNorm(1) and k = 3 convs),
`_timestep_embedding` (:235), `dit_forward` (:244: the six-way AdaLN from
each layer's `scale_shift_table` plus `t_block`, an ungated
cross-attention on the `y_embedder` memory, the final scale and shift)
and `embed_anchors` (:301, tanh-gated). Parameter names are the JAX
tree's; every linear is the port's `Linear`, so a q8 model runs it on
kernel K2, while the tables and convs stay dense.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import holder
from ....nn import Conv1d, Embedding, LayerNorm, Linear, RMSNorm, rms_norm


@dataclass
class TransformerConfig(BaseModelArgs):
    dim: int = 2816
    n_heads: int = 22
    n_layers: int = 22
    norm_eps: float = 1e-5
    qk_norm: bool = True
    fc_bias: bool = False
    ffn_exp: int = 4
    ffn_dim_multiplier: float = 1
    multiple_of: int = 64
    non_linearity: str = "swiglu"
    use_rope: bool = True
    max_positions: int = 10000
    frequency_embedding_dim: int = 256
    timestep_non_linearity: str = "swiglu"
    t_block_non_linearity: str = "silu"
    t_block_bias: bool = True
    context_dim: int = 2816
    context_norm: bool = False
    out_channels: int = 256
    in_channels: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_hidden(self) -> int:
        hidden = int(self.ffn_exp * self.dim)
        if self.non_linearity == "swiglu":
            hidden = int(2 * hidden / 3)
        hidden = int(self.ffn_dim_multiplier * hidden)
        m = self.multiple_of
        return m * ((hidden + m - 1) // m)


class Projection(nn.Module):
    """{w1 (in -> out), w2 (out -> w2's out), w3 (in -> out) when gated}."""

    def __init__(self, in_dim: int, out_dim: int, swiglu: bool, bias: bool,
                 w2_out: Optional[int] = None):
        super().__init__()
        self.w1 = Linear(in_dim, out_dim, bias=bias)
        self.w2 = Linear(out_dim, out_dim if w2_out is None else w2_out,
                         bias=bias)
        if swiglu:
            self.w3 = Linear(in_dim, out_dim, bias=bias)


def apply_projection(p: Projection, x: torch.Tensor,
                     non_linearity: str) -> torch.Tensor:
    h1 = p.w1(x)
    if hasattr(p, "w3"):
        h = F.silu(h1) * p.w3(x)
    elif non_linearity == "silu":
        h = F.silu(h1)
    else:
        h = F.gelu(h1, approximate="tanh")
    return p.w2(h)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.dim
        self.wq, self.wk, self.wv, self.wo = (
            Linear(d, d, bias=cfg.fc_bias) for _ in range(4))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim)
            self.k_norm = RMSNorm(cfg.head_dim)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block1 = holder(groupnorm=LayerNorm(in_ch),
                             project=Conv1d(in_ch, out_ch, 3))
        self.block2 = holder(groupnorm=LayerNorm(out_ch),
                             project=Conv1d(out_ch, out_ch, 3))
        if in_ch != out_ch:
            self.to_out = Conv1d(in_ch, out_ch, 1)


class DiTLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.dim
        self.attention = Attention(cfg)
        self.cross_attention = Attention(cfg)
        self.feed_forward = Projection(d, cfg.ffn_hidden,
                                       cfg.non_linearity == "swiglu",
                                       cfg.fc_bias, w2_out=d)
        self.attention_norm = RMSNorm(d)
        self.ffn_norm = RMSNorm(d)
        self.scale_shift_table = nn.Parameter(torch.empty(6, d))


class DiT(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        swiglu_t = cfg.timestep_non_linearity == "swiglu"
        self.layers = nn.ModuleList(DiTLayer(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(d)
        self.output = Linear(d, cfg.out_channels, bias=cfg.fc_bias)
        self.x_embedder = holder(block=ResnetBlock(d, d))
        y = {"projection": Projection(cfg.context_dim, d, swiglu_t,
                                      cfg.fc_bias)}
        if cfg.context_norm:
            y["norm"] = RMSNorm(cfg.context_dim)
        self.y_embedder = holder(**y)
        self.t_embedder = holder(projection=Projection(
            cfg.frequency_embedding_dim, d, swiglu_t, cfg.fc_bias))
        self.t_block = Linear(d, 6 * d, bias=cfg.t_block_bias)
        self.final_layer_scale_shift_table = nn.Parameter(torch.empty(2, d))


# -- forward -----------------------------------------------------------------

def rope_tables(t: int, d: int, theta: float, device) -> tuple:
    """(cos, sin) (T, D/2) f32 of the adjacent-pair RoPE."""
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=device) * 2 / d))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope_pairs(x: torch.Tensor, tables: tuple) -> torch.Tensor:
    """Adjacent-pair RoPE on (B, H, T, D) with `rope_tables`' (cos, sin)
    for this T and D, in f32, cast back."""
    b, h, t, d = x.shape
    c, s = tables
    xr = x.reshape(b, h, t, d // 2, 2).float()
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(b, h, t, d).to(x.dtype)


def heads_sam(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """SAM-Audio's head split: (B, T, C) -> (B, T, C/H, H) -> (B, H, T,
    C/H); head h holds channels h, h + H, h + 2H, ..."""
    b, t, c = x.shape
    return x.reshape(b, t, c // n_heads, n_heads).permute(0, 3, 1, 2)


def attention(p: Attention, cfg: TransformerConfig, x: torch.Tensor,
              cross_x: Optional[torch.Tensor],
              key_padding_mask: Optional[torch.Tensor],
              rope: Optional[tuple]) -> torch.Tensor:
    """One attention block; `rope` the RoPE tables of x's length, applied
    to q and k (None: no RoPE, as in the cross-attention)."""
    b, t, _ = x.shape
    h = cfg.n_heads
    src = x if cross_x is None else cross_x
    q, k, v = heads_sam(p.wq(x), h), heads_sam(p.wk(src), h), \
        heads_sam(p.wv(src), h)
    if hasattr(p, "q_norm"):
        q = rms_norm(q, p.q_norm.weight, cfg.norm_eps)
        k = rms_norm(k, p.k_norm.weight, cfg.norm_eps)
    if rope is not None:
        q, k = rope_pairs(q, rope), rope_pairs(k, rope)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(cfg.head_dim)
    scores = scores.float()
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask[:, None, None, :],
                                    float("-inf"))
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v).transpose(1, 2).reshape(b, t, -1)
    return p.wo(o)


def group_norm1(p: LayerNorm, x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """num_groups = 1 GroupNorm on channel-last (B, T, C): the statistics
    over every step and channel of each row."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p.weight.to(x.dtype) \
        + p.bias.to(x.dtype)


def resnet_block(p: ResnetBlock, x: torch.Tensor) -> torch.Tensor:
    h = group_norm1(p.block1.groupnorm, x)
    h = p.block1.project(F.silu(h), padding=1)
    h = group_norm1(p.block2.groupnorm, h)
    h = p.block2.project(F.silu(h), padding=1)
    if hasattr(p, "to_out"):
        x = p.to_out(x)
    return h + x


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """(B,) -> (B, dim) f32 [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dit_forward(p: DiT, x: torch.Tensor, time: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None,
                memory_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """x (B, T, dim), time (B,) -> velocity (B, T, out_channels); masks are
    bool, True = a valid step."""
    cfg = p.cfg
    h = resnet_block(p.x_embedder.block, x)
    t_emb = apply_projection(
        p.t_embedder.projection,
        timestep_embedding(time, cfg.frequency_embedding_dim).to(x.dtype),
        cfg.timestep_non_linearity)
    t0 = p.t_block(F.silu(t_emb))
    y = None
    if memory is not None:
        ym = memory
        if hasattr(p.y_embedder, "norm"):
            ym = rms_norm(ym, p.y_embedder.norm.weight, cfg.norm_eps)
        y = apply_projection(p.y_embedder.projection, ym,
                             cfg.timestep_non_linearity)
    b = x.shape[0]
    rope = (rope_tables(x.shape[1], cfg.head_dim,
                        max(10000.0, 2.0 * cfg.max_positions), x.device)
            if cfg.use_rope else None)
    for lp in p.layers:
        biases = lp.scale_shift_table.to(x.dtype)[None] + t0.reshape(b, 6, -1)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            biases[:, j][:, None] for j in range(6))
        hn = rms_norm(h, lp.attention_norm.weight, cfg.norm_eps)
        hn = hn * (1 + scale_msa) + shift_msa
        h = h + attention(lp.attention, cfg, hn, None, padding_mask,
                          rope) * gate_msa
        if y is not None:
            h = h + attention(lp.cross_attention, cfg, h, y,
                              memory_padding_mask, None)
        hn = rms_norm(h, lp.ffn_norm.weight, cfg.norm_eps)
        hn = hn * (1 + scale_mlp) + shift_mlp
        h = h + apply_projection(lp.feed_forward, hn,
                                 cfg.non_linearity) * gate_mlp
    shift, scale = (p.final_layer_scale_shift_table.to(x.dtype)[None]
                    + t_emb[:, None]).chunk(2, dim=1)
    h = rms_norm(h, p.norm.weight, cfg.norm_eps)
    return p.output(h * (1 + scale) + shift)


# -- anchors -----------------------------------------------------------------

class EmbedAnchors(nn.Module):
    """{embed (num_anchors + 1, embed_dim), gate (1,), proj (no bias)}."""

    init_fill = {"gate": 0.0}

    def __init__(self, num_anchors: int, embed_dim: int, out_dim: int):
        super().__init__()
        self.embed = Embedding(num_anchors + 1, embed_dim)
        self.gate = nn.Parameter(torch.zeros(1))
        self.proj = Linear(embed_dim, out_dim, bias=False)


def embed_anchors(p: EmbedAnchors, x: torch.Tensor,
                  anchor_ids: Optional[torch.Tensor],
                  anchor_alignment: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, C) plus tanh(gate) proj(embed(anchor_ids[alignment]))."""
    if anchor_ids is None or anchor_alignment is None:
        return x
    gathered = torch.gather(anchor_ids.long(), 1, anchor_alignment.long())
    embs = p.embed(gathered).to(x.dtype)
    return x + torch.tanh(p.gate.to(x.dtype)) * p.proj(embs)


__all__ = ["TransformerConfig", "DiT", "dit_forward", "EmbedAnchors",
           "embed_anchors", "apply_projection", "heads_sam", "rope_pairs",
           "timestep_embedding", "resnet_block"]
