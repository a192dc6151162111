"""FastConformer encoder: relative-position attention and conv modules.

Counterpart of mlx_audio_tpu/stt/models/parakeet/conformer.py, the encoder
that Parakeet, Canary and Cohere ASR share:

* `ConformerArgs` and the host table `rel_pos_encoding` (:35-60), copied;
* `_rel_shift` (:63-69), the Transformer-XL shift;
* the parameter tree as `nn.Module`s named after the JAX leaves
  (`pre_encode.{layers.00_conv, layers.01_dw, layers.02_pw, ..., out}`,
  `layers.N.{norm_feed_forward1, feed_forward1.{linear1, linear2},
  norm_self_att, self_attn.{linear_q, linear_k, linear_v, linear_out,
  linear_pos, pos_bias_u, pos_bias_v}, norm_conv, conv.{pointwise_conv1,
  depthwise_conv, batch_norm, pointwise_conv2}, norm_feed_forward2,
  feed_forward2, norm_out}`), so `model.load_jax_params` fills it;
* `rel_pos_attention` (:122-142), `conformer_block` (:145-165): macaron
  FFs at 0.5, then pointwise -> GLU -> depthwise -> BatchNorm -> SiLU ->
  pointwise; `subsample` (:194-209), `subsampled_length` (:221-228) and
  `conformer_forward` with `lengths` (:231-253).

The dw-striding subsampling runs channel-first (B, C, T', F') with H =
time and W = mel, where JAX runs NHWC; it permutes to (B, T', F', C)
before the flatten, so the `out` linear sees JAX's (F', C) order, C
fastest. A pointwise conv (width 1) runs as the linear it is.

Departure: a row with no valid frame (length 0) attends over all its
frames, so its softmax has a key. JAX's mask leaves it none, and the row
comes out NaN; here it is finite, and zeroed after each block as every
padded frame is. Valid rows never read a pad key, so they are JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....nn import BatchNorm, Conv1d, Conv2d, LayerNorm, Linear, linear


@dataclass
class ConformerArgs:
    feat_in: int = 80
    n_layers: int = 16
    d_model: int = 512
    n_heads: int = 8
    ff_expansion_factor: int = 4
    subsampling_factor: int = 8
    self_attention_model: str = "rel_pos"
    subsampling: str = "dw_striding"
    conv_kernel_size: int = 9
    subsampling_conv_channels: int = 256
    pos_emb_max_len: int = 5000
    causal_downsampling: bool = False
    use_bias: bool = True
    xscaling: bool = False
    subsampling_conv_chunking_factor: int = 1


def rel_pos_encoding(length: int, d_model: int) -> np.ndarray:
    """Transformer-XL relative positions [+L-1 ... 0 ... -L+1] -> sinusoids."""
    positions = np.arange(length - 1, -length, -1, dtype=np.float64)
    inv = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((len(positions), d_model), np.float32)
    pe[:, 0::2] = np.sin(positions[:, None] * inv)
    pe[:, 1::2] = np.cos(positions[:, None] * inv)
    return pe


@lru_cache(maxsize=8)
def _pos_table(length: int, d_model: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """rel_pos_encoding on `device` in `dtype`, copied there once."""
    return torch.from_numpy(rel_pos_encoding(length, d_model)).to(device,
                                                                  dtype)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL shift."""
    b, h, t, n = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, n + 1, t)
    return x[:, :, 1:].reshape(b, h, t, n)[..., : (n + 1) // 2]


def _n_stages(a: ConformerArgs) -> int:
    return int(math.log2(a.subsampling_factor))


def subsampled_length(a: ConformerArgs, n):
    """Mel frames -> encoder frames for the dw_striding stack (an int or
    a tensor)."""
    for _ in range({8: 3, 4: 2, 2: 1}.get(a.subsampling_factor, 3)):
        n = (n - 1) // 2 + 1
    return n


# -------------------------------------------------------- parameter tree

class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int, bias: bool):
        super().__init__()
        self.linear1 = Linear(d, hidden, bias=bias)
        self.linear2 = Linear(hidden, d, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.silu(self.linear1(x)))


class RelPositionAttention(nn.Module):
    init_fill = {"pos_bias_u": 0.0, "pos_bias_v": 0.0}

    def __init__(self, d: int, n_heads: int, bias: bool):
        super().__init__()
        self.linear_q = Linear(d, d, bias=bias)
        self.linear_k = Linear(d, d, bias=bias)
        self.linear_v = Linear(d, d, bias=bias)
        self.linear_out = Linear(d, d, bias=bias)
        self.linear_pos = Linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_heads, d // n_heads))
        self.pos_bias_v = nn.Parameter(torch.empty(n_heads, d // n_heads))


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int, bias: bool):
        super().__init__()
        self.pointwise_conv1 = Conv1d(d, 2 * d, 1, bias=bias)
        self.depthwise_conv = Conv1d(d, d, kernel, bias=bias, groups=d)
        self.batch_norm = BatchNorm(d)
        self.pointwise_conv2 = Conv1d(d, d, 1, bias=bias)


class ConformerBlock(nn.Module):
    def __init__(self, a: ConformerArgs):
        super().__init__()
        d, ffd = a.d_model, a.d_model * a.ff_expansion_factor
        self.norm_feed_forward1 = LayerNorm(d)
        self.feed_forward1 = FeedForward(d, ffd, a.use_bias)
        self.norm_self_att = LayerNorm(d)
        self.self_attn = RelPositionAttention(d, a.n_heads, a.use_bias)
        self.norm_conv = LayerNorm(d)
        self.conv = ConvModule(d, a.conv_kernel_size, a.use_bias)
        self.norm_feed_forward2 = LayerNorm(d)
        self.feed_forward2 = FeedForward(d, ffd, a.use_bias)
        self.norm_out = LayerNorm(d)


class Subsampling(nn.Module):
    """The dw-striding stack: a 3x3 stride-2 conv, then per further stage a
    depthwise 3x3 stride-2 conv and a pointwise conv; then `out` over the
    flattened (F', C)."""

    def __init__(self, a: ConformerArgs):
        super().__init__()
        ch = a.subsampling_conv_channels
        layers = {"00_conv": Conv2d(1, ch, 3)}
        for stage in range(1, _n_stages(a)):
            layers[f"{2 * stage - 1:02d}_dw"] = Conv2d(ch, ch, 3, groups=ch)
            layers[f"{2 * stage:02d}_pw"] = Conv2d(ch, ch, 1)
        self.layers = nn.ModuleDict(layers)
        f_out = a.feat_in
        for _ in range(_n_stages(a)):
            f_out = (f_out - 1) // 2 + 1
        self.out = Linear(ch * f_out, a.d_model)


class Conformer(nn.Module):
    def __init__(self, a: ConformerArgs):
        super().__init__()
        self.pre_encode = Subsampling(a)
        self.layers = nn.ModuleList(ConformerBlock(a)
                                    for _ in range(a.n_layers))


# --------------------------------------------------------------- forward

def subsample(sub: Subsampling, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, F) -> (B, T', d_model) through the strided conv stack."""
    x = mel[:, None]                                    # (B, 1, T, F)
    for key, conv in sub.layers.items():
        if key.endswith("_conv"):
            x = F.relu(conv(x, stride=2, padding=1))
        elif key.endswith("_dw"):
            x = conv(x, stride=2, padding=1)
        else:
            x = F.relu(conv(x))
    b, c, t, f = x.shape
    return sub.out(x.permute(0, 2, 3, 1).reshape(b, t, f * c))


def rel_pos_attention(attn: RelPositionAttention, a: ConformerArgs,
                      x: torch.Tensor, pos_emb: torch.Tensor,
                      allow: Optional[torch.Tensor]) -> torch.Tensor:
    """Self-attention over (B, T, d) with Transformer-XL relative positions
    (`pos_emb` (2T-1, d)); `allow` (B, 1, 1, T) bool names the keys a row
    may read. Scores and softmax in f32."""
    b, t, d = x.shape
    h, hd = a.n_heads, d // a.n_heads
    q = attn.linear_q(x).view(b, t, h, hd)
    k = attn.linear_k(x).view(b, t, h, hd)
    v = attn.linear_v(x).view(b, t, h, hd)
    pos = attn.linear_pos(pos_emb).view(-1, h, hd)      # (2T-1, H, hd)
    ac = torch.einsum("bthd,bshd->bhts",
                      q + attn.pos_bias_u.to(x.dtype), k)
    bd = _rel_shift(torch.einsum("bthd,phd->bhtp",
                                 q + attn.pos_bias_v.to(x.dtype), pos))
    scores = (ac.float() + bd.float()) / math.sqrt(hd)
    if allow is not None:
        scores = scores.masked_fill(~allow, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, d)
    return attn.linear_out(out)


def _pointwise(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    return linear(x, conv.weight[:, :, 0], conv.bias)


def conformer_block(blk: ConformerBlock, a: ConformerArgs, x: torch.Tensor,
                    pos_emb: torch.Tensor,
                    allow: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = x + 0.5 * blk.feed_forward1(blk.norm_feed_forward1(x))
    x = x + rel_pos_attention(blk.self_attn, a, blk.norm_self_att(x),
                              pos_emb, allow)
    c = blk.conv
    h = F.glu(_pointwise(c.pointwise_conv1, blk.norm_conv(x)), dim=-1)
    h = c.depthwise_conv(h, padding=(a.conv_kernel_size - 1) // 2)
    h = F.silu(c.batch_norm(h))
    x = x + _pointwise(c.pointwise_conv2, h)
    x = x + 0.5 * blk.feed_forward2(blk.norm_feed_forward2(x))
    return blk.norm_out(x)


def conformer_forward(enc: Conformer, a: ConformerArgs, mel: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, T, F) -> (B, T/sub, d). With `lengths` (B,) mel frames,
    padded frames are masked out of attention and re-zeroed after each
    block, so bucketed inputs match tight shapes; a row of length 0 comes
    out zero."""
    x = subsample(enc.pre_encode, mel)
    if a.xscaling:
        x = x * (a.d_model ** 0.5)
    t = x.shape[1]
    pos_emb = _pos_table(t, a.d_model, x.device, x.dtype)
    allow = vmask = None
    if lengths is not None:
        n = subsampled_length(a, lengths)
        valid = torch.arange(t, device=x.device)[None, :] < n[:, None]
        allow = (valid | (n == 0)[:, None])[:, None, None, :]
        vmask = valid.to(x.dtype)[..., None]
        x = x * vmask
    for blk in enc.layers:
        x = conformer_block(blk, a, x, pos_emb, allow)
        if vmask is not None:
            x = x * vmask
    return x


__all__ = ["ConformerArgs", "Conformer", "ConformerBlock", "Subsampling",
           "rel_pos_encoding", "subsample", "rel_pos_attention",
           "conformer_block", "conformer_forward", "subsampled_length"]
