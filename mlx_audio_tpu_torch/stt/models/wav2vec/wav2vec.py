"""Wav2Vec2 / HuBERT backbone: raw-waveform conv feature encoder +
transformer.

Counterpart of mlx_audio_tpu/stt/models/wav2vec/wav2vec.py, whole: the
strided conv feature encoder with its group-norm (first layer only,
normalised over the valid frames) and layer-norm variants, the grouped
positional conv with its same-pad trim, the post-norm and stable-layer-
norm encoder stacks with the optional MMS attention adapters, and the
HF-checkpoint sanitize, whose weight-norm pairs are folded into plain conv
weights. Channel-last (B, T, C) throughout; a `num_samples` count per row
keeps padded rows out of the norms and re-zeroes them after every stage,
so a padded length gives the tight length's numbers.

The Higgs Audio v2 codec's semantic branch runs it (`semantic_model`).
Parameters are named as the JAX tree's leaves and held in torch layouts;
`sanitize_wav2vec2` keeps an HF checkpoint's torch (O, I/g, K) conv
kernels as they are (the JAX package's turns them to WIO).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Conv1d, LayerNorm, Linear, gelu


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "wav2vec2"
    vocab_size: int = 32
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_feat_extract_layers: int = 7
    do_stable_layer_norm: bool = False
    pad_token_id: int = 0
    adapter_attn_dim: Optional[int] = None


def feature_lengths(cfg: ModelConfig, num_samples) -> torch.Tensor:
    """Samples -> conv-stack output frames: L' = (L - k) // s + 1 per layer."""
    n = torch.as_tensor(num_samples)
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = torch.div(n - k, s, rounding_mode="floor") + 1
    return torch.clamp(n, min=0)


# ---------------------------------------------------------------- modules


class _ConvLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, i: int):
        super().__init__()
        cin = 1 if i == 0 else cfg.conv_dim[i - 1]
        self.conv = Conv1d(cin, cfg.conv_dim[i], cfg.conv_kernel[i],
                           bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "layer" or \
                (cfg.feat_extract_norm == "group" and i == 0):
            self.layer_norm = LayerNorm(cfg.conv_dim[i], cfg.layer_norm_eps)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.attention = holder(q_proj=Linear(h, h), k_proj=Linear(h, h),
                                 v_proj=Linear(h, h), out_proj=Linear(h, h))
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps)
        self.feed_forward = holder(
            intermediate_dense=Linear(h, cfg.intermediate_size),
            output_dense=Linear(cfg.intermediate_size, h))
        self.final_layer_norm = LayerNorm(h, cfg.layer_norm_eps)
        if cfg.adapter_attn_dim is not None:
            self.adapter_layer = holder(
                norm=LayerNorm(h, cfg.layer_norm_eps),
                linear_1=Linear(h, cfg.adapter_attn_dim),
                linear_2=Linear(cfg.adapter_attn_dim, h))


class Wav2Vec2Model(TorchModel):
    """The backbone's parameters under the JAX tree's names
    (`feature_extractor.conv_layers.{i}`, `feature_projection`,
    `encoder.pos_conv_embed.conv`, `encoder.layers.{i}`, ...), on `device`:
    the card by default; without CUDA the constructor raises unless given
    `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict], device="cuda"):
        device = check_device(device)
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        cfg = config
        h = cfg.hidden_size
        with torch.device(device):
            self.feature_extractor = holder(conv_layers=nn.ModuleList(
                _ConvLayer(cfg, i)
                for i in range(cfg.num_feat_extract_layers)))
            self.feature_projection = holder(
                layer_norm=LayerNorm(cfg.conv_dim[-1], cfg.layer_norm_eps),
                projection=Linear(cfg.conv_dim[-1], h))
            self.encoder = holder(
                pos_conv_embed=holder(conv=Conv1d(
                    h, h, cfg.num_conv_pos_embeddings,
                    groups=cfg.num_conv_pos_embedding_groups)),
                layer_norm=LayerNorm(h, cfg.layer_norm_eps),
                layers=nn.ModuleList(_EncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)))
        self.requires_grad_(False)


# ---------------------------------------------------------------- forward


def _masked_channel_norm(p: LayerNorm, x: torch.Tensor, mask: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """torch GroupNorm(groups == channels) on (B, C, T): per-channel
    normalisation over TIME, restricted to valid frames."""
    m = mask[..., None]                                   # (B, T, 1)
    n = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (x * m).sum(dim=1, keepdim=True) / n
    var = ((x - mean) ** 2 * m).sum(dim=1, keepdim=True) / n
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p.weight.to(x.dtype) + p.bias.to(x.dtype)


def _frames_mask(t: int, n: torch.Tensor, dtype) -> torch.Tensor:
    return (torch.arange(t, device=n.device)[None, :] < n[:, None]).to(dtype)


def _feature_encoder(model: Wav2Vec2Model, cfg: ModelConfig,
                     wave: torch.Tensor, num_samples
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) waveform -> ((B, F, conv_dim[-1]) features, (B,) lengths)."""
    x = wave[..., None]
    n = torch.as_tensor(num_samples, device=wave.device)
    for i, lp in enumerate(model.feature_extractor.conv_layers):
        x = lp.conv(x, stride=cfg.conv_stride[i])
        n = torch.clamp(torch.div(n - cfg.conv_kernel[i], cfg.conv_stride[i],
                                  rounding_mode="floor") + 1, min=0)
        mask = _frames_mask(x.shape[1], n, x.dtype)
        if cfg.feat_extract_norm == "group" and i == 0:
            x = _masked_channel_norm(lp.layer_norm, x, mask)
        elif cfg.feat_extract_norm == "layer":
            x = lp.layer_norm(x)
        x = gelu(x) * mask[..., None]
    return x, n


def _pos_conv(p: nn.Module, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    k = cfg.num_conv_pos_embeddings
    y = p.conv(x, padding=k // 2)
    if k % 2 == 0:
        y = y[:, :-1, :]
    return gelu(y)


def _attention(p: nn.Module, x: torch.Tensor, num_heads: int,
               bias_mask: torch.Tensor) -> torch.Tensor:
    """Full bidirectional attention; scores and softmax in x's dtype, as the
    JAX package's."""
    b, t, d = x.shape
    hd = d // num_heads
    q = p.q_proj(x).reshape(b, t, num_heads, hd)
    k = p.k_proj(x).reshape(b, t, num_heads, hd)
    v = p.v_proj(x).reshape(b, t, num_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(hd, dtype=x.dtype))
    logits = logits + bias_mask[:, None, None, :].to(logits.dtype)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, d)
    return p.out_proj(out)


def _ffn(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return p.output_dense(gelu(p.intermediate_dense(x)))


def _embed(model: Wav2Vec2Model, cfg: ModelConfig, wave: torch.Tensor,
           num_samples):
    """Feature encoder, projection, positional conv (and the post-norm
    stack's first layer norm) -> (x, n, valid, mask) before the layers."""
    feats, n = _feature_encoder(model, cfg, wave, num_samples)
    valid = torch.arange(feats.shape[1], device=n.device)[None, :] < n[:, None]
    mask = valid.to(feats.dtype)[..., None]
    fp = model.feature_projection
    x = fp.projection(fp.layer_norm(feats)) * mask
    enc = model.encoder
    x = (x + _pos_conv(enc.pos_conv_embed, cfg, x)) * mask
    if not cfg.do_stable_layer_norm:
        x = enc.layer_norm(x)
    return x, n, valid, mask


def encoder_layer(lp: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                  bias_mask: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One encoder layer, its output re-zeroed past each row's length."""
    if cfg.do_stable_layer_norm:
        x = x + _attention(lp.attention, lp.layer_norm(x),
                           cfg.num_attention_heads, bias_mask)
        x = x + _ffn(lp.feed_forward, lp.final_layer_norm(x))
        if hasattr(lp, "adapter_layer"):
            a = lp.adapter_layer
            x = x + a.linear_2(torch.relu(a.linear_1(a.norm(x))))
    else:
        x = x + _attention(lp.attention, x, cfg.num_attention_heads,
                           bias_mask)
        x = lp.layer_norm(x)
        x = x + _ffn(lp.feed_forward, x)
        x = lp.final_layer_norm(x)
    return x * mask


def wav2vec2_forward(model: Wav2Vec2Model, wave: torch.Tensor, num_samples,
                     collect_hidden: bool = False):
    """(B, T) raw 16 kHz waveform (normalised by the caller) -> ((B, F,
    hidden) hidden states, (B,) valid frame counts); with collect_hidden
    also the HF-indexed list of hidden states ([0] before the layers,
    [i + 1] after layer i)."""
    cfg = model.config
    x, n, valid, mask = _embed(model, cfg, wave, num_samples)
    bias_mask = torch.where(valid, 0.0, torch.finfo(x.dtype).min).to(x.dtype)
    hidden = [x] if collect_hidden else None
    for lp in model.encoder.layers:
        x = encoder_layer(lp, cfg, x, bias_mask, mask)
        if collect_hidden:
            hidden.append(x)
    if cfg.do_stable_layer_norm:
        x = model.encoder.layer_norm(x) * mask
    if collect_hidden:
        return x, n, hidden
    return x, n


# ---------------------------------------------------------------- sanitize


def _fold_weight_norm_conv(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """HF pos-conv weight norm (torch weight_norm dim=2 on (O, I/g, K)):
    per-kernel-position g (1, 1, K), norm over (O, I/g)."""
    v = np.asarray(v, np.float32)
    g = np.asarray(g, np.float32).reshape(1, 1, -1)
    norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def sanitize_wav2vec2(weights: Dict, strip_prefix: bool = True) -> Dict:
    """HF checkpoint -> the port's names (wav2vec.py:265-294): weight-norm
    pairs (weight_g/weight_v or parametrizations.original0/1) folded into
    plain conv weights, training-only tensors dropped; conv kernels keep
    torch's (O, I/g, K)."""
    out = {}
    staged_g, staged_v = {}, {}
    for k, v in weights.items():
        if strip_prefix and k.startswith("wav2vec2."):
            k = k[len("wav2vec2."):]
        if k.endswith(".parametrizations.weight.original0"):
            k = k.replace(".parametrizations.weight.original0", ".weight_g")
        elif k.endswith(".parametrizations.weight.original1"):
            k = k.replace(".parametrizations.weight.original1", ".weight_v")
        if k.startswith("quantizer.") or k.startswith("project_") \
                or k == "masked_spec_embed":
            continue
        if k.endswith(".weight_g"):
            staged_g[k[: -len(".weight_g")]] = np.asarray(v)
            continue
        if k.endswith(".weight_v"):
            staged_v[k[: -len(".weight_v")]] = np.asarray(v)
            continue
        out[k] = np.asarray(v)
    for base, v in staged_v.items():
        g = staged_g.get(base)
        out[base + ".weight"] = _fold_weight_norm_conv(g, v) \
            if g is not None else np.asarray(v)
    return out


__all__ = ["ModelConfig", "Wav2Vec2Model", "wav2vec2_forward",
           "feature_lengths", "sanitize_wav2vec2", "encoder_layer"]
