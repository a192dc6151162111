"""Qwen3-TTS 12.5 Hz split-RVQ speech-tokenizer decoder, non-streaming.

Counterpart of the decode half of
mlx_audio_tpu/tts/models/qwen3_tts/speech_tokenizer.py: `snake_beta`,
`causal_conv`, `causal_tconv`, `split_rvq_decode`, the pre-transformer
(sliding window, LayerScale) without caches, the ConvNeXt and residual
units, and `decode_full` (:358-379). Module names follow the JAX tree
(`speech_tokenizer.decoder.<...>`); the convolutions hold torch layouts,
converted from the JAX package's WIO / pre-flipped kernels by
`model.load_jax_params`. The streaming path (`streaming_step`,
`init_stream_state`) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import (Conv1d, ConvTranspose1d, Embedding, LayerNorm, Linear,
                    RMSNorm, gelu)
from ....ops.attention import attention
from ....ops.rope import apply_rotary, rope_cos_sin, rope_freqs
from .config import Qwen3TTSTokenizerDecoderConfig


class SnakeBeta(nn.Module):
    """x + 1/(e^beta) sin^2(e^alpha x) (snake_beta, :52-56)."""

    init_fill = {"alpha": 0.0, "beta": 0.0}

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(dim))
        self.beta = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.exp(self.alpha)
        beta = torch.exp(self.beta)
        return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha) ** 2


class CausalConv(nn.Module):
    """`{"conv": {...}}` holder; left-pads (k-1)*dil + 1 - stride."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.kernel = kernel
        self.conv = Conv1d(in_ch, out_ch, kernel, bias=bias, groups=groups)

    def forward(self, x: torch.Tensor, dilation: int = 1,
                stride: int = 1) -> torch.Tensor:
        pad = (self.kernel - 1) * dilation + 1 - stride
        return self.conv(x, stride=stride, padding=(pad, 0),
                         dilation=dilation)


class CausalTConv(nn.Module):
    """Transposed conv with the last kernel - stride samples trimmed."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.conv = ConvTranspose1d(in_ch, out_ch, kernel)

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        y = self.conv(x, stride=stride)
        trim = self.kernel - stride
        return y[:, :y.shape[1] - trim] if trim > 0 else y


class Codebook(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self.embed = Embedding(size, dim)


class VQLayer(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self.codebook = Codebook(size, dim)


class VQ(nn.Module):
    def __init__(self, n_q: int, size: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(VQLayer(size, dim) for _ in range(n_q))


class RVQ(nn.Module):
    def __init__(self, n_q: int, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        dim = cfg.codebook_dim // 2
        # 1x1 conv (JAX WIO (1, dim, codebook_dim)), no bias
        self.output_proj = Conv1d(dim, cfg.codebook_dim, 1, bias=False)
        self.vq = VQ(n_q, cfg.codebook_size, dim)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, n_q, T) -> (B, T, codebook_dim)."""
        acc = None
        for i, layer in enumerate(self.vq.layers):
            q = layer.codebook.embed(codes[:, i])
            acc = q if acc is None else acc + q
        return self.output_proj(acc)


class SplitRVQ(nn.Module):
    """Semantic level(s) and acoustic rest, decoded and summed
    (split_rvq_decode, :126-148)."""

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.n_sem = cfg.num_semantic_quantizers
        self.rvq_first = RVQ(cfg.num_semantic_quantizers, cfg)
        self.rvq_rest = RVQ(cfg.num_quantizers - cfg.num_semantic_quantizers,
                            cfg)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        out = self.rvq_first(codes[:, :self.n_sem])
        if codes.shape[1] > self.n_sem:
            out = out + self.rvq_rest(codes[:, self.n_sem:])
        return out


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.init_fill = {"scale": init}
        self.scale = nn.Parameter(torch.empty(dim))


class TfAttention(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        hd, b = cfg.head_dim, cfg.attention_bias
        self.q_proj = Linear(cfg.hidden_size, cfg.num_attention_heads * hd, b)
        self.k_proj = Linear(cfg.hidden_size, cfg.num_key_value_heads * hd, b)
        self.v_proj = Linear(cfg.hidden_size, cfg.num_key_value_heads * hd, b)
        self.o_proj = Linear(cfg.num_attention_heads * hd, cfg.hidden_size, b)


class TfMLP(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size, False)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, False)
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size, False)


class TfLayer(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        eps, init = cfg.rms_norm_eps, cfg.layer_scale_initial_scale
        self.self_attn = TfAttention(cfg)
        self.mlp = TfMLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.self_attn_layer_scale = LayerScale(cfg.hidden_size, init)
        self.mlp_layer_scale = LayerScale(cfg.hidden_size, init)


class PreTransformer(nn.Module):
    """Sliding-window causal transformer with LayerScale, no cache
    (pre_transformer_forward, :201-258)."""

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.input_proj = Linear(cfg.latent_dim, cfg.hidden_size)
        self.output_proj = Linear(cfg.hidden_size, cfg.latent_dim)
        self.layers = nn.ModuleList(TfLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.register_buffer("inv_freq",
                             rope_freqs(cfg.head_dim, cfg.rope_theta),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        x = self.input_proj(x)
        positions = torch.arange(t, device=x.device)[None, :]
        cos, sin = rope_cos_sin(positions, self.inv_freq)
        q_pos = torch.arange(t, device=x.device)[:, None]
        k_pos = torch.arange(t, device=x.device)[None, :]
        ok = (k_pos <= q_pos) & (k_pos > q_pos - cfg.sliding_window)
        mask = torch.zeros(ok.shape, device=x.device).masked_fill(
            ~ok, float("-inf"))[None, None]
        for lp in self.layers:
            a = lp.self_attn
            h = lp.input_layernorm(x)
            q = apply_rotary(a.q_proj(h).reshape(b, t, nh, hd), cos, sin)
            k = apply_rotary(a.k_proj(h).reshape(b, t, nkv, hd), cos, sin)
            v = a.v_proj(h).reshape(b, t, nkv, hd)
            out = attention(q, k, v, mask=mask).reshape(b, t, nh * hd)
            x = x + a.o_proj(out) * lp.self_attn_layer_scale.scale
            h = lp.post_attention_layernorm(x)
            m = lp.mlp
            x = x + (m.down_proj(F.silu(m.gate_proj(h)) * m.up_proj(h))
                     * lp.mlp_layer_scale.scale)
        return self.output_proj(self.norm(x))


class ConvNeXt(nn.Module):
    """Depthwise causal conv k=7 -> LayerNorm -> MLP (exact GELU) -> gamma
    residual (_convnext_apply, :277-289)."""

    init_fill = {"gamma": 1e-6}

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = CausalConv(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.dwconv(x))
        h = self.pwconv2(gelu(self.pwconv1(h)))
        return x + self.gamma * h


class ResUnit(nn.Module):
    """snake -> causal conv k=7 (dilated) -> snake -> 1x1 conv, residual
    (_res_unit_apply, :302-314)."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.act1 = SnakeBeta(dim)
        self.conv1 = CausalConv(dim, dim, 7)
        self.act2 = SnakeBeta(dim)
        self.conv2 = CausalConv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.act1(x), dilation=self.dilation)
        return self.conv2(self.act2(h)) + x


class DecoderBlock(nn.Module):
    """snake -> upsampling transposed conv -> residual units dil 1, 3, 9."""

    def __init__(self, in_dim: int, out_dim: int, rate: int):
        super().__init__()
        self.rate = rate
        self.block = nn.ModuleList([
            SnakeBeta(in_dim), CausalTConv(in_dim, out_dim, rate * 2),
            ResUnit(out_dim, 1), ResUnit(out_dim, 3), ResUnit(out_dim, 9)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        snake, tconv, *units = self.block
        x = tconv(snake(x), self.rate)
        for unit in units:
            x = unit(x)
        return x


class Decoder(nn.Module):
    """codes (B, n_q, T) -> audio (B, T * total_upsample) (init_decoder,
    :317-351; decode_full, :358-379)."""

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.pre_transformer = PreTransformer(cfg)
        self.quantizer = SplitRVQ(cfg)
        self.pre_conv = CausalConv(cfg.codebook_dim, cfg.latent_dim, 3)
        self.upsample = nn.ModuleList(
            nn.ModuleList([CausalTConv(cfg.latent_dim, cfg.latent_dim,
                                       factor * 2), ConvNeXt(cfg.latent_dim)])
            for factor in cfg.upsampling_ratios)
        blocks = [CausalConv(cfg.latent_dim, cfg.decoder_dim, 7)]
        for li, rate in enumerate(cfg.upsample_rates):
            blocks.append(DecoderBlock(cfg.decoder_dim // 2 ** li,
                                       cfg.decoder_dim // 2 ** (li + 1), rate))
        out_dim = cfg.decoder_dim // 2 ** len(cfg.upsample_rates)
        blocks += [SnakeBeta(out_dim), CausalConv(out_dim, 1, 7)]
        self.decoder = nn.ModuleList(blocks)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.quantizer(codes)
        h = self.pre_conv(h)
        h = self.pre_transformer(h)
        for (tconv, convnext), factor in zip(self.upsample,
                                             cfg.upsampling_ratios):
            h = convnext(tconv(h, factor))
        for block in self.decoder:
            h = block(h)
        return torch.clamp(h[..., 0], -1.0, 1.0)


class SpeechTokenizer(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.decoder = Decoder(cfg)


def total_upsample(cfg: Qwen3TTSTokenizerDecoderConfig) -> int:
    return int(math.prod(cfg.upsample_rates) * math.prod(cfg.upsampling_ratios))
