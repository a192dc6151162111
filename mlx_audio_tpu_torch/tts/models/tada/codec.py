"""TADA codec: the DAC waveform coder and the segment-masked local
attention stack.

Counterpart of mlx_audio_tpu/tts/models/tada/codec.py: the snake residual
units (:34-50), `wav_encoder_forward` (:73) and `dac_decoder_forward`
(:109; each transposed conv runs unpadded, then is cropped by `pad` and
extended by `out_pad`, as :115-120 do), the post-norm local attention
stack `local_attention_forward` (:160; interleaved-pair RoPE over the
positions of the sequence, base 10,000, :147; its FFN's GELU the tanh
form, `jax.nn.gelu`'s default) and `segment_attention_mask` v1 and v2
(:193). The modules hold the JAX tree's names; the snake alphas are
(C,) here where the JAX tree keeps (1, 1, C), which `load_jax_params`
reshapes. A blocked position is an additive -inf in the attention's
float mask. There is no Pallas kernel on this path.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....codec.models.blocks import Snake, snake
from ....nn import Conv1d, ConvTranspose1d, LayerNorm, Linear
from ....ops.attention import attention
from ....ops.rope import apply_rope_interleaved, rope_freqs


class ResUnit(nn.Module):
    """`snake1`, a 7-wide `conv1`, `snake2`, a 1x1 `conv2`."""

    def __init__(self, dim: int):
        super().__init__()
        self.snake1 = Snake(dim)
        self.conv1 = Conv1d(dim, dim, 7)
        self.snake2 = Snake(dim)
        self.conv2 = Conv1d(dim, dim, 1)


def _res_unit(p: ResUnit, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = snake(x, p.snake1.alpha)
    h = p.conv1(h, padding=((7 - 1) * dilation) // 2, dilation=dilation)
    return x + p.conv2(snake(h, p.snake2.alpha))


def _res_units(dim: int) -> dict:
    return {"res1": ResUnit(dim), "res2": ResUnit(dim), "res3": ResUnit(dim)}


def _run_res_units(blk, x: torch.Tensor) -> torch.Tensor:
    for name, dil in (("res1", 1), ("res2", 3), ("res3", 9)):
        x = _res_unit(blk[name], x, dil)
    return x


class WavEncoder(nn.Module):
    """init_wav_encoder's tree: `conv_in`, `blocks.N` (three residual
    units, a snake, a strided conv doubling the width), `snake_out`,
    `conv_out`."""

    def __init__(self, d_model: int, strides: List[int], d_latent: int):
        super().__init__()
        self.conv_in = Conv1d(1, d_model, 7)
        blocks = {}
        d = d_model
        for i, s in enumerate(strides):
            d *= 2
            blocks[str(i)] = nn.ModuleDict(dict(
                _res_units(d // 2), snake=Snake(d // 2),
                conv=Conv1d(d // 2, d, 2 * s)))
        self.blocks = nn.ModuleDict(blocks)
        self.snake_out = Snake(d)
        self.conv_out = Conv1d(d, d_latent, 3)


def wav_encoder_forward(p: WavEncoder, strides: List[int],
                        x: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) -> (B, T / prod(strides), d_latent)."""
    x = p.conv_in(x, padding=3)
    for i, s in enumerate(strides):
        blk = p.blocks[str(i)]
        x = _run_res_units(blk, x)
        x = snake(x, blk["snake"].alpha)
        x = blk["conv"](x, stride=s, padding=math.ceil(s / 2))
    return p.conv_out(snake(x, p.snake_out.alpha), padding=1)


class DacDecoder(nn.Module):
    """init_dac_decoder's tree: `conv_in`, `blocks.N` (a snake, a
    transposed conv halving the width, three residual units),
    `snake_out`, `conv_out`."""

    def __init__(self, d_model: int, strides: List[int], d_latent: int):
        super().__init__()
        mult = 2 ** len(strides)
        self.conv_in = Conv1d(d_latent, d_model * mult, 7)
        blocks = {}
        for i, s in enumerate(strides):
            dim = d_model * mult
            blocks[str(i)] = nn.ModuleDict(dict(
                snake=Snake(dim), conv_t=ConvTranspose1d(dim, dim // 2, 2 * s),
                **_res_units(dim // 2)))
            mult //= 2
        self.blocks = nn.ModuleDict(blocks)
        self.snake_out = Snake(d_model)
        self.conv_out = Conv1d(d_model, 1, 7)


def dac_decoder_forward(p: DacDecoder, strides: List[int],
                        x: torch.Tensor) -> torch.Tensor:
    """(B, L, d_latent) -> (B, L * prod(strides), 1) tanh waveform."""
    x = p.conv_in(x, padding=3)
    for i, s in enumerate(strides):
        blk = p.blocks[str(i)]
        x = snake(x, blk["snake"].alpha)
        pad = math.ceil(s / 2)
        out_pad = s + 2 * pad - 2 * s
        y = blk["conv_t"](x, stride=s)
        x = _run_res_units(blk, y[:, pad:y.shape[1] - pad + out_pad])
    x = snake(x, p.snake_out.alpha)
    return torch.tanh(p.conv_out(x, padding=3))


# ------------------------------------------------- local attention stack

class LocalAttention(nn.Module):
    """init_local_attention's tree: `layers.N` (`self_attn` with a fused
    `qkv`, `out_proj` and its post-`layer_norm`; `ffn_in`, `ffn_out`,
    `norm`) and `final_norm`."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int,
                 d_ff: int):
        super().__init__()
        self.num_heads = num_heads
        self.layers = nn.ModuleList(nn.ModuleDict(dict(
            self_attn=nn.ModuleDict(dict(
                qkv=Linear(d_model, 3 * d_model),
                out_proj=Linear(d_model, d_model),
                layer_norm=LayerNorm(d_model))),
            ffn_in=Linear(d_model, d_ff), ffn_out=Linear(d_ff, d_model),
            norm=LayerNorm(d_model))) for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model)


def local_attention_forward(p: LocalAttention, x: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Post-norm transformer over x (B, L, D) with interleaved RoPE in
    every layer; `mask` (B, L, L) or (L, L) bool, True = blocked."""
    b, l, d = x.shape
    nh = p.num_heads
    dh = d // nh
    add = None
    if mask is not None:
        add = torch.zeros(mask.shape, device=x.device).masked_fill(
            mask, float("-inf"))
        add = add[None, None] if add.ndim == 2 else add[:, None]
    pos = torch.arange(l, device=x.device)
    inv = rope_freqs(dh, 10000.0).to(x.device)
    for lp in p.layers:
        a = lp["self_attn"]
        qkv = a["qkv"](x).reshape(b, l, 3, nh, dh)
        q = apply_rope_interleaved(qkv[:, :, 0], pos, inv)
        k = apply_rope_interleaved(qkv[:, :, 1], pos, inv)
        o = attention(q, k, qkv[:, :, 2], mask=add, scale=dh ** -0.5)
        x = a["layer_norm"](x + a["out_proj"](o.reshape(b, l, d)))
        h = lp["ffn_out"](F.gelu(lp["ffn_in"](x), approximate="tanh"))
        x = lp["norm"](x + h)
    return p.final_norm(x)


def segment_attention_mask(token_mask: torch.Tensor,
                           version: str = "v2") -> torch.Tensor:
    """(B, L) boundary mask -> (B, L, L) bool, True = blocked: a row sees
    its own block and (v2) the block before it, or (v1) the block after
    it with the boundary rows excluded."""
    tm = token_mask.long()
    block_ids = torch.cumsum(tm, dim=1) - tm
    bi = block_ids[:, :, None]
    bj = block_ids[:, None, :]
    same = bj == bi
    if version == "v1":
        bj_ex = torch.where(tm.bool(), -10, block_ids)[:, None, :]
        can = same | (bj_ex == bi + 1)
    elif version == "v2":
        can = same | (bj == bi - 1)
    else:
        raise ValueError(f"Unknown version: {version}")
    return ~can


__all__ = ["WavEncoder", "wav_encoder_forward", "DacDecoder",
           "dac_decoder_forward", "LocalAttention",
           "local_attention_forward", "segment_attention_mask"]
