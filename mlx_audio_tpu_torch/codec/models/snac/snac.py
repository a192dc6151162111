"""SNAC: a multi-scale residual-VQ codec (24 kHz speech, the codec under
Orpheus).

Counterpart of mlx_audio_tpu/codec/models/snac/snac.py: `ModelConfig`
(:54-68), the encoder, quantizer and decoder trees (:76-178), `preprocess`,
`_encode_latent`, `encode`, `codes_to_latent`, `decode` (:182-281),
`decode_stream` (:283-318) and `sanitize` (:326-364), on channel-last
(B, T, C) tensors with parameters in torch's layouts. Parameter names are
the JAX tree's (`encoder.1.block.0.block.1.weight`, `quantizer.0.codebook`,
`decoder.2.block.1.weight`), so `model.load_jax_params` binds that tree
and `sanitize` gives it from a torch checkpoint.

The decoder's noise blocks add `noise * conv1x1(x)` after each upsampler.
The JAX package draws that noise from `jax.random.PRNGKey(0)` on every
decode, so a decode is deterministic; a torch stream cannot repeat that
draw. Here each decode draws from a `torch.Generator` seeded with
`noise_seed` (0), stage by stage, through `_noise`, the seam through which
the tests hand the port JAX's draws.

The JAX package ignores `attn_window_size`: the local attention of the
32 and 44.1 kHz SNACs runs in neither package. Orpheus's 24 kHz SNAC has
none.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Conv1d, ConvTranspose1d, Embedding
from ..blocks import (ResidualUnit, Snake, apply_residual_unit, apply_snake,
                      avg_pool_time, repeat_time, vq_encode)

DILATIONS = (1, 3, 9)


def _is_decoder_upsampler(base: str) -> bool:
    """decoder.N.block.1 is a decoder stage's transposed upsampler in the
    descript/snac layout. A substring test on '.block.1.' would also match
    a residual unit's inner conv (...block.K.block.1), so the pattern is
    anchored to the block right under a decoder stage (:42-49)."""
    return re.search(r"decoder\.(?:model\.)?\d+\.block\.1$", base) is not None


@dataclass
class ModelConfig(BaseModelArgs):
    sampling_rate: int = 24000
    encoder_dim: int = 64
    encoder_rates: List[int] = field(default_factory=lambda: [3, 3, 7, 7])
    latent_dim: Optional[int] = None
    decoder_dim: int = 1536
    decoder_rates: List[int] = field(default_factory=lambda: [7, 7, 3, 3])
    attn_window_size: Optional[int] = 32
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: List[int] = field(default_factory=lambda: [8, 4, 2, 1])
    noise: bool = True
    depthwise: bool = True
    model_path: str = ""


def _encoder_block(dim: int, stride: int, groups: int) -> nn.Module:
    """(:76-85) three residual units at dim / 2, a snake, a strided conv."""
    half = dim // 2
    return holder(block=nn.ModuleDict({
        "0": ResidualUnit(half, groups=groups),
        "1": ResidualUnit(half, groups=groups),
        "2": ResidualUnit(half, groups=groups),
        "3": Snake(half),
        "4": Conv1d(half, dim, 2 * stride)}))


def _decoder_block(in_dim: int, out_dim: int, stride: int, noise: bool,
                   groups: int) -> nn.Module:
    """(:88-105) a snake, the transposed upsampler, the noise block's 1x1
    conv, three residual units."""
    block = {"0": Snake(in_dim),
             "1": ConvTranspose1d(in_dim, out_dim, 2 * stride)}
    if noise:
        block["2"] = holder(linear=Conv1d(out_dim, out_dim, 1, bias=False))
    for _ in DILATIONS:
        block[str(len(block))] = ResidualUnit(out_dim, groups=groups)
    return holder(block=nn.ModuleDict(block))


def convert_torch_conv_transpose_weight(w: np.ndarray,
                                        groups: int = 1) -> np.ndarray:
    """torch ConvTranspose1d weight (I, O/g, W) -> the JAX tree's
    pre-flipped forward kernel (W, I/g, O) (mlx_audio_tpu/nn/layers.py:
    243-257)."""
    w = np.asarray(w)
    i_ch, o_g, width = w.shape
    w = w.reshape(groups, i_ch // groups, o_g, width).transpose(3, 1, 0, 2)
    return np.flip(w.reshape(width, i_ch // groups, groups * o_g), axis=0)


class SNAC(TorchModel):
    """The SNAC codec on `device` (the card by default; without CUDA the
    constructor raises unless given `device="cpu"`)."""

    noise_seed = 0

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda"):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        c = config
        self.hop_length = int(np.prod(c.encoder_rates))
        self.latent_dim = (c.latent_dim if c.latent_dim is not None
                           else c.encoder_dim * (2 ** len(c.encoder_rates)))
        with torch.device(device):
            enc = {"0": Conv1d(1, c.encoder_dim, 7)}
            d = c.encoder_dim
            for stride in c.encoder_rates:
                d *= 2
                enc[str(len(enc))] = _encoder_block(
                    d, stride, d // 2 if c.depthwise else 1)
            enc[str(len(enc))] = Conv1d(d, d, 7,
                                        groups=d if c.depthwise else 1)
            self.encoder = nn.ModuleDict(enc)
            self.quantizer = nn.ModuleDict({str(i): holder(
                in_proj=Conv1d(self.latent_dim, c.codebook_dim, 1),
                out_proj=Conv1d(c.codebook_dim, self.latent_dim, 1),
                codebook=Embedding(c.codebook_size, c.codebook_dim))
                for i in range(len(c.vq_strides))})
            lat = self.latent_dim
            if c.depthwise:
                dec = {"0": Conv1d(lat, lat, 7, groups=lat),
                       "1": Conv1d(lat, c.decoder_dim, 1)}
            else:
                dec = {"0": Conv1d(lat, c.decoder_dim, 7)}
            out_dim = c.decoder_dim
            for i, stride in enumerate(c.decoder_rates):
                in_dim = c.decoder_dim // (2 ** i)
                out_dim = c.decoder_dim // (2 ** (i + 1))
                dec[str(len(dec))] = _decoder_block(
                    in_dim, out_dim, stride, c.noise,
                    out_dim if c.depthwise else 1)
            dec[str(len(dec))] = Snake(out_dim)
            dec[str(len(dec))] = Conv1d(out_dim, 1, 7)
            self.decoder = nn.ModuleDict(dec)
        self.requires_grad_(False)
        self.eval()

    # -- pipeline -----------------------------------------------------------

    def preprocess(self, audio: torch.Tensor) -> torch.Tensor:
        """Right-pad the last axis to a multiple of vq_strides[0] x hop."""
        lcm = np.lcm(self.config.vq_strides[0], 1) * self.hop_length
        pad = (lcm - audio.shape[-1] % lcm) % lcm
        return torch.nn.functional.pad(audio, (0, int(pad)))

    def _encode_latent(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T) -> latent (B, T / hop, D)."""
        c, enc = self.config, self.encoder
        x = enc["0"](audio[..., None], padding=3)
        for i, stride in enumerate(c.encoder_rates):
            blk = enc[str(i + 1)].block
            for j, dil in zip("012", DILATIONS):
                x = apply_residual_unit(blk[j], x, dil)
            x = apply_snake(blk["3"], x)
            x = blk["4"](x, stride=stride, padding=math.ceil(stride / 2))
        return enc[str(len(c.encoder_rates) + 1)](x, padding=3)

    def _audio(self, audio) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(
            audio, torch.Tensor) else audio, device=self.device).float()
        if x.ndim == 3:
            x = x[:, 0]
        elif x.ndim == 1:
            x = x[None]
        return x

    @torch.no_grad()
    def encode(self, audio) -> List[torch.Tensor]:
        """(B, 1, T), (B, T) or (T,) audio -> one int64 code tensor (B, T_i)
        a quantizer level (T_i = latent frames / vq_strides[i])."""
        z = self._encode_latent(self.preprocess(self._audio(audio)))
        codes, residual = [], z
        for i, stride in enumerate(self.config.vq_strides):
            q = self.quantizer[str(i)]
            zi = avg_pool_time(residual, stride) if stride > 1 else residual
            idx = vq_encode(q.in_proj(zi), q.codebook.weight, normalized=True)
            codes.append(idx)
            z_q = q.out_proj(q.codebook(idx))
            if stride > 1:
                z_q = repeat_time(z_q, stride)
            residual = residual - z_q
        return codes

    def _codes(self, codes: Sequence) -> List[torch.Tensor]:
        return [torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=self.device).long()
            for x in codes]

    @torch.no_grad()
    def codes_to_latent(self, codes: Sequence) -> torch.Tensor:
        z = None
        for i, (stride, idx) in enumerate(zip(self.config.vq_strides,
                                              self._codes(codes))):
            q = self.quantizer[str(i)]
            z_q = q.out_proj(q.codebook(idx))
            if stride > 1:
                z_q = repeat_time(z_q, stride)
            z = z_q if z is None else z + z_q
        return z

    def _noise(self, generator: torch.Generator, stage: int,
               shape: Tuple[int, ...]) -> torch.Tensor:
        """The standard-normal f32 noise (B, T, 1) of decoder stage `stage`
        (a test replaces this to feed JAX's draws)."""
        del stage
        return torch.randn(shape, generator=generator, device=self.device)

    @torch.no_grad()
    def decode(self, codes: Sequence) -> torch.Tensor:
        """codes (one (B, T_i) per level) -> audio (B, samples, 1) in
        [-1, 1] (tanh)."""
        c, dec = self.config, self.decoder
        z = self.codes_to_latent(codes)
        if c.depthwise:
            x = dec["1"](dec["0"](z, padding=3))
            idx = 2
        else:
            x = dec["0"](z, padding=3)
            idx = 1
        gen = torch.Generator(device=self.device).manual_seed(self.noise_seed)
        for i, stride in enumerate(c.decoder_rates):
            blk = dec[str(idx + i)].block
            x = apply_snake(blk["0"], x)
            x = blk["1"](x, stride=stride, padding=math.ceil(stride / 2),
                         output_padding=stride % 2)
            j = 2
            if c.noise:
                h = blk["2"].linear(x)
                noise = self._noise(gen, i, (x.shape[0], x.shape[1], 1))
                x = x + noise.to(x.dtype) * h
                j = 3
            for dil in DILATIONS:
                x = apply_residual_unit(blk[str(j)], x, dil)
                j += 1
        idx += len(c.decoder_rates)
        x = dec[str(idx + 1)](apply_snake(dec[str(idx)], x), padding=3)
        return torch.tanh(x)

    def decode_stream(self, codes: Sequence,
                      prev_codes: Optional[Sequence] = None,
                      context_frames: int = 8
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Decode new frames with latent-frame context (:283-318). `codes`
        are the new frames only; level i prepends its last
        max(1, context_frames // vq_strides[i]) codes of `prev_codes`, and
        the context's context_frames x hop samples are cut from the front.
        -> (new audio (B, samples, 1), context codes for the next call:
        each level's last context_frames codes)."""
        codes = self._codes(codes)
        new_context = [x[:, -context_frames:] if x.shape[1] > context_frames
                       else x for x in codes]
        if prev_codes is None:
            return self.decode(codes), new_context
        combined = []
        for stride, prev, new in zip(self.config.vq_strides,
                                     self._codes(prev_codes), codes):
            layer_ctx = max(1, context_frames // stride)
            if prev.shape[1] > layer_ctx:
                prev = prev[:, -layer_ctx:]
            combined.append(torch.cat([prev, new], dim=1))
        audio = self.decode(combined)
        context_samples = context_frames * self.hop_length
        if audio.shape[1] > context_samples:
            audio = audio[:, context_samples:]
        return audio, new_context

    def forward(self, audio) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        codes = self.encode(audio)
        return self.decode(codes), codes

    # -- weights ------------------------------------------------------------

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """A torch SNAC checkpoint -> the JAX tree (:326-364), which
        `load_jax_params` binds: weight norm folded from `weight_g`/
        `weight_v` or `parametrizations.weight.original0/1`; conv kernels
        to WIO and the decoder's upsamplers (by the anchored pattern) to
        the pre-flipped transposed layout; snake alphas (1, C, 1) to
        (C,)."""
        from ....tts.models.kokoro.istftnet import fold_weight_norm

        def layout(base: str, w) -> np.ndarray:
            if _is_decoder_upsampler(base):
                return convert_torch_conv_transpose_weight(w)
            return np.transpose(np.asarray(w), (2, 1, 0))

        out: Dict[str, np.ndarray] = {}
        gs = {k: v for k, v in weights.items() if k.endswith("weight_g")}
        for k, w in weights.items():
            if k.endswith(("weight_g", "parametrizations.weight.original0")):
                continue
            if k.endswith("parametrizations.weight.original1"):
                base = k[: -len(".parametrizations.weight.original1")]
                g = weights.get(base + ".parametrizations.weight.original0")
                k = base + ".weight_v"
                if g is not None:
                    gs[base + ".weight_g"] = g
            if k.endswith("weight_v"):
                base = k[: -len(".weight_v")]
                g = gs.get(base + ".weight_g")
                folded = (fold_weight_norm(g, w) if g is not None
                          else np.asarray(w))
                out[base + ".weight"] = layout(base, folded)
                continue
            w = np.asarray(w)
            if k.endswith("alpha") and w.ndim == 3:
                out[k] = w.reshape(-1)
            elif k.endswith(".weight") and w.ndim == 3:
                out[k] = layout(k[: -len(".weight")], w)
            else:
                out[k] = w
        return out


Model = SNAC

__all__ = ["SNAC", "Model", "ModelConfig", "convert_torch_conv_transpose_weight"]
