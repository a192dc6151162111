"""Descript Audio Codec (DAC): a residual-VQ codec at 16, 24 or 44.1 kHz,
the codec under OuteTTS.

Counterpart of mlx_audio_tpu/codec/models/descript/dac.py: `ModelConfig`
with its HF `DacConfig` schema (:42-74), the encoder, quantizer and decoder
trees (:77-136), `preprocess`, `encode` (:161), `from_codes` (:186),
`decode` (:196), the HF `DacModel` key remap `_remap_hf` (:219-268) and
`sanitize` (:269-279), which reuses SNAC's. On channel-last (B, T, C)
tensors, built from the shared codec blocks (`codec/models/blocks.py`);
parameter names are the JAX tree's, so `model.load_jax_params` binds that
tree and `sanitize` gives it from a torch checkpoint.

DAC is SNAC without the multi-scale VQ strides, the noise blocks and the
depthwise convs. Its channels (1,536 down to 96 at the published dims)
are no kernel's: the JAX DAC calls none, and the convs here are cuDNN's.

Departure from the JAX package: `sanitize` folds an HF checkpoint's
weight-norm pairs (`weight_g`/`weight_v`, or the parametrization form)
before the HF key remap. JAX's remap matches only `.weight` and `.bias`
leaves, so such a checkpoint's conv names pass it unmapped and fail to
bind there.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Conv1d, ConvTranspose1d, Embedding
from ..blocks import (ResidualUnit, Snake, apply_residual_unit, apply_snake,
                      fold_torch_weight_norm, vq_encode)

DILATIONS = (1, 3, 9)


@dataclass
class ModelConfig(BaseModelArgs):
    encoder_dim: int = 64
    encoder_rates: List[int] = field(default_factory=lambda: [2, 4, 5, 8])
    latent_dim: Optional[int] = None
    decoder_dim: int = 1536
    decoder_rates: List[int] = field(default_factory=lambda: [8, 5, 4, 2])
    n_codebooks: int = 32
    codebook_size: int = 1024
    codebook_dim: int = 8
    sample_rate: int = 44100
    model_path: str = ""

    @classmethod
    def from_dict(cls, config: dict):
        """The native descript field names, or the HF transformers
        `DacConfig` schema (descript/dac_* hub repos)."""
        if isinstance(config, dict) and ("encoder_hidden_size" in config
                                         or "downsampling_ratios" in config):
            return cls(
                encoder_dim=config.get("encoder_hidden_size", 64),
                encoder_rates=list(config.get("downsampling_ratios",
                                              [2, 4, 8, 8])),
                latent_dim=config.get("hidden_size"),
                decoder_dim=config.get("decoder_hidden_size", 1536),
                decoder_rates=list(config.get("upsampling_ratios",
                                              [8, 8, 4, 2])),
                n_codebooks=config.get("n_codebooks", 9),
                codebook_size=config.get("codebook_size", 1024),
                codebook_dim=config.get("codebook_dim", 8),
                sample_rate=config.get("sampling_rate", 44100),
                model_path=config.get("model_path", ""))
        return super().from_dict(config)


class DAC(TorchModel):
    """The DAC codec on `device` (the card by default; without CUDA the
    constructor raises unless given `device="cpu"`)."""

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
                half = d // 2
                enc[str(len(enc))] = holder(block=nn.ModuleDict({
                    "0": ResidualUnit(half), "1": ResidualUnit(half),
                    "2": ResidualUnit(half), "3": Snake(half),
                    "4": Conv1d(half, d, 2 * stride)}))
            enc[str(len(enc))] = Snake(d)
            enc[str(len(enc))] = Conv1d(d, self.latent_dim, 3)
            self.encoder = nn.ModuleDict(enc)
            self.quantizer = nn.ModuleDict({str(i): holder(
                in_proj=Conv1d(self.latent_dim, c.codebook_dim, 1),
                out_proj=Conv1d(c.codebook_dim, self.latent_dim, 1),
                codebook=Embedding(c.codebook_size, c.codebook_dim))
                for i in range(c.n_codebooks)})
            dec = {"0": Conv1d(self.latent_dim, c.decoder_dim, 7)}
            out_dim = c.decoder_dim
            for i, stride in enumerate(c.decoder_rates):
                in_dim = c.decoder_dim // (2 ** i)
                out_dim = c.decoder_dim // (2 ** (i + 1))
                dec[str(len(dec))] = holder(block=nn.ModuleDict({
                    "0": Snake(in_dim),
                    "1": ConvTranspose1d(in_dim, out_dim, 2 * stride),
                    "2": ResidualUnit(out_dim), "3": ResidualUnit(out_dim),
                    "4": ResidualUnit(out_dim)}))
            dec[str(len(dec))] = Snake(out_dim)
            dec[str(len(dec))] = Conv1d(out_dim, 1, 7)
            self.decoder = nn.ModuleDict(dec)
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    # -- pipeline -----------------------------------------------------------

    def preprocess(self, audio: torch.Tensor) -> torch.Tensor:
        """Right-pad the last axis to a multiple of the hop."""
        pad = (-audio.shape[-1]) % self.hop_length
        return torch.nn.functional.pad(audio, (0, pad))

    def encode_latent(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T) -> latent (B, T / hop, D)."""
        c, enc = self.config, self.encoder
        x = enc["0"](audio[..., None], padding=3)
        for i, stride in enumerate(c.encoder_rates):
            blk = enc[str(i + 1)].block
            for j, dil in zip("012", DILATIONS):
                x = apply_residual_unit(blk[j], x, dil)
            x = apply_snake(blk["3"], x)
            x = blk["4"](x, stride=stride, padding=math.ceil(stride / 2))
        idx = len(c.encoder_rates) + 1
        x = apply_snake(enc[str(idx)], x)
        return enc[str(idx + 1)](x, padding=1)

    def _audio(self, audio) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(
            audio, torch.Tensor) else audio, device=self.device).float()
        if x.ndim == 3:
            x = x[:, 0]
        elif x.ndim == 1:
            x = x[None]
        return x.to(self.encoder["0"].weight.dtype)

    @torch.no_grad()
    def encode(self, audio, n_quantizers: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 1, T), (B, T) or (T,) audio -> (z_q (B, T', D), codes
        (B, n_quantizers, T') int64)."""
        z = self.encode_latent(self.preprocess(self._audio(audio)))
        nq = n_quantizers or self.config.n_codebooks
        codes = []
        z_q = torch.zeros_like(z)
        residual = z
        for i in range(nq):
            q = self.quantizer[str(i)]
            idx = vq_encode(q.in_proj(residual), q.codebook.weight,
                            normalized=True)
            codes.append(idx)
            z_q_i = q.out_proj(q.codebook(idx))
            z_q = z_q + z_q_i
            residual = residual - z_q_i
        return z_q, torch.stack(codes, dim=1)

    @torch.no_grad()
    def from_codes(self, codes) -> torch.Tensor:
        """codes (B, nq, T) -> latent z_q (B, T, D)."""
        codes = torch.as_tensor(np.asarray(codes) if not isinstance(
            codes, torch.Tensor) else codes, device=self.device).long()
        z_q = None
        for i in range(codes.shape[1]):
            q = self.quantizer[str(i)]
            z_q_i = q.out_proj(q.codebook(codes[:, i]))
            z_q = z_q_i if z_q is None else z_q + z_q_i
        return z_q

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent (B, T, D) -> audio (B, T * hop, 1) in [-1, 1] (tanh)."""
        c, dec = self.config, self.decoder
        x = dec["0"](z, padding=3)
        for i, stride in enumerate(c.decoder_rates):
            blk = dec[str(i + 1)].block
            x = apply_snake(blk["0"], x)
            x = blk["1"](x, stride=stride, padding=math.ceil(stride / 2),
                         output_padding=stride % 2)
            for j, dil in zip("234", DILATIONS):
                x = apply_residual_unit(blk[j], x, dil)
        idx = len(c.decoder_rates) + 1
        x = apply_snake(dec[str(idx)], x)
        return torch.tanh(dec[str(idx + 1)](x, padding=3))

    def forward(self, audio) -> Tuple[torch.Tensor, torch.Tensor]:
        z_q, codes = self.encode(audio)
        return self.decode(z_q), codes

    # -- weights ------------------------------------------------------------

    def _remap_hf(self, weights: Dict) -> Dict:
        """HF-transformers `DacModel` keys (descript/dac_* hub repos) -> the
        native descript Sequential-index names this tree uses; the layouts
        are converted in SNAC's sanitize."""
        r_enc = len(self.config.encoder_rates)
        r_dec = len(self.config.decoder_rates)
        out = {}
        for k, w in weights.items():
            m = re.match(
                r"^(encoder|decoder)\.block\.(\d+)\."
                r"(?:res_unit(\d)\.(snake|conv)(\d)|"
                r"(snake1)\.alpha|(conv1|conv_t1)\.(weight|bias))"
                r"(?:\.(alpha|weight|bias))?$", k)
            if m:
                side, i = m.group(1), int(m.group(2))
                stage = f"{side}.{i + 1}.block"
                if m.group(3):  # res_unitR.snakeN / convN
                    r = int(m.group(3)) - 1
                    base = r if side == "encoder" else r + 2
                    kind, n = m.group(4), int(m.group(5))
                    inner = {("snake", 1): "0.alpha", ("conv", 1): "1",
                             ("snake", 2): "2.alpha", ("conv", 2): "3"}[
                                 (kind, n)]
                    key = f"{stage}.{base}.block.{inner}"
                    out[key if kind == "snake" else f"{key}.{m.group(9)}"] = w
                elif m.group(6):  # the stage's snake1
                    out[f"{stage}.{3 if side == 'encoder' else 0}.alpha"] = w
                else:  # the stage's conv1 / conv_t1
                    idx = 4 if side == "encoder" else 1
                    out[f"{stage}.{idx}.{m.group(8)}"] = w
                continue
            m = re.match(r"^(encoder|decoder)\.(conv1|conv2|snake1)\."
                         r"(weight|bias|alpha)$", k)
            if m:
                side, part, leaf = m.groups()
                last = r_enc if side == "encoder" else r_dec
                idx = {"conv1": 0, "snake1": last + 1, "conv2": last + 2}[
                    part]
                out[f"{side}.{idx}.{leaf}"] = w
                continue
            m = re.match(r"^quantizer\.quantizers\.(\d+)\.(.+)$", k)
            if m:
                out[f"quantizer.{m.group(1)}.{m.group(2)}"] = w
                continue
            out[k] = w
        return out

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """A torch DAC checkpoint (descript's names, or HF `DacModel`'s,
        remapped after its weight-norm pairs are folded) -> the JAX tree,
        through SNAC's sanitize: conv kernels to WIO, the decoder's
        upsamplers to the pre-flipped transposed layout, snake alphas to
        (C,)."""
        from ..snac.snac import SNAC

        weights = fold_torch_weight_norm(weights)
        if any(k.startswith("quantizer.quantizers.") or ".res_unit1." in k
               for k in weights):
            weights = self._remap_hf(weights)
        return SNAC.sanitize(self, weights)


Model = DAC

__all__ = ["DAC", "Model", "ModelConfig"]
