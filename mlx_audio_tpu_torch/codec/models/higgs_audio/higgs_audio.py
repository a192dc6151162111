"""Higgs Audio v2 acoustic tokenizer: a DAC encoder and decoder, an 8-book
residual VQ, and a HuBERT semantic branch fused into the encoder.

Counterpart of mlx_audio_tpu/codec/models/higgs_audio/higgs_audio.py:

* decode (`Model.decode`, :306-325): per book, codebook row -> project_out,
  summed (`rvq_decode`, :174-182) -> fc2 (1024 -> 256) -> the DAC decoder
  (`acoustic_decode`, :200-213: conv k7, then per stride a snake, a
  transposed conv of width 2s whose output is cut to t_in * s, and three
  residual units of dilations 1, 3, 9; snake, conv k7). Exact token length,
  no bucket padding: the decoder is not causal;
* encode (`Model.encode`, :327-360): the 24 kHz wave resampled to 16 kHz
  (`utils.resample_audio`) and padded by downsample_factor / 2 each side ->
  the mean of ALL HuBERT hidden states (`hubert_hidden_mean`, :230-265) ->
  every semantic_downsample_factor-th frame -> the semantic CNN
  (`semantic_encode`, :268-286); the 24 kHz wave -> the DAC encoder
  (`acoustic_encode`, :216-227); both cut to the shorter, concatenated, fc
  -> residual nearest-codebook quantization (`rvq_encode`, :185-197).
  Without `semantic_model_config` it raises, as JAX's;
* `sanitize` (:362-434): the checkpoint's keep and drop rules, codebook
  `embed` -> `weight`, snake alphas flattened; conv kernels stay in torch's
  layouts ((O, I, K), and (I, O, K) for the transposed convs), each checked
  against the width `_expected_kernel` gives.

Activations are channel-last (B, T, C); the convs are cuDNN's. The snake ->
conv legs here are plain PyTorch: the JAX package computes them outside
Pallas too (:89-97), so kernel K1 is not on this path.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Conv1d, ConvTranspose1d, Embedding, Linear
from ....stt.models.wav2vec.wav2vec import (ModelConfig as W2VConfig,
                                            Wav2Vec2Model, _embed,
                                            encoder_layer, sanitize_wav2vec2)
from ..blocks import Snake


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "higgs_audio_v2_tokenizer"
    sample_rate: int = 24000
    codebook_size: int = 1024
    codebook_dim: int = 64
    downsample_factor: int = 320
    dac_num_codebooks: int = 8
    dac_encoder_ratios: List[int] = field(
        default_factory=lambda: [8, 5, 4, 2, 3])
    dac_encoder_hidden: int = 64
    dac_decoder_hidden: int = 1024
    latent_dim: int = 1024
    fusion_dim: int = 256
    semantic_sample_rate: int = 16000
    semantic_model_config: Optional[Dict[str, Any]] = None
    strides: List[int] = field(default_factory=lambda: [1, 1])
    block_dilations: List[int] = field(default_factory=lambda: [1, 1])
    channel_ratios: List[int] = field(default_factory=lambda: [1, 1])
    kernel_size: int = 3
    unit_kernel_size: int = 3
    model_path: str = ""

    @property
    def acoustic_hop(self) -> int:
        return math.prod(self.dac_encoder_ratios)

    @property
    def semantic_downsample_factor(self) -> int:
        hubert_fps = self.semantic_sample_rate / self.downsample_factor
        acoustic_fps = self.sample_rate / self.acoustic_hop
        return max(1, round(hubert_fps / acoustic_fps))


# ---------------------------------------------------------------- modules


class ResUnit(nn.Module):
    """Snake -> conv k7 (dilated) -> snake -> conv 1x1, plus the input."""

    def __init__(self, dim: int):
        super().__init__()
        self.snake1 = Snake(dim)
        self.conv1 = Conv1d(dim, dim, 7)
        self.snake2 = Snake(dim)
        self.conv2 = Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor, dilation: int) -> torch.Tensor:
        # centred padding (k - 1) * d / 2 keeps the length
        y = self.conv1(self.snake1(x), padding=3 * dilation,
                       dilation=dilation)
        return x + self.conv2(self.snake2(y))


def _res_units(dim: int) -> Dict[str, ResUnit]:
    return {f"res_unit{j}": ResUnit(dim) for j in (1, 2, 3)}


def _acoustic_encoder(cfg: ModelConfig) -> nn.Module:
    eh = cfg.dac_encoder_hidden
    ch = [eh * 2 ** i for i in range(len(cfg.dac_encoder_ratios) + 1)]
    blocks = nn.ModuleList(
        holder(**_res_units(ch[i]), snake1=Snake(ch[i]),
                conv1=Conv1d(ch[i], ch[i + 1], 2 * s))
        for i, s in enumerate(cfg.dac_encoder_ratios))
    return holder(conv1=Conv1d(1, ch[0], 7), block=blocks,
                   snake1=Snake(ch[-1]),
                   conv2=Conv1d(ch[-1], cfg.fusion_dim, 3))


def _acoustic_decoder(cfg: ModelConfig) -> nn.Module:
    dh = cfg.dac_decoder_hidden
    c_in = [dh // 2 ** i for i in range(len(cfg.dac_encoder_ratios))]
    c_out = [c // 2 for c in c_in]
    blocks = nn.ModuleList(
        holder(snake1=Snake(c_in[i]),
                conv_t1=ConvTranspose1d(c_in[i], c_out[i], 2 * s),
                **_res_units(c_out[i]))
        for i, s in enumerate(cfg.dac_encoder_ratios))
    return holder(conv1=Conv1d(cfg.fusion_dim, dh, 7), block=blocks,
                   snake1=Snake(c_out[-1]), conv2=Conv1d(c_out[-1], 1, 7))


def _semantic_encoder(cfg: ModelConfig, hs: int) -> nn.Module:
    blocks = nn.ModuleList()
    for _, _, r in zip(cfg.strides, cfg.block_dilations, cfg.channel_ratios):
        dim = hs * r
        units = nn.ModuleList(
            holder(conv1=Conv1d(dim, dim, cfg.unit_kernel_size, bias=False),
                    conv2=Conv1d(dim, dim, 1, bias=False))
            for _ in range(2))
        blocks.append(holder(res_units=units,
                              conv=Conv1d(dim, dim, cfg.kernel_size)))
    return holder(conv=Conv1d(hs, hs, cfg.kernel_size, bias=False),
                   conv_blocks=blocks)


# ------------------------------------------------------------------ paths


def rvq_decode(quantizer: nn.Module, codes: torch.Tensor,
               n_books: int) -> torch.Tensor:
    """codes (B, T, n_books) -> (B, T, latent_dim)."""
    out = None
    for i in range(n_books):
        q = quantizer.quantizers[i]
        e = q.project_out(F.embedding(codes[..., i].long(),
                                      q.codebook.weight))
        out = e if out is None else out + e
    return out


def rvq_encode(quantizer: nn.Module, z: torch.Tensor,
               n_books: int) -> torch.Tensor:
    """(B, T, latent_dim) -> int32 codes (B, T, n_books): per book the
    nearest codebook row of the projected residual (first on ties)."""
    residual = z
    codes = []
    for i in range(n_books):
        q = quantizer.quantizers[i]
        zq = q.project_in(residual)
        cb = q.codebook.weight.to(zq.dtype)
        d = ((zq * zq).sum(-1, keepdim=True) - 2 * (zq @ cb.T)
             + (cb * cb).sum(-1)[None, None])
        idx = torch.argmin(d, dim=-1)
        codes.append(idx)
        residual = residual - q.project_out(cb[idx])
    return torch.stack(codes, dim=-1).to(torch.int32)


def acoustic_decode(p: nn.Module, cfg: ModelConfig,
                    z: torch.Tensor) -> torch.Tensor:
    """(B, T, fusion_dim) -> (B, T * hop, 1)."""
    x = p.conv1(z, padding=3)
    for blk, s in zip(p.block, cfg.dac_encoder_ratios):
        t_in = x.shape[1]
        x = blk.conv_t1(blk.snake1(x), stride=s, padding=s // 2)
        x = x[:, : t_in * s]
        for j, dil in enumerate((1, 3, 9)):
            x = getattr(blk, f"res_unit{j + 1}")(x, dil)
    return p.conv2(p.snake1(x), padding=3)


def acoustic_encode(p: nn.Module, cfg: ModelConfig,
                    wav: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) -> (B, T // hop, fusion_dim)."""
    x = p.conv1(wav, padding=3)
    for blk, s in zip(p.block, cfg.dac_encoder_ratios):
        for j, dil in enumerate((1, 3, 9)):
            x = getattr(blk, f"res_unit{j + 1}")(x, dil)
        x = blk.conv1(blk.snake1(x), stride=s, padding=math.ceil(s / 2))
    return p.conv2(p.snake1(x), padding=1)


def hubert_hidden_mean(model: Wav2Vec2Model, cfg: W2VConfig,
                       wave: torch.Tensor, num_samples) -> torch.Tensor:
    """The mean over ALL encoder hidden states (HF output_hidden_states:
    the input of the first layer and the output of every layer)."""
    x, _, valid, mask = _embed(model, cfg, wave, num_samples)
    bias_mask = torch.where(valid, 0.0, torch.finfo(x.dtype).min).to(x.dtype)
    acc = x
    for lp in model.encoder.layers:
        x = encoder_layer(lp, cfg, x, bias_mask, mask)
        acc = acc + x
    return acc / (cfg.num_hidden_layers + 1)


def semantic_encode(p: nn.Module, cfg: ModelConfig,
                    feats: torch.Tensor) -> torch.Tensor:
    """(B, T, H) HuBERT features -> (B, T', H) (the SemanticEncoder CNN)."""
    pad = (cfg.kernel_size - 1) // 2
    x = p.conv(feats, padding=pad)
    for blk, s, d in zip(p.conv_blocks, cfg.strides, cfg.block_dilations):
        for ru in blk.res_units:
            upad = (cfg.unit_kernel_size - 1) * d // 2
            y = ru.conv1(F.elu(x), padding=upad, dilation=d)
            x = x + ru.conv2(F.elu(y))
        x = blk.conv(x, stride=s, padding=pad)
    return x


# ---------------------------------------------------------------- model


class Model(TorchModel):
    """The Higgs Audio v2 tokenizer on `device`: the card by default;
    without CUDA the constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        cfg = config
        with torch.device(device):
            self.acoustic_encoder = _acoustic_encoder(cfg)
            self.acoustic_decoder = _acoustic_decoder(cfg)
            self.quantizer = holder(quantizers=nn.ModuleList(
                holder(project_in=Linear(cfg.latent_dim, cfg.codebook_dim),
                        codebook=Embedding(cfg.codebook_size,
                                           cfg.codebook_dim),
                        project_out=Linear(cfg.codebook_dim, cfg.latent_dim))
                for _ in range(cfg.dac_num_codebooks)))
            self.fc2 = Linear(cfg.latent_dim, cfg.fusion_dim)
            if cfg.semantic_model_config is not None:
                w2v = W2VConfig.from_dict(cfg.semantic_model_config)
                hs = w2v.hidden_size
                self.semantic_model = Wav2Vec2Model(w2v, device=device)
                self.encoder_semantic = _semantic_encoder(cfg, hs)
                self.fc = Linear(hs + cfg.fusion_dim, hs + cfg.fusion_dim)
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    on_device: bool = False) -> "Model":
        """Random weights (TorchModel.init_params); codebook rows N(0, 0.1)
        as init_higgs draws them."""
        super().init_params(seed, on_device)
        for q in self.quantizer.quantizers:
            q.codebook.weight.mul_(5.0)
        return self

    @torch.no_grad()
    def decode(self, tokens) -> np.ndarray:
        """(T, n_books) int codes (or (1, T, n_books)) -> (T * hop,) f32
        waveform, at the exact length."""
        cfg = self.config
        codes = torch.as_tensor(np.asarray(tokens, np.int64),
                                device=self.device)
        if codes.ndim == 2:
            codes = codes[None]
        n = codes.shape[1]
        z = self.fc2(rvq_decode(self.quantizer, codes, cfg.dac_num_codebooks))
        wav = acoustic_decode(self.acoustic_decoder, cfg, z)
        return wav[0, : n * cfg.acoustic_hop, 0].float().cpu().numpy()

    @torch.no_grad()
    def encode(self, waveform) -> np.ndarray:
        """(T,) 24 kHz waveform -> (T', n_books) int32 codes."""
        cfg = self.config
        if not hasattr(self, "semantic_model"):
            raise RuntimeError("encode requires semantic_model_config "
                               "(HuBERT weights) in the checkpoint")
        from ....utils import resample_audio

        wav = np.asarray(waveform, np.float32).reshape(-1)
        wav16 = np.asarray(resample_audio(wav, cfg.sample_rate,
                                          cfg.semantic_sample_rate),
                           np.float32)
        pad = cfg.downsample_factor // 2
        wav16 = np.pad(wav16, (pad, pad))
        dev = self.device
        w2v = self.semantic_model.config
        sem = hubert_hidden_mean(self.semantic_model, w2v,
                                 torch.from_numpy(wav16)[None].to(dev),
                                 torch.tensor([len(wav16)], device=dev))
        sem = sem[:, ::cfg.semantic_downsample_factor]
        sem = semantic_encode(self.encoder_semantic, cfg, sem)
        ac = acoustic_encode(self.acoustic_encoder, cfg,
                             torch.from_numpy(wav)[None, :, None].to(dev))
        t = min(sem.shape[1], ac.shape[1])
        emb = self.fc(torch.cat([ac[:, :t], sem[:, :t]], dim=-1))
        codes = rvq_encode(self.quantizer, emb, cfg.dac_num_codebooks)
        return codes[0].cpu().numpy()

    # ---------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict:
        """The published checkpoint -> the port's names (:362-416): keep the
        encoder, decoder, quantizer, fc2 and the semantic branch (HuBERT
        through `sanitize_wav2vec2`); drop `decoder_semantic.`, `fc1.`,
        `masked_spec_embed` and the VQ's training statistics; codebook
        `embed` -> `weight`; snake alphas (1, C, 1) -> (C,). Conv kernels
        keep torch's layouts; a kernel whose width is not the one
        `_expected_kernel` gives raises."""
        keep = ("acoustic_encoder.", "acoustic_decoder.", "quantizer.",
                "fc2.", "semantic_model.", "encoder_semantic.")
        out = {}
        sem_raw = {}
        for k, v in weights.items():
            if k in ("semantic_model.masked_spec_embed",):
                continue
            if k.startswith(("decoder_semantic.", "fc1.")):
                continue
            if not (any(k.startswith(p) for p in keep)
                    or k in ("fc.weight", "fc.bias")):
                continue
            if k.endswith((".embed_avg", ".cluster_size", ".inited")):
                continue
            v = np.asarray(v)
            if k.startswith("semantic_model."):
                sem_raw[k[len("semantic_model."):]] = v
                continue
            if k.endswith(".codebook.embed"):
                k = k[: -len("embed")] + "weight"
            if k.endswith(".weight") and v.ndim == 3:
                kern = self._expected_kernel(k)
                if kern is not None and v.shape[-1] != kern:
                    raise ValueError(f"{k}: kernel {tuple(v.shape)} is not "
                                     f"in torch's layout of width {kern}")
            if k.endswith(".alpha"):
                v = v.reshape(-1)
            out[k] = v
        if sem_raw:
            for k, v in sanitize_wav2vec2(sem_raw,
                                          strip_prefix=False).items():
                out[f"semantic_model.{k}"] = v
        return out

    def _expected_kernel(self, k: str) -> Optional[int]:
        """Kernel width expected at this key (key-aware: tiny configs make
        shape heuristics ambiguous, e.g. a 4-channel k7)."""
        cfg = self.config
        if ".res_unit" in k and ".res_units." not in k:
            return 7 if k.endswith("conv1.weight") else 1
        if ".res_units." in k:
            return cfg.unit_kernel_size if k.endswith("conv1.weight") \
                else 1
        m = re.search(r"\.block\.(\d+)\.conv(?:_t)?1\.weight$", k)
        if m:
            return 2 * cfg.dac_encoder_ratios[int(m.group(1))]
        if k in ("acoustic_encoder.conv1.weight",
                 "acoustic_decoder.conv1.weight",
                 "acoustic_decoder.conv2.weight"):
            return 7
        if k == "acoustic_encoder.conv2.weight":
            return 3
        if k.startswith("encoder_semantic.") and k.endswith(".weight"):
            return cfg.kernel_size
        return None


HiggsAudioTokenizer = Model


__all__ = ["Model", "ModelConfig", "HiggsAudioTokenizer", "rvq_decode",
           "rvq_encode", "acoustic_decode", "acoustic_encode",
           "hubert_hidden_mean", "semantic_encode"]
