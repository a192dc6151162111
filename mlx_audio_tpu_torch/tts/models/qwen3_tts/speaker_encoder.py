"""Qwen3-TTS's ECAPA-TDNN speaker encoder (the x-vector of a reference
clip) and its mel front end.

Counterpart of mlx_audio_tpu/tts/models/qwen3_tts/speaker_encoder.py
(:27-176): TDNN blocks with reflect padding, SE-Res2Net blocks, the
multi-layer feature aggregation, attentive statistics pooling and the
final 1x1 conv (`SpeakerEncoder`, `speaker_encoder_forward`), the slaney
log-mel `speaker_mel` (a reflect-padded, center=False STFT through the
port's `dsp.stft`, magnitudes with 1e-9, the slaney filterbank of
`dsp.mel_filters`, log clipped at 1e-5), and `sanitize_speaker_encoder`.
Channel-last (B, T, C) throughout; conv kernels in torch's layout, so a
checkpoint's `speaker_encoder.*` weights bind as they are. The encoder
runs in f32 whatever the talker's dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....dsp import filters_on, stft
from ....model import TorchModel, holder
from ....nn import Conv1d
from .config import Qwen3TTSSpeakerEncoderConfig


def _reflect_pad_t(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the time axis of (B, T, C)."""
    if pad <= 0:
        return x
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


def _tdnn(p: nn.Module, x: torch.Tensor, kernel: int,
          dilation: int) -> torch.Tensor:
    x = _reflect_pad_t(x, (kernel - 1) * dilation // 2)
    return torch.relu(p.conv(x, dilation=dilation))


def _tdnn_block(in_ch: int, out_ch: int, kernel: int) -> nn.Module:
    return holder(conv=Conv1d(in_ch, out_ch, kernel))


class SpeakerEncoder(TorchModel):
    """init_speaker_encoder's tree: blocks.0 (TDNN), blocks.1..n-2
    (SE-Res2Net), mfa, asp and fc. Built on the current default device."""

    def __init__(self, cfg: Qwen3TTSSpeakerEncoderConfig):
        super().__init__(cfg)
        ch = cfg.enc_channels
        scale = cfg.enc_res2net_scale
        blocks = [_tdnn_block(cfg.mel_dim, ch[0], cfg.enc_kernel_sizes[0])]
        for i in range(1, len(ch) - 1):
            blocks.append(holder(
                tdnn1=_tdnn_block(ch[i - 1], ch[i], 1),
                res2net_block=holder(blocks=nn.ModuleList(
                    _tdnn_block(ch[i] // scale, ch[i] // scale,
                                cfg.enc_kernel_sizes[i])
                    for _ in range(scale - 1))),
                tdnn2=_tdnn_block(ch[i], ch[i], 1),
                se_block=holder(
                    conv1=Conv1d(ch[i], cfg.enc_se_channels, 1),
                    conv2=Conv1d(cfg.enc_se_channels, ch[i], 1))))
        self.blocks = nn.ModuleList(blocks)
        self.mfa = _tdnn_block(sum(ch[1:-1]), ch[-1], cfg.enc_kernel_sizes[-1])
        self.asp = holder(tdnn=_tdnn_block(ch[-1] * 3,
                                           cfg.enc_attention_channels, 1),
                          conv=Conv1d(cfg.enc_attention_channels, ch[-1], 1))
        self.fc = Conv1d(ch[-1] * 2, cfg.enc_dim, 1)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        return speaker_encoder_forward(self, self.config, mels)


def _res2net(p: nn.Module, x: torch.Tensor, scale: int, kernel: int,
             dilation: int) -> torch.Tensor:
    outs, part = [], None
    for i, chunk in enumerate(x.chunk(scale, dim=-1)):
        if i == 0:
            part = chunk
        elif i == 1:
            part = _tdnn(p.blocks[0], chunk, kernel, dilation)
        else:
            part = _tdnn(p.blocks[i - 1], chunk + part, kernel, dilation)
        outs.append(part)
    return torch.cat(outs, dim=-1)


def _se(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    se = torch.relu(p.conv1(x.mean(dim=1, keepdim=True)))
    return x * torch.sigmoid(p.conv2(se))


def _asp(p: nn.Module, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Attentive statistics pooling: (B, T, C) -> (B, 2C)."""
    mean = x.mean(dim=1, keepdim=True)
    std = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + eps)
    attn = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    attn = p.conv(torch.tanh(_tdnn(p.tdnn, attn, 1, 1)))
    attn = torch.softmax(attn, dim=1)
    mean = (attn * x).sum(dim=1)
    var = (attn * (x - mean[:, None]) ** 2).sum(dim=1)
    return torch.cat([mean, torch.sqrt(var.clamp(min=eps))], dim=-1)


def speaker_encoder_forward(p: SpeakerEncoder,
                            cfg: Qwen3TTSSpeakerEncoderConfig,
                            mels: torch.Tensor) -> torch.Tensor:
    """mels (B, T, mel_dim) -> embedding (B, enc_dim)."""
    x = _tdnn(p.blocks[0], mels, cfg.enc_kernel_sizes[0],
              cfg.enc_dilations[0])
    hidden = []
    for i in range(1, len(cfg.enc_channels) - 1):
        b = p.blocks[i]
        res = x
        x = _tdnn(b.tdnn1, x, 1, 1)
        x = _res2net(b.res2net_block, x, cfg.enc_res2net_scale,
                     cfg.enc_kernel_sizes[i], cfg.enc_dilations[i])
        x = _se(b.se_block, _tdnn(b.tdnn2, x, 1, 1)) + res
        hidden.append(x)
    x = _tdnn(p.mfa, torch.cat(hidden, dim=-1), cfg.enc_kernel_sizes[-1],
              cfg.enc_dilations[-1])
    return p.fc(_asp(p.asp, x)[:, None])[:, 0]


def speaker_mel(audio, *, n_fft: int = 1024, num_mels: int = 128,
                sample_rate: int = 24000, hop_size: int = 256,
                win_size: int = 1024, fmin: float = 0.0,
                fmax: float = 12000.0, device="cpu") -> torch.Tensor:
    """The speaker encoder's slaney log-mel: audio (T,) -> (1, frames,
    num_mels) f32 on `device` (the reference's qwen3_tts.py:64 front end)."""
    x = torch.as_tensor(np.asarray(audio, np.float32).reshape(-1),
                        device=device)
    pad = (n_fft - hop_size) // 2
    x = torch.cat([torch.flip(x[1:pad + 1], dims=(0,)), x,
                   torch.flip(x[-(pad + 1):-1], dims=(0,))])
    spec = stft(x, n_fft=n_fft, hop_length=hop_size, win_length=win_size,
                window="hann", center=False)
    mag = torch.sqrt(spec.abs() ** 2 + 1e-9)
    if fmin != 0.0:
        raise ValueError("speaker_mel: fmin other than 0 is not supported")
    fb = filters_on(mag.device, sample_rate, n_fft, num_mels, "slaney",
                    "slaney", False, fmax)
    return torch.log((mag @ fb).clamp(min=1e-5))[None]


def sanitize_speaker_encoder(weights: Dict) -> Dict[str, np.ndarray]:
    """The `speaker_encoder.*` keys of a checkpoint, whose torch layouts are
    the port's."""
    return {k: np.asarray(v) for k, v in weights.items()
            if k.startswith("speaker_encoder.")}


__all__ = ["SpeakerEncoder", "speaker_encoder_forward", "speaker_mel",
           "sanitize_speaker_encoder"]
