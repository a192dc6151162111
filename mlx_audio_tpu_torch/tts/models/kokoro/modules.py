"""Kokoro text encoder and prosody predictor (channel-last, masked).

Counterpart of mlx_audio_tpu/tts/models/kokoro/modules.py. The LSTMs take
validity masks (nn/recurrent.py); every mask here is a prefix.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ....nn import BiLSTM, Conv1d, Embedding, LayerNorm, Linear, layer_norm, leaky_relu
from .istftnet import AdainResBlk1d


class AdaLayerNorm(nn.Module):
    """Channel layer norm with a style-conditioned affine."""

    def __init__(self, style_dim: int, channels: int):
        super().__init__()
        self.fc = Linear(style_dim, channels * 2)

    def forward(self, x, s, eps: float = 1e-5):
        gamma, beta = self.fc(s).chunk(2, dim=-1)
        return (1 + gamma[:, None, :]) * layer_norm(x, eps=eps) + beta[:, None, :]


class TextEncoder(nn.Module):
    def __init__(self, channels: int, kernel_size: int, depth: int,
                 n_symbols: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.embedding = Embedding(n_symbols, channels)
        self.cnn = nn.ModuleList(
            nn.ModuleList([Conv1d(channels, channels, kernel_size),
                           LayerNorm(channels)])
            for _ in range(depth))
        self.lstm = BiLSTM(channels, channels // 2)

    def forward(self, ids, valid):
        """ids (B, L) int; valid (B, L) bool. -> (B, L, C)."""
        pad = (self.kernel_size - 1) // 2
        m = valid[..., None]
        x = torch.where(m, self.embedding(ids), 0.0)
        for conv, norm in self.cnn:
            x = torch.where(m, conv(x, padding=pad), 0.0)
            x = torch.where(m, norm(x), 0.0)
            x = torch.where(m, leaky_relu(x, 0.2), 0.0)
        return torch.where(m, self.lstm(x, valid), 0.0)


class DurationEncoder(nn.Module):
    def __init__(self, sty_dim: int, d_model: int, nlayers: int):
        super().__init__()
        layers = []
        for _ in range(nlayers):
            layers.append(BiLSTM(d_model + sty_dim, d_model // 2))
            layers.append(AdaLayerNorm(sty_dim, d_model))
        self.lstms = nn.ModuleList(layers)

    def forward(self, x, style, valid):
        """x (B, L, d_model); style (B, sty). -> (B, L, d_model + sty)."""
        m = valid[..., None]
        s_b = style[:, None, :].expand(x.shape[0], x.shape[1], style.shape[-1])
        x = torch.where(m, torch.cat([x, s_b], dim=-1), 0.0)
        for i in range(0, len(self.lstms), 2):
            x = self.lstms[i + 1](self.lstms[i](x, valid), style)
            x = torch.where(m, torch.cat([x, s_b], dim=-1), 0.0)
        return x


class _DurationProj(nn.Module):
    def __init__(self, d_hid: int, max_dur: int):
        super().__init__()
        self.linear_layer = Linear(d_hid, max_dur)


class ProsodyPredictor(nn.Module):
    def __init__(self, style_dim: int, d_hid: int, nlayers: int,
                 max_dur: int = 50):
        super().__init__()
        self.text_encoder = DurationEncoder(style_dim, d_hid, nlayers)
        self.lstm = BiLSTM(d_hid + style_dim, d_hid // 2)
        self.duration_proj = _DurationProj(d_hid, max_dur)
        self.shared = BiLSTM(d_hid + style_dim, d_hid // 2)
        self.F0 = nn.ModuleList([
            AdainResBlk1d(d_hid, d_hid, style_dim),
            AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True),
            AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim),
        ])
        self.N = nn.ModuleList([
            AdainResBlk1d(d_hid, d_hid, style_dim),
            AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True),
            AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim),
        ])
        self.F0_proj = Conv1d(d_hid // 2, 1, 1)
        self.N_proj = Conv1d(d_hid // 2, 1, 1)


def float_durations(p: ProsodyPredictor, d, valid) -> torch.Tensor:
    """Float durations before rounding, (B, L): sum of sigmoids of the
    duration head (at speed 1)."""
    x = p.lstm(d, valid)
    return torch.sigmoid(p.duration_proj.linear_layer(x)).sum(dim=-1)


def predict_durations(p: ProsodyPredictor, d, valid, speed: float,
                      max_frames_per_phoneme: int = 100) -> torch.Tensor:
    """d (B, L, d_hid+sty) -> pred_dur (B, L) int64 (modules.py:158-170)."""
    duration = float_durations(p, d, valid) / speed
    duration = torch.nan_to_num(duration, nan=1.0,
                                posinf=max_frames_per_phoneme, neginf=1.0)
    pred = torch.round(duration).clamp(1, max_frames_per_phoneme).long()
    return torch.where(valid, pred, 0)


def f0n_train(p: ProsodyPredictor, en, s,
              frame_valid: Optional[torch.Tensor] = None):
    """en (B, F, d_hid+sty) aligned features -> (F0 (B, 2F), N (B, 2F))."""
    x = p.shared(en, frame_valid)
    up_valid = (None if frame_valid is None
                else frame_valid.repeat_interleave(2, dim=-1))
    outs = []
    for blocks, proj in ((p.F0, p.F0_proj), (p.N, p.N_proj)):
        h = x
        # block 1 upsamples internally, so blocks 0 and 1 take the frame-rate
        # mask and only block 2 runs at the doubled rate
        for i, blk in enumerate(blocks):
            h = blk(h, s, up_valid if i == 2 else frame_valid)
        outs.append(proj(h)[..., 0])
    return outs[0], outs[1]


def build_alignment(pred_dur: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Durations (B, L) -> alignment (B, L, F): frame t belongs to phoneme i
    iff cumsum[i-1] <= t < cumsum[i]."""
    csum = torch.cumsum(pred_dur, dim=-1)
    start = csum - pred_dur
    t = torch.arange(num_frames, device=pred_dur.device)[None, None, :]
    return ((t >= start[..., None]) & (t < csum[..., None])).float()
