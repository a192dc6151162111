"""The ECAPA-TDNN embedding backbone (ECAPA LID runs it).

Counterpart of mlx_audio_tpu/codec/models/ecapa_tdnn/ecapa_tdnn.py:
`EcapaTdnnConfig` (:23-33), inference BatchNorm from running statistics
(:36-43), the TDNN block (a conv zero-padded to keep the length, ReLU, the
norm; :46-55), SE-Res2Net (:91-107), attentive statistics pooling with the
optional global context (:110-136) and the backbone (:58-88). Channel-last
(B, T, C); parameter names are the JAX tree's (`block0.conv`,
`block1.res2net_block.blocks.N`, `asp.tdnn`, `asp_bn`, `fc`), convs in
torch's layout.

Qwen3-TTS's speaker encoder (`tts/models/qwen3_tts/speaker_encoder.py`)
is an ECAPA-TDNN too, but pads by reflection; it stays separate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch
from torch import nn

from ....model import holder
from ....nn import BatchNorm, Conv1d


@dataclass
class EcapaTdnnConfig:
    input_size: int = 60
    channels: int = 1024
    embed_dim: int = 256
    kernel_sizes: List[int] = field(default_factory=lambda: [5, 3, 3, 3, 1])
    dilations: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 1])
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = False


def _tdnn_block(in_ch: int, out_ch: int, kernel: int) -> nn.Module:
    return holder(conv=Conv1d(in_ch, out_ch, kernel), norm=BatchNorm(out_ch))


def tdnn(p: nn.Module, x: torch.Tensor, kernel: int,
         dilation: int = 1) -> torch.Tensor:
    """BatchNorm(ReLU(conv(x))), the conv zero-padded (k - 1) dil / 2 a
    side."""
    pad = (kernel - 1) * dilation // 2
    return p.norm(torch.relu(p.conv(x, padding=pad, dilation=dilation)))


def _se_res2net_block(cfg: EcapaTdnnConfig, kernel: int) -> nn.Module:
    ch = cfg.channels
    hidden = ch // cfg.res2net_scale
    return holder(
        tdnn1=_tdnn_block(ch, ch, 1),
        res2net_block=holder(blocks=nn.ModuleDict({
            str(i): _tdnn_block(hidden, hidden, kernel)
            for i in range(cfg.res2net_scale - 1)})),
        tdnn2=_tdnn_block(ch, ch, 1),
        se_block=holder(conv1=Conv1d(ch, cfg.se_channels, 1),
                        conv2=Conv1d(cfg.se_channels, ch, 1)))


class EcapaBackbone(nn.Module):
    """The backbone's parameters (init_ecapa_backbone, :58-88)."""

    def __init__(self, cfg: EcapaTdnnConfig):
        super().__init__()
        ch = cfg.channels
        self.block0 = _tdnn_block(cfg.input_size, ch, cfg.kernel_sizes[0])
        for i in (1, 2, 3):
            setattr(self, f"block{i}",
                    _se_res2net_block(cfg, cfg.kernel_sizes[i]))
        self.mfa = _tdnn_block(ch * 3, ch * 3, cfg.kernel_sizes[4])
        asp_in = ch * 9 if cfg.global_context else ch * 3
        self.asp = holder(tdnn=_tdnn_block(asp_in, cfg.attention_channels, 1),
                          conv=Conv1d(cfg.attention_channels, ch * 3, 1))
        self.asp_bn = BatchNorm(ch * 6)
        self.fc = Conv1d(ch * 6, cfg.embed_dim, 1)


def _se_res2net(p: nn.Module, x: torch.Tensor, cfg: EcapaTdnnConfig,
                kernel: int, dilation: int) -> torch.Tensor:
    out = tdnn(p.tdnn1, x, 1)
    chunks = out.chunk(cfg.res2net_scale, dim=-1)
    ys = [chunks[0]]
    for i in range(cfg.res2net_scale - 1):
        inp = chunks[i + 1] + ys[-1] if i > 0 else chunks[i + 1]
        ys.append(tdnn(p.res2net_block.blocks[str(i)], inp, kernel,
                       dilation))
    out = tdnn(p.tdnn2, torch.cat(ys, dim=-1), 1)
    s = out.mean(dim=1, keepdim=True)
    s = torch.relu(p.se_block.conv1(s))
    s = torch.sigmoid(p.se_block.conv2(s))
    return out * s + x


def ecapa_backbone(p: EcapaBackbone, cfg: EcapaTdnnConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) -> embedding (B, embed_dim)."""
    out = tdnn(p.block0, x, cfg.kernel_sizes[0], cfg.dilations[0])
    xs = []
    for i in (1, 2, 3):
        out = _se_res2net(getattr(p, f"block{i}"), out, cfg,
                          cfg.kernel_sizes[i], cfg.dilations[i])
        xs.append(out)
    out = tdnn(p.mfa, torch.cat(xs, dim=-1), cfg.kernel_sizes[4],
               cfg.dilations[4])
    # attentive statistics pooling
    if cfg.global_context:
        m = out.mean(dim=1, keepdim=True)
        s = torch.sqrt(out.var(dim=1, keepdim=True, correction=0) + 1e-9)
        attn_in = torch.cat([out, m.expand_as(out), s.expand_as(out)],
                            dim=-1)
    else:
        attn_in = out
    attn = p.asp.conv(torch.tanh(tdnn(p.asp.tdnn, attn_in, 1)))
    attn = torch.softmax(attn, dim=1)
    mean = (attn * out).sum(dim=1)
    var = (attn * out * out).sum(dim=1) - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-9))
    pooled = p.asp_bn(torch.cat([mean, std], dim=-1))
    return p.fc(pooled[:, None, :])[:, 0, :]


__all__ = ["EcapaTdnnConfig", "EcapaBackbone", "ecapa_backbone", "tdnn"]
