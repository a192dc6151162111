"""The LFM2.5-Audio detokenizer: Mimi codes -> 24 kHz waveform through an
ISTFT head.

Counterpart of mlx_audio_tpu/sts/models/lfm_audio/detokenizer.py:

* `DetokenizerConfig` (copied);
* the embedding of the codes (the mean over the codebooks of one table
  at offset rows), a nearest 6x upsample, an LFM2-style backbone of gated
  short convs (`_conv_block` :100) and causal 30-frame sliding-window
  attention (`_sliding_attention` :112), its final RMS norm, then a linear
  head to 641 log-magnitudes and 641 phases and a COLA-normalised ISTFT
  with n_fft 1,280 and hop 320 (`detokenize_frames` :149; the port's
  `dsp.irfft_pair` and `dsp.overlap_add`);
* `LFM2AudioDetokenizer` (:185) and its `sanitize` (:218).

The JAX package compiles codes -> waveform once per frame count; here it
runs eagerly on the model's device.

Departure: `sanitize` reads a short conv's taps from the layout their
shape shows (torch (D, 1, K), MLX (D, K, 1) or the JAX tree's (K, D)),
where JAX's reads every 3-D one as torch's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....dsp import irfft_pair, overlap_add
from ....model import TorchModel, check_device
from ....nn import Embedding, Linear, RMSNorm
from ....ops.attention import attention
from ....ops.rope import rope_freqs
from .lfm2 import QKNormAttention, ShortConv, SwiGLU, init_short_convs

_DEFAULT_LAYER_TYPES = ("conv", "conv", "sliding_attention", "conv",
                        "sliding_attention", "conv", "sliding_attention",
                        "conv")


@dataclass
class DetokenizerConfig(BaseModelArgs):
    hidden_size: int = 512
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    layer_types: Tuple[str, ...] = _DEFAULT_LAYER_TYPES
    sliding_window: int = 30
    intermediate_size: int = 2304
    norm_eps: float = 1e-5
    rope_theta: float = 1000000.0
    output_size: int = 1282
    num_codebooks: int = 8
    vocab_size: int = 2048
    n_fft: int = 1280
    hop_length: int = 320
    upsample_factor: int = 6
    conv_kernel: int = 3

    def __post_init__(self):
        if isinstance(self.layer_types, list):
            self.layer_types = tuple(self.layer_types)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class DetokBlock(nn.Module):
    def __init__(self, c: DetokenizerConfig, kind: str):
        super().__init__()
        d = c.hidden_size
        self.operator_norm = RMSNorm(d, c.norm_eps)
        self.ffn_norm = RMSNorm(d, c.norm_eps)
        self.feed_forward = SwiGLU(d, c.intermediate_size)
        if kind == "conv":
            self.conv = ShortConv(d, c.conv_kernel, bias=False)
        else:
            self.self_attn = QKNormAttention(
                d, c.num_attention_heads, c.num_key_value_heads, c.head_dim,
                c.norm_eps)


def short_conv_taps(name: str, v: np.ndarray, k: int, d: int) -> np.ndarray:
    """A short conv's taps as the JAX leaf (K, D), from torch's (D, 1, K),
    MLX's (D, K, 1) or (K, D) itself; any other shape raises."""
    v = np.asarray(v)
    if v.shape == (d, 1, k):
        return v[:, 0].T
    if v.shape == (d, k, 1):
        return v[:, :, 0].T
    if v.shape == (k, d):
        return v
    raise ValueError(f"{name}: shape {v.shape} is none of torch's "
                     f"{(d, 1, k)}, MLX's {(d, k, 1)} or {(k, d)}")


class LFM2AudioDetokenizer(TorchModel):
    """Codes -> 24 kHz waveform on `device`: the card by default; without
    CUDA the constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[DetokenizerConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = DetokenizerConfig.from_dict(kwargs) if kwargs else \
                DetokenizerConfig()
        elif isinstance(config, dict):
            config = DetokenizerConfig.from_dict(config)
        super().__init__(config)
        c = config
        with torch.device(device):
            self.emb = Embedding(c.num_codebooks * c.vocab_size,
                                 c.hidden_size)
            self.layers = nn.ModuleList(DetokBlock(c, kind)
                                        for kind in c.layer_types)
            self.embedding_norm = RMSNorm(c.hidden_size, c.norm_eps)
            self.lin = Linear(c.hidden_size, c.output_size)
        n = c.n_fft
        self._window = (0.5 - 0.5 * np.cos(2 * math.pi * np.arange(n) / n)
                        ).astype(np.float32)
        self.register_buffer("inv_freq", rope_freqs(c.head_dim, c.rope_theta)
                             .to(device), persistent=False)
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    on_device: bool = False) -> "LFM2AudioDetokenizer":
        """`TorchModel.init_params`, then the short convs' taps (N(0, 1) /
        K, as the JAX package draws them)."""
        super().init_params(seed, on_device)
        init_short_convs(self, seed, on_device)
        return self

    @property
    def window(self) -> np.ndarray:
        return np.asarray(self._window, np.float32)

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        b, t, _ = x.shape
        d_idx = torch.arange(t, device=x.device)[:, None] \
            - torch.arange(t, device=x.device)[None, :]
        valid = (d_idx >= 0) & (d_idx < c.sliding_window)
        mask = torch.where(valid, 0.0, float("-inf"))
        pos = torch.arange(t, device=x.device)
        for blk, kind in zip(self.layers, c.layer_types):
            h = blk.operator_norm(x)
            if kind == "conv":
                h = blk.conv(h)
            else:
                a = blk.self_attn
                q, kk, v = a.qkv(h, pos, self.inv_freq)
                h = a.out_proj(attention(q, kk, v, mask=mask).reshape(b, t,
                                                                      -1))
            x = x + h
            x = x + blk.feed_forward(blk.ffn_norm(x))
        return self.embedding_norm(x)

    def detokenize_frames(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, K, T) int -> waveform (B, T * up * hop), f32."""
        c = self.config
        b, kk, t = codes.shape
        offsets = torch.arange(kk, device=codes.device)[None, :, None] \
            * c.vocab_size
        emb = self.emb((codes + offsets).reshape(b, -1))
        x = emb.reshape(b, kk, t, c.hidden_size).mean(dim=1)
        x = torch.repeat_interleave(x, c.upsample_factor, dim=1)
        spec = self.lin(self.backbone(x)).float()       # (B, T', 1282)
        n_bins = c.n_fft // 2 + 1
        log_mag = torch.clamp(spec[..., :n_bins], -30.0, 20.0)
        phase = spec[..., n_bins:]
        mag = torch.exp(log_mag)
        frames = irfft_pair(mag * torch.cos(phase), mag * torch.sin(phase),
                            n=c.n_fft)
        n_frames = frames.shape[1]
        win = torch.from_numpy(self.window).to(frames.device)
        rec = overlap_add(frames * win, c.hop_length, c.n_fft)
        env = np.zeros((n_frames - 1) * c.hop_length + c.n_fft, np.float64)
        w2 = self.window.astype(np.float64) ** 2
        for i in range(n_frames):
            env[i * c.hop_length: i * c.hop_length + c.n_fft] += w2
        env = torch.from_numpy(np.where(env > 1e-10, env, 1.0).astype(
            np.float32)).to(rec.device)
        rec = rec / env
        pad = (c.n_fft - c.hop_length) // 2
        return rec[:, pad:-pad] if pad else rec

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """Checkpoint names -> the JAX tree's (`emb.emb.` -> `emb.`, `lfm.`
        dropped, `o_proj` -> `out_proj`; the unused `lfm.embed_tokens`
        skipped); `istft.window` kept as the window; each short conv's
        taps read into (K, D) from the layout their shape shows."""
        c = self.config
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if k == "istft.window":
                self._window = np.asarray(v, np.float32)
                continue
            if k.startswith("lfm.embed_tokens"):
                continue  # unused table (reference detokenizer.py:333-335)
            k = k.replace("emb.emb.", "emb.")
            k = k.replace("lfm.layers.", "layers.")
            k = k.replace("lfm.embedding_norm.", "embedding_norm.")
            k = k.replace(".self_attn.o_proj.", ".self_attn.out_proj.")
            if k.endswith("conv.conv.weight") or k.endswith("conv.weight"):
                k = k.replace("conv.conv.weight", "conv.weight")
                v = short_conv_taps(k, v, c.conv_kernel, c.hidden_size)
            out[k] = v
        return out

    @torch.inference_mode()
    def __call__(self, codes) -> np.ndarray:
        """codes (B, K, T) or (K, T) -> waveform (B, samples), f32 numpy."""
        codes = torch.as_tensor(np.asarray(codes) if not isinstance(
            codes, torch.Tensor) else codes).to(self.device, torch.long)
        if codes.ndim == 2:
            codes = codes[None]
        return self.detokenize_frames(codes).cpu().numpy()


__all__ = ["DetokenizerConfig", "LFM2AudioDetokenizer", "short_conv_taps"]
