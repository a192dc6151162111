"""EnCodec (Meta): a SEANet encoder and decoder around a two-layer
residual LSTM, and a euclidean residual VQ.

Counterpart of mlx_audio_tpu/codec/models/encodec/encodec.py: `ModelConfig`
(:38-60), the trees in the HF `EncodecModel` numbering, where the ELU
modules hold indices of their own (:72-129), the residual block and the
residual LSTM stack (:133-151), `encode_latent`, `decode_latent`,
`encode` (:193), `decode` (:212) and `sanitize` (:229), which maps HF's
LSTM, codebook and transposed-conv keys. On channel-last (B, T, C)
tensors, with the port's Mimi causal convs (`_causal_conv`,
`_causal_tconv`) and cuDNN LSTMs (`nn.LSTM`, one a layer); parameter
names are the JAX tree's, so `model.load_jax_params` binds that tree and
`sanitize` gives it from an HF checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import LSTM, Conv1d, ConvTranspose1d, Embedding
from ..blocks import fold_torch_weight_norm, vq_encode
from ..mimi.mimi import _causal_conv, _causal_tconv, exact_f32


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x, alpha=1.0)


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "encodec"
    audio_channels: int = 1
    num_filters: int = 32
    kernel_size: int = 7
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    codebook_size: int = 1024
    codebook_dim: int = 128
    hidden_size: int = 128
    num_lstm_layers: int = 2
    residual_kernel_size: int = 3
    use_causal_conv: bool = True
    normalize: bool = False
    pad_mode: str = "reflect"
    last_kernel_size: int = 7
    trim_right_ratio: float = 1.0
    compress: int = 2
    upsampling_ratios: List[int] = field(default_factory=lambda: [8, 5, 4, 2])
    sampling_rate: int = 24000
    num_quantizers: int = 32
    model_path: str = ""


def _resnet(c: ModelConfig, dim: int) -> nn.Module:
    hidden = dim // c.compress
    return holder(block=nn.ModuleDict({
        "1": Conv1d(dim, hidden, c.residual_kernel_size),
        "3": Conv1d(hidden, dim, 1)}), shortcut=Conv1d(dim, dim, 1))


def _lstm_stack(c: ModelConfig, dim: int) -> nn.Module:
    return holder(lstm=nn.ModuleDict({str(i): LSTM(dim, dim)
                                      for i in range(c.num_lstm_layers)}))


class Encodec(TorchModel):
    """The EnCodec codec on `device` (the card by default; without CUDA
    the constructor raises unless given `device="cpu"`)."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda"):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        c = config
        self.hop_length = int(np.prod(c.upsampling_ratios))
        with torch.device(device):
            enc = {"0": Conv1d(c.audio_channels, c.num_filters,
                               c.kernel_size)}
            idx, scaling = 1, 1
            for ratio in reversed(c.upsampling_ratios):
                cur = scaling * c.num_filters
                for _ in range(c.num_residual_layers):
                    enc[str(idx)] = _resnet(c, cur)
                    idx += 1
                idx += 1                                  # ELU
                enc[str(idx)] = Conv1d(cur, cur * 2, ratio * 2)
                idx += 1
                scaling *= 2
            top = scaling * c.num_filters
            enc[str(idx)] = _lstm_stack(c, top)
            idx += 2                                      # LSTM, ELU
            enc[str(idx)] = Conv1d(top, c.hidden_size, c.last_kernel_size)
            self.encoder = holder(layers=nn.ModuleDict(enc))
            dec = {"0": Conv1d(c.hidden_size, top, c.kernel_size),
                   "1": _lstm_stack(c, top)}
            idx = 2
            for ratio in c.upsampling_ratios:
                cur = scaling * c.num_filters
                idx += 1                                  # ELU
                dec[str(idx)] = ConvTranspose1d(cur, cur // 2, ratio * 2)
                idx += 1
                for _ in range(c.num_residual_layers):
                    dec[str(idx)] = _resnet(c, cur // 2)
                    idx += 1
                scaling //= 2
            idx += 1                                      # ELU
            dec[str(idx)] = Conv1d(c.num_filters, c.audio_channels,
                                   c.last_kernel_size)
            self.decoder = holder(layers=nn.ModuleDict(dec))
            self.quantizer = holder(layers=nn.ModuleDict({
                str(i): holder(codebook=holder(embed=Embedding(
                    c.codebook_size, c.codebook_dim)))
                for i in range(c.num_quantizers)}))
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sampling_rate

    # -- building blocks ----------------------------------------------------

    def _resnet(self, p: nn.Module, x: torch.Tensor,
                dilation: int) -> torch.Tensor:
        c = self.config
        h = _causal_conv(p.block["1"], elu(x), c.residual_kernel_size,
                         dilation=dilation, pad_mode=c.pad_mode)
        h = _causal_conv(p.block["3"], elu(h), 1, pad_mode=c.pad_mode)
        return _causal_conv(p.shortcut, x, 1, pad_mode=c.pad_mode) + h

    def _lstm(self, p: nn.Module, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.config.num_lstm_layers):
            h = p.lstm[str(i)](h)
        return x + h                  # the residual skip (HF EncodecLSTM)

    # -- encode / decode ----------------------------------------------------

    def encode_latent(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T, 1) -> (B, frames, hidden)."""
        c = self.config
        p = self.encoder.layers
        x = _causal_conv(p["0"], audio, c.kernel_size, pad_mode=c.pad_mode)
        idx = 1
        for ratio in reversed(c.upsampling_ratios):
            for j in range(c.num_residual_layers):
                x = self._resnet(p[str(idx)], x, c.dilation_growth_rate ** j)
                idx += 1
            idx += 1
            x = _causal_conv(p[str(idx)], elu(x), ratio * 2, stride=ratio,
                             pad_mode=c.pad_mode)
            idx += 1
        x = self._lstm(p[str(idx)], x)
        idx += 2
        return _causal_conv(p[str(idx)], elu(x), c.last_kernel_size,
                            pad_mode=c.pad_mode)

    def decode_latent(self, x: torch.Tensor) -> torch.Tensor:
        """(B, frames, hidden) -> audio (B, samples, 1)."""
        c = self.config
        p = self.decoder.layers
        x = _causal_conv(p["0"], x, c.kernel_size, pad_mode=c.pad_mode)
        x = self._lstm(p["1"], x)
        idx = 2
        for ratio in c.upsampling_ratios:
            idx += 1
            x = _causal_tconv(p[str(idx)], elu(x), ratio * 2, ratio)
            idx += 1
            for j in range(c.num_residual_layers):
                x = self._resnet(p[str(idx)], x, c.dilation_growth_rate ** j)
                idx += 1
        idx += 1
        return _causal_conv(p[str(idx)], elu(x), c.last_kernel_size,
                            pad_mode=c.pad_mode)

    def _codebook(self, i: int) -> torch.Tensor:
        return self.quantizer.layers[str(i)].codebook.embed.weight

    @torch.no_grad()
    def encode(self, audio, n_quantizers: Optional[int] = None
               ) -> torch.Tensor:
        """(B, 1, T), (B, T) or (T,) audio -> codes (B, nq, frames) int64.
        Under `exact_f32`: codes are an argmin over distances, which the
        card's TF32 convolutions would flip."""
        x = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(
            audio, torch.Tensor) else audio, device=self.device).float()
        if x.ndim == 3:
            x = x[:, 0]
        elif x.ndim == 1:
            x = x[None]
        with exact_f32():
            residual = self.encode_latent(x[..., None])
            codes = []
            for i in range(n_quantizers or self.config.num_quantizers):
                cb = self._codebook(i)
                idx = vq_encode(residual, cb, normalized=False)
                codes.append(idx)
                residual = residual - F.embedding(idx, cb)
        return torch.stack(codes, dim=1)

    @torch.no_grad()
    def decode(self, codes) -> torch.Tensor:
        """codes (B, nq, T) -> audio (B, T * hop, 1)."""
        codes = torch.as_tensor(np.asarray(codes) if not isinstance(
            codes, torch.Tensor) else codes, device=self.device).long()
        acc = None
        for i in range(codes.shape[1]):
            q = F.embedding(codes[:, i], self._codebook(i))
            acc = q if acc is None else acc + q
        return self.decode_latent(acc)

    def forward(self, audio) -> Tuple[torch.Tensor, torch.Tensor]:
        codes = self.encode(audio)
        return self.decode(codes), codes

    # -- weights ------------------------------------------------------------

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """An HF `EncodecModel` checkpoint -> the JAX tree: weight norm
        folded, `lstm.weight_ih_l{n}` -> `lstm.{n}.weight_ih`, `.conv.`
        dropped, conv kernels to WIO and the decoder's transposed convs to
        the pre-flipped layout, codebooks rebuilt from embed_sum /
        cluster_size (or taken from `codebook.embed`)."""
        from ..snac.snac import convert_torch_conv_transpose_weight

        weights = fold_torch_weight_norm(weights)
        c = self.config
        out, codebooks = {}, {}
        tconv_idx, idx = set(), 2
        for _ in c.upsampling_ratios:
            idx += 1
            tconv_idx.add(idx)
            idx += 1 + c.num_residual_layers
        for k, w in weights.items():
            w = np.asarray(w)
            if ("codebook.embed_sum" in k or "codebook.cluster_size" in k
                    or "codebook.cluster_usage" in k):
                base = k.split(".codebook.")[0]
                codebooks.setdefault(base, {})[
                    "sum" if "embed_sum" in k else "usage"] = w
                continue
            if "codebook.inited" in k or "codebook.initialized" in k:
                continue
            if k.endswith(".codebook.embed"):
                out[k + ".weight"] = w
                continue
            for n in range(c.num_lstm_layers):
                for part in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    suf = f".lstm.{part}_l{n}"
                    if k.endswith(suf):
                        k = k[: -len(suf)] + f".lstm.{n}.{part}"
                        break
            if k.endswith(".conv.weight"):
                k = k.replace(".conv.weight", ".weight")
            if k.endswith(".conv.bias"):
                k = k.replace(".conv.bias", ".bias")
            if k.endswith(".weight") and w.ndim == 3:
                parts = k.split(".")
                if ("decoder" in k and len(parts) >= 3 and parts[2].isdigit()
                        and int(parts[2]) in tconv_idx):
                    out[k] = convert_torch_conv_transpose_weight(w)
                else:
                    out[k] = np.transpose(w, (2, 1, 0))
                continue
            out[k] = w
        for base, d in codebooks.items():
            if "sum" in d and "usage" in d:
                out[f"{base}.codebook.embed.weight"] = (
                    d["sum"] / np.clip(d["usage"][:, None], 1e-5, None))
        return out


Model = Encodec

__all__ = ["Encodec", "Model", "ModelConfig"]
