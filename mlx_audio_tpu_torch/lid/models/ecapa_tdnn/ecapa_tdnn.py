"""ECAPA-TDNN spoken language ID (SpeechBrain's VoxLingua107, 107
languages).

Counterpart of mlx_audio_tpu/lid/models/ecapa_tdnn/ecapa_tdnn.py: the
SpeechBrain log-mel front end (`compute_mel_spectrogram`, :38-56: a
periodic Hamming window, zero centre padding, HTK mels, 10 log10 and a top
dB of 80), `ModelConfig` (:59-75), the model (the ECAPA backbone under
`embedding_model`, the classifier's norms and linears, :78-113), the
forward with its sentence-mean normalisation (:115-127) and `predict`'s
top-k (language, probability) (:129-137). The backbone is the port's
`codec/models/ecapa_tdnn`; the front end runs on the model's device (the
DFT in float64), and the host reads the probabilities once.

The TDNN convs pad with zeros, as the JAX package's; SpeechBrain pads by
reflection, which only a real checkpoint's numbers would show.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ....base import BaseModelArgs
from ....codec.models.ecapa_tdnn import (EcapaBackbone, EcapaTdnnConfig,
                                         ecapa_backbone)
from ....dsp import _window_np, filters_on, frame_signal
from ....model import TorchModel, check_device, holder
from ....nn import BatchNorm, Linear

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 60


def compute_mel_spectrogram(audio, device="cpu") -> torch.Tensor:
    """SpeechBrain's log-mel of a 16-kHz waveform (T,) -> (1, frames, 60)
    f32 on `device`."""
    x = torch.as_tensor(np.asarray(audio, np.float32).reshape(-1)
                        if not isinstance(audio, torch.Tensor) else audio,
                        device=device).float().reshape(-1)
    x = F.pad(x, (N_FFT // 2, N_FFT // 2))
    w = torch.from_numpy(_window_np("hamming", N_FFT + 1, False)[:-1]).to(
        x.device, torch.float64)
    spec = torch.fft.rfft(frame_signal(x, N_FFT, HOP_LENGTH).double() * w,
                          dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2).float()
    mel = power @ filters_on(x.device, SAMPLE_RATE, N_FFT, N_MELS, None,
                             "htk")
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return torch.maximum(db, db.max() - 80.0)[None]


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "ecapa_tdnn"
    n_mels: int = 60
    channels: int = 1024
    embedding_dim: int = 256
    kernel_sizes: List[int] = field(default_factory=lambda: [5, 3, 3, 3, 1])
    dilations: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 1])
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    classifier_hidden_dim: int = 512
    num_classes: int = 107
    id2label: Optional[Dict[str, str]] = None
    model_path: str = ""


class Model(TorchModel):
    """ECAPA language ID on `device` (the card by default; without CUDA
    the constructor raises unless given `device="cpu"`)."""

    def __init__(self, config: Union[ModelConfig, dict], device="cuda"):
        device = check_device(device)
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        c = config
        self.backbone_cfg = EcapaTdnnConfig(
            input_size=c.n_mels, channels=c.channels,
            embed_dim=c.embedding_dim, kernel_sizes=c.kernel_sizes,
            dilations=c.dilations, attention_channels=c.attention_channels,
            res2net_scale=c.res2net_scale, se_channels=c.se_channels,
            global_context=True)
        self.id2label = {int(k): v.split(":")[0].strip()
                         for k, v in (c.id2label or {}).items()}
        with torch.device(device):
            self.embedding_model = EcapaBackbone(self.backbone_cfg)
            self.classifier = holder(
                norm=BatchNorm(c.embedding_dim),
                DNN=holder(block_0=holder(
                    linear=holder(w=Linear(c.embedding_dim,
                                           c.classifier_hidden_dim)),
                    norm=BatchNorm(c.classifier_hidden_dim))),
                out=holder(w=Linear(c.classifier_hidden_dim,
                                    c.num_classes)))
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def forward(self, mel_features: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels) -> log-probabilities (B, num_classes)."""
        x = mel_features - mel_features.mean(dim=1, keepdim=True)
        emb = ecapa_backbone(self.embedding_model, self.backbone_cfg, x)
        c = self.classifier
        out = c.norm(F.leaky_relu(emb, 0.01))
        out = c.DNN.block_0.linear.w(out)
        out = c.DNN.block_0.norm(F.leaky_relu(out, 0.01))
        out = c.out.w(out)
        return torch.log(torch.softmax(out, dim=-1) + 1e-10)

    def predict(self, audio, top_k: int = 5) -> List[Tuple[str, float]]:
        """Raw 16-kHz audio -> the top-k (language, probability)."""
        mel = compute_mel_spectrogram(audio, self.device)
        dt = self.embedding_model.fc.weight.dtype
        logp = self(mel.to(dt))[0].float().cpu().numpy()
        probs = np.exp(logp)
        order = np.argsort(probs)[::-1][:top_k]
        return [(self.id2label.get(int(i), str(int(i))), float(probs[i]))
                for i in order]

    def generate(self, audio, top_k: int = 5, **kwargs):
        return self.predict(audio, top_k=top_k)


__all__ = ["Model", "ModelConfig", "compute_mel_spectrogram"]
