"""MMS-LID: spoken language identification over wav2vec2.

Counterpart of mlx_audio_tpu/lid/models/wav2vec2/wav2vec2.py: the config
(wav2vec2's with `classifier_proj_size`, `num_labels` and `id2label`,
:29-37), the model (the backbone, `projector`, `classifier`, :40-60), the
forward over MMS's length buckets with the waveform normalised over its
valid samples, the projector, the mean over the valid frames and the
softmax (:62-84), `predict`'s top-k (label, probability) (:86-104) and
`sanitize` (:108-112). The backbone is the port's wav2vec2, held as
`model.wav2vec2`; the host reads the probabilities once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ....model import TorchModel, check_device
from ....nn import Linear
from ....stt.models.mms.mms import normalize_valid, padded_wave, wio_convs
from ....stt.models.wav2vec import ModelConfig as Wav2Vec2Config
from ....stt.models.wav2vec import (Wav2Vec2Model, sanitize_wav2vec2,
                                    wav2vec2_forward)


@dataclass
class ModelConfig(Wav2Vec2Config):
    classifier_proj_size: int = 256
    num_labels: int = 2
    id2label: Optional[Dict[str, str]] = None

    def __post_init__(self):
        if self.id2label is not None:
            self.num_labels = len(self.id2label)


class Model(TorchModel):
    """wav2vec2 language ID on `device` (the card by default; without CUDA
    the constructor raises unless given `device="cpu"`)."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda"):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        self.wav2vec2 = Wav2Vec2Model(config, device=device)
        with torch.device(device):
            self.projector = Linear(config.hidden_size,
                                    config.classifier_proj_size)
            self.classifier = Linear(config.classifier_proj_size,
                                     config.num_labels)
        self.requires_grad_(False)

    @torch.no_grad()
    def probs(self, wave: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """(B, T) padded waveform and (B,) sample counts -> the label
        probabilities (B, num_labels) f32, on the device."""
        dt = self.projector.weight.dtype
        wave = normalize_valid(wave.float(), n).to(dt)
        h, frames = wav2vec2_forward(self.wav2vec2, wave, n)
        proj = self.projector(h)
        fmask = (torch.arange(proj.shape[1], device=proj.device)[None, :]
                 < frames[:, None]).to(proj.dtype)[..., None]
        pooled = (proj * fmask).sum(1) / torch.clamp(fmask.sum(1), min=1.0)
        return torch.softmax(self.classifier(pooled).float(), dim=-1)

    def predict(self, audio, top_k: int = 5) -> List[Tuple[str, float]]:
        """A mono 16-kHz waveform (or a file path) -> the top-k (language,
        probability)."""
        if isinstance(audio, str):
            from ....utils import load_audio

            audio = load_audio(audio, 16000)
        audio = np.asarray(audio, np.float32).reshape(-1)
        wave, n = padded_wave(audio, self.device)
        probs = self.probs(wave, n)[0].cpu().numpy()
        order = np.argsort(-probs)[:top_k]
        id2label = self.config.id2label or {}
        return [(id2label.get(str(int(i)), f"LABEL_{int(i)}"),
                 float(probs[i])) for i in order]

    __call__ = predict

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """HF `Wav2Vec2ForSequenceClassification` names -> the JAX tree,
        which `model.load_jax_params` binds: the `wav2vec2.` prefix kept
        beside the head, conv kernels to WIO, training-only tensors and any
        `lm_head.` dropped."""
        return wio_convs(sanitize_wav2vec2(
            {k: v for k, v in weights.items()
             if not k.startswith("lm_head.")}, strip_prefix=False))


__all__ = ["Model", "ModelConfig"]
