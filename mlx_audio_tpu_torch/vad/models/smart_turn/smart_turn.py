"""Smart Turn: the semantic end-of-turn detector (a Whisper-style encoder,
attention pooling and an MLP head).

Counterpart of mlx_audio_tpu/vad/models/smart_turn/smart_turn.py:

* the encoder (`encoder_forward` :83): two tanh-GELU convs (the second of
  stride 2), learned positions, pre-norm attention layers with biased q/v
  projections (k's bias optional), a final layer norm;
* the head (`head_forward` :100): tanh attention pooling, then a
  four-linear classifier with a layer norm; a sigmoid gives the
  probability;
* the host feature prep, copied: `_prepare_audio` (:146; `np.interp`
  resampling, the last `max_audio_seconds` kept, left padding, mean/std
  normalisation) and `prepare_input_features` (:172; the port's
  `dsp.log_mel_spectrogram` with `log_base="log10_whisper"` on the model's
  device, its last frame dropped, the frame count fixed by left padding or
  by keeping the last frames);
* `predict_endpoint` (:201) and `_remap_key`/`sanitize` (:213-250).

The JAX package runs the whole mel -> probability function as one jitted
program on a fixed frame count; here it runs eagerly on the model's device
at the same fixed count.

Departure: `sanitize` reads the stem convs' layout (torch (O, I, 3), MLX
(O, 3, I) or WIO) and each 2-D linear's orientation from this model's own
shapes, where JAX's takes any conv whose first axis is not 3 for torch's
(and so misreads an MLX conv) and transposes a linear by comparing its two
axes (and so turns a square (in, out) export into nothing it recognises).
A square linear reads as torch's (out, in), the one orientation its shape
cannot tell apart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....model import TorchModel, check_device, convs_to_wio
from ....nn import Conv1d, Embedding, LayerNorm, Linear
from ....ops.attention import attention
from .config import EncoderConfig, ModelConfig


@dataclass
class EndpointOutput:
    prediction: int
    probability: float


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------- encoder

class SelfAttention(nn.Module):
    def __init__(self, d: int, k_bias: bool):
        super().__init__()
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d, bias=k_bias)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn_layer_norm = LayerNorm(d)
        self.self_attn = SelfAttention(d, cfg.k_proj_bias)
        self.final_layer_norm = LayerNorm(d)
        self.fc1 = Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = Linear(cfg.encoder_ffn_dim, d)


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.conv1 = Conv1d(cfg.num_mel_bins, d, 3)
        self.conv2 = Conv1d(d, d, 3)
        self.embed_positions = Embedding(cfg.max_source_positions, d)
        self.layer_norm = LayerNorm(d)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, frames, n_mels) -> (B, frames // 2, d_model)."""
        cfg = self.cfg
        x = _gelu(self.conv1(mel, padding=1))
        x = _gelu(self.conv2(x, stride=2, padding=1))
        x = x + self.embed_positions.weight[:x.shape[1]].to(x.dtype)[None]
        b, t, d = x.shape
        h_n = cfg.encoder_attention_heads
        for lp in self.layers:
            h = lp.self_attn_layer_norm(x)
            a = lp.self_attn
            q, k, v = (p(h).view(b, t, h_n, d // h_n)
                       for p in (a.q_proj, a.k_proj, a.v_proj))
            x = x + a.out_proj(attention(q, k, v).reshape(b, t, d))
            x = x + lp.fc2(_gelu(lp.fc1(lp.final_layer_norm(x))))
        return self.layer_norm(x)


# --------------------------------------------------------------- model

class Model(TorchModel):
    """Smart Turn on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        d = config.encoder_config.d_model
        with torch.device(device):
            self.encoder = Encoder(config.encoder_config)
            self.pool_attention_0 = Linear(d, 256)
            self.pool_attention_2 = Linear(256, 1)
            self.classifier_0 = Linear(d, 256)
            self.classifier_1 = LayerNorm(256)
            self.classifier_4 = Linear(256, 64)
            self.classifier_6 = Linear(64, 1)
        self.requires_grad_(False)
        self.eval()

    def head_forward(self, hidden: torch.Tensor) -> torch.Tensor:
        """Attention pooling + classifier -> (B, 1) logits."""
        attn = self.pool_attention_2(torch.tanh(
            self.pool_attention_0(hidden)))
        attn = torch.softmax(attn.float(), dim=1).to(hidden.dtype)
        pooled = (hidden * attn).sum(dim=1)
        x = self.classifier_1(self.classifier_0(pooled))
        x = self.classifier_4(_gelu(x))
        return self.classifier_6(_gelu(x))

    # host-side feature prep ------------------------------------------

    def _prepare_audio(self, audio, sample_rate: Optional[int]) -> np.ndarray:
        pc = self.config.processor_config
        sr = pc.sampling_rate if sample_rate is None else sample_rate
        if isinstance(audio, str):
            from ....audio_io import read as audio_read
            wav, sr = audio_read(audio)
            if wav.ndim > 1:
                wav = wav.mean(axis=1)
            audio = wav
        x = np.asarray(audio, np.float32)
        if x.ndim != 1:
            raise ValueError(f"expected mono 1-D audio, got {x.shape}")
        if sr != pc.sampling_rate and x.size:
            new_len = max(1, int(round(x.shape[0] * pc.sampling_rate / sr)))
            x = np.interp(np.linspace(0, 1, new_len, endpoint=False),
                          np.linspace(0, 1, x.shape[0], endpoint=False),
                          x).astype(np.float32)
        max_samples = pc.max_audio_seconds * pc.sampling_rate
        if x.shape[0] > max_samples:
            x = x[-max_samples:]          # keep the most recent window
        elif x.shape[0] < max_samples:
            x = np.pad(x, (max_samples - x.shape[0], 0))
        if pc.normalize_audio and x.size:
            x = (x - x.mean()) / max(float(x.std()), 1e-7)
        return x

    def prepare_input_features(self, audio, sample_rate=None) -> torch.Tensor:
        """audio -> (frames, n_mels) whisper log-mel on the model's device,
        a fixed frame count."""
        from ....dsp import log_mel_spectrogram
        pc = self.config.processor_config
        x = self._prepare_audio(audio, sample_rate)
        mel = log_mel_spectrogram(x, n_fft=pc.n_fft,
                                  hop_length=pc.hop_length, n_mels=pc.n_mels,
                                  sample_rate=pc.sampling_rate,
                                  log_base="log10_whisper",
                                  device=self.device)[:-1]
        target = pc.max_audio_seconds * pc.sampling_rate // pc.hop_length
        frames = mel.shape[0]
        if frames > target:
            mel = mel[-target:]
        elif frames < target:
            mel = F.pad(mel, (0, 0, target - frames, 0))
        return mel

    @torch.inference_mode()
    def __call__(self, mel) -> torch.Tensor:
        """mel (frames, n_mels), (B, frames, n_mels) or HF's (B, n_mels,
        frames) -> (B, 1) end-of-turn probability, f32."""
        mel = torch.as_tensor(mel, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        if mel.shape[-1] != self.config.processor_config.n_mels:
            mel = mel.transpose(-1, -2)
        hidden = self.encoder(mel.to(self.encoder.conv1.weight.dtype))
        return torch.sigmoid(self.head_forward(hidden).float())

    def predict_endpoint(self, audio, sample_rate: Optional[int] = None,
                         threshold: Optional[float] = None
                         ) -> EndpointOutput:
        mel = self.prepare_input_features(audio, sample_rate)
        prob = float(self(mel)[0, 0])
        thr = self.config.processor_config.threshold if threshold is None \
            else float(threshold)
        return EndpointOutput(prediction=int(prob > thr), probability=prob)

    # weight loading --------------------------------------------------

    @staticmethod
    def _remap_key(key: str) -> str:
        if key.startswith("inner."):
            key = key[len("inner."):]
        for i in ("0", "2"):
            key = key.replace(f"pool_attention.{i}.", f"pool_attention_{i}.")
        for i in ("0", "1", "4", "6"):
            key = key.replace(f"classifier.{i}.", f"classifier_{i}.")
        return key

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """Checkpoint names -> the JAX tree's (`inner.` dropped, the
        indexed Sequentials renamed, ONNX helper constants `val_*`
        skipped), the stem convs read into WIO and each 2-D linear into
        (out, in) from the layout its shape shows against this model's."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for key, v in weights.items():
            if key.startswith("val_"):   # ONNX helper constants
                continue
            key = self._remap_key(key)
            v = np.asarray(v)
            want = shapes.get(key)
            if v.ndim == 2 and want is not None and v.shape != want \
                    and v.shape == want[::-1]:
                v = v.T                  # an ONNX MatMul's (in, out)
            out[key] = v
        return convs_to_wio(out, shapes, lambda k, v: k in (
            "encoder.conv1.weight", "encoder.conv2.weight")
            and np.ndim(v) == 3)


__all__ = ["EncoderConfig", "ModelConfig", "EndpointOutput", "Model",
           "Encoder"]
