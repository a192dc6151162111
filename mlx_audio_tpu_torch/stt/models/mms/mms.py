"""MMS: massively multilingual CTC speech recognition over wav2vec2.

Counterpart of mlx_audio_tpu/stt/models/mms/mms.py: the length buckets
(:33-40), `ctc_collapse` (:43-51), the model (wav2vec2 backbone and the
`lm_head` CTC projection, :54-73), the forward over a bucket with the
waveform normalised over its valid samples (:75-96), `transcribe_ids`,
`generate` returning an `STTOutput` (:98-139), `sanitize` and
`post_load_hook`, which merges a language adapter and reads `vocab.json`
(:143-186). The backbone is the port's wav2vec2 (`stt/models/wav2vec`),
held as `model.wav2vec2` under the JAX tree's names; everything runs on
the model's device, and the host reads the argmax ids and the frame count
once.

Departure from the JAX package: `post_load_hook` binds the adapter
strictly. An adapter key the model does not hold, or one of another
shape, raises, naming it; JAX's merge drops every key its tree lacks
(`if k in flat`), so a wrong adapter there loads as no adapter.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ....model import TorchModel, check_device
from ....nn import Linear
from ..base import STTOutput
from ..wav2vec import (ModelConfig, Wav2Vec2Model, sanitize_wav2vec2,
                       wav2vec2_forward)

LENGTH_BUCKETS = (16000, 48000, 160000, 480000)   # 1 s / 3 s / 10 s / 30 s


def _bucket(n: int) -> int:
    for b in LENGTH_BUCKETS:
        if n <= b:
            return b
    return ((n + 159999) // 160000) * 160000


def ctc_collapse(ids: np.ndarray, length: int, blank: int = 0) -> List[int]:
    """Greedy CTC: repeats dropped, then blanks."""
    ids = np.asarray(ids[:length])
    if ids.size == 0:
        return []
    keep = np.ones(ids.shape, bool)
    keep[1:] = ids[1:] != ids[:-1]
    ids = ids[keep]
    return ids[ids != blank].tolist()


def normalize_valid(wave: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Zero mean and unit variance over each row's first n samples (B, T),
    the padding zeroed (mms.py:80-86)."""
    mask = (torch.arange(wave.shape[1], device=wave.device)[None, :]
            < n[:, None]).to(wave.dtype)
    denom = torch.clamp(n[:, None].to(wave.dtype), min=1.0)
    mean = (wave * mask).sum(-1, keepdim=True) / denom
    var = ((wave - mean) ** 2 * mask).sum(-1, keepdim=True) / denom
    return (wave - mean) * torch.rsqrt(var + 1e-7) * mask


def padded_wave(audio: np.ndarray, device) -> tuple:
    """A mono waveform right-padded with zeros to its length bucket ->
    ((1, bucket) f32 on `device`, the (1,) sample count there)."""
    n = len(audio)
    wave = np.zeros((1, _bucket(max(n, 1))), np.float32)
    wave[0, :n] = audio
    return (torch.from_numpy(wave).to(device),
            torch.tensor([n], device=device))


def wio_convs(weights: Dict) -> Dict:
    """`weights` with each 3-D `.conv.weight` turned from torch's (O, I/g,
    K) to the JAX tree's WIO (K, I/g, O), as the JAX package's sanitize
    gives it."""
    return {k: (np.transpose(np.asarray(v), (2, 1, 0))
                if k.endswith(".conv.weight") and np.ndim(v) == 3 else v)
            for k, v in weights.items()}


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """One safetensors file -> {name: numpy array} (bfloat16 as f32)."""
    from safetensors import safe_open

    out = {}
    with safe_open(str(path), framework="pt") as f:
        for k in f.keys():
            t = f.get_tensor(k)
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


class Model(TorchModel):
    """MMS on `device` (the card by default; without CUDA the constructor
    raises unless given `device="cpu"`)."""

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
            self.lm_head = Linear(config.hidden_size, config.vocab_size)
        self._vocab: Optional[Dict[int, str]] = None
        self.last_run: dict = {}
        self.requires_grad_(False)

    @property
    def sample_rate(self) -> int:
        return 16000

    @torch.no_grad()
    def forward_ids(self, wave: torch.Tensor, n: torch.Tensor):
        """(B, T) padded waveform and (B,) sample counts -> (argmax ids
        (B, F), valid frames (B,)), on the device."""
        dt = self.lm_head.weight.dtype
        wave = normalize_valid(wave.float(), n).to(dt)
        h, frames = wav2vec2_forward(self.wav2vec2, wave, n)
        return self.lm_head(h).argmax(dim=-1), frames

    def transcribe_ids(self, audio) -> List[int]:
        """A mono waveform -> its CTC-collapsed token ids."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        if len(audio) == 0:
            return []
        wave, n = padded_wave(audio, self.device)
        ids, frames = self.forward_ids(wave, n)
        frames = int(frames[0])
        self.last_run = {"samples": len(audio), "bucket": wave.shape[1],
                         "frames": frames}
        return ctc_collapse(ids[0, :frames].cpu().numpy(), frames,
                            blank=self.config.pad_token_id)

    def _tokens_to_text(self, tokens: List[int]) -> str:
        if self._vocab is None:
            return " ".join(str(t) for t in tokens)
        return "".join(self._vocab.get(t, "") for t in tokens) \
            .replace("|", " ")

    def generate(self, audio, *, verbose: bool = False, **kwargs
                 ) -> STTOutput:
        t0 = time.time()
        if isinstance(audio, (str, Path)):
            from ...utils import load_audio

            audio = load_audio(str(audio), self.sample_rate)
        audio = np.asarray(audio, np.float32).reshape(-1)
        tokens = self.transcribe_ids(audio)
        text = self._tokens_to_text(tokens).strip()
        if verbose:
            print(f"Text: {text}")
        return STTOutput(
            text=text, segments=[{"text": text, "start": 0.0, "end": 0.0}],
            total_time=time.time() - t0)

    __call__ = generate

    # ------------------------------------------------------------ loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """HF `Wav2Vec2ForCTC` names -> the JAX tree, which
        `model.load_jax_params` binds: the backbone through
        `sanitize_wav2vec2` under `wav2vec2.` (conv kernels to WIO),
        `lm_head.` as named."""
        head = {k: np.asarray(v) for k, v in weights.items()
                if k.startswith("lm_head.")}
        body = sanitize_wav2vec2({k: v for k, v in weights.items()
                                  if not k.startswith("lm_head.")},
                                 strip_prefix=False)
        out = {k if k.startswith("wav2vec2.") else "wav2vec2." + k: v
               for k, v in wio_convs(body).items()}
        out.update(head)
        return out

    def merge_adapter(self, weights: Dict) -> int:
        """Copy a language adapter's weights (HF names; linears and norms)
        into the model: every key must name a parameter of the model's
        shape. -> how many were copied."""
        own = self.state_dict()
        extra = self.sanitize(weights)
        for k, v in extra.items():
            if k not in own:
                raise ValueError(f"adapter key {k!r} names no parameter of "
                                 f"this MMS model")
            if tuple(own[k].shape) != tuple(np.shape(v)):
                raise ValueError(f"adapter key {k!r}: shape "
                                 f"{tuple(np.shape(v))}, the model's "
                                 f"{tuple(own[k].shape)}")
        with torch.no_grad():
            for k, v in extra.items():
                own[k].copy_(torch.as_tensor(np.asarray(v, np.float32)))
        return len(extra)

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """Merge `adapter.eng.safetensors` (else the first
        `adapter.*.safetensors`) strictly, and read `vocab.json` (its
        "eng" or "en" table where it holds one per language)."""
        model_path = Path(model_path)
        adapters = sorted(model_path.glob("adapter.*.safetensors"))
        preferred = model_path / "adapter.eng.safetensors"
        adapter_path = preferred if preferred.exists() else \
            (adapters[0] if adapters else None)
        if adapter_path is not None:
            model.merge_adapter(read_safetensors(adapter_path))
        vocab_path = model_path / "vocab.json"
        if vocab_path.exists():
            vocab = json.loads(vocab_path.read_text())
            if isinstance(next(iter(vocab.values())), dict):
                vocab = vocab.get("eng", vocab.get(
                    "en", next(iter(vocab.values()))))
            model._vocab = {v: k for k, v in vocab.items()}
        return model


__all__ = ["Model", "ModelConfig", "ctc_collapse", "LENGTH_BUCKETS"]
