"""KittenTTS: a width-parametrized Kokoro with voices.npz packs.

Counterpart of mlx_audio_tpu/tts/models/kitten_tts/kitten_tts.py: its
`ModelConfig` (:46) maps onto the port's Kokoro config with
`decoder_bottleneck = max_conv_dim` and `decoder_res_dim = asr_res_dim`
(:75-91), so the model is the port's Kokoro and every residual conv leg of
its generator runs on K1 (`istftnet.AdaINResBlock1`) on the card in bf16.
The voices.npz packs with aliases and speed priors (`load_voices`,
`get_voice`), `_crossfade`, `_apply_tail` and `generate` (phonemes chunked
through the port's `KokoroPipeline` helpers and G2P) are the JAX
package's.

`fake_quant_dynamic_u8` (:27) is copied and held to the JAX function by
the tests; neither package applies it (nothing reads
`activation_quant_modules`).

Departures: `Model(...)` builds on the card by default and raises without
CUDA unless given `device="cpu"`; `compute_dtype` and `transfer_dtype`
(the port's Kokoro knobs) are config fields here too; `sanitize` drops the
voice packs a directory of npz weights has its voices.npz read with.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ....base import BaseModelArgs
from ..base import GenerationResult, format_duration, peak_memory_gb
from ..kokoro.kokoro import Model as KokoroModel
from ..kokoro.kokoro import ModelConfig as KokoroConfig


def fake_quant_dynamic_u8(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor uint8 fake-quant (ONNX DynamicQuantizeLinear)."""
    xf = x.float()
    x_min = torch.clamp(xf.min(), max=0.0)
    x_max = torch.clamp(xf.max(), min=0.0)
    scale = (x_max - x_min) / 255.0
    scale_safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(-x_min / scale_safe), 0.0, 255.0)
    q = torch.clamp(torch.round(xf / scale_safe + zp), 0.0, 255.0)
    deq = (q - zp) * scale_safe
    return torch.where(scale == 0, torch.zeros_like(deq), deq).to(x.dtype)


def basic_english_tokenize(text: str) -> List[str]:
    return re.findall(r"\w+|[^\w\s]", text)


@dataclass
class ModelConfig(BaseModelArgs):
    hidden_dim: int = 128
    max_conv_dim: int = 512
    max_dur: int = 50
    n_layer: int = 3
    n_mels: int = 80
    n_token: int = 178
    style_dim: int = 128
    text_encoder_kernel_size: int = 5
    asr_res_dim: int = 64
    plbert: dict = field(default_factory=dict)
    istftnet: dict = field(default_factory=dict)
    vocab: Dict[str, int] = field(default_factory=dict)
    sample_rate: int = 24000
    decoder_out_dim: Optional[int] = None
    voices_path: str = "voices.npz"
    speed_priors: Optional[dict] = None
    voice_aliases: Optional[dict] = None
    model_path: str = ""
    activation_quant_modules: Optional[List[str]] = None
    compute_dtype: str = "bfloat16"
    transfer_dtype: str = "float16"


class Model(KokoroModel):
    """KittenTTS = width-parametrized Kokoro + voices.npz + speed priors."""

    def __init__(self, config, repo_id: Optional[str] = None,
                 device="cuda"):
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        kcfg = KokoroConfig(
            istftnet=config.istftnet, hidden_dim=config.hidden_dim,
            max_conv_dim=config.max_conv_dim, max_dur=config.max_dur,
            n_layer=config.n_layer, n_mels=config.n_mels,
            n_token=config.n_token, style_dim=config.style_dim,
            text_encoder_kernel_size=config.text_encoder_kernel_size,
            plbert=config.plbert, vocab=config.vocab,
            sample_rate=config.sample_rate, model_path=config.model_path,
            decoder_bottleneck=config.max_conv_dim,
            decoder_res_dim=config.asr_res_dim,
            compute_dtype=config.compute_dtype,
            transfer_dtype=config.transfer_dtype)
        super().__init__(kcfg, repo_id=repo_id, device=device)
        self.kitten_config = config
        self.speed_priors = config.speed_priors or {}
        self.voice_aliases = config.voice_aliases or {}
        self._voices: Optional[Dict[str, np.ndarray]] = None

    # -- voices (npz pack) ----------------------------------------------------

    def load_voices(self) -> Dict[str, np.ndarray]:
        if self._voices is None:
            path = Path(self.kitten_config.model_path or ".") / \
                self.kitten_config.voices_path
            self._voices = {}
            if path.exists():
                with np.load(path) as data:
                    for name in data.files:
                        self._voices[name] = data[name]
        return self._voices

    def get_voice(self, voice: str, n_phonemes: int = 1) -> np.ndarray:
        voice = self.voice_aliases.get(voice, voice)
        packs = self.load_voices()
        if voice not in packs:
            raise FileNotFoundError(
                f"Voice '{voice}' not in {sorted(packs) or 'empty pack'}")
        pack = packs[voice]
        if pack.ndim == 3:  # kokoro-style per-length packs
            pack = pack[min(n_phonemes - 1, pack.shape[0] - 1)]
        return pack.reshape(1, -1)

    def get_supported_speakers(self) -> List[str]:
        return sorted(self.load_voices())

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Kokoro's `sanitize`, after dropping the voice packs: a directory
        whose weights are npz files has its voices.npz read with them
        (`utils.load_weights`), and a pack's name has no dot."""
        return super().sanitize({k: v for k, v in weights.items()
                                 if "." in k})

    # -- generation -----------------------------------------------------------

    @staticmethod
    def _ensure_punctuation(text: str) -> str:
        text = text.strip()
        return text if (not text or text[-1] in ".!?;:,") else text + "."

    def _crossfade(self, prev: np.ndarray, nxt: np.ndarray,
                   crossfade_samples: int):
        """Equal-gain linear blend of the chunk boundary. Returns
        (emit_now, carried_remainder)."""
        fade = min(crossfade_samples, len(prev), len(nxt))
        if fade <= 0:
            return prev, nxt
        t = np.arange(fade, dtype=np.float32) / fade
        blended = prev[-fade:] * (1.0 - t) + nxt[:fade] * t
        return np.concatenate([prev[:-fade], blended]), nxt[fade:]

    def _apply_tail(self, audio: np.ndarray, fade_out_ms: float,
                    tail_silence_ms: float) -> np.ndarray:
        """Fade out from the last energetic frame, then tail silence."""
        sr = self.config.sample_rate
        fade_out = int(sr * max(fade_out_ms, 0) / 1000)
        tail = int(sr * max(tail_silence_ms, 0) / 1000)
        audio = np.asarray(audio, np.float32)
        if fade_out > 0 and len(audio) > fade_out:
            hop = max(1, sr // 100)
            tail_len = min(len(audio), int(sr * max(fade_out_ms, 400) / 1000))
            fade_start = len(audio) - fade_out
            frames = audio[-tail_len:][: (tail_len // hop) * hop]
            if len(frames) >= hop:
                rms = np.sqrt((frames.reshape(-1, hop) ** 2).mean(axis=1))
                thr = max(float(rms.max()) * 0.05, 1e-4)
                idxs = np.flatnonzero(rms > thr)
                if len(idxs):
                    fade_start = len(audio) - tail_len + int(idxs[-1]) * hop
            fade_len = len(audio) - fade_start
            if fade_len < fade_out:
                fade_start = max(0, len(audio) - fade_out)
                fade_len = len(audio) - fade_start
            if fade_len > 0:
                curve = 1.0 - np.arange(fade_len,
                                        dtype=np.float32) / fade_len
                audio = np.concatenate([audio[:fade_start],
                                        audio[fade_start:] * curve])
        if tail > 0:
            audio = np.concatenate([audio, np.zeros(tail, np.float32)])
        return audio

    def generate(self, text: str, voice: Optional[str] = None,
                 speed: float = 1.0, lang_code: str = "a",
                 split_pattern: str = r"\n+", clean_text: bool = True,
                 chunk_size: int = 400, crossfade_ms: float = 20,
                 fade_out_ms: float = 200, tail_silence_ms: float = 200,
                 **kwargs):
        """Kokoro's synthesis with npz voices, per-voice speed priors,
        chunk crossfading and tail shaping."""
        from ...g2p import g2p
        from ..kokoro.pipeline import KokoroPipeline

        voice = voice or (self.get_supported_speakers() or ["default"])[0]
        speed = speed * float(self.speed_priors.get(voice, 1.0))
        if clean_text:
            text = self._ensure_punctuation(text)
        crossfade_samples = int(self.config.sample_rate
                                * max(crossfade_ms, 0) / 1000)
        segments = KokoroPipeline.split_segments(text, split_pattern)
        start = time.time()
        pieces = []  # (segment_idx, ids, audio)
        for segment_idx, segment in enumerate(segments):
            ps = g2p(segment)
            for chunk in KokoroPipeline.chunk_phonemes(
                    ps, max_len=min(chunk_size, 510)):
                ids = self.phonemes_to_ids(chunk)
                if not ids:
                    continue
                ref_s = self.get_voice(voice, len(ids))
                audio, _ = self(chunk, ref_s, speed=speed)
                pieces.append((segment_idx, ids, np.asarray(audio)))

        for i, (segment_idx, ids, audio) in enumerate(pieces):
            if i + 1 < len(pieces):
                audio, rest = self._crossfade(
                    audio, pieces[i + 1][2], crossfade_samples)
                pieces[i + 1] = (pieces[i + 1][0], pieces[i + 1][1], rest)
            else:
                audio = self._apply_tail(audio, fade_out_ms, tail_silence_ms)
            if not len(audio):
                continue
            now = time.time()
            seg_time = now - start
            start = now
            dur = len(audio) / self.config.sample_rate
            yield GenerationResult(
                audio=audio, samples=len(audio),
                sample_rate=self.config.sample_rate,
                segment_idx=segment_idx, token_count=len(ids),
                audio_duration=format_duration(dur),
                real_time_factor=round(seg_time / dur, 2) if dur else 0,
                prompt={"tokens": len(ids), "tokens-per-sec":
                        round(len(ids) / seg_time, 2) if seg_time else 0},
                audio_samples={"samples": len(audio), "samples-per-sec":
                               round(len(audio) / seg_time, 2)
                               if seg_time else 0},
                processing_time_seconds=seg_time,
                peak_memory_usage=peak_memory_gb(),
            )


__all__ = ["Model", "ModelConfig", "fake_quant_dynamic_u8",
           "basic_english_tokenize"]
