"""The LFM2.5-Audio processor: the mel front end, the tokenizers, the chat
state.

Counterpart of mlx_audio_tpu/sts/models/lfm_audio/processor.py:

* `LFMModality` and `PreprocessorConfig` (copied);
* `preprocess_features` (:63): pre-emphasis, a Hann STFT on the port's
  `dsp.stft`, slaney mels, log with a 2^-24 guard and per-feature
  normalisation over the audio's frames (Bessel's variance), on the
  device; `AudioPreprocessor`;
* `LFM2AudioProcessor` (:111): the text tokenizer, the 32-codebook Mimi of
  which LFM2.5 uses the first 8 (:139-160), the detokenizer,
  `tokenize_audio`, `decode_audio`;
* `_subsampled_frames` (:271) and `ChatState` (:279), copied.

Departures, from JAX faults:
* The JAX `mimi` binds random weights when the directory holds no
  `tokenizer-*.safetensors` (:151-160), and the JAX `detokenizer` when
  `audio_detokenizer/model.safetensors` is missing: each then encodes or
  decodes noise without a word. Here each raises and names the missing
  file; a caller may bind its own (`LFM2AudioProcessor(..., mimi=,
  detokenizer=)`).
* The text tokenizer is the directory's own, read by the model's
  `post_load_hook` (`tts.models.base.local_tokenizer`: None without
  tokenizer files or `transformers`); never downloaded. Asked for with
  none set, it raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ....base import BaseModelArgs
from .... import dsp
from ....model import check_device
from .detokenizer import LFM2AudioDetokenizer


class LFMModality(IntEnum):
    """Modality flags (values match the PyTorch implementation)."""

    TEXT = 1
    AUDIO_IN = 2
    AUDIO_OUT = 3


@dataclass
class PreprocessorConfig(BaseModelArgs):
    sample_rate: int = 16000
    normalize: str = "per_feature"
    window_size: float = 0.025
    window_stride: float = 0.01
    window: str = "hann"
    features: int = 128
    n_fft: int = 512
    log: bool = True
    frame_splicing: int = 1
    dither: float = 1e-05
    pad_to: int = 0
    pad_value: float = 0.0
    preemph: float = 0.97

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_stride)

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.window_size)


def read_safetensors(path: Path) -> Dict[str, np.ndarray]:
    """One safetensors file as {name: numpy array}, bfloat16 as f32."""
    from safetensors import safe_open

    out = {}
    with safe_open(str(path), framework="pt") as f:
        for k in f.keys():
            t = f.get_tensor(k)
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def preprocess_features(c: PreprocessorConfig, audio: torch.Tensor,
                        mel_fb: torch.Tensor) -> torch.Tensor:
    """(T,) waveform -> (frames, n_mels) normalized log-mel, f32, on the
    audio's device; `mel_fb` (n_fft // 2 + 1, n_mels)."""
    if c.preemph and c.preemph > 0:
        audio = torch.cat([audio[:1], audio[1:] - c.preemph * audio[:-1]])
    spec = dsp.stft(audio, n_fft=c.n_fft, hop_length=c.hop_length,
                    win_length=c.win_length, window=c.window,
                    center=True, pad_mode="constant")
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ mel_fb
    if c.log:
        mel = torch.log(mel + 5.96e-8)  # 2^-24 guard (reference :112-113)
    if c.normalize == "per_feature":
        n = audio.shape[0] // c.hop_length
        n = min(max(n, 2), mel.shape[0])
        valid = mel[:n]
        mean = valid.mean(dim=0, keepdim=True)
        var = ((valid - mean) ** 2).sum(dim=0, keepdim=True) / (n - 1)
        mel = (mel - mean) / (torch.sqrt(var) + 1e-5)
    return mel


class AudioPreprocessor:
    """Waveform -> mel features on `device`: the card by default; without
    CUDA it raises unless given `device="cpu"` (reference AudioPreprocessor
    :33)."""

    def __init__(self, config: PreprocessorConfig, device="cuda"):
        if isinstance(config, dict):
            config = PreprocessorConfig.from_dict(config)
        self.config = config
        self.device = check_device(device)
        self._mel_fb = dsp.mel_filters(
            sample_rate=config.sample_rate, n_fft=config.n_fft,
            n_mels=config.features, f_min=0.0,
            f_max=config.sample_rate // 2, norm="slaney",
            mel_scale="slaney").T.contiguous().to(self.device)

    def __call__(self, audio) -> torch.Tensor:
        audio = torch.as_tensor(np.asarray(audio, np.float32) if not
                                isinstance(audio, torch.Tensor) else audio,
                                dtype=torch.float32, device=self.device)
        single = audio.ndim == 1
        if single:
            audio = audio[None]
        feats = torch.stack([preprocess_features(self.config, a,
                                                 self._mel_fb)
                             for a in audio])
        return feats[0] if single else feats


class LFM2AudioProcessor:
    """Text + audio front and back ends (reference LFM2AudioProcessor
    :144) on `device`: the card by default; without CUDA it raises unless
    given `device="cpu"`. The model builds its own on its device."""

    def __init__(self, config: Any, tokenizer: Optional[Any] = None,
                 mimi: Optional[Any] = None,
                 detokenizer: Optional[LFM2AudioDetokenizer] = None,
                 device="cuda"):
        self.config = config
        self.device = check_device(device)
        pre = getattr(config, "preprocessor_config", None) \
            or getattr(config, "preprocessor", None) or PreprocessorConfig()
        if isinstance(pre, dict):
            pre = PreprocessorConfig.from_dict(pre)
        self.audio_preprocessor = AudioPreprocessor(pre, self.device)
        self._tokenizer = tokenizer
        self._mimi = mimi
        self._detokenizer = detokenizer
        self.model_path: Optional[Path] = None

    # ------------------------------------------------------ lazy members

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            raise ValueError(
                "LFM2-Audio: no text tokenizer (the directory held no "
                "tokenizer files, or `transformers` is not installed); set "
                "`processor._tokenizer`")
        return self._tokenizer

    def _file(self, pattern: str, member: str) -> Path:
        """The first file of the directory matching `pattern`; none raises
        and names it, and the argument `member` that binds one instead."""
        files = [] if self.model_path is None else sorted(
            Path(self.model_path).glob(pattern))
        if not files:
            raise FileNotFoundError(
                f"LFM2-Audio: no {pattern} in {self.model_path}; bind one "
                f"with LFM2AudioProcessor(..., {member}=)")
        return files[0]

    @property
    def mimi(self):
        """The 32-codebook Kyutai Mimi of `tokenizer-*.safetensors`;
        LFM2.5 uses the first 8 (reference :197-210)."""
        if self._mimi is None:
            from ....codec.models.mimi.mimi import Mimi, mimi_202407
            from ....model import load_jax_params

            path = self._file("tokenizer-*.safetensors", "mimi")
            mimi = Mimi(mimi_202407(num_codebooks=32), device=self.device)
            load_jax_params(mimi, mimi.sanitize(read_safetensors(path)))
            self._mimi = mimi
        return self._mimi

    @property
    def detokenizer(self) -> LFM2AudioDetokenizer:
        if self._detokenizer is None:
            import json

            from ....model import load_jax_params
            from .detokenizer import DetokenizerConfig

            path = self._file("audio_detokenizer/model.safetensors",
                              "detokenizer")
            cfg_f = path.parent / "config.json"
            cfg = json.loads(cfg_f.read_text()) if cfg_f.exists() else {}
            detok = LFM2AudioDetokenizer(DetokenizerConfig.from_dict(cfg),
                                         device=self.device)
            load_jax_params(detok, detok.sanitize(read_safetensors(path)))
            self._detokenizer = detok
        return self._detokenizer

    @classmethod
    def from_pretrained(cls, model_name_or_path: str,
                        config: Optional[Any] = None, device="cuda"
                        ) -> "LFM2AudioProcessor":
        """The processor of a local directory (never downloaded), on
        `device`: the card by default; without CUDA it raises, before
        reading anything, unless given `device="cpu"`."""
        import json

        device = check_device(device)
        model_path = Path(model_name_or_path)
        if not model_path.is_dir():
            raise FileNotFoundError(
                f"Local model path not found: {model_name_or_path}")
        if config is None:
            from .lfm_audio import LFM2AudioConfig

            cfg = json.loads((model_path / "config.json").read_text())
            config = LFM2AudioConfig.from_dict(cfg)
        proc = cls(config, device=device)
        proc.model_path = model_path
        return proc

    # ------------------------------------------------------------ audio

    def preprocess_audio(self, audio, sample_rate: int = 16000):
        target = self.audio_preprocessor.config.sample_rate
        if sample_rate != target:
            audio = self._resample(audio, sample_rate, target)
        return self.audio_preprocessor(audio)

    def tokenize_audio(self, audio, sample_rate: int = 24000):
        audio = np.asarray(audio, np.float32)
        mimi_sr = int(self.mimi.sample_rate)
        if sample_rate != mimi_sr:
            audio = np.asarray(
                self._resample(audio, sample_rate, mimi_sr))
        if audio.ndim == 1:
            audio = audio[None]
        return self.mimi.encode(audio)

    def decode_audio(self, codes, codec: str = "detokenizer"):
        codes = np.asarray(codes)
        if codes.ndim == 2:
            codes = codes[None]
        if codec == "detokenizer":
            return self.decode_with_detokenizer(codes)
        if codec == "mimi":
            return self.mimi.decode(codes).float().cpu().numpy()
        raise ValueError(f"Invalid codec: {codec}")

    def decode_with_detokenizer(self, codes) -> np.ndarray:
        codes = np.asarray(codes)
        if codes.ndim == 2:
            codes = codes[None]
        vocab = self.detokenizer.config.vocab_size
        codes = np.clip(codes, 0, vocab - 1)
        return self.detokenizer(codes)

    # ------------------------------------------------------------- text

    def tokenize_text(self, text: str):
        return np.asarray(
            self.tokenizer.encode(text, add_special_tokens=True))

    def decode_text(self, tokens) -> str:
        if hasattr(tokens, "tolist"):
            tokens = np.asarray(tokens).reshape(-1).tolist()
        return self.tokenizer.decode(tokens)

    def format_chat(self, messages: List[Dict[str, str]],
                    add_generation_prompt: bool = True) -> str:
        return self.tokenizer.apply_chat_template(
            messages, tokenize=False,
            add_generation_prompt=add_generation_prompt)

    @staticmethod
    def _resample(audio, orig_sr: int, target_sr: int):
        if orig_sr == target_sr:
            return audio
        from ....utils import resample_audio

        return resample_audio(np.asarray(audio), orig_sr, target_sr)


def _subsampled_frames(mel_frames: int, stages: int = 3) -> int:
    """Encoder frames after the dw_striding stack (reference :481-488)."""
    t = mel_frames
    for _ in range(stages):
        t = (t + 2 * 1 - 3) // 2 + 1
    return t


class ChatState:
    """Multi-turn prompt builder (reference ChatState :403-533)."""

    def __init__(self, processor: LFM2AudioProcessor, add_bos: bool = True):
        self.processor = processor
        self.text_tokens: List[int] = []
        self.audio_features = None
        self.audio_out_codes: List[np.ndarray] = []
        self.modalities: List[LFMModality] = []
        self.current_turn: Optional[str] = None
        if add_bos:
            bos = getattr(processor.tokenizer, "bos_token_id", 1)
            if bos is not None:
                self.text_tokens.append(int(bos))
                self.modalities.append(LFMModality.TEXT)

    def _add_tokens(self, tokens: List[int]):
        self.text_tokens.extend(int(t) for t in tokens)
        self.modalities.extend([LFMModality.TEXT] * len(tokens))

    def new_turn(self, role: str):
        self.current_turn = role
        self._add_tokens(self.processor.tokenizer.encode(
            f"<|im_start|>{role}\n", add_special_tokens=False))

    def end_turn(self):
        self._add_tokens(self.processor.tokenizer.encode(
            "<|im_end|>\n", add_special_tokens=False))
        self.current_turn = None

    def add_text(self, text: str):
        self._add_tokens(self.processor.tokenizer.encode(
            text, add_special_tokens=False))

    def add_audio(self, audio, sample_rate: int = 16000):
        feats = self.processor.preprocess_audio(audio, sample_rate)
        feats = feats.float().cpu().numpy()
        if feats.ndim == 3:
            feats = feats[0]
        if self.audio_features is None:
            self.audio_features = feats
        else:
            self.audio_features = np.concatenate(
                [self.audio_features, feats], axis=0)
        n = _subsampled_frames(feats.shape[0])
        self.modalities.extend([LFMModality.AUDIO_IN] * n)

    def append(self, token, modality: LFMModality):
        if modality == LFMModality.TEXT:
            self.text_tokens.append(int(np.asarray(token).reshape(())))
        elif modality == LFMModality.AUDIO_OUT:
            self.audio_out_codes.append(np.asarray(token))
        self.modalities.append(modality)

    def get_text_tokens(self):
        return np.asarray(self.text_tokens, np.int32)[None]

    def get_audio_features(self):
        if self.audio_features is None:
            return None
        f = np.asarray(self.audio_features)
        return f[None] if f.ndim == 2 else f

    def get_modalities(self):
        return np.asarray([int(m) for m in self.modalities], np.int32)[None]

    def items(self):
        return [("text_tokens", self.get_text_tokens()),
                ("audio_features", self.get_audio_features()),
                ("modalities", self.get_modalities())]

    def __iter__(self):
        return iter(self.items())

    def keys(self):
        return [k for k, _ in self.items()]

    def __getitem__(self, key):
        for k, v in self.items():
            if k == key:
                return v
        raise KeyError(key)


__all__ = ["LFMModality", "PreprocessorConfig", "AudioPreprocessor",
           "LFM2AudioProcessor", "ChatState", "preprocess_features",
           "_subsampled_frames"]
