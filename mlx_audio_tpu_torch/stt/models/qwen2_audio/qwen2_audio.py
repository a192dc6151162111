"""Qwen2-Audio: the Whisper-style tower with a 2x average pool, and a Qwen2
LM on the llama backbone.

Counterpart of mlx_audio_tpu/stt/models/qwen2_audio/qwen2_audio.py:

* `sinusoids` (:53-58) and `ModelConfig` (:60-74), whose `__post_init__`
  turns on Qwen2's q/k/v biases (`attention_bias`) unless the text config
  says otherwise;
* `get_audio_embeds` (:107-156): Voxtral's tower (`llm_stt.WhisperTower`)
  with the fixed sinusoidal positions of `max_source_positions + 1` rows,
  a 2x average pool before the last LayerNorm (an odd last frame
  dropped), then one linear projector;
* the prompt (`_build_prompt_ids`, the chat template's "Audio 1:" line, or
  the bare audio block), `generate` with its repetition penalty,
  `_eos_ids`, `sanitize` (a missing position table filled with the
  sinusoids) and `post_load_hook` (:158-357).

Qwen2-Audio hears only the first 30 s of its input: `get_audio_embeds`
cuts the waveform to 3,000 mel frames, as the JAX package does; the port
adds no chunking.

Departures (besides `llm_stt`'s): `sanitize` reads each conv weight's
layout from the model's own shapes (see `voxtral.py`); `post_load_hook`
reads only the model directory's tokenizer files and raises when they
fail to load, where JAX's swallows any error and leaves no tokenizer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Linear
from ....tts.models.base import local_tokenizer
from ....tts.models.llama.llama import Model as LlamaLM
from ....tts.models.llama.llama import ModelConfig as LlamaConfig
from ...models.base import STTOutput
from ..llm_stt import (WhisperTower, as_audio, decode_fns, decode_tokens,
                       sampling_knobs, splice_embeds, tower_forward)
from ..qwen3_lm import iter_decode
from ..voxtral.voxtral import AudioConfig
from ..whisper.audio import N_FRAMES, SAMPLE_RATE, log_mel_spectrogram


def sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "qwen2_audio"
    audio_config: Optional[dict] = None
    text_config: Optional[dict] = None
    audio_token_id: int = 151646
    audio_bos_token_id: int = 151647
    audio_eos_token_id: int = 151648
    model_path: str = ""

    def __post_init__(self):
        self.audio = AudioConfig.from_dict(self.audio_config or {})
        t = dict(self.text_config or {})
        t.setdefault("attention_bias", True)   # Qwen2 qkv bias
        self.text = LlamaConfig.from_dict(t)


class Model(TorchModel):
    """Qwen2-Audio on `device`: the card by default; without CUDA the
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
        a, t = config.audio, config.text
        with torch.device(device):
            self.audio_tower = WhisperTower(a, a.max_source_positions + 1)
            self.multi_modal_projector = holder(
                linear=Linear(a.d_model, t.hidden_size))
        self.language_model = LlamaLM(t, device=device)
        self._tokenizer = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def init_params(self, seed: int = 0, on_device: bool = False):
        """TorchModel's draws, then the fixed sinusoidal positions."""
        super().init_params(seed, on_device)
        pos = self.audio_tower.embed_positions.weight
        pos.copy_(torch.from_numpy(sinusoids(*pos.shape)))
        return self

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.model.norm.weight.dtype

    # ------------------------------------------------------------ encoding

    def mel(self, audio) -> torch.Tensor:
        """The first 30 s' log-mel, zero-filled to (1, 3000, n_mels)."""
        a = self.config.audio
        wav = np.asarray(audio, np.float32).reshape(-1)
        mel = torch.zeros(1, N_FRAMES, a.num_mel_bins, device=self.device)
        m = log_mel_spectrogram(wav[:N_FRAMES * 160], n_mels=a.num_mel_bins,
                                device=self.device)[:N_FRAMES]
        mel[0, :m.shape[0]] = m
        return mel

    @torch.inference_mode()
    def encode_mels(self, mels: torch.Tensor) -> torch.Tensor:
        """(B, frames, n_mels) -> (B, frames / 4, lm_hidden): the tower, its
        pool and norm, the projector."""
        a = self.config.audio
        x = tower_forward(self.audio_tower, a.encoder_attention_heads,
                          mels.to(self.device, self.dtype), pool=True)
        return self.multi_modal_projector.linear(x)

    def get_audio_embeds(self, audio) -> Tuple[torch.Tensor, int]:
        """Waveform -> ((n_tokens, lm_hidden), n_tokens) of its first 30 s."""
        out = self.encode_mels(self.mel(audio))[0]
        return out, out.shape[0]

    def _build_prompt_ids(self, n_audio_tokens: int,
                          prompt: Optional[str]) -> List[int]:
        cfg = self.config
        user_prompt = prompt or "Please transcribe the speech."
        tok = self._tokenizer
        if tok is not None and hasattr(tok, "apply_chat_template"):
            content = ("Audio 1: <|audio_bos|>"
                       + "<|AUDIO|>" * n_audio_tokens
                       + "<|audio_eos|>\n" + user_prompt)
            text = tok.apply_chat_template(
                [{"role": "user", "content": content}], tokenize=False,
                add_generation_prompt=True)
            return list(tok.encode(text))
        ids = [cfg.audio_bos_token_id] + \
            [cfg.audio_token_id] * n_audio_tokens + [cfg.audio_eos_token_id]
        if tok is not None:
            ids += list(tok.encode(user_prompt))
        return ids

    @property
    def audio_id(self) -> int:
        """The <|AUDIO|> id the prompt's audio rows hold."""
        return self.config.audio_token_id

    def prompt_inputs(self, audio, prompt: Optional[str] = None):
        """Waveform -> (its audio embeddings, the prompt's token ids)."""
        feats, n_audio = self.get_audio_embeds(audio)
        return feats, self._build_prompt_ids(n_audio, prompt)

    def _eos_ids(self) -> Tuple[int, ...]:
        ids = set()
        tok = self._tokenizer
        if tok is not None:
            if getattr(tok, "eos_token_id", None) is not None:
                ids.add(int(tok.eos_token_id))
            conv = getattr(tok, "convert_tokens_to_ids", None)
            if conv is not None:
                for s in ("<|im_end|>", "<|endoftext|>"):
                    i = conv(s)
                    if i is not None and i != getattr(tok, "unk_token_id",
                                                      None):
                        ids.add(int(i))
        if not ids:
            ids.update((151645, 151643))
        return tuple(sorted(ids))

    # -------------------------------------------------------------- decode

    def generate(self, audio, *, prompt: Optional[str] = None,
                 max_tokens: int = 256, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20, seed: int = 0,
                 verbose: bool = False, **kwargs) -> STTOutput:
        t0 = time.time()
        audio = as_audio(audio, SAMPLE_RATE)
        t_enc = time.perf_counter()
        feats, ids = self.prompt_inputs(audio, prompt)
        n = len(ids)
        with torch.inference_mode():
            embeds = splice_embeds(self.language_model, ids, feats,
                                   audio_id=self.audio_id)
        fns = decode_fns(self.language_model, n, max_tokens, sampling_knobs(
            temperature, top_k, top_p, min_p, repetition_penalty,
            repetition_context_size), self._eos_ids())
        self.last_run = {"audio_tokens": feats.shape[0],
                         "encode_ms": (time.perf_counter() - t_enc) * 1e3}
        generated = decode_tokens(iter_decode(
            fns, embeds, n, max_tokens=max_tokens, seed=seed,
            run=self.last_run))
        text = (self._tokenizer.decode(generated, skip_special_tokens=True)
                if self._tokenizer is not None
                else " ".join(map(str, generated)))
        dt = time.time() - t0
        if verbose:
            print(text)
        return STTOutput(
            text=text.strip(), language="en",
            segments=[{"text": text.strip(), "start": 0.0,
                       "end": len(audio) / SAMPLE_RATE}],
            prompt_tokens=n, generation_tokens=len(generated),
            total_tokens=n + len(generated), total_time=dt,
            prompt_tps=n / dt if dt else 0.0,
            generation_tps=len(generated) / dt if dt else 0.0)

    __call__ = generate

    # ------------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The position table under the tree's name (the sinusoids where
        the checkpoint has none), conv weights to WIO from the layout their
        shapes show, RoPE tables dropped."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        pos_key = "audio_tower.embed_positions.weight"
        out = {}
        for k, v in weights.items():
            if k.endswith("rotary_emb.inv_freq"):
                continue
            v = v if isinstance(v, np.ndarray) else np.asarray(v)
            if "embed_positions" in k:
                out[pos_key] = v
                continue
            out[k] = v
        if pos_key not in out:
            out[pos_key] = sinusoids(*shapes[pos_key])
        return convs_to_wio(out, shapes, lambda k, v: "conv" in k
                            and k.endswith("weight") and v.ndim == 3)

    def model_quant_predicate(self, path, w) -> bool:
        return not path.startswith("audio_tower")

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path))
        return model


__all__ = ["Model", "ModelConfig", "sinusoids"]
