"""Voxtral (offline STT): a Whisper-style audio tower and a Mistral LM on
the llama backbone.

Counterpart of mlx_audio_tpu/stt/models/voxtral/voxtral.py:

* `AudioConfig` and `ModelConfig` (:63-89), whose `text_config` gives the
  llama `ModelConfig` (its defaults where empty);
* the tower (`init_audio_tower`, `audio_tower_forward`, :92-139) as
  `llm_stt.WhisperTower`: two GELU convs, learned positions, pre-norm
  layers (k_proj without bias), a final LayerNorm;
* `get_audio_embeds` (:232-257): 30-s chunks, each chunk's Whisper log-mel
  zero-filled in log-mel space to 3,000 frames (not the log-mel of
  silence), four encoder frames grouped into one `intermediate_size` row,
  then the two-linear GELU projector; the chunks go through the tower
  together;
* the Tekken tokenizer (`TekkenEncoder`, :142-199, copied: the port's
  Voxtral Realtime tokenizer decodes only, and skips every special id);
* the prompt (`_build_prompt_ids`, :259-283), `generate` (:344-393),
  `sanitize`, `model_quant_predicate` (the tower stays dense) and
  `post_load_hook` (:394-417).

Departures (besides `llm_stt`'s): `sanitize` reads each conv weight's
layout (torch, MLX or WIO) from the model's own shapes, where JAX's takes
a weight for torch's when its first axis is the longer, which misreads an
MLX checkpoint's `conv1` (1280, 3, 128) and leaves its `conv2`
(1280, 3, 1280) as it is.
"""

from __future__ import annotations

import base64
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Linear, gelu
from ....tts.models.llama.llama import Model as LlamaLM
from ....tts.models.llama.llama import ModelConfig as LlamaConfig
from ...models.base import STTOutput
from ..llm_stt import (WhisperTower, as_audio, decode_fns, decode_tokens,
                       sampling_knobs, splice_embeds, tower_forward)
from ..qwen3_lm import iter_decode
from ..whisper.audio import N_FRAMES, SAMPLE_RATE, log_mel_spectrogram


@dataclass
class AudioConfig(BaseModelArgs):
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    intermediate_size: int = 5120


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "voxtral"
    audio_config: Optional[AudioConfig] = None
    text_config: Optional[dict] = None
    audio_token_id: int = 24
    model_path: str = ""

    def __post_init__(self):
        if isinstance(self.audio_config, dict):
            self.audio_config = AudioConfig.from_dict(self.audio_config)
        if self.audio_config is None:
            self.audio_config = AudioConfig()
        self.text = LlamaConfig.from_dict(self.text_config or {})


class TekkenEncoder:
    """tekken.json tokenizer with decode, a greedy byte-level encode and
    the named special tokens the transcription prompt needs (a copy of the
    JAX package's)."""

    def __init__(self, tekken_path: str):
        data = json.loads(Path(tekken_path).read_text(encoding="utf-8"))
        self.n_special = int(data.get("config", {}).get(
            "default_num_special_tokens", 1000))
        self.vocab_bytes = [base64.b64decode(v["token_bytes"])
                            for v in data["vocab"]]
        self.byte2id = {}
        for i, b in enumerate(self.vocab_bytes):
            self.byte2id.setdefault(b, i)
        self.special = {}
        for st in data.get("special_tokens", []):
            if "rank" in st and ("token_str" in st or "name" in st):
                self.special[st.get("token_str") or st.get("name")] = \
                    int(st["rank"])
        self.eos_ids = {r for n, r in self.special.items()
                        if n and ("</s>" in n or "eos" in n.lower())}

    def special_id(self, name: str) -> Optional[int]:
        for k, v in self.special.items():
            if k == name or (k and name in k):
                return v
        return None

    def encode_text(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        ids, i = [], 0
        while i < len(data):
            for ln in range(min(16, len(data) - i), 0, -1):
                tid = self.byte2id.get(data[i:i + ln])
                if tid is not None:
                    ids.append(tid + self.n_special)
                    i += ln
                    break
            else:
                i += 1
        return ids

    def decode(self, token_ids) -> str:
        out = bytearray()
        for tid in token_ids:
            tid = int(tid)
            if tid < self.n_special:
                continue
            vid = tid - self.n_special
            if 0 <= vid < len(self.vocab_bytes):
                out += self.vocab_bytes[vid]
        return out.decode("utf-8", errors="replace")


class Model(TorchModel):
    """Offline Voxtral on `device`: the card by default; without CUDA the
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
        a, t = config.audio_config, config.text
        with torch.device(device):
            self.audio_tower = WhisperTower(a)
            self.multi_modal_projector = holder(
                linear_1=Linear(a.intermediate_size, t.hidden_size,
                                bias=False),
                linear_2=Linear(t.hidden_size, t.hidden_size, bias=False))
        self.language_model = LlamaLM(t, device=device)
        self._tekken: Optional[TekkenEncoder] = None
        self._audio_id = config.audio_token_id
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.model.norm.weight.dtype

    # ------------------------------------------------------------ encoding

    def chunk_mels(self, audio) -> torch.Tensor:
        """Waveform -> (chunks, 3000, n_mels) f32 on the model's device:
        each 30-s chunk's log-mel zero-filled to 3,000 frames."""
        a = self.config.audio_config
        wav = np.asarray(audio, np.float32).reshape(-1)
        n_chunk = N_FRAMES * 160
        mels = torch.zeros(-(-max(len(wav), 1) // n_chunk), N_FRAMES,
                           a.num_mel_bins, device=self.device)
        for j, i in enumerate(range(0, max(len(wav), 1), n_chunk)):
            m = log_mel_spectrogram(wav[i:i + n_chunk], n_mels=a.num_mel_bins,
                                    device=self.device)[:N_FRAMES]
            mels[j, :m.shape[0]] = m
        return mels

    @torch.inference_mode()
    def encode_mels(self, mels: torch.Tensor) -> torch.Tensor:
        """(chunks, frames, n_mels) -> (chunks, frames / 2, d_model)."""
        a = self.config.audio_config
        return tower_forward(self.audio_tower, a.encoder_attention_heads,
                             mels.to(self.device, self.dtype))

    @torch.inference_mode()
    def get_audio_embeds(self, audio) -> torch.Tensor:
        """Waveform -> (n_tokens, lm_hidden): the chunks through the tower,
        four encoder frames grouped into one row, the projector."""
        a = self.config.audio_config
        enc = self.encode_mels(self.chunk_mels(audio))
        mm = self.multi_modal_projector
        h = mm.linear_1(enc.reshape(-1, a.intermediate_size))
        return mm.linear_2(gelu(h))

    def _build_prompt_ids(self, n_audio_tokens: int, language: str
                          ) -> List[int]:
        """<s>[INST][BEGIN_AUDIO][AUDIO]*n lang:xx[TRANSCRIBE][/INST]."""
        tk = self._tekken
        if tk is None:
            raise RuntimeError("tekken.json tokenizer not loaded")

        def sid(name, default):
            v = tk.special_id(name)
            return v if v is not None else default

        audio = sid("[AUDIO]", self.config.audio_token_id)
        ids = [sid("<s>", 1), sid("[INST]", 3), sid("[BEGIN_AUDIO]", 12)]
        ids += [audio] * n_audio_tokens
        ids += tk.encode_text(f"lang:{language}")
        ids += [sid("[TRANSCRIBE]", 34), sid("[/INST]", 4)]
        self._audio_id = audio
        return ids

    def _eos_ids(self):
        return tuple(sorted(self._tekken.eos_ids)) or (2,)

    @property
    def audio_id(self) -> int:
        """The [AUDIO] id the prompt's audio rows hold."""
        return self._audio_id

    def prompt_inputs(self, audio, language: str = "en"):
        """Waveform -> (its audio embeddings, the prompt's token ids)."""
        feats = self.get_audio_embeds(audio)
        return feats, self._build_prompt_ids(feats.shape[0], language)

    # -------------------------------------------------------------- decode

    def generate(self, audio, *, language: str = "en",
                 max_tokens: int = 128, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                 seed: int = 0, verbose: bool = False,
                 **kwargs) -> STTOutput:
        t0 = time.time()
        audio = as_audio(audio, SAMPLE_RATE)
        t_enc = time.perf_counter()
        feats, ids = self.prompt_inputs(audio, language)
        n = len(ids)
        with torch.inference_mode():
            embeds = splice_embeds(self.language_model, ids, feats,
                                   audio_id=self._audio_id)
        fns = decode_fns(self.language_model, n, max_tokens,
                         sampling_knobs(temperature, top_k, top_p, min_p),
                         self._eos_ids())
        self.last_run = {"audio_tokens": feats.shape[0],
                         "encode_ms": (time.perf_counter() - t_enc) * 1e3}
        generated = decode_tokens(iter_decode(
            fns, embeds, n, max_tokens=max_tokens, seed=seed,
            run=self.last_run))
        text = self._tekken.decode(generated)
        dt = time.time() - t0
        if verbose:
            print(text)
        return STTOutput(
            text=text, language=language,
            segments=[{"text": text, "start": 0.0,
                       "end": len(audio) / SAMPLE_RATE}],
            prompt_tokens=n, generation_tokens=len(generated),
            total_tokens=n + len(generated), total_time=dt,
            prompt_tps=n / dt if dt else 0.0,
            generation_tps=len(generated) / dt if dt else 0.0)

    __call__ = generate

    # ------------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """HF or MLX names are the JAX tree's; conv weights to WIO from the
        layout their shapes show (`convs_to_wio`); RoPE tables dropped."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if k.endswith("rotary_emb.inv_freq"):
                continue
            out[k] = v if isinstance(v, np.ndarray) else np.asarray(v)
        return convs_to_wio(out, shapes, lambda k, v: "conv" in k
                            and k.endswith("weight") and v.ndim == 3)

    def model_quant_predicate(self, path, w) -> bool:
        return not path.startswith("audio_tower")

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's tekken.json, where it has one."""
        tekken = Path(model_path) / "tekken.json"
        if tekken.exists():
            model._tekken = TekkenEncoder(str(tekken))
        return model


__all__ = ["Model", "ModelConfig", "AudioConfig", "TekkenEncoder"]
