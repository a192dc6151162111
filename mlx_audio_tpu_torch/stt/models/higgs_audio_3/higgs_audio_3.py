"""Higgs Audio v3 STT: a Whisper-style tower with a 2x mean pool, a
depthwise temporal projector and a Qwen3 LM, over VAD-cut chunks.

Counterpart of mlx_audio_tpu/stt/models/higgs_audio_3/higgs_audio_3.py:

* the configs (`AudioEncoderConfig`, `ModelConfig`, :56-93) and the tree
  (`init_params` :158-175: `audio_tower`, `audio_encoder_proj` with its
  `temporal` depthwise conv, `language_model`, `lm_head`);
* `split_long` and `vad_chunk_ranges` (:100-135), copied;
* `get_audio_features` (:242-271): the chunks padded to the longest one,
  each chunk's log-mel (slaney norm, HTK scale, the last frame dropped),
  the tower as one batch with the mean pool by 2 before its last
  LayerNorm (`llm_stt.tower_forward(pool=True)`, the same pool as
  Qwen2-Audio's), the stride-2 depthwise conv, ReLU MLP;
* `get_input_embeddings` (:274): the ChatML prefix, each chunk's rows in
  turn, the suffix; `parse_output` (:314, `<think>` stripped), `generate`
  on the shared stepper (eos 151645, 151643), `sanitize` (:180-199).

Departures from the JAX package:

* **where the VAD comes from.** JAX's `_vad_ranges` (:223-240) downloads
  mlx-community/silero-vad and, when that fails, falls back to plain
  4-s splits. The port never downloads: with `vad_cut` on it takes a
  local Silero through the seam Cohere ASR has (`generate(vad=<directory>)`,
  `set_vad_model(<directory or model>)`, or the MLX_AUDIO_VAD_MODEL
  environment variable) and raises, naming Silero and `vad_cut=False`,
  when none is given. With `vad_cut=False` the plain split equals JAX's
  `vad_chunk_ranges(backend=None)`;
* the decode is `stt.models.qwen3_lm`'s stepper over the unpadded prompt
  (JAX pads it to a bucket), with its departures (a stop at most one step
  after EOS, caches that grow with the decode, draws from a
  `torch.Generator`); the kept tokens are JAX's;
* a bf16 model computes in bf16 (the mel cast to it) against f32 caches;
* `sanitize` reads each conv weight's layout (torch, MLX or the JAX
  tree's WIO) from the model's own shapes, where JAX's transposes a
  weight whose first axis exceeds its last;
* `post_load_hook` reads only the directory's tokenizer files and raises
  when they fail to load, where JAX's swallows any error and leaves none.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ....base import BaseModelArgs
from ....dsp import log_mel_spectrogram
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Conv1d, Linear
from ....tts.models.base import local_tokenizer
from ....tts.models.moss_tts.config import Qwen3LMConfig
from ....tts.models.moss_tts.moss_tts import Qwen3LM
from ...models.base import STTOutput
from ..llm_stt import (WhisperTower, as_audio, decode_tokens, sampling_knobs,
                       tower_forward)
from ..qwen3_lm import iter_decode, qwen3_decode_fns

DEFAULT_PROMPT = ("Transcribe the speech. Output only the spoken words in "
                  "lowercase with no punctuation.")
PROJ_HIDDEN = 2048
EOS_IDS = (151643, 151645)


@dataclass
class AudioEncoderConfig(BaseModelArgs):
    model_type: str = "higgs_audio_encoder"
    num_mel_bins: int = 128
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    d_model: int = 1280
    max_source_positions: int = 1500
    frame_rate: int = 25


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "higgs_audio_3"
    audio_encoder_config: AudioEncoderConfig = field(
        default_factory=AudioEncoderConfig)
    text_config: Optional[Qwen3LMConfig] = None
    model_path: Optional[str] = None
    audio_adapter_type: str = "stack"
    projector_type: str = "mlp"
    projector_temporal_downsample: int = 2
    audio_in_token_idx: int = 151672
    audio_out_token_idx: int = 151673
    audio_bos_token_id: int = 151669
    audio_eos_token_id: int = 151670
    chunk_size_seconds: float = 4.0
    pad_token_id: int = 151643
    sample_rate: int = 16000
    vad_cut: bool = True
    split_vads: bool = False

    def __post_init__(self):
        if isinstance(self.audio_encoder_config, dict):
            self.audio_encoder_config = AudioEncoderConfig.from_dict(
                self.audio_encoder_config)
        if self.text_config is None:
            self.text_config = Qwen3LMConfig(tie_word_embeddings=False)
        elif isinstance(self.text_config, dict):
            self.text_config = Qwen3LMConfig.from_dict(self.text_config)
        self.text_config.tie_word_embeddings = False


# ------------------------------------------------------- VAD chunking


def split_long(start: int, end: int, max_samples: int
               ) -> List[Tuple[int, int]]:
    out, pos = [], start
    while pos < end:
        nxt = min(end, pos + max_samples)
        out.append((pos, nxt))
        pos = nxt
    return out


def vad_chunk_ranges(wav: np.ndarray, chunk_samples: int, backend=None,
                     split_vads: bool = False) -> List[Tuple[int, int]]:
    """Chunk at VAD speech boundaries; plain splits without a backend
    (reference vad.py:58-88)."""
    total = len(wav)
    cuts: List[Tuple[int, int]] = []
    if backend is not None:
        try:
            cuts = backend(wav)
        except Exception:
            cuts = []
    if not cuts:
        return split_long(0, total, chunk_samples)
    if split_vads:
        spans = list(cuts)
    else:
        spans, prev_e = [], 0
        for idx, (start, end) in enumerate(cuts):
            s = min(prev_e, start)
            e = total if idx == len(cuts) - 1 else end
            if e > s:
                spans.append((s, e))
            prev_e = e
    out: List[Tuple[int, int]] = []
    for s, e in spans:
        out.extend(split_long(s, e, chunk_samples))
    return out or split_long(0, total, chunk_samples)


class Model(TorchModel):
    """Higgs Audio v3 STT on `device`: the card by default; without CUDA
    the constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        a, tc = config.audio_encoder_config, config.text_config
        with torch.device(device):
            self.audio_tower = WhisperTower(a)
            proj = dict(linear1=Linear(a.d_model, PROJ_HIDDEN),
                        linear2=Linear(PROJ_HIDDEN, tc.hidden_size))
            if config.projector_temporal_downsample > 1:
                proj["temporal"] = Conv1d(a.d_model, a.d_model, 3,
                                          groups=a.d_model)
            self.audio_encoder_proj = holder(**proj)
            self.language_model = Qwen3LM(tc)
            self.lm_head = Linear(tc.hidden_size, tc.vocab_size, bias=False)
        self._tokenizer = None
        self._vad_model = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.norm.weight.dtype

    # ---------------------------------------------------------------- VAD

    def set_vad_model(self, model):
        """Inject a loaded Silero VAD model, or load one from a local
        directory (`vad.utils.load_model`, on this model's device). It is
        held outside the module tree: its weights are not this model's."""
        if isinstance(model, (str, Path)):
            from ....vad.utils import load_model as load_vad

            model = load_vad(model, device=self.device)
        self.__dict__["_vad_model"] = model

    def _vad_backend(self, vad):
        """The speech spans' backend of a local Silero (`vad` a directory,
        else the one set, else MLX_AUDIO_VAD_MODEL's); None with
        `vad_cut` off. Raises when `vad_cut` is on and none is given."""
        if not self.config.vad_cut:
            return None
        if vad is not None:
            self.set_vad_model(vad)
        if self._vad_model is None:
            env = os.environ.get("MLX_AUDIO_VAD_MODEL", "")
            if not env:
                raise RuntimeError(
                    "higgs_audio_3 with vad_cut=True needs a Silero VAD "
                    "model: give a local Silero directory (vad=<directory>, "
                    "set_vad_model(), or the MLX_AUDIO_VAD_MODEL environment "
                    "variable), or set vad_cut=False for plain "
                    f"{self.config.chunk_size_seconds:g}-s chunks; nothing "
                    "is downloaded")
            self.set_vad_model(env)
        m = self._vad_model

        def backend(w):
            ts = m.get_speech_timestamps(
                np.asarray(w, np.float32), sample_rate=self.sample_rate,
                threshold=0.5, min_speech_duration_ms=250,
                min_silence_duration_ms=100, speech_pad_ms=30,
                return_seconds=False)
            return [(int(t["start"]), int(t["end"])) for t in ts
                    if t["end"] > t["start"]]

        return backend

    # -------------------------------------------------------------- audio

    def _mel(self, wav: np.ndarray) -> torch.Tensor:
        """(T,) -> (frames, n_mels) Whisper-normalised log-mel (slaney
        norm, HTK scale), the last frame dropped, on the device."""
        mel = log_mel_spectrogram(
            wav, n_fft=400, hop_length=160,
            n_mels=self.config.audio_encoder_config.num_mel_bins,
            sample_rate=16000, log_base="log10_whisper", mel_norm="slaney",
            mel_scale="htk", device=self.device)
        return mel[:-1] if mel.shape[0] > 1 else mel

    @torch.inference_mode()
    def get_audio_features(self, wav: np.ndarray, vad=None
                           ) -> Tuple[List[torch.Tensor], int]:
        """VAD-cut (or plain) chunks padded to the longest, encoded as one
        batch -> (each chunk's projected rows, the chunk count)."""
        cfg = self.config
        a = cfg.audio_encoder_config
        chunk = int(cfg.chunk_size_seconds * self.sample_rate)
        ranges = vad_chunk_ranges(wav, chunk, backend=self._vad_backend(vad),
                                  split_vads=cfg.split_vads)
        pieces = [wav[s:e] for s, e in ranges]
        max_len = max(len(p) for p in pieces)
        mels = torch.stack([self._mel(np.pad(p, (0, max_len - len(p))))
                            for p in pieces])
        x = tower_forward(self.audio_tower, a.encoder_attention_heads,
                          mels.to(self.dtype), pool=True)
        pr = self.audio_encoder_proj
        if hasattr(pr, "temporal"):
            x = pr.temporal(x, stride=2, padding=1)
        x = pr.linear2(F.relu(pr.linear1(x)))
        return list(x), len(pieces)

    # ------------------------------------------------------------- prompt

    def get_input_embeddings(self, wav: np.ndarray,
                             user_prompt: str = DEFAULT_PROMPT, vad=None
                             ) -> Tuple[torch.Tensor, int]:
        """The prompt's embeddings (1, n, D): the ChatML prefix, each
        chunk's audio rows in turn, the suffix -> (embeds, n)."""
        if self._tokenizer is None:
            raise RuntimeError("Tokenizer not initialized.")
        feats, n_chunks = self.get_audio_features(wav, vad)
        enc = lambda s: list(self._tokenizer.encode(  # noqa: E731
            s, add_special_tokens=False))
        prefix = (enc("<|im_start|>user\n") + enc(user_prompt)
                  + enc("<|audio_bos|>"))
        suffix = (enc("<|audio_eos|>") + enc("<|im_end|>\n")
                  + enc("<|im_start|>assistant\n"))
        table = self.language_model.embed_tokens
        with torch.inference_mode():
            pre, suf = (table(torch.as_tensor(ids, device=self.device))
                        for ids in (prefix, suffix))
            embeds = torch.cat([pre] + [f.to(pre.dtype) for f in feats]
                               + [suf])
        self.last_run = {"chunks": n_chunks, "audio_rows": sum(
            f.shape[0] for f in feats)}
        return embeds[None], embeds.shape[0]

    # ------------------------------------------------------------- decode

    @staticmethod
    def parse_output(text: str) -> str:
        text = re.sub(r"<think>.*?</think>", "", text, flags=re.DOTALL)
        if "<think>" in text:
            text = text[text.index("<think>") + len("<think>"):]
        return re.sub(r"<\|.*?\|>", "", text).strip()

    def generate(self, audio, *, max_tokens: int = 1024,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1,
                 prompt: str = DEFAULT_PROMPT, vad=None,
                 seed: int = 0, verbose: bool = False,
                 **kwargs) -> STTOutput:
        t0 = time.time()
        wav = as_audio(audio, self.sample_rate)
        t_enc = time.perf_counter()
        embeds, n = self.get_input_embeddings(wav, prompt, vad)
        run = dict(self.last_run,
                   encode_ms=(time.perf_counter() - t_enc) * 1e3)
        fns = qwen3_decode_fns(
            self.language_model, self.config.text_config, self.lm_head, n,
            max_tokens, sampling_knobs(temperature, top_k, top_p, min_p,
                                       repetition_penalty,
                                       repetition_context_size,
                                       min_tokens_to_keep), EOS_IDS)
        tokens = decode_tokens(iter_decode(fns, embeds, n,
                                           max_tokens=max_tokens, seed=seed,
                                           run=run))
        self.last_run = run
        text = self.parse_output(self._tokenizer.decode(
            tokens, skip_special_tokens=False))
        if verbose:
            print(text)
        wall = time.time() - t0
        return STTOutput(
            text=text, segments=[{"start": 0.0, "end": wall, "text": text}],
            prompt_tokens=n, generation_tokens=len(tokens),
            total_tokens=n + len(tokens), total_time=wall,
            generation_tps=len(tokens) / wall if wall else 0.0)

    __call__ = generate

    # ------------------------------------------------------------ loading

    def model_quant_predicate(self, path: str, leaf) -> bool:
        return not path.startswith(("audio_tower", "audio_encoder_proj"))

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The text head and the LM's names as JAX renames them, conv
        weights to WIO from the layout their shape shows."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if k == "audio_decoder_proj.text_lm_head.weight":
                out["lm_head.weight"] = v
                continue
            if k.startswith("model."):
                k = "language_model." + k[len("model."):]
            elif k in ("embed_tokens.weight", "norm.weight") or \
                    k.startswith("layers."):
                k = "language_model." + k
            out[k] = v
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3
                            and k.endswith("weight")
                            and ("audio_tower.conv" in k
                                 or "audio_encoder_proj.temporal" in k))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path))
        return model


__all__ = ["Model", "ModelConfig", "AudioEncoderConfig", "vad_chunk_ranges",
           "split_long", "DEFAULT_PROMPT", "EOS_IDS"]
