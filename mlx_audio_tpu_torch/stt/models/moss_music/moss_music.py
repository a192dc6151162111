"""MOSS-Music: a conv2d-stem audio encoder whose deepstack features are
added into the first layers of a Qwen3 LM.

Counterpart of mlx_audio_tpu/stt/models/moss_music/moss_music.py:

* the configs (`AudioEncoderConfig`, `ModelConfig`, :70-118),
  `sinusoids` and `conv3_downsample_len` (:121-131), copied;
* `music_encoder_forward` (:163-201): three stride-2 3x3 conv2d over
  (mel, time) with tanh-approximate GELU (`jax.nn.gelu`'s default), the
  stem projection over (channel, frequency), sinusoidal positions,
  pre-norm layers under each chunk's key mask, the hidden states after
  the `deepstack_encoder_layer_indexes` layers captured, the final
  LayerNorm and `out_proj` (on the captures too) where the output width
  differs;
* `encode_audio` (:334-378): the Whisper slaney log-mel (precise filters,
  the last frame dropped), chunks of 2 x `n_window` frames padded to it
  and encoded as one batch, each chunk's valid rows, the gated-MLP adapter
  and one merger a deepstack capture;
* the prompt: time-marker spans (`_audio_span_ids` :380, the
  `moss_transcribe_diarize` helper), `<|audio_start|>` and `<|audio_end|>`
  ids, ChatML (`_build_prompt_ids` :402); the splice (`_decode` :497-530);
* the LM (`_lm_forward` :420): the Qwen3 layers, each deepstack feature
  (zero but at the audio rows) added to the output of layer i < n at the
  prefill only (`_lm_fns` :442-496), the untied `lm_head`; EOS
  `eos_token_id`;
* `<think>` stripping and structured timestamp parsing (:553-627),
  `generate` and `_stream` (:643-714), `model_quant_predicate` (:281),
  `sanitize` and `post_load_hook`.

Qwen3-ASR's stem (`qwen3_asr.conv_stem`) is not reused: it computes
another function (exact GELU, a bias-free `conv_out`, positions a
100-frame chunk), where MOSS-Music's runs tanh GELU, a stem projection
with bias and chunks of 400 frames (n_window 200) under a key mask.

Departures from the JAX package:

* the decode is `stt.models.qwen3_lm`'s stepper (`qwen3_decode_fns`, its
  prefill hook adding the deepstack features) in place of the family's
  own `_lm_fns`: the prompt is not padded to a bucket; the kept tokens
  are JAX's; the decode stops at most one step after the step that draws
  EOS, where JAX's runs the whole chunk it is in; the repetition
  penalty's history runs on across chunks, where JAX's starts each chunk
  with an empty one; f32 caches grow with the decode (JAX allocates
  bucket + 2,048 columns); draws come from a `torch.Generator`, so only
  greedy decoding compares token for token;
* the stream yields each token's text as its chunk is read, then a final
  result; JAX's decodes everything before its first yield;
* a bf16 model computes in bf16 (the mel cast to it) against f32 caches;
* `sanitize` reads each conv2d weight's layout (torch OIHW, MLX OHWI or
  the JAX tree's HWIO) from the model's own shapes, where JAX's guesses it
  from the axes' sizes;
* `post_load_hook` reads only the directory's tokenizer files and raises
  when they fail to load, where JAX's swallows any error and leaves none.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....dsp import log_mel_spectrogram
from ....model import TorchModel, check_device, holder
from ....nn import Conv2d, LayerNorm, Linear
from ....ops.attention import attention
from ....tts.models.base import local_tokenizer
from ....tts.models.moss_tts.config import Qwen3LMConfig
from ....tts.models.moss_tts.moss_tts import Qwen3LM
from ...models.base import STTOutput
from ..llm_stt import decode_tokens, sampling_knobs
from ..moss_transcribe_diarize.moss_transcribe_diarize import (
    StreamingResult, audio_span_ids, digit_ids, splice_rows)
from ..qwen3_asr.qwen3_asr import _to_jax_conv2d
from ..qwen3_lm import iter_decode, qwen3_decode_fns


@dataclass
class AudioEncoderConfig(BaseModelArgs):
    model_type: str = "moss_music_audio_encoder"
    d_model: int = 1280
    output_dim: int = 1280
    num_mel_bins: int = 128
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    downsample_hidden_size: int = 480
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5
    n_window: int = 200
    conv_chunksize: int = 64
    deepstack_encoder_layer_indexes: List[int] = field(
        default_factory=lambda: [8, 16, 24])


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "moss_music"
    audio_config: AudioEncoderConfig = field(
        default_factory=AudioEncoderConfig)
    language_config: Optional[Any] = None
    adapter_hidden_size: int = 8192
    deepstack_num_inject_layers: int = 3
    model_path: Optional[str] = None
    sample_rate: int = 16000
    audio_token_id: int = 151654
    audio_start_id: int = 151669
    audio_end_id: int = 151670
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    enable_time_marker: bool = True
    strip_thinking: bool = True
    default_prompt: str = ("Please give a detailed musical description of "
                           "this clip.")

    def __post_init__(self):
        if isinstance(self.audio_config, dict):
            self.audio_config = AudioEncoderConfig.from_dict(
                self.audio_config)
        if self.language_config is None:
            self.language_config = Qwen3LMConfig(tie_word_embeddings=False)
        elif isinstance(self.language_config, dict):
            self.language_config = Qwen3LMConfig.from_dict(
                self.language_config)


def sinusoids(length: int, channels: int) -> np.ndarray:
    log_ts = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_ts * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def conv3_downsample_len(n: int) -> int:
    for _ in range(3):
        n = (int(n) - 1) // 2 + 1
    return n


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _gated_mlp(in_dim: int, hidden: int, out_dim: int) -> nn.Module:
    return holder(gate_proj=Linear(in_dim, hidden, bias=False),
                  up_proj=Linear(in_dim, hidden, bias=False),
                  down_proj=Linear(hidden, out_dim, bias=False))


def gated_mlp(p, x: torch.Tensor) -> torch.Tensor:
    return p.down_proj(F.silu(p.gate_proj(x)) * p.up_proj(x))


def _encoder(a: AudioEncoderConfig) -> nn.Module:
    d, h, eps = a.d_model, a.downsample_hidden_size, a.layer_norm_eps
    parts = dict(
        conv1=Conv2d(1, h, 3), conv2=Conv2d(h, h, 3), conv3=Conv2d(h, h, 3),
        stem_proj=Linear(h * conv3_downsample_len(a.num_mel_bins), d),
        layers=nn.ModuleList(holder(
            self_attn=holder(q_proj=Linear(d, d),
                             k_proj=Linear(d, d, bias=False),
                             v_proj=Linear(d, d), out_proj=Linear(d, d)),
            self_attn_layer_norm=LayerNorm(d, eps),
            fc1=Linear(d, a.encoder_ffn_dim), fc2=Linear(a.encoder_ffn_dim, d),
            final_layer_norm=LayerNorm(d, eps))
            for _ in range(a.encoder_layers)),
        layer_norm=LayerNorm(d, eps))
    if a.output_dim != a.d_model:
        parts["out_proj"] = Linear(d, a.output_dim, bias=False)
    return holder(**parts)


def music_encoder_forward(enc, a: AudioEncoderConfig, mel: torch.Tensor,
                          lengths: List[int], capture
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """mel (B, n_mels, T) chunks, each chunk's valid rows after the stem
    -> (features (B, T', out), the captures [(B, T', out)])."""
    x = _gelu(enc.conv1(mel[:, None], stride=2, padding=1))
    x = _gelu(enc.conv2(x, stride=2, padding=1))
    x = _gelu(enc.conv3(x, stride=2, padding=1))
    b, c, f, t = x.shape
    x = enc.stem_proj(x.permute(0, 3, 1, 2).reshape(b, t, c * f))
    pos = torch.from_numpy(sinusoids(a.max_source_positions, a.d_model))
    x = x + pos[:t].to(x.device, x.dtype)[None]
    lens = torch.as_tensor(lengths, device=x.device)
    keys = torch.arange(t, device=x.device)
    mask = torch.zeros(b, 1, 1, t, device=x.device).masked_fill(
        keys[None, None, None, :] >= lens[:, None, None, None],
        float("-inf"))
    nh = a.encoder_attention_heads
    hd = a.d_model // nh
    deepstack: List[torch.Tensor] = []
    for i, blk in enumerate(enc.layers):
        h = blk.self_attn_layer_norm(x)
        at = blk.self_attn
        q = at.q_proj(h).reshape(b, t, nh, hd)
        k = at.k_proj(h).reshape(b, t, nh, hd)
        v = at.v_proj(h).reshape(b, t, nh, hd)
        x = x + at.out_proj(attention(q, k, v, mask=mask).reshape(b, t, -1))
        x = x + blk.fc2(_gelu(blk.fc1(blk.final_layer_norm(x))))
        if i in capture:
            deepstack.append(x)
    x = enc.layer_norm(x)
    if hasattr(enc, "out_proj"):
        x = enc.out_proj(x)
        deepstack = [enc.out_proj(s) for s in deepstack]
    return x, deepstack


class Model(TorchModel):
    """MOSS-Music on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    _TIME_VALUE = (r"(?:\d{1,2}:\d{2}(?::\d{2})?(?:[.,]\d+)?"
                   r"|\d+(?:[.,]\d+)?\s*s"
                   r"|\d+(?:[.,]\d+)?)")
    _LINE_TIME_VALUE = (r"(?:\d{1,2}:\d{2}(?::\d{2})?(?:[.,]\d+)?"
                        r"|\d+(?:[.,]\d+)?\s*s)")
    _RANGE_SEP = r"(?:-|\u2013|\u2014|~|to|\u2192)"
    _BRACKETED_RE = re.compile(
        rf"(?P<open>[\[\(<\u3010])\s*(?P<start>{_TIME_VALUE})\s*"
        rf"(?:(?:{_RANGE_SEP})\s*(?P<end>{_TIME_VALUE}))?"
        rf"\s*(?P<close>[\]\)>\u3011])", re.IGNORECASE)
    _LINE_RE = re.compile(
        rf"(?m)(?:^|\n)\s*(?P<start>{_LINE_TIME_VALUE})\s*"
        rf"(?:(?:{_RANGE_SEP})\s*(?P<end>{_LINE_TIME_VALUE}))?"
        r"\s*[:\uff1a\-\u2013\u2014]\s*", re.IGNORECASE)

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        a, lc = config.audio_config, config.language_config
        with torch.device(device):
            self.audio_encoder = _encoder(a)
            self.language_model = Qwen3LM(lc)
            self.audio_adapter = _gated_mlp(a.output_dim,
                                            config.adapter_hidden_size,
                                            lc.hidden_size)
            self.deepstack_audio_merger_list = nn.ModuleList(
                _gated_mlp(a.output_dim, config.adapter_hidden_size,
                           lc.hidden_size)
                for _ in range(self._n_deepstack()))
            self.lm_head = Linear(lc.hidden_size, lc.vocab_size, bias=False)
        self._tokenizer = None
        self._digit_token_ids: Optional[Dict[str, int]] = None
        self.audio_tokens_per_second = 12.5
        self.time_marker_every_seconds = 2
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.norm.weight.dtype

    def _n_deepstack(self) -> int:
        n = len(self.config.audio_config.deepstack_encoder_layer_indexes
                or [])
        if self.config.deepstack_num_inject_layers is not None:
            n = min(n, int(self.config.deepstack_num_inject_layers))
        return n

    # -------------------------------------------------------------- audio

    def _mel(self, wav: np.ndarray) -> torch.Tensor:
        """(T,) -> (n_mels, frames): the Whisper-normalised slaney log-mel
        (precise filters), the last frame dropped, on the device."""
        mel = log_mel_spectrogram(
            wav, n_fft=400, hop_length=160,
            n_mels=self.config.audio_config.num_mel_bins, sample_rate=16000,
            log_base="log10_whisper", mel_norm="slaney", mel_scale="slaney",
            precise=True, device=self.device)
        if mel.shape[0] > 1:
            mel = mel[:-1]
        return mel.T

    @torch.inference_mode()
    def encode_audio(self, wav: np.ndarray
                     ) -> Tuple[torch.Tensor, List[torch.Tensor], int, float]:
        """-> (adapted rows (n_tok, D_lm), the merged deepstack rows
        [(n_tok, D_lm)], n_tok, duration)."""
        a = self.config.audio_config
        duration = len(wav) / self.sample_rate
        mel = self._mel(wav)
        chunk_frames = a.n_window * 2
        chunks, lengths = [], []
        for start in range(0, max(mel.shape[1], 1), chunk_frames):
            piece = mel[:, start:start + chunk_frames]
            lengths.append(conv3_downsample_len(piece.shape[1]))
            chunks.append(F.pad(piece, (0, chunk_frames - piece.shape[1])))
        capture = tuple(a.deepstack_encoder_layer_indexes
                        [:self._n_deepstack()])
        feats, deepstack = music_encoder_forward(
            self.audio_encoder, a, torch.stack(chunks).to(self.dtype),
            lengths, capture)
        flat = torch.cat([feats[i, :n] for i, n in enumerate(lengths)])
        adapted = gated_mlp(self.audio_adapter, flat)
        merged = [gated_mlp(m, torch.cat([d[i, :n] for i, n in
                                          enumerate(lengths)]))
                  for m, d in zip(self.deepstack_audio_merger_list,
                                  deepstack)]
        return adapted, merged, flat.shape[0], duration

    # ------------------------------------------------------------- prompt

    def _audio_span_ids(self, n: int, enable_time_marker: Optional[bool]
                        ) -> List[int]:
        use = self.config.enable_time_marker if enable_time_marker is None \
            else bool(enable_time_marker)
        return audio_span_ids(
            n, self.config.audio_token_id,
            self._digit_token_ids if use else None,
            self.audio_tokens_per_second, self.time_marker_every_seconds)

    def _build_prompt_ids(self, text: str, n_audio: Optional[int],
                          enable_time_marker: Optional[bool]) -> List[int]:
        if self._tokenizer is None:
            raise RuntimeError("Tokenizer is not initialized.")
        enc = lambda s: list(self._tokenizer.encode(  # noqa: E731
            s, add_special_tokens=False))
        head = ("<|im_start|>system\nYou are a helpful assistant."
                "<|im_end|>\n<|im_start|>user\n")
        tail = f"{text}<|im_end|>\n<|im_start|>assistant\n"
        if n_audio is None:
            return enc(head + tail)
        cfg = self.config
        return (enc(head) + [cfg.audio_start_id]
                + self._audio_span_ids(n_audio, enable_time_marker)
                + [cfg.audio_end_id] + enc("\n" + tail))

    # ------------------------------------------------------------- decode

    def prompt_embeds(self, ids: List[int], audio: Optional[torch.Tensor],
                      deepstack: Optional[List[torch.Tensor]]
                      ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """The prompt's embeddings (1, n, D) with the audio rows spliced
        in, and each deepstack feature as (1, n, D), zero but at the audio
        rows (a count mismatch raises)."""
        lm = self.language_model
        if audio is None:
            tok = torch.as_tensor(ids, device=self.device)[None]
            return lm.embed_tokens(tok), None
        embeds = splice_rows(lm.embed_tokens, ids, audio,
                             self.config.audio_token_id)
        if not deepstack:
            return embeds, None
        pos = torch.nonzero(torch.as_tensor(ids) == self.config
                            .audio_token_id)[:, 0].to(self.device)
        ds = []
        for d in deepstack:
            full = torch.zeros_like(embeds)
            full[0, pos] = d.to(full.dtype)
            ds.append(full)
        return embeds, ds

    def _decode_iter(self, ids, audio, deepstack, max_tokens: int, sampling,
                     seed: int):
        with torch.inference_mode():
            embeds, ds = self.prompt_embeds(ids, audio, deepstack)
        fns = qwen3_decode_fns(self.language_model,
                               self.config.language_config, self.lm_head,
                               len(ids), max_tokens, sampling,
                               (self.config.eos_token_id,), deepstack=ds)
        return iter_decode(fns, embeds, len(ids), max_tokens=max_tokens,
                           seed=seed, run=self.last_run)

    def _decode(self, ids, audio, deepstack, max_tokens: int, sampling,
                seed: int = 0) -> List[int]:
        return decode_tokens(self._decode_iter(ids, audio, deepstack,
                                               max_tokens, sampling, seed))

    # ---------------------------------------------------- segment parsing

    @staticmethod
    def _strip_thinking(text: str) -> str:
        text = re.sub(r"<think>.*?</think>", "", text, flags=re.DOTALL)
        text = re.sub(r"^\s*<think>.*", "", text, flags=re.DOTALL)
        return text.strip()

    @staticmethod
    def _parse_ts(value: str) -> float:
        value = value.strip().lower().replace(",", ".")
        if value.endswith("s"):
            value = value[:-1].strip()
        parts = value.split(":")
        if len(parts) == 3:
            return int(parts[0]) * 3600 + int(parts[1]) * 60 + float(parts[2])
        if len(parts) == 2:
            return int(parts[0]) * 60 + float(parts[1])
        return float(value)

    @classmethod
    def _collect_markers(cls, text: str):
        markers = []
        for pat in (cls._BRACKETED_RE, cls._LINE_RE):
            for m in pat.finditer(text):
                try:
                    start = cls._parse_ts(m.group("start"))
                    end = cls._parse_ts(m.group("end")) if m.group("end") \
                        else None
                except ValueError:
                    continue
                markers.append((m.start(), m.end(), start, end,
                                m.group(0).strip()))
        markers.sort(key=lambda x: (x[0], x[1]))
        deduped, last_end = [], -1
        for mk in markers:
            if mk[0] < last_end:
                continue
            deduped.append(mk)
            last_end = mk[1]
        return deduped

    @classmethod
    def parse_structured_segments(cls, text: str, *,
                                  audio_duration: Optional[float] = None,
                                  total_time: Optional[float] = None
                                  ) -> List[Dict[str, object]]:
        markers = cls._collect_markers(text)
        fallback_end = audio_duration if audio_duration is not None \
            else (total_time or 0.0)
        if not markers:
            return [{"text": text, "start": 0.0,
                     "end": round(float(fallback_end), 3), "kind": "text",
                     "marker": None}]
        segments = []
        for i, (s0, s1, start, end, raw) in enumerate(markers):
            body_end = markers[i + 1][0] if i + 1 < len(markers) \
                else len(text)
            seg_text = re.sub(r"^[\s:\uff1a,;|\-\u2013\u2014>]+", "",
                              text[s1:body_end].strip())
            seg_text = re.sub(r"[\s|]+$", "", seg_text).strip()
            if not seg_text and end is None:
                continue
            e = end
            if e is None and i + 1 < len(markers):
                e = markers[i + 1][2]
            if e is None:
                e = fallback_end
            e = max(e, start)
            segments.append({"text": seg_text,
                             "start": round(float(start), 3),
                             "end": round(float(e), 3),
                             "kind": "timestamped_text", "marker": raw})
        if not segments:
            return [{"text": text, "start": 0.0,
                     "end": round(float(fallback_end), 3), "kind": "text",
                     "marker": None}]
        return segments

    # ----------------------------------------------------------- generate

    def _load_audio(self, audio) -> Optional[np.ndarray]:
        if audio is None:
            return None
        if isinstance(audio, (str, Path)):
            from ...utils import load_audio

            audio = load_audio(str(audio), sample_rate=self.sample_rate)
        if isinstance(audio, torch.Tensor):
            audio = audio.detach().float().cpu().numpy()
        wav = np.asarray(audio, np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=0 if wav.shape[0] <= 8 else 1)
        return wav.reshape(-1)

    def _prepare(self, audio, prompt, enable_time_marker):
        t0 = time.perf_counter()
        wav = self._load_audio(audio)
        feats = ds = n_audio = duration = None
        if wav is not None:
            feats, ds, n_audio, duration = self.encode_audio(wav)
        ids = self._build_prompt_ids(prompt or self.config.default_prompt,
                                     n_audio, enable_time_marker)
        self.last_run = {"audio_tokens": n_audio or 0,
                         "encode_ms": (time.perf_counter() - t0) * 1e3}
        return ids, feats, ds, duration

    def generate(self, audio=None, *, max_tokens: int = 1024,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1,
                 prompt: Optional[str] = None,
                 strip_thinking: Optional[bool] = None,
                 enable_time_marker: Optional[bool] = None,
                 stream: bool = False, seed: int = 0,
                 verbose: bool = False, **kwargs
                 ) -> Union[STTOutput, Generator[StreamingResult, None,
                                                 None]]:
        sampling = sampling_knobs(temperature, top_k, top_p, min_p,
                                  repetition_penalty,
                                  repetition_context_size,
                                  min_tokens_to_keep)
        if stream:
            return self._stream(audio, max_tokens=max_tokens,
                                sampling=sampling, prompt=prompt,
                                enable_time_marker=enable_time_marker,
                                seed=seed)
        t0 = time.time()
        ids, feats, ds, duration = self._prepare(audio, prompt,
                                                 enable_time_marker)
        gen = self._decode(ids, feats, ds, max_tokens, sampling, seed)
        text = self._tokenizer.decode(gen, skip_special_tokens=True)
        if verbose:
            print(text)
        do_strip = self.config.strip_thinking if strip_thinking is None \
            else strip_thinking
        if do_strip:
            text = self._strip_thinking(text)
        wall = time.time() - t0
        return STTOutput(
            text=text,
            segments=self.parse_structured_segments(
                text, audio_duration=duration, total_time=wall),
            prompt_tokens=len(ids), generation_tokens=len(gen),
            total_tokens=len(ids) + len(gen), total_time=wall,
            generation_tps=len(gen) / wall if wall else 0.0)

    __call__ = generate

    def _stream(self, audio, *, max_tokens, sampling, prompt,
                enable_time_marker, seed
                ) -> Generator[StreamingResult, None, None]:
        ids, feats, ds, _ = self._prepare(audio, prompt, enable_time_marker)
        count = 0
        for new in self._decode_iter(ids, feats, ds, max_tokens, sampling,
                                     seed):
            for tok in new:
                count += 1
                yield StreamingResult(
                    text=self._tokenizer.decode([tok],
                                                skip_special_tokens=True),
                    is_final=False, start_time=0.0, end_time=0.0,
                    prompt_tokens=len(ids), generation_tokens=count)
        yield StreamingResult(text="", is_final=True, start_time=0.0,
                              end_time=0.0, prompt_tokens=len(ids),
                              generation_tokens=count)

    # ------------------------------------------------------------ loading

    def model_quant_predicate(self, path: str, leaf) -> bool:
        return not path.startswith("audio_encoder")

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The positions' timescales dropped, the encoder's attention
        projections moved under `self_attn`, conv2d weights to HWIO from
        the layout their shape shows."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if k == "audio_encoder.embed_positions.inv_timescales":
                continue
            m = re.match(r"(audio_encoder\.layers\.\d+)\."
                         r"(q_proj|k_proj|v_proj|out_proj)\.(.+)", k)
            if m:
                k = f"{m.group(1)}.self_attn.{m.group(2)}.{m.group(3)}"
            if k.startswith("audio_encoder.conv") and \
                    k.endswith(".weight") and v.ndim == 4 and k in shapes:
                v = _to_jax_conv2d(k, v, shapes[k])
            out[k] = v
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`; files that fail to load raise) and its digit
        ids."""
        model._tokenizer = local_tokenizer(Path(model_path), use_fast=False)
        if model._tokenizer is not None:
            model._digit_token_ids = digit_ids(model._tokenizer)
        return model


__all__ = ["Model", "ModelConfig", "AudioEncoderConfig", "StreamingResult",
           "music_encoder_forward", "conv3_downsample_len", "sinusoids",
           "gated_mlp"]
