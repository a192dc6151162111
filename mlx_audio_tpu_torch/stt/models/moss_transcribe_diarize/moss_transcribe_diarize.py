"""MOSS-Transcribe-Diarize: a Whisper encoder and a Qwen3 LM that writes
speaker-tagged segments.

Counterpart of mlx_audio_tpu/stt/models/moss_transcribe_diarize/
moss_transcribe_diarize.py:

* the configs (`AudioConfig`, `ModelConfig`, :74-107) and the tree
  (`init_moss_std` :173-190: `model.language_model`,
  `model.whisper_encoder`, `model.vq_adaptor`, `lm_head` unless tied);
* `whisper_encoder_forward` (:136) as `llm_stt.WhisperTower` and
  `tower_forward` (learned positions, no pool); `encode_audio`
  (`_mel_chunks`, :282-322): 30-s chunks padded to 30 s (the Whisper
  slaney log-mel of the padded chunk), the encoder over the chunks as one
  batch, each chunk's rows cut to its token count x 4, the x4 time merge
  and the VQ adaptor (SiLU MLP, LayerNorm at the LM's epsilon);
* the prompt: time-marker audio spans (`_audio_span_ids` :334), the ChatML
  template (:360), the splice (`_decode` :448-466: the audio ids' rows
  replaced, a count mismatch raising);
* `_parse_segments` (:491, `[t][Sxx]text[t]`), `generate` and `_stream`
  (:516-573), `sanitize` (the `vq_ad(w)aptor.layers.{0,2,3}` names, a tied
  `lm_head` dropped) and `post_load_hook` (the tokenizer's digit ids,
  `processor_config.json`).

Departures from the JAX package:

* the decode is `stt.models.qwen3_lm`'s stepper (`qwen3_decode_fns`) in
  place of the family's own `_lm_fns` (:376-438): the prompt is not padded
  to a bucket; the kept tokens are JAX's (the drawn tokens before the first
  EOS, which is not kept, at most `max_tokens`); the decode stops at most
  one step after the step that draws EOS, where JAX's runs the whole chunk
  of DEC_CHUNK steps it is in; the repetition penalty's history runs on
  across chunks, where JAX's starts each chunk with an empty one (the two
  agree over the first DEC_CHUNK tokens); f32 caches grow with the decode
  (JAX allocates bucket + 4,096 columns); draws come from a
  `torch.Generator`, so only greedy decoding compares token for token;
* the stream yields each token's text as its chunk is read, then a final
  result, and stops at `max_tokens`, as JAX's does; JAX's decodes
  everything before its first yield; each result carries the prompt's
  length, where JAX's leaves `prompt_tokens` 0;
* a bf16 model computes in bf16 (the mel cast to it) against f32 caches;
* `sanitize` reads each conv weight's layout (torch, MLX or the JAX tree's
  WIO) from the model's own shapes, where JAX's transposes every 3-D
  encoder conv weight;
* `post_load_hook` reads only the directory's tokenizer files and raises
  when they fail to load, where JAX's swallows any error and leaves none.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ....base import BaseModelArgs
from ....dsp import log_mel_spectrogram
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import LayerNorm, Linear
from ....tts.models.base import local_tokenizer
from ....tts.models.moss_tts.config import Qwen3LMConfig
from ....tts.models.moss_tts.moss_tts import Qwen3LM
from ...models.base import STTOutput
from ..llm_stt import (WhisperTower, as_audio, decode_tokens, sampling_knobs,
                       tower_forward)
from ..qwen3_lm import DEC_CHUNK, iter_decode, qwen3_decode_fns

WHISPER_ENCODER_STRIDE = 2
MEL_CHUNK_FRAMES = 3000            # 30 s at hop 160
DEFAULT_PROMPT = (
    "Transcribe the audio into text. Start each segment with the start "
    "timestamp and speaker label ([S01], [S02], [S03], ...), write the "
    "corresponding spoken content, and end each segment with the ending "
    "timestamp to clearly mark the segment range.")
SEGMENT_RE = re.compile(
    r"\[(?P<start>\d+(?:\.\d+)?)\]\[(?P<speaker>S\d+)\]"
    r"(?P<text>.*?)\[(?P<end>\d+(?:\.\d+)?)\]", re.DOTALL)


@dataclass
class StreamingResult:
    text: str
    is_final: bool
    start_time: float
    end_time: float
    language: str = "en"
    prompt_tokens: int = 0
    generation_tokens: int = 0


@dataclass
class AudioConfig(BaseModelArgs):
    model_type: str = "whisper"
    num_mel_bins: int = 80
    d_model: int = 1024
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    max_source_positions: int = 1500


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "moss_transcribe_diarize"
    text_config: Optional[Qwen3LMConfig] = None
    audio_config: Optional[AudioConfig] = None
    audio_token_id: int = 151671
    audio_merge_size: int = 4
    adaptor_input_dim: Optional[int] = None
    tie_word_embeddings: bool = True
    sample_rate: int = 16000

    def __post_init__(self):
        if self.audio_config is None:
            self.audio_config = AudioConfig()
        elif isinstance(self.audio_config, dict):
            self.audio_config = AudioConfig.from_dict(self.audio_config)
        if self.text_config is None:
            self.text_config = Qwen3LMConfig()
        elif isinstance(self.text_config, dict):
            self.text_config = Qwen3LMConfig.from_dict(self.text_config)
        self.text_config.tie_word_embeddings = self.tie_word_embeddings
        if self.adaptor_input_dim is None:
            self.adaptor_input_dim = (self.audio_config.d_model
                                      * self.audio_merge_size)


def audio_span_ids(n: int, audio_id: int, digits: Optional[Dict[str, int]],
                   per_second: float, every: int) -> List[int]:
    """n audio ids with the digits of each `every`-th second between them
    (`_audio_span_ids`); plain audio ids without digit ids or markers."""
    if n <= 0 or every <= 0 or digits is None:
        return [audio_id] * max(n, 0)
    per_marker = int(per_second * every)
    if per_marker <= 0:
        return [audio_id] * n
    out, consumed = [], 0
    for sec in range(every, int(n / per_second) + 1, every):
        seg = (sec // every) * per_marker - consumed
        if seg > 0:
            out.extend([audio_id] * seg)
            consumed += seg
        out.extend(digits[d] for d in str(sec))
    if n - consumed > 0:
        out.extend([audio_id] * (n - consumed))
    return out


def digit_ids(tokenizer) -> Optional[Dict[str, int]]:
    """The tokenizer's one-id digits, or None unless all ten are."""
    digits = {}
    for d in "0123456789":
        ids = tokenizer.encode(d, add_special_tokens=False)
        if len(ids) == 1:
            digits[d] = int(ids[0])
    return digits if len(digits) == 10 else None


def splice_rows(embed_tokens, ids: List[int], rows: torch.Tensor,
                audio_id: int) -> torch.Tensor:
    """The prompt's embeddings (1, n, D) with each `audio_id` row replaced
    in order by `rows`; a count mismatch raises (`_decode`)."""
    tok = torch.as_tensor(ids, dtype=torch.long)
    dev = embed_tokens.weight.device
    embeds = embed_tokens(tok[None].to(dev))
    pos = torch.nonzero(tok == audio_id)[:, 0]
    if len(pos) != rows.shape[0]:
        raise ValueError(
            f"Audio features and audio tokens do not match: tokens: "
            f"{len(pos)}, features: {rows.shape[0]}")
    embeds[0, pos.to(dev)] = rows.to(dev, embeds.dtype)
    return embeds


class Model(TorchModel):
    """MOSS-Transcribe-Diarize on `device`: the card by default; without
    CUDA the constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        tc = config.text_config
        with torch.device(device):
            self.model = holder(
                language_model=Qwen3LM(tc),
                whisper_encoder=WhisperTower(config.audio_config),
                vq_adaptor=holder(
                    fc1=Linear(config.adaptor_input_dim, tc.hidden_size),
                    fc2=Linear(tc.hidden_size, tc.hidden_size),
                    norm=LayerNorm(tc.hidden_size, tc.rms_norm_eps)))
            if not config.tie_word_embeddings:
                self.lm_head = Linear(tc.hidden_size, tc.vocab_size,
                                      bias=False)
        self._tokenizer = None
        self.audio_tokens_per_second = 12.5
        self.time_marker_every_seconds = 5
        self.enable_time_marker = True
        self._digit_token_ids: Optional[Dict[str, int]] = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        return self.model.language_model.norm.weight.dtype

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "lm_head"):
            return self.lm_head(hidden)
        table = self.model.language_model.embed_tokens.weight
        return hidden @ table.to(hidden.dtype).T

    # ------------------------------------------------------------ encoder

    def _mel_chunks(self, wav: np.ndarray
                    ) -> Tuple[torch.Tensor, List[int], float]:
        """30-s mel chunks on the model's device -> (chunks (C, 3000,
        n_mels), token counts, duration)."""
        cfg = self.config
        duration = len(wav) / self.sample_rate
        n_samples = MEL_CHUNK_FRAMES * 160
        stride = 160 * WHISPER_ENCODER_STRIDE * cfg.audio_merge_size
        chunks, lengths = [], []
        for start in range(0, max(len(wav), 1), n_samples):
            piece = wav[start:start + n_samples]
            lengths.append((len(piece) - 1) // stride + 1)
            piece = np.pad(piece, (0, n_samples - len(piece)))
            chunks.append(log_mel_spectrogram(
                piece, n_fft=400, hop_length=160,
                n_mels=cfg.audio_config.num_mel_bins, sample_rate=16000,
                log_base="log10_whisper", mel_norm="slaney",
                mel_scale="slaney", device=self.device)[:MEL_CHUNK_FRAMES])
        return torch.stack(chunks), lengths, duration

    @torch.inference_mode()
    def encode_audio(self, wav: np.ndarray
                     ) -> Tuple[torch.Tensor, int, float]:
        """-> (audio rows (n_tokens, D) on the device, n_tokens,
        duration)."""
        cfg = self.config
        ms = cfg.audio_merge_size
        mels, lengths, duration = self._mel_chunks(wav)
        feats = tower_forward(self.model.whisper_encoder,
                              cfg.audio_config.encoder_attention_heads,
                              mels.to(self.dtype))
        flat = torch.cat([feats[i, :n * ms] for i, n in enumerate(lengths)])
        n_merged = flat.shape[0] // ms
        merged = flat[:n_merged * ms].reshape(n_merged, ms * feats.shape[-1])
        ad = self.model.vq_adaptor
        h = ad.norm(ad.fc2(F.silu(ad.fc1(merged))))
        return h, n_merged, duration

    # ------------------------------------------------------------- prompt

    def _audio_span_ids(self, n: int) -> List[int]:
        return audio_span_ids(
            n, self.config.audio_token_id,
            self._digit_token_ids if self.enable_time_marker else None,
            self.audio_tokens_per_second, self.time_marker_every_seconds)

    def _build_prompt(self, n_audio: int, prompt: Optional[str]
                      ) -> List[int]:
        if self._tokenizer is None:
            raise RuntimeError("Tokenizer is not initialized.")
        prompt = prompt or DEFAULT_PROMPT
        audio_tok = "<|audio_pad|>"
        rendered = (f"<|im_start|>user\n<|audio_start|>{audio_tok}"
                    f"<|audio_end|>\n{prompt}<|im_end|>\n"
                    "<|im_start|>assistant\n")
        before, after = rendered.split(audio_tok, 1)
        enc = lambda s: list(self._tokenizer.encode(  # noqa: E731
            s, add_special_tokens=False))
        return enc(before) + self._audio_span_ids(n_audio) + enc(after)

    # ------------------------------------------------------------- decode

    def _eos_ids(self) -> Tuple[int, ...]:
        ids = {151643, 151645}
        eos = getattr(self._tokenizer, "eos_token_id", None)
        if isinstance(eos, int):
            ids.add(eos)
        return tuple(sorted(ids))

    def _decode_iter(self, ids: List[int], rows: torch.Tensor,
                     max_tokens: int, sampling, seed: int):
        """The prompt spliced, the stepper over it -> the generator of
        each decode chunk's kept tokens (the run's numbers in
        `last_run`)."""
        lm = self.model.language_model
        with torch.inference_mode():
            embeds = splice_rows(lm.embed_tokens, ids, rows,
                                 self.config.audio_token_id)
        fns = qwen3_decode_fns(lm, self.config.text_config, self.logits,
                               len(ids), max_tokens, sampling,
                               self._eos_ids())
        return iter_decode(fns, embeds, len(ids), max_tokens=max_tokens,
                           seed=seed, run=self.last_run)

    def _decode(self, ids: List[int], rows: torch.Tensor, max_tokens: int,
                sampling, seed: int = 0) -> List[int]:
        return decode_tokens(self._decode_iter(ids, rows, max_tokens,
                                               sampling, seed))

    def _prepare(self, audio, prompt) -> Tuple[List[int], torch.Tensor,
                                               float]:
        t0 = time.perf_counter()
        wav = self._load_audio(audio)
        rows, n_audio, duration = self.encode_audio(wav)
        ids = self._build_prompt(n_audio, prompt)
        self.last_run = {"audio_tokens": n_audio,
                         "encode_ms": (time.perf_counter() - t0) * 1e3}
        return ids, rows, duration

    # ----------------------------------------------------------- generate

    @staticmethod
    def _parse_segments(text: str, fallback_end: float) -> List[dict]:
        segments = []
        for m in SEGMENT_RE.finditer(text):
            start, end = float(m.group("start")), float(m.group("end"))
            seg_text = m.group("text").strip()
            if end < start or not seg_text:
                continue
            segments.append({"start": start, "end": end,
                             "text": f"[{m.group('speaker')}] {seg_text}",
                             "speaker_id": m.group("speaker")})
        return segments or [{"start": 0.0, "end": max(fallback_end, 0.0),
                             "text": text}]

    def _load_audio(self, audio) -> np.ndarray:
        wav = as_audio(audio, self.sample_rate)
        if wav.shape[0] == 0:
            raise ValueError("Audio must contain at least one sample.")
        return wav

    def generate(self, audio, *, max_tokens: int = 2048,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1,
                 prompt: Optional[str] = None,
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
                                sampling=sampling, prompt=prompt, seed=seed)
        t0 = time.time()
        ids, rows, duration = self._prepare(audio, prompt)
        gen = self._decode(ids, rows, max_tokens, sampling, seed)
        text = self._tokenizer.decode(gen, skip_special_tokens=True).strip()
        if verbose:
            print(text)
        wall = time.time() - t0
        return STTOutput(
            text=text, segments=self._parse_segments(text, duration),
            prompt_tokens=len(ids), generation_tokens=len(gen),
            total_tokens=len(ids) + len(gen), total_time=wall,
            generation_tps=len(gen) / wall if wall else 0.0)

    __call__ = generate

    def _stream(self, audio, *, max_tokens, sampling, prompt, seed
                ) -> Generator[StreamingResult, None, None]:
        ids, rows, _ = self._prepare(audio, prompt)
        count = 0
        for new in self._decode_iter(ids, rows, max_tokens, sampling, seed):
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
        return not path.startswith(("model.whisper_encoder",
                                    "model.vq_adaptor"))

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """HF names -> the JAX tree's: `vq_ad(w)aptor.layers.{0,2,3}` to
        fc1/fc2/norm, a tied `lm_head` dropped, the encoder's conv weights
        to WIO from the layout their shape shows."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if k == "lm_head.weight" and self.config.tie_word_embeddings:
                continue
            k = k.replace("model.vq_adwaptor.", "model.vq_adaptor.")
            m = re.match(r"model\.vq_adaptor\.(?:layers\.)+(\d)\.(.+)", k)
            if m:
                name = {"0": "fc1", "2": "fc2", "3": "norm"}.get(m.group(1))
                if name is None:
                    continue
                k = f"model.vq_adaptor.{name}.{m.group(2)}"
            out[k] = np.asarray(v)
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3
                            and "whisper_encoder.conv" in k
                            and k.endswith(".weight"))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`; files that fail to load raise) and its digit ids;
        `processor_config.json`'s marker settings."""
        path = Path(model_path)
        model._tokenizer = local_tokenizer(path)
        if model._tokenizer is not None:
            model._digit_token_ids = digit_ids(model._tokenizer)
        pc = path / "processor_config.json"
        if pc.exists():
            c = json.loads(pc.read_text())
            model.audio_tokens_per_second = float(c.get(
                "audio_tokens_per_second", model.audio_tokens_per_second))
            model.time_marker_every_seconds = int(c.get(
                "time_marker_every_seconds",
                model.time_marker_every_seconds))
            model.enable_time_marker = bool(c.get(
                "enable_time_marker", model.enable_time_marker))
        return model


__all__ = ["Model", "ModelConfig", "AudioConfig", "StreamingResult",
           "audio_span_ids", "digit_ids", "splice_rows", "DEC_CHUNK",
           "DEFAULT_PROMPT"]
