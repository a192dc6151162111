"""Cohere ASR: a FastConformer encoder and a transformer decoder.

Counterpart of mlx_audio_tpu/stt/models/cohere_asr/cohere_asr.py:

* the configs (:64-138), the energy chunker `split_audio_chunks_energy`
  and `_quietest_split` (:143-182), `join_chunk_texts` (:185-188) and the
  silero-VAD segmentation `segment_with_silero` (:191-263), copied as host
  numpy;
* the front end `_log_mel` (:330-363): preemphasis, a host rfft, the slaney
  mel of the port's `dsp.mel_filters`, ln(mel + 2^-24) and per-feature
  normalization over the valid frames (ddof=1), in host numpy;
* the parameter tree `encoder` (the shared `parakeet.conformer`),
  `decoder` (the shared `canary.TransformerDecoder`) and `encoder_proj`
  when the widths differ, so `model.load_jax_params` fills it;
* `encode` over `MEL_BUCKETS` with validity masks, the batched greedy
  `decode` (the counterpart of the `lax.while_loop` at :387-421),
  `_transcribe_segments`, `_prompt_tokens`, `transcribe`, `generate`,
  `_to_mono`, `set_vad_model`, `sanitize` and `post_load_hook`.

Departures from the JAX package:

* **Rows.** Each batch runs at its real row count: with nothing compiled
  per shape, a trailing batch of 3 segments runs 3 rows where JAX pads it to
  the full batch. `encode` gives finite rows for a row of length 0 (JAX's
  are NaN: its attention mask leaves them no key), and `decode` starts such
  a row finished, so a batch stops once its real rows reach EOS. JAX's
  padded rows emit token 0 forever, so its loop always runs `max_tokens`
  steps for a padded batch.
* **Eager decode.** The loop is Python over eager steps. The argmax, the
  per-row EOS flags and the kept tokens stay on the device; each step's
  flags are copied to the host without blocking (`ops/host_flags.py`) and
  step i+1 starts only once step i-1's flags are read, so the loop stops at
  most `STEPS_AFTER_EOS` step after the one where every row finished (JAX
  stops at once), with the same kept tokens. The decoder step whose logits
  no kept token needs (after the last) is not run.
* **Compute dtype.** A bf16 model computes in bf16 (the mel is cast to
  it), with f32 softmax, f32 batch-norm statistics and f32 self-attention
  caches; JAX promotes its bf16 weights against the f32 mel. An f32 model
  computes as JAX does.
* **Loading.** `post_load_hook` takes a `tokenizer.model` through
  sentencepiece (and raises if the package is missing) or else a
  `tokens.json` piece list; the checkpoint's `preprocessor.featurizer.fb`
  and `window` are read with `utils.load_weights` (npz or safetensors),
  where JAX reads safetensors only and swallows any error there. `vad=True`
  needs a model given to `set_vad_model`: the silero VAD family is not
  ported, and nothing is downloaded.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ....base import BaseModelArgs
from ....dsp import hanning, mel_filters
from ....model import TorchModel, check_device
from ....nn import Linear
from ....ops.host_flags import FinishedFlags
from ....ops.kvcache import KVCache
from ....utils import load_audio, load_weights, resample_audio
from ..base import STTOutput
from ..canary.canary import (CanaryTokenizer, DecoderConfig as
                             _DecoderInnerConfig, TransformerDecoder,
                             _fixed_positions, cross_kv, decoder_forward,
                             encoder_bias, logits)
from ..parakeet.conformer import (Conformer, ConformerArgs,
                                  conformer_forward, subsampled_length)

NO_SPACE_LANGS = {"ja", "zh"}
MEL_BUCKETS = (256, 512, 1024, 2048, 3584)
LOG_GUARD = 2.0 ** -24
# steps the decode may run after the one where every row has finished: it
# reads the flags of step i-1 before launching step i+1
STEPS_AFTER_EOS = 1
PREPROCESSOR_BUFFERS = ("preprocessor.featurizer.fb",
                        "preprocessor.featurizer.window")


@dataclass
class PreprocessorConfig(BaseModelArgs):
    sample_rate: int = 16000
    normalize: str = "per_feature"
    features: int = 128
    n_fft: int = 512
    window_size: float = 0.025
    window_stride: float = 0.01
    window: str = "hann"
    preemph: float = 0.97
    pad_value: float = 0.0
    log: bool = True

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)


@dataclass
class HeadConfig(BaseModelArgs):
    hidden_size: int = 1024
    num_classes: int = 16384
    log_softmax: bool = True


@dataclass
class DecoderConfig(BaseModelArgs):
    config_dict: Optional[dict] = None

    def inner(self) -> _DecoderInnerConfig:
        d = dict(self.config_dict or {})
        d.setdefault("num_attention_heads", 8)
        return _DecoderInnerConfig.from_dict(d)


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "cohere_asr"
    vocab_size: int = 16384
    encoder: dict = field(default_factory=dict)
    transf_decoder: Optional[DecoderConfig] = None
    head: Optional[HeadConfig] = None
    preprocessor: Optional[PreprocessorConfig] = None
    max_audio_clip_s: float = 35.0
    overlap_chunk_second: float = 5.0
    min_energy_window_samples: int = 1600
    batch_size: int = 8
    sample_rate: int = 16000
    supported_languages: List[str] = field(default_factory=lambda: [
        "en", "fr", "de", "es", "it", "pt", "nl", "pl", "el", "ar",
        "ja", "zh", "vi", "ko"])

    def __post_init__(self):
        if isinstance(self.transf_decoder, dict):
            self.transf_decoder = DecoderConfig.from_dict(self.transf_decoder)
        if self.transf_decoder is None:
            self.transf_decoder = DecoderConfig()
        if isinstance(self.head, dict):
            self.head = HeadConfig.from_dict(self.head)
        if self.head is None:
            self.head = HeadConfig(num_classes=self.vocab_size)
        if isinstance(self.preprocessor, dict):
            self.preprocessor = PreprocessorConfig.from_dict(self.preprocessor)
        if self.preprocessor is None:
            self.preprocessor = PreprocessorConfig()

    def conformer_args(self) -> ConformerArgs:
        valid = set(ConformerArgs.__dataclass_fields__)
        enc = {k: v for k, v in (self.encoder or {}).items() if k in valid}
        enc.setdefault("feat_in", self.preprocessor.features)
        return ConformerArgs(**enc)


# ---------------------------------------------------------------- chunking

def split_audio_chunks_energy(
    waveform: np.ndarray,
    sample_rate: int,
    max_audio_clip_s: float,
    overlap_chunk_second: float,
    min_energy_window_samples: int,
) -> List[Tuple[int, int]]:
    """Split at the quietest window near each max-length boundary."""
    waveform = np.asarray(waveform, np.float32)
    chunk_size = max(1, int(round(max_audio_clip_s * sample_rate)))
    ctx = max(1, int(round(overlap_chunk_second * sample_rate)))
    total = waveform.shape[0]
    if total <= chunk_size:
        return [(0, total)]
    chunks = []
    start = 0
    while start < total:
        if start + chunk_size >= total:
            chunks.append((start, total))
            break
        s0 = max(start, start + chunk_size - ctx)
        s1 = min(start + chunk_size, total)
        split = _quietest_split(waveform, s0, s1, min_energy_window_samples)
        split = max(start + 1, min(split, total))
        chunks.append((start, split))
        start = split
    return chunks


def _quietest_split(waveform: np.ndarray, start: int, end: int,
                    window: int) -> int:
    seg = waveform[start:end]
    if seg.shape[0] <= window:
        return (start + end) // 2
    usable = (seg.shape[0] // window) * window
    if usable <= 0:
        return (start + end) // 2
    energies = np.mean(seg[:usable].reshape(-1, window) ** 2, axis=1)
    return start + int(np.argmin(energies)) * window


def join_chunk_texts(texts, language: str) -> str:
    parts = [t.strip() for t in texts if t and t.strip()]
    sep = "" if language in NO_SPACE_LANGS else " "
    return sep.join(parts)


def segment_with_silero(
    waveform: np.ndarray,
    vad_model,
    sample_rate: int = 16000,
    *,
    threshold: float = 0.5,
    merge_gap_s: float = 1.0,
    max_chunk_s: float = 30.0,
    min_speech_duration_ms: int = 250,
    min_silence_duration_ms: int = 100,
    speech_pad_ms: int = 30,
) -> List[Tuple[int, int]]:
    """Silero-probability speech runs pooled to 256 ms blocks, merged across
    small gaps and capped at max_chunk_s."""
    chunk = 512
    blocks_per = 8
    block = chunk * blocks_per
    block_s = block / sample_rate
    probs32 = np.asarray(
        vad_model.predict_proba(np.asarray(waveform, np.float32),
                                sample_rate)).reshape(-1)
    n = (probs32.shape[0] // blocks_per) * blocks_per
    if n == 0:
        return [(0, int(waveform.shape[0]))]
    probs = 1.0 - np.prod((1.0 - probs32[:n]).reshape(-1, blocks_per), axis=1)
    pad_b = max(0, int(speech_pad_ms / 1000 / block_s))
    min_speech_b = max(1, int(min_speech_duration_ms / 1000 / block_s))
    min_sil_b = max(1, int(min_silence_duration_ms / 1000 / block_s))
    total = int(waveform.shape[0])

    runs = []
    in_speech, seg_start, last_speech, silent = False, 0, -1, 0
    for idx, p in enumerate(probs):
        if p >= threshold:
            if not in_speech:
                seg_start, in_speech = max(0, idx - pad_b), True
            last_speech, silent = idx, 0
        elif in_speech:
            silent += 1
            if silent >= min_sil_b:
                seg_end = min(last_speech + 1 + pad_b, len(probs))
                if seg_end - seg_start >= min_speech_b:
                    s, e = seg_start * block, min(seg_end * block, total)
                    if s < e:
                        runs.append((s, e))
                in_speech, silent, last_speech = False, 0, -1
    if in_speech:
        seg_end = min(len(probs), last_speech + 1 + pad_b)
        if seg_end - seg_start >= min_speech_b:
            s, e = seg_start * block, min(seg_end * block, total)
            if s < e:
                runs.append((s, e))
    if not runs:
        return [(0, total)]
    # merge across gaps and cap chunk length
    max_chunk = int(max_chunk_s * sample_rate)
    max_gap = int(merge_gap_s * sample_rate)

    def split_long(s, e):
        out = []
        while s < e:
            out.append([s, min(s + max_chunk, e)])
            s = min(s + max_chunk, e)
        return out

    merged = split_long(*runs[0])
    for s, e in runs[1:]:
        prev = merged[-1]
        if s - prev[1] <= max_gap and e - prev[0] <= max_chunk:
            prev[1] = e
        else:
            merged.extend(split_long(s, e))
    return [(s, e) for s, e in merged]


# ------------------------------------------------------------------- model

def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _center_pad(w: np.ndarray, n_fft: int) -> np.ndarray:
    """A window of win_length samples, zero-padded about its centre to
    n_fft."""
    pad = n_fft - w.shape[0]
    if pad <= 0:
        return w
    return np.concatenate([np.zeros(pad // 2, np.float32), w,
                           np.zeros(pad - pad // 2, np.float32)])


class Model(TorchModel):
    """Cohere ASR on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda"):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        self.args = config.conformer_args()
        self.dec_cfg = config.transf_decoder.inner()
        d = self.dec_cfg.hidden_size
        with torch.device(device):
            self.encoder = Conformer(self.args)
            self.decoder = TransformerDecoder(self.dec_cfg,
                                              config.head.num_classes, d)
            self.encoder_proj = (Linear(self.args.d_model, d)
                                 if self.args.d_model != d else None)
        self.requires_grad_(False)
        self.eval()
        # the decoder's fixed positions, f32 on the device (not a parameter)
        self.pos_table = torch.from_numpy(_fixed_positions(
            self.dec_cfg.max_sequence_length, d)).to(device)
        self._tokenizer: Optional[CanaryTokenizer] = None
        self._mel_fb: Optional[np.ndarray] = None
        self._window: Optional[np.ndarray] = None
        self._vad_model = None
        self.last_run: Dict[str, int] = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the parameters: the compute dtype."""
        return self.decoder.embedding.weight.dtype

    # ------------------------------------------------------------ frontend

    def _fb(self) -> np.ndarray:
        if self._mel_fb is None:
            pp = self.config.preprocessor
            self._mel_fb = mel_filters(
                pp.sample_rate, pp.n_fft, pp.features, norm="slaney",
                mel_scale="slaney").numpy()
        return self._mel_fb

    def _stft_window(self) -> np.ndarray:
        if self._window is None:
            pp = self.config.preprocessor
            self._window = _center_pad(
                hanning(pp.win_length, periodic=False).numpy(), pp.n_fft)
        return self._window

    def _log_mel(self, audio: np.ndarray) -> Tuple[np.ndarray, int]:
        """waveform -> (per-feature-normalized log mel (T, F), valid frames).

        Slaney-mel power spectrogram with preemphasis and ln(mel + 2^-24)
        guard; per-feature mean/std over valid frames with ddof=1. Inference
        is deterministic: no dither noise."""
        pp = self.config.preprocessor
        x = np.asarray(audio, np.float32).reshape(-1)
        if pp.preemph and x.shape[0] > 1:
            x = np.concatenate([x[:1], x[1:] - pp.preemph * x[:-1]])
        pad = pp.n_fft // 2
        xp = np.pad(x, (pad, pad))
        n_frames = 1 + (len(xp) - pp.n_fft) // pp.hop_length
        idx = (np.arange(pp.n_fft)[None, :]
               + pp.hop_length * np.arange(n_frames)[:, None])
        frames = xp[idx] * self._stft_window()[None, :]
        power = np.square(np.abs(np.fft.rfft(frames, axis=-1)))  # (T', F)
        mel = power @ self._fb().T                              # (T', n_mels)
        if pp.log:
            mel = np.log(mel + LOG_GUARD)
        seq_len = min(max(x.shape[0] // pp.hop_length, 0), mel.shape[0])
        if pp.normalize == "per_feature" and seq_len > 0:
            valid = mel[:seq_len]
            mean = valid.mean(axis=0, keepdims=True)
            std = valid.std(axis=0, ddof=1, keepdims=True) if seq_len > 1 \
                else np.zeros_like(mean)
            mel = (mel - mean) / (std + 1e-5)
        mel = mel[:seq_len]
        return mel.astype(np.float32), seq_len

    # ------------------------------------------------------------- encoder

    def features(self, segments: List[np.ndarray]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batch's log-mels, zero-padded to their `MEL_BUCKETS` bucket
        (and cut to the last), and their lengths in frames, on the device:
        (B, bucket, F) f32 and (B,) int64."""
        mels = [self._log_mel(s)[0] for s in segments]
        tb = _bucket(max(len(m) for m in mels), MEL_BUCKETS)
        feats = np.zeros((len(mels), tb, self.config.preprocessor.features),
                         np.float32)
        for r, m in enumerate(mels):
            feats[r, :min(len(m), tb)] = m[:tb]
        lens = np.array([min(len(m), tb) for m in mels], np.int64)
        return (torch.from_numpy(feats).to(self.device),
                torch.from_numpy(lens).to(self.device))

    @torch.inference_mode()
    def encode(self, feats: torch.Tensor,
               lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats (B, T, F) and lengths (B,) in mel frames, on the device ->
        (encoder output (B, T', d_dec), valid frames (B, T') bool). A row
        of length 0 comes out finite."""
        enc = conformer_forward(self.encoder, self.args,
                                feats.to(self.dtype), lengths)
        if self.encoder_proj is not None:
            enc = self.encoder_proj(enc)
        n = subsampled_length(self.args, lengths)
        mask = torch.arange(enc.shape[1], device=enc.device)[None, :] \
            < n[:, None]
        return enc, mask

    # ------------------------------------------------------------- decoder

    @torch.inference_mode()
    def decode(self, enc: torch.Tensor, enc_mask: torch.Tensor,
               prompt: List[int], max_tokens: int,
               eos_id: int) -> Tuple[torch.Tensor, int]:
        """Batched greedy decode -> (tokens (B, max_tokens) on the device,
        EOS from each row's first EOS on; decode steps run). A row with no
        valid encoder frame starts finished."""
        cfg = self.dec_cfg
        b, dev = enc.shape[0], enc.device
        plen = len(prompt)
        ckv = cross_kv(self.decoder, cfg, enc)
        ebias = encoder_bias(enc_mask)
        caches = KVCache.init(b, plen + max_tokens, cfg.num_attention_heads,
                              cfg.hidden_size // cfg.num_attention_heads,
                              dtype=torch.float32, device=dev,
                              n_layers=cfg.num_layers)
        ids = torch.tensor(prompt, device=dev).expand(b, plen)
        h = decoder_forward(self.decoder, cfg, ids, ebias, caches, ckv, 0,
                            self.pos_table)
        lg = logits(self.decoder, h[:, -1])
        toks = torch.full((b, max_tokens), eos_id, dtype=torch.long,
                          device=dev)
        done = ~enc_mask.any(dim=1)
        flags = FinishedFlags(max(max_tokens, 1), done)
        lag = STEPS_AFTER_EOS + 1
        steps = 0
        for i in range(max_tokens):
            if i >= lag and bool(flags.read(i - lag).all()):
                break
            nxt = torch.where(done, eos_id, lg.argmax(dim=-1))
            done = done | (nxt == eos_id)
            toks[:, i] = nxt
            flags.record(i, done)
            steps = i + 1
            if steps < max_tokens:
                h = decoder_forward(self.decoder, cfg, nxt[:, None], ebias,
                                    caches, ckv, plen + i, self.pos_table)
                lg = logits(self.decoder, h[:, 0])
        return toks, steps

    def _transcribe_segments(
        self, segments: List[np.ndarray], language: str, punctuation: bool,
        batch_size: int, max_tokens: int,
    ) -> Tuple[List[str], List[int], int]:
        if self._tokenizer is None:
            raise RuntimeError(
                "tokenizer not loaded (place tokenizer.model / tokens.json "
                "beside the weights)")
        tok = self._tokenizer
        prompt = self._prompt_tokens(language, punctuation)
        eos_id = tok.eos_id
        order = sorted(range(len(segments)),
                       key=lambda i: segments[i].shape[0], reverse=True)
        texts = [""] * len(segments)
        counts = [0] * len(segments)
        max_tokens = max(0, min(int(max_tokens),
                                self.dec_cfg.max_sequence_length
                                - len(prompt)))
        run = {"segments": len(segments), "batches": 0, "decode_steps": 0}
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            enc, enc_mask = self.encode(*self.features(
                [segments[i] for i in idxs]))
            toks, steps = self.decode(enc, enc_mask, prompt, max_tokens,
                                      eos_id)
            toks = toks.cpu().numpy()
            run["batches"] += 1
            run["decode_steps"] += steps
            for r, i in enumerate(idxs):
                row = toks[r]
                stop = np.flatnonzero(row == eos_id)
                gen = row[: stop[0]] if stop.size else row
                texts[i] = tok.decode(gen.tolist()).strip()
                counts[i] = int(gen.shape[0])
        self.last_run = run
        return texts, counts, len(prompt)

    def _prompt_tokens(self, language: str, punctuation: bool) -> List[int]:
        t = self._tokenizer.token2id
        names = ["<|startofcontext|>", "<|startoftranscript|>",
                 "<|emo:undefined|>", f"<|{language}|>", f"<|{language}|>",
                 "<|pnc|>" if punctuation else "<|nopnc|>",
                 "<|noitn|>", "<|notimestamp|>", "<|nodiarize|>"]
        return [t[n] for n in names]

    # ----------------------------------------------------------- generate

    def transcribe(self, *, language: str, audio_files=None,
                   audio_arrays=None, sample_rates=None,
                   punctuation: bool = True, batch_size: Optional[int] = None,
                   max_tokens: int = 256) -> List[str]:
        """Multi-file batch API: one text per file or array."""
        if (audio_files is None) == (audio_arrays is None):
            raise ValueError("provide exactly one of audio_files/audio_arrays")
        self._validate_language(language)
        if audio_files is not None:
            waves = [load_audio(str(f), self.sample_rate)
                     for f in audio_files]
        else:
            if sample_rates is None or len(sample_rates) != len(audio_arrays):
                raise ValueError("sample_rates must match audio_arrays")
            waves = [self._to_mono(a, sr)
                     for a, sr in zip(audio_arrays, sample_rates)]
        if not waves:
            return []
        seg_waves, seg_meta = self._prepare_segments(waves)
        texts, _, _ = self._transcribe_segments(
            seg_waves, language, punctuation,
            batch_size or self.config.batch_size, max_tokens)
        outputs = [""] * len(waves)
        grouped: Dict[int, List[Tuple[int, str]]] = {}
        for meta, text in zip(seg_meta, texts):
            if meta["chunk_idx"] is None:
                outputs[meta["sample_idx"]] = text
            else:
                grouped.setdefault(meta["sample_idx"], []).append(
                    (meta["chunk_idx"], text))
        for i, items in grouped.items():
            items.sort()
            outputs[i] = join_chunk_texts([t for _, t in items], language)
        return outputs

    def generate(self, audio, *, language: str = "en",
                 punctuation: bool = True, batch_size: Optional[int] = None,
                 max_tokens: int = 256, verbose: bool = False,
                 stream: bool = False, sample_rate: Optional[int] = None,
                 vad: Union[bool, str] = False, vad_merge_gap_s: float = 1.0,
                 vad_max_chunk_s: float = 30.0, **kwargs) -> STTOutput:
        """Greedy transcription of `audio` (a path, or samples at
        `sample_rate`, 16 kHz by default): split at quiet points (or by
        VAD) into segments of at most `max_audio_clip_s`, decoded in
        batches of `batch_size`."""
        if stream:
            raise NotImplementedError(
                "streaming generation is not implemented for Cohere ASR")
        t0 = time.time()
        self._validate_language(language)
        if isinstance(audio, (str, Path)):
            wave = load_audio(str(audio), self.sample_rate)
        else:
            wave = self._to_mono(audio, sample_rate)
        if vad:
            spans = segment_with_silero(
                wave, self._get_vad(vad), self.sample_rate,
                merge_gap_s=vad_merge_gap_s, max_chunk_s=vad_max_chunk_s)
            seg_waves = [wave[s:e] for s, e in spans]
            seg_meta = [{"start": s / self.sample_rate,
                         "end": e / self.sample_rate} for s, e in spans]
        else:
            seg_waves, seg_meta = self._prepare_segments([wave])
        texts, counts, prompt_len = self._transcribe_segments(
            seg_waves, language, punctuation,
            batch_size or self.config.batch_size, max_tokens)
        segments = [{"text": t, "start": float(m["start"]),
                     "end": float(m["end"])}
                    for m, t in zip(seg_meta, texts)]
        text = join_chunk_texts(texts, language)
        dt = time.time() - t0
        gen_tokens = int(sum(counts))
        prompt_tokens = prompt_len * len(seg_waves)
        if verbose:
            print(text)
        return STTOutput(
            text=text, segments=segments, language=language,
            prompt_tokens=prompt_tokens, generation_tokens=gen_tokens,
            total_tokens=prompt_tokens + gen_tokens, total_time=dt,
            prompt_tps=prompt_tokens / dt if dt > 0 else 0.0,
            generation_tps=gen_tokens / dt if dt > 0 else 0.0)

    # ------------------------------------------------------------ helpers

    def _validate_language(self, language: str):
        if language not in set(self.config.supported_languages):
            raise ValueError(
                f"Unsupported language '{language}'. Supported: "
                f"{sorted(self.config.supported_languages)}")

    def _to_mono(self, audio, sample_rate: Optional[int]) -> np.ndarray:
        arr = np.asarray(audio, np.float32)
        if arr.ndim == 2:
            arr = arr.mean(axis=0 if arr.shape[0] <= 8
                           and arr.shape[1] > arr.shape[0] else 1)
        if arr.ndim != 1:
            raise ValueError(f"expected mono waveform, got {arr.shape}")
        if sample_rate is not None and sample_rate != self.sample_rate:
            arr = np.asarray(resample_audio(arr, sample_rate,
                                            self.sample_rate), np.float32)
        return arr

    def _prepare_segments(self, waves: List[np.ndarray]):
        cfg = self.config
        fast_path_s = max(0.0, cfg.max_audio_clip_s - cfg.overlap_chunk_second)
        seg_waves, seg_meta = [], []
        for si, w in enumerate(waves):
            dur = w.shape[0] / self.sample_rate
            if dur <= fast_path_s:
                seg_waves.append(w)
                seg_meta.append({"sample_idx": si, "chunk_idx": None,
                                 "start": 0.0, "end": dur})
                continue
            for ci, (s, e) in enumerate(split_audio_chunks_energy(
                    w, self.sample_rate, cfg.max_audio_clip_s,
                    cfg.overlap_chunk_second, cfg.min_energy_window_samples)):
                seg_waves.append(w[s:e])
                seg_meta.append({"sample_idx": si, "chunk_idx": ci,
                                 "start": s / self.sample_rate,
                                 "end": e / self.sample_rate})
        return seg_waves, seg_meta

    def _get_vad(self, selector):
        if selector is not True and selector != "silero-mlx":
            raise ValueError(
                f"unknown vad backend: {selector!r} "
                "(supported: True, 'silero-mlx')")
        if self._vad_model is None:
            raise RuntimeError(
                "vad=True needs a silero VAD model: the silero VAD family is "
                "not ported to mlx_audio_tpu_torch yet; pass a loaded one "
                "(an object with predict_proba(audio, sample_rate)) to "
                "set_vad_model()")
        return self._vad_model

    def set_vad_model(self, model):
        """Inject a loaded silero VAD model."""
        self._vad_model = model

    # ------------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """NeMo/Cohere checkpoint names -> the JAX tree's names, and torch
        conv layouts to the JAX tree's HWIO/WIO, as numpy;
        `model.load_jax_params` converts to the port's layouts. The
        preprocessor's buffers and `num_batches_tracked` are dropped."""
        out = {}
        sub_map = {"conv.0.": "layers.00_conv.", "conv.2.": "layers.01_dw.",
                   "conv.3.": "layers.02_pw.", "conv.5.": "layers.03_dw.",
                   "conv.6.": "layers.04_pw."}
        renames = (
            ("transf_decoder._embedding.", "transf_decoder.embedding."),
            ("transf_decoder._decoder.", "transf_decoder.decoder."),
            ("transf_decoder.decoder.layers.", "decoder.blocks."),
            ("transf_decoder.decoder.final_layer_norm.",
             "decoder.final_norm."),
            ("transf_decoder.embedding.token_embedding.",
             "decoder.embedding."),
            ("transf_decoder.embedding.layer_norm.",
             "decoder.embedding_layer_norm."),
            (".layer_norm_1.", ".self_attn_norm."),
            (".layer_norm_2.", ".cross_attn_norm."),
            (".layer_norm_3.", ".ff_norm."),
            (".first_sub_layer.", ".self_attn."),
            (".second_sub_layer.", ".cross_attn."),
            (".query_net.", ".q_proj."), (".key_net.", ".k_proj."),
            (".value_net.", ".v_proj."), (".out_projection.", ".out_proj."),
            (".third_sub_layer.dense_in.", ".ff1."),
            (".third_sub_layer.dense_out.", ".ff2."),
            ("log_softmax.mlp.layer0.", "decoder.output_proj."),
            ("encoder_decoder_proj.", "encoder_proj."))
        for k, v in weights.items():
            if k.startswith("preprocessor.") or \
                    k.endswith("num_batches_tracked"):
                continue
            v = np.asarray(v)
            if k.startswith("encoder.pre_encode."):
                for old, new in sub_map.items():
                    k = k.replace("pre_encode." + old, "pre_encode." + new)
            for old, new in renames:
                k = k.replace(old, new)
            if k.endswith("weight") and v.ndim == 4:
                v = np.transpose(v, (2, 3, 1, 0))       # OIHW -> HWIO
            elif k.endswith("weight") and v.ndim == 3 and (
                    ".conv" in k or "_dw" in k or "_pw" in k
                    or "pre_encode" in k):
                v = np.transpose(v, (2, 1, 0))          # OIK -> WIO
            out[k] = v
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The tokenizer (`tokenizer.model` through sentencepiece, else a
        `tokens.json` piece list) and the checkpoint's mel filterbank and
        window, which override the analytic ones."""
        model_path = Path(model_path)
        if (model_path / "tokenizer.model").exists():
            model._tokenizer = CanaryTokenizer(
                str(model_path / "tokenizer.model"))
        elif (model_path / "tokens.json").exists():
            model._tokenizer = CanaryTokenizer(piece_list=json.loads(
                (model_path / "tokens.json").read_text(encoding="utf-8")))
        buf = load_weights(model_path, keys=PREPROCESSOR_BUFFERS)
        fb = buf.get("preprocessor.featurizer.fb")
        if fb is not None:
            fb = np.asarray(fb, np.float32)
            model._mel_fb = fb.reshape(-1, fb.shape[-1])
        win = buf.get("preprocessor.featurizer.window")
        if win is not None:
            model._window = _center_pad(np.asarray(win, np.float32),
                                        model.config.preprocessor.n_fft)
        return model


__all__ = ["Model", "ModelConfig", "split_audio_chunks_energy",
           "segment_with_silero", "join_chunk_texts"]
