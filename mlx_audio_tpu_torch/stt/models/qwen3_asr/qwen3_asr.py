"""Qwen3-ASR: a Whisper-style chunked audio encoder and a Qwen3 LM decoder.

Counterpart of mlx_audio_tpu/stt/models/qwen3_asr/qwen3_asr.py:

* `StreamingResult`, `feat_out_len` and `split_audio_into_chunks`
  (:57-117), copied;
* the audio tower (`init_audio_tower` :122-147, `encode_audio` :180-228):
  three stride-2 3x3 conv2d + GELU over 100-frame mel chunks, `conv_out`,
  per-chunk sinusoidal positions (`_sin_pos`), block attention over
  windows of `per_win` valid frames, `ln_post`, `proj1` + GELU, `proj2`;
* `encode` and `encode_features` (:251-301), on the port's Whisper log-mel
  (`whisper.audio.log_mel_spectrogram`);
* the LM (`init_qwen3_asr` :150-166: `model.embed_tokens`,
  `model.layers.N`, `model.norm`, `lm_head` unless tied) on the port's
  Qwen3 layers, the prompt (`_build_prompt`, `extract_language`,
  `_eos_ids`, :382-421), `_transcribe_chunk`, `generate`,
  `stream_transcribe` (:425-597), `sanitize` and `post_load_hook`.

The conv stem runs channel-first: mel chunks (C, 1, mel, time), flattened
after the stem as (channel, frequency) with frequency fastest, which is the
JAX tree's NHWC (C, freq, time, ch) flattened after its transpose, so
`conv_out` reads its inputs in the same order.

Departures from the JAX package:

* the encoder runs on the chunks and windows the audio has: no padding of
  the chunk count or the window count to powers of two (a TPU
  workaround), so no window is wholly padding and no row of the features
  is NaN; the conv stem runs `conv_chunksize` chunks at a time;
* the decode is `stt.models.qwen3_lm`'s eager prefill and chunk pair:
  draws from a `torch.Generator` (only greedy decoding compares with JAX
  token for token), a stop at most one step after EOS with the same kept
  tokens, f32 caches that grow with the decode up to bucket + max_tokens
  columns, where JAX's allocate all of them at once (about 1.9 GB at the
  default dims and max_tokens 8,192), and a step that reads only the
  columns written so far;
* a bf16 model computes in bf16 (the mel cast to it) against f32 caches;
* `sanitize` reads each conv2d weight's layout (torch OIHW, MLX OHWI, or
  the JAX tree's HWIO) from the model's own shapes, where JAX's transposes
  a weight whose last two axes are 3 and takes any other as HWIO;
* `post_load_hook` raises when the directory's tokenizer files fail to
  load, where JAX's swallows the error and leaves no tokenizer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....model import TorchModel, check_device, holder
from ....nn import Conv2d, LayerNorm, Linear, gelu
from ....ops.attention import attention
from ...models.base import STTOutput
from ...models.llm_stt import as_audio
from ...models.qwen3_lm import (DEC_CHUNK, iter_decode, make_decode_fns)
from ....tts.models.base import local_tokenizer
from ....tts.models.moss_tts.moss_tts import (Qwen3LM, lm_logits,
                                              qwen3_lm_forward)
from ..whisper.audio import log_mel_spectrogram
from .config import AudioEncoderConfig, ModelConfig, TextConfig

PROMPT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384)


@dataclass
class StreamingResult:
    """Streaming emission (reference qwen3_asr.py:20-40)."""

    text: str
    is_final: bool
    start_time: float
    end_time: float
    language: str = "en"
    prompt_tokens: int = 0
    generation_tokens: int = 0


def feat_out_len(n: int) -> int:
    """Conv-stem output length for n mel frames (reference :162-171)."""
    rem = n % 100
    f1 = (rem - 1) // 2 + 1
    f2 = (f1 - 1) // 2 + 1
    f3 = (f2 - 1) // 2 + 1
    return (n // 100) * 13 + (f3 if rem else 0)


def split_audio_into_chunks(wav: np.ndarray, sr: int,
                            chunk_duration: float = 1200.0,
                            min_chunk_duration: float = 1.0,
                            search_expand_sec: float = 5.0,
                            min_window_ms: float = 100.0
                            ) -> List[Tuple[np.ndarray, float]]:
    """Split long audio at low-energy boundaries (reference :43-131)."""
    if wav.ndim > 1:
        wav = wav.mean(axis=-1) if wav.shape[-1] <= 2 else wav.mean(axis=0)
    total = len(wav)
    if total / sr <= chunk_duration:
        if total < min_chunk_duration * sr:
            wav = np.pad(wav, (0, int(min_chunk_duration * sr) - total))
        return [(wav, 0.0)]
    chunks, start = [], 0
    max_s = int(chunk_duration * sr)
    search = int(search_expand_sec * sr)
    win = int(min_window_ms * sr / 1000)
    while start < total:
        end = min(start + max_s, total)
        if end >= total:
            chunk = wav[start:total]
            if len(chunk) < min_chunk_duration * sr:
                chunk = np.pad(chunk, (0, int(min_chunk_duration * sr)
                                       - len(chunk)))
            chunks.append((chunk, start / sr))
            break
        s0, s1 = max(start, end - search), min(total, end + search)
        region = wav[s0:s1]
        if len(region) > win:
            energy = np.convolve(region ** 2, np.ones(win) / win,
                                 mode="valid")
            cut = s0 + int(np.argmin(energy)) + win // 2
        else:
            cut = end
        cut = max(cut, start + sr)
        chunks.append((wav[start:cut], start / sr))
        start = cut
    return chunks


def _sin_pos(length: int, channels: int) -> np.ndarray:
    """Sinusoidal positions, [sin|cos] concat (reference :174-193)."""
    inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None]
    return np.concatenate([np.sin(t), np.cos(t)],
                          axis=1).astype(np.float32)


def prompt_bucket(n: int) -> int:
    """The prefill bucket of an n-token prompt (PROMPT_BUCKETS, then
    multiples of 2,048)."""
    return next((b for b in PROMPT_BUCKETS if n <= b),
                ((n + 2047) // 2048) * 2048)


# ------------------------------------------------------------------ tower


class EncoderLayer(nn.Module):
    def __init__(self, a: AudioEncoderConfig):
        super().__init__()
        d = a.d_model
        self.self_attn = holder(q_proj=Linear(d, d), k_proj=Linear(d, d),
                                v_proj=Linear(d, d), out_proj=Linear(d, d))
        self.self_attn_layer_norm = LayerNorm(d)
        self.fc1 = Linear(d, a.encoder_ffn_dim)
        self.fc2 = Linear(a.encoder_ffn_dim, d)
        self.final_layer_norm = LayerNorm(d)


class AudioTower(nn.Module):
    """init_audio_tower's tree (:122-147)."""

    def __init__(self, a: AudioEncoderConfig):
        super().__init__()
        h, d = a.downsample_hidden_size, a.d_model
        freq_after = ((((a.num_mel_bins + 1) // 2) + 1) // 2 + 1) // 2
        self.conv2d1 = Conv2d(1, h, 3)
        self.conv2d2 = Conv2d(h, h, 3)
        self.conv2d3 = Conv2d(h, h, 3)
        self.conv_out = Linear(h * freq_after, d, bias=False)
        self.layers = nn.ModuleList(EncoderLayer(a)
                                    for _ in range(a.encoder_layers))
        self.ln_post = LayerNorm(d)
        self.proj1 = Linear(d, d)
        self.proj2 = Linear(d, a.output_dim)


def conv_stem(tower: AudioTower, a: AudioEncoderConfig,
              chunks: torch.Tensor) -> torch.Tensor:
    """(C, n_mels, 100) mel chunks -> (C, t, d_model): the three stride-2
    convs with GELU, `conv_out` over (channel, frequency) features and the
    sinusoidal positions, `conv_chunksize` chunks at a time."""
    outs = []
    step = max(int(a.conv_chunksize), 1)
    for i in range(0, chunks.shape[0], step):
        x = chunks[i:i + step, None]            # (c, 1, mel, time)
        x = gelu(tower.conv2d1(x, stride=2, padding=1))
        x = gelu(tower.conv2d2(x, stride=2, padding=1))
        x = gelu(tower.conv2d3(x, stride=2, padding=1))
        c, ch, f, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(c, t, ch * f)
        outs.append(tower.conv_out(x))
    x = torch.cat(outs)
    pos = torch.from_numpy(_sin_pos(x.shape[1], x.shape[2]))
    return x + pos.to(x.device, x.dtype)[None]


def encode_audio(tower: AudioTower, a: AudioEncoderConfig,
                 mel_chunks: torch.Tensor, valid: List[int]) -> torch.Tensor:
    """(C, n_mels, 100) mel chunks and each chunk's count of valid stem
    frames -> (sum(valid), output_dim): the valid frames in order, in
    windows of per_win frames (max(valid) x n_window_infer / 100; the last
    window partial, its padded keys masked) through the block-attention
    layers, then ln_post and the projections."""
    x = conv_stem(tower, a, mel_chunks)         # (C, t, d)
    c, t, d = x.shape
    n_valid = sum(valid)
    idx = torch.cat([torch.arange(i * t, i * t + v)
                     for i, v in enumerate(valid)]).to(x.device)
    per_win = max(valid) * (a.n_window_infer // (a.n_window * 2))
    w = -(-n_valid // per_win)
    h = torch.zeros(w * per_win, d, dtype=x.dtype, device=x.device)
    h[:n_valid] = x.reshape(c * t, d)[idx]
    h = h.reshape(w, per_win, d)
    win_len = torch.full((w,), per_win, device=x.device)
    win_len[-1] = n_valid - (w - 1) * per_win
    keys = torch.arange(per_win, device=x.device)
    mask = torch.zeros(w, 1, 1, per_win, device=x.device).masked_fill(
        keys[None, None, None, :] >= win_len[:, None, None, None],
        float("-inf"))
    nh = a.encoder_attention_heads
    hd = d // nh
    for blk in tower.layers:
        r = h
        y = blk.self_attn_layer_norm(h)
        sa = blk.self_attn
        q = sa.q_proj(y).reshape(w, per_win, nh, hd)
        k = sa.k_proj(y).reshape(w, per_win, nh, hd)
        v = sa.v_proj(y).reshape(w, per_win, nh, hd)
        o = attention(q, k, v, mask=mask).reshape(w, per_win, d)
        h = r + sa.out_proj(o)
        r = h
        y = blk.final_layer_norm(h)
        h = r + blk.fc2(gelu(blk.fc1(y)))
    h = tower.ln_post(h)
    h = tower.proj2(gelu(tower.proj1(h)))
    return h.reshape(w * per_win, -1)[:n_valid]


def _to_jax_conv2d(key: str, w: np.ndarray, torch_shape) -> np.ndarray:
    """A conv2d weight in torch (O, I, kh, kw), MLX (O, kh, kw, I) or the
    JAX tree's HWIO (kh, kw, I, O) layout, told apart by the model's own
    torch shape for it -> HWIO."""
    o, i, kh, kw = torch_shape
    if w.shape == (o, i, kh, kw):
        return np.transpose(w, (2, 3, 1, 0))
    if w.shape == (kh, kw, i, o):
        return w
    if w.shape == (o, kh, kw, i):
        return np.transpose(w, (1, 2, 3, 0))
    raise ValueError(f"{key}: shape {w.shape} is none of torch's "
                     f"{tuple(torch_shape)}, MLX's {(o, kh, kw, i)} or "
                     f"HWIO {(kh, kw, i, o)}")


# ------------------------------------------------------------------ model


class Model(TorchModel):
    """Qwen3-ASR on `device`: the card by default; without CUDA the
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
        t = config.text_config
        with torch.device(device):
            self.audio_tower = AudioTower(config.audio_config)
            self.model = Qwen3LM(t)
            if not t.tie_word_embeddings:
                self.lm_head = Linear(t.hidden_size, t.vocab_size,
                                      bias=False)
        self._tokenizer = None
        self._fns: Dict = {}
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return 16000

    @property
    def dtype(self) -> torch.dtype:
        return self.model.norm.weight.dtype

    # ------------------------------------------------------------ encode

    def encode(self, audio) -> Tuple[torch.Tensor, int]:
        """Audio (16 kHz) -> ((n_tokens, output_dim) features on the
        model's device, n_tokens) through the chunked encoder."""
        a = self.config.audio_config
        mel = log_mel_spectrogram(np.asarray(audio, np.float32),
                                  n_mels=a.num_mel_bins, device=self.device)
        return self.encode_features(mel.T)

    @torch.inference_mode()
    def encode_features(self, mel) -> Tuple[torch.Tensor, int]:
        """(n_mels, T) log-mel -> ((n_tokens, output_dim), n_tokens); the
        mel-level entry point."""
        a = self.config.audio_config
        mel = torch.as_tensor(mel, dtype=torch.float32).to(self.device)
        n_frames = mel.shape[1]
        chunk = a.n_window * 2                              # 100
        c = (n_frames + chunk - 1) // chunk
        if c == 0:
            return torch.zeros(0, a.output_dim, dtype=self.dtype,
                               device=self.device), 0
        padded = torch.nn.functional.pad(mel, (0, c * chunk - n_frames))
        chunks = padded.reshape(mel.shape[0], c, chunk).permute(1, 0, 2)
        valid = [13] * (c - 1) + [feat_out_len(n_frames % chunk or chunk)]
        feats = encode_audio(self.audio_tower, a,
                             chunks.to(self.dtype).contiguous(), valid)
        return feats, sum(valid)

    # ---------------------------------------------------------------- LM

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm_logits(self, hidden)

    def _lm_forward(self, embeds, caches, offset, pad_mask):
        return qwen3_lm_forward(self.model, embeds, caches, offset, pad_mask)

    def _decode_fns(self, bucket: int, max_tokens: int, sampling,
                    eos_ids: Tuple[int, ...]):
        if isinstance(sampling, float):
            sampling = (sampling, 0, 1.0, 0.0, 1.0, 20, 1)
        key = ("lm", bucket, max_tokens, tuple(sampling), eos_ids)
        fns = self._fns.get(key)
        if fns is None:
            (temperature, top_k, top_p, min_p, repetition_penalty,
             repetition_context_size, min_tokens_to_keep) = sampling
            t = self.config.text_config
            fns = make_decode_fns(
                text_config=t, embed_fn=self.embed, logits_fn=self.logits,
                forward_fn=self._lm_forward,
                make_caches=lambda cols: self.model.make_caches(t, 1, cols),
                bucket=bucket, max_new=max_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, min_p=min_p,
                min_tokens_to_keep=min_tokens_to_keep, eos_ids=eos_ids,
                repetition_penalty=repetition_penalty,
                repetition_context_size=repetition_context_size)
            self._fns = {key: fns}
        return fns

    @torch.inference_mode()
    def prompt_embeds(self, ids: List[int], feats: torch.Tensor,
                      bucket: int) -> torch.Tensor:
        """The prompt's token embeddings (1, bucket, D), right-padded with
        id 0, each `<|audio_pad|>` row replaced by the next encoder row."""
        n = len(ids)
        tok = torch.zeros(1, bucket, dtype=torch.long)
        tok[0, :n] = torch.as_tensor(ids, dtype=torch.long)
        embeds = self.embed(tok.to(self.device))
        pos = torch.nonzero(tok[0, :n] == self.config.audio_token_id)[:, 0]
        m = min(len(pos), feats.shape[0])
        embeds[0, pos[:m].to(self.device)] = feats[:m].to(embeds.dtype)
        return embeds

    # ---------------------------------------------------------- prompting

    def _build_prompt(self, n_audio: int, language: Optional[str],
                      system_prompt: Optional[str]) -> List[int]:
        sys_c = f"{system_prompt}\n" if system_prompt else ""
        if language is not None:
            sup = {s.lower(): s for s in self.config.support_languages}
            lang = sup.get(language.lower(), language)
            prefix = f"language {lang}<asr_text>"
        else:
            prefix = ""
        prompt = (f"<|im_start|>system\n{sys_c}<|im_end|>\n"
                  f"<|im_start|>user\n<|audio_start|>"
                  f"{'<|audio_pad|>' * n_audio}<|audio_end|><|im_end|>\n"
                  f"<|im_start|>assistant\n{prefix}")
        return list(self._tokenizer.encode(prompt,
                                           add_special_tokens=False))

    @staticmethod
    def extract_language(text: str) -> Tuple[str, str]:
        if "<asr_text>" in text and text.startswith("language "):
            i = text.find("<asr_text>")
            return text[len("language "):i].strip(), \
                text[i + len("<asr_text>"):]
        return "English", text

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

    # ----------------------------------------------------------- decoding

    def _decode_chunk(self, audio: np.ndarray, language: Optional[str],
                      max_tokens: int, sampling,
                      system_prompt: Optional[str], seed: int):
        """One audio chunk: encode, prompt, prefill -> (the decode's
        generator of each chunk's kept tokens, prompt length). Its run's
        numbers land in `last_run` (the encoder's ms too)."""
        t0 = time.perf_counter()
        feats, n_audio = self.encode(audio)
        ids = self._build_prompt(n_audio, language, system_prompt)
        n = len(ids)
        pb = prompt_bucket(n)
        fns = self._decode_fns(pb, max_tokens, sampling, self._eos_ids())
        embeds = self.prompt_embeds(ids, feats, pb)
        self.last_run = {"audio_tokens": n_audio,
                         "encode_ms": (time.perf_counter() - t0) * 1e3}
        return iter_decode(fns, embeds, n, max_tokens=max_tokens, seed=seed,
                           run=self.last_run), n

    def _transcribe_chunk(self, audio: np.ndarray, language: Optional[str],
                          max_tokens: int, temperature,
                          system_prompt: Optional[str], seed: int
                          ) -> Tuple[List[int], int]:
        """One audio chunk -> (token ids, prompt length)."""
        gen, n = self._decode_chunk(audio, language, max_tokens, temperature,
                                    system_prompt, seed)
        out: List[int] = []
        for new in gen:
            out.extend(new)
        return out[:max_tokens], n

    def _require_tokenizer(self):
        if self._tokenizer is None:
            raise RuntimeError("qwen3_asr needs its HF tokenizer (place "
                               "tokenizer files in the model directory)")

    def generate(self, audio, *, max_tokens: int = 8192,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1,
                 language: Optional[str] = None,
                 chunk_duration: float = 1200.0,
                 min_chunk_duration: float = 1.0, verbose: bool = False,
                 stream: bool = False, system_prompt: Optional[str] = None,
                 seed: int = 0, **kwargs) -> STTOutput:
        sampling = (float(temperature), int(top_k), float(top_p),
                    float(min_p), float(repetition_penalty),
                    int(repetition_context_size), int(min_tokens_to_keep))
        if stream:
            return self.stream_transcribe(
                audio, max_tokens=max_tokens, temperature=sampling,
                language=language, chunk_duration=chunk_duration,
                system_prompt=system_prompt, seed=seed)
        self._require_tokenizer()
        t0 = time.time()
        audio_np = self._load(audio)
        chunks = split_audio_into_chunks(audio_np, self.sample_rate,
                                         chunk_duration,
                                         min_chunk_duration)
        texts, segments = [], []
        p_tok = g_tok = 0
        remaining = max_tokens
        for wav, off in chunks:
            if remaining <= 0:
                break
            toks, n_prompt = self._transcribe_chunk(
                wav, language, remaining, sampling, system_prompt, seed)
            text = self._tokenizer.decode(toks, skip_special_tokens=True)
            if language is None:
                language, text = self.extract_language(text)
            texts.append(text)
            p_tok += n_prompt
            g_tok += len(toks)
            remaining -= len(toks)
            segments.append({"text": text, "language": language,
                             "start": off,
                             "end": off + len(wav) / self.sample_rate})
        dt = time.time() - t0
        return STTOutput(
            text=" ".join(texts), segments=segments,
            language=[s["language"] for s in segments],
            prompt_tokens=p_tok, generation_tokens=g_tok,
            total_tokens=p_tok + g_tok, total_time=dt,
            prompt_tps=p_tok / dt if dt > 0 else 0,
            generation_tps=g_tok / dt if dt > 0 else 0)

    def stream_transcribe(self, audio, *, max_tokens: int = 8192,
                          temperature=0.0,
                          language: Optional[str] = None,
                          chunk_duration: float = 1200.0,
                          min_chunk_duration: float = 1.0,
                          system_prompt: Optional[str] = None,
                          seed: int = 0, **kwargs
                          ) -> Generator[StreamingResult, None, None]:
        """Yield the new text of each decode chunk (DEC_CHUNK steps), then
        a final marker per audio chunk (reference :1436-1590)."""
        self._require_tokenizer()
        audio_np = self._load(audio)
        chunks = split_audio_into_chunks(audio_np, self.sample_rate,
                                         chunk_duration,
                                         min_chunk_duration)
        p_tok = g_tok = 0
        remaining = max_tokens
        for ci, (wav, off) in enumerate(chunks):
            dur = len(wav) / self.sample_rate
            gen, n = self._decode_chunk(wav, language, remaining,
                                        temperature, system_prompt, seed)
            p_tok += n
            emitted = 0
            acc: List[int] = []
            for new in gen:
                acc.extend(new)
                emitted += len(new)
                if new:
                    text = self._tokenizer.decode(
                        new, skip_special_tokens=True)
                    frac0 = (emitted - len(new)) / max(remaining, 1)
                    frac1 = min(emitted / max(remaining, 1), 1.0)
                    yield StreamingResult(
                        text=text, is_final=False,
                        start_time=off + dur * frac0,
                        end_time=off + dur * frac1,
                        language=language or "auto")
            if language is None and acc:
                full = self._tokenizer.decode(acc, skip_special_tokens=True)
                language, _ = self.extract_language(full)
            g_tok += emitted
            remaining -= emitted
            yield StreamingResult(
                text="", is_final=(ci == len(chunks) - 1
                                   or remaining <= 0),
                start_time=off, end_time=off + dur,
                language=language or "English",
                prompt_tokens=p_tok, generation_tokens=g_tok)
            if remaining <= 0:
                break

    @staticmethod
    def _load(audio) -> np.ndarray:
        return as_audio(audio, 16000)

    # ------------------------------------------------------------ loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """HF names -> the JAX tree: the `thinker.` prefix dropped, a tied
        `lm_head.weight` dropped, conv2d weights to HWIO (from torch,
        MLX or HWIO layouts, read against the model's shapes);
        `model.load_jax_params` converts to the port's layouts."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if k.startswith("thinker."):
                k = k[len("thinker."):]
            if k == "lm_head.weight" and self.config.text_config \
                    .tie_word_embeddings:
                continue
            v = v if isinstance(v, np.ndarray) else np.asarray(v)
            if "conv2d" in k and k.endswith("weight") and v.ndim == 4 \
                    and k in shapes:
                v = _to_jax_conv2d(k, v, shapes[k])
            out[k] = v
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path))
        return model


__all__ = ["Model", "ModelConfig", "AudioEncoderConfig", "TextConfig",
           "StreamingResult", "AudioTower", "encode_audio", "conv_stem",
           "feat_out_len", "split_audio_into_chunks", "prompt_bucket",
           "DEC_CHUNK"]
