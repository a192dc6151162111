"""Whisper encoder-decoder speech-to-text.

Counterpart of mlx_audio_tpu/stt/models/whisper/whisper.py:

* `ModelDimensions` (OpenAI and HF config keys), `sinusoids`;
* the parameter tree as `nn.Module`s named after the JAX leaves
  (`encoder.conv1/conv2/blocks.N.{attn.{query,key,value,out},attn_ln,mlp1,
  mlp2,mlp_ln}/ln_post`, `decoder.token_embedding/positional_embedding/
  blocks.N.{..., cross_attn, cross_attn_ln}/ln`), so `model.load_jax_params`
  fills it from the JAX tree (or from a checkpoint through `sanitize`);
* `encoder_forward`, `cross_kv`, `decoder_forward` (a per-layer cache of
  `n_text_ctx` columns written at `offset`, attended through an additive
  mask over the whole buffer) and `decoder_forward_with_cross_qk`;
* `Model.generate`: the windowed transcription with its temperature
  fallback, timestamp segmentation, prompt conditioning, word timestamps
  and hallucination skipping; `generate(stream=True)` and
  `generate_streaming` run the local-agreement streaming session.

Compute dtype: the encoder casts the mel to the parameters' floating dtype,
so caches, cross K/V and logits follow it. An f32 model computes as the JAX
package does; a bf16 model runs its products in bf16 on tensor cores with
the attention softmax in f32 (`F.scaled_dot_product_attention`, one scale
hd**-0.5 for JAX's hd**-0.25 on each of q and k), where the JAX package's
einsums promote bf16 weights against the f32 mel and compute in f32.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....model import TorchModel, check_device
from ....nn import Conv1d, Embedding, LayerNorm, Linear, gelu
from ....ops.kvcache import KVCache, kv_update
from ..base import STTOutput
from .audio import (FRAMES_PER_SECOND, HOP_LENGTH, SAMPLE_RATE,
                    log_mel_spectrogram, pad_or_trim)
from .tokenizer import WhisperTokenizer, get_tokenizer


@dataclass
class ModelDimensions:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @classmethod
    def from_dict(cls, config: dict) -> "ModelDimensions":
        config = dict(config)
        if "d_model" in config or "encoder_layers" in config:
            return cls(
                n_mels=config.get("num_mel_bins", 128),
                n_audio_ctx=config.get("max_source_positions", 1500),
                n_audio_state=config.get("d_model", 1280),
                n_audio_head=config.get("encoder_attention_heads", 20),
                n_audio_layer=config.get("encoder_layers", 32),
                n_vocab=config.get("vocab_size", 51866),
                n_text_ctx=config.get("max_target_positions", 448),
                n_text_state=config.get("d_model", 1280),
                n_text_head=config.get("decoder_attention_heads", 20),
                n_text_layer=config.get("decoder_layers", 32),
            )
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in config.items() if k in known})


ModelConfig = ModelDimensions


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> np.ndarray:
    """(length, channels) f32 sinusoidal positions, built on the host in
    float64."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# parameter tree
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int):
        super().__init__()
        self.query = Linear(n_state, n_state)
        self.key = Linear(n_state, n_state, bias=False)
        self.value = Linear(n_state, n_state)
        self.out = Linear(n_state, n_state)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, cross: bool):
        super().__init__()
        self.attn = MultiHeadAttention(n_state)
        self.attn_ln = LayerNorm(n_state)
        self.mlp1 = Linear(n_state, 4 * n_state)
        self.mlp2 = Linear(4 * n_state, n_state)
        self.mlp_ln = LayerNorm(n_state)
        if cross:
            self.cross_attn = MultiHeadAttention(n_state)
            self.cross_attn_ln = LayerNorm(n_state)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp2(gelu(self.mlp1(self.mlp_ln(x))))


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = Conv1d(dims.n_mels, d, 3)
        self.conv2 = Conv1d(d, d, 3)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, False)
                                    for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d)
        # recomputed, never loaded (sanitize drops a checkpoint's copy)
        self.register_buffer("positional_embedding", torch.tensor(
            sinusoids(dims.n_audio_ctx, d)), persistent=False)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        d = dims.n_text_state
        self.token_embedding = Embedding(dims.n_vocab, d)
        self.positional_embedding = nn.Parameter(
            torch.empty(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, True)
                                    for _ in range(dims.n_text_layer))
        self.ln = LayerNorm(d)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D/H)."""
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def _mha(attn: MultiHeadAttention, n_head: int, x: torch.Tensor,
         mask: Optional[torch.Tensor] = None, kv_override=None):
    """Whisper attention (whisper.py:155-181), self-attention unless
    `kv_override` gives precomputed (k, v) (B, S, D): the cross K/V or a
    cache. `mask`: additive, broadcast to (B, H, T, S). One scale hd**-0.5
    on the product for JAX's hd**-0.25 on each of q and k; the softmax runs
    in f32 inside `scaled_dot_product_attention`."""
    b, t, d = x.shape
    q = attn.query(x)
    k, v = kv_override if kv_override is not None else (attn.key(x),
                                                        attn.value(x))
    out = F.scaled_dot_product_attention(
        _heads(q, n_head), _heads(k, n_head), _heads(v, n_head),
        attn_mask=None if mask is None else mask.to(q.dtype),
        scale=(d // n_head) ** -0.5)
    return attn.out(out.transpose(1, 2).reshape(b, t, d))


def _causal_mask(t: int, device) -> torch.Tensor:
    return torch.full((t, t), float("-inf"), device=device).triu(1)


def encoder_forward(model: "Model", mel: torch.Tensor) -> torch.Tensor:
    """mel (B, 2 * n_audio_ctx, n_mels) -> (B, n_audio_ctx, D), in the
    parameters' dtype (the mel is cast to it here)."""
    enc = model.encoder
    x = torch.as_tensor(mel).to(device=model.device, dtype=model.dtype)
    x = gelu(enc.conv1(x, padding=1))
    x = gelu(enc.conv2(x, stride=2, padding=1))
    x = x + enc.positional_embedding.to(x.dtype)
    n_head = model.dims.n_audio_head
    for blk in enc.blocks:
        x = x + _mha(blk.attn, n_head, blk.attn_ln(x))
        x = x + blk.mlp(x)
    return enc.ln_post(x)


def cross_kv(model: "Model", audio_features: torch.Tensor):
    """Per-layer cross-attention (k, v), computed once per window."""
    return [(blk.cross_attn.key(audio_features),
             blk.cross_attn.value(audio_features))
            for blk in model.decoder.blocks]


def _decoder_tail(model: "Model", x: torch.Tensor) -> torch.Tensor:
    dec = model.decoder
    x = dec.ln(x)
    return x @ dec.token_embedding.weight.to(x.dtype).T


def decoder_forward(model: "Model", tokens: torch.Tensor,
                    positions: torch.Tensor, cross_kvs,
                    caches: Optional[KVCache], offset: int,
                    self_mask: Optional[torch.Tensor]):
    """tokens (B, T) at positions (B, T) -> (logits (B, T, V), caches).

    With `caches` (a stacked KVCache of n_text_ctx columns): write this
    step's k/v at `offset`, in place, and attend over the whole buffer
    through the additive `self_mask` (B or 1, 1, T, n_text_ctx). Without:
    causal attention over the T tokens."""
    dec = model.decoder
    x = dec.token_embedding(tokens) + dec.positional_embedding[positions]
    b, t, d = x.shape
    n_head = model.dims.n_text_head
    causal = None if caches is not None else _causal_mask(t, x.device)
    for i, blk in enumerate(dec.blocks):
        h = blk.attn_ln(x)
        if caches is not None:
            c = kv_update(caches.layer(i),
                          blk.attn.key(h).reshape(b, t, 1, d),
                          blk.attn.value(h).reshape(b, t, 1, d), offset)
            attn = _mha(blk.attn, n_head, h,
                        kv_override=(c.k[:, :, 0], c.v[:, :, 0]),
                        mask=self_mask)
        else:
            attn = _mha(blk.attn, n_head, h, mask=causal)
        x = x + attn
        x = x + _mha(blk.cross_attn, n_head, blk.cross_attn_ln(x),
                     kv_override=cross_kvs[i])
        x = x + blk.mlp(x)
    return _decoder_tail(model, x), caches


def decoder_forward_with_cross_qk(model: "Model", tokens: torch.Tensor,
                                  cross_kvs):
    """Cache-less decoder forward that also returns each layer's scaled
    pre-softmax cross-attention scores (B, heads, T, S) in f32, for the
    DTW word timing."""
    dec = model.decoder
    b, t = tokens.shape
    x = dec.token_embedding(tokens) + dec.positional_embedding[:t]
    n_head = model.dims.n_text_head
    scale = (model.dims.n_text_state // n_head) ** -0.25
    causal = _causal_mask(t, x.device)
    qks = []
    for i, blk in enumerate(dec.blocks):
        x = x + _mha(blk.attn, n_head, blk.attn_ln(x), mask=causal)
        q = blk.cross_attn.query(blk.cross_attn_ln(x))
        k, v = cross_kvs[i]
        scores = (_heads(q, n_head) * scale) @ (
            _heads(k, n_head) * scale).transpose(-1, -2)
        qks.append(scores.float())
        w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = (w @ _heads(v, n_head)).transpose(1, 2).reshape(b, t, -1)
        x = x + blk.cross_attn.out(out)
        x = x + blk.mlp(x)
    return _decoder_tail(model, x), qks


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _format_timestamp(seconds: float) -> str:
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1000)
    hours_marker = f"{hours:02d}:" if hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}.{ms:03d}"


class Model(TorchModel):
    """Whisper STT on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, dims: Union[ModelDimensions, dict], device="cuda"):
        device = check_device(device)
        if isinstance(dims, dict):
            dims = ModelDimensions.from_dict(dims)
        super().__init__(dims)
        self.dims = dims
        # window geometry follows the model's audio context (3000 mel frames
        # / 30 s for published checkpoints; smaller for tiny test configs)
        self.window_frames = dims.n_audio_ctx * 2
        self.window_samples = self.window_frames * HOP_LENGTH
        with torch.device(device):
            self.encoder = AudioEncoder(dims)
            self.decoder = TextDecoder(dims)
        self.requires_grad_(False)
        self.eval()
        # what the last generate() ran: decodes (one per window and
        # fallback temperature) and the decode steps they launched
        self.last_run: Dict[str, int] = {}

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the parameters: the compute dtype."""
        return self.encoder.conv1.weight.dtype

    # -- weights -----------------------------------------------------------

    @torch.no_grad()
    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        """TorchModel.init_params, plus the decoder's positional embedding
        drawn N(0, 0.01) as `init_whisper` draws it."""
        super().init_params(seed, on_device=on_device)
        pe = self.decoder.positional_embedding
        dev, dtype = ((pe.device, pe.dtype) if on_device
                      else (torch.device("cpu"), torch.float32))
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        pe.copy_(torch.randn(pe.shape, generator=g, device=dev,
                             dtype=dtype) * 0.01)
        return self

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Map HF transformers whisper keys onto the OpenAI/mlx names of the
        JAX tree and the stem convs to its WIO (3, I, O) layout, as the JAX
        package's `sanitize` does, key for key; `model.load_jax_params`
        then converts WIO to torch's layout."""
        out = {}
        hf = any(k.startswith(("model.encoder", "model.decoder"))
                 for k in weights)
        for k, w in weights.items():
            if hf:
                k = (k.replace("model.encoder.", "encoder.")
                      .replace("model.decoder.", "decoder.")
                      .replace(".layers.", ".blocks.")
                      .replace(".self_attn.", ".attn.")
                      .replace(".encoder_attn.", ".cross_attn.")
                      .replace(".self_attn_layer_norm.", ".attn_ln.")
                      .replace(".encoder_attn_layer_norm.", ".cross_attn_ln.")
                      .replace(".final_layer_norm.", ".mlp_ln.")
                      .replace(".fc1.", ".mlp1.")
                      .replace(".fc2.", ".mlp2.")
                      .replace(".q_proj.", ".query.")
                      .replace(".k_proj.", ".key.")
                      .replace(".v_proj.", ".value.")
                      .replace(".out_proj.", ".out.")
                      .replace("encoder.layer_norm.", "encoder.ln_post.")
                      .replace("decoder.layer_norm.", "decoder.ln.")
                      .replace("decoder.embed_tokens.", "decoder.token_embedding.")
                      .replace("decoder.embed_positions.weight",
                               "decoder.positional_embedding"))
                if k == "proj_out.weight" or k.startswith("model.proj_out"):
                    continue
            if k.endswith("embed_positions.weight") and k.startswith("encoder"):
                continue  # sinusoids are recomputed
            w = np.asarray(w)
            if ("conv1.weight" in k or "conv2.weight" in k) and w.ndim == 3:
                # stem convs have kernel 3; map torch (O, I, 3) or
                # mlx (O, 3, I) to WIO (3, I, O); keep if already WIO
                if w.shape[0] == 3:
                    pass  # already WIO
                elif w.shape[-1] == 3:
                    w = np.transpose(w, (2, 1, 0))
                else:
                    w = np.transpose(w, (1, 2, 0))
            out[k] = w
        return out

    @property
    def alignment_heads(self):
        """(layer, head) pairs used for word timing: every head of the last
        half of the decoder's layers."""
        return [(l, h) for l in range(self.dims.n_text_layer // 2,
                                      self.dims.n_text_layer)
                for h in range(self.dims.n_text_head)]

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab >= 51865

    def get_tokenizer(self, language="en", task="transcribe") -> WhisperTokenizer:
        # the config is the dims, as in the JAX package: no model_path, so
        # the tokenizer is the files-free one
        return get_tokenizer(self.dims.n_vocab,
                             getattr(self.config, "model_path", None)
                             if not isinstance(self.config, ModelDimensions)
                             else None,
                             language or "en", task)

    # -- pieces ---------------------------------------------------------------

    @torch.inference_mode()
    def embed_audio(self, mel) -> torch.Tensor:
        return encoder_forward(self, mel)

    @torch.inference_mode()
    def detect_language_probs(self, mel_segment) -> torch.Tensor:
        """(B, frames, mels) -> (B, V) softmax over the language tokens."""
        tok = self.get_tokenizer()
        feats = encoder_forward(self, mel_segment)
        ckv = cross_kv(self, feats)
        b = feats.shape[0]
        toks = torch.full((b, 1), tok.sot, dtype=torch.long,
                          device=self.device)
        pos = torch.zeros((b, 1), dtype=torch.long, device=self.device)
        logits, _ = decoder_forward(self, toks, pos, ckv, None, 0, None)
        mask = torch.full((self.dims.n_vocab,), float("-inf"),
                          device=self.device)
        mask[list(tok.all_language_tokens)] = 0.0
        return torch.softmax(logits[:, 0].float() + mask, dim=-1)

    def detect_language(self, mel_segment, language: Optional[str] = None):
        tok = self.get_tokenizer()
        probs = self.detect_language_probs(mel_segment).cpu().numpy()
        codes = tok.all_language_codes
        lang_tokens = list(tok.all_language_tokens)
        p = {codes[i]: float(probs[0, lang_tokens[i]])
             for i in range(len(codes))}
        return max(p, key=p.get), p

    # -- public transcription ----------------------------------------------

    def _prepare_audio(self, audio, padding=None):
        """-> (whole-file log-mel (frames, n_mels) f32 on the model's
        device, content frames). The mel is computed once over the whole
        padded file: its floor is the maximum of the whole array."""
        if padding is None:
            padding = self.window_samples
        if isinstance(audio, str):
            from ....utils import load_audio

            audio = load_audio(audio, sample_rate=SAMPLE_RATE)
        mel = log_mel_spectrogram(audio, n_mels=self.dims.n_mels,
                                  padding=padding, device=self.device)
        content_frames = mel.shape[-2] - (self.window_frames if padding else 0)
        return mel, content_frames

    def generate(
        self,
        audio,
        *,
        verbose: Optional[bool] = None,
        language: Optional[str] = None,
        task: str = "transcribe",
        temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        return_timestamps: bool = True,
        word_timestamps: bool = False,
        clip_timestamps="0",
        hallucination_silence_threshold: Optional[float] = None,
        stream: bool = False,
        **decode_options,
    ):
        """Windowed transcription (whisper.py:471-774) -> STTOutput.

        `stream=True` returns a generator of one STTOutput per text delta
        of the streaming session (`generate_streaming`'s, and the one that
        closing it commits; together they make the final text), where the
        JAX package ignores `stream` and returns one STTOutput, which its
        CLI's `--stream` then fails to iterate."""
        if stream:
            return (STTOutput(text=ev.text, language=language or "en")
                    for _, ev in self._stream_events(
                        audio, decode_options.get("chunk_duration") or 1.0,
                        language)
                    if ev.kind == "delta")
        with torch.inference_mode():
            return self._transcribe(
                audio, verbose, language, task, temperature,
                compression_ratio_threshold, logprob_threshold,
                no_speech_threshold, condition_on_previous_text,
                initial_prompt, return_timestamps, word_timestamps,
                clip_timestamps, hallucination_silence_threshold,
                decode_options)

    def _transcribe(self, audio, verbose, language, task, temperature,
                    compression_ratio_threshold, logprob_threshold,
                    no_speech_threshold, condition_on_previous_text,
                    initial_prompt, return_timestamps, word_timestamps,
                    clip_timestamps, hallucination_silence_threshold,
                    decode_options) -> STTOutput:
        from .decoding import DecodingOptions, DecodingTask

        t_start = time.time()
        mel, content_frames = self._prepare_audio(audio)
        language = language or (
            self._detect_language_cached(mel) if self.is_multilingual else "en")
        tokenizer = self.get_tokenizer(language=language, task=task)

        temperatures = ([temperature] if isinstance(temperature, (int, float))
                        else list(temperature))
        task_runner = DecodingTask(
            self, DecodingOptions(
                task=task, language=language,
                without_timestamps=not return_timestamps,
                # options.temperature is validation/metadata only; the
                # fallback ladder passes the actual value into run()
                temperature=max(temperatures),
                **{k: v for k, v in decode_options.items()
                   if k in DecodingOptions.__dataclass_fields__}))

        all_tokens: List[int] = []
        all_segments: List[dict] = []
        prompt_reset_since = 0
        if initial_prompt:
            initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
            all_tokens.extend(initial_prompt_tokens)
        else:
            initial_prompt_tokens = []

        # clip_timestamps "start,end,start,end,..." -> seek windows
        if isinstance(clip_timestamps, str):
            clip_timestamps = [float(ts) for ts in
                               (clip_timestamps.split(",")
                                if clip_timestamps else [])]
        seek_points = [round(ts * FRAMES_PER_SECOND)
                       for ts in clip_timestamps]
        if not seek_points:
            seek_points.append(0)
        if len(seek_points) % 2 == 1:
            seek_points.append(content_frames)
        else:
            seek_points[-1] = min(content_frames, seek_points[-1])
        seek_clips = list(zip(seek_points[::2], seek_points[1::2]))

        clip_idx = 0
        seek = seek_clips[0][0]
        run = self.last_run = {"windows": 0, "decodes": 0, "decode_steps": 0}
        input_stride = 2  # mel frames per token position
        time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02
        prompt_tokens_count = 0
        gen_tokens_count = 0
        last_speech_timestamp = 0.0
        content_duration = content_frames * HOP_LENGTH / SAMPLE_RATE
        punctuation = "\"'\u201c\u00bf([{-\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"

        while clip_idx < len(seek_clips):
            seek_clip_start, seek_clip_end = seek_clips[clip_idx]
            if seek < seek_clip_start:
                seek = seek_clip_start
            if seek >= seek_clip_end or seek >= content_frames:
                clip_idx += 1
                if clip_idx < len(seek_clips):
                    seek = max(seek, seek_clips[clip_idx][0])
                continue
            time_offset = seek * HOP_LENGTH / SAMPLE_RATE
            window_end_time = (seek + self.window_frames) \
                * HOP_LENGTH / SAMPLE_RATE
            mel_segment = mel[seek: seek + self.window_frames]
            segment_size = min(self.window_frames, content_frames - seek,
                               seek_clip_end - seek)
            segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE
            mel_segment = pad_or_trim(mel_segment[:segment_size],
                                      self.window_frames)[None]
            previous_seek = seek
            run["windows"] += 1

            prompt = all_tokens[prompt_reset_since:] \
                if condition_on_previous_text else initial_prompt_tokens

            result = None
            for t in temperatures:
                result = task_runner.run(mel_segment, prompt, temperature=t)
                run["decodes"] += 1
                run["decode_steps"] += task_runner.last_steps
                needs_fallback = False
                if (compression_ratio_threshold is not None
                        and result.compression_ratio > compression_ratio_threshold):
                    needs_fallback = True
                if (logprob_threshold is not None
                        and result.avg_logprob < logprob_threshold):
                    needs_fallback = True
                if (no_speech_threshold is not None
                        and result.no_speech_prob > no_speech_threshold):
                    needs_fallback = False  # silence: accept
                if not needs_fallback:
                    break

            prompt_tokens_count += len(prompt) + len(tokenizer.sot_sequence)
            gen_tokens_count += len(result.tokens)
            window_seg_start = len(all_segments)

            if (no_speech_threshold is not None
                    and result.no_speech_prob > no_speech_threshold
                    and (logprob_threshold is None
                         or result.avg_logprob < logprob_threshold)):
                seek += segment_size  # silent segment
                continue

            tokens = np.asarray(result.tokens)
            ts_begin = tokenizer.timestamp_begin
            timestamp_tokens = tokens >= ts_begin
            single_ts_end = (len(tokens) >= 2 and timestamp_tokens[-1]
                             and not timestamp_tokens[-2])
            consecutive = np.where(
                np.logical_and(timestamp_tokens[:-1], timestamp_tokens[1:])
            )[0] + 1

            def new_segment(start, end, seg_tokens, res):
                seg_tokens = [int(t) for t in seg_tokens]
                text_tokens = [t for t in seg_tokens if t < tokenizer.eot]
                return {
                    "seek": seek,
                    "start": start,
                    "end": end,
                    "text": tokenizer.decode(text_tokens),
                    "tokens": seg_tokens,
                    "temperature": res.temperature,
                    "avg_logprob": res.avg_logprob,
                    "compression_ratio": res.compression_ratio,
                    "no_speech_prob": res.no_speech_prob,
                }

            if len(consecutive) > 0:
                slices = list(consecutive)
                if single_ts_end:
                    slices.append(len(tokens))
                last_slice = 0
                for cur_slice in slices:
                    seg = tokens[last_slice:cur_slice]
                    start_pos = int(seg[0]) - ts_begin
                    end_pos = int(seg[-1]) - ts_begin
                    all_segments.append(new_segment(
                        time_offset + start_pos * time_precision,
                        time_offset + end_pos * time_precision,
                        seg, result))
                    last_slice = cur_slice
                if single_ts_end:
                    seek += segment_size
                else:
                    last_ts_pos = int(tokens[last_slice - 1]) - ts_begin
                    seek += last_ts_pos * input_stride
            else:
                duration = segment_duration
                ts = tokens[timestamp_tokens.nonzero()[0]]
                if len(ts) > 0 and int(ts[-1]) != ts_begin:
                    duration = (int(ts[-1]) - ts_begin) * time_precision
                all_segments.append(new_segment(
                    time_offset, time_offset + duration, tokens, result))
                seek += segment_size

            if word_timestamps:
                from .timing import add_word_timestamps

                add_word_timestamps(
                    segments=all_segments[window_seg_start:],
                    model=self, tokenizer=tokenizer,
                    mel_segment=mel_segment, num_frames=segment_size,
                    time_offset=time_offset)

                def _get_end(segs):
                    return next((w["end"] for seg in reversed(segs)
                                 for w in reversed(seg.get("words") or [])),
                                None)

                current = all_segments[window_seg_start:]
                if not single_ts_end:
                    last_word_end = _get_end(current)
                    if last_word_end is not None \
                            and last_word_end > time_offset:
                        seek = round(last_word_end * FRAMES_PER_SECOND)

                # hallucination skipping: anomalous word runs surrounded by
                # silence are dropped and the window re-seeks past the
                # silence
                if hallucination_silence_threshold is not None:
                    threshold = hallucination_silence_threshold

                    def word_anomaly_score(word):
                        prob = word.get("probability", 0.0)
                        dur = word["end"] - word["start"]
                        score = 0.0
                        if prob < 0.15:
                            score += 1.0
                        if dur < 0.133:
                            score += (0.133 - dur) * 15
                        if dur > 2.0:
                            score += dur - 2.0
                        return score

                    def is_segment_anomaly(seg):
                        if seg is None or not seg.get("words"):
                            return False
                        words = [w for w in seg["words"]
                                 if w["word"] not in punctuation][:8]
                        score = sum(word_anomaly_score(w) for w in words)
                        return score >= 3 or score + 0.01 >= len(words)

                    def next_words_segment(segs):
                        return next((s for s in segs if s.get("words")),
                                    None)

                    if not single_ts_end:
                        last_word_end = _get_end(current)
                        if last_word_end is not None \
                                and last_word_end > time_offset:
                            remaining = window_end_time - last_word_end
                            if remaining > threshold:
                                seek = round(
                                    last_word_end * FRAMES_PER_SECOND)
                            else:
                                seek = previous_seek + segment_size

                    first_segment = next_words_segment(current)
                    if first_segment is not None \
                            and is_segment_anomaly(first_segment):
                        gap = first_segment["start"] - time_offset
                        if gap > threshold:
                            # drop this window and re-decode past the gap
                            del all_segments[window_seg_start:]
                            seek = previous_seek + round(
                                gap * FRAMES_PER_SECOND)
                            continue

                    hal_last_end = last_speech_timestamp
                    for si, seg in enumerate(current):
                        if not seg.get("words"):
                            continue
                        if is_segment_anomaly(seg):
                            nxt = next_words_segment(current[si + 1:])
                            hal_next_start = (nxt["words"][0]["start"]
                                              if nxt is not None else
                                              time_offset + segment_duration)
                            silence_before = (
                                seg["start"] - hal_last_end > threshold
                                or seg["start"] < threshold
                                or seg["start"] - time_offset < 2.0)
                            silence_after = (
                                hal_next_start - seg["end"] > threshold
                                or is_segment_anomaly(nxt)
                                or window_end_time - seg["end"] < 2.0)
                            if silence_before and silence_after:
                                seek = round(max(time_offset + 1,
                                                 seg["start"])
                                             * FRAMES_PER_SECOND)
                                if content_duration - seg["end"] < threshold:
                                    seek = content_frames
                                del all_segments[window_seg_start + si:]
                                break
                        hal_last_end = seg["end"]

                last_word_end = _get_end(all_segments[window_seg_start:])
                if last_word_end is not None:
                    last_speech_timestamp = last_word_end

            all_tokens.extend([int(t) for t in tokens])
            if not condition_on_previous_text or result.temperature > 0.5:
                prompt_reset_since = len(all_tokens)

            if verbose:
                for seg in all_segments[-4:]:
                    print(f"[{_format_timestamp(seg['start'])} --> "
                          f"{_format_timestamp(seg['end'])}] {seg['text']}")

        total_time = time.time() - t_start
        text = "".join(seg["text"] for seg in all_segments)
        return STTOutput(
            text=text,
            segments=all_segments,
            language=language,
            prompt_tokens=prompt_tokens_count,
            generation_tokens=gen_tokens_count,
            total_tokens=prompt_tokens_count + gen_tokens_count,
            prompt_tps=prompt_tokens_count / total_time if total_time else 0.0,
            generation_tps=gen_tokens_count / total_time if total_time else 0.0,
            total_time=total_time,
        )

    def _detect_language_cached(self, mel) -> str:
        seg = pad_or_trim(mel, self.window_frames)[None]
        lang, _ = self.detect_language(seg)
        return lang

    # -- streaming (server /v1/realtime session protocol) -------------------

    def create_streaming_session(self, language: str = "en", **kwargs):
        from .streaming import WhisperStreamingSession

        return WhisperStreamingSession(self, language=language, **kwargs)

    def _stream_events(self, audio, chunk_duration: float,
                       language: Optional[str]):
        """(closed, StreamingEvent) of a streaming session fed `audio` in
        fixed chunks, then closed and stepped until done."""
        from ....utils import load_audio

        if isinstance(audio, str):
            audio = load_audio(audio, sample_rate=SAMPLE_RATE)
        audio = np.asarray(audio, np.float32)
        session = self.create_streaming_session(language=language or "en")
        chunk = int(chunk_duration * SAMPLE_RATE)
        for off in range(0, len(audio), chunk):
            session.feed(audio[off: off + chunk])
            for ev in session.step():
                yield False, ev
        session.close()
        while not session.done:
            for ev in session.step():
                yield True, ev

    def generate_streaming(self, audio, chunk_duration: float = 1.0,
                           language: Optional[str] = None, **kwargs):
        """Offline-driven streaming: feed fixed chunks through a streaming
        session and yield STTOutput deltas, then the final text."""
        for closed, ev in self._stream_events(audio, chunk_duration,
                                              language):
            if ev.kind == ("final" if closed else "delta"):
                yield STTOutput(text=ev.text, language=language or "en")
