"""Voxtral Mini Realtime: a causal audio encoder and a time-lockstep LLM
decoder.

Counterpart of mlx_audio_tpu/stt/models/voxtral_realtime/voxtral_realtime.py:

* the constants, the token math and the streaming pad (:51-80), the configs
  (:83-152, `audio_encoding_args` may sit inside `encoder_args`) and the
  decode-only tekken tokenizer (:155-184), copied;
* `voxtral_mel` (:189-205): periodic Hann, centre reflect pad, the last
  frame dropped, the log clamped at `global_log_mel_max - 8`;
* the parameter tree as `nn.Module`s named after the JAX leaves
  (`encoder.conv_layers_{0,1}_conv.conv`, `encoder.transformer_layers.N.
  {attention_norm, attention.{wq,wk,wv,wo}, ffn_norm, feed_forward_w{1,2,3}}`,
  `encoder.transformer_norm`, `encoder.audio_language_projection_{0,2}`,
  `decoder.{tok_embeddings, layers.N.{..., ada_rms_norm_t_cond.{ada_down,
  ada_up}}, norm}`), so `model.load_jax_params` fills it;
* the encoder (`conv_stem`, `encoder_layers`, `downsample_project`,
  `encode_audio`, `Model.encode` over `MEL_BUCKETS`), the decoder
  (`compute_time_embedding`, `ada_scales`, `decoder_forward`), the offline
  lockstep decode (`generate`, whole and `stream=True`) and the loaders
  (`_remap_consolidated`, `sanitize`, `post_load_hook`).

Departures from the JAX package:

* **Pad rows of the offline encoder.** JAX's bucket mask leaves a pad query
  that lies a window or more past the valid frames with no key, so its
  softmax is NaN, and from the second layer on every row reads those NaN
  keys and values through `0 * NaN`: `Model.encode` returns NaN for some
  audio lengths. Here a pad query also sees its own key. Valid queries
  never read a pad key, so they are JAX's wherever JAX is finite.
* **Eager decode.** JAX runs the lockstep decode as a compiled 64-step
  scan over a cache of fixed size. Here each step runs eagerly: the argmax,
  the EOS flag and the kept tokens stay on the device and are read once per
  64-position chunk, so the chunks yield what JAX's yield. The step whose
  logits no kept token needs (the one at the last audio position, and the
  steps past `max_tokens`) is not run. Attention reads the cache's written
  columns only, which is JAX's mask over the whole buffer.
* **Compute dtype.** Activations run in the parameters' dtype (the mel is
  cast to it, as Whisper's is), where the JAX package's einsums promote
  bf16 weights against f32 activations. The K/V caches are f32, as JAX's
  are, and attention over a cache runs in f32 (q is cast up).
"""

from __future__ import annotations

import base64
import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....dsp import filters_on, spec_abs, stft
from ....model import TorchModel, check_device
from ....nn import Conv1d, Embedding, Linear, RMSNorm, gelu, rms_norm
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import apply_rotary_interleaved, rope_cis, rope_freqs
from ..base import STTOutput

SAMPLE_RATE = 16000
FRAME_RATE = 12.5
HOP_LENGTH = 160
RAW_AUDIO_LENGTH_PER_TOK = int(SAMPLE_RATE // FRAME_RATE)      # 1280
AUDIO_LENGTH_PER_TOK = RAW_AUDIO_LENGTH_PER_TOK // HOP_LENGTH  # 8

DEC_CHUNK = 64
MEL_BUCKETS = (512, 1024, 2048, 4096, 8192)


def _num_audio_tokens(audio_len: int) -> int:
    if audio_len % HOP_LENGTH != 0:
        audio_len = math.ceil(audio_len / HOP_LENGTH - 1)
    else:
        audio_len = audio_len // HOP_LENGTH
    return math.ceil(audio_len / AUDIO_LENGTH_PER_TOK)


def _num_delay_tokens(delay_ms: float) -> int:
    return _num_audio_tokens(int(delay_ms / 1000.0 * SAMPLE_RATE))


def _pad_audio_streaming(audio: np.ndarray, n_left: int,
                         n_right: int) -> np.ndarray:
    mult = RAW_AUDIO_LENGTH_PER_TOK
    align = (mult - (len(audio) % mult)) % mult
    return np.pad(audio, (n_left * mult, align + n_right * mult))


# --------------------------------------------------------------- configs

@dataclass
class AudioEncodingConfig(BaseModelArgs):
    sampling_rate: int = 16000
    frame_rate: float = 12.5
    num_mel_bins: int = 128
    hop_length: int = 160
    window_size: int = 400
    global_log_mel_max: float = 1.5


@dataclass
class EncoderConfig(BaseModelArgs):
    dim: int = 1280
    n_layers: int = 32
    n_heads: int = 32
    head_dim: int = 64
    hidden_dim: int = 5120
    n_kv_heads: int = 32
    norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    sliding_window: int = 750
    causal: bool = True
    use_biases: bool = True
    downsample_factor: int = 4


@dataclass
class DecoderConfig(BaseModelArgs):
    dim: int = 3072
    n_layers: int = 26
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    hidden_dim: int = 9216
    vocab_size: int = 131072
    norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    sliding_window: int = 8192
    tied_embeddings: bool = True
    ada_rms_norm_t_cond: bool = True
    ada_rms_norm_t_cond_dim: int = 32


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "voxtral_realtime"
    encoder_args: Optional[Dict] = None
    decoder: Optional[Dict] = None
    audio_encoding_args: Optional[Dict] = None
    transcription_delay_ms: int = 480
    bos_token_id: int = 1
    eos_token_id: int = 2
    streaming_pad_token_id: int = 32
    n_left_pad_tokens: int = 32
    model_path: str = ""

    def __post_init__(self):
        if isinstance(self.encoder_args, dict):
            self.encoder_args = dict(self.encoder_args)
            aea = self.encoder_args.pop("audio_encoding_args", None)
            if aea and self.audio_encoding_args is None:
                self.audio_encoding_args = aea
        if not isinstance(self.encoder_args, EncoderConfig):
            self.encoder_args = EncoderConfig.from_dict(
                self.encoder_args or {})
        if not isinstance(self.decoder, DecoderConfig):
            self.decoder = DecoderConfig.from_dict(self.decoder or {})
        if not isinstance(self.audio_encoding_args, AudioEncodingConfig):
            self.audio_encoding_args = AudioEncodingConfig.from_dict(
                self.audio_encoding_args or {})


# ------------------------------------------------------------- tokenizer

class TekkenTokenizer:
    """Decode-only tekken.json tokenizer (a copy of the JAX package's)."""

    def __init__(self, tekken_path: str):
        data = json.loads(Path(tekken_path).read_text(encoding="utf-8"))
        self.vocab = data["vocab"]
        self.n_special = int(data.get("config", {}).get(
            "default_num_special_tokens", 1000))
        self.special_ids = {int(st["rank"])
                            for st in data.get("special_tokens", [])
                            if "rank" in st}

    def decode(self, token_ids) -> str:
        out = bytearray()
        for tid in token_ids:
            tid = int(tid)
            if tid < self.n_special or tid in self.special_ids:
                continue
            vid = tid - self.n_special
            if 0 <= vid < len(self.vocab):
                out += base64.b64decode(self.vocab[vid]["token_bytes"])
        return out.decode("utf-8", errors="replace")

    @classmethod
    def from_model_path(cls, model_path) -> "TekkenTokenizer":
        p = Path(model_path) / "tekken.json"
        if not p.exists():
            raise FileNotFoundError(f"tekken.json not found at "
                                    f"{model_path}")
        return cls(str(p))


# ------------------------------------------------------------------ mel

def voxtral_mel(audio, aec: AudioEncodingConfig) -> torch.Tensor:
    """(T,) -> (frames, n_mels) f32, on the audio's device (the CPU for
    numpy input): periodic Hann (built in f32, as the JAX package builds
    it), reflect centre pad, the last frame dropped, the log10 clamped at
    the fixed `global_log_mel_max - 8`."""
    n = np.arange(aec.window_size, dtype=np.float32)
    win = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / aec.window_size))) \
        .astype(np.float32)
    spec = stft(audio, n_fft=aec.window_size, hop_length=aec.hop_length,
                win_length=aec.window_size, window=win, center=True,
                pad_mode="reflect")
    power = spec_abs(spec[:-1]) ** 2
    fb = filters_on(power.device, aec.sampling_rate, aec.window_size,
                    aec.num_mel_bins, "slaney", "slaney", f_max=8000)
    log_spec = torch.log10(torch.clamp(power @ fb, min=1e-10))
    log_spec = torch.clamp(log_spec, min=aec.global_log_mel_max - 8.0)
    return (log_spec + 4.0) / 4.0


# -------------------------------------------------------- parameter tree

class Attention(nn.Module):
    def __init__(self, dim: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, biases: bool):
        super().__init__()
        self.wq = Linear(dim, n_heads * head_dim, bias=biases)
        self.wk = Linear(dim, n_kv_heads * head_dim, bias=False)
        self.wv = Linear(dim, n_kv_heads * head_dim, bias=biases)
        self.wo = Linear(n_heads * head_dim, dim, bias=biases)


class AdaRMSNormTCond(nn.Module):
    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.ada_down = Linear(dim, cond_dim, bias=False)
        self.ada_up = Linear(cond_dim, dim, bias=False)


class TransformerLayer(nn.Module):
    """One pre-norm block: the encoder's (biases on wq, wv, wo and w2) or
    the decoder's (no biases, GQA, an AdaRMSNorm time conditioning)."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, hidden_dim: int, eps: float, biases: bool,
                 ada_dim: Optional[int] = None):
        super().__init__()
        self.attention_norm = RMSNorm(dim, eps)
        self.attention = Attention(dim, n_heads, n_kv_heads, head_dim,
                                   biases)
        self.ffn_norm = RMSNorm(dim, eps)
        self.feed_forward_w1 = Linear(dim, hidden_dim, bias=False)
        self.feed_forward_w3 = Linear(dim, hidden_dim, bias=False)
        self.feed_forward_w2 = Linear(hidden_dim, dim, bias=biases)
        if ada_dim is not None:
            self.ada_rms_norm_t_cond = AdaRMSNormTCond(dim, ada_dim)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        return self.feed_forward_w2(F.silu(self.feed_forward_w1(h))
                                    * self.feed_forward_w3(h))


class _Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, 3)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        e, d = cfg.encoder_args, cfg.decoder
        self.conv_layers_0_conv = _Conv(cfg.audio_encoding_args.num_mel_bins,
                                        e.dim)
        self.conv_layers_1_conv = _Conv(e.dim, e.dim)
        self.transformer_layers = nn.ModuleList(
            TransformerLayer(e.dim, e.n_heads, e.n_heads, e.head_dim,
                             e.hidden_dim, e.norm_eps, True)
            for _ in range(e.n_layers))
        self.transformer_norm = RMSNorm(e.dim, e.norm_eps)
        self.audio_language_projection_0 = Linear(
            e.dim * e.downsample_factor, d.dim, bias=False)
        self.audio_language_projection_2 = Linear(d.dim, d.dim, bias=False)


class Decoder(nn.Module):
    def __init__(self, d: DecoderConfig):
        super().__init__()
        self.tok_embeddings = Embedding(d.vocab_size, d.dim)
        self.layers = nn.ModuleList(
            TransformerLayer(d.dim, d.n_heads, d.n_kv_heads, d.head_dim,
                             d.hidden_dim, d.norm_eps, False,
                             d.ada_rms_norm_t_cond_dim
                             if d.ada_rms_norm_t_cond else None)
            for _ in range(d.n_layers))
        self.norm = RMSNorm(d.dim, d.norm_eps)


# --------------------------------------------------------------- encoder

def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, t = x.shape[:2]
    return x.view(b, t, n, hd)


def encoder_block(blk: TransformerLayer, e: EncoderConfig, x: torch.Tensor,
                  cis: torch.Tensor, attend) -> torch.Tensor:
    """One encoder layer over (1, T, dim); `attend(q, k, v)` (each (1, T,
    H, hd), rotated) returns (1, T, H, hd): full attention under a mask
    offline, a ring cache when streaming."""
    a = blk.attention
    h = blk.attention_norm(x)
    q = apply_rotary_interleaved(_heads(a.wq(h), e.n_heads, e.head_dim), cis)
    k = apply_rotary_interleaved(_heads(a.wk(h), e.n_heads, e.head_dim), cis)
    v = _heads(a.wv(h), e.n_heads, e.head_dim)
    x = x + a.wo(attend(q, k, v).reshape(x.shape[0], x.shape[1], -1))
    return x + blk.ffn(blk.ffn_norm(x))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """Attention on (B, T, H, hd) q and (B, S, H, hd) k, v with a boolean
    (True: attend) or additive mask broadcast to (B, H, T, S); softmax in
    f32 inside `scaled_dot_product_attention`."""
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask)
    return out.transpose(1, 2)


def conv_stem(enc: Encoder, mel: torch.Tensor) -> torch.Tensor:
    """(1, T_mel, n_mels) -> (1, T_mel // 2, dim): causal, left pads 2 and
    1, the second conv of stride 2, exact GELU."""
    x = gelu(enc.conv_layers_0_conv.conv(mel, padding=(2, 0)))
    return gelu(enc.conv_layers_1_conv.conv(x, stride=2, padding=(1, 0)))


def encoder_layers(model: "Model", x: torch.Tensor,
                   n_valid: int) -> torch.Tensor:
    """Causal sliding-window transformer over (1, T, dim), frames past
    `n_valid` being padding: a valid query sees the valid keys of its
    window, and a pad query its own key too (so it is never left without
    one, which is JAX's NaN)."""
    e = model.config.encoder_args
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    qi, kj = pos[:, None], pos[None, :]
    allow = ((kj <= qi) & (qi - kj < e.sliding_window) & (kj < n_valid)) \
        | ((qi >= n_valid) & (kj == qi))
    cis = rope_cis(pos, model.enc_inv_freq)
    for blk in model.encoder.transformer_layers:
        x = encoder_block(blk, e, x, cis,
                          lambda q, k, v: sdpa(q, k, v, allow))
    return model.encoder.transformer_norm(x)


def downsample_project(enc: Encoder, e: EncoderConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """(1, T, dim) -> (1, T // ds, decoder_dim): stack ds frames, then the
    adapter MLP."""
    ds = e.downsample_factor
    t = (x.shape[1] // ds) * ds
    merged = x[:, :t].reshape(1, t // ds, e.dim * ds)
    return enc.audio_language_projection_2(
        gelu(enc.audio_language_projection_0(merged)))


def encode_audio(model: "Model", mel: torch.Tensor,
                 n_mel: int) -> torch.Tensor:
    """(1, T_mel_bucket, n_mels) -> (1, T // 8, decoder_dim); the first
    `n_mel` mel frames are valid."""
    x = conv_stem(model.encoder, mel)
    x = encoder_layers(model, x, (n_mel + 1) // 2)
    return downsample_project(model.encoder, model.config.encoder_args, x)


# --------------------------------------------------------------- decoder

def compute_time_embedding(t_value: float, dim: int,
                           theta: float = 10000.0) -> np.ndarray:
    half = dim // 2
    inv = np.exp(-np.log(theta) * np.arange(half, dtype=np.float32)
                 / half)
    emb = t_value * inv
    return np.concatenate([np.cos(emb), np.sin(emb)]).astype(np.float32)


def ada_scales(dec: Decoder, d: DecoderConfig,
               t_cond: torch.Tensor) -> torch.Tensor:
    """(dim,) time condition -> (n_layers, dim) per-layer AdaRMSNorm
    scales (zeros for a layer without the conditioning)."""
    out = []
    for blk in dec.layers:
        ada = getattr(blk, "ada_rms_norm_t_cond", None)
        if ada is None:
            out.append(torch.zeros(d.dim, dtype=t_cond.dtype,
                                   device=t_cond.device))
        else:
            out.append(ada.ada_up(gelu(ada.ada_down(t_cond))))
    return torch.stack(out)


def decoder_forward(model: "Model", x: torch.Tensor, ffn_w: torch.Tensor,
                    caches: KVCache, offset: int) -> torch.Tensor:
    """(1, T, dim) embeddings at positions offset..offset+T-1 -> (1, T,
    dim) hidden after the final norm. Each layer writes its k/v into
    `caches` (stacked, f32) at `offset`, in place, and attends in f32 over
    the offset + T written columns, causally among the T new rows. `ffn_w`
    (n_layers, dim) are the FFN norms' weights with the time conditioning
    folded in (`Model.ffn_norm_weights`)."""
    d = model.config.decoder
    dec = model.decoder
    b, t, _ = x.shape
    s = offset + t
    cis = rope_cis(torch.arange(offset, s, device=x.device),
                   model.dec_inv_freq)
    mask = None
    if t > 1:
        q_pos = torch.arange(offset, s, device=x.device)[:, None]
        mask = torch.zeros(t, s, device=x.device).masked_fill(
            torch.arange(s, device=x.device)[None, :] > q_pos, float("-inf"))
    for i, blk in enumerate(dec.layers):
        a = blk.attention
        h = blk.attention_norm(x)
        q = apply_rotary_interleaved(_heads(a.wq(h), d.n_heads, d.head_dim),
                                     cis)
        k = apply_rotary_interleaved(
            _heads(a.wk(h), d.n_kv_heads, d.head_dim), cis)
        c = kv_update(caches.layer(i), k, _heads(a.wv(h), d.n_kv_heads,
                                                 d.head_dim), offset)
        o = attention(q.float(), c.k[:, :s], c.v[:, :s], mask=mask)
        x = x + a.wo(o.to(x.dtype).reshape(b, t, -1))
        x = x + blk.ffn(rms_norm(x, ffn_w[i], d.norm_eps))
    return dec.norm(x)


def logits(model: "Model", h: torch.Tensor) -> torch.Tensor:
    """Hidden (..., dim) -> logits (..., vocab) through the tied
    embeddings."""
    return h @ model.decoder.tok_embeddings.weight.T


# ---------------------------------------------------------------- model

class Model(TorchModel):
    """Voxtral Realtime STT on `device`: the card by default; without CUDA
    the constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Optional[ModelConfig] = None, device="cuda"):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        e, d = config.encoder_args, config.decoder
        with torch.device(device):
            self.encoder = Encoder(config)
            self.decoder = Decoder(d)
        self.requires_grad_(False)
        self.eval()
        # RoPE inverse frequencies, f32 on the device (not parameters)
        self.enc_inv_freq = rope_freqs(e.head_dim, e.rope_theta).to(device)
        self.dec_inv_freq = rope_freqs(d.head_dim, d.rope_theta).to(device)
        self._tokenizer: Optional[TekkenTokenizer] = None

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the parameters: the compute dtype."""
        return self.decoder.tok_embeddings.weight.dtype

    def token_embeddings(self, ids: torch.Tensor) -> torch.Tensor:
        """(n,) token ids on the device -> (n, dim), gathered there."""
        return torch.index_select(self.decoder.tok_embeddings.weight, 0, ids)

    def ffn_norm_weights(self, n_delay: int) -> torch.Tensor:
        """(n_layers, dim): each decoder layer's `ffn_norm` weight times
        1 + its AdaRMSNorm scales for a delay of `n_delay` tokens, taken in
        f32 and cast to the compute dtype once (JAX multiplies the normed
        h by the weight, then by 1 + the scales)."""
        d = self.config.decoder
        t_cond = torch.from_numpy(compute_time_embedding(
            float(n_delay), d.dim)).to(self.device)
        gain = 1.0 + ada_scales(self.decoder, d, t_cond)
        w = torch.stack([blk.ffn_norm.weight.float()
                         for blk in self.decoder.layers])
        return (w * gain).to(self.dtype)

    def decoder_caches(self, cap: int) -> KVCache:
        d = self.config.decoder
        return KVCache.init(1, cap, d.n_kv_heads, d.head_dim,
                            dtype=torch.float32, device=self.device,
                            n_layers=d.n_layers)

    def prompt_ids(self, prompt_len: int) -> torch.Tensor:
        cfg = self.config
        return torch.tensor([cfg.bos_token_id] + [cfg.streaming_pad_token_id]
                            * (prompt_len - 1), device=self.device)

    # ----------------------------------------------------------- encode

    @torch.inference_mode()
    def encode(self, padded_audio) -> Tuple[torch.Tensor, int]:
        """Padded audio -> ((1, n_audio, dec_dim) adapter frames on the
        device, n_audio). The mel is padded to a bucket of MEL_BUCKETS (then
        to a multiple of 2048), as in the JAX package."""
        cfg = self.config
        mel = voxtral_mel(torch.as_tensor(padded_audio, dtype=torch.float32,
                                          device=self.device),
                          cfg.audio_encoding_args)
        if mel.shape[0] % 2:
            mel = mel[1:]
        n = mel.shape[0]
        b = next((x for x in MEL_BUCKETS if n <= x),
                 ((n + 2047) // 2048) * 2048)
        padded = F.pad(mel, (0, 0, 0, b - n))[None].to(self.dtype)
        out = encode_audio(self, padded, n)
        n_audio = (n // 2) // cfg.encoder_args.downsample_factor
        return out[:, :n_audio], n_audio

    # --------------------------------------------------------- generate

    @torch.inference_mode()
    def _run(self, audio_np: np.ndarray, max_tokens: int,
             delay_ms: Optional[int]):
        """Yield (new_tokens, n_audio, prompt_len) per DEC_CHUNK positions.

        The token at position p is the argmax of the logits of the step at
        p - 1, for p in [prompt_len, n_audio]; the step at p feeds adapter
        frame p plus the embedding of that token. Tokens from the first EOS
        on are dropped (-1), as JAX's chunk drops them."""
        cfg = self.config
        eos = cfg.eos_token_id
        n_delay = _num_delay_tokens(delay_ms
                                    or cfg.transcription_delay_ms)
        padded = _pad_audio_streaming(audio_np, cfg.n_left_pad_tokens,
                                      (n_delay + 1) + 10)
        adapter, n_audio = self.encode(padded)
        adapter = adapter[0]
        prompt_len = 1 + cfg.n_left_pad_tokens + n_delay
        ffn_w = self.ffn_norm_weights(n_delay)
        caches = self.decoder_caches(n_audio)
        embeds = adapter[:prompt_len] + self.token_embeddings(
            self.prompt_ids(prompt_len))
        h = decoder_forward(self, embeds[None], ffn_w, caches, 0)
        lg = logits(self, h[0, -1:])
        done = torch.zeros(1, dtype=torch.bool, device=self.device)
        pos = prompt_len
        emitted = 0
        while pos <= n_audio and emitted < max_tokens:
            k = min(DEC_CHUNK, n_audio + 1 - pos, max_tokens - emitted)
            # a later chunk can follow only a whole chunk with room after it
            more = k == DEC_CHUNK and k < min(n_audio + 1 - pos,
                                              max_tokens - emitted)
            toks = []
            for i in range(k):
                tok = lg.argmax(-1)
                done = done | (tok == eos)
                toks.append(torch.where(done, -1, tok))
                if i < k - 1 or more:
                    emb = adapter[pos + i] + self.token_embeddings(tok)
                    h = decoder_forward(self, emb[None], ffn_w, caches,
                                        pos + i)
                    lg = logits(self, h[0])
            pos += k
            arr = torch.cat(toks + [done.long()]).tolist()   # one read
            new = [t for t in arr[:-1] if t >= 0]
            emitted += len(new)
            yield new, n_audio, prompt_len
            if arr[-1]:
                break

    def generate(self, audio, *, max_tokens: int = 4096,
                 temperature: float = 0.0, verbose: bool = False,
                 stream: bool = False,
                 transcription_delay_ms: Optional[int] = None,
                 **kwargs):
        """Greedy transcription of `audio` (a path, or 16-kHz samples):
        an STTOutput, or with `stream=True` a generator of text deltas, one
        per decoded chunk. Needs the tekken tokenizer (`post_load_hook`)."""
        if self._tokenizer is None:
            raise RuntimeError("voxtral_realtime needs tekken.json in the "
                               "model directory")
        audio_np = self._load(audio)
        if stream:
            return self._stream_deltas(audio_np, max_tokens,
                                       transcription_delay_ms)
        t0 = time.time()
        tokens: List[int] = []
        prompt_len = 0
        for new, n_audio, prompt_len in self._run(
                audio_np, max_tokens, transcription_delay_ms):
            tokens.extend(new)
        text = self._tokenizer.decode(
            [t for t in tokens if t != self.config.eos_token_id])
        dt = time.time() - t0
        return STTOutput(
            text=text.strip(), language="en",
            segments=[{"text": text.strip(), "start": 0.0,
                       "end": len(audio_np) / SAMPLE_RATE}],
            prompt_tokens=prompt_len, generation_tokens=len(tokens),
            total_tokens=prompt_len + len(tokens), total_time=dt,
            generation_tps=len(tokens) / dt if dt > 0 else 0)

    def _stream_deltas(self, audio_np, max_tokens, delay_ms):
        """Yield text deltas per decoded chunk."""
        tokens: List[int] = []
        prev = ""
        eos = self.config.eos_token_id
        for new, _, _ in self._run(audio_np, max_tokens, delay_ms):
            tokens.extend(t for t in new if t != eos)
            text = self._tokenizer.decode(tokens)
            if len(text) > len(prev):
                yield text[len(prev):]
                prev = text

    @staticmethod
    def _load(audio) -> np.ndarray:
        from ....utils import load_audio

        x = audio[0] if isinstance(audio, list) else audio
        if isinstance(x, str):
            x = load_audio(x, sample_rate=SAMPLE_RATE)
        return np.asarray(x, np.float32).reshape(-1)

    # ---------------------------------------------------------- loading

    # published mistralai consolidated.safetensors prefixes
    _ENC_PREFIX = "mm_streams_embeddings.embedding_module.whisper_encoder"
    _ADAPTER_PREFIX = "mm_streams_embeddings.embedding_module"

    @classmethod
    def _remap_consolidated(cls, weights: Dict) -> Dict:
        """mistral consolidated.safetensors keys -> the JAX tree's names.
        No-op for converted checkpoints (no mm_streams_embeddings or
        layers. keys)."""
        if not any(k.startswith(("mm_streams_embeddings.", "layers."))
                   for k in weights):
            return weights
        enc, ad = cls._ENC_PREFIX, cls._ADAPTER_PREFIX
        out = {}
        for k, v in weights.items():
            if k == f"{ad}.tok_embeddings.weight":
                out["decoder.tok_embeddings.weight"] = v
            elif k == "norm.weight":
                out["decoder.norm.weight"] = v
            elif k.startswith(f"{enc}.conv_layers."):
                idx, _, param = k[len(f"{enc}.conv_layers."):].split(".", 2)
                out[f"encoder.conv_layers_{idx}_conv.conv.{param}"] = v
            elif k.startswith(f"{enc}.transformer.layers."):
                idx, rest = k[len(f"{enc}.transformer.layers."):] \
                    .split(".", 1)
                rest = rest.replace("feed_forward.w", "feed_forward_w")
                out[f"encoder.transformer_layers.{idx}.{rest}"] = v
            elif k.startswith(f"{enc}.transformer.norm."):
                out["encoder.transformer_norm."
                    + k[len(f"{enc}.transformer.norm."):]] = v
            elif k.startswith(f"{ad}.audio_language_projection."):
                idx, param = k[len(f"{ad}.audio_language_projection."):] \
                    .split(".", 1)
                out[f"encoder.audio_language_projection_{idx}.{param}"] = v
            elif k.startswith("layers."):
                idx, rest = k[len("layers."):].split(".", 1)
                rest = rest.replace("feed_forward.w", "feed_forward_w")
                rest = rest.replace("ada_rms_norm_t_cond.0.",
                                    "ada_rms_norm_t_cond.ada_down.")
                rest = rest.replace("ada_rms_norm_t_cond.2.",
                                    "ada_rms_norm_t_cond.ada_up.")
                out[f"decoder.layers.{idx}.{rest}"] = v
            else:
                out[k] = v
        return out

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """Checkpoint keys and conv layouts -> the JAX tree's (conv weights
        WIO (3, I, O), from MLX (O, 3, I) or torch (O, I, 3)), as numpy;
        `model.load_jax_params` converts to the port's layouts."""
        out = {}
        for k, v in self._remap_consolidated(weights).items():
            v = np.asarray(v)
            if "conv" in k and k.endswith("weight") and v.ndim == 3 \
                    and v.shape[0] != 3:
                v = np.transpose(v, (1, 2, 0) if v.shape[1] == 3
                                 else (2, 1, 0))
            out[k] = v
        return out

    def create_streaming_session(self, **kwargs):
        """Live feed()/close()/step() session (streaming.py)."""
        if self._tokenizer is None:
            raise RuntimeError("voxtral_realtime needs tekken.json in the "
                               "model directory")
        from .streaming import VoxtralStreamingSession
        return VoxtralStreamingSession(self, **kwargs)

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        try:
            model._tokenizer = TekkenTokenizer.from_model_path(model_path)
        except FileNotFoundError:
            model._tokenizer = None
        return model


__all__ = ["Model", "ModelConfig", "TekkenTokenizer", "voxtral_mel",
           "encode_audio", "decoder_forward", "ada_scales",
           "compute_time_embedding", "_num_audio_tokens",
           "_num_delay_tokens", "_pad_audio_streaming"]
