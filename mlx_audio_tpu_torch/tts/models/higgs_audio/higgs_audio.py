"""Higgs Audio v2 (3B): a dual-FFN Llama that speaks in 8 delayed codebooks,
decoded to 24 kHz audio by the Higgs acoustic tokenizer.

Counterpart of mlx_audio_tpu/tts/models/higgs_audio/higgs_audio.py:

* the backbone (`higgs_forward`, :168-220): shared attention (GQA, Llama-3
  scaled RoPE), and per row either the text or the audio path's norms and
  MLP, chosen by `audio_out_mask`. A prefill computes each path the mask
  needs and selects, as JAX's `jnp.where` does; a decode step (every row
  audio, :448-449) runs the audio path alone, so its text MLP is never
  streamed (XLA drops it in the JAX package, bench.py:478-481);
* the frame loop: `prefill` (:394-425: KV caches in the parameters' dtype,
  padded prompt rows masked past `plen`, frame 0 all BOS) and `chunk`
  (:427-495: CHUNK_FRAMES eager steps with their state on the device:
  sampling with greedy warm-up, then `frame_rules`, RAS over a (K, 8)
  window, delay ramp-in, EOS ramp-out and `done`). `generate_frames`
  (:497-539) copies each chunk's frames and flags to the host once and
  trims at the first `done`. A caller may drive `prefill` and `chunk`
  directly, as bench.py:438-448 drives JAX's `_prefill_fn` and `_chunk_fn`;
* the request: `build_prompt` (:322-391, the smart-voice and voice-clone
  ChatML prompts, the mask over the reference's codes), `generate`
  (:541-606, the `references=` alias, edge fades, streamed overlap-add
  :624-681), `_frames_to_codes` and `_decode_codes` (:608-622), `_result`
  (:683-704, both of JAX's RTF conventions) and `HiggsAudioServer`
  (:707-741);
* loading: `sanitize` (:276-285, the tied text head), the quantization
  predicate (:287-291) and `post_load_hook` (:293-302, the HF tokenizer).

Departures from the JAX package, each pinned by a test in
tests/test_torch_higgs_audio.py:

* the KV cache holds the whole request. JAX sizes it min(_bucket(need),
  4096), where `_bucket` returns 2,048 for any need past it; decode
  writes past column 2,047 are clamped onto it and overwrite the previous
  frame's K/V. Here the cache is the smallest of PROMPT_BUCKETS + (4096,)
  that holds pb + max_new_frames + K + CHUNK_FRAMES, and a prompt over
  2,048 tokens or a request past 4,096 columns raises ValueError before the
  prefill. Where JAX's sizing suffices the length, and so every frame, is
  JAX's;
* codes cross to the codec in the codec's own layout: `encode` gives
  (T, K) and `decode` takes (T, K) (as bench.py:466-467 calls it). JAX's
  model reshapes the (T, K) reference codes to (K, T) and hands `decode`
  (1, K, T), which its codec reads as K frames;
* the random draw: a torch.Generator (exponential race), not JAX's key
  stream, so only greedy decoding is compared between the packages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Embedding, Linear, RMSNorm
from ....ops.attention import attention, decode_attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import (apply_rotary, rope_cos_sin, rope_freqs,
                          rope_freqs_llama3)
from ....ops.sampling import top_k_top_p_filter
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)

MAX_CACHE_LEN = 4096
CHUNK_FRAMES = 16
PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048)
CACHE_BUCKETS = PROMPT_BUCKETS + (MAX_CACHE_LEN,)
RAS_WINDOW = 8


def _smallest(n: int, buckets, what: str) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{what} of {n} exceeds the largest bucket "
                     f"{buckets[-1]}")


def prompt_bucket(plen: int) -> int:
    """The prefill's padded length; a prompt over 2,048 tokens raises."""
    return _smallest(plen, PROMPT_BUCKETS, "a prompt")


def cache_length(pb: int, max_new_frames: int, n_books: int) -> int:
    """KV columns for a request: the smallest of CACHE_BUCKETS that holds
    the prompt bucket, max_new_frames, the delay ramp and one chunk's
    overrun; past 4,096 it raises."""
    return _smallest(pb + max_new_frames + n_books + CHUNK_FRAMES,
                     CACHE_BUCKETS, "a request needing KV columns")


@dataclass
class HiggsTextConfig(BaseModelArgs):
    hidden_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 24
    num_key_value_heads: int = 8
    intermediate_size: int = 8192
    vocab_size: int = 128256
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    rope_scaling: Optional[dict] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "higgs_audio"
    text_config: Optional[dict] = None
    audio_num_codebooks: int = 8
    audio_codebook_size: int = 1024
    audio_stream_bos_id: int = 1024
    audio_stream_eos_id: int = 1025
    use_delay_pattern: bool = True
    sample_rate: int = 24000
    model_path: str = ""

    def __post_init__(self):
        self.text = HiggsTextConfig.from_dict(self.text_config or {})

    @property
    def stride(self) -> int:
        return self.audio_codebook_size + 2


# ---------------------------------------------------------------- modules


class MLP(nn.Module):
    def __init__(self, t: HiggsTextConfig):
        super().__init__()
        self.gate_proj = Linear(t.hidden_size, t.intermediate_size, bias=False)
        self.up_proj = Linear(t.hidden_size, t.intermediate_size, bias=False)
        self.down_proj = Linear(t.intermediate_size, t.hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DualFFNLayer(nn.Module):
    """Shared attention; a text and an audio copy of the norms and MLP."""

    def __init__(self, t: HiggsTextConfig):
        super().__init__()
        hd, d = t.head_dim, t.hidden_size
        self.input_layernorm = RMSNorm(d, t.rms_norm_eps)
        self.audio_input_layernorm = RMSNorm(d, t.rms_norm_eps)
        self.self_attn = holder(
            q_proj=Linear(d, t.num_attention_heads * hd, bias=False),
            k_proj=Linear(d, t.num_key_value_heads * hd, bias=False),
            v_proj=Linear(d, t.num_key_value_heads * hd, bias=False),
            o_proj=Linear(t.num_attention_heads * hd, d, bias=False))
        self.post_attention_layernorm = RMSNorm(d, t.rms_norm_eps)
        self.audio_post_attention_layernorm = RMSNorm(d, t.rms_norm_eps)
        self.mlp = MLP(t)
        self.audio_mlp = MLP(t)


def _inv_freq(t: HiggsTextConfig) -> torch.Tensor:
    rs = t.rope_scaling or {}
    if rs.get("rope_type") == "llama3":
        return rope_freqs_llama3(
            t.head_dim, t.rope_theta, factor=rs.get("factor", 8.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position=rs.get(
                "original_max_position_embeddings", 8192))
    return rope_freqs(t.head_dim, t.rope_theta)


def _routed(m: Optional[torch.Tensor], paths, audio_fn, text_fn, x):
    """The audio or the text path, or both selected per row by m (B, T, 1)."""
    if paths == (True, False):
        return audio_fn(x)
    if paths == (False, True):
        return text_fn(x)
    return torch.where(m, audio_fn(x), text_fn(x))


def higgs_forward(model: "Model", embeds: torch.Tensor,
                  audio_out_mask: Optional[torch.Tensor],
                  caches: Optional[KVCache] = None, offset: int = 0,
                  pad_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Dual-FFN stack: embeds (B, T, D) -> final-normed hidden (B, T, D).

    `audio_out_mask` (B, T) bool routes each row; None means every row is
    audio, and then only the audio norms and MLPs run (a decode step). With
    a mask, each path that some row takes is computed for all rows and
    selected, as JAX's; a path no row takes is skipped (one read of the
    mask on the host). `caches` is written in place at `offset` (a host
    int); T == 1 attends to the first offset + 1 columns, a longer T to
    the causal columns plus `pad_mask` (additive, broadcast over (B, H, T,
    S)); without caches attention is causal over T."""
    t = model.config.text
    hd = t.head_dim
    b, tl, _ = embeds.shape
    dev = embeds.device
    x = embeds
    if audio_out_mask is None:
        paths, m = (True, False), None
    else:
        m = audio_out_mask[..., None]
        paths = (bool(audio_out_mask.any()), bool((~audio_out_mask).any()))
    positions = offset + torch.arange(tl, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, model.inv_freq)
    if caches is None:
        causal = torch.ones(tl, tl, dtype=torch.bool, device=dev).tril()
        add = torch.zeros(tl, tl, device=dev).masked_fill(~causal,
                                                          float("-inf"))
    elif tl == 1:
        valid = (torch.arange(caches.k.shape[2], device=dev)
                 <= offset)[None].expand(b, -1)
    else:
        pos_s = torch.arange(caches.k.shape[2],
                             device=dev)[None, None, None, :]
        causal = pos_s <= (offset + torch.arange(tl, device=dev))[
            None, None, :, None]
        add = torch.zeros(causal.shape, device=dev).masked_fill(
            ~causal, float("-inf"))
        if pad_mask is not None:
            add = add + pad_mask
    for i, lp in enumerate(model.layers):
        hn = _routed(m, paths, lp.audio_input_layernorm, lp.input_layernorm,
                     x)
        sa = lp.self_attn
        q = apply_rotary(sa.q_proj(hn).reshape(b, tl, t.num_attention_heads,
                                               hd), cos, sin)
        k = apply_rotary(sa.k_proj(hn).reshape(b, tl, t.num_key_value_heads,
                                               hd), cos, sin)
        v = sa.v_proj(hn).reshape(b, tl, t.num_key_value_heads, hd)
        if caches is None:
            o = attention(q, k, v, mask=add)
        else:
            nc = kv_update(caches.layer(i), k, v, offset)
            if tl == 1:
                o = decode_attention(q, nc.k, nc.v, offset + 1,
                                     lengths_mask=valid)
            else:
                o = attention(q, nc.k, nc.v, mask=add)
        x = x + sa.o_proj(o.reshape(b, tl, -1))
        post = _routed(m, paths, lp.audio_post_attention_layernorm,
                       lp.post_attention_layernorm, x)
        x = x + _routed(m, paths, lp.audio_mlp, lp.mlp, post)
    return model.norm(x), caches


# ------------------------------------------------------------ delay pattern


def revert_delay_pattern(delayed: np.ndarray) -> np.ndarray:
    """(K, N) delayed -> (K, N-K+1) aligned (codebook k read at +k)."""
    k, n = delayed.shape
    t = n - k + 1
    if t <= 0:
        return np.zeros((k, 0), delayed.dtype)
    return np.stack([delayed[i, i: i + t] for i in range(k)], axis=0)


def apply_delay_pattern(codes: np.ndarray, bos: int, eos: int) -> np.ndarray:
    """(K, T) aligned -> (K, T+K-1) delayed: row k shifted right k, BOS
    above the diagonal, EOS below."""
    k, t = codes.shape
    out = np.full((k, t + k - 1), eos, dtype=codes.dtype)
    for i in range(k):
        out[i, :i] = bos
        out[i, i: i + t] = codes[i]
    return out


# ------------------------------------------------------------- frame rules


class FrameState(NamedTuple):
    """The rule state of the frame loop, on the device."""

    num_delay: torch.Tensor      # 0-dim int64: codebooks released so far
    num_remaining: torch.Tensor  # 0-dim int64: -1 = ramp-out not started
    done: torch.Tensor           # 0-dim bool
    ras_window: torch.Tensor     # (K, RAS_WINDOW) recent tokens


def initial_state(n_books: int, bos: int, device) -> FrameState:
    return FrameState(
        num_delay=torch.zeros((), dtype=torch.int64, device=device),
        num_remaining=torch.full((), -1, dtype=torch.int64, device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
        ras_window=torch.full((n_books, RAS_WINDOW), bos, dtype=torch.int64,
                              device=device))


def frame_rules(tok: torch.Tensor, greedy: torch.Tensor, state: FrameState,
                *, bos: int, eos: int, ras_win_len: int,
                ras_max_repeat: int) -> Tuple[torch.Tensor, FrameState]:
    """One frame's rules on drawn tokens tok (K,) and the greedy ones
    (:456-477), all on the device: RAS (a codebook whose token repeats
    ras_max_repeat times in the last ras_win_len frames falls back to
    greedy), the delay ramp-in (codebooks past num_delay forced to BOS),
    the EOS ramp-out (once EOS appears, every codebook before the last EOS
    is EOS, and the count of frames left runs down) and `done` (set the
    frame after the count reaches 0). -> (tokens, next state)."""
    k = tok.shape[0]
    idx = torch.arange(k, device=tok.device)
    if ras_win_len > 0:
        win = state.ras_window[:, -ras_win_len:]
        count = (win == tok[:, None]).sum(dim=1)
        tok = torch.where(count >= ras_max_repeat, greedy, tok)
    ramping = state.num_delay + 1 < k
    tok = torch.where(ramping & (idx > state.num_delay), bos, tok)
    num_delay = torch.where(ramping, state.num_delay + 1, state.num_delay)
    started = state.num_remaining >= 0
    tok = torch.where(started & (idx < k - state.num_remaining), eos, tok)
    eos_mask = tok == eos
    any_eos = eos_mask.any()
    last_eos = (k - 1) - torch.argmax(
        torch.flip(eos_mask, (0,)).to(torch.int8))
    tok = torch.where(~started & any_eos & (idx < last_eos), eos, tok)
    num_remaining = torch.where(
        started, state.num_remaining - 1,
        torch.where(any_eos, k - last_eos - 1, -1))
    done = state.done | (started & (state.num_remaining <= 0))
    window = torch.cat([state.ras_window[:, 1:], tok[:, None]], dim=1)
    return tok, FrameState(num_delay, num_remaining, done, window)


@dataclass
class FrameCarry:
    """State carried from one frame to the next: the KV caches (written in
    place), the next input embedding, the host's counters (cache offset,
    frames sampled) and the rule state and random stream on the device."""

    caches: KVCache
    embed: torch.Tensor          # (1, 1, D)
    offset: int
    step: int
    state: FrameState
    generator: torch.Generator


@dataclass
class Sampling:
    """The chunk step's sampling options (JAX's `_chunk_fn` arguments)."""

    temperature: float = 0.7
    top_p: float = 0.95
    top_k: int = 0
    ras_win_len: int = 7
    ras_max_repeat: int = 2
    warmup: int = 0


# ---------------------------------------------------------------- model


class Model(TorchModel):
    """Higgs Audio v2 (voice cloning and smart voice) on `device`: the card
    by default; without CUDA the constructor raises unless given
    `device="cpu"`. Bind a codec (`model.codec = codec.Model(...)`) for
    audio, and an HF tokenizer (`post_load_hook`) for text prompts."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        t = config.text
        k = config.audio_num_codebooks
        with torch.device(device):
            self.embed_tokens = Embedding(t.vocab_size, t.hidden_size)
            self.audio_codebook_embeddings = Embedding(k * config.stride,
                                                       t.hidden_size)
            self.layers = nn.ModuleList(DualFFNLayer(t)
                                        for _ in range(t.num_hidden_layers))
            self.norm = RMSNorm(t.hidden_size, t.rms_norm_eps)
            self.audio_decoder_proj = holder(
                text_lm_head=Linear(t.hidden_size, t.vocab_size, bias=False),
                audio_lm_head=Linear(t.hidden_size, k * config.stride,
                                     bias=False))
        self.register_buffer("inv_freq", _inv_freq(t).to(device),
                             persistent=False)
        self.register_buffer("code_offsets", torch.arange(
            k, device=device) * config.stride, persistent=False)
        self.requires_grad_(False)
        self.eval()
        self.tokenizer = None
        self.codec = None
        self.last_run: Dict[str, int] = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    # ---------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict:
        """Drop `rotary_emb.inv_freq`; with tie_word_embeddings the published
        checkpoint has no text head, which then is `embed_tokens`."""
        out = {k: np.asarray(v) for k, v in weights.items()
               if not k.endswith("rotary_emb.inv_freq")}
        tied = "audio_decoder_proj.text_lm_head.weight"
        if tied not in out and "embed_tokens.weight" in out:
            out[tied] = out["embed_tokens.weight"]
        return out

    def model_quant_predicate(self, path: str, w) -> bool:
        """The audio head and the codebook embeddings stay dense."""
        return not any(p in path for p in
                       ("audio_codebook_embeddings", "audio_lm_head"))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The HF text tokenizer. `tokenizer` stays None when `transformers`
        is not installed or the directory holds no tokenizer files; any
        other failure to read them raises."""
        model.tokenizer = local_tokenizer(model_path)
        return model

    # -------------------------------------------------------- embeddings

    def _embed_frame(self, frame: torch.Tensor) -> torch.Tensor:
        """(K,) delayed codes -> (1, 1, D) summed codebook embedding."""
        e = self.audio_codebook_embeddings(frame.long() + self.code_offsets)
        return e.sum(dim=0)[None, None]

    def _audio_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(D,) -> (K, C + 2)."""
        cfg = self.config
        flat = self.audio_decoder_proj.audio_lm_head(hidden)
        return flat.reshape(cfg.audio_num_codebooks, cfg.stride)

    # ------------------------------------------------------------ prompt

    def _embed_text(self, s: str) -> torch.Tensor:
        ids = self.tokenizer.encode(s, add_special_tokens=False)
        return self.embed_tokens(torch.tensor(ids, dtype=torch.int64,
                                              device=self.device))

    def build_prompt(self, text: str, ref_audio=None,
                     ref_text: Optional[str] = None, ref_codes=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (embeds (1, T, D), audio_out_mask (1, T) bool), on the device.

        Voice clone (reference audio or its (K, T) codes given): ChatML
        user(ref_text) / assistant(<the reference's delayed codes>) /
        user(text) / assistant <|audio_out_bos|>, the mask true over the
        codes. Smart voice otherwise."""
        if self.tokenizer is None:
            raise RuntimeError("higgs_audio needs the HF text tokenizer")
        cfg = self.config
        k = cfg.audio_num_codebooks
        dev = self.device
        if ref_audio is None and ref_codes is None:
            prompt = ("<|begin_of_text|><|start_header_id|>user"
                      f"<|end_header_id|>\n\n{text}<|eot_id|>"
                      "<|start_header_id|>assistant<|end_header_id|>\n\n"
                      "<|audio_out_bos|>")
            emb = self._embed_text(prompt)
            return emb[None], torch.zeros((1, emb.shape[0]), dtype=torch.bool,
                                          device=dev)
        if ref_codes is None:
            if self.codec is None:
                raise RuntimeError("voice cloning needs the codec bound "
                                   "(model.codec = ...)")
            ref_codes = self._reference_codes(ref_audio)
        ref_codes = np.asarray(ref_codes, np.int64)
        bos_col = np.full((k, 1), cfg.audio_stream_bos_id, np.int64)
        eos_col = np.full((k, 1), cfg.audio_stream_eos_id, np.int64)
        delayed = apply_delay_pattern(ref_codes, cfg.audio_stream_bos_id,
                                      cfg.audio_stream_eos_id)
        delayed = np.concatenate([bos_col, delayed, eos_col], axis=1)
        codes = torch.from_numpy(delayed).to(dev) + self.code_offsets[:, None]
        audio_emb = self.audio_codebook_embeddings(codes).sum(dim=0)
        prefix = ("<|begin_of_text|><|start_header_id|>user"
                  f"<|end_header_id|>\n\n{ref_text or ''}<|eot_id|>"
                  "<|start_header_id|>assistant<|end_header_id|>\n\n"
                  "<|audio_out_bos|>")
        middle = ("<|audio_eos|><|eot_id|>"
                  "<|start_header_id|>user<|end_header_id|>\n\n"
                  f"{text}<|eot_id|>"
                  "<|start_header_id|>assistant<|end_header_id|>\n\n"
                  "<|audio_out_bos|>")
        pre, mid = self._embed_text(prefix), self._embed_text(middle)
        embeds = torch.cat([pre, audio_emb, mid], dim=0)[None]
        mask = torch.cat([
            torch.zeros(pre.shape[0], dtype=torch.bool, device=dev),
            torch.ones(audio_emb.shape[0], dtype=torch.bool, device=dev),
            torch.zeros(mid.shape[0], dtype=torch.bool, device=dev)])[None]
        return embeds, mask

    def _reference_codes(self, ref_audio) -> np.ndarray:
        """The codec's (T, K) codes of a 24 kHz reference -> (K, T)."""
        codes = np.asarray(self.codec.encode(
            np.asarray(ref_audio, np.float32).reshape(-1)))
        return codes.reshape(-1, self.config.audio_num_codebooks).T

    # -------------------------------------------------------- frame loop

    @torch.no_grad()
    def prefill(self, embeds: torch.Tensor, mask: torch.Tensor, plen: int,
                cache_len: int, seed: int = 0
                ) -> Tuple[FrameCarry, np.ndarray]:
        """Run the padded prompt (1, pb, D) into fresh caches of cache_len
        columns in the parameters' dtype. -> (carry, frame 0: the all-BOS
        AUDIO_INIT frame, never sampled)."""
        cfg = self.config
        t = cfg.text
        dev = self.device
        caches = KVCache.init(1, cache_len, t.num_key_value_heads,
                              t.head_dim, self.embed_tokens.weight.dtype,
                              dev, n_layers=t.num_hidden_layers)
        pad = torch.zeros(cache_len, device=dev).masked_fill(
            torch.arange(cache_len, device=dev) >= plen,
            float("-inf"))[None, None, None, :]
        higgs_forward(self, embeds, mask, caches, 0, pad_mask=pad)
        k = cfg.audio_num_codebooks
        frame0 = torch.full((k,), cfg.audio_stream_bos_id, dtype=torch.int64,
                            device=dev)
        carry = FrameCarry(
            caches=caches, embed=self._embed_frame(frame0), offset=plen,
            step=0, state=initial_state(k, cfg.audio_stream_bos_id, dev),
            generator=torch.Generator(device=dev).manual_seed(seed))
        return carry, np.full((k,), cfg.audio_stream_bos_id, np.int32)

    def _sample(self, logits: torch.Tensor, sampling: Sampling, step: int,
                generator: torch.Generator):
        """(drawn, greedy) tokens (K,) from logits (K, C + 2): greedy in the
        warm-up and at temperature <= 0, else top-k/top-p filtered at the
        temperature and drawn by an exponential race from `generator`."""
        greedy = torch.argmax(logits, dim=-1)
        if sampling.temperature <= 0.0 or step < sampling.warmup:
            return greedy, greedy
        lg = logits.float() / max(sampling.temperature, 1e-6)
        lg = top_k_top_p_filter(lg, top_k=sampling.top_k or 0,
                                top_p=sampling.top_p if sampling.top_p
                                else 1.0)
        probs = torch.softmax(lg, dim=-1)
        race = torch.empty_like(probs).exponential_(generator=generator)
        return torch.argmax(probs / race, dim=-1), greedy

    @torch.no_grad()
    def chunk(self, carry: FrameCarry, sampling: Sampling,
              n: int = CHUNK_FRAMES) -> Tuple[torch.Tensor, torch.Tensor]:
        """n decode steps from `carry` (advanced in place), nothing read on
        the host. -> (frames (n, K) int64, done flags (n,) bool), on the
        device."""
        cfg = self.config
        frames, dones = [], []
        for _ in range(n):
            hidden, _ = higgs_forward(self, carry.embed, None, carry.caches,
                                      carry.offset)
            logits = self._audio_logits(hidden[0, -1])
            tok, greedy = self._sample(logits, sampling, carry.step,
                                       carry.generator)
            tok, carry.state = frame_rules(
                tok, greedy, carry.state, bos=cfg.audio_stream_bos_id,
                eos=cfg.audio_stream_eos_id,
                ras_win_len=sampling.ras_win_len,
                ras_max_repeat=sampling.ras_max_repeat)
            carry.embed = self._embed_frame(tok)
            carry.offset += 1
            carry.step += 1
            frames.append(tok)
            dones.append(carry.state.done)
        return torch.stack(frames), torch.stack(dones)

    def generate_frames(self, embeds: torch.Tensor, mask: torch.Tensor, *,
                        max_new_frames: int = 900,
                        temperature: float = 0.7, top_p: float = 0.95,
                        top_k: int = 0, ras_win_len: int = 7,
                        ras_max_repeat: int = 2,
                        sampling_warmup_frames: int = 0,
                        seed: int = 0) -> Iterator[np.ndarray]:
        """Yield delayed (chunk, K) int32 frame blocks (frame 0 = AUDIO_INIT),
        the last trimmed at the first `done`. One copy to the host a
        chunk. Raises ValueError before the prefill when the prompt or the
        request does not fit (`prompt_bucket`, `cache_length`)."""
        cfg = self.config
        plen = embeds.shape[1]
        pb = prompt_bucket(plen)
        cache_len = cache_length(pb, max_new_frames, cfg.audio_num_codebooks)
        embeds = F.pad(embeds, (0, 0, 0, pb - plen))
        mask = F.pad(mask, (0, pb - mask.shape[1]))
        sampling = Sampling(temperature, top_p, top_k, ras_win_len,
                            ras_max_repeat, sampling_warmup_frames)
        self.last_run = {"prompt_len": plen, "prompt_bucket": pb,
                         "cache_len": cache_len, "chunks": 0}
        carry, frame0 = self.prefill(embeds, mask, plen, cache_len, seed)
        yield frame0[None]
        n = 0
        while n < max_new_frames:
            frames, dones = self.chunk(carry, sampling)
            self.last_run["chunks"] += 1
            host = torch.cat([frames, dones[:, None].long()], dim=1).cpu()
            f = host[:, :-1].numpy().astype(np.int32)
            d = host[:, -1].numpy().astype(bool)
            if d.any():
                yield f[: int(np.argmax(d)) + 1]
                return
            yield f
            n += len(f)

    # ------------------------------------------------------------ request

    def generate(self, text: str, *, ref_audio=None, ref_text=None,
                 ref_codes=None, voice: Optional[str] = None,
                 temperature: float = 0.7, top_p: float = 0.95,
                 top_k: int = 0, max_new_frames: int = 900,
                 max_tokens: Optional[int] = None,
                 ras_win_len: int = 7, ras_max_repeat: int = 2,
                 stream: bool = False, streaming_interval: float = 0.64,
                 overlap_ms: float = 40.0, fade_in_ms: float = 30.0,
                 fade_out_ms: float = 15.0,
                 references=None, seed: int = 0, verbose: bool = False,
                 **kwargs) -> Iterator[GenerationResult]:
        """Text (and an optional reference) -> one GenerationResult, or with
        stream=True overlap-added chunks (the last `is_final_chunk`)."""
        t0 = time.time()
        if max_tokens is not None:
            max_new_frames = max_tokens
        if references and ref_audio is None and ref_codes is None:
            # the reference's `references=[...]` alias: a list of {audio |
            # path, text} dicts or bare audio; v2's prompt conditions on one
            # reference, so the first is taken
            ref = references[0] if isinstance(
                references, (list, tuple)) else references
            if isinstance(ref, dict):
                ref_audio = next((ref[k] for k in
                                  ("audio", "audio_path", "path", "ref_audio")
                                  if ref.get(k) is not None), None)
                ref_codes = ref.get("codes", ref_codes)
                ref_text = ref.get("text", ref_text)
            else:
                ref_audio = ref
        if isinstance(ref_audio, (str, Path)):
            from ....utils import load_audio

            ref_audio = load_audio(str(ref_audio),
                                   sample_rate=self.sample_rate)
        embeds, mask = self.build_prompt(text, ref_audio=ref_audio,
                                         ref_text=ref_text,
                                         ref_codes=ref_codes)
        gen = self.generate_frames(
            embeds, mask, max_new_frames=max_new_frames,
            temperature=temperature, top_p=top_p, top_k=top_k,
            ras_win_len=ras_win_len, ras_max_repeat=ras_max_repeat,
            seed=seed)
        if stream:
            yield from self._stream_overlap_add(
                gen, t0, emit_every_frames=max(
                    int(streaming_interval * 25), 4),
                overlap_ms=overlap_ms)
            return
        frames = np.concatenate(list(gen), axis=0)       # (N, K) delayed
        codes = self._frames_to_codes(frames)
        audio = self._decode_codes(codes)
        sr = self.sample_rate
        n_in = int(fade_in_ms * sr / 1000.0)
        n_out = int(fade_out_ms * sr / 1000.0)
        audio = np.asarray(audio, np.float32).copy()
        if n_in > 0 and audio.size > n_in:
            audio[:n_in] *= np.linspace(0.0, 1.0, n_in, dtype=np.float32)
        if n_out > 0 and audio.size > n_out:
            audio[-n_out:] *= np.linspace(1.0, 0.0, n_out, dtype=np.float32)
        dt = time.time() - t0
        yield self._result(audio, 0, codes.shape[1], dt, codes=codes,
                           final=True)

    def _frames_to_codes(self, frames: np.ndarray) -> np.ndarray:
        """Delayed frame stack (N, K) -> aligned (K, T), the boundary frames
        trimmed."""
        aligned = revert_delay_pattern(frames.T.astype(np.int32))
        if aligned.shape[1] >= 2:
            aligned = aligned[:, 1:-1]
        return np.clip(aligned, 0, self.config.audio_codebook_size - 1)

    def _decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """Aligned codes (K, T) -> audio through the codec, which takes
        (T, K); without a codec, zeros of the length it would give."""
        if self.codec is not None and codes.shape[1]:
            return np.asarray(self.codec.decode(
                np.ascontiguousarray(codes.T))).reshape(-1)
        return np.zeros((codes.shape[1] * 960,), np.float32)

    def _stream_overlap_add(self, frame_gen, t0, *,
                            emit_every_frames: int = 16,
                            overlap_ms: float = 40.0,
                            fade_in_ms: float = 5.0
                            ) -> Iterator[GenerationResult]:
        """Re-decode the accumulated codes every emit_every_frames frames and
        crossfade the previous decode's tail into the new one."""
        sr = self.sample_rate
        overlap = int(overlap_ms * sr / 1000.0)
        n_fade = int(fade_in_ms * sr / 1000.0)
        frames: List[np.ndarray] = []
        emitted = 0
        tail: Optional[np.ndarray] = None
        seg = 0
        last_emit = 0
        seg_t0 = time.time()
        k = self.config.audio_num_codebooks

        def decode_now():
            codes = self._frames_to_codes(np.concatenate(frames, axis=0))
            if codes.shape[1] == 0:
                return None, codes
            return self._decode_codes(codes), codes

        for block in frame_gen:
            frames.append(block)
            total = sum(len(b) for b in frames)
            if total <= k + 1 or total - last_emit < emit_every_frames:
                continue
            last_emit = total
            pcm, codes = decode_now()
            if pcm is None:
                continue
            if seg == 0 and n_fade > 0 and pcm.size > n_fade:
                pcm[:n_fade] *= np.linspace(0, 1, n_fade, dtype=np.float32)
            if tail is not None and overlap > 0:
                ov = min(overlap, len(tail), len(pcm) - emitted)
                if ov > 0:
                    w = np.linspace(0, 1, ov, dtype=np.float32)
                    pcm[emitted:emitted + ov] = (
                        tail[:ov] * (1 - w) + pcm[emitted:emitted + ov] * w)
            emit_end = max(len(pcm) - overlap, emitted)
            chunk = pcm[emitted:emit_end]
            tail = pcm[emit_end:]
            emitted = emit_end
            if len(chunk):
                dt = time.time() - seg_t0
                seg_t0 = time.time()
                yield self._result(chunk, seg, codes.shape[1], dt,
                                   streaming=True)
                seg += 1
        pcm, codes = decode_now()
        if pcm is not None and len(pcm) > emitted:
            dt = time.time() - seg_t0
            yield self._result(pcm[emitted:], seg, codes.shape[1], dt,
                               streaming=True, final=True)

    def _result(self, audio, seg, n_codes, dt, codes=None, streaming=False,
                final=False) -> GenerationResult:
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=np.asarray(audio), samples=len(audio),
            sample_rate=self.sample_rate, segment_idx=seg,
            token_count=int(n_codes),
            audio_duration=format_duration(dur),
            # the reference's conventions: streamed chunks report audio /
            # elapsed, the whole result elapsed / audio
            real_time_factor=(round(dur / dt, 3) if streaming and dt > 0
                              else round(dt / dur, 3) if dur > 0 else 0.0),
            prompt={"tokens": int(n_codes),
                    "tokens-per-sec": round(n_codes / dt, 2) if dt else 0,
                    **({"codes": codes} if codes is not None else {})},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / dt, 2)
                           if dt else 0},
            processing_time_seconds=dt,
            peak_memory_usage=peak_memory_gb(),
            is_streaming_chunk=streaming, is_final_chunk=final)


class HiggsAudioServer:
    """Serving wrapper: a cached reference (its codes encoded once) and
    overlap-add streaming (HiggsAudioServer, :707-741)."""

    def __init__(self, model: Model):
        self.model = model
        self._reference: Optional[Tuple[np.ndarray, str]] = None

    def prepare_reference(self, ref_audio, ref_text: str = "") -> None:
        if self.model.codec is None:
            raise RuntimeError("codec not bound")
        self._reference = (self.model._reference_codes(ref_audio), ref_text)

    def clear_reference(self) -> None:
        self._reference = None

    def generate(self, target_text: str, **kwargs) -> GenerationResult:
        ref_codes, ref_text = self._reference or (None, None)
        return next(self.model.generate(
            target_text, ref_codes=ref_codes, ref_text=ref_text, **kwargs))

    def generate_stream_overlap_add(self, target_text: str, **kwargs
                                    ) -> Iterator[GenerationResult]:
        ref_codes, ref_text = self._reference or (None, None)
        yield from self.model.generate(
            target_text, ref_codes=ref_codes, ref_text=ref_text,
            stream=True, **kwargs)


__all__ = ["Model", "ModelConfig", "HiggsAudioServer", "HiggsTextConfig",
           "higgs_forward", "revert_delay_pattern", "apply_delay_pattern",
           "frame_rules", "FrameState", "FrameCarry", "Sampling",
           "prompt_bucket", "cache_length"]
