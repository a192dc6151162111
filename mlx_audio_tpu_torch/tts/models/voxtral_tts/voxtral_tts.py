"""Voxtral-4B-TTS: a Mistral LM -> a per-frame flow-matching acoustic head
-> an ALiBi conv/transformer codec decoder.

Counterpart of mlx_audio_tpu/tts/models/voxtral_tts/voxtral_tts.py:
`ModelConfig` (:76, with the Mistral `params.json` flattening of
`from_dict`, :131-174); the LM is the port's llama with interleaved RoPE
(`tts/models/llama`); `acoustic_velocity` (:290: three layers over the
rows (noisy codes, time, LLM hidden), unmasked attention, swiglu) and
`acoustic_decode_frame` (:316: the semantic argmax with the padding and
row 0 masked, 7 Euler steps of two CFG rows, clip, round, the +2 offset);
the audio-tokenizer decoder `audio_decode` (:474: the semantic codebook
from `embedding_sum / cluster_usage`, acoustic levels, causal convs with
replicate or reflect padding, transposed convs, ALiBi attention with QK
RMSNorm in causal windows of 2, 4, 8 and 16); the voice-embedding splice
(`_build_input_embeddings`, :640, on the device); `decode_audio_codes`,
`generate` (whole or streamed with 16 frames of context), `sanitize`
(:548-602, with the weight-norm fold) and `post_load_hook`.

The frame loop: the JAX package compiles a prefill plus one AUDIO-token
step, then chunks of DEC_CHUNK = 25 `lax.scan` frames (one acoustic frame,
the stop on semantic code <= 1, the sum of the 37 codebook embeddings at
`_global_offsets`, one LM step). Here the prefill runs the prompt
unpadded, and each chunk is 25 eager frames with every piece of state on
the device and one read a chunk (its codes and stop flags). The frames it
keeps are JAX's. The Euler state is f32; a bf16 model runs its linears in
bf16. The noise comes from a `torch.Generator` through `_draws`, the seam
through which the tests hand the port JAX's draws.

Departures, each pinned by a test in tests/test_torch_voxtral_tts.py:

* the codec decodes the frames it has. JAX pads them to a multiple of 64
  (:714-716); the decoder is causal, so the valid samples are equal;
* the decode stops at `max_tokens`: the last chunk runs only the frames
  left (JAX runs whole chunks and drops the rest), and the caches hold
  prompt + 1 + max_tokens columns;
* `post_load_hook` reads the directory only and raises on a `tekken.json`
  that fails to parse (JAX warns); without `mistral_common` it leaves no
  tokenizer, and `generate` then raises naming `mistral-common[audio]` and
  a tokenizer with `encode_speech(text, voice)`, as JAX's does.

q8 (`utils.apply_quantization`) quantizes every `Linear` whose input
width the group divides, but those named like a table, as the JAX
package's rule (`ops/quant.py`, `maybe_quantize_tree`) skips them: the
LM's and the codec's linears and the acoustic head's but
`input_projection` (36 wide) and the two `*_codebook_output` heads. The
tables and the convs stay dense. The quantized linears run on K2.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Generator, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder, leaves
from ....nn import Embedding, Linear, RMSNorm
from ....ops.attention import attention
from ....ops.kvcache import KVCache
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)
from ..llama.llama import Model as LlamaModel
from ..llama.llama import ModelConfig as LlamaConfig
from ..llama.llama import init_caches, llama_forward
from .text_preprocess import sanitize_tts_input_text_for_demo

DEC_CHUNK = 25          # 2 s of audio a chunk (80-ms frames)
N_SPECIAL = 2           # empty_audio, end_audio
CONTEXT_FRAMES = 16     # a streamed chunk's codec context

VOICE_MAP = {
    "casual_female": 0, "casual_male": 1, "cheerful_female": 2,
    "neutral_female": 3, "neutral_male": 4, "pt_male": 5, "pt_female": 6,
    "nl_male": 7, "nl_female": 8, "it_male": 9, "it_female": 10,
    "fr_male": 11, "fr_female": 12, "es_male": 13, "es_female": 14,
    "de_male": 15, "de_female": 16, "ar_male": 17, "hi_male": 18,
    "hi_female": 19,
}


def pad_to_multiple(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "voxtral_tts"
    dim: int = 3072
    n_layers: int = 26
    head_dim: int = 128
    hidden_dim: int = 9216
    n_heads: int = 32
    n_kv_heads: int = 8
    vocab_size: int = 131072
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    tied_embeddings: bool = True
    use_biases: bool = False
    max_position_embeddings: int = 128000
    sample_rate: int = 24000

    semantic_codebook_size: int = 8192
    acoustic_codebook_size: int = 21
    n_acoustic_codebook: int = 36
    frame_rate: float = 12.5
    num_codebooks: int = 37

    acoustic_dim: int = 3072
    acoustic_n_layers: int = 3
    acoustic_head_dim: int = 128
    acoustic_hidden_dim: int = 9216
    acoustic_n_heads: int = 32
    acoustic_n_kv_heads: int = 8
    acoustic_rope_theta: float = 10000.0
    acoustic_sigma: float = 1e-5
    acoustic_sigma_max: float = 1.0
    n_denoising_steps: int = 8
    cfg_alpha: float = 1.2

    tokenizer_dim: int = 1024
    tokenizer_hidden_dim: int = 4096
    tokenizer_n_heads: int = 8
    tokenizer_n_kv_heads: int = 8
    tokenizer_head_dim: int = 128
    tokenizer_patch_size: int = 240
    tokenizer_patch_proj_kernel_size: int = 7
    tokenizer_semantic_dim: int = 256
    tokenizer_acoustic_dim: int = 36
    tokenizer_norm_eps: float = 0.01
    tokenizer_layer_scale_init: float = 0.01
    tokenizer_decoder_transformer_lengths_str: str = "2,2,2,2"
    tokenizer_decoder_convs_kernels_str: str = "3,4,4,4"
    tokenizer_decoder_convs_strides_str: str = "1,2,2,2"

    bos_token_id: int = 1
    audio_token_id: int = 24
    begin_audio_token_id: int = 25
    model_path: Optional[str] = None

    @classmethod
    def from_dict(cls, params: dict) -> "ModelConfig":
        # a Mistral params.json -> the flat config
        if "multimodal" not in params:
            return super().from_dict(params)
        mm = params.get("multimodal", {})
        aa = mm.get("audio_model_args", {})
        enc = aa.get("audio_encoding_args", {})
        ac = aa.get("acoustic_transformer_args", {})
        tk = mm.get("audio_tokenizer_args", {})
        flat = {k: v for k, v in params.items()
                if k in cls.__dataclass_fields__}
        flat.update(dict(
            model_type="voxtral_tts",
            sample_rate=enc.get("sampling_rate", 24000),
            semantic_codebook_size=aa.get("semantic_codebook_size", 8192),
            acoustic_codebook_size=aa.get("acoustic_codebook_size", 21),
            n_acoustic_codebook=aa.get("n_acoustic_codebook", 36),
            frame_rate=enc.get("frame_rate", 12.5),
            num_codebooks=enc.get("num_codebooks", 37),
            acoustic_dim=ac.get("dim", 3072),
            acoustic_n_layers=ac.get("n_layers", 3),
            acoustic_head_dim=ac.get("head_dim", 128),
            acoustic_hidden_dim=ac.get("hidden_dim", 9216),
            acoustic_n_heads=ac.get("n_heads", 32),
            acoustic_n_kv_heads=ac.get("n_kv_heads", 8),
            acoustic_rope_theta=ac.get("rope_theta", 10000.0),
            acoustic_sigma=ac.get("sigma", 1e-5),
            acoustic_sigma_max=ac.get("sigma_max", 1.0),
            tokenizer_dim=tk.get("dim", 1024),
            tokenizer_hidden_dim=tk.get("hidden_dim", 4096),
            tokenizer_n_heads=tk.get("n_heads", 8),
            tokenizer_n_kv_heads=tk.get("n_kv_heads", 8),
            tokenizer_head_dim=tk.get("head_dim", 128),
            tokenizer_patch_size=tk.get("pretransform_patch_size", 240),
            tokenizer_patch_proj_kernel_size=tk.get(
                "patch_proj_kernel_size", 7),
            tokenizer_semantic_dim=tk.get("semantic_dim", 256),
            tokenizer_acoustic_dim=tk.get("acoustic_dim", 36),
            tokenizer_norm_eps=tk.get("norm_eps", 0.01),
            bos_token_id=mm.get("bos_token_id", 1),
            audio_token_id=aa.get("audio_token_id", 24),
            begin_audio_token_id=aa.get("begin_audio_token_id", 25),
        ))
        return super().from_dict(flat)

    @property
    def semantic_padded(self) -> int:
        return (self.semantic_codebook_size // 128 + 1) * 128

    @property
    def audio_embedding_size(self) -> int:
        return self.semantic_padded + pad_to_multiple(
            self.acoustic_codebook_size * self.n_acoustic_codebook, 128)

    @property
    def llama_config(self) -> LlamaConfig:
        return LlamaConfig(
            hidden_size=self.dim, num_hidden_layers=self.n_layers,
            intermediate_size=self.hidden_dim,
            num_attention_heads=self.n_heads,
            num_key_value_heads=self.n_kv_heads,
            vocab_size=self.vocab_size, rms_norm_eps=self.norm_eps,
            rope_theta=self.rope_theta, head_dim=self.head_dim,
            tie_word_embeddings=self.tied_embeddings,
            attention_bias=self.use_biases, rope_interleaved=True)

    @property
    def decoder_strides(self) -> List[int]:
        return [int(x) for x in
                self.tokenizer_decoder_convs_strides_str.split(",")]

    @property
    def decoder_kernels(self) -> List[int]:
        return [int(x) for x in
                self.tokenizer_decoder_convs_kernels_str.split(",")]

    @property
    def decoder_tf_lengths(self) -> List[int]:
        return [int(x) for x in
                self.tokenizer_decoder_transformer_lengths_str.split(",")]

    @property
    def samples_per_frame(self) -> int:
        up = 1
        for s in self.decoder_strides:
            up *= s
        return up * self.tokenizer_patch_size


# --------------------------------------------------------- shared parts

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 with the weight applied before the cast back, as the
    JAX module's `_rms`."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool = False):
        super().__init__()
        self.w1 = Linear(dim, hidden, bias=bias)
        self.w2 = Linear(hidden, dim, bias=bias)
        self.w3 = Linear(dim, hidden, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def _attn_holder(dim: int, n_heads: int, n_kv: int, head_dim: int,
                 bias: bool, qk_norm: bool) -> nn.Module:
    parts = dict(wq=Linear(dim, n_heads * head_dim, bias=bias),
                 wk=Linear(dim, n_kv * head_dim, bias=bias),
                 wv=Linear(dim, n_kv * head_dim, bias=bias),
                 wo=Linear(n_heads * head_dim, dim, bias=bias))
    if qk_norm:
        parts.update(q_norm=RMSNorm(n_heads * head_dim),
                     k_norm=RMSNorm(n_kv * head_dim))
    return holder(**parts)


# --------------------------------------------------------- acoustic head

class AcousticHead(nn.Module):
    """`acoustic_transformer` of the JAX tree (init_acoustic_head)."""

    def __init__(self, c: ModelConfig):
        super().__init__()
        d = c.acoustic_dim
        self.layers = nn.ModuleList(holder(
            attention_norm=RMSNorm(d), ffn_norm=RMSNorm(d),
            attention=_attn_holder(d, c.acoustic_n_heads,
                                   c.acoustic_n_kv_heads,
                                   c.acoustic_head_dim, c.use_biases, False),
            feed_forward=SwiGLU(d, c.acoustic_hidden_dim, c.use_biases))
            for _ in range(c.acoustic_n_layers))
        self.input_projection = Linear(c.n_acoustic_codebook, d, bias=False)
        self.llm_projection = Linear(c.dim, d, bias=False)
        self.time_projection = Linear(d, d, bias=False)
        self.semantic_codebook_output = Linear(d, c.semantic_padded,
                                               bias=False)
        self.acoustic_codebook_output = Linear(d, c.n_acoustic_codebook,
                                               bias=False)
        self.norm = RMSNorm(d)


def _time_embedding(t: torch.Tensor, dim: int,
                    theta: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    inv = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    emb = t.float()[:, None] * inv[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def acoustic_velocity(p: AcousticHead, c: ModelConfig, x_t: torch.Tensor,
                      t: torch.Tensor, llm_out: torch.Tensor
                      ) -> torch.Tensor:
    """(B, 36) noisy codes + (B,) t + (B, dim) LLM hidden -> (B, 36)."""
    b = x_t.shape[0]
    dt = p.norm.weight.dtype
    time_emb = p.time_projection(_time_embedding(t, c.acoustic_dim).to(dt))
    llm_emb = p.llm_projection(llm_out.to(dt))
    ac_emb = p.input_projection(x_t.to(dt))
    x = torch.stack([ac_emb, time_emb, llm_emb], dim=1)   # (B, 3, d)
    hd, nh, nkv = (c.acoustic_head_dim, c.acoustic_n_heads,
                   c.acoustic_n_kv_heads)
    for blk in p.layers:
        h = _rms(x, blk.attention_norm.weight, c.norm_eps)
        a = blk.attention
        q = a.wq(h).reshape(b, 3, nh, hd)
        k = a.wk(h).reshape(b, 3, nkv, hd)
        v = a.wv(h).reshape(b, 3, nkv, hd)
        x = x + a.wo(attention(q, k, v).reshape(b, 3, -1))
        h = _rms(x, blk.ffn_norm.weight, c.norm_eps)
        x = x + blk.feed_forward(h)
    x = _rms(x, p.norm.weight, c.norm_eps)
    return p.acoustic_codebook_output(x[:, 0])


def semantic_code(p: AcousticHead, c: ModelConfig,
                  h: torch.Tensor) -> torch.Tensor:
    """The semantic argmax of LLM hidden (B, dim) -> (B,) int64, with the
    padding past the codebook and its specials and row 0 masked."""
    lg = p.semantic_codebook_output(h).float()
    pad = torch.arange(c.semantic_padded, device=h.device) >= \
        c.semantic_codebook_size + N_SPECIAL
    lg = torch.where(pad, lg - 1e9, lg)
    lg[:, 0] -= 1e9
    return lg.argmax(dim=-1)


def acoustic_levels(p: AcousticHead, c: ModelConfig, h: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """The Euler integration of LLM hidden (B, dim) from `noise` (B, 36)
    -> the f32 state x before clipping and rounding."""
    b = h.shape[0]
    n = c.n_denoising_steps
    ts = [i / (n - 1) for i in range(n)]
    x = noise.float() * c.acoustic_sigma_max
    llm_pair = torch.cat([h, torch.zeros_like(h)], dim=0)
    for step in range(n - 1):
        t = torch.full((2 * b,), ts[step], dtype=torch.float32,
                       device=h.device)
        v_both = acoustic_velocity(p, c, x.repeat(2, 1), t,
                                   llm_pair).float()
        v = c.cfg_alpha * v_both[:b] + (1.0 - c.cfg_alpha) * v_both[b:]
        x = x + v * (ts[step + 1] - ts[step])
    return x


def acoustic_decode_frame(p: AcousticHead, c: ModelConfig, h: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """LLM hidden (B, dim) -> one frame of codes (B, 37), the +2
    special-token offset on the acoustic codes."""
    sem = semantic_code(p, c, h)
    x = torch.clamp(acoustic_levels(p, c, h, noise), -1.0, 1.0)
    ac = torch.clamp(torch.round((x + 1.0) * (c.acoustic_codebook_size - 1)
                                 / 2.0),
                     0, c.acoustic_codebook_size - 1).long() + N_SPECIAL
    return torch.cat([sem[:, None], ac], dim=-1)


# --------------------------------------------------------- codec decoder

def _alibi_slopes(n_heads: int) -> np.ndarray:
    def pow2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = pow2(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        s = pow2(closest) + pow2(2 * closest)[0::2][:n_heads - closest]
    return np.asarray(s, np.float32)


class AudioDecoder(nn.Module):
    """`audio_tokenizer` of the JAX tree (init_audio_decoder): the conv
    weights are raw leaves in torch's (out, in, K) layout, as the JAX tree
    holds them."""

    def __init__(self, c: ModelConfig):
        super().__init__()
        d = c.tokenizer_dim
        cb_dim = c.tokenizer_semantic_dim + c.tokenizer_acoustic_dim
        self.quantizer = holder(semantic_codebook=leaves(
            cluster_usage=(c.semantic_codebook_size,),
            embedding_sum=(c.semantic_codebook_size,
                           c.tokenizer_semantic_dim)))
        self.quantizer.semantic_codebook.init_fill = {"cluster_usage": 1.0}
        blocks = {}
        for i, (kernel, n_layers) in enumerate(zip(c.decoder_kernels,
                                                   c.decoder_tf_lengths)):
            in_ch = cb_dim if i == 0 else d
            blocks[str(2 * i)] = holder(conv=leaves(weight=(d, in_ch,
                                                           kernel)))
            blocks[str(2 * i + 1)] = holder(layers=nn.ModuleList(
                self._layer(c) for _ in range(n_layers)))
        self.decoder_blocks = holder(**blocks)
        self.output_proj = holder(conv=leaves(
            weight=(c.tokenizer_patch_size, d,
                    c.tokenizer_patch_proj_kernel_size)))

    @staticmethod
    def _layer(c: ModelConfig) -> nn.Module:
        d = c.tokenizer_dim
        m = holder(attention_norm=RMSNorm(d), ffn_norm=RMSNorm(d),
                   attention=_attn_holder(d, c.tokenizer_n_heads,
                                          c.tokenizer_n_kv_heads,
                                          c.tokenizer_head_dim, False, True),
                   feed_forward=SwiGLU(d, c.tokenizer_hidden_dim))
        m.attention_scale = nn.Parameter(torch.empty(d))
        m.ffn_scale = nn.Parameter(torch.empty(d))
        m.init_fill = {"attention_scale": c.tokenizer_layer_scale_init,
                       "ffn_scale": c.tokenizer_layer_scale_init}
        return m


def _reflect_index(t: int, left: int, right: int,
                   device) -> torch.Tensor:
    """numpy's `reflect` padding of t rows as a gather index, pads wider
    than the rows included (they reflect again, as `jnp.pad` does)."""
    i = torch.arange(-left, t + right, device=device)
    if t == 1:
        return torch.zeros_like(i)
    p = 2 * (t - 1)
    j = torch.remainder(i, p)
    return torch.where(j < t, j, p - j)


def _wn_conv1d(w: torch.Tensor, x: torch.Tensor, stride: int,
               pad_mode: str) -> torch.Tensor:
    """Causal conv on (B, T, C) with a torch-layout (out, in, K) weight."""
    kernel = w.shape[2]
    pad_total = kernel - stride
    n_frames = (x.shape[1] - kernel + pad_total) / stride + 1
    target = (math.ceil(n_frames) - 1) * stride + (kernel - pad_total)
    extra = max(0, target - x.shape[1])
    h = x.transpose(1, 2)
    if pad_mode == "constant":
        h = F.pad(h, (pad_total, extra))
    elif pad_mode == "reflect":
        h = h.index_select(2, _reflect_index(h.shape[2], pad_total, extra,
                                             h.device))
    else:
        h = F.pad(h, (pad_total, extra), mode=pad_mode)
    return F.conv1d(h, w.to(x.dtype), stride=stride).transpose(1, 2)


def _wn_conv_transpose1d(w: torch.Tensor, x: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """The JAX package's transposed conv of (B, T, C) by w (out, in, K),
    cut to T * stride rows: torch's conv_transpose1d of the (in, out, K)
    kernel."""
    t = x.shape[1]
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype).transpose(0, 1),
                           stride=stride)
    return y.transpose(1, 2)[:, :t * stride]


def _alibi_attention(a: nn.Module, c: ModelConfig, x: torch.Tensor,
                     slopes: torch.Tensor, window: int) -> torch.Tensor:
    b, t, _ = x.shape
    nh, nkv, hd = (c.tokenizer_n_heads, c.tokenizer_n_kv_heads,
                   c.tokenizer_head_dim)
    q = _rms(a.wq(x), a.q_norm.weight, 1e-6).reshape(b, t, nh, hd)
    k = _rms(a.wk(x), a.k_norm.weight, 1e-6).reshape(b, t, nkv, hd)
    v = a.wv(x).reshape(b, t, nkv, hd)
    pos = torch.arange(t, device=x.device)
    dist = (pos[None, :] - pos[:, None]).float()        # j - i
    bias = slopes[:, None, None] * dist[None]
    mask = torch.where(dist > 0, -1e9, 0.0)
    if window > 0:
        mask = mask + torch.where(dist < -window, -1e9, 0.0)
    o = attention(q, k, v, mask=(bias + mask)[None])
    return a.wo(o.reshape(b, t, -1))


def audio_decode(p: AudioDecoder, c: ModelConfig,
                 codes: torch.Tensor) -> torch.Tensor:
    """codes (B, T, 37) -> f32 waveform (B, T * samples_per_frame)."""
    dt = p.output_proj.conv.weight.dtype
    sem = codes[:, :, 0] - N_SPECIAL
    ac = codes[:, :, 1:] - N_SPECIAL
    cb = p.quantizer.semantic_codebook
    codebook = cb.embedding_sum.float() / torch.clamp(
        cb.cluster_usage.float()[:, None], min=1e-8)
    sem_emb = codebook[torch.clamp(sem, 0, c.semantic_codebook_size - 1)]
    ac_emb = 2.0 * ac.float() / (c.acoustic_codebook_size - 1) - 1.0
    x = torch.cat([sem_emb, ac_emb], dim=-1).to(dt)
    slopes = torch.from_numpy(_alibi_slopes(c.tokenizer_n_heads)).to(
        codes.device)
    windows = [2, 4, 8, 16]
    for i, (stride, n_layers) in enumerate(zip(c.decoder_strides,
                                               c.decoder_tf_lengths)):
        w = getattr(p.decoder_blocks, str(2 * i)).conv.weight
        if stride > 1:
            x = _wn_conv_transpose1d(w, x, stride)
        else:
            x = _wn_conv1d(w, x, stride, "replicate")
        win = windows[i] if i < len(windows) else 16
        for lp in getattr(p.decoder_blocks, str(2 * i + 1)).layers:
            h = _alibi_attention(
                lp.attention, c,
                _rms(x, lp.attention_norm.weight, c.tokenizer_norm_eps),
                slopes, win)
            x = x + h * lp.attention_scale.to(x.dtype)
            h = lp.feed_forward(_rms(x, lp.ffn_norm.weight,
                                     c.tokenizer_norm_eps))
            x = x + h * lp.ffn_scale.to(x.dtype)
    x = _wn_conv1d(p.output_proj.conv.weight, x, 1, "reflect")
    return x.reshape(x.shape[0], -1).float()


# ------------------------------------------------------------------ model

class Model(TorchModel):
    """Voxtral-4B-TTS on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    SANITIZE_GIVES_JAX_TREE = True

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        with torch.device(device):
            self.language_model = LlamaModel(config.llama_config,
                                             device=device, lm_head=False)
            self.audio_codebook_embeddings = holder(embeddings=Embedding(
                config.audio_embedding_size, config.dim))
            self.acoustic_transformer = AcousticHead(config)
            self.audio_tokenizer = AudioDecoder(config)
        self.requires_grad_(False)
        self.eval()
        self.tokenizer = None
        self._voice_embeddings = {}
        self._voice_embedding_files = {}
        self._text_to_audio_token_id = None
        self._audio_to_text_token_id = None
        self.last_run: dict = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @torch.no_grad()
    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        """Random weights (TorchModel.init_params), then the codec's raw
        leaves as init_audio_decoder draws them: each conv uniform
        +-1/sqrt(in * K), the semantic `embedding_sum` N(0, 0.02)."""
        super().init_params(seed, on_device)
        dec = self.audio_tokenizer
        raw = [m.conv.weight for m in dec.decoder_blocks.children()
               if hasattr(m, "conv")] + [dec.output_proj.conv.weight]
        g = torch.Generator(device=raw[0].device if on_device else "cpu")
        g.manual_seed(seed + 1)
        for w in raw:
            s = (w.shape[1] * w.shape[2]) ** -0.5
            w.copy_(torch.empty(w.shape, device=g.device).uniform_(
                -s, s, generator=g))
        e = dec.quantizer.semantic_codebook.embedding_sum
        e.copy_(torch.randn(e.shape, generator=g, device=g.device) * 0.02)
        return self

    # -------------------------------------------------------- sanitize

    def sanitize(self, weights):
        """A consolidated Mistral checkpoint -> the JAX tree: weight-norm
        pairs folded (norm over the (in, K) axes, in float64), the LM's
        Mistral names to llama's, the tied `output` dropped, the audio
        codebook table moved under `audio_codebook_embeddings`."""
        cfg = self.config
        out = {}
        wn_g = {k: v for k, v in weights.items()
                if k.endswith("parametrizations.weight.original0")}
        remap = {
            "attention.wq.weight": "self_attn.q_proj.weight",
            "attention.wk.weight": "self_attn.k_proj.weight",
            "attention.wv.weight": "self_attn.v_proj.weight",
            "attention.wo.weight": "self_attn.o_proj.weight",
            "feed_forward.w1.weight": "mlp.gate_proj.weight",
            "feed_forward.w2.weight": "mlp.down_proj.weight",
            "feed_forward.w3.weight": "mlp.up_proj.weight",
            "attention_norm.weight": "input_layernorm.weight",
            "ffn_norm.weight": "post_attention_layernorm.weight",
        }
        for k, v in weights.items():
            if k.endswith("parametrizations.weight.original0"):
                continue
            if k.endswith("parametrizations.weight.original1"):
                base = k[:-len(".parametrizations.weight.original1")]
                g = wn_g.get(base + ".parametrizations.weight.original0")
                vv = np.asarray(v, np.float64)
                folded = vv / np.sqrt((vv * vv).sum(axis=(1, 2),
                                                    keepdims=True) + 1e-12)
                if g is not None:
                    folded = folded * np.asarray(g, np.float64)
                out[base + ".weight"] = folded.astype(np.float32)
                continue
            v = np.asarray(v)
            if k in ("tok_embeddings.weight",
                     "mm_audio_embeddings.tok_embeddings.weight"):
                out["language_model.model.embed_tokens.weight"] = v
            elif k == "norm.weight":
                out["language_model.model.norm.weight"] = v
            elif k == "output.weight":
                if not cfg.tied_embeddings:
                    out["language_model.lm_head.weight"] = v
            elif k.startswith("mm_audio_embeddings."
                              "audio_codebook_embeddings."):
                out["audio_codebook_embeddings." + k.split(".", 2)[2]] = v
            else:
                m = re.match(r"layers\.(\d+)\.(.*)", k)
                if m:
                    idx, suffix = m.groups()
                    out[f"language_model.model.layers.{idx}."
                        f"{remap.get(suffix, suffix)}"] = v
                else:
                    out[k] = v
        return out

    # ---------------------------------------------------------- prompt

    def _get_voice_embedding(self, voice: str) -> Optional[np.ndarray]:
        emb = self._voice_embeddings.get(voice)
        if emb is not None:
            return emb
        f = self._voice_embedding_files.get(voice)
        if f is None:
            return None
        from safetensors import safe_open

        with safe_open(str(f), framework="np") as sf:
            names = list(sf.keys())
            emb = sf.get_tensor("embedding" if "embedding" in names
                                else names[0])
        emb = np.asarray(emb, np.float32)
        self._voice_embeddings[voice] = emb
        return emb

    def _encode_text(self, text: str, voice: str) -> List[int]:
        text = sanitize_tts_input_text_for_demo(text)
        if self.tokenizer is None:
            raise RuntimeError(
                "Tokenizer not loaded: Voxtral TTS needs a Mistral speech "
                "tokenizer (mistral-common[audio] and the directory's "
                "tekken.json) or a tokenizer with encode_speech(text, "
                "voice)")
        if hasattr(self.tokenizer, "encode_speech_request"):
            from mistral_common.protocol.speech.request import \
                SpeechRequest

            req = SpeechRequest(input=text, voice=voice)
            return list(self.tokenizer.encode_speech_request(req).tokens)
        if hasattr(self.tokenizer, "encode_speech"):
            return list(self.tokenizer.encode_speech(text, voice))
        raise RuntimeError(
            "Voxtral TTS requires a Mistral speech tokenizer "
            "(mistral-common[audio]) or a tokenizer with "
            "encode_speech(text, voice) to build the prompt")

    @torch.inference_mode()
    def _build_input_embeddings(self, ids, voice: str) -> torch.Tensor:
        """ids (T,) -> (1, T, dim) on the device, the voice embedding's
        rows at the AUDIO token positions."""
        ids_t = torch.as_tensor(np.asarray(ids, np.int64),
                                device=self.device)
        emb = self.language_model.model.embed_tokens(ids_t[None])
        voice_emb = self._get_voice_embedding(voice)
        if voice_emb is None:
            return emb
        pos = torch.nonzero(ids_t == self.config.audio_token_id)[:, 0]
        take = min(len(pos), voice_emb.shape[0])
        emb = emb.clone()
        emb[0, pos[:take]] = torch.as_tensor(
            voice_emb[:take], device=self.device).to(emb.dtype)
        return emb

    # ------------------------------------------------------------ decode

    def _global_offsets(self) -> np.ndarray:
        cfg = self.config
        sem_size = cfg.semantic_codebook_size + N_SPECIAL
        ac_size = cfg.acoustic_codebook_size + N_SPECIAL
        return np.asarray(
            [0] + [sem_size + i * ac_size
                   for i in range(cfg.n_acoustic_codebook)], np.int32)

    def _draws(self, generator: torch.Generator) -> torch.Tensor:
        """One frame's noise (1, n_acoustic_codebook), f32, N(0, 1)."""
        return torch.randn((1, self.config.n_acoustic_codebook),
                           generator=generator, device=self.device)

    def _lm_step(self, embeds: torch.Tensor, caches: KVCache,
                 offset: int) -> torch.Tensor:
        """One LM step over embeds (1, 1, dim) at the host int `offset`,
        against the cache columns written so far -> hidden (1, dim)."""
        used = offset + 1
        view = KVCache(caches.k[:, :, :used], caches.v[:, :, :used])
        hidden, _ = llama_forward(self.language_model, embeds, caches=view,
                                  offset=offset)
        return hidden[:, -1]

    @torch.inference_mode()
    def start(self, embeds: torch.Tensor, max_tokens: int,
              seed: int = 0) -> dict:
        """The prefill over the prompt embeds (1, T, dim) and the AUDIO
        token's step -> the state a chunk advances."""
        cfg = self.config
        lm = self.language_model
        plen = embeds.shape[1]
        caches = init_caches(cfg.llama_config, 1, plen + 1 + max_tokens,
                             dtype=embeds.dtype, device=self.device)
        llama_forward(lm, embeds, caches=KVCache(
            caches.k[:, :, :plen], caches.v[:, :, :plen]), offset=0)
        tok = lm.model.embed_tokens(torch.full(
            (1, 1), cfg.audio_token_id, dtype=torch.long,
            device=self.device))
        h = self._lm_step(tok, caches, plen)
        return {"caches": caches, "offset": plen + 1, "h": h,
                "done": torch.zeros((), dtype=torch.bool,
                                    device=self.device),
                "frames": 0, "max_tokens": max_tokens,
                "offsets": torch.as_tensor(self._global_offsets(),
                                           dtype=torch.long,
                                           device=self.device),
                "generator": torch.Generator(device=self.device)
                .manual_seed(int(seed))}

    @torch.inference_mode()
    def chunk(self, state: dict, n_frames: int = DEC_CHUNK):
        """Up to n_frames frames from `state` (advanced in place) -> (the
        kept frames (k, 37) int64 numpy, whether the request stopped)."""
        cfg = self.config
        p = self.acoustic_transformer
        table = self.audio_codebook_embeddings.embeddings
        n = min(n_frames, state["max_tokens"] - state["frames"])
        codes_l, valid_l = [], []
        for i in range(n):
            codes = acoustic_decode_frame(p, cfg, state["h"],
                                          self._draws(state["generator"]))
            state["done"] = state["done"] | (codes[0, 0] <= 1)
            codes_l.append(codes[0])
            valid_l.append(~state["done"])
            state["frames"] += 1
            if state["frames"] < state["max_tokens"]:
                emb = table(codes + state["offsets"][None]).sum(
                    dim=1, keepdim=True)
                state["h"] = self._lm_step(emb, state["caches"],
                                           state["offset"])
                state["offset"] += 1
        if not codes_l:
            return np.zeros((0, cfg.num_codebooks), np.int64), True
        read = torch.cat([torch.stack(codes_l),
                          torch.stack(valid_l).long()[:, None]], dim=1)
        read = read.cpu().numpy()
        kept = read[read[:, -1] > 0, :-1]
        stopped = not bool(read[-1, -1]) or \
            state["frames"] >= state["max_tokens"]
        return kept, stopped

    @torch.inference_mode()
    def decode_audio_codes(self, codes: np.ndarray) -> np.ndarray:
        """codes (T, 37) -> f32 waveform (T * samples_per_frame,)."""
        c = torch.as_tensor(np.asarray(codes, np.int64),
                            device=self.device)[None]
        return audio_decode(self.audio_tokenizer, self.config,
                            c)[0].cpu().numpy()

    # ---------------------------------------------------------- generate

    def generate(self, text: str, voice: str = "casual_male",
                 max_tokens: int = 4096, stream: bool = False,
                 streaming_interval: float = 2.0, seed: int = 0, **kwargs
                 ) -> Generator[GenerationResult, None, None]:
        cfg = self.config
        t0 = time.perf_counter()
        ids = np.asarray(self._encode_text(text, voice), np.int64)
        embeds = self._build_input_embeddings(ids, voice)
        state = self.start(embeds, max_tokens, seed)
        frames: List[np.ndarray] = []
        yielded = 0
        chunk_idx = 0
        frames_per_chunk = max(1, int(streaming_interval / 0.08))
        spf = cfg.samples_per_frame
        run = {"prompt_len": int(embeds.shape[1]), "chunks": 0,
               "chunk_ms": []}
        t_last = time.perf_counter()
        while True:
            kept, stopped = self.chunk(state)
            now = time.perf_counter()
            run["chunk_ms"].append((now - t_last) * 1e3)
            t_last = now
            run["chunks"] += 1
            frames.extend(kept)
            if stream and len(frames) - yielded >= frames_per_chunk:
                ctx = max(0, yielded - CONTEXT_FRAMES)
                wav = self.decode_audio_codes(np.stack(frames[ctx:]))
                wav = wav[(yielded - ctx) * spf:]
                dt = max(time.perf_counter() - t0, 1e-6)
                dur = len(wav) / cfg.sample_rate
                yield GenerationResult(
                    audio=wav, samples=len(wav),
                    sample_rate=cfg.sample_rate, segment_idx=chunk_idx,
                    token_count=len(frames) - yielded,
                    audio_duration=format_duration(dur),
                    real_time_factor=round(dur / dt, 3),
                    prompt={"tokens": len(frames) - yielded,
                            "tokens-per-sec": round(
                                (len(frames) - yielded) / dt, 2)},
                    audio_samples={"samples": len(wav),
                                   "samples-per-sec": cfg.sample_rate},
                    processing_time_seconds=dt,
                    peak_memory_usage=peak_memory_gb(),
                    is_streaming_chunk=True, is_final_chunk=False)
                yielded = len(frames)
                chunk_idx += 1
                t0 = time.perf_counter()
            if stopped:
                break
        run.update(frames_run=state["frames"], frames=len(frames))
        self.last_run = run
        if not frames:
            raise RuntimeError("No audio frames generated")
        remaining = len(frames) - yielded
        if stream and yielded > 0 and remaining > 0:
            ctx = max(0, yielded - CONTEXT_FRAMES)
            wav = self.decode_audio_codes(np.stack(frames[ctx:]))
            wav = wav[(yielded - ctx) * spf:]
        elif stream and yielded > 0:
            wav = np.zeros((0,), np.float32)
        else:
            wav = self.decode_audio_codes(np.stack(frames))
        dt = max(time.perf_counter() - t0, 1e-6)
        dur = len(wav) / cfg.sample_rate
        count = remaining if stream and yielded > 0 else len(frames)
        yield GenerationResult(
            audio=wav, samples=len(wav), sample_rate=cfg.sample_rate,
            segment_idx=chunk_idx if stream else 0, token_count=count,
            audio_duration=format_duration(dur),
            real_time_factor=round(dur / dt, 3),
            prompt={"tokens": count,
                    "tokens-per-sec": round(count / dt, 2)},
            audio_samples={"samples": len(wav),
                           "samples-per-sec": cfg.sample_rate},
            processing_time_seconds=dt,
            peak_memory_usage=peak_memory_gb(),
            is_streaming_chunk=stream, is_final_chunk=stream)

    # ---------------------------------------------------------- loading

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's `tekken.json` (its special ids; a file that
        fails to parse raises) and, with `mistral_common` installed, its
        Mistral tokenizer; without a tekken file the directory's HF
        tokenizer (`local_tokenizer`); the `voice_embedding/*.safetensors`
        files by voice name."""
        import json

        model_path = Path(model_path)
        tekken = model_path / "tekken.json"
        if tekken.is_file():
            data = json.loads(tekken.read_text())
            specials = {i["token_str"]: i["rank"]
                        for i in data.get("special_tokens", [])
                        if "token_str" in i and "rank" in i}
            model._text_to_audio_token_id = specials.get("[NEXT_AUDIO_TEXT]")
            model._audio_to_text_token_id = specials.get(
                "[REPEAT_AUDIO_TEXT]")
            try:
                from mistral_common.tokens.tokenizers.mistral import \
                    MistralTokenizer
            except ImportError:
                MistralTokenizer = None
            if MistralTokenizer is not None:
                model.tokenizer = MistralTokenizer.from_file(str(tekken))
        else:
            model.tokenizer = local_tokenizer(model_path)
        voice_dir = model_path / "voice_embedding"
        if voice_dir.exists():
            for f in voice_dir.glob("*.safetensors"):
                model._voice_embedding_files[f.stem] = f
        return model


__all__ = ["Model", "ModelConfig", "VOICE_MAP", "DEC_CHUNK",
           "acoustic_decode_frame", "acoustic_levels", "semantic_code",
           "acoustic_velocity", "audio_decode",
           "sanitize_tts_input_text_for_demo"]
