"""Granite Speech: a conformer CTC encoder, a Q-Former projector and a
Granite LM on the llama backbone.

Counterpart of mlx_audio_tpu/stt/models/granite_speech/granite_speech.py:

* the configs (`EncoderConfig`, `ProjectorConfig`, `ModelConfig`,
  :83-125); the LM's Granite multipliers are the llama config's;
* the conformer encoder (`encoder_forward`, :189-293): half-step FFNs,
  block-local attention with Shaw relative positions (`block_attention`,
  :214-239: padded key columns take -1e9, not -inf, so a block of padding
  alone is a uniform softmax, not NaN; distances clamped to
  +-context_size), the conv module with its batch norm (:241-260), and
  the mid-layer CTC head's softmax fed back at half depth (:287-290);
* the Q-former projector over windows of `window_size` frames
  (`projector_forward`, :296-335);
* the features (`_extract_features`, :357-383: a 400-sample periodic Hann
  centred in a 512-point STFT, an HTK mel, log10 normalised, two frames
  stacked into one row), the splice and the prompt (:384-443), `generate`
  and its token-at-a-time stream (:444-611), `sanitize` and
  `post_load_hook` (:612-642).

Departures (besides `llm_stt`'s):

* the encoder runs the features' own frames, not a bucket of them (a TPU
  workaround): the block attention pads its last block to `context_size`
  rows and masks their keys, the conv module sees the unpadded run's zero
  padding, as JAX's masked bucket does, so the valid rows agree;
* the stream decodes greedily in chunks of DEC_CHUNK steps with one read
  a chunk, then yields each token, where JAX's yields a token a step; its
  caches grow with the decode (JAX's hold bucket + 1 columns, so a stream
  past its prompt bucket overwrites the last one);
* `sanitize` reads each conv weight's layout (torch, MLX or WIO) from the
  model's own shapes, where JAX's transposes every 3-D conv weight unless
  the checkpoint holds quantization scales;
* `post_load_hook` reads only the model directory's tokenizer files and
  raises when they fail to load, where JAX's swallows any error.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....dsp import hanning, mel_filters, spec_abs, stft
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import BatchNorm, Conv1d, Embedding, LayerNorm, Linear, gelu
from ....ops.attention import attention
from ....tts.models.base import local_tokenizer
from ....tts.models.llama.llama import Model as LlamaLM
from ....tts.models.llama.llama import ModelConfig as LlamaConfig
from ...models.base import STTOutput
from ..llm_stt import (GREEDY, as_audio, decode_fns, decode_tokens,
                       sampling_knobs, splice_embeds)
from ..qwen3_asr.qwen3_asr import StreamingResult
from ..qwen3_lm import iter_decode

LANGUAGE_CODES = {
    "en": "English", "fr": "French", "de": "German", "es": "Spanish",
    "pt": "Portuguese", "ja": "Japanese",
}


@dataclass
class EncoderConfig(BaseModelArgs):
    input_dim: int = 160
    num_layers: int = 10
    hidden_dim: int = 1024
    feedforward_mult: int = 4
    num_heads: int = 8
    dim_head: int = 128
    output_dim: int = 42
    context_size: int = 200
    max_pos_emb: int = 512
    conv_kernel_size: int = 15
    conv_expansion_factor: int = 2


@dataclass
class ProjectorConfig(BaseModelArgs):
    hidden_size: int = 1024
    num_hidden_layers: int = 2
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-12
    encoder_hidden_size: int = 1024


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "granite_speech"
    encoder_config: Optional[dict] = None
    projector_config: Optional[dict] = None
    text_config: Optional[dict] = None
    audio_token_index: int = 100352
    downsample_rate: int = 5
    window_size: int = 15
    has_lora_adapter: bool = False
    model_path: str = ""

    def __post_init__(self):
        self.enc = EncoderConfig.from_dict(self.encoder_config or {})
        self.proj = ProjectorConfig.from_dict(self.projector_config or {})
        self.text = LlamaConfig.from_dict(self.text_config or {})


# ------------------------------------------------------------------- tree


def _ff(e: EncoderConfig) -> nn.Module:
    return holder(pre_norm=LayerNorm(e.hidden_dim),
                  up_proj=Linear(e.hidden_dim,
                                 e.hidden_dim * e.feedforward_mult),
                  down_proj=Linear(e.hidden_dim * e.feedforward_mult,
                                   e.hidden_dim))


def _conformer_layer(e: EncoderConfig) -> nn.Module:
    dm, inner = e.hidden_dim, e.dim_head * e.num_heads
    cdim = e.hidden_dim * e.conv_expansion_factor
    return holder(
        ff1=_ff(e),
        attn=holder(pre_norm=LayerNorm(dm),
                    to_q=Linear(dm, inner, bias=False),
                    to_kv=Linear(dm, inner * 2, bias=False),
                    to_out=Linear(inner, dm),
                    rel_pos_emb=Embedding(2 * e.max_pos_emb + 1, e.dim_head)),
        conv=holder(norm=LayerNorm(dm), up_conv=Conv1d(dm, cdim * 2, 1),
                    depth_conv=holder(conv=Conv1d(
                        cdim, cdim, e.conv_kernel_size, bias=False,
                        groups=cdim)),
                    batch_norm=BatchNorm(cdim),
                    down_conv=Conv1d(cdim, dm, 1)),
        ff2=_ff(e), post_norm=LayerNorm(dm))


def _qattn(hidden: int, kv_dim: int) -> nn.Module:
    return holder(
        attention=holder(query=Linear(hidden, hidden),
                         key=Linear(kv_dim, hidden),
                         value=Linear(kv_dim, hidden)),
        output=holder(dense=Linear(hidden, hidden),
                      LayerNorm=LayerNorm(hidden, 1e-12)))


class Projector(nn.Module):
    """The Q-former projector's tree: the learned `query` (zeros at init),
    `qformer.layernorm`, `qformer.encoder.layer.N`, `linear`."""

    init_fill = {"query": 0.0}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        pj = cfg.proj
        h = pj.hidden_size
        nq = cfg.window_size // cfg.downsample_rate
        self.query = nn.Parameter(torch.empty(1, nq, h))
        self.qformer = holder(
            layernorm=LayerNorm(h, 1e-12),
            encoder=holder(layer=nn.ModuleList(holder(
                attention=_qattn(h, h),
                crossattention=_qattn(h, pj.encoder_hidden_size),
                intermediate_query=holder(dense=Linear(h, pj.intermediate_size)),
                output_query=holder(dense=Linear(pj.intermediate_size, h),
                                    LayerNorm=LayerNorm(h, 1e-12)))
                for _ in range(pj.num_hidden_layers))))
        self.linear = Linear(h, cfg.text.hidden_size)


# ---------------------------------------------------------------- encoder


def _ff_forward(p, x: torch.Tensor) -> torch.Tensor:
    return p.down_proj(F.silu(p.up_proj(p.pre_norm(x))))


def block_attention(p, e: EncoderConfig, x: torch.Tensor,
                    n_valid: Optional[int] = None) -> torch.Tensor:
    """Block-local attention with Shaw relative positions inside blocks of
    `context_size` rows: x (B, N, D), its rows past `n_valid` (default N)
    padding; the last block is padded to `context_size` rows and every
    padded key column takes -1e9 (a block of padding alone gets a uniform
    softmax). -> (B, N, D)."""
    b, n, _ = x.shape
    c, h, dh = e.context_size, e.num_heads, e.dim_head
    n_valid = n if n_valid is None else n_valid
    nb = -(-n // c)
    xn = p.pre_norm(x)
    q = p.to_q(xn)
    k, v = p.to_kv(xn).chunk(2, dim=-1)
    pad = nb * c - n
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    q, k, v = (t.reshape(b, nb, c, h, dh).transpose(2, 3) for t in (q, k, v))
    pos = torch.arange(c, device=x.device)
    dists = (pos[:, None] - pos[None, :]).clamp(-c, c) + e.max_pos_emb
    rel = p.rel_pos_emb.weight[dists].to(q.dtype)          # (C, C, dh)
    scale = dh ** -0.5
    pos_attn = torch.einsum("bnhcd,ckd->bnhck", q, rel) * scale
    scores = (q @ k.transpose(-1, -2)) * scale + pos_attn
    valid = (torch.arange(nb * c, device=x.device) < n_valid).reshape(nb, c)
    add = torch.where(valid, 0.0, -1e9).to(scores.dtype)
    w = torch.softmax((scores + add[None, :, None, None, :]).float(),
                      dim=-1).to(x.dtype)
    o = (w @ v).transpose(2, 3).reshape(b, nb * c, h * dh)[:, :n]
    return p.to_out(o)


def _conv_module(p, e: EncoderConfig, x: torch.Tensor) -> torch.Tensor:
    h = p.up_conv(p.norm(x))
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)
    ksz = e.conv_kernel_size
    pad = ksz // 2
    h = p.depth_conv.conv(h, padding=(pad, pad - (ksz + 1) % 2))
    return p.down_conv(F.silu(p.batch_norm(h)))


def encoder_forward(enc, e: EncoderConfig,
                    feats: torch.Tensor) -> torch.Tensor:
    """(B, N, input_dim) stacked features -> (B, N, hidden_dim), any N."""
    x = enc.input_linear(feats)
    for idx, lp in enumerate(enc.layers, 1):
        x = 0.5 * _ff_forward(lp.ff1, x) + x
        x = block_attention(lp.attn, e, x) + x
        x = _conv_module(lp.conv, e, x) + x
        x = 0.5 * _ff_forward(lp.ff2, x) + x
        x = lp.post_norm(x)
        if idx == e.num_layers // 2:
            mid = torch.softmax(enc.out(x).float(), dim=-1).to(x.dtype)
            x = x + enc.out_mid(mid)
    return x


def _qformer_attention(p, x: torch.Tensor, kv: torch.Tensor,
                       heads: int) -> torch.Tensor:
    a = p.attention
    b, n, d = x.shape
    dh = d // heads
    q = a.query(x).reshape(b, n, heads, dh)
    k = a.key(kv).reshape(b, -1, heads, dh)
    v = a.value(kv).reshape(b, -1, heads, dh)
    o = p.output.dense(attention(q, k, v).reshape(b, n, d))
    return p.output.LayerNorm(o + x)


def projector_forward(proj: Projector, cfg: ModelConfig,
                      enc_out: torch.Tensor) -> torch.Tensor:
    """(B, L, D) encoder rows, L a multiple of window_size ->
    (B, L / window_size x num_queries, lm_hidden)."""
    pj = cfg.proj
    b, n, d = enc_out.shape
    w = cfg.window_size
    nblocks = n // w
    nq = w // cfg.downsample_rate
    windows = enc_out.reshape(b * nblocks, w, d)
    x = proj.query.to(enc_out.dtype).expand(b * nblocks, nq, pj.hidden_size)
    x = proj.qformer.layernorm(x)
    for lp in proj.qformer.encoder.layer:
        x = _qformer_attention(lp.attention, x, x, pj.num_attention_heads)
        x = _qformer_attention(lp.crossattention, x, windows,
                               pj.num_attention_heads)
        h = lp.output_query.dense(gelu(lp.intermediate_query.dense(x)))
        x = lp.output_query.LayerNorm(h + x)
    return proj.linear(x.reshape(b, nblocks * nq, pj.hidden_size))


# ------------------------------------------------------------------ model


class Model(TorchModel):
    """Granite Speech on `device`: the card by default; without CUDA the
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
        e = config.enc
        with torch.device(device):
            self.encoder = holder(
                input_linear=Linear(e.input_dim, e.hidden_dim),
                layers=nn.ModuleList(_conformer_layer(e)
                                     for _ in range(e.num_layers)),
                out=Linear(e.hidden_dim, e.output_dim),
                out_mid=Linear(e.output_dim, e.hidden_dim))
            self.projector = Projector(config)
        self.language_model = LlamaLM(config.text, device=device)
        self._tokenizer = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return 16000

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.model.norm.weight.dtype

    # ------------------------------------------------------------ features

    def _extract_features(self, audio) -> Tuple[torch.Tensor, int]:
        """Audio -> ((T, 2 n_mels) stacked log-mel on the model's device,
        num_audio_tokens)."""
        wav = torch.as_tensor(np.asarray(audio, np.float32).reshape(-1))
        n_fft, win_length, hop = 512, 400, 160
        n_mels = self.config.enc.input_dim // 2
        pad_l = (n_fft - win_length) // 2
        win = F.pad(hanning(win_length, periodic=True),
                    (pad_l, n_fft - win_length - pad_l))
        spec = stft(wav.to(self.device), n_fft=n_fft, hop_length=hop,
                    window=win, center=True, pad_mode="reflect")
        power = spec_abs(spec) ** 2
        fb = mel_filters(16000, n_fft, n_mels, mel_scale="htk").to(
            power.device)
        logmel = torch.log10(torch.clamp(power @ fb.T, min=1e-10))
        logmel = torch.maximum(logmel, logmel.max() - 8.0) / 4.0 + 1.0
        if logmel.shape[0] % 2 == 1:
            logmel = logmel[:-1]
        feats = logmel.reshape(-1, 2 * n_mels)
        nblocks = math.ceil(feats.shape[0] / self.config.window_size)
        nq = self.config.window_size // self.config.downsample_rate
        return feats, nblocks * nq

    @torch.inference_mode()
    def get_audio_features(self, feats) -> torch.Tensor:
        """(T, input_dim) -> (num_audio_tokens, lm_hidden): the encoder on
        the T rows, zero rows up to whole windows, the projector."""
        cfg = self.config
        feats = torch.as_tensor(feats).to(self.device, self.dtype)
        t = feats.shape[0]
        enc = encoder_forward(self.encoder, cfg.enc, feats[None])
        enc = F.pad(enc, (0, 0, 0, (-t) % cfg.window_size))
        return projector_forward(self.projector, cfg, enc)[0]

    # -------------------------------------------------------------- prompt

    def _build_prompt_ids(self, n_audio: int,
                          prompt: Optional[str]) -> List[int]:
        user_prompt = prompt or \
            "can you transcribe the speech into a written format?"
        content = "<|audio|>" * n_audio + user_prompt
        tok = self._tokenizer
        if tok is not None and getattr(tok, "chat_template", None):
            text = tok.apply_chat_template(
                [{"role": "user", "content": content}], tokenize=False,
                add_generation_prompt=True)
            return list(tok.encode(text))
        if tok is not None:
            return list(tok.encode(f"USER: {content}\nASSISTANT:"))
        return [self.config.audio_token_index] * n_audio

    def _eos_ids(self) -> Tuple[int, ...]:
        tok = self._tokenizer
        if tok is not None and tok.eos_token_id is not None:
            return (int(tok.eos_token_id),)
        return (0,)

    def _prepare(self, audio, prompt) -> Tuple[List[int], torch.Tensor]:
        t0 = time.perf_counter()
        feats, n_audio = self._extract_features(as_audio(audio, 16000))
        audio_feats = self.get_audio_features(feats)
        ids = self._build_prompt_ids(n_audio, prompt)
        with torch.inference_mode():
            embeds = splice_embeds(self.language_model, ids, audio_feats,
                                   audio_id=self.config.audio_token_index)
        self.last_run = {"audio_tokens": n_audio,
                         "encode_ms": (time.perf_counter() - t0) * 1e3}
        return ids, embeds

    def _text(self, toks: List[int]) -> str:
        if self._tokenizer is None:
            return " ".join(map(str, toks))
        return self._tokenizer.decode(toks, skip_special_tokens=True)

    # -------------------------------------------------------------- decode

    def generate(self, audio, *, max_tokens: int = 448,
                 prompt: Optional[str] = None,
                 language: Optional[str] = None, stream: bool = False,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1, seed: int = 0,
                 verbose: bool = False, **kwargs
                 ) -> Union[STTOutput, Generator]:
        if prompt is None and language is not None:
            name = LANGUAGE_CODES.get(language.lower(), language)
            prompt = f"Translate the speech to {name}."
        if stream:
            return self._stream_generate(audio, prompt=prompt,
                                         max_tokens=max_tokens)
        t0 = time.time()
        ids, embeds = self._prepare(audio, prompt)
        n = len(ids)
        fns = decode_fns(self.language_model, n, max_tokens, sampling_knobs(
            temperature, top_k, top_p, min_p, repetition_penalty,
            repetition_context_size, min_tokens_to_keep), self._eos_ids())
        generated = decode_tokens(iter_decode(
            fns, embeds, n, max_tokens=max_tokens, seed=seed,
            run=self.last_run))
        text = self._text(generated)
        dt = time.time() - t0
        if verbose:
            print(text)
        return STTOutput(
            text=text, segments=[], prompt_tokens=n,
            generation_tokens=len(generated),
            total_tokens=n + len(generated), total_time=round(dt, 3),
            prompt_tps=n / dt if dt else 0.0,
            generation_tps=len(generated) / dt if dt else 0.0)

    __call__ = generate

    def _stream_generate(self, audio, *, prompt=None, max_tokens=448
                         ) -> Generator[StreamingResult, None, None]:
        """Greedy tokens, each as a result with its text, then a final
        marker."""
        ids, embeds = self._prepare(audio, prompt)
        n = len(ids)
        fns = decode_fns(self.language_model, n, max_tokens, GREEDY,
                         self._eos_ids())
        count = 0
        for new in iter_decode(fns, embeds, n, max_tokens=max_tokens,
                               run=self.last_run):
            for tok in new:
                count += 1
                yield StreamingResult(text=self._text([tok]),
                                      is_final=False, start_time=0.0,
                                      end_time=0.0, prompt_tokens=n,
                                      generation_tokens=count)
        yield StreamingResult(text="", is_final=True, start_time=0.0,
                              end_time=0.0, prompt_tokens=n,
                              generation_tokens=count)

    # ------------------------------------------------------------- loading

    def model_quant_predicate(self, path: str, leaf) -> bool:
        return path.startswith("language_model")

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """Batch-norm step counters and RoPE tables dropped; conv weights
        to WIO from the layout their shapes show."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if "num_batches_tracked" in k or k.endswith(
                    "rotary_emb.inv_freq"):
                continue
            out[k] = v if isinstance(v, np.ndarray) else np.asarray(v)
        return convs_to_wio(out, shapes, lambda k, v: v.ndim == 3
                            and k.endswith("weight") and any(
                                s in k for s in ("up_conv", "down_conv",
                                                 "depth_conv")))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path),
                                           trust_remote_code=True)
        return model


__all__ = ["Model", "ModelConfig", "EncoderConfig", "ProjectorConfig",
           "StreamingResult", "encoder_forward", "projector_forward",
           "block_attention", "LANGUAGE_CODES"]
