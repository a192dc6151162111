"""Moshi: a full-duplex speech-to-speech LM over Mimi codes.

Counterpart of mlx_audio_tpu/sts/models/moshi/moshi.py:

* the configs (`TransformerDims`, `DepFormerDims`, `LmConfig` with the raw
  kyutai schema, :60-190) and both presets, `config_v0_1` (Moshiko /
  Moshika 7B) and `config1b_202412`;
* `ScaledEmbedding` (`apply_scaled_embedding`, :226-245): index -1 gives
  exact zeros, an optional low-rank factor, the optional second-stream
  demux;
* `Block` (`_block_forward`, :289-333): RMSNorm at eps 1e-8 (or LayerNorm),
  interleaved RoPE (kyutai's `traditional=True`), a causal window of
  `context` previous keys plus the current one, the gating MLP (hidden
  11d/4 when the feed-forward is 4d, else 2ff/3);
* `Lm` (:334-535): the temporal transformer over the summed text and 16
  audio-stream embeddings, `forward_text`, `sample_step` (the depformer
  over its slices, each slice its own weights, on a fresh
  `num_slices + 2`-column cache, each slice's draw feeding the next),
  `depformer_logits` (teacher-forced) and `_sample` (greedy at
  temperature 0, else top-p 0.95);
* `LmGen` (:538-631): the host ring of generated tokens, the per-codebook
  delays, the other speaker's codes fed in, the undelayed own frames;
* `Model` (:633-720): Mimi encode -> the step loop -> Mimi decode over a
  bound Mimi (`model.mimi`, a codec.models.mimi.Mimi); without one,
  `generate` raises as JAX's does;
* `sanitize_lm` (:736-867) for the kyutai MLX, kyutai PyTorch and HF
  transformers layouts (HF's half-split RoPE q/k un-permuted to
  interleaved, `_unpermute_hf_rope` :727).

On the card a step is eager PyTorch: the main stack, then the depformer's
slices, with the sampled tokens staying on the device from slice to slice;
the host reads the step's text token and own codes once, as JAX's `LmGen`
does. The main KV cache is JAX's: f32, max(max_steps, context + 1) columns,
written at the host step index; a step attends only to the columns its
window keeps (context previous keys and its own), read as a slice. Under
affine quantization (`utils.apply_quantization`) every linear of the main
stack and of the depformer, each slice's `linear_in` and `linear_out`, and
`text_linear` becomes a `QuantizedLinear` (kernel K2 on the card); the
embedding tables stay dense.

Departures from the JAX package:

* quantization keeps the tables dense (`Embedding` modules are never
  quantized). JAX's default tree rule (`maybe_quantize_tree`) quantizes
  `text_emb`, `audio_embs.N` and `depformer.slices.S.emb`, whose names it
  does not take for tables, and `apply_scaled_embedding` then fails on the
  missing `weight`: no quantized Moshi runs there
  (tests/test_torch_moshi.py::test_quantization_keeps_the_tables_dense);
* a bf16 model computes in bf16 against its f32 caches (attention in
  f32), where JAX promotes the residual stream to f32;
* draws come from a torch.Generator, so only greedy runs compare with JAX;
* `Model.generate` fills `processing_time_seconds`, `real_time_factor`,
  the peak memory and `model.last_run` (steps, ms a step), which JAX
  leaves at 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....codec.models.mimi.mimi import LayerScale
from ....model import TorchModel, check_device, holder
from ....nn import Embedding, LayerNorm, Linear, RMSNorm
from ....nn.layers import gelu
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import apply_rotary_interleaved, rope_cis, rope_freqs
from ....ops.sampling import sample

MAX_STEPS = 2048
TOP_P = 0.95


@dataclass
class TransformerDims:
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 8
    dim_feedforward: int = 2048
    context: int = 750
    max_period: float = 10000.0
    gating: bool = True
    norm: str = "rms_norm"  # "rms_norm" (eps 1e-8) | "layer_norm" (eps 1e-5)
    positional_embedding: str = "rope"  # "rope" (interleaved) | "none"
    layer_scale: Optional[float] = None
    bias_ff: bool = False
    bias_attn: bool = False
    hidden: Optional[int] = None  # gating MLP hidden; None -> kyutai rule

    @property
    def gating_hidden(self) -> int:
        if self.hidden is not None:
            return self.hidden
        if self.dim_feedforward == 4 * self.d_model:
            return 11 * self.d_model // 4
        return 2 * self.dim_feedforward // 3


@dataclass
class DepFormerDims:
    d_model: int = 256
    num_heads: int = 8
    num_layers: int = 4
    dim_feedforward: int = 1024
    num_slices: int = 8
    context: Optional[int] = None  # None -> num_slices
    max_period: float = 10000.0
    positional_embedding: str = "none"
    weights_per_step_schedule: Optional[List[int]] = None
    low_rank_embeddings: Optional[int] = None
    hidden: Optional[int] = None


@dataclass
class LmConfig(BaseModelArgs):
    model_type: str = "moshi"
    transformer: TransformerDims = field(default_factory=TransformerDims)
    depformer: DepFormerDims = field(default_factory=DepFormerDims)
    text_in_vocab_size: int = 32001
    text_out_vocab_size: int = 32000
    audio_vocab_size: int = 2049
    audio_codebooks: int = 16
    audio_delays: List[int] = field(default_factory=lambda: [0] + [1] * 7
                                    + [0] + [1] * 7)
    demux_second_stream: bool = False
    extra_heads_num_heads: int = 0
    extra_heads_dim: int = 6
    sample_rate: int = 24000
    model_path: str = ""

    def __post_init__(self):
        if isinstance(self.transformer, dict):
            self.transformer = TransformerDims(**{
                k: v for k, v in self.transformer.items()
                if k in TransformerDims.__dataclass_fields__})
        if isinstance(self.depformer, dict):
            self.depformer = DepFormerDims(**{
                k: v for k, v in self.depformer.items()
                if k in DepFormerDims.__dataclass_fields__})

    @classmethod
    def from_dict(cls, d: dict) -> "LmConfig":
        if "dim" in d and "transformer" not in d:
            return cls.from_config_dict(d)
        return super().from_dict(d)

    @classmethod
    def from_config_dict(cls, data: dict) -> "LmConfig":
        """The raw kyutai config.json schema."""
        transformer = TransformerDims(
            d_model=data["dim"],
            num_heads=data["num_heads"],
            num_layers=data["num_layers"],
            dim_feedforward=4 * data["dim"],
            context=data["context"],
            max_period=data["max_period"],
            gating=True,
            norm="rms_norm",
            positional_embedding=data.get("positional_embedding", "rope"),
            layer_scale=data.get("layer_scale"),
        )
        depformer = DepFormerDims(
            d_model=data["depformer_dim"],
            num_heads=data["depformer_num_heads"],
            num_layers=data["depformer_num_layers"],
            dim_feedforward=data["depformer_dim_feedforward"],
            num_slices=data["dep_q"],
            context=data.get("depformer_context", data["dep_q"]),
            max_period=data.get("depformer_max_period", 8),
            positional_embedding=data.get("depformer_pos_emb", "none"),
            weights_per_step_schedule=data.get(
                "depformer_weights_per_step_schedule"),
            low_rank_embeddings=data.get("depformer_low_rank_embeddings"),
        )
        return cls(
            transformer=transformer,
            depformer=depformer,
            text_in_vocab_size=data["text_card"] + 1,
            text_out_vocab_size=data["text_card"],
            audio_vocab_size=data["card"] + 1,
            audio_codebooks=data["n_q"],
            # the first delay is for the text token
            audio_delays=data["delays"][1:],
            demux_second_stream=data.get("demux_second_stream", False),
            extra_heads_dim=data.get("extra_heads_dim", 6),
            extra_heads_num_heads=data.get("extra_heads_num_heads", 0),
        )

    @property
    def generated_codebooks(self) -> int:
        return self.depformer.num_slices

    @property
    def other_codebooks(self) -> int:
        return self.audio_codebooks - self.generated_codebooks

    @property
    def audio_padding_token(self) -> int:
        return self.audio_vocab_size - 1

    @property
    def audio_eos_token(self) -> int:
        return self.audio_vocab_size - 2


def config_v0_1() -> dict:
    """Moshiko/Moshika v0.1 7B."""
    return dict(
        transformer=dict(d_model=4096, num_heads=32, num_layers=32,
                         dim_feedforward=4 * 4096, context=3000,
                         max_period=10000.0),
        depformer=dict(d_model=1024, num_heads=16, num_layers=6,
                       dim_feedforward=4 * 1024, num_slices=8, context=8),
        text_in_vocab_size=32001, text_out_vocab_size=32000,
        audio_vocab_size=2049, audio_codebooks=16,
        audio_delays=([0] + [1] * 7) * 2)


def config1b_202412() -> dict:
    """Hibiki-class 1B."""
    return dict(
        transformer=dict(d_model=2048, num_heads=16, num_layers=16,
                         dim_feedforward=4 * 2048, context=3000,
                         max_period=100000.0),
        depformer=dict(d_model=1024, num_heads=16, num_layers=6,
                       dim_feedforward=4 * 1024, num_slices=8, context=8),
        text_in_vocab_size=48001, text_out_vocab_size=48000,
        audio_vocab_size=2049, audio_codebooks=16,
        audio_delays=([0] + [2] * 7) * 2)


LM_PRESETS = {"v0_1": config_v0_1, "1b_202412": config1b_202412}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class ScaledEmbedding(Embedding):
    """A table whose index -1 gives exact zeros, with an optional low-rank
    factor (`low_rank`, (rank -> dim)) or the second-stream demux (`out1`,
    `out2`: ids tok2 * vocab + tok1)."""

    def __init__(self, vocab: int, dim: int, low_rank: Optional[int] = None,
                 demux: bool = False):
        super().__init__(vocab, low_rank or dim)
        self.num_embeddings = vocab
        self.demux = demux
        if low_rank is not None:
            self.low_rank = Linear(low_rank, dim, bias=False)
        if demux:
            self.out1 = Linear(dim, dim, bias=False)
            self.out2 = Linear(dim, dim, bias=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        keep = (ids != -1)[..., None]
        idx = ids.clamp(min=0)
        if self.demux:
            n = self.num_embeddings
            right = idx // n - 1
            y = self.out1(F.embedding(idx % n, self.weight))
            y_r = self.out2(F.embedding(right.clamp(min=0), self.weight))
            y = y + y_r * (right >= 0)[..., None].to(y.dtype)
        else:
            y = F.embedding(idx, self.weight)
            if hasattr(self, "low_rank"):
                y = self.low_rank(y)
        return y * keep.to(y.dtype)


class Block(nn.Module):
    """One transformer layer of the temporal stack or of a depformer
    slice."""

    def __init__(self, d: TransformerDims):
        super().__init__()
        dm = d.d_model
        self.dims = d
        self.self_attn = holder(
            in_proj=Linear(dm, 3 * dm, bias=d.bias_attn),
            out_proj=Linear(dm, dm, bias=d.bias_attn))
        norm = ((lambda: LayerNorm(dm, eps=1e-5)) if d.norm == "layer_norm"
                else (lambda: RMSNorm(dm, eps=1e-8)))
        self.norm1, self.norm2 = norm(), norm()
        if d.layer_scale is not None:
            self.layer_scale_1 = LayerScale(dm, d.layer_scale)
            self.layer_scale_2 = LayerScale(dm, d.layer_scale)
        if d.gating:
            h = d.gating_hidden
            self.gating = holder(linear_in=Linear(dm, 2 * h, bias=d.bias_ff),
                                 linear_out=Linear(h, dm, bias=d.bias_ff))
        else:
            self.linear1 = Linear(dm, d.dim_feedforward, bias=d.bias_ff)
            self.linear2 = Linear(d.dim_feedforward, dm, bias=d.bias_ff)

    def forward(self, x: torch.Tensor, cis: Optional[torch.Tensor],
                cache: Optional[KVCache], offset: int) -> torch.Tensor:
        """x (B, T, D) at positions offset..offset+T-1; `cache` (B, S, H,
        hd) written in place at `offset`, or None (the T tokens alone)."""
        d = self.dims
        b, t, dm = x.shape
        hd = dm // d.num_heads
        q, k, v = self.self_attn.in_proj(self.norm1(x)).chunk(3, dim=-1)
        q = q.reshape(b, t, d.num_heads, hd)
        k = k.reshape(b, t, d.num_heads, hd)
        v = v.reshape(b, t, d.num_heads, hd)
        if cis is not None:
            q = apply_rotary_interleaved(q, cis)
            k = apply_rotary_interleaved(k, cis)
        # keys kept: the `context` previous ones and the current one
        lo = max(0, offset - d.context)
        if cache is not None:
            kv_update(cache, k, v, offset)
            k, v = cache.k[:, lo: offset + t], cache.v[:, lo: offset + t]
        else:
            lo = offset
        mask = None
        if t > 1:
            q_pos = offset + torch.arange(t, device=x.device)[:, None]
            k_pos = lo + torch.arange(k.shape[1], device=x.device)[None, :]
            ok = (k_pos <= q_pos) & (k_pos >= q_pos - d.context)
            mask = torch.zeros(ok.shape, device=x.device).masked_fill(
                ~ok, float("-inf"))
        out = attention(q.to(k.dtype), k, v, mask=mask).to(x.dtype)
        upd = self.self_attn.out_proj(out.reshape(b, t, dm))
        if hasattr(self, "layer_scale_1"):
            upd = upd * self.layer_scale_1.scale.to(x.dtype)
        x = x + upd
        h = self.norm2(x)
        if d.gating:
            a, g = self.gating.linear_in(h).chunk(2, dim=-1)
            h = self.gating.linear_out(F.silu(a) * g)
        else:
            h = self.linear2(gelu(self.linear1(h)))
        if hasattr(self, "layer_scale_2"):
            h = h * self.layer_scale_2.scale.to(x.dtype)
        return x + h


def _stack(dims: TransformerDims) -> nn.Module:
    return holder(layers=nn.ModuleList(Block(dims)
                                       for _ in range(dims.num_layers)))


def _build(module_fn, device, dtype) -> nn.Module:
    """Build a module tree on the meta device, cast it, then allocate it on
    `device`: a full-size model never holds an f32 copy of its weights.
    The parameters are uninitialised until init_params or a load."""
    with torch.device("meta"):
        m = module_fn()
    return m.to(dtype).to_empty(device=device)


class Lm(TorchModel):
    """The Moshi language model (temporal transformer + depformer) on
    `device` in `dtype`."""

    def __init__(self, config, device="cuda", dtype=torch.float32):
        if isinstance(config, dict):
            config = LmConfig.from_dict(config)
        super().__init__(config)
        device = check_device(device)
        c = config
        t, dp = c.transformer, c.depformer

        def modules():
            m = nn.Module()
            m.text_emb = ScaledEmbedding(c.text_in_vocab_size, t.d_model,
                                         demux=c.demux_second_stream)
            m.audio_embs = nn.ModuleList(
                ScaledEmbedding(c.audio_vocab_size, t.d_model)
                for _ in range(c.audio_codebooks))
            m.transformer = _stack(t)
            m.out_norm = (RMSNorm(t.d_model, eps=1e-8) if t.norm == "rms_norm"
                          else LayerNorm(t.d_model, eps=1e-5))
            m.text_linear = Linear(t.d_model, c.text_out_vocab_size,
                                   bias=False)
            if c.extra_heads_num_heads:
                m.extra_heads = nn.ModuleList(
                    Linear(t.d_model, c.extra_heads_dim, bias=False)
                    for _ in range(c.extra_heads_num_heads))
            dpd = self.dp_dims
            lr = dp.low_rank_embeddings
            slices = []
            for s in range(dp.num_slices):
                in_vs = c.text_in_vocab_size if s == 0 else c.audio_vocab_size
                slices.append(holder(
                    emb=ScaledEmbedding(in_vs, dp.d_model, low_rank=lr),
                    linear_in=Linear(t.d_model, dp.d_model, bias=False),
                    linear_out=Linear(dp.d_model, c.audio_vocab_size - 1,
                                      bias=False),
                    transformer=_stack(dpd)))
            m.depformer = holder(slices=nn.ModuleList(slices))
            return m

        built = _build(modules, device, dtype)
        for name, child in built.named_children():
            setattr(self, name, child)
        self.__dict__["_tables"] = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def dp_dims(self) -> TransformerDims:
        dp = self.config.depformer
        return TransformerDims(
            d_model=dp.d_model, num_heads=dp.num_heads,
            num_layers=dp.num_layers, dim_feedforward=dp.dim_feedforward,
            context=(dp.context if dp.context is not None
                     else dp.num_slices),
            max_period=dp.max_period, gating=True, norm="rms_norm",
            positional_embedding=dp.positional_embedding, hidden=dp.hidden)

    def _inv_freq(self, d: TransformerDims) -> torch.Tensor:
        key = ("inv_freq", d.d_model // d.num_heads, d.max_period)
        if key not in self._tables:
            self._tables[key] = rope_freqs(d.d_model // d.num_heads,
                                           d.max_period).to(self.device)
        return self._tables[key]

    def make_caches(self, batch: int, max_steps: int = MAX_STEPS) -> KVCache:
        """The main stack's f32 KV cache (L, B, max_steps, H, hd)."""
        t = self.config.transformer
        return KVCache.init(batch, max_steps, t.num_heads,
                            t.d_model // t.num_heads, torch.float32,
                            self.device, n_layers=t.num_layers)

    def _dp_cache(self, batch: int, dtype) -> KVCache:
        """The depformer's cache of num_slices + 2 columns, one buffer
        reused by every step: slice s writes column s before any slice
        reads it."""
        dpd = self.dp_dims
        key = ("dp_cache", batch, dtype)
        if key not in self._tables:
            self._tables[key] = KVCache.init(
                batch, self.config.depformer.num_slices + 2, dpd.num_heads,
                dpd.d_model // dpd.num_heads, dtype, self.device,
                n_layers=dpd.num_layers)
        return self._tables[key]

    def _run(self, stack: nn.Module, d: TransformerDims, x: torch.Tensor,
             caches: Optional[KVCache], offset: int) -> torch.Tensor:
        cis = None
        if d.positional_embedding == "rope":
            pos = torch.arange(offset, offset + x.shape[1], device=x.device)
            cis = rope_cis(pos, self._inv_freq(d))
        for i, layer in enumerate(stack.layers):
            x = layer(x, cis, None if caches is None else caches.layer(i),
                      offset)
        return x

    def _main_step(self, embeds: torch.Tensor, caches: Optional[KVCache],
                   offset: int) -> torch.Tensor:
        x = self._run(self.transformer, self.config.transformer, embeds,
                      caches, offset)
        return self.out_norm(x)

    def _audio_embeds(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, n_codebooks[, T]) -> the sum of the codebooks'
        embeddings (B, T, D)."""
        if tokens.ndim == 2:
            tokens = tokens[..., None]
        return sum(emb(tokens[:, i]) for i, emb in enumerate(self.audio_embs))

    @torch.inference_mode()
    def forward_text(self, token_ids: torch.Tensor,
                     caches: Optional[KVCache] = None, offset: int = 0):
        """Text-only forward: (hidden, logits)."""
        hidden = self._main_step(self.text_emb(token_ids), caches, offset)
        return hidden, self.text_linear(hidden)

    def _depformer(self, hidden: torch.Tensor, first: torch.Tensor,
                   teacher: Optional[torch.Tensor] = None, sampler=None):
        """The slices over one main step's hidden state (B, 1, D): slice s
        takes slice s-1's token (the text token at s = 0; `teacher`'s
        column s when given) -> ((B, S, V - 1) logits or (B, S) tokens)."""
        dpd = self.dp_dims
        caches = self._dp_cache(hidden.shape[0], hidden.dtype)
        last = first
        outs = []
        for s, sp in enumerate(self.depformer.slices):
            if teacher is not None:
                last = teacher[:, s]
            x = sp.linear_in(hidden) + sp.emb(last[:, None])
            x = self._run(sp.transformer, dpd, x, caches, s)
            logits = sp.linear_out(x[:, -1])
            if sampler is None:
                outs.append(logits)
            else:
                last = sampler(logits)
                outs.append(last)
        return torch.stack(outs, dim=1)

    @torch.inference_mode()
    def sample_step(self, text_token: torch.Tensor,
                    audio_tokens: torch.Tensor, caches: KVCache, offset: int,
                    generator: Optional[torch.Generator] = None,
                    text_temp: float = 0.8, audio_temp: float = 0.8,
                    top_p: float = TOP_P):
        """One full-duplex step. text_token (B, 1); audio_tokens (B,
        n_codebooks), the delayed previous codes of both streams (-1: the
        zero token). -> (text token (B,), own audio (B, S), out) with out
        holding `hidden`, `text_logits` and any `extra_heads`; nothing is
        read back to the host."""
        xs = self.text_emb(text_token) + self._audio_embeds(audio_tokens)
        hidden = self._main_step(xs, caches, offset)
        text_logits = self.text_linear(hidden[:, -1])
        text_next = self._sample(text_logits, text_temp, top_p, generator)
        own = self._depformer(
            hidden[:, -1:], text_next,
            sampler=lambda lg: self._sample(lg, audio_temp, top_p,
                                            generator))
        out = {"hidden": hidden, "text_logits": text_logits}
        if hasattr(self, "extra_heads"):
            out["extra_heads"] = [torch.softmax(h(hidden), dim=-1)
                                  for h in self.extra_heads]
        return text_next, own, out

    @torch.inference_mode()
    def depformer_logits(self, hidden: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced depformer scoring for one main step: hidden (B,
        1, D), tokens (B, S) ([text token, own cb0 .. cb_(S-2)]) -> per-
        slice logits (B, S, audio_vocab - 1)."""
        return self._depformer(hidden, tokens[:, 0], teacher=tokens)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                top_p: float = TOP_P,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if temperature <= 0.0:
            return logits.float().argmax(dim=-1)
        return sample(logits, temperature, top_p=top_p, generator=generator)


class LmGen:
    """Streaming generation driver with per-codebook delays and stream
    undelaying. Its token ring lives on the host; a step sends the step's
    inputs to the device once and reads its tokens back once."""

    ZERO_TOKEN = -1
    UNGENERATED = -2

    def __init__(self, model: Lm, max_steps: int = MAX_STEPS,
                 text_temp: float = 0.8, audio_temp: float = 0.8,
                 batch_size: int = 1, seed: int = 0):
        self.model = model
        self.cfg = model.config
        self.max_steps = max_steps
        self.text_temp = text_temp
        self.audio_temp = audio_temp
        self.B = batch_size
        ncb = 1 + self.cfg.audio_codebooks
        self.gen = np.full((batch_size, ncb, max_steps), self.UNGENERATED,
                           np.int64)
        self.step_idx = 0
        self.caches = model.make_caches(
            batch_size, max_steps=max(max_steps,
                                      self.cfg.transformer.context + 1))
        self.generator = torch.Generator(device=model.device).manual_seed(
            seed)
        self.main = self.cfg.generated_codebooks
        self.delays = self.cfg.audio_delays
        self.max_delay = max(self.delays, default=0)
        self.last_extra_heads = None

    def _raw_step(self, other_audio_tokens: np.ndarray) -> np.ndarray:
        """Advance one step; returns the sampled text tokens (B,)."""
        cfg = self.cfg
        pad = cfg.audio_padding_token
        t = self.step_idx
        if t >= self.max_steps:
            raise ValueError(f"reached max-steps {self.max_steps}")
        inputs = np.full((self.B, 1 + cfg.audio_codebooks), pad, np.int64)
        inputs[:, 0] = (cfg.text_out_vocab_size if t == 0
                        else self.gen[:, 0, t - 1])
        self.gen[:, 1 + self.main:, t] = other_audio_tokens
        for cb in range(cfg.audio_codebooks):
            src_t = t - 1 - self.delays[cb]
            if src_t >= 0:
                tok = self.gen[:, 1 + cb, src_t]
                if (tok == self.UNGENERATED).any():
                    raise ValueError(
                        f"ungenerated value in audio tokens cb {cb} step {t}")
                inputs[:, 1 + cb] = tok
        x = torch.from_numpy(inputs).to(self.model.device)
        text_next, own, extra = self.model.sample_step(
            x[:, :1], x[:, 1:], self.caches, t, self.generator,
            self.text_temp, self.audio_temp)
        tokens = torch.cat([text_next[:, None], own], dim=1).cpu().numpy()
        if "extra_heads" in extra:
            self.last_extra_heads = [e.float().cpu().numpy()
                                     for e in extra["extra_heads"]]
        text_next = tokens[:, 0]
        self.gen[:, 0, t] = text_next
        # own codes sampled at step t land at position t - delay, so the
        # streams come out undelayed
        for cb in range(self.main):
            dst_t = t - self.delays[cb]
            if dst_t >= 0:
                self.gen[:, 1 + cb, dst_t] = tokens[:, 1 + cb]
        self.step_idx += 1
        return text_next

    def last_audio_tokens(self) -> Optional[np.ndarray]:
        """Undelayed frame (B, S), or None while the delay pipeline
        fills."""
        out_t = self.step_idx - 1 - self.max_delay
        if out_t < 0:
            return None
        tokens = self.gen[:, 1: 1 + self.main, out_t]
        if (tokens == self.cfg.audio_padding_token).any():
            return None
        if (tokens == self.UNGENERATED).any():
            raise ValueError(f"ungenerated value at step {self.step_idx}")
        return tokens

    def step(self, other_audio_tokens: np.ndarray) -> tuple:
        """Feed the other speaker's codes (B, other_codebooks; -1 =
        silence); returns (text_token (B,), own_audio (B, S) or None until
        the delay pipeline fills)."""
        text_next = self._raw_step(np.asarray(other_audio_tokens, np.int64))
        return text_next, self.last_audio_tokens()


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "moshi"
    lm_config: Optional[dict] = None
    lm_preset: str = "v0_1"
    mimi_num_codebooks: int = 8
    sample_rate: int = 24000
    model_path: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        if "dim" in d and "lm_config" not in d:
            # raw kyutai config.json at top level
            return cls(lm_config=dict(d),
                       mimi_num_codebooks=d.get("dep_q", 8),
                       sample_rate=d.get("sample_rate", 24000))
        return super().from_dict(d)


class Model(TorchModel):
    """Speech-to-speech wrapper: Mimi encode -> the Lm step loop -> Mimi
    decode, on `device` in `dtype` (the card by default; without CUDA the
    constructor raises unless given `device="cpu"`). The Mimi is bound by
    the caller (`model.mimi = Mimi(...)`) and kept outside the module
    tree."""

    def __init__(self, config=None, device="cuda", dtype=torch.float32):
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        lm_cfg = config.lm_config
        if lm_cfg is None:
            lm_cfg = LM_PRESETS[config.lm_preset]()
        self.lm = Lm(LmConfig.from_dict(lm_cfg)
                     if isinstance(lm_cfg, dict) else lm_cfg,
                     device=device, dtype=dtype)
        self.__dict__["mimi"] = None
        self.last_run: Dict[str, object] = {}

    def __setattr__(self, name, value):
        if name == "mimi":      # a codec beside the model, not a submodule
            self.__dict__["mimi"] = value
        else:
            super().__setattr__(name, value)

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict:
        return {f"lm.{k}": v
                for k, v in sanitize_lm(dict(weights), self.lm.config).items()}

    @property
    def sample_rate(self):
        return self.config.sample_rate

    def generate(self, audio, max_steps: Optional[int] = None, **kwargs):
        """Offline duplex run: user audio in -> Moshi's audio and text
        tokens. `text_temp`, `audio_temp` and `seed` go to LmGen."""
        from ....tts.models.base import (GenerationResult, format_duration,
                                         peak_memory_gb)

        if self.mimi is None:
            raise ValueError("Bind a Mimi codec to model.mimi first.")
        t0 = time.perf_counter()
        if isinstance(audio, (str, Path)):
            from ....utils import load_audio

            audio = load_audio(audio, self.sample_rate)
        codes = self.mimi.encode(np.asarray(audio, np.float32)).cpu().numpy()
        n_steps = codes.shape[-1] if max_steps is None else min(
            codes.shape[-1], max_steps)
        other_cb = self.lm.config.other_codebooks
        gen = LmGen(self.lm, max_steps=max(n_steps + 8, 16), **{
            k: v for k, v in kwargs.items()
            if k in ("text_temp", "audio_temp", "seed")})
        own_frames, texts, step_ms = [], [], []
        for t in range(n_steps):
            ts = time.perf_counter()
            text_tok, own = gen.step(codes[0, :other_cb, t][None])
            step_ms.append((time.perf_counter() - ts) * 1e3)
            texts.append(int(text_tok[0]))
            if own is not None:
                own_frames.append(own[0])
        if own_frames:
            own_codes = np.stack(own_frames, axis=-1)[None]  # (1, S, T)
            own_codes = np.clip(own_codes, 0,
                                self.lm.config.audio_vocab_size - 2)
            audio_out = self.mimi.decode(own_codes)[0, 0].float().cpu() \
                .numpy()
        else:
            audio_out = np.zeros(0, np.float32)
        wall = time.perf_counter() - t0
        dur = len(audio_out) / self.sample_rate
        self.last_run = {"steps": n_steps, "step_ms": step_ms,
                         "own_frames": len(own_frames)}
        return GenerationResult(
            audio=audio_out, samples=len(audio_out),
            sample_rate=self.sample_rate, segment_idx=0,
            token_count=len(texts), audio_duration=format_duration(dur),
            real_time_factor=dur / wall if wall > 0 else 0.0,
            prompt={"tokens": len(texts), "text_tokens": texts,
                    "tokens-per-sec": len(texts) / wall if wall else 0},
            audio_samples={"samples": len(audio_out),
                           "samples-per-sec": len(audio_out) / wall
                           if wall else 0},
            processing_time_seconds=wall, peak_memory_usage=peak_memory_gb(),
            is_final_chunk=True)


# ---------------------------------------------------------------------------
# Checkpoint sanitize (kyutai MLX / kyutai PyTorch / HF transformers)
# ---------------------------------------------------------------------------

def _unpermute_hf_rope(w: np.ndarray, num_heads: int) -> np.ndarray:
    """HF stores q/k for half-split rotate_half; kyutai weights are
    interleaved. Invert the HF conversion permute."""
    out, inp = w.shape
    hd = out // num_heads
    return (w.reshape(num_heads, 2, hd // 2, inp)
            .transpose(0, 2, 1, 3).reshape(out, inp))


def sanitize_lm(w: Dict[str, np.ndarray], cfg: LmConfig) -> Dict:
    """Flat checkpoint dict -> flat dict in the JAX tree's names, numpy."""
    w = {k: np.asarray(v) for k, v in w.items()}
    if any(k.startswith("decoder.model.") for k in w):
        return _sanitize_hf(w, cfg)
    if "out_norm.alpha" in w or "depformer_in.0.weight" in w:
        return _sanitize_kyutai_pt(w, cfg)
    return _sanitize_kyutai_mlx(w, cfg)


def _sanitize_kyutai_mlx(w: Dict, cfg: LmConfig) -> Dict:
    """kyutai/moshiko-mlx-*: the module tree's own names."""
    return {k: v for k, v in w.items()
            if not k.startswith(("audio_encoder.", "tokenizer."))}


def _sanitize_kyutai_pt(w: Dict, cfg: LmConfig) -> Dict:
    """kyutai/moshiko-pytorch-* (kyutai's load_pytorch_weights)."""
    dp = cfg.depformer
    chunks = dp.num_slices
    if dp.weights_per_step_schedule is not None:
        chunks = max(dp.weights_per_step_schedule) + 1
    out = {"out_norm.weight": w["out_norm.alpha"].reshape(-1)}
    for name in ("text_emb.weight", "text_emb.out1.weight",
                 "text_emb.out2.weight", "text_linear.weight"):
        if name in w:
            out[name] = w[name]
    for cb in range(cfg.audio_codebooks):
        out[f"audio_embs.{cb}.weight"] = w[f"emb.{cb}.weight"]
    for k, v in w.items():
        if k.startswith("transformer."):
            if k.endswith(".alpha"):
                out[k[: -len(".alpha")] + ".weight"] = v.reshape(-1)
                continue
            out[k.replace(".in_proj_weight", ".in_proj.weight")] = v
        elif k.startswith("extra_heads."):
            out[k] = v
    for s in range(dp.num_slices):
        pt_idx = s
        if dp.weights_per_step_schedule is not None:
            pt_idx = dp.weights_per_step_schedule[s]
        pre = f"depformer.slices.{s}"
        out[f"{pre}.linear_in.weight"] = w[f"depformer_in.{pt_idx}.weight"]
        out[f"{pre}.linear_out.weight"] = w[f"linears.{s}.weight"]
        if s == 0:
            out[f"{pre}.emb.weight"] = w["depformer_text_emb.weight"]
            for n in ("low_rank", "out1", "out2"):
                if f"depformer_text_emb.{n}.weight" in w:
                    out[f"{pre}.emb.{n}.weight"] = \
                        w[f"depformer_text_emb.{n}.weight"]
        else:
            out[f"{pre}.emb.weight"] = w[f"depformer_emb.{s - 1}.weight"]
            if f"depformer_emb.{s - 1}.low_rank.weight" in w:
                out[f"{pre}.emb.low_rank.weight"] = \
                    w[f"depformer_emb.{s - 1}.low_rank.weight"]
        for li in range(dp.num_layers):
            p = f"{pre}.transformer.layers.{li}"
            src = f"depformer.layers.{li}"
            out[f"{p}.norm1.weight"] = w[f"{src}.norm1.alpha"].reshape(-1)
            out[f"{p}.norm2.weight"] = w[f"{src}.norm2.alpha"].reshape(-1)
            out[f"{p}.gating.linear_in.weight"] = \
                w[f"{src}.gating.{pt_idx}.linear_in.weight"]
            out[f"{p}.gating.linear_out.weight"] = \
                w[f"{src}.gating.{pt_idx}.linear_out.weight"]
            out[f"{p}.self_attn.in_proj.weight"] = np.split(
                w[f"{src}.self_attn.in_proj_weight"], chunks, axis=0)[pt_idx]
            out[f"{p}.self_attn.out_proj.weight"] = np.split(
                w[f"{src}.self_attn.out_proj.weight"], chunks, axis=0)[pt_idx]
    return out


def _sanitize_hf(w: Dict, cfg: LmConfig) -> Dict:
    """HF transformers Moshi (kmhf/hf-moshiko); its q/k carry the
    half-split RoPE permutation, undone here."""
    t = cfg.transformer
    out = {
        "text_emb.weight": w["decoder.model.embed_tokens.weight"],
        "text_linear.weight": w["decoder.lm_head.weight"],
        "out_norm.weight": w["decoder.model.norm.weight"],
    }
    for cb in range(cfg.audio_codebooks):
        out[f"audio_embs.{cb}.weight"] = w[f"embed_tokens.{cb}.weight"]
    for li in range(t.num_layers):
        src = f"decoder.model.layers.{li}"
        dst = f"transformer.layers.{li}"
        q = _unpermute_hf_rope(w[f"{src}.self_attn.q_proj.linear.weight"],
                               t.num_heads)
        k = _unpermute_hf_rope(w[f"{src}.self_attn.k_proj.linear.weight"],
                               t.num_heads)
        v = w[f"{src}.self_attn.v_proj.linear.weight"]
        out[f"{dst}.self_attn.in_proj.weight"] = np.concatenate([q, k, v], 0)
        out[f"{dst}.self_attn.out_proj.weight"] = \
            w[f"{src}.self_attn.o_proj.linear.weight"]
        out[f"{dst}.norm1.weight"] = w[f"{src}.input_layernorm.weight"]
        out[f"{dst}.norm2.weight"] = w[f"{src}.post_attention_layernorm.weight"]
        out[f"{dst}.gating.linear_in.weight"] = w[f"{src}.mlp.fc1.weight"]
        out[f"{dst}.gating.linear_out.weight"] = w[f"{src}.mlp.fc2.weight"]
    dp = cfg.depformer
    for s in range(dp.num_slices):
        pre = f"depformer.slices.{s}"
        out[f"{pre}.linear_in.weight"] = \
            w["depth_decoder.input_projections.weight"][s]
        out[f"{pre}.linear_out.weight"] = w["depth_decoder.lm_heads.weight"][s]
        out[f"{pre}.emb.weight"] = (
            w["depth_decoder.text_embed_tokens.weight"] if s == 0
            else w[f"depth_decoder.embed_tokens.{s - 1}.weight"])
        for li in range(dp.num_layers):
            src = f"depth_decoder.layers.{li}"
            p = f"{pre}.transformer.layers.{li}"
            # the depth decoder has no RoPE: nothing to un-permute
            out[f"{p}.self_attn.in_proj.weight"] = np.concatenate(
                [w[f"{src}.self_attn.q_proj.linear.weight"][s],
                 w[f"{src}.self_attn.k_proj.linear.weight"][s],
                 w[f"{src}.self_attn.v_proj.linear.weight"][s]], axis=0)
            out[f"{p}.self_attn.out_proj.weight"] = \
                w[f"{src}.self_attn.o_proj.linear.weight"][s]
            out[f"{p}.norm1.weight"] = w[f"{src}.input_layernorm.weight"]
            out[f"{p}.norm2.weight"] = w[f"{src}.post_attention_layernorm.weight"]
            out[f"{p}.gating.linear_in.weight"] = w[f"{src}.mlp.fc1.weight"][s]
            out[f"{p}.gating.linear_out.weight"] = w[f"{src}.mlp.fc2.weight"][s]
    return out


__all__ = ["Model", "ModelConfig", "Lm", "LmConfig", "LmGen",
           "ScaledEmbedding", "Block", "TransformerDims", "DepFormerDims",
           "config_v0_1", "config1b_202412", "LM_PRESETS", "sanitize_lm"]
