"""Pocket-TTS: Kyutai's streaming flow-matching TTS over Mimi latents, with
voice cloning from a reference clip.

Counterpart of mlx_audio_tpu/tts/models/pocket_tts/pocket_tts.py:
`FlowLMConfig` and `ModelConfig` with `mimi_config` (:64-139), the
interleaved-pair RoPE (:147), the streaming transformer (:176), the
timestep embedder (:204-227), the AdaLN flow net (:230-290), the frame
step with its N-step LSD decode (:366-395), the text embeds and the
voice-prompt state (:399-427), `generate_audio_stream`,
`_stream_short_text` and `generate` (:429-552), `sanitize` (:574) and
`post_load_hook` with the tokenizers (:597-662), and the text helpers
`prepare_text_prompt` and `split_into_best_sentences` (:665-705).
Parameter names are the JAX tree's (`flow_lm.transformer.layers.N.*`,
`flow_lm.flow_net.*`, `mimi.*`, `speaker_proj_weight`), linears in
(out, in) and the Mimi in torch's conv layouts.

The frame loop runs eagerly, one step a frame: the transformer over the
previous latent against an f32 KV cache of MAX_FRAMES columns at the
host's offset (reading only the columns written), the EOS head, the LSD
flow decode, and the Mimi's streaming latent decode (`decode_latent_step`);
the host reads the EOS flag and the frame's audio once a frame. The voice
prompt and each sentence's text are prefilled at their own length (the
JAX package pads them to a bucket and attends only below the offset, so
the numbers are the same).

Departures from the JAX package:

* the feed-forward GELU is the tanh approximation, as `jax.nn.gelu`'s
  default that the JAX package calls (:202); which form Kyutai's weights
  were trained with only a real checkpoint would show;
* the cache's cap raises before the prefill, naming it: a voice prompt
  over PREFILL_BUCKETS[-1] frames (512, about 41 s; the JAX package's
  `jnp.pad` fails there on a negative width), or a prompt, text and
  `max_gen` frames past MAX_FRAMES (1,024; the JAX package's
  `dynamic_update_slice` clamps the write onto earlier columns without a
  word);
* the flow's noise is drawn from a `torch.Generator` seeded with `seed`
  for each sentence, through `_draws`, the seam through which the tests
  hand the port JAX's draws; at temperature 0 the noise is zero;
* the Mimi's streamed first frames keep the transposed convs' bias (the
  port's Mimi, tests/test_torch_mimi.py), where JAX's lose it.
"""

from __future__ import annotations

import json
import math
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder, leaves
from ....nn import Embedding, LayerNorm, Linear
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update
from ..base import GenerationResult, format_duration, peak_memory_gb

DEFAULT_TEMPERATURE = 0.7
DEFAULT_LSD_DECODE_STEPS = 2
DEFAULT_NOISE_CLAMP = 5.0
DEFAULT_EOS_THRESHOLD = -4.0
MAX_FRAMES = 1024
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)


# ----------------------------------------------------------------- configs


@dataclass
class FlowLMConfig(BaseModelArgs):
    dim: int = 1024           # transformer d_model
    num_heads: int = 16
    num_layers: int = 12
    hidden_scale: int = 4
    max_period: float = 10000.0
    flow_dim: int = 1024      # flow net width
    flow_depth: int = 6
    lut_n_bins: int = 8000
    lut_dim: int = 1024

    @classmethod
    def from_reference_dict(cls, d: dict) -> "FlowLMConfig":
        t = d.get("transformer", {})
        f = d.get("flow", {})
        lut = d.get("lookup_table", {})
        return cls(
            dim=t.get("d_model", 1024), num_heads=t.get("num_heads", 16),
            num_layers=t.get("num_layers", 12),
            hidden_scale=t.get("hidden_scale", 4),
            max_period=float(t.get("max_period", 10000.0)),
            flow_dim=f.get("dim", 1024), flow_depth=f.get("depth", 6),
            lut_n_bins=lut.get("n_bins", 8000),
            lut_dim=lut.get("dim", 1024))


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "pocket_tts"
    flow_lm: dict = field(default_factory=dict)
    mimi: dict = field(default_factory=dict)
    sample_rate: int = 24000
    model_path: str = ""

    def __post_init__(self):
        self.flow_cfg = FlowLMConfig.from_reference_dict(self.flow_lm or {})
        m = self.mimi or {}
        self.latent_dim = m.get("quantizer", {}).get("dimension", 512)
        self.mimi_output_dim = m.get("quantizer", {}).get(
            "output_dimension", 512)
        if m.get("sample_rate"):
            self.sample_rate = m["sample_rate"]

    def mimi_config(self):
        from ....codec.models.mimi.mimi import MimiConfig

        m = self.mimi or {}
        s = m.get("seanet", {})
        t = m.get("transformer", {})
        return MimiConfig(
            channels=m.get("channels", 1),
            sample_rate=m.get("sample_rate", 24000),
            frame_rate=m.get("frame_rate", 12.5),
            seanet=dict(
                dimension=s.get("dimension", 512),
                channels=s.get("channels", 1),
                nfilters=s.get("n_filters", 64),
                nresidual_layers=s.get("n_residual_layers", 1),
                ratios=s.get("ratios", [8, 6, 5, 4]),
                ksize=s.get("kernel_size", 7),
                residual_ksize=s.get("residual_kernel_size", 3),
                last_ksize=s.get("last_kernel_size", 3),
                dilation_base=s.get("dilation_base", 2),
                pad_mode=s.get("pad_mode", "constant"),
                compress=s.get("compress", 2)),
            transformer=dict(
                d_model=t.get("d_model", 512),
                num_heads=t.get("num_heads", 8),
                num_layers=t.get("num_layers", 8),
                layer_scale=t.get("layer_scale", 0.01),
                context=t.get("context", 250),
                max_period=float(t.get("max_period", 10000.0)),
                dim_feedforward=t.get("dim_feedforward", 2048)),
            quantizer_nq=1,
            quantizer_bins=16,
            quantizer_dim=self.latent_dim,
        )


# ------------------------------------------------------- flow-lm components


def rope_interleaved(x: torch.Tensor, offset: int,
                     max_period: float) -> torch.Tensor:
    """Interleaved-pair RoPE of x (B, T, H, D) at positions offset + t, in
    f32 (:147-159)."""
    b, t, h, d = x.shape
    half = d // 2
    dev = x.device
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=dev)
                      * (-math.log(max_period) * 2 / d))
    ts = (torch.arange(t, dtype=torch.float32, device=dev)
          + offset)[None, :, None, None]
    xr = x.reshape(b, t, h, half, 2).float()
    re_, im = xr[..., 0], xr[..., 1]
    c, s = torch.cos(freqs * ts), torch.sin(freqs * ts)
    out = torch.stack([re_ * c - im * s, re_ * s + im * c], dim=-1)
    return out.reshape(b, t, h, d).to(x.dtype)


def _layer(f: FlowLMConfig) -> nn.Module:
    ff = int(f.hidden_scale * f.dim)
    return holder(
        self_attn=holder(in_proj=Linear(f.dim, 3 * f.dim, bias=False),
                         out_proj=Linear(f.dim, f.dim, bias=False)),
        norm1=LayerNorm(f.dim), norm2=LayerNorm(f.dim),
        linear1=Linear(f.dim, ff, bias=False),
        linear2=Linear(ff, f.dim, bias=False))


def streaming_transformer(p: nn.Module, f: FlowLMConfig, x: torch.Tensor,
                          caches: KVCache, offset: int) -> torch.Tensor:
    """x (B, T, dim) at positions offset.. through the layers, each writing
    its K and V into `caches` (stacked, in place) and attending causally to
    the columns written (:176-201). The feed-forward GELU is tanh's."""
    b, t, d = x.shape
    h = f.num_heads
    hd = d // h
    end = offset + t
    q_pos = offset + torch.arange(t, device=x.device)
    ok = torch.arange(end, device=x.device)[None, :] <= q_pos[:, None]
    mask = torch.zeros(ok.shape, device=x.device).masked_fill(
        ~ok, float("-inf"))[None, None]
    for i, lp in enumerate(p.layers):
        qkv = lp.self_attn.in_proj(lp.norm1(x)).reshape(b, t, 3, h, hd)
        q = rope_interleaved(qkv[:, :, 0], offset, f.max_period)
        k = rope_interleaved(qkv[:, :, 1], offset, f.max_period)
        cache = kv_update(caches.layer(i), k.to(caches.k.dtype),
                          qkv[:, :, 2].to(caches.v.dtype), offset)
        o = attention(q, cache.k[:, :end].to(q.dtype),
                      cache.v[:, :end].to(q.dtype), mask=mask)
        x = x + lp.self_attn.out_proj(o.reshape(b, t, d))
        x = x + lp.linear2(F.gelu(lp.linear1(lp.norm2(x)),
                                  approximate="tanh"))
    return x


def _timestep_embedder(hidden: int, freq_size: int = 256) -> nn.Module:
    alpha = leaves(alpha=(hidden,))
    alpha.init_fill = {"alpha": 1.0}
    return holder(mlp=nn.ModuleDict({"0": Linear(freq_size, hidden),
                                     "2": Linear(hidden, hidden),
                                     "3": alpha}))


def timestep_embed(p: nn.Module, t: torch.Tensor, freq_size: int = 256,
                   max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal features of t (B, 1) through the MLP, then torch's
    RMSNorm with the ddof=1 variance (:213-227)."""
    half = freq_size // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float() * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    h = p.mlp["2"](F.silu(p.mlp["0"](emb.to(p.mlp["0"].weight.dtype))))
    var = 1e-5 + torch.var(h.float(), dim=-1, keepdim=True, correction=1)
    return (h * p.mlp["3"].alpha.to(h.dtype)
            * torch.rsqrt(var).to(h.dtype))


def _flow_net(in_ch: int, model_ch: int, cond_ch: int,
              depth: int) -> nn.Module:
    return holder(
        time_embed=nn.ModuleDict({"0": _timestep_embedder(model_ch),
                                  "1": _timestep_embedder(model_ch)}),
        cond_embed=Linear(cond_ch, model_ch),
        input_proj=Linear(in_ch, model_ch),
        res_blocks=nn.ModuleDict({str(i): holder(
            in_ln=LayerNorm(model_ch),
            mlp=nn.ModuleDict({"0": Linear(model_ch, model_ch),
                               "2": Linear(model_ch, model_ch)}),
            adaLN_modulation=nn.ModuleDict(
                {"1": Linear(model_ch, 3 * model_ch)}))
            for i in range(depth)}),
        final_layer=holder(
            linear=Linear(model_ch, in_ch),
            adaLN_modulation=nn.ModuleDict(
                {"1": Linear(model_ch, 2 * model_ch)})))


def flow_net_forward(p: nn.Module, c: torch.Tensor, s: torch.Tensor,
                     t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The AdaLN MLP (:255-290): c the condition (B, C), s and t times
    (B, 1), x the noisy latent (B, latent) -> the flow (B, latent)."""
    x = p.input_proj(x)
    tc = (timestep_embed(p.time_embed["0"], s)
          + timestep_embed(p.time_embed["1"], t)) / 2.0
    y = tc + p.cond_embed(c)
    sy = F.silu(y)
    for bp in p.res_blocks.values():
        shift, scale, gate = bp.adaLN_modulation["1"](sy).chunk(3, dim=-1)
        h = bp.in_ln(x) * (1 + scale) + shift
        h = bp.mlp["2"](F.silu(bp.mlp["0"](h)))
        x = x + gate * h
    fl = p.final_layer
    shift, scale = fl.adaLN_modulation["1"](sy).chunk(2, dim=-1)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    xn = ((x - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype)
    return fl.linear(xn * (1 + scale) + shift)


# -------------------------------------------------------------------- model


class Model(TorchModel):
    """Pocket-TTS on `device` (the card by default; without CUDA the
    constructor raises unless given `device="cpu"`)."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda"):
        from ....codec.models.mimi.mimi import Mimi

        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        f = config.flow_cfg
        lat = config.latent_dim
        with torch.device(device):
            lm = leaves(emb_std=(lat,), emb_mean=(lat,), bos_emb=(lat,))
            lm.init_fill = {"emb_std": 1.0, "emb_mean": 0.0}
            cond = {"embed": Embedding(f.lut_n_bins + 1, f.lut_dim)}
            if f.lut_dim != f.dim:
                cond["output_proj"] = Linear(f.lut_dim, f.dim, bias=False)
            lm.conditioner = holder(**cond)
            lm.transformer = holder(layers=nn.ModuleList(
                _layer(f) for _ in range(f.num_layers)))
            lm.flow_net = _flow_net(lat, f.flow_dim, f.dim, f.flow_depth)
            lm.input_linear = Linear(lat, f.dim, bias=False)
            lm.out_norm = LayerNorm(f.dim)
            lm.out_eos = Linear(f.dim, 1)
            self.flow_lm = lm
            self.speaker_proj_weight = nn.Parameter(
                torch.empty(f.dim, config.mimi_output_dim))
        self.mimi = Mimi(config.mimi_config(), device=device)
        self.init_fill = {"speaker_proj_weight": 0.0}
        self.temp = DEFAULT_TEMPERATURE
        self.lsd_decode_steps = DEFAULT_LSD_DECODE_STEPS
        self.noise_clamp = DEFAULT_NOISE_CLAMP
        self.eos_threshold = DEFAULT_EOS_THRESHOLD
        self.tokenizer = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    on_device: bool = False) -> "Model":
        """TorchModel's draws, then `bos_emb` from N(0, 1) (init_params,
        :320-336)."""
        super().init_params(seed, on_device)
        p = self.flow_lm.bos_emb
        dev = p.device if on_device else torch.device("cpu")
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        p.copy_(torch.randn(p.shape, generator=g, device=dev,
                            dtype=p.dtype if on_device else torch.float32))
        return self

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def frame_rate(self) -> float:
        return self.mimi.config.frame_rate

    # ------------------------------------------------------------- steps

    def _init_caches(self) -> KVCache:
        f = self.config.flow_cfg
        return KVCache.init(1, MAX_FRAMES, f.num_heads, f.dim // f.num_heads,
                            torch.float32, self.device,
                            n_layers=f.num_layers)

    def _dtype(self) -> torch.dtype:
        return self.flow_lm.input_linear.weight.dtype

    def _draws(self, generator: torch.Generator,
               shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard-normal f32 noise of one frame (a test replaces this to
        feed JAX's draws)."""
        return torch.randn(shape, generator=generator, device=self.device)

    @torch.no_grad()
    def frame(self, caches: KVCache, offset: int,
              prev_latent: Optional[torch.Tensor],
              generator: Optional[torch.Generator]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One frame (:366-395): the previous latent (B, 1, latent), or
        `bos_emb` when None, through the transformer at `offset`; the EOS
        logit against `eos_threshold`; the noise times sqrt(temp), clamped;
        `lsd_decode_steps` flow steps. -> (latent (1, 1, latent) f32, is_eos
        (1,) bool), both on the device."""
        lm = self.flow_lm
        lat = self.config.latent_dim
        seq = (lm.bos_emb[None, None, :] if prev_latent is None
               else prev_latent).to(self._dtype())
        x = lm.input_linear(seq)
        out = streaming_transformer(lm.transformer, self.config.flow_cfg, x,
                                    caches, offset)
        out = lm.out_norm(out)[:, -1].float()
        is_eos = lm.out_eos.forward(out.to(self._dtype())).float()[:, 0] \
            > self.eos_threshold
        if self.temp == 0.0:
            noise = torch.zeros(1, lat, device=self.device)
        else:
            noise = self._draws(generator, (1, lat)) * (self.temp ** 0.5)
            if self.noise_clamp is not None:
                noise = noise.clamp(-self.noise_clamp, self.noise_clamp)
        cur, n = noise, self.lsd_decode_steps
        cond = out.to(self._dtype())
        for i in range(n):
            s = torch.full((1, 1), i / n, device=self.device)
            t = torch.full((1, 1), (i + 1) / n, device=self.device)
            cur = cur + flow_net_forward(lm.flow_net, cond, s, t,
                                         cur.to(self._dtype())).float() / n
        return cur[:, None, :], is_eos

    # ------------------------------------------------------------ prompt

    def _text_embeds(self, tokens) -> torch.Tensor:
        c = self.flow_lm.conditioner
        ids = torch.as_tensor(np.asarray(tokens, np.int64).reshape(1, -1),
                              device=self.device)
        e = c.embed(ids)
        if hasattr(c, "output_proj"):
            e = c.output_proj(e)
        return e

    @torch.no_grad()
    def encode_voice_prompt(self, audio) -> torch.Tensor:
        """Reference audio -> conditioning frames (1, F, dim)."""
        audio = np.asarray(audio, np.float32).reshape(1, -1)
        latents = self.mimi.encode_to_latent(audio)
        return latents.to(self._dtype()) @ self.speaker_proj_weight.T

    @torch.no_grad()
    def get_state_for_audio_prompt(self, audio) -> Dict[str, Any]:
        """The reusable voice-prompt state: its frames prefilled into a
        fresh cache."""
        if isinstance(audio, (str, Path)):
            from ....utils import load_audio

            audio = load_audio(str(audio), sample_rate=self.sample_rate)
        cond = self.encode_voice_prompt(audio)
        n = cond.shape[1]
        if n > PREFILL_BUCKETS[-1]:
            raise ValueError(
                f"a voice prompt of {n} frames: at most "
                f"{PREFILL_BUCKETS[-1]} fit (the largest prefill bucket, "
                f"{PREFILL_BUCKETS[-1] / self.frame_rate:.1f} s)")
        caches = self._init_caches()
        streaming_transformer(self.flow_lm.transformer, self.config.flow_cfg,
                              cond, caches, 0)
        return {"caches": caches, "prompt_frames": int(n), "offset": int(n)}

    # ---------------------------------------------------------- generate

    def generate_audio_stream(self, model_state, text_to_generate: str,
                              frames_after_eos: Optional[int] = None,
                              seed: int = 0) -> Iterable[np.ndarray]:
        """Each sentence chunk's frames of audio, from the voice state's
        offset (every chunk starts back at the prompt)."""
        if self.tokenizer is None:
            raise ValueError("pocket_tts text tokenizer not loaded")
        prompt_frames = model_state["prompt_frames"]
        for chunk in split_into_best_sentences(self.tokenizer,
                                               text_to_generate):
            model_state["offset"] = prompt_frames
            _, guess = prepare_text_prompt(chunk)
            fae = (frames_after_eos if frames_after_eos is not None
                   else guess + 2)
            yield from self._stream_short_text(model_state, chunk, fae, seed)

    @torch.no_grad()
    def _stream_short_text(self, model_state, text: str,
                           frames_after_eos: int, seed: int
                           ) -> Iterable[np.ndarray]:
        lm = self.flow_lm
        mimi = self.mimi
        max_gen = int((len(text.split()) + 2.0) * mimi.config.frame_rate)
        tokens = np.asarray(self.tokenizer.encode(text), np.int64)
        offset = model_state["offset"]
        if offset + len(tokens) + max_gen > MAX_FRAMES:
            raise ValueError(
                f"{offset} prompt frames, {len(tokens)} text tokens and up to "
                f"{max_gen} frames: past the cache's {MAX_FRAMES} columns")
        caches = model_state["caches"]
        streaming_transformer(lm.transformer, self.config.flow_cfg,
                              self._text_embeds(tokens), caches, offset)
        offset += len(tokens)
        dec_state = mimi.init_decode_stream_state(batch=1)
        qproj = mimi.quantizer.rvq_first.output_proj
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        prev = None
        eos_step = None
        frames = 0
        t0 = time.perf_counter()
        for step in range(max_gen):
            latent, is_eos = self.frame(caches, offset, prev, gen)
            offset += 1
            if bool(is_eos[0]) and eos_step is None:
                eos_step = step
            self.last_run = {"frames": frames, "max_gen": max_gen,
                             "eos_step": eos_step, "text_tokens":
                             len(tokens), "offset": offset,
                             "seconds": time.perf_counter() - t0}
            if eos_step is not None and step >= eos_step + frames_after_eos:
                break
            dec_in = latent * lm.emb_std.float() + lm.emb_mean.float()
            dec_state, audio = mimi.decode_latent_step(
                dec_state, qproj(dec_in.to(mimi.dtype)))
            frames += 1
            self.last_run["frames"] = frames
            yield audio[0, 0].float().cpu().numpy()
            prev = latent
        model_state["caches"] = caches
        model_state["offset"] = offset

    def generate(self, text: str, voice: Optional[str] = None,
                 ref_audio=None, temperature: Optional[float] = None,
                 stream: bool = False, streaming_interval: float = 2.0,
                 frames_after_eos: Optional[int] = None, seed: int = 0,
                 verbose: bool = False, **kwargs
                 ) -> Iterable[GenerationResult]:
        """Yield the request's audio: one result, or with `stream` one every
        streaming_interval seconds of audio and a final one. The voice is
        `ref_audio` (or a `voice` path), else 0.5 s of silence."""
        if ref_audio is None and voice is not None and \
                Path(str(voice)).exists():
            ref_audio = voice
        if ref_audio is None:
            ref_audio = np.zeros(int(0.5 * self.sample_rate), np.float32)
        if isinstance(ref_audio, (str, Path)):
            from ....utils import load_audio

            ref_audio = load_audio(str(ref_audio),
                                   sample_rate=self.sample_rate)
        model_state = self.get_state_for_audio_prompt(ref_audio)
        if temperature is not None:
            self.temp = temperature
        for k in ("lsd_decode_steps", "noise_clamp", "eos_threshold"):
            if kwargs.get(k) is not None:
                setattr(self, k, kwargs[k])
        token_count = len(text.split())
        interval = max(int(streaming_interval * self.sample_rate), 1)
        buf: List[np.ndarray] = []
        buffered = seg = 0
        t0 = time.perf_counter()
        for chunk in self.generate_audio_stream(model_state, text,
                                                frames_after_eos, seed):
            buf.append(chunk)
            buffered += len(chunk)
            if stream and buffered >= interval:
                yield self._result(np.concatenate(buf), seg, token_count,
                                   time.perf_counter() - t0, streaming=True)
                buf, buffered, seg = [], 0, seg + 1
                t0 = time.perf_counter()
        if buf or not stream:
            audio = (np.concatenate(buf) if buf
                     else np.zeros((0,), np.float32))
            yield self._result(audio, seg, token_count,
                               time.perf_counter() - t0, streaming=stream,
                               final=True)

    def _result(self, audio, seg, token_count, dt, streaming=False,
                final=False) -> GenerationResult:
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=seg, token_count=token_count,
            audio_duration=format_duration(dur),
            real_time_factor=round(dur / dt, 3) if dt > 0 else 0.0,
            prompt={"tokens": token_count,
                    "tokens-per-sec": round(token_count / dt, 2)
                    if dt > 0 else 0},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / dt, 2)
                           if dt > 0 else 0},
            processing_time_seconds=dt, peak_memory_usage=peak_memory_gb(),
            is_streaming_chunk=streaming, is_final_chunk=final)

    # ----------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """Kyutai's (MLX or torch) checkpoint -> the port's names: the
        `mimi.` weights through the Mimi's sanitize, the rest as named."""
        from ....codec.models.mimi.mimi import sanitize_mimi

        mimi_w, out = {}, {}
        for k, v in weights.items():
            if k.startswith("mimi."):
                mimi_w[k[len("mimi."):]] = v
            elif k.endswith("speaker_proj_weight"):
                out["speaker_proj_weight"] = np.asarray(v)
            else:
                out[k] = np.asarray(v)
        for k, v in sanitize_mimi(mimi_w, self.mimi.config.seanet).items():
            out[f"mimi.{k}"] = v
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's SentencePiece model (`tokenizer.model` or
        `spm.model`, where `sentencepiece` is installed), else its
        `tokens.json` piece list; a file that fails to load raises."""
        model_path = Path(model_path)
        for name in ("tokenizer.model", "spm.model"):
            f = model_path / name
            if f.exists():
                try:
                    import sentencepiece as spm
                except ImportError:
                    break
                sp = spm.SentencePieceProcessor()
                sp.load(str(f))
                model.tokenizer = _SpTokenizer(sp)
                return model
        tokens = model_path / "tokens.json"
        if tokens.exists():
            model.tokenizer = _PieceTokenizer(json.loads(tokens.read_text()))
        return model


class _SpTokenizer:
    def __init__(self, sp):
        self.sp = sp

    def encode(self, text):
        return self.sp.encode(text, out_type=int)

    def decode(self, ids):
        return self.sp.decode(ids)


class _PieceTokenizer:
    """A piece list (decode-only checkpoints ship tokens.json), encoded by
    the greedy longest piece over the raw characters."""

    def __init__(self, pieces: List[str]):
        self.pieces = pieces
        self.t2i = {p: i for i, p in enumerate(pieces)}

    def encode(self, text):
        ids, i = [], 0
        while i < len(text):
            best = None
            for ln in range(min(12, len(text) - i), 0, -1):
                cand = ("▁" + text[i:i + ln] if (i == 0 or text[i - 1] == " ")
                        else text[i:i + ln])
                if cand in self.t2i:
                    best = (ln, self.t2i[cand])
                    break
            if best is None:
                i += 1
                continue
            ids.append(best[1])
            i += best[0]
        return ids or [0]

    def decode(self, ids):
        return "".join(self.pieces[i] for i in ids
                       if 0 <= i < len(self.pieces)).replace("▁", " ").strip()


# ------------------------------------------------------------ text helpers


def prepare_text_prompt(text: str) -> Tuple[str, int]:
    """Normalise the text and guess frames_after_eos (:665-682)."""
    text = text.strip()
    if text == "":
        raise ValueError("Text prompt cannot be empty")
    text = text.replace("\n", " ").replace("\r", " ").replace("  ", " ")
    guess = 3 if len(text.split()) <= 4 else 1
    if not text[0].isupper():
        text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text = text + "."
    if len(text.split()) < 5:
        text = " " * 8 + text
    return text, guess


def split_into_best_sentences(tokenizer, text: str,
                              max_tokens: int = 50) -> List[str]:
    """Sentences packed into chunks of at most `max_tokens` tokens
    (:685-705)."""
    text, _ = prepare_text_prompt(text)
    text = text.strip()
    sentences = [s.strip() for s in re.split(r"(?<=[.!?])\s+", text)
                 if s.strip()]
    chunks: List[str] = []
    cur, cur_n = "", 0
    for s in sentences:
        n = len(tokenizer.encode(s))
        if not cur:
            cur, cur_n = s, n
        elif cur_n + n > max_tokens:
            chunks.append(cur)
            cur, cur_n = s, n
        else:
            cur, cur_n = cur + " " + s, cur_n + n
    if cur:
        chunks.append(cur)
    return chunks


__all__ = ["Model", "ModelConfig", "FlowLMConfig", "prepare_text_prompt",
           "split_into_best_sentences", "MAX_FRAMES", "PREFILL_BUCKETS"]
