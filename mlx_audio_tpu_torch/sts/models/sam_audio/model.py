"""SAM-Audio: text-guided audio source separation by a flow-matching ODE
over DACVAE latents.

Counterpart of mlx_audio_tpu/sts/models/sam_audio/model.py: `ModelConfig`
(:60), `encode_text` (:130), the velocity and the ODE (`_ode_fn`
:153-205: the DiT's input is [noisy | zeros | audio features] through
`proj` and the anchor embedding, its memory the T5 features through
`memory_proj` plus a sinusoidal embedding of t; euler or midpoint at
`step_size`), `separate` (:209), `separate_long`, `separate_streaming` and
`_stream_chunks` (:297-372: 10-s chunks, 3-s overlap, a cosine
crossfade, `seed + i` a chunk), `_prepare` (:376; anchors), `sanitize`
(:424) and `post_load_hook` (:452).

JAX runs the whole ODE (16 midpoint steps, 32 DiT evaluations at the
defaults) as one `lax.scan`; here it is an eager loop on the device, the
solver state in f32, t a device tensor, and nothing read by the host until
the decoded waveforms. With a `quantization` entry every `Linear` (the
DiT's, T5's, `proj`, `memory_proj` and the anchors' `proj`) runs on kernel
K2; the tables, the scale/shift tables and the convs stay dense.

Departures from the JAX package:
* buckets: JAX pads the features to `FEATURE_BUCKETS` (:48) and decodes
  the whole bucket; the `x_embedder`'s GroupNorm(1) averages over every
  row of the bucket, padding included, and its k = 3 convs read padded
  rows at the edge, so JAX's valid rows depend on the bucket. The port
  runs the frames the audio has: equal to JAX at a bucket length, not
  elsewhere (tests pin both). The text runs at its own length: its
  padding is masked out of T5's attention and the DiT's cross-attention,
  so JAX's `TEXT_BUCKETS` padding changes nothing (a test shows it);
* draws: noise comes from a `torch.Generator` on the model's device seeded
  with `seed` (`_draw_noise`, the seam tests replace), where JAX draws
  `normal(PRNGKey(seed), (B, bucket, 2C))`; a given `noise` is cut to the
  audio's frames;
* `post_load_hook` reads the tokenizer from the model directory only
  (`tts.models.base.local_tokenizer`): a broken tokenizer file raises, and
  without one `encode_text` raises naming the files it looked for. JAX's
  swallows every error, then tries to download `t5-base`, and leaves
  `tokenizer` None, so `encode_text` fails later;
* `sanitize` reads the `x_embedder` convs' layout from their shapes
  (`model.convs_to_wio`), where JAX's takes every 3-D weight whose name
  holds `project`, `to_out` or `x_embedder` for torch's (O, I, K) and so
  misreads an MLX (O, K, I) checkpoint (into (I, K, O), no kernel of the
  model); the codec's part goes through the port's DACVAE `sanitize`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio
from ....nn import Linear
from ....codec.models.dacvae.dacvae import (
    Model as DACVAE, ModelConfig as DACVAEConfig, dacvae_decode,
    dacvae_encode)
from .dit import DiT, EmbedAnchors, TransformerConfig, dit_forward, \
    embed_anchors
from .t5 import T5Config, T5Encoder, sanitize_t5, t5_encode

DFLT_ODE_OPT = {"step_size": 2 / 32, "method": "midpoint"}
ANCHOR_DICT = {"<null>": 0, "+": 1, "-": 2, "<pad>": 3}
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                   "tokenizer.model")


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "sam_audio"
    in_channels: int = 768
    audio_codec: dict = field(default_factory=dict)
    text_encoder: dict = field(default_factory=dict)
    transformer: dict = field(default_factory=dict)
    num_anchors: int = 3
    anchor_embedding_dim: int = 128
    model_path: str = ""

    def __post_init__(self):
        self.codec_cfg = DACVAEConfig.from_dict(self.audio_codec or {})
        self.t5_cfg = T5Config.from_dict(self.text_encoder or {})
        if "dim" in (self.text_encoder or {}):
            self.t5_cfg.d_model = self.text_encoder["dim"]
        self.dit_cfg = TransformerConfig.from_dict(self.transformer or {})


@dataclass
class SeparationResult:
    target: List[np.ndarray]
    residual: List[np.ndarray]
    noise: Optional[np.ndarray] = None
    peak_memory: float = 0.0


class Model(TorchModel):
    """SAM-Audio on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`. `separate`,
    `separate_long` and `separate_streaming` as in the JAX package;
    `tokenizer` must be set (or loaded by `post_load_hook`) before a
    description is encoded."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        c = config
        self.audio_codec = DACVAE(c.codec_cfg, device=device)
        with torch.device(device):
            self.text_encoder = T5Encoder(c.t5_cfg)
            self.transformer = DiT(c.dit_cfg)
            self.proj = Linear(c.in_channels, c.dit_cfg.dim)
            self.embed_anchors = EmbedAnchors(
                c.num_anchors, c.anchor_embedding_dim, c.dit_cfg.dim)
            self.memory_proj = Linear(c.t5_cfg.d_model, c.dit_cfg.dim)
        self.tokenizer = None
        self.last_run: Dict[str, Any] = {}
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        """`TorchModel.init_params`, then the DiT's scale/shift tables
        N(0, 1 / dim) as the JAX package's `init_dit` draws them, from a
        generator seeded `seed + 1` (on the CPU in f32, or with `on_device`
        on the tables' device in their dtype)."""
        super().init_params(seed, on_device)
        dit = self.transformer
        tables = [lp.scale_shift_table for lp in dit.layers]
        tables.append(dit.final_layer_scale_shift_table)
        dev = tables[0].device if on_device else torch.device("cpu")
        dtype = tables[0].dtype if on_device else torch.float32
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        for t in tables:
            t.copy_(torch.randn(t.shape, generator=g, device=dev, dtype=dtype)
                    * t.shape[1] ** -0.5)
        return self

    @property
    def sample_rate(self) -> int:
        return self.config.codec_cfg.sample_rate

    @property
    def hop_length(self) -> int:
        return self.config.codec_cfg.hop_length

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer.norm.weight.dtype

    def wav_idx_to_feature_idx(self, n: int) -> int:
        return math.ceil(n / self.hop_length)

    def feature_idx_to_wav_idx(self, n: int) -> int:
        return int(n) * self.hop_length

    # -- text --------------------------------------------------------------

    @torch.no_grad()
    def encode_text(self, descriptions: List[str]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """texts -> (T5 features (B, L, d), bool mask (B, L)) at the
        tokenizer's longest length."""
        if self.tokenizer is None:
            where = self.config.model_path or "the model directory"
            raise RuntimeError(
                f"SAM-Audio has no T5 tokenizer: none of "
                f"{', '.join(TOKENIZER_FILES)} was found in {where}; set "
                f"model.tokenizer")
        enc = self.tokenizer(descriptions, truncation=True, max_length=512,
                             padding="longest", return_tensors="np")
        ids = torch.as_tensor(np.asarray(enc["input_ids"], np.int64),
                              device=self.device)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"], np.int64),
                               device=self.device)
        return t5_encode(self.text_encoder, ids, mask), mask > 0

    # -- the ODE -----------------------------------------------------------

    def velocity(self, noisy, audio_features, text_features, t, text_mask,
                 anchor_ids, anchor_alignment, pad_mask) -> torch.Tensor:
        """The DiT's velocity at time t (a 0-d f32 tensor) -> (B, T, 2C) in
        the model's dtype."""
        dt = self.dtype
        x = torch.cat([noisy.to(dt), torch.zeros_like(audio_features),
                       audio_features], dim=2)
        aligned = embed_anchors(self.embed_anchors, self.proj(x), anchor_ids,
                                anchor_alignment)
        b = noisy.shape[0]
        tt = t.expand(b)
        half = self.config.dit_cfg.dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, dtype=torch.float32, device=noisy.device) / half)
        ang = tt[:, None] * freqs[None]
        t_emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        memory = self.memory_proj(text_features) + t_emb[:, None].to(dt)
        return dit_forward(self.transformer, aligned, tt, padding_mask=pad_mask,
                           memory=memory, memory_padding_mask=text_mask)

    def ode(self, noise, audio_features, text_features, text_mask,
            anchor_ids, anchor_alignment, pad_mask, num_steps: int,
            method: str) -> torch.Tensor:
        """Euler or midpoint from t = 0 over `num_steps` steps of 1 /
        num_steps, the state in f32 -> (B, T, 2C) f32."""
        dt = 1.0 / num_steps
        ts = torch.arange(num_steps, dtype=torch.float32,
                          device=noise.device) * dt
        x = noise.float()
        args = (audio_features, text_features)
        rest = (text_mask, anchor_ids, anchor_alignment, pad_mask)
        for i in range(num_steps):
            v1 = self.velocity(x, *args, ts[i], *rest).float()
            if method == "euler":
                x = x + dt * v1
                continue
            mid = x + 0.5 * dt * v1
            v2 = self.velocity(mid, *args, ts[i] + 0.5 * dt, *rest).float()
            x = x + dt * v2
        return x

    def _draw_noise(self, shape, seed: int) -> torch.Tensor:
        """N(0, 1) f32 of `shape` on the model's device, from a generator
        there seeded with `seed`."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randn(shape, generator=g, device=self.device)

    # -- separation --------------------------------------------------------

    @torch.no_grad()
    def separate(self, audios, descriptions: List[str],
                 sizes: Optional[np.ndarray] = None,
                 anchors: Optional[List[List[Tuple[str, float, float]]]] = None,
                 noise: Optional[np.ndarray] = None,
                 ode_opt: Optional[Dict[str, Any]] = None, seed: int = 0,
                 _text_features=None, _text_mask=None,
                 **kwargs) -> SeparationResult:
        """Text-guided separation of (B, 1, T) audio (or paths, (T,) or
        (B, T)) -> the target and residual waveforms, (n, 1) each."""
        audios, sizes, anchor_ids, anchor_alignment = self._prepare(
            audios, descriptions, anchors, sizes)
        ode_opt = dict(DFLT_ODE_OPT, **(ode_opt or {}))
        step_size = ode_opt["step_size"]
        if not 0 < step_size < 1:
            raise ValueError(f"step_size {step_size} must be in (0, 1)")
        num_steps = int(1.0 / step_size)
        method = ode_opt.get("method", "midpoint")
        dev, dt = self.device, self.dtype
        b = audios.shape[0]
        wav = torch.as_tensor(np.transpose(audios, (0, 2, 1)), device=dev)
        pad = (-wav.shape[1]) % self.hop_length
        if pad:
            wav = torch.nn.functional.pad(wav, (0, 0, 0, pad))
        feats = dacvae_encode(self.audio_codec, wav.to(dt)).transpose(1, 2)
        feats = torch.cat([feats, feats], dim=2)            # (B, T, 2C)
        t_feat = feats.shape[1]
        if sizes is None:
            sizes = np.full((b,), t_feat, np.int64)
        pad_mask = torch.arange(t_feat, device=dev)[None, :] < torch.as_tensor(
            np.asarray(sizes, np.int64), device=dev)[:, None]
        if anchor_alignment is not None:
            anchor_alignment = torch.as_tensor(anchor_alignment, device=dev)
            anchor_ids = torch.as_tensor(anchor_ids, device=dev)
        if _text_features is not None:
            text_features, text_mask = _text_features, _text_mask
        else:
            text_features, text_mask = self.encode_text(descriptions)
        if noise is None:
            noise = self._draw_noise(tuple(feats.shape), seed)
        else:
            noise = torch.as_tensor(np.array(noise, np.float32),
                                    device=dev)[:, :t_feat]
        # a mask that keeps every key changes nothing: left out
        if (np.asarray(sizes) >= t_feat).all():
            pad_mask = None
        if text_mask is not None and bool(text_mask.all()):
            text_mask = None
        generated = self.ode(noise, feats, text_features, text_mask,
                             anchor_ids, anchor_alignment, pad_mask,
                             num_steps, method)
        c = self.config.codec_cfg.codebook_dim
        both = dacvae_decode(self.audio_codec, torch.cat(
            [generated[..., :c], generated[..., c:]], dim=0).to(dt))
        both = both.float().cpu().numpy()
        self.last_run = {"frames": t_feat, "text_len": text_features.shape[1],
                         "steps": num_steps, "method": method,
                         "evals": num_steps * (1 if method == "euler" else 2)}
        target, residual = [], []
        for i in range(b):
            n = self.feature_idx_to_wav_idx(int(sizes[i]))
            target.append(both[i, :n])
            residual.append(both[b + i, :n])
        return SeparationResult(target=target, residual=residual,
                                noise=noise.cpu().numpy())

    def separate_long(self, audios, descriptions: List[str],
                      chunk_seconds: float = 10.0,
                      overlap_seconds: float = 3.0,
                      ode_opt: Optional[Dict[str, Any]] = None,
                      seed: int = 42, verbose: bool = False,
                      **kwargs) -> SeparationResult:
        """Chunked separation with a cosine crossfade."""
        chunks = list(self._stream_chunks(audios, descriptions,
                                          chunk_seconds, overlap_seconds,
                                          ode_opt, seed))
        return SeparationResult(
            target=[np.concatenate([c[0] for c in chunks], axis=0)],
            residual=[np.concatenate([c[1] for c in chunks], axis=0)])

    def separate_streaming(self, audios, descriptions: List[str],
                           chunk_seconds: float = 10.0,
                           overlap_seconds: float = 3.0,
                           ode_opt: Optional[Dict[str, Any]] = None,
                           seed: int = 42, verbose: bool = False,
                           **kwargs) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        """Yield (target, residual) chunks as they are separated."""
        yield from self._stream_chunks(audios, descriptions, chunk_seconds,
                                       overlap_seconds, ode_opt, seed)

    def _stream_chunks(self, audios, descriptions, chunk_seconds,
                       overlap_seconds, ode_opt, seed):
        audios, _, _, _ = self._prepare(audios, descriptions, None, None)
        if audios.shape[0] != 1:
            raise ValueError("long/streaming separation supports batch=1")
        sr = self.sample_rate
        chunk_n = int(chunk_seconds * sr)
        overlap_n = int(overlap_seconds * sr)
        hop_n = chunk_n - overlap_n
        total = audios.shape[2]
        if total <= chunk_n:
            res = self.separate(audios, descriptions, ode_opt=ode_opt,
                                seed=seed)
            yield res.target[0], res.residual[0]
            return
        text_features, text_mask = self.encode_text(descriptions)
        num_chunks = math.ceil((total - overlap_n) / hop_n)
        prev_t = prev_r = None
        for i in range(num_chunks):
            start = i * hop_n
            end = min(start + chunk_n, total)
            res = self.separate(audios[:, :, start:end], descriptions,
                                ode_opt=ode_opt, seed=seed + i,
                                _text_features=text_features,
                                _text_mask=text_mask)
            t_c, r_c = res.target[0], res.residual[0]
            if prev_t is not None and overlap_n > 0:
                ov = min(overlap_n, len(prev_t), len(t_c))
                w = 0.5 * (1 - np.cos(
                    math.pi * np.linspace(0, 1, ov)))[:, None]
                head_t = prev_t[-ov:] * (1 - w) + t_c[:ov] * w
                head_r = prev_r[-ov:] * (1 - w) + r_c[:ov] * w
                yield (np.concatenate([prev_t[:-ov], head_t]),
                       np.concatenate([prev_r[:-ov], head_r]))
                prev_t, prev_r = t_c[ov:], r_c[ov:]
            else:
                prev_t, prev_r = t_c, r_c
        if prev_t is not None:
            yield prev_t, prev_r

    def _prepare(self, audios, descriptions, anchors, sizes):
        """Audio as (B, 1, T) float32 (paths read and mono-mixed at the
        model's rate, their sizes in frames) and the anchors' ids and
        per-frame alignment (host numpy, as the JAX package's)."""
        if isinstance(audios, (list, tuple)) and audios \
                and isinstance(audios[0], (str, Path)):
            from ....utils import load_audio

            waves = [load_audio(str(p), self.sample_rate) for p in audios]
            arr = np.zeros((len(waves), 1, max(len(w) for w in waves)),
                           np.float32)
            for i, w in enumerate(waves):
                arr[i, 0, :len(w)] = w
            audios = arr
            sizes = np.asarray([self.wav_idx_to_feature_idx(len(w))
                                for w in waves])
        else:
            audios = np.asarray(audios, np.float32)
            if audios.ndim == 1:
                audios = audios[None, None]
            elif audios.ndim == 2:
                audios = audios[:, None]
        anchor_ids = anchor_alignment = None
        if anchors is not None:
            b = audios.shape[0]
            t_feat = self.wav_idx_to_feature_idx(audios.shape[2])
            alignment = np.zeros((b, t_feat), np.int64)
            all_ids = []
            for i, spans in enumerate(anchors):
                current = [ANCHOR_DICT["<null>"], ANCHOR_DICT["<pad>"]]
                for token, start_s, end_s in spans:
                    s = self.wav_idx_to_feature_idx(
                        int(start_s * self.sample_rate))
                    e = self.wav_idx_to_feature_idx(
                        int(end_s * self.sample_rate))
                    alignment[i, s:min(e, t_feat)] = len(current)
                    current.append(ANCHOR_DICT.get(token, 0))
                all_ids.append(current)
            width = max(len(x) for x in all_ids)
            anchor_ids = np.asarray(
                [x + [ANCHOR_DICT["<pad>"]] * (width - len(x))
                 for x in all_ids], np.int64)
            anchor_alignment = alignment
        return audios, sizes, anchor_ids, anchor_alignment

    # -- loading -----------------------------------------------------------

    def sanitize(self, weights: Dict) -> Dict:
        """A SAM-Audio checkpoint -> the JAX tree: `audio_codec.*` through
        the DACVAE's `sanitize`, `text_encoder.*` through `sanitize_t5`,
        the `x_embedder` convs read into WIO from the layout their shapes
        show, the rest as named."""
        codec_w, rest = {}, {}
        for k, v in weights.items():
            if k.startswith("audio_codec."):
                codec_w[k[len("audio_codec."):]] = v
            elif not k.startswith("text_encoder."):
                rest[k] = np.asarray(v)
        out = {f"audio_codec.{k}": v
               for k, v in self.audio_codec.sanitize(codec_w).items()}
        out.update(sanitize_t5(weights, prefix="text_encoder."))
        shapes = {n: tuple(p.shape) for n, p in self.named_parameters()
                  if p.ndim == 3}
        out.update(convs_to_wio(rest, shapes,
                                lambda k, v: np.ndim(v) == 3))
        return out

    @classmethod
    def post_load_hook(cls, model: "Model", model_path) -> "Model":
        """The T5 tokenizer saved in the model directory, never
        downloaded (None without one: `encode_text` then raises)."""
        from ....tts.models.base import local_tokenizer

        model.config.model_path = str(model_path)
        model.tokenizer = local_tokenizer(model_path)
        return model


SAMAudio = Model

__all__ = ["Model", "ModelConfig", "SAMAudio", "SeparationResult",
           "ANCHOR_DICT", "DFLT_ODE_OPT"]
