"""VibeVoice: streaming TTS with a split Qwen2 LM and a diffusion head; and
the pieces KugelAudio shares with it.

Counterpart of mlx_audio_tpu/tts/models/vibevoice/vibevoice.py:

* `_llama_cfg` (:59-67): the Qwen2 decoder as a llama backbone config
  (q/k/v biases);
* `DiffusionHead` and `head_forward` (:170-199): the adaLN diffusion head
  (timestep embedding, per-layer shift/scale/gate, a final modulated
  norm), with parameter names the JAX tree's (`noisy_images_proj`,
  `t_embedder.mlp.{0,2}`, `layers.N.adaLN_modulation.1`, ...);
  `DiffusionHead.cond_embed` and `t_embed` split out what stays fixed over
  a latent's solver steps (cond_proj) or over a request (the timestep
  embeddings), so a sampler computes them once;
* `diffusion_sample` (:202-229): DPM-Solver++ (the ODE multistep solver)
  under classifier-free guidance, reading `scheduler.dpm_tables` as host
  floats, one eager head pass a step;
* `VAEDecoder` and `decode_latents` (:234-264): the causal acoustic
  decoder (depthwise causal convs, GELU FFNs, layer-scale gammas,
  conv-transposes with the causal right-trim);
* `Model` (:269-614): the lower text LM (no final norm) and the upper TTS
  LM as one b = 2 CFG batch over shared f32 caches, text windows of 5 and
  speech windows of 6 tokens, the EOS classifier, voice caches
  (`load_voice`), `_generate_multi`, `sanitize` (torch-layout
  checkpoints) and `post_load_hook`.

Departures from the JAX package, each pinned by a test in
tests/test_torch_vibevoice.py:

* a speech window's steps run on the device with no read in between; the
  host reads the window's EOS flags once and keeps the latents up to the
  first EOS. Steps past it run and are dropped, so the kept latents are
  JAX's;
* the draws come from a torch.Generator, one (steps, 1, latent) noise
  tensor a window (`_draws`, the seam a test uses to feed JAX's draws);
* a bf16 model computes in bf16 (JAX promotes the diffusion head and the
  connector to f32 against its f32 sampler state): the solver state, the
  guidance and the VAE stay f32;
* `post_load_hook` reads a tokenizer from the model directory only, and
  raises where the files are there but do not load. JAX swallows every
  failure and falls back to downloading Qwen/Qwen2.5-0.5B;
* `sanitize` takes the published checkpoint's torch conv layouts as the
  port's own; the JAX package converts them to its WIO layouts.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....model import TorchModel, check_device, holder
from ....nn import (Conv1d, ConvTranspose1d, Embedding, Linear, RMSNorm,
                    gelu)
from ....ops.kvcache import KVCache
from ..base import GenerationResult, format_duration, local_tokenizer
from ..llama.llama import Model as LlamaModel
from ..llama.llama import ModelConfig as LlamaConfig
from ..llama.llama import llama_forward
from .config import (AcousticTokenizerConfig, DiffusionHeadConfig,
                     ModelConfig, Qwen2DecoderConfig)
from .scheduler import dpm_tables

TTS_TEXT_WINDOW_SIZE = 5
TTS_SPEECH_WINDOW_SIZE = 6
LATENT_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _llama_cfg(d: Qwen2DecoderConfig, n_layers: int,
               vocab_size: Optional[int] = None) -> LlamaConfig:
    return LlamaConfig(
        model_type="qwen2", hidden_size=d.hidden_size,
        num_hidden_layers=n_layers, intermediate_size=d.intermediate_size,
        num_attention_heads=d.num_attention_heads,
        num_key_value_heads=d.num_key_value_heads,
        vocab_size=vocab_size or d.vocab_size,
        rms_norm_eps=d.rms_norm_eps, rope_theta=d.rope_theta,
        head_dim=d.head_dim, attention_bias=True,   # qwen2: biased qkv
        logits_scaling=d.logits_scaling)


def _bucket(n: int, buckets, step: int) -> int:
    """The smallest bucket that holds n, past the last a multiple of
    `step`."""
    return next((b for b in buckets if n <= b), -(-n // step) * step)


# --------------------------------------------------------- diffusion head


def _modulation(hidden: int, n: int) -> nn.Module:
    return holder(**{"1": Linear(hidden, n * hidden, bias=False)})


class HeadLayer(nn.Module):
    def __init__(self, dh: DiffusionHeadConfig):
        super().__init__()
        h = dh.hidden_size
        ffn = int(h * dh.head_ffn_ratio)
        self.ffn = holder(gate_proj=Linear(h, ffn, bias=False),
                          up_proj=Linear(h, ffn, bias=False),
                          down_proj=Linear(ffn, h, bias=False))
        self.norm = RMSNorm(h, dh.rms_norm_eps)
        self.adaLN_modulation = _modulation(h, 3)


class DiffusionHead(nn.Module):
    """The prediction head: (B, latent), (B,), (B, cond) -> v (B, latent).
    It computes in the dtype of its parameters."""

    def __init__(self, dh: DiffusionHeadConfig, cond_dim: int):
        super().__init__()
        self.cfg = dh
        h = dh.hidden_size
        self.noisy_images_proj = Linear(dh.latent_size, h, bias=False)
        self.cond_proj = Linear(cond_dim, h, bias=False)
        self.t_embedder = holder(mlp=holder(**{
            "0": Linear(dh.freq_embed_size, h, bias=False),
            "2": Linear(h, h, bias=False)}))
        self.layers = nn.ModuleList(HeadLayer(dh)
                                    for _ in range(dh.head_layers))
        self.final_layer = holder(linear=Linear(h, dh.latent_size, bias=False),
                                  adaLN_modulation=_modulation(h, 2))

    @property
    def dtype(self) -> torch.dtype:
        return self.layers[0].norm.weight.dtype

    def cond_embed(self, cond: torch.Tensor) -> torch.Tensor:
        """cond_proj(cond): fixed over a latent's solver steps."""
        return self.cond_proj(cond.to(self.dtype))

    def t_embed(self, t: torch.Tensor) -> torch.Tensor:
        """(N,) timesteps -> (N, hidden): the sinusoidal embedding in f32,
        then the MLP."""
        half = self.cfg.freq_embed_size // 2
        freqs = torch.exp(-float(np.log(10000.0)) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        mlp = self.t_embedder.mlp
        return getattr(mlp, "2")(F.silu(getattr(mlp, "0")(emb.to(self.dtype))))

    def run(self, x_lat: torch.Tensor, temb: torch.Tensor,
            cond_h: torch.Tensor) -> torch.Tensor:
        """The head on noisy latents (B, latent) given the timestep
        embeddings (B or 1, hidden) and cond_embed(cond) (B, hidden)."""
        eps = self.cfg.rms_norm_eps
        x = self.noisy_images_proj(x_lat.to(self.dtype))
        c_act = F.silu(cond_h + temb)
        for layer in self.layers:
            shift, scale, gate = getattr(layer.adaLN_modulation, "1")(
                c_act).chunk(3, dim=-1)
            hn = layer.norm(x) * (1 + scale) + shift
            f = layer.ffn
            x = x + gate * f.down_proj(F.silu(f.gate_proj(hn)) * f.up_proj(hn))
        fl = self.final_layer
        shift, scale = getattr(fl.adaLN_modulation, "1")(c_act).chunk(2, dim=-1)
        xn = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
        return fl.linear(xn * (1 + scale) + shift)


def head_forward(head: DiffusionHead, x_lat: torch.Tensor, t: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor:
    """(B, latent), (B,), (B, hidden) -> v prediction (B, latent)."""
    return head.run(x_lat, head.t_embed(t), head.cond_embed(cond))


def diffusion_sample(head: DiffusionHead, cond: torch.Tensor,
                     neg_cond: torch.Tensor, noise: torch.Tensor,
                     tables: Dict[str, np.ndarray], cfg_scale: float,
                     temb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample latents (B, latent) by DPM-Solver++ from `noise` (B, latent)
    under guidance against neg_cond; `tables` from scheduler.dpm_tables,
    `temb` their t_embed (computed here when None). The solver state is
    f32; each step is one head pass over the 2B rows."""
    b = cond.shape[0]
    if temb is None:
        temb = head.t_embed(torch.from_numpy(tables["t"]).to(noise.device))
    cond_h = head.cond_embed(torch.cat([cond, neg_cond], dim=0))
    speech = noise.float()
    prev_x0 = torch.zeros_like(speech)
    for k in range(len(tables["t"])):
        tab = {name: float(v[k]) for name, v in tables.items()}
        eps = head.run(torch.cat([speech, speech], dim=0), temb[k:k + 1],
                       cond_h).float()
        guided = eps[b:] + cfg_scale * (eps[:b] - eps[b:])
        x0 = tab["alpha"] * speech - tab["sigma"] * guided
        step = tab["alpha_next"] * tab["em1"]
        first = tab["sigma_ratio"] * speech - step * x0
        if tab["use_first"] > 0:
            speech = first
        else:
            speech = first - 0.5 * step * (tab["inv_r0"] * (x0 - prev_x0))
        prev_x0 = x0
    return speech


# --------------------------------------------------------- VAE decoder


def _nest(*names: str, leaf: nn.Module) -> nn.Module:
    """holder(a=holder(b=...leaf)) for names (a, b, ...)."""
    for name in reversed(names):
        leaf = holder(**{name: leaf})
    return leaf


class VAEBlock(nn.Module):
    def __init__(self, dim: int, a: AcousticTokenizerConfig):
        super().__init__()
        self.norm = RMSNorm(dim, a.layernorm_eps)
        self.ffn_norm = RMSNorm(dim, a.layernorm_eps)
        self.mixer = _nest("conv", "conv", leaf=holder(conv=Conv1d(
            dim, dim, a.mixer_kernel, bias=a.conv_bias, groups=dim)))
        self.ffn = holder(linear1=Linear(dim, 4 * dim),
                          linear2=Linear(4 * dim, dim))
        self.gamma = nn.Parameter(torch.empty(dim))
        self.ffn_gamma = nn.Parameter(torch.empty(dim))
        self.init_fill = {"gamma": a.layer_scale_init_value,
                          "ffn_gamma": a.layer_scale_init_value}


class VAEDecoder(nn.Module):
    """The acoustic tokenizer's decoder: (B, L, vae_dim) -> (B, L*hop)."""

    def __init__(self, a: AcousticTokenizerConfig):
        super().__init__()
        self.cfg = a
        depths, ratios, km = a.depths, a.ratios, a.mixer_kernel
        n = len(depths)
        nf = a.decoder_n_filters or a.encoder_n_filters
        ups = [_nest("0", "conv", leaf=holder(conv=Conv1d(
            a.vae_dim, nf * 2 ** (n - 1), km, bias=a.conv_bias)))]
        for i, r in enumerate(ratios):
            in_ch = nf * 2 ** (n - 1 - i)
            out_ch = nf * 2 ** (n - 2 - i) if i < len(ratios) - 1 else nf
            ups.append(_nest("0", "convtr", leaf=holder(convtr=ConvTranspose1d(
                in_ch, out_ch, 2 * r, bias=a.conv_bias))))
        self.upsample_layers = nn.ModuleList(ups)
        self.stages = nn.ModuleList(
            nn.ModuleList(VAEBlock(nf * 2 ** (n - 1 - i), a)
                          for _ in range(depths[i])) for i in range(n))
        self.head = _nest("conv", leaf=holder(conv=Conv1d(
            nf, a.channels, km, bias=a.conv_bias)))


def decode_latents(dec: VAEDecoder, x: torch.Tensor) -> torch.Tensor:
    """(B, L, vae_dim) latents -> (B, L*hop) audio, fully causal, in x's
    dtype (parameters are cast at use)."""
    a = dec.cfg
    pad = (a.mixer_kernel - 1, 0)
    first = getattr(dec.upsample_layers[0], "0")
    x = first.conv.conv(x, padding=pad)
    for i, blocks in enumerate(dec.stages):
        for blk in blocks:
            h = blk.mixer.conv.conv.conv(blk.norm(x), padding=pad)
            x = x + blk.gamma.to(x.dtype) * h
            h = blk.ffn.linear2(gelu(blk.ffn.linear1(blk.ffn_norm(x))))
            x = x + blk.ffn_gamma.to(x.dtype) * h
        if i < len(a.ratios):
            r = a.ratios[i]
            up = getattr(dec.upsample_layers[i + 1], "0").convtr.convtr
            x = up(x, stride=r)
            x = x[:, : x.shape[1] - r]          # causal right-trim (k - s)
    return dec.head.conv.conv(x, padding=pad)[..., 0]


# ---------------------------------------------------------------- model


def add_speech_factors(module: nn.Module) -> None:
    """The latent rescaling scalars speech_scaling_factor (init 1) and
    speech_bias_factor (init 0), as parameters of `module`."""
    module.speech_scaling_factor = nn.Parameter(torch.ones(()))
    module.speech_bias_factor = nn.Parameter(torch.zeros(()))
    module.init_fill = {"speech_scaling_factor": 1.0,
                        "speech_bias_factor": 0.0}


class Model(TorchModel):
    """VibeVoice on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`. Needs a tokenizer
    (`post_load_hook`, or any object with `encode(text,
    add_special_tokens=False)`) before `generate`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        d = config.decoder_config
        h = d.hidden_size
        lm_cfg, tts_cfg = self._cfgs()
        with torch.device(device):
            self.language_model = LlamaModel(lm_cfg, device, final_norm=False,
                                             lm_head=False)
            self.tts_language_model = LlamaModel(tts_cfg, device, embed=False,
                                                 lm_head=False)
            self.tts_input_types = Embedding(2, h)
            self.acoustic_connector = holder(
                fc1=Linear(config.acoustic_vae_dim, h),
                norm=RMSNorm(h, 1e-6), fc2=Linear(h, h))
            self.prediction_head = DiffusionHead(
                config.diffusion_head_config, h)
            self.tts_eos_classifier = holder(fc1=Linear(h, h),
                                             fc2=Linear(h, 1))
            self.acoustic_tokenizer = holder(decoder=VAEDecoder(
                config.acoustic_tokenizer_config))
            add_speech_factors(self)
        self.requires_grad_(False)
        self.eval()
        self.tokenizer = None
        self._voice_path: Optional[str] = None
        self._voice: Optional[dict] = None
        self.last_run: Dict[str, int] = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def _cfgs(self) -> Tuple[LlamaConfig, LlamaConfig]:
        d = self.config.decoder_config
        tts = self.config.tts_backbone_num_hidden_layers
        return (_llama_cfg(d, d.num_hidden_layers - tts),
                _llama_cfg(d, tts, vocab_size=8))

    # ------------------------------------------------------------ voices

    def load_voice(self, voice: Union[str, Path]) -> None:
        """Load a voice cache (precomputed LM/TTS-LM K/V and hidden
        tails) from a .safetensors file, or voices/<name>.safetensors in
        the model directory; K/V stored (B, kv heads, S, head dim) go to
        the cache's (B, S, kv heads, head dim)."""
        vp = Path(str(voice))
        if not vp.exists():
            vp = Path(self.config.model_path or ".") / "voices" / \
                f"{voice}.safetensors"
        if not vp.exists():
            raise FileNotFoundError(f"Voice cache not found: {vp}")
        from safetensors.numpy import load_file

        t = load_file(str(vp))

        def kv(prefix, i):
            k, v = t[f"{prefix}_key_{i}"], t[f"{prefix}_value_{i}"]
            if k.ndim == 4 and k.shape[1] != k.shape[2]:
                k = k.transpose(0, 2, 1, 3)
                v = v.transpose(0, 2, 1, 3)
            return k, v

        lm_cfg, tts_cfg = self._cfgs()
        voice = {
            "lm_hidden": t["lm_hidden"],
            "tts_hidden": t["tts_lm_hidden"],
            "neg_tts_hidden": t["neg_tts_lm_hidden"],
            "lm_kv": [kv("lm", i) for i in range(lm_cfg.num_hidden_layers)],
            "tts_kv": [kv("tts_lm", i)
                       for i in range(tts_cfg.num_hidden_layers)],
            "neg_tts_kv": [kv("neg_tts_lm", i)
                           for i in range(tts_cfg.num_hidden_layers)],
        }
        if voice["tts_kv"][0][0].shape[1] != \
                voice["neg_tts_kv"][0][0].shape[1]:
            raise ValueError("voice cache pos/neg TTS lengths differ")
        self._voice = voice
        self._voice_path = str(vp)

    def _init_caches(self, cfg: LlamaConfig, batch: int, cap: int,
                     kvs: Optional[list]) -> Tuple[KVCache, int]:
        """f32 caches of `cap` columns, rows filled from a voice's K/V (one
        (k, v) per layer, or a list of them, one per row); -> (caches,
        columns written)."""
        caches = KVCache.init(batch, cap, cfg.num_key_value_heads,
                              cfg.resolved_head_dim, torch.float32,
                              self.device, n_layers=cfg.num_hidden_layers)
        off = 0
        for i, rows in enumerate(kvs or ()):
            rows = rows if isinstance(rows, list) else [rows]
            for r, (rk, rv) in enumerate(rows):
                n = rk.shape[1]
                caches.k[i, r:r + 1, :n] = torch.from_numpy(np.asarray(rk))
                caches.v[i, r:r + 1, :n] = torch.from_numpy(np.asarray(rv))
                off = n
        return caches, off

    # ------------------------------------------------------------ pieces

    def _dtype(self) -> torch.dtype:
        return self.tts_input_types.weight.dtype

    def _draws(self, generator: torch.Generator, start: int, n: int,
               shape: Tuple[int, ...]) -> torch.Tensor:
        """(n, *shape) standard normal f32 draws for the latents start ..
        start + n - 1 (a test replaces this to feed JAX's draws)."""
        del start
        return torch.randn((n,) + tuple(shape), generator=generator,
                           device=self.device)

    def _connector(self, latent: torch.Tensor) -> torch.Tensor:
        c = self.acoustic_connector
        return c.fc2(c.norm(c.fc1(latent.to(self._dtype()))))

    def _text_window(self, tokens, w, lm_caches, tts_caches, lm_off,
                     tts_off):
        """A text window of up to 5 tokens through the text LM, then both
        CFG rows (text hidden, zeros) through the TTS LM; -> the last real
        column's (pos, neg) hidden."""
        lm_h, _ = llama_forward(self.language_model, tokens, caches=lm_caches,
                                offset=lm_off, final_norm=False)
        ttype = self.tts_input_types.weight[1]
        x2 = torch.cat([lm_h + ttype, torch.zeros_like(lm_h) + ttype], dim=0)
        h2, _ = llama_forward(self.tts_language_model, x2, caches=tts_caches,
                              offset=tts_off)
        last = h2[:, w - 1]
        return last[0:1], last[1:2]

    def _speech_step(self, tts_caches, pos_cond, neg_cond, tts_off, noise,
                     tables, temb, cfg_scale):
        """One latent: the DPM-Solver++ sample, its embedding into both
        CFG rows of the TTS LM, the EOS probability. Nothing is read on the
        host."""
        latent = diffusion_sample(self.prediction_head, pos_cond, neg_cond,
                                  noise, tables, cfg_scale, temb)
        e = self._connector(latent) + self.tts_input_types.weight[0]
        h2, _ = llama_forward(self.tts_language_model,
                              e[None].expand(2, 1, e.shape[-1]),
                              caches=tts_caches, offset=tts_off)
        cl = self.tts_eos_classifier
        eos = torch.sigmoid(cl.fc2(F.relu(cl.fc1(h2[0, 0]))))[0]
        return latent, h2[0:1, 0], h2[1:2, 0], eos

    def _decode(self, latents: torch.Tensor) -> np.ndarray:
        """(L, vae_dim) latents -> audio (L * hop,): rescaled, padded to a
        length bucket (the decoder is causal, so the prefix is the tight
        decode's) and decoded in f32."""
        n = latents.shape[0]
        b = _bucket(n, LATENT_BUCKETS, 256)
        seq = F.pad(latents.float(), (0, 0, 0, b - n))[None]
        seq = seq / self.speech_scaling_factor.float() \
            - self.speech_bias_factor.float()
        hop = self.config.acoustic_tokenizer_config.hop_length
        audio = decode_latents(self.acoustic_tokenizer.decoder, seq)
        return audio[0, :n * hop].cpu().numpy()

    # ---------------------------------------------------------- generate

    def generate(self, text: Union[str, List[str]], max_tokens: int = 512,
                 cfg_scale: float = 1.5, ddpm_steps: Optional[int] = None,
                 voice: Optional[Union[str, Path, List]] = None,
                 verbose: bool = False, seed: int = 0, **kwargs):
        if self.tokenizer is None:
            raise RuntimeError(
                "vibevoice needs its HF tokenizer (Qwen2.5); place "
                "tokenizer files in the model directory")
        if isinstance(text, list) and isinstance(voice, list):
            yield from self._generate_multi(list(zip(voice, text)),
                                            max_tokens, cfg_scale,
                                            ddpm_steps, seed)
            return
        if voice is not None and str(voice) != self._voice_path:
            self.load_voice(voice)
        yield self._generate_single(text, max_tokens, cfg_scale, ddpm_steps,
                                    seed)

    def _generate_multi(self, dialogue, max_tokens, cfg_scale, ddpm_steps,
                        seed):
        t0 = time.perf_counter()
        parts, total = [], 0
        for idx, (vname, seg) in enumerate(dialogue):
            self.load_voice(vname)
            r = self._generate_single(seg, max_tokens, cfg_scale, ddpm_steps,
                                      seed + idx)
            parts.append(r.audio)
            total += r.token_count
        audio = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        yield self._result(audio, total, time.perf_counter() - t0)

    @torch.no_grad()
    def _generate_single(self, text: str, max_tokens: int, cfg_scale: float,
                         ddpm_steps: Optional[int], seed: int
                         ) -> GenerationResult:
        cfg = self.config
        dh = cfg.diffusion_head_config
        steps = ddpm_steps or dh.ddpm_num_inference_steps
        t0 = time.perf_counter()
        dev = self.device
        ids = self.tokenizer.encode(text.strip() + "\n",
                                    add_special_tokens=False)
        n = len(ids)
        lm_cfg, tts_cfg = self._cfgs()
        W, S = TTS_TEXT_WINDOW_SIZE, TTS_SPEECH_WINDOW_SIZE
        v = self._voice
        v_lm = v["lm_kv"][0][0].shape[1] if v else 0
        v_tts = v["tts_kv"][0][0].shape[1] if v else 0
        lm_cap = -(-(v_lm + n + W + 1) // 128) * 128
        tts_cap = -(-(v_tts + n + W + max_tokens + S + 1) // 256) * 256
        lm_caches, lm_off = self._init_caches(
            lm_cfg, 1, lm_cap, v["lm_kv"] if v else None)
        tts_caches, tts_off = self._init_caches(
            tts_cfg, 2, tts_cap,
            [[pk, nk] for pk, nk in zip(v["tts_kv"], v["neg_tts_kv"])]
            if v else None)
        dt = self._dtype()
        pos_cond = neg_cond = None
        if v:
            pos_cond = torch.from_numpy(v["tts_hidden"][:, -1]).to(dev, dt)
            neg_cond = torch.from_numpy(v["neg_tts_hidden"][:, -1]).to(dev,
                                                                       dt)
        tables = dpm_tables(dh.ddpm_num_steps, steps, dh.ddpm_beta_schedule)
        temb = self.prediction_head.t_embed(
            torch.from_numpy(tables["t"]).to(dev))
        gen = torch.Generator(device=dev).manual_seed(seed)
        latents: List[torch.Tensor] = []
        windows = text_pos = 0
        finished = False
        while not finished and len(latents) < max_tokens:
            if text_pos < n:
                w = min(W, n - text_pos)
                win = torch.zeros((1, W), dtype=torch.int64)
                win[0, :w] = torch.tensor(ids[text_pos:text_pos + w])
                text_pos += w
                pos_cond, neg_cond = self._text_window(
                    win.to(dev), w, lm_caches, tts_caches, lm_off, tts_off)
                lm_off += w
                tts_off += w
            if pos_cond is None:
                break
            k = min(S, max_tokens - len(latents))
            noise = self._draws(gen, len(latents), k,
                                (1, cfg.acoustic_vae_dim))
            lats, eos = [], []
            for j in range(k):
                lat, pos_cond, neg_cond, e = self._speech_step(
                    tts_caches, pos_cond, neg_cond, tts_off, noise[j],
                    tables, temb, cfg_scale)
                tts_off += 1
                lats.append(lat)
                eos.append(e)
            windows += 1
            stop = (torch.stack(eos) > 0.5).cpu().numpy()
            if stop.any():
                lats = lats[:int(np.argmax(stop)) + 1]
                finished = True
            latents += lats
            if text_pos >= n and not latents:
                break
        self.last_run = {"windows": windows, "latents": len(latents)}
        audio = (self._decode(torch.cat(latents)) if latents
                 else np.zeros(0, np.float32))
        return self._result(audio, n, time.perf_counter() - t0)

    def _result(self, audio: np.ndarray, n_tokens: int,
                dt: float) -> GenerationResult:
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=0, token_count=n_tokens,
            audio_duration=format_duration(dur),
            real_time_factor=round(dur / dt, 2) if dt else 0.0,
            prompt={"tokens": n_tokens,
                    "tokens-per-sec": round(n_tokens / dt, 2) if dt else 0},
            audio_samples={"samples": len(audio),
                           "samples-per-sec":
                               round(len(audio) / dt, 2) if dt else 0},
            processing_time_seconds=dt, peak_memory_usage=0.0)

    # ---------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict:
        """The published checkpoint's names onto the port's: drop the
        `model.` prefix, `lm_head` and the rotary buffers, and put the two
        LMs' layers under `.model.`. Conv kernels keep torch's layouts,
        which are the port's."""
        out = {}
        for k, v in weights.items():
            if k.startswith("model."):
                k = k[len("model."):]
            if "rotary_emb.inv_freq" in k or k.startswith("lm_head."):
                continue
            for pref in ("tts_language_model.", "language_model."):
                if k.startswith(pref) and not k.startswith(pref + "model."):
                    k = pref + "model." + k[len(pref):]
                    break
            out[k] = np.asarray(v)
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The HF tokenizer from the model directory (never downloaded)."""
        model.tokenizer = local_tokenizer(model_path)
        return model


__all__ = ["Model", "ModelConfig", "DiffusionHead", "VAEDecoder",
           "head_forward", "diffusion_sample", "decode_latents"]
