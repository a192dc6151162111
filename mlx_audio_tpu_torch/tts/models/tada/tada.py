"""TADA: text-audio dual alignment TTS (a llama, an adaLN flow-matching
head over acoustic latents with gray-coded durations, a DAC codec).

Counterpart of mlx_audio_tpu/tts/models/tada/tada.py: the gray code
(`int_to_gray_bits`, `gray_bits_to_int`, :74-90), `normalize_text`
(:101), `ModelConfig` (:118-189; `llama_config()` is the port's llama,
tied, with no head), the flow head `diffusion_head_forward` (:221-249:
a sinusoidal time embedding through `t_embedder`, plus `cond_proj`, then
SiLU; six adaLN blocks of an RMSNorm and a SwiGLU FFN; the final adaLN
and `final.linear`), `build_time_schedule` and `scheduled_cfg`
(:252-273), the step embedding `_step_embed` (:364, five terms) and
`_bottleneck`, the codec decode `decode_wav` (:442-493), the reference
encoder `encode_reference` and `_encoder_forward` (:495-554, the uniform
alignment whenever no aligner is bound), `generate` and `_run`
(:572-774) and `align_text_tokens` (:777). The host helpers are copies.

The loop: the JAX package runs one compiled step (the llama step at
batch 2, the positive and the negative CFG stream, then the whole flow
integration) and reads the step's latent back to decode the durations
and pick the next inputs. Here the step count is fixed before the loop
(`min(len(ids), max_tokens)`), the prompt-audio overrides are known by
index, so the gray decode of the durations runs on the device, the next
step's inputs are picked there, and the latents and durations are read
once, at the end. The noise comes from a `torch.Generator` through
`_draws`, the seam through which the tests hand the port JAX's draws.
Within a step, `cond_proj` of the hidden row and the adaLN modulations
of all the Euler steps are computed once, batched over the steps (the
time embeddings of the schedule are computed once a request): they do
not depend on the latent, and their numbers are JAX's.

Departures, each pinned by a test in tests/test_torch_tada.py:

* the codec decodes the latent rows it has. JAX pads them to a bucket
  (:464-468) and its decoder's convolutions are not causal, so JAX's
  last samples depend on the padded rows; and for more than 2,048 rows
  (41 s at 50 Hz) JAX's bucket is too short and its decode fails
  (:466). The port decodes any length;
* the llama's cache holds the request's steps. JAX's holds 4,096 columns
  (:61, :705) and clamps later writes onto earlier columns; the port
  raises before the loop for a request of more than MAX_CACHE_LEN steps;
* `post_load_hook` reads the directory only (`local_tokenizer`) and
  raises on tokenizer files that fail to load; JAX's leaves no tokenizer
  on any error (:353-361);
* q8 (`utils.apply_quantization`) quantizes the `Linear`s, never a table
  or a conv. JAX's rule also quantizes `acoustic_mask_emb`, a (2, D)
  table whose name has no "embed", and each codec conv whose output
  width the group divides, and its q8 model then fails to read them.

Gaps of both packages: no aligner is bound anywhere, so a cloned
prompt's text tokens are aligned uniformly; the codec encoder's weights
come only from `init_encoder_params`, which draws them at random.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Embedding, Linear, RMSNorm
from ....ops.kvcache import KVCache
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)
from ..llama.llama import Model as LlamaModel
from ..llama.llama import ModelConfig as LlamaConfig
from ..llama.llama import init_caches, llama_forward
from .codec import (DacDecoder, LocalAttention, WavEncoder,
                    dac_decoder_forward, local_attention_forward,
                    segment_attention_mask, wav_encoder_forward)

MAX_CACHE_LEN = 4096


# --------------------------------------------------------------- gray code

def int_to_gray_bits(n: int, num_bits: int) -> List[float]:
    gray = n ^ (n >> 1)
    return [1.0 if (gray >> i) & 1 else -1.0
            for i in range(num_bits - 1, -1, -1)]


def gray_bits_to_int(bits) -> int:
    gray = 0
    for b in bits:
        gray = (gray << 1) | (1 if b > 0 else 0)
    n = gray
    mask = n >> 1
    while mask:
        n ^= mask
        mask >>= 1
    return n


def gray_bits_to_int_device(bits: torch.Tensor) -> torch.Tensor:
    """`gray_bits_to_int` over the last axis of a float tensor (..., nb),
    most significant bit first, on its device -> int64 (...): each binary
    bit is the parity of the gray bits down to it."""
    nb = bits.shape[-1]
    binary = torch.cumsum((bits > 0).long(), dim=-1) % 2
    weights = 2 ** torch.arange(nb - 1, -1, -1, device=bits.device)
    return (binary * weights).sum(-1)


# ------------------------------------------------------------ text utils

_PUNCT_SUBS = {"“": '"', "”": '"', "„": '"', "‟": '"',
               "‘": "'", "’": "'", "‚": "'", "‛": "'",
               "–": "-", "—": "-", "―": "-", "‐": "-",
               "‑": "-", "…": "...", "‹": "<",
               "›": ">", "«": "<<", "»": ">>"}


def normalize_text(text: str) -> str:
    """TADA text cleanup (ref text_utils.py)."""
    pattern = re.compile("|".join(re.escape(c) for c in _PUNCT_SUBS))
    text = pattern.sub(lambda m: _PUNCT_SUBS[m.group(0)], text)
    text = (text.replace("; ", ". ").replace('"', "").replace(":", ",")
            .replace("(", "").replace(")", "").replace("--", "-")
            .replace("-", ", ").replace(",,", ",").replace(" '", " ")
            .replace("' ", " ").replace("  ", " "))
    text = re.sub(r"\s+([.,?!])", r"\1", text)
    text = re.sub(r"([.!?]\s*)(\w)",
                  lambda m: m.group(1) + m.group(2).upper(), text.lower())
    return text[0].upper() + text[1:] if text else text


# ---------------------------------------------------------------- config

@dataclass
class ModelConfig(BaseModelArgs):
    vocab_size: int = 128256
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True

    acoustic_dim: int = 512
    num_time_classes: int = 256
    shift_acoustic: int = 5
    head_layers: int = 6
    head_ffn_ratio: float = 4.0
    bottleneck_dim: Optional[int] = None
    context_window: int = 8
    acoustic_mean: float = 0.0
    acoustic_std: float = 1.5

    decoder_hidden_dim: int = 1024
    decoder_d_model: int = 96
    decoder_embed_dim: int = 512
    decoder_strides: List[int] = field(default_factory=lambda: [4, 4, 5, 6])
    decoder_num_attn_layers: int = 6
    decoder_num_attn_heads: int = 8
    decoder_attn_dim_feedforward: int = 4096
    decoder_block_attention: str = "v2"

    encoder_hidden_dim: int = 1024
    encoder_d_model: int = 96
    encoder_embed_dim: int = 512
    encoder_strides: List[int] = field(default_factory=lambda: [6, 5, 4, 4])
    encoder_num_attn_layers: int = 6
    encoder_num_attn_heads: int = 8
    encoder_attn_dim_feedforward: int = 4096
    encoder_block_attention: str = "v2"
    encoder_std: float = 0.5

    sample_rate: int = 24000
    model_type: str = "tada"
    eos_token_id: Union[int, List[int]] = 128001
    rope_scaling: Optional[dict] = None
    model_path: str = ""

    @property
    def num_time_bits(self) -> int:
        return math.ceil(math.log2(self.num_time_classes))

    @property
    def time_dim(self) -> int:
        return 2 * self.num_time_bits

    @property
    def latent_size(self) -> int:
        return self.acoustic_dim + self.time_dim

    def llama_config(self) -> LlamaConfig:
        """The llama of the JAX package's `llama_config()`: tied, and
        without `rope_scaling`, which the JAX TADA does not pass on."""
        return LlamaConfig(
            hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            intermediate_size=self.intermediate_size,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            vocab_size=self.vocab_size, rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta, head_dim=self.head_dim,
            tie_word_embeddings=True)


# --------------------------------------------------------- diffusion head

class DiffusionHead(nn.Module):
    """init_diffusion_head's tree."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        hidden = cfg.bottleneck_dim or cfg.hidden_size
        ffn = int(hidden * cfg.head_ffn_ratio)
        self.layers = nn.ModuleDict({str(i): holder(
            ffn=holder(gate_proj=Linear(hidden, ffn, bias=False),
                       up_proj=Linear(hidden, ffn, bias=False),
                       down_proj=Linear(ffn, hidden, bias=False)),
            norm=RMSNorm(hidden, cfg.rms_norm_eps),
            adaLN=Linear(hidden, 3 * hidden, bias=False))
            for i in range(cfg.head_layers)})
        self.noisy_images_proj = Linear(cfg.latent_size, hidden, bias=False)
        self.cond_proj = Linear(hidden, hidden, bias=False)
        self.t_embedder = holder(fc1=Linear(256, hidden),
                                 fc2=Linear(hidden, hidden))
        self.final = holder(linear=Linear(hidden, cfg.latent_size,
                                          bias=False),
                            adaLN=Linear(hidden, 2 * hidden, bias=False))

    @property
    def dtype(self) -> torch.dtype:
        return self.layers["0"].norm.weight.dtype


def time_embedding(p: DiffusionHead, t: torch.Tensor) -> torch.Tensor:
    """t (N,) f32 -> `t_embedder`'s (N, hidden): the sinusoid of t x 1000
    (cos then sin, 128 frequencies) through fc1, SiLU, fc2."""
    half = 128
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None] * 1000.0
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    te = p.t_embedder
    return te.fc2(F.silu(te.fc1(emb.to(p.dtype))))


def head_modulations(p: DiffusionHead, cond: torch.Tensor,
                     temb: torch.Tensor) -> Tuple[List[torch.Tensor],
                                                  torch.Tensor]:
    """The adaLN modulations of `cond` (B, hidden) at the time embeddings
    temb (N, hidden): c = SiLU(cond_proj(cond) + temb) -> (each block's
    (N, B, 3 hidden), the final one's (N, B, 2 hidden))."""
    c = p.cond_proj(cond.to(p.dtype))
    c_act = F.silu(c[None] + temb[:, None].to(c.dtype))
    return ([blk.adaLN(c_act) for blk in p.layers.values()],
            p.final.adaLN(c_act))


def head_velocity(p: DiffusionHead, cfg: ModelConfig, x: torch.Tensor,
                  mods: List[torch.Tensor],
                  final_mod: torch.Tensor) -> torch.Tensor:
    """The head over latents x (B, latent) at one time's modulations
    (each block's (B, 3 hidden), the final (B, 2 hidden)) -> f32
    velocity (B, latent)."""
    h = p.noisy_images_proj(x.to(p.dtype))
    for blk, mod in zip(p.layers.values(), mods):
        shift, scale, gate = mod.chunk(3, dim=-1)
        hn = blk.norm(h) * (1 + scale) + shift
        f = blk.ffn
        h = h + gate * f.down_proj(F.silu(f.gate_proj(hn)) * f.up_proj(hn))
    shift, scale = final_mod.chunk(2, dim=-1)
    hf = h.float()
    hn = (hf * torch.rsqrt(hf.pow(2).mean(-1, keepdim=True)
                           + cfg.rms_norm_eps)).to(h.dtype)
    return p.final.linear(hn * (1 + scale) + shift).float()


def diffusion_head_forward(p: DiffusionHead, cfg: ModelConfig,
                           x: torch.Tensor, t: torch.Tensor,
                           cond: torch.Tensor) -> torch.Tensor:
    """(B, latent), (B,), (B, hidden) -> f32 velocity (B, latent), each
    row at its own time (diffusion_head_forward, :221-249)."""
    temb = time_embedding(p, t)
    c_act = F.silu(p.cond_proj(cond.to(p.dtype)) + temb)
    mods = [blk.adaLN(c_act) for blk in p.layers.values()]
    return head_velocity(p, cfg, x, mods, p.final.adaLN(c_act))


def build_time_schedule(num_steps: int, schedule: str) -> np.ndarray:
    if schedule == "cosine":
        u = np.linspace(0, 1, num_steps + 1)
        return 0.5 * (1 - np.cos(np.pi * u))
    if schedule == "logsnr":
        log_snr = np.linspace(5.0, -5.0, num_steps + 1)
        t = 1.0 / (1.0 + np.exp(log_snr / 2))
        t[0], t[-1] = 0.0, 1.0
        return t
    return np.linspace(0, 1, num_steps + 1)


def scheduled_cfg(base: float, t: float, schedule: str) -> float:
    if schedule == "constant" or base == 1.0:
        return base
    if schedule == "linear":
        return 1.0 + (base - 1.0) * (1.0 - t)
    if schedule == "cosine":
        return 1.0 + (base - 1.0) * 0.5 * (1.0 + math.cos(math.pi * t))
    return base


# ------------------------------------------------------------ the encoder

class CodecEncoder(TorchModel):
    """The codec encoder (init_encoder_params's tree): `wav_encoder` at
    width 64, `local_attention_encoder`, `pos_emb` and, where the widths
    differ, `hidden_linear`. It stands apart from the model's parameters,
    as `_encoder_params` does in the JAX package."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        device = check_device(device)
        super().__init__(cfg)
        with torch.device(device):
            self.wav_encoder = WavEncoder(64, cfg.encoder_strides,
                                          cfg.encoder_hidden_dim)
            self.local_attention_encoder = LocalAttention(
                cfg.encoder_hidden_dim, cfg.encoder_num_attn_layers,
                cfg.encoder_num_attn_heads, cfg.encoder_attn_dim_feedforward)
            self.pos_emb = Embedding(2, cfg.encoder_hidden_dim)
            if cfg.encoder_hidden_dim != cfg.encoder_embed_dim:
                self.hidden_linear = Linear(cfg.encoder_hidden_dim,
                                            cfg.encoder_embed_dim)
        self.requires_grad_(False)
        self.eval()


# ----------------------------------------------------------------- model

class Model(TorchModel):
    """TADA (HumeAI), a duration-aware flow-matching token TTS, on
    `device`: the card by default; without CUDA the constructor raises
    unless given `device="cpu"`. The llama's tree sits at `model`, as in
    the JAX tree."""

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
        cfg = config
        lm = LlamaModel(cfg.llama_config(), device=device, lm_head=False)
        self.__dict__["_lm"] = lm
        self.model = lm.model
        h = cfg.hidden_size
        with torch.device(device):
            self.acoustic_proj = Linear(cfg.acoustic_dim, h)
            self.time_start_embed = Embedding(cfg.num_time_classes, h)
            self.time_end_embed = Embedding(cfg.num_time_classes, h)
            self.acoustic_mask_emb = Embedding(2, h)
            self.prediction_head = DiffusionHead(cfg)
            self.decoder = holder(
                decoder_proj=Linear(cfg.decoder_embed_dim,
                                    cfg.decoder_hidden_dim),
                local_attention_decoder=LocalAttention(
                    cfg.decoder_hidden_dim, cfg.decoder_num_attn_layers,
                    cfg.decoder_num_attn_heads,
                    cfg.decoder_attn_dim_feedforward),
                wav_decoder=DacDecoder(cfg.decoder_d_model,
                                       cfg.decoder_strides,
                                       cfg.decoder_hidden_dim))
            if cfg.bottleneck_dim is not None:
                self.bottleneck_proj = Linear(h, cfg.bottleneck_dim)
        self.requires_grad_(False)
        self.eval()
        self._tokenizer = None
        self.__dict__["_encoder"] = None
        self._aligner = None
        self.last_run: dict = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def encoder(self) -> Optional[CodecEncoder]:
        return self.__dict__["_encoder"]

    def init_encoder_params(self, seed: int = 0) -> CodecEncoder:
        """The codec encoder, random from `seed` on the model's device (the
        tada-codec weights are not loaded; random for tests)."""
        enc = CodecEncoder(self.config, device=self.device).init_params(seed)
        enc.astype(self.prediction_head.dtype)
        self.__dict__["_encoder"] = enc
        return enc

    def set_encoder(self, encoder: CodecEncoder) -> "Model":
        self.__dict__["_encoder"] = encoder
        return self

    def sanitize(self, weights: Dict) -> Dict:
        return {k: v for k, v in weights.items()
                if "rotary_emb.inv_freq" not in k and k != "lm_head.weight"}

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (`local_tokenizer`: None without
        tokenizer files; files that fail to load raise)."""
        model._tokenizer = local_tokenizer(model_path)
        return model

    # ------------------------------------------------------------ embeds

    def _step_embed(self, ids, acoustic, masks, t_before, t_after):
        dt = self.model.embed_tokens.weight.dtype
        return (self.model.embed_tokens(ids)
                + self.acoustic_proj(acoustic.to(dt))
                + self.acoustic_mask_emb(masks)
                + self.time_start_embed(t_before)
                + self.time_end_embed(t_after))

    def _bottleneck(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "bottleneck_proj"):
            return self.bottleneck_proj(x)
        return x

    # -------------------------------------------------------------- step

    def flow_plan(self, fm_steps: int, acoustic_cfg: float,
                  duration_cfg: float, cfg_schedule: str,
                  time_schedule: str) -> dict:
        """The Euler steps of one flow integration (t, dt, the acoustic and
        the duration CFG scale of each), whether a negative stream runs,
        and the time embeddings of the steps' t on the device."""
        t_span = build_time_schedule(fm_steps, time_schedule)
        steps = []
        t_curr = float(t_span[0])
        for i in range(1, len(t_span)):
            dt = float(t_span[i]) - t_curr
            steps.append((t_curr, dt,
                          scheduled_cfg(acoustic_cfg, t_curr, cfg_schedule),
                          scheduled_cfg(duration_cfg, t_curr, cfg_schedule)))
            t_curr = float(t_span[i])
        t = torch.tensor([s[0] for s in steps], dtype=torch.float32,
                         device=self.device)
        return {"steps": steps, "need_neg": acoustic_cfg != 1.0,
                "temb": time_embedding(self.prediction_head, t)}

    def flow(self, hidden: torch.Tensor, noise: torch.Tensor,
             plan: dict) -> torch.Tensor:
        """The flow integration from `noise` (1, latent) f32, conditioned
        on the llama rows hidden (B, D) (the positive stream, then the
        negative one under CFG) -> the f32 latent (1, latent)."""
        cfg = self.config
        p = self.prediction_head
        ad = cfg.acoustic_dim
        b = hidden.shape[0]
        mods, final_mod = head_modulations(p, self._bottleneck(hidden),
                                           plan["temb"])
        speech = noise.float()
        for i, (_, dt, a_cfg, d_cfg) in enumerate(plan["steps"]):
            v = head_velocity(p, cfg, speech.expand(b, -1),
                              [m[i] for m in mods], final_mod[i])
            if b == 2:
                vp, vn = v[:1], v[1:]
                v = torch.cat([vn[:, :ad] + a_cfg * (vp[:, :ad] - vn[:, :ad]),
                               vn[:, ad:] + d_cfg * (vp[:, ad:]
                                                     - vn[:, ad:])], dim=-1)
            speech = speech + dt * v
        return speech

    def step(self, caches: KVCache, offset: int, ids: torch.Tensor,
             acoustic: torch.Tensor, masks: torch.Tensor,
             t_before: torch.Tensor, t_after: torch.Tensor,
             noise: torch.Tensor, plan: dict) -> torch.Tensor:
        """One AR step: the llama step of ids (B, 1) (B = 2 under CFG: the
        positive, then the negative stream) at the host int `offset`,
        against the cache columns written so far, then the flow over the
        hidden rows -> the f32 latent (1, latent)."""
        b = ids.shape[0]
        emb = self._step_embed(ids, acoustic.expand(b, -1, -1),
                               masks.expand(b, -1), t_before.expand(b, -1),
                               t_after.expand(b, -1))
        view = KVCache(caches.k[:, :, :offset + 1],
                       caches.v[:, :, :offset + 1])
        hidden, _ = llama_forward(self.__dict__["_lm"], emb, caches=view,
                                  offset=offset)
        return self.flow(hidden[:, -1], noise, plan)

    def _draws(self, generator: torch.Generator) -> torch.Tensor:
        """One step's noise (1, latent_size), f32, N(0, 1)."""
        return torch.randn((1, self.config.latent_size),
                           generator=generator, device=self.device)

    def gray_durations(self, speech: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The gray-coded durations of a latent (1, latent) -> (before,
        after), each (1, 1) int64 on the device."""
        cfg = self.config
        nb = cfg.num_time_bits
        vals = gray_bits_to_int_device(
            speech[0, -cfg.time_dim:].reshape(2, nb))
        return vals[0].reshape(1, 1), vals[1].reshape(1, 1)

    # ---------------------------------------------------------- decoding

    def _expand(self, encoded: np.ndarray,
                time_before: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The latents expanded over the gaps before each (:447-462) ->
        (rows (n, D), token masks (n,))."""
        rows = []
        for pos in range(encoded.shape[0]):
            n_zeros = max(0, int(time_before[pos]) - 1)
            if n_zeros:
                rows.append(np.zeros((n_zeros, encoded.shape[-1]),
                                     np.float32))
            rows.append(encoded[pos:pos + 1])
        n_trail = int(time_before[-1])
        if n_trail:
            rows.append(np.zeros((n_trail, encoded.shape[-1]), np.float32))
        expanded = np.concatenate(rows, axis=0)
        return expanded, (np.linalg.norm(expanded, axis=-1) != 0).astype(
            np.int64)

    @torch.inference_mode()
    def decode_latents(self, expanded: np.ndarray,
                       token_masks: np.ndarray) -> np.ndarray:
        """The codec decoder over expanded rows (n, D) -> f32 waveform
        (n * prod(decoder_strides),)."""
        cfg = self.config
        d = self.decoder
        x = torch.as_tensor(expanded, device=self.device)[None]
        tm = torch.as_tensor(token_masks, device=self.device)[None]
        h = d.decoder_proj(x.to(self.prediction_head.dtype))
        attn = segment_attention_mask(tm, version=cfg.decoder_block_attention)
        h = local_attention_forward(d.local_attention_decoder, h, mask=attn)
        wav = dac_decoder_forward(d.wav_decoder, cfg.decoder_strides, h)
        return wav[0, :, 0].float().cpu().numpy()

    def decode_wav(self, encoded: np.ndarray,
                   time_before: np.ndarray) -> np.ndarray:
        """Expand latents over silence gaps and run the codec decoder over
        the rows (ref _decode_wav :404-427)."""
        time_before = time_before[: encoded.shape[0] + 1]
        if time_before.shape[0] == 0:
            return np.zeros((0,), np.float32)
        expanded, token_masks = self._expand(encoded, time_before)
        self.last_run["latent_rows"] = len(expanded)
        return self.decode_latents(expanded, token_masks)

    # --------------------------------------------------- reference encode

    def encode_reference(self, audio: np.ndarray, text: str
                         ) -> Tuple[np.ndarray, np.ndarray, str]:
        """-> (token_values (1, N, D), token_positions (1, N), text)."""
        if self.encoder is None or self._tokenizer is None:
            raise RuntimeError("codec encoder / tokenizer not loaded")
        cfg = self.config
        text = normalize_text(text)
        text_ids = np.asarray(self._tokenizer.encode(
            text, add_special_tokens=False), np.int64)
        audio = np.asarray(audio, np.float32).reshape(-1)
        num_frames = int(np.ceil(len(audio) / cfg.sample_rate * 50))

        if self._aligner is not None:
            n16 = int(len(audio) * 16000 / cfg.sample_rate)
            idx = np.linspace(0, len(audio) - 1, n16)
            audio16 = np.interp(idx, np.arange(len(audio)), audio) \
                .astype(np.float32)
            logits = self._aligner.logits(audio16)
            positions, token_masks = align_text_tokens(
                np.asarray(logits), text_ids, len(audio), cfg.sample_rate)
        else:
            # uniform fallback alignment (no aligner weights bound)
            positions = np.linspace(1, max(num_frames - 1, 1),
                                    len(text_ids)).astype(np.int64)
            token_masks = np.zeros(num_frames, np.int64)
            token_masks[np.clip(positions - 1, 0, num_frames - 1)] = 1

        token_values = self._encoder_forward(audio, positions, token_masks)
        return token_values, positions[None], text

    @torch.inference_mode()
    def _encoder_forward(self, audio: np.ndarray, positions: np.ndarray,
                         token_masks: np.ndarray) -> np.ndarray:
        cfg = self.config
        p = self.encoder
        dev = self.device
        padded = torch.as_tensor(np.pad(audio, (0, 960)),
                                 device=dev)[None, :, None]
        enc = wav_encoder_forward(p.wav_encoder, cfg.encoder_strides,
                                  padded.to(p.pos_emb.weight.dtype))
        seq = enc.shape[1]
        tm = np.zeros(seq, np.int64)
        n = min(seq, len(token_masks))
        tm[:n] = token_masks[:n]
        tm_t = torch.as_tensor(tm, device=dev)[None]
        enc = enc + p.pos_emb(tm_t)
        attn = segment_attention_mask(tm_t,
                                      version=cfg.encoder_block_attention)
        enc = local_attention_forward(p.local_attention_encoder, enc,
                                      mask=attn)
        if hasattr(p, "hidden_linear"):
            enc = p.hidden_linear(enc)
        enc = enc[0].float().cpu().numpy()
        enc = enc * tm[:, None]
        pos = np.clip(positions - 1, 0, enc.shape[0] - 1)
        vals = enc[pos]
        vals = (vals - cfg.acoustic_mean) / cfg.acoustic_std
        return vals[None]

    # ---------------------------------------------------------- generate

    def _prompt_ids(self, full_text: str) -> Tuple[List[int], int]:
        tok = self._tokenizer
        bos = tok.bos_token_id
        eot = tok.convert_tokens_to_ids("<|eot_id|>")
        sh = tok.convert_tokens_to_ids("<|start_header_id|>")
        eh = tok.convert_tokens_to_ids("<|end_header_id|>")
        system = list(tok.encode("system", add_special_tokens=False))
        assistant = list(tok.encode("assistant", add_special_tokens=False))
        prefix_text = [sh] + system + [eh, eot, sh] + assistant + [eh]
        ids = ([bos] + prefix_text
               + list(tok.encode(full_text, add_special_tokens=False))
               + [eot] * self.config.shift_acoustic)
        return ids, len(prefix_text)

    def generate(self, text: str, ref_audio=None, ref_text=None,
                 voice=None, acoustic_cfg_scale: float = 1.6,
                 duration_cfg_scale: float = 1.0,
                 cfg_schedule: str = "cosine",
                 noise_temperature: float = 0.9,
                 num_flow_matching_steps: int = 20,
                 time_schedule: str = "logsnr",
                 num_transition_steps: int = 5, max_tokens: int = 1024,
                 speed_up_factor: Optional[float] = None, seed: int = 0,
                 **kwargs) -> Generator[GenerationResult, None, None]:
        if self._tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        cfg = self.config
        t0 = time.perf_counter()
        text = normalize_text(text)

        prompt_vals = prompt_positions = None
        prompt_text = ""
        if ref_audio is not None and ref_text is not None:
            if isinstance(ref_audio, str):
                from ....utils import load_audio

                ref_audio = load_audio(ref_audio,
                                       sample_rate=cfg.sample_rate)
            prompt_vals, prompt_positions, prompt_text = \
                self.encode_reference(np.asarray(ref_audio), ref_text)

        ids, prefix_len = self._prompt_ids(prompt_text + text)
        wav = self._run(ids, prefix_len, prompt_vals, prompt_positions,
                        acoustic_cfg_scale, duration_cfg_scale,
                        cfg_schedule, noise_temperature,
                        num_flow_matching_steps, time_schedule,
                        num_transition_steps, max_tokens, speed_up_factor,
                        seed)
        dt = max(time.perf_counter() - t0, 1e-6)
        dur = len(wav) / cfg.sample_rate
        yield GenerationResult(
            audio=wav, samples=len(wav), sample_rate=cfg.sample_rate,
            segment_idx=0, token_count=len(ids),
            audio_duration=format_duration(dur),
            real_time_factor=round(dur / dt, 3),
            prompt={"tokens": len(ids),
                    "tokens-per-sec": round(len(ids) / dt, 2)},
            audio_samples={"samples": len(wav),
                           "samples-per-sec": round(len(wav) / dt, 2)},
            processing_time_seconds=dt, peak_memory_usage=peak_memory_gb())

    def _structure(self) -> Tuple[set, int, int, int]:
        """(the structural ids, pad id, <|start_header_id|>,
        <|end_header_id|>) of the tokenizer."""
        tok = self._tokenizer
        eot = tok.convert_tokens_to_ids("<|eot_id|>")
        sh = tok.convert_tokens_to_ids("<|start_header_id|>")
        eh = tok.convert_tokens_to_ids("<|end_header_id|>")
        try:
            pad_id = tok.convert_tokens_to_ids("<|finetune_right_pad_id|>")
        except Exception:
            pad_id = 0
        return {sh, eh, eot, tok.bos_token_id, 128001}, pad_id, sh, eh

    @torch.inference_mode()
    def _run(self, ids, prefix_len, prompt_vals, prompt_positions,
             acoustic_cfg, duration_cfg, cfg_schedule, noise_temperature,
             fm_steps, time_schedule, num_transition_steps, max_tokens,
             speed_up_factor, seed,
             time_override: Optional[dict] = None) -> np.ndarray:
        cfg = self.config
        shift = cfg.shift_acoustic
        structural, pad_id, sh, eh = self._structure()

        input_ids = np.asarray(ids, np.int64)
        num_steps = min(len(ids), max_tokens)
        if num_steps > MAX_CACHE_LEN:
            raise ValueError(
                f"TADA: {num_steps} steps exceed the {MAX_CACHE_LEN}-column "
                f"cache; shorten the text or max_tokens")

        # prompt-audio timing tracks (padded for the chat prefix)
        has_prompt = prompt_vals is not None and prompt_vals.shape[1] > 0
        pa = pm = ptb = pta = None
        if has_prompt:
            tp = np.asarray(prompt_positions[0])
            tp_pad = np.insert(tp, 0, 1)
            gaps = np.clip(tp - tp_pad[:-1], 0, cfg.num_time_classes - 1)
            gaps = np.insert(gaps, 0, 0)
            pa = np.pad(prompt_vals, ((0, 0), (prefix_len, 0), (0, 0)))
            pm = np.pad(np.ones(prompt_vals.shape[:2], np.int64),
                        ((0, 0), (prefix_len, 0)))
            ptb = np.pad(gaps[:-1][None], ((0, 0), (prefix_len, 0)))
            pta = np.pad(gaps[1:][None], ((0, 0), (prefix_len, 0)))
            if num_transition_steps > 0 and pa.shape[1] > \
                    num_transition_steps:
                pa = pa[:, :-num_transition_steps]
                pm = pm[:, :-num_transition_steps]
                ptb = ptb[:, :-num_transition_steps]
                pta = pta[:, :-num_transition_steps]
            pm = np.concatenate([pm[:, 1:], np.ones_like(pm[:, :1])],
                                axis=1)
            # mask non-structural prompt text tokens
            plen = pa.shape[1]
            pids = input_ids[:plen]
            is_struct = np.isin(pids, list(structural))
            depth = np.cumsum(pids == sh) - np.cumsum(pids == eh)
            is_struct |= (depth > 0) | (pids == sh) | (pids == eh)
            input_ids = np.concatenate(
                [np.where(is_struct, pids, pad_id), input_ids[plen:]])
        if time_override is not None:
            # speed-control second pass: durations forced from pass 1
            ptb = time_override["before"]
            pta = time_override["after"]

        encoded, times = self._loop(
            input_ids[:num_steps], structural, pad_id, pa, pm, ptb, pta,
            has_prompt or time_override is not None,
            self.flow_plan(fm_steps, acoustic_cfg, duration_cfg,
                           cfg_schedule, time_schedule),
            noise_temperature, seed)
        if encoded is None:
            return np.zeros((0,), np.float32)
        times = np.append(times, times[-1])

        if speed_up_factor is not None:
            scaled = np.round(np.asarray(times[:-1], np.float32)
                              / speed_up_factor).astype(np.int64)[None]
            override = {
                "before": np.concatenate(
                    [np.zeros_like(scaled[:, :1]), scaled], axis=1),
                "after": np.concatenate(
                    [scaled, np.ones_like(scaled[:, :1])], axis=1)}
            return self._run(ids, prefix_len, prompt_vals,
                             prompt_positions, acoustic_cfg, duration_cfg,
                             cfg_schedule, noise_temperature, fm_steps,
                             time_schedule, num_transition_steps,
                             max_tokens, None, seed,
                             time_override=override)

        encoded = encoded * cfg.acoustic_std + cfg.acoustic_mean
        if has_prompt:
            skip = pa.shape[1] + num_transition_steps - 1
        else:
            skip = max(0, prefix_len - num_transition_steps) \
                + num_transition_steps - 1
        if 0 < skip < encoded.shape[0]:
            encoded = encoded[skip:]
            times = times[skip:]
        wav = self.decode_wav(encoded, times)
        if len(times):
            lead = int(cfg.sample_rate * int(times[0]) / 50)
            if 0 < lead < len(wav):
                wav = wav[lead:]
        return wav

    def _loop(self, input_ids: np.ndarray, structural: set, pad_id: int,
              pa, pm, ptb, pta, use_prompt_times: bool, plan: dict,
              noise_temperature: float, seed: int):
        """The AR steps over input_ids, all on the device -> (the acoustic
        rows (n, acoustic_dim), their durations before (n,)), read once;
        (None, None) when no step reached the acoustic shift."""
        cfg = self.config
        dev = self.device
        shift = cfg.shift_acoustic
        num_steps = len(input_ids)
        need_neg = plan["need_neg"]
        b = 2 if need_neg else 1
        ids_t = torch.as_tensor(input_ids, device=dev)
        neg_t = torch.as_tensor(np.where(np.isin(input_ids, list(structural)),
                                         input_ids, pad_id), device=dev)
        has_prompt = pa is not None
        if has_prompt:
            pa_t = torch.as_tensor(pa, dtype=torch.float32, device=dev)
            pm_t = torch.as_tensor(pm, device=dev)
        if ptb is not None:
            ptb_t = torch.as_tensor(ptb, dtype=torch.long, device=dev)
            pta_t = torch.as_tensor(pta, dtype=torch.long, device=dev)
        caches = init_caches(self.__dict__["_lm"].config, b, max(1, num_steps),
                             dtype=self.model.embed_tokens.weight.dtype,
                             device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        acoustic = torch.zeros((1, 1, cfg.acoustic_dim), device=dev)
        masks = torch.zeros((1, 1), dtype=torch.long, device=dev)
        tb = torch.zeros((1, 1), dtype=torch.long, device=dev)
        ta = torch.zeros((1, 1), dtype=torch.long, device=dev)
        ones = torch.ones((1, 1), dtype=torch.long, device=dev)
        all_ac, all_tb = [], []
        t0 = time.perf_counter()
        for step_i in range(num_steps):
            sl = ids_t[step_i:step_i + 1]
            ids2 = torch.stack([sl, neg_t[step_i:step_i + 1]]) if need_neg \
                else sl[None]
            noise = self._draws(gen).float() * noise_temperature
            speech = self.step(caches, step_i, ids2, acoustic, masks, tb, ta,
                               noise, plan)
            if step_i >= shift:
                j = step_i - shift
                if has_prompt and j < pa.shape[1]:
                    acoustic = pa_t[:, j:j + 1]
                    masks = pm_t[:, j:j + 1]
                else:
                    acoustic = speech[None, :, :cfg.acoustic_dim]
                    masks = ones
                all_ac.append(acoustic)
                if use_prompt_times and ptb is not None \
                        and j < ptb.shape[1] - 1:
                    tb = ptb_t[:, j + 1:j + 2]
                    ta = pta_t[:, j + 1:j + 2]
                else:
                    tb, ta = self.gray_durations(speech)
                all_tb.append(tb)
        self.last_run = {"steps": num_steps, "batch": b,
                         "flow_steps": len(plan["steps"]),
                         "loop_s": time.perf_counter() - t0}
        if not all_ac:
            return None, None
        encoded = torch.cat(all_ac, dim=1)[0].float().cpu().numpy()
        times = torch.cat(all_tb, dim=1)[0].cpu().numpy()
        return encoded, times


def align_text_tokens(logits: np.ndarray, text_tokens: np.ndarray,
                      audio_length: int, sample_rate: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic greedy CTC alignment (ref tada.py:1590-1648)."""
    t_frames, _ = logits.shape
    n = len(text_tokens)
    num_frames = int(np.ceil(audio_length / sample_rate * 50))
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(num_frames, np.int64)
    ctc_to_codec = np.linspace(0, num_frames - 1, t_frames).astype(np.int64)
    log_probs = logits - np.log(
        np.sum(np.exp(logits), axis=-1, keepdims=True) + 1e-10)
    scores = np.stack([log_probs[:, tok] for tok in text_tokens])
    positions = np.zeros(n, np.int64)
    min_gap = max(1, t_frames // (n + 1))
    for i in range(n):
        start = int(positions[i - 1] + min_gap) if i > 0 else 0
        end = t_frames - (n - i - 1) * min_gap
        if start >= end:
            start = max(0, end - 1)
        positions[i] = start + int(np.argmax(scores[i, start:end]))
    codec_positions = ctc_to_codec[positions]
    token_masks = np.zeros(num_frames, np.int64)
    for pos in codec_positions:
        if 0 <= pos < num_frames:
            token_masks[pos] = 1
    return codec_positions + 1, token_masks


__all__ = ["Model", "ModelConfig", "CodecEncoder", "MAX_CACHE_LEN",
           "normalize_text", "int_to_gray_bits", "gray_bits_to_int",
           "gray_bits_to_int_device", "build_time_schedule", "scheduled_cfg",
           "align_text_tokens", "diffusion_head_forward", "time_embedding",
           "head_modulations", "head_velocity"]
