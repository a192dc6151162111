"""KugelAudio: a 7B VibeVoice-derived AR + diffusion TTS (24 EU languages).

Counterpart of mlx_audio_tpu/tts/models/kugelaudio/kugelaudio.py: a
Qwen2.5 LM constrained to 4 speech tokens, one latent sampled by the
SDE-DPM-Solver++ head under classifier-free guidance (CFG) per
speech_diffusion token, and the VibeVoice causal VAE decoder:

* `ModelConfig` (:86-119, the `acostic_vae_dim` alias), `sanitize` and
  `model_quant_predicate` (:196-208), `post_load_hook`;
* `_logits`, `_connector` (:226-240) and `_pick4_logits` (:242-274): the
  4 valid rows of a dense, W8A8 (`Int8Linear`) or affine (`QuantizedLinear`)
  `lm_head`, its optional bias and `logits_scaling`;
* `prefill` (:276-315): both CFG rows over the prompt bucket, row 1 a bare
  SPEECH_START at slot 0 under its own mask, as JAX does (M = 2 x bucket);
* `chunk` (:317-431): eager frames whose state stays on the device (the
  pick, the final-latent margin, the latent buffer, `finished`, the
  negative row advancing only on diffusion embeds with its own mask and
  positions, the held row-1 hidden); the host reads one packed status a
  chunk of CHUNK_FRAMES (4) frames;
* `sde_sample` (:440-480), `_build_prompt_tokens` (:484-494), `generate`
  (:496-605: the LAT_MAX clamp and its warning, the latent bucket decode,
  the scaling factors' NaN rule, the 0.95 peak normalisation) and
  `_result` (elapsed / audio, the family's RTF convention).

Departures from the JAX package, each pinned by a test in
tests/test_torch_kugelaudio.py:

* the frame loop runs whole chunks: frames after the one that finishes
  run on the device and change nothing that is kept (the latent writes,
  counters and negative-row advance are gated by `emit & ~finished`), so
  the kept latents and the frame count are JAX's. The SDE runs every
  frame and is kept only where a latent is emitted; the lane's frames all
  emit;
* the draws come from a torch.Generator, one (frames, 1 + steps, latent)
  noise tensor a chunk, indexed on the device by the latent count (`_draws`,
  the seam a test uses to feed JAX's key splits);
* a bf16 model computes in bf16, with f32 KV caches (attended in f32), an
  f32 SDE state and an f32 VAE, where JAX promotes the residual stream,
  the head and the connector to f32 against its f32 caches and sampler;
* a prompt over the last prompt bucket (1,024 tokens) raises ValueError
  before the prefill (JAX fails in a numpy broadcast);
* `post_load_hook` reads a tokenizer from the model directory only and
  raises where its files do not load (JAX swallows every failure);
* conv kernels stay in torch's layouts, which are the port's (JAX's
  `sanitize` leaves a torch-layout checkpoint's kernels in a layout its
  convs do not take).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Int8Linear, Linear, QuantizedLinear, RMSNorm
from ....ops.kvcache import KVCache
from ....ops.quant import dequantize_weight
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)
from ..llama.llama import Model as LlamaModel
from ..llama.llama import llama_forward
from ..vibevoice.config import (AcousticTokenizerConfig, DiffusionHeadConfig,
                                Qwen2DecoderConfig)
from ..vibevoice.scheduler import sde_dpm_tables
from ..vibevoice.vibevoice import (DiffusionHead, VAEDecoder, _llama_cfg,
                                   add_speech_factors, decode_latents)

SPEECH_START_ID = 151652
SPEECH_END_ID = 151653
SPEECH_DIFFUSION_ID = 151654
EOS_TOKEN_ID = 151643
VALID_SPEECH_TOKENS = (SPEECH_START_ID, SPEECH_END_ID, SPEECH_DIFFUSION_ID,
                       EOS_TOKEN_ID)
FINAL_LATENT_LOGIT_MARGIN = 5.0

PROMPT_BUCKETS = (64, 128, 256, 512, 1024)
LATENT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
CACHE_BUCKETS = (512, 1024, 2048, 4096)
LAT_MAX = 2048           # latent buffer rows on the device
# frames a chunk, one read of the status each. A bf16 frame of the lane
# waits on the host, so a read costs no measurable wall: on an H100 80GB HBM3
# at 700 W (tools/kugel_chunk_sweep.py) the 64-frame lane ran no slower in
# chunks of 1-8 than of 32, while a request ending on END ran up to C - 1
# frames past it (23 at C = 32, about a third of its wall). 4 keeps that
# tail to 3 frames and a read to every fourth frame.
CHUNK_FRAMES = 4


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "kugelaudio"
    model_path: Optional[str] = None
    sample_rate: int = 24000
    acoustic_tokenizer_config: AcousticTokenizerConfig = field(
        default_factory=AcousticTokenizerConfig)
    decoder_config: Qwen2DecoderConfig = field(
        default_factory=Qwen2DecoderConfig)
    diffusion_head_config: DiffusionHeadConfig = field(
        default_factory=DiffusionHeadConfig)
    acoustic_vae_dim: int = 64
    semantic_vae_dim: int = 128
    tie_word_embeddings: bool = False

    @classmethod
    def from_dict(cls, params: dict) -> "ModelConfig":
        params = dict(params or {})
        if "acostic_vae_dim" in params:      # upstream config typo
            params.setdefault("acoustic_vae_dim",
                              params.pop("acostic_vae_dim"))
        params.pop("semantic_tokenizer_config", None)
        return super().from_dict(params)

    def __post_init__(self):
        if isinstance(self.acoustic_tokenizer_config, dict):
            self.acoustic_tokenizer_config = AcousticTokenizerConfig \
                .from_dict(self.acoustic_tokenizer_config)
        if isinstance(self.decoder_config, dict):
            self.decoder_config = Qwen2DecoderConfig.from_dict(
                self.decoder_config)
        if isinstance(self.diffusion_head_config, dict):
            self.diffusion_head_config = DiffusionHeadConfig.from_dict(
                self.diffusion_head_config)


@dataclass
class FrameCarry:
    """The frame loop's state: the f32 KV caches (written in place), each
    CFG row's last hidden, the latent buffer and the counters on the
    device; the cache column of the next LM step on the host."""

    caches: KVCache
    hidden: torch.Tensor         # (rows, H)
    offset: int                  # row 0's next cache column
    pos: torch.Tensor            # 0-dim int64: row 0's next position
    neg_pos: torch.Tensor        # 0-dim int64: row 1's next position
    neg_mask: torch.Tensor       # (cache_len,) bool: columns row 1 sees
    n_lat: torch.Tensor          # 0-dim int64: latents kept
    n_tok: torch.Tensor          # 0-dim int64: frames run
    finished: torch.Tensor       # 0-dim bool
    latbuf: torch.Tensor         # (LAT_MAX, latent) f32


class Model(TorchModel):
    """KugelAudio-0-open (hybrid AR + diffusion, CFG) on `device`: the card
    by default; without CUDA the constructor raises unless given
    `device="cpu"`. Needs a tokenizer (`post_load_hook`, or any object
    with `encode(text, add_special_tokens=False)`) before `generate`."""

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
        with torch.device(device):
            self.language_model = LlamaModel(
                _llama_cfg(d, d.num_hidden_layers), device, lm_head=False)
            self.acoustic_connector = holder(
                fc1=Linear(config.acoustic_vae_dim, h),
                norm=RMSNorm(h, d.rms_norm_eps), fc2=Linear(h, h))
            self.prediction_head = DiffusionHead(
                config.diffusion_head_config, h)
            self.acoustic_tokenizer = holder(decoder=VAEDecoder(
                config.acoustic_tokenizer_config))
            add_speech_factors(self)
            if not config.tie_word_embeddings:
                self.lm_head = Linear(h, d.vocab_size, bias=False)
        self.register_buffer("valid_ids", torch.tensor(
            VALID_SPEECH_TOKENS, device=device), persistent=False)
        self.requires_grad_(False)
        self.eval()
        self.tokenizer = None
        self.last_run: Dict[str, float] = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    # ---------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict:
        """Drop the rotary buffers and put the LM's layers under
        `language_model.model.`; conv kernels keep torch's layouts, which
        are the port's."""
        out = {}
        for k, v in weights.items():
            if "rotary_emb.inv_freq" in k:
                continue
            if k.startswith("language_model.") and \
                    not k.startswith("language_model.model."):
                k = "language_model.model." + k[len("language_model."):]
            out[k] = np.asarray(v)
        return out

    def model_quant_predicate(self, path: str, w) -> bool:
        """Only the LM is quantized: the head, connector, VAE and lm_head
        stay dense."""
        return path.startswith("language_model.")

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The HF tokenizer from the model directory (never downloaded)."""
        model.tokenizer = local_tokenizer(model_path)
        return model

    # ----------------------------------------------------------- pieces

    def _dtype(self) -> torch.dtype:
        return self.language_model.model.embed_tokens.weight.dtype

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Full-vocabulary logits (the constrained pick reads 4 rows)."""
        if hasattr(self, "lm_head"):
            lg = self.lm_head(hidden)
        else:
            w = self.language_model.model.embed_tokens.weight
            lg = hidden @ w.to(hidden.dtype).T
        s = self.config.decoder_config.logits_scaling
        return lg / s if s != 1.0 else lg

    def _connector(self, latent: torch.Tensor) -> torch.Tensor:
        c = self.acoustic_connector
        return c.fc2(c.norm(c.fc1(latent.to(self._dtype()))))

    def _pick4_logits(self, h: torch.Tensor) -> torch.Tensor:
        """(H,) -> f32 logits (4,) of the valid speech tokens, from their
        4 rows of the head (dense, W8A8 or affine codes) in f32."""
        ids = self.valid_ids
        lm = getattr(self, "lm_head", None)
        if lm is None:
            w4 = self.language_model.model.embed_tokens.weight[ids].float()
        elif isinstance(lm, Int8Linear):
            w4 = lm.w_i8[ids].float() * lm.scale[ids].float()[:, None]
        elif isinstance(lm, QuantizedLinear):
            w4 = dequantize_weight({"w_q": lm.w_q[ids],
                                    "scales": lm.scales[ids],
                                    "biases": lm.biases[ids]})
        else:
            w4 = lm.weight[ids].float()
        out = w4 @ h.float()
        if lm is not None and lm.bias is not None:
            out = out + lm.bias[ids].float()
        s = self.config.decoder_config.logits_scaling
        return out / s if s != 1.0 else out

    def _draws(self, generator: torch.Generator, start: int, n: int,
               shape: Tuple[int, ...]) -> torch.Tensor:
        """(n, *shape) standard normal f32 draws for the latents start ..
        start + n - 1 (a test replaces this to feed JAX's draws)."""
        del start
        return torch.randn((n,) + tuple(shape), generator=generator,
                           device=self.device)

    # ------------------------------------------------------- frame loop

    @torch.no_grad()
    def prefill(self, ids: torch.Tensor, plen: int,
                cache_len: int) -> FrameCarry:
        """The prompt bucket ids (rows, pb) into fresh f32 caches of
        cache_len columns. Row 0 is the prompt, masked past plen; with CFG
        row 1 is the negative stream, a SPEECH_START at slot 0 that sees
        only that slot."""
        lm = self.language_model
        cfg = lm.config
        dev = self.device
        rows = ids.shape[0]
        caches = KVCache.init(rows, cache_len, cfg.num_key_value_heads,
                              cfg.resolved_head_dim, torch.float32, dev,
                              n_layers=cfg.num_hidden_layers)
        j = torch.arange(cache_len, device=dev)
        ninf = torch.full((cache_len,), float("-inf"), device=dev)
        masks = [torch.where(j < plen, 0.0, ninf),
                 torch.where(j == 0, 0.0, ninf)]
        hidden, _ = llama_forward(lm, ids, caches=caches, offset=0,
                                  mask=torch.stack(masks[:rows]))
        h = torch.stack([hidden[0, plen - 1], hidden[-1, 0]])[:rows]
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        latent = self.config.diffusion_head_config.latent_size
        return FrameCarry(
            caches=caches, hidden=h, offset=plen, pos=zero + plen,
            neg_pos=zero + 1, neg_mask=j == 0, n_lat=zero, n_tok=zero,
            finished=torch.zeros((), dtype=torch.bool, device=dev),
            latbuf=torch.zeros((LAT_MAX, latent), device=dev))

    def sde_sample(self, cond: torch.Tensor, neg_cond: torch.Tensor,
                   draws: torch.Tensor, tables: Dict[str, np.ndarray],
                   temb: torch.Tensor, cfg_scale: float) -> torch.Tensor:
        """One latent (1, latent) f32 by SDE-DPM-Solver++ from draws
        (1 + steps, latent): the start noise, then each step's. `temb`
        holds the steps' timestep embeddings; with cfg_scale > 1 each step
        is one head pass over (cond, neg_cond) and the guidance."""
        head = self.prediction_head
        use_cfg = cfg_scale > 1.0
        cond_h = head.cond_embed(torch.cat([cond, neg_cond], dim=0)
                                 if use_cfg else cond)
        speech = draws[0:1].float()
        prev_x0 = torch.zeros_like(speech)
        for k in range(len(tables["t"])):
            tab = {name: float(v[k]) for name, v in tables.items()}
            if use_cfg:
                eps = head.run(torch.cat([speech, speech], dim=0),
                               temb[k:k + 1], cond_h).float()
                guided = eps[1:] + cfg_scale * (eps[:1] - eps[1:])
            else:
                guided = head.run(speech, temb[k:k + 1], cond_h).float()
            x0 = tab["alpha"] * speech - tab["sigma"] * guided
            first = (tab["a_sample"] * speech + tab["b_x0"] * x0
                     + tab["c_noise"] * draws[1 + k:2 + k])
            if tab["use_first"] > 0:
                speech = first
            else:
                speech = first + 0.5 * tab["b_x0"] * (
                    tab["inv_r0"] * (x0 - prev_x0))
            prev_x0 = x0
        return speech

    @torch.no_grad()
    def chunk(self, c: FrameCarry, n: int, draws: torch.Tensor,
              first_latent: int, tables: Dict[str, np.ndarray],
              temb: torch.Tensor, cfg_scale: float) -> torch.Tensor:
        """n frames from `c` (advanced in place), nothing read on the host;
        draws (n, 1 + steps, latent) serve the latents first_latent ..
        first_latent + n - 1. -> status (3,) int64 on the device: latents
        kept, frames run, finished."""
        rows = c.hidden.shape[0]
        cache_len = c.neg_mask.shape[0]
        j = torch.arange(cache_len, device=c.neg_mask.device)
        for _ in range(n):
            hidden = c.hidden
            logits4 = self._pick4_logits(hidden[0])
            a = torch.argmax(logits4)
            is_diff = a == 2
            is_end = (a == 1) | (a == 3)
            margin_ok = logits4[2] > logits4[a] - FINAL_LATENT_LOGIT_MARGIN
            emit = is_diff | (is_end & margin_ok & (c.n_lat > 0))
            live = ~c.finished
            lat = self.sde_sample(
                hidden[0:1], hidden[rows - 1:rows],
                draws[(c.n_lat - first_latent).clamp(0, n - 1)], tables,
                temb, cfg_scale)
            row = c.n_lat.clamp(max=LAT_MAX - 1)
            keep = emit & live
            c.latbuf[row] = torch.where(keep, lat[0], c.latbuf[row])
            c.n_lat = c.n_lat + keep
            c.n_tok = c.n_tok + live
            c.finished = c.finished | is_end
            embed = torch.where(
                is_diff, self._connector(lat)[0],
                self.language_model.model.embed_tokens(self.valid_ids[a]))
            x = embed.expand(rows, 1, embed.shape[-1])
            m0 = j <= c.offset
            if rows == 2:
                mask = torch.stack([m0, c.neg_mask | (j == c.offset)])
                positions = torch.stack([c.pos, c.neg_pos])[:, None]
            else:
                mask, positions = m0[None], c.pos[None, None]
            hseq, _ = llama_forward(self.language_model, x,
                                    positions=positions, caches=c.caches,
                                    offset=c.offset, mask=mask)
            # the step counts only when this frame did not finish; row 1
            # advances only on a diffusion embed, otherwise its hidden is
            # held and the column it wrote stays outside its mask
            ran = ~c.finished
            adv = ran & is_diff
            h = [torch.where(ran, hseq[0, 0], hidden[0])]
            if rows == 2:
                h.append(torch.where(adv, hseq[1, 0], hidden[1]))
                c.neg_mask = c.neg_mask | ((j == c.offset) & adv)
                c.neg_pos = c.neg_pos + adv
            c.hidden = torch.stack(h)
            c.offset += 1
            c.pos = c.pos + 1
        return torch.stack([c.n_lat, c.n_tok, c.finished.long()])

    # ------------------------------------------------------------ request

    def _build_prompt_tokens(self, text: str) -> List[int]:
        formatted = text.strip()
        if not formatted.startswith("Speaker"):
            formatted = f"Speaker 0: {formatted}"
        full = (" Transform the text provided by various speakers into "
                "speech output, utilizing the distinct voice of each "
                "respective speaker.\n"
                f" Text input:\n {formatted}\n Speech output:\n")
        toks = list(self.tokenizer.encode(full, add_special_tokens=False))
        toks.append(SPEECH_START_ID)
        return toks

    @torch.no_grad()
    def generate(self, text: str, voice: Optional[str] = None,
                 cfg_scale: float = 3.0, max_tokens: int = 2048,
                 ddpm_steps: Optional[int] = None, verbose: bool = False,
                 seed: int = 0, **kwargs) -> Iterator[GenerationResult]:
        """Text -> one GenerationResult. `last_run` then holds the prompt
        bucket, cache length, chunks, frames (those that count, and those
        the device ran, whole chunks), latents, and the seconds of the
        prefill, the frame loop and the VAE decode."""
        del voice
        if not text or not text.strip():
            raise ValueError("text must be a non-empty string")
        if self.tokenizer is None:
            raise RuntimeError("Tokenizer not loaded")
        cfg = self.config
        if max_tokens > LAT_MAX:
            warnings.warn(
                f"kugelaudio max_tokens={max_tokens} exceeds the on-device "
                f"latent capacity LAT_MAX={LAT_MAX}; clamping", stacklevel=2)
            max_tokens = LAT_MAX
        dh = cfg.diffusion_head_config
        steps = ddpm_steps if ddpm_steps is not None else \
            dh.ddpm_num_inference_steps
        dev = self.device
        t0 = time.perf_counter()
        prompt = self._build_prompt_tokens(text)
        plen = len(prompt)
        if plen > PROMPT_BUCKETS[-1]:
            raise ValueError(f"a prompt of {plen} tokens exceeds the largest "
                             f"prompt bucket {PROMPT_BUCKETS[-1]}")
        pb = _bucket(plen, PROMPT_BUCKETS)
        rows = 2 if cfg_scale > 1.0 else 1
        cache_len = _bucket(plen + max_tokens + 1, CACHE_BUCKETS)
        ids = torch.zeros((rows, pb), dtype=torch.int64)
        ids[0, :plen] = torch.tensor(prompt)
        if rows == 2:
            ids[1, 0] = SPEECH_START_ID
        carry = self.prefill(ids.to(dev), plen, cache_len)
        if dev.type == "cuda":          # the prefill's time, for last_run
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        tables = sde_dpm_tables(dh.ddpm_num_steps, steps,
                                dh.ddpm_beta_schedule)
        temb = self.prediction_head.t_embed(
            torch.from_numpy(tables["t"]).to(dev))
        gen = torch.Generator(device=dev).manual_seed(seed)
        n_lat = n_tok = chunks = ran = 0
        fin = False
        while not fin and n_tok < max_tokens:
            n = min(CHUNK_FRAMES, max_tokens - n_tok)
            draws = self._draws(gen, n_lat, n, (1 + steps, dh.latent_size))
            status = self.chunk(carry, n, draws, n_lat, tables, temb,
                                cfg_scale)
            n_lat, n_tok, fin = status.tolist()
            chunks += 1
            ran += n
        t2 = time.perf_counter()
        self.last_run = {"prompt_len": plen, "prompt_bucket": pb,
                         "cache_len": cache_len, "chunks": chunks,
                         "frames": n_tok, "frames_run": ran,
                         "latents": n_lat,
                         "prefill_s": t1 - t0, "frames_s": t2 - t1,
                         "vae_s": 0.0}
        total = plen + n_tok
        if n_lat == 0:
            yield self._result(np.zeros((0,), np.float32), total,
                               max(time.perf_counter() - t0, 1e-6))
            return
        lb = min(_bucket(n_lat, LATENT_BUCKETS), carry.latbuf.shape[0])
        seq = carry.latbuf[:lb][None]
        scale = self.speech_scaling_factor.float()
        bias = self.speech_bias_factor.float()
        seq = torch.where(torch.isnan(scale), seq, seq / scale - bias)
        hop = int(np.prod(cfg.acoustic_tokenizer_config.ratios))
        audio = decode_latents(self.acoustic_tokenizer.decoder, seq)
        audio = audio[0, :n_lat * hop].cpu().numpy()
        self.last_run["vae_s"] = time.perf_counter() - t2
        peak = np.abs(audio).max()
        if peak > 1.0:
            audio = audio * (0.95 / peak)
        yield self._result(audio, total, time.perf_counter() - t0)

    def _result(self, audio, n_tokens, dt) -> GenerationResult:
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=0, token_count=n_tokens,
            audio_duration=format_duration(dur),
            real_time_factor=round(dt / max(dur, 1e-6), 2),
            prompt={"tokens": n_tokens,
                    "tokens-per-sec": round(n_tokens / dt, 2)},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / dt, 2)},
            processing_time_seconds=dt, peak_memory_usage=peak_memory_gb())


__all__ = ["Model", "ModelConfig", "FrameCarry", "SPEECH_START_ID",
           "SPEECH_END_ID", "SPEECH_DIFFUSION_ID", "EOS_TOKEN_ID",
           "VALID_SPEECH_TOKENS", "LAT_MAX", "CHUNK_FRAMES"]
