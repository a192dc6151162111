"""OmniVoice: MaskGIT-style non-autoregressive TTS over 8 RVQ codebooks
with a bidirectional Qwen3 backbone, decoded by the Higgs Audio codec.

Counterpart of mlx_audio_tpu/tts/models/omnivoice/omnivoice.py:
`backbone_forward` (:133: Qwen3 layers with per-head QK norm and
rotate-half RoPE, bidirectional attention), `_forward` (:271: the text
table at text rows and the sum of the 8 audio tables at audio rows, then 8
heads), the unmask of `_unmask_fn` (:295-368: per step a conditional pass
and, when `guidance_scale` != 0, an unconditional one over the target
rows, guided log-softmax with the mask id barred, a top-10% class filter
with Gumbel noise at `class_temperature`, confidences less
`layer_penalty_factor` x layer with Gumbel noise at
`position_temperature`, a reveal of the top `k_sched[s]` still-masked
slots), the host schedule of `_time_steps` and `_run_unmask`
(:291, :370-418), `_prepare_inputs`, `_target_len`, `generate`,
`generate_batch`, `sanitize` (:247-267: the stacked tables split into 8)
and `post_load_hook`; the text helpers `combine_text` and
`tokenize_with_nonverbal_tags`.

The unmask runs as an eager loop on the device with no host read inside
(JAX's is one `lax.scan`); the heads run on the target rows alone, the
only ones read (the same numbers). The Gumbel noise's uniforms come from a
`torch.Generator` through `_draws`, the seam through which the tests hand
the port JAX's; a tie at the reveal threshold reveals what JAX's reveals.

Departures, each pinned by a test in tests/test_torch_omnivoice.py:

* the audio tables are gathered with the ids clamped into them: JAX's
  `_forward` looks text ids up in the 1,025-row audio tables too, where
  `jnp.take` fills the rows past them with NaN and the `where` drops
  them; a torch lookup past its table fails on the card. The numbers are
  JAX's;
* the rows of a batch attend to their own keys only: JAX's backbone has no
  attention mask, so a shorter row of a mixed-length batch attends to the
  padding (mask ids) in both passes and its tokens differ from the row's
  alone. The port masks the padded keys, so a batched row equals the row
  alone; a batch of one, and rows of one length, equal JAX's;
* `generate_batch` raises without a codec (JAX's returns silence);
* `post_load_hook` reads the directory only: its HF tokenizer
  (`local_tokenizer`) and the Higgs codec of an `audio_tokenizer/`
  subfolder; files that fail to load raise (JAX's warns, and binds a
  codec loaded non-strictly from the model directory itself: one with no
  weights).

The codec (`audio_tokenizer`) is held outside the module tree: its
weights are not this model's.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Generator, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Embedding, Linear, RMSNorm
from ....ops.rope import rope_cos_sin, rope_freqs
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)
from ..qwen3_tts.talker import Qwen3Layer

_NONVERBAL_PATTERN = re.compile(
    r"\[(laughter|sigh|confirmation-en|question-en|question-ah|"
    r"question-oh|question-ei|question-yi|surprise-ah|surprise-oh|"
    r"surprise-wa|surprise-yo|dissatisfaction-hnn)\]")

SAMPLES_PER_TOKEN = 960


@dataclass
class BackboneConfig(BaseModelArgs):
    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    intermediate_size: int = 3072
    vocab_size: int = 151676
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 40960


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "omnivoice"
    audio_vocab_size: int = 1025           # 1024 codes + mask
    audio_mask_id: int = 1024
    num_audio_codebook: int = 8
    audio_codebook_weights: List[int] = field(
        default_factory=lambda: [8, 8, 6, 6, 4, 4, 2, 2])
    sample_rate: int = 24000
    llm_config: Optional[Dict] = None
    model_path: Optional[str] = None

    @property
    def backbone_config(self) -> BackboneConfig:
        return BackboneConfig.from_dict(self.llm_config or {})


class Backbone(nn.Module):
    """`backbone` of the JAX tree: `embed_tokens`, `layers.N`, `norm`."""

    def __init__(self, c: BackboneConfig):
        super().__init__()
        self.embed_tokens = Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(
            Qwen3Layer(c.hidden_size, c.num_attention_heads,
                       c.num_key_value_heads, c.head_dim,
                       c.intermediate_size, False, c.rms_norm_eps)
            for _ in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.register_buffer("inv_freq", rope_freqs(c.head_dim, c.rope_theta),
                             persistent=False)


def backbone_forward(p: Backbone, embeds: torch.Tensor,
                     key_valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(B, S, D) -> (B, S, D): bidirectional attention over every key, or
    over the keys `key_valid` (B, S) marks."""
    b, s, _ = embeds.shape
    pos = torch.arange(s, device=embeds.device)[None, :]
    cos, sin = rope_cos_sin(pos, p.inv_freq)
    mask = None
    if key_valid is not None:
        mask = torch.zeros(key_valid.shape, device=embeds.device).masked_fill(
            ~key_valid, float("-inf"))[:, None, None, :]
    x = embeds
    for layer in p.layers:
        x = layer(x, cos, sin, None, 0, mask)
    return p.norm(x)


# ----------------------------------------------------------- text utils

def combine_text(text: str, ref_text: Optional[str] = None) -> str:
    full = (ref_text.strip() + " " + text.strip()) if ref_text else \
        text.strip()
    full = re.sub(r"[\r\n]+", "", full)
    full = re.sub(r"[ \t]+", " ", full)
    cjk = r"[一-鿿]"
    return re.sub(rf"(?<={cjk})\s+|\s+(?={cjk})", "", full)


def tokenize_with_nonverbal_tags(text: str, tokenizer) -> List[int]:
    """Keep [laughter]-style tags atomic."""
    parts: List[int] = []
    last = 0
    for m in _NONVERBAL_PATTERN.finditer(text):
        if m.start() > last:
            parts.extend(tokenizer(text[last:m.start()],
                                   add_special_tokens=False).input_ids)
        parts.extend(tokenizer(m.group(),
                               add_special_tokens=False).input_ids)
        last = m.end()
    if last < len(text):
        parts.extend(tokenizer(text[last:],
                               add_special_tokens=False).input_ids)
    if not parts:
        parts = list(tokenizer(text, add_special_tokens=False).input_ids)
    return parts


def _ensure_list(x, n: int):
    if x is None:
        return [None] * n
    if not isinstance(x, list):
        return [x] * n
    if len(x) != n:
        raise ValueError(f"Expected list of length {n}, got {len(x)}")
    return x


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u + 1e-10) + 1e-10)


# ------------------------------------------------------------------ model

class Model(TorchModel):
    """OmniVoice on `device`: the card by default; without CUDA the
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
        bc = config.backbone_config
        c, v = config.num_audio_codebook, config.audio_vocab_size
        with torch.device(device):
            self.backbone = Backbone(bc)
            self.audio_embeddings = holder(**{
                str(i): Embedding(v, bc.hidden_size) for i in range(c)})
            self.audio_heads = holder(**{
                str(i): Linear(bc.hidden_size, v, bias=False)
                for i in range(c)})
        self.requires_grad_(False)
        self.eval()
        self.text_tokenizer = None
        self.audio_tokenizer = None
        self.last_run: dict = {}

    def __setattr__(self, name, value):
        # the codec is held outside the module tree: its weights are not
        # this model's (a state_dict, a bind or a cast leaves it alone)
        if name == "audio_tokenizer":
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def sanitize(self, weights):
        """A checkpoint -> the JAX tree: the stacked audio tables and heads
        split into the codebooks', `llm.` -> `backbone.`."""
        cfg = self.config
        c, v = cfg.num_audio_codebook, cfg.audio_vocab_size
        out = {}
        for k, w in weights.items():
            w = np.asarray(w)
            if k == "codebook_layer_offsets":
                continue
            if k in ("audio_embeddings.weight", "audio_heads.weight"):
                name = k.split(".")[0]
                for i in range(c):
                    out[f"{name}.{i}.weight"] = w[i * v:(i + 1) * v]
                continue
            if k.startswith("llm."):
                k = "backbone." + k[4:]
            out[k] = w
        return out

    # --------------------------------------------------------- forward

    def _hidden(self, ids: torch.Tensor, audio_mask: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """unified ids (B, L, C) + audio mask (B, L) -> hidden (B, L, D)."""
        cfg = self.config
        bc = cfg.backbone_config
        text_e = self.backbone.embed_tokens(
            ids[..., 0].clamp(0, bc.vocab_size - 1))
        audio_ids = ids.clamp(0, cfg.audio_vocab_size - 1)
        audio_e = sum(getattr(self.audio_embeddings, str(i))(
            audio_ids[..., i]) for i in range(cfg.num_audio_codebook))
        embeds = torch.where(audio_mask[..., None], audio_e, text_e)
        return backbone_forward(self.backbone, embeds, key_valid)

    def _heads(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (B, U, D) -> f32 logits (B, U, C, V)."""
        return torch.stack([getattr(self.audio_heads, str(i))(hidden)
                            for i in range(self.config.num_audio_codebook)],
                           dim=2).float()

    def _forward(self, ids: torch.Tensor,
                 audio_mask: torch.Tensor) -> torch.Tensor:
        """unified ids (B, L, C) + audio mask (B, L) -> logits (B, L, C,
        V)."""
        return self._heads(self._hidden(ids, audio_mask))

    # ----------------------------------------------------------- unmask

    @staticmethod
    def _time_steps(num_steps: int, t_shift: float) -> List[float]:
        ts = [i / num_steps for i in range(num_steps + 1)]
        return [t_shift * t / (1.0 + (t_shift - 1.0) * t) for t in ts]

    def _draws(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Uniforms in [0, 1) of `shape` for the Gumbel noise."""
        return torch.rand(shape, generator=generator, device=self.device)

    @torch.inference_mode()
    def unmask(self, ids: torch.Tensor, cond_mask: torch.Tensor,
               row_lens: torch.Tensor, u_start: torch.Tensor,
               t_lens: torch.Tensor, k_sched: torch.Tensor, U: int,
               guidance_scale: float, class_temperature: float,
               position_temperature: float, layer_penalty_factor: float,
               generator: torch.Generator) -> torch.Tensor:
        """The whole unmask on the device: ids (B, L, C), cond_mask (B, L),
        row_lens (B,) (each row's rows, its valid keys), u_start (B,),
        t_lens (B,), k_sched (S, B) -> the ids after the last step."""
        cfg = self.config
        C, V, mask_id = (cfg.num_audio_codebook, cfg.audio_vocab_size,
                         cfg.audio_mask_id)
        B, L, _ = ids.shape
        dev = ids.device
        layer_pen = torch.arange(C, dtype=torch.float32,
                                 device=dev) * layer_penalty_factor
        topk_k = max(1, math.ceil(0.1 * V))
        ar_u = torch.arange(U, device=dev)
        gidx = torch.clamp(u_start[:, None] + ar_u[None], 0, L + U - 1)
        valid_u = ar_u[None] < t_lens[:, None]
        key_valid = torch.arange(L, device=dev)[None] < row_lens[:, None]
        uncond_mask = torch.ones((B, U), dtype=torch.bool, device=dev)
        pad = torch.full((B, U, C), mask_id, dtype=ids.dtype, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        barred = torch.arange(V, device=dev) == mask_id
        for s in range(k_sched.shape[0]):
            hidden = self._hidden(ids, cond_mask, key_valid)
            hidden = torch.cat([hidden, hidden.new_zeros(
                (B, U, hidden.shape[-1]))], dim=1)[rows, gidx]
            ext = torch.cat([ids, pad], dim=1)
            u_ids = ext[rows, gidx]                          # (B, U, C)
            lc = torch.log_softmax(self._heads(hidden), dim=-1)
            if guidance_scale != 0:
                lu = torch.log_softmax(self._heads(self._hidden(
                    u_ids, uncond_mask, valid_u)), dim=-1)
                lp_t = torch.log_softmax(lc + guidance_scale * (lc - lu),
                                         dim=-1)
            else:
                lp_t = lc
            lp_t = lp_t.masked_fill(barred, float("-inf"))
            if class_temperature > 0.0:
                thr = torch.topk(lp_t, topk_k, dim=-1).values[..., -1:]
                filt = torch.where(lp_t >= thr, lp_t,
                                   torch.full_like(lp_t, float("-inf")))
                new_toks = torch.argmax(
                    filt / class_temperature
                    + _gumbel(self._draws(filt.shape, generator)), dim=-1)
            else:
                new_toks = torch.argmax(lp_t, dim=-1)        # (B, U, C)
            conf = lp_t.max(dim=-1).values - layer_pen[None, None]
            if position_temperature > 0.0:
                conf = conf / position_temperature + _gumbel(
                    self._draws(conf.shape, generator))
            still = (u_ids == mask_id) & valid_u[..., None]
            score = torch.where(still, conf, torch.full_like(
                conf, float("-inf"))).reshape(B, U * C)
            srt = torch.sort(score, dim=-1, descending=True).values
            kc = torch.clamp(k_sched[s], 1, U * C)
            thr = srt.gather(1, (kc - 1)[:, None])
            reveal = (score >= thr).reshape(B, U, C) & still
            upd = torch.where(reveal, new_toks.to(ids.dtype), u_ids)
            ext[rows, gidx] = upd
            ids = ext[:, :L]
        return ids

    def _run_unmask(self, rows: List[dict], target_lens: List[int],
                    num_steps: int, guidance_scale: float,
                    class_temperature: float, position_temperature: float,
                    layer_penalty_factor: float, t_shift: float,
                    seed: int) -> List[np.ndarray]:
        cfg = self.config
        C, mask_id = cfg.num_audio_codebook, cfg.audio_mask_id
        B = len(rows)
        L = max(r["input_ids"].shape[1] for r in rows)
        U = max(target_lens)
        L = max(L, U)

        ids = np.full((B, L, C), mask_id, np.int64)
        cond_mask = np.zeros((B, L), bool)
        u_start = np.zeros((B,), np.int64)
        row_lens = np.zeros((B,), np.int64)
        for i, r in enumerate(rows):
            cl = r["input_ids"].shape[1]
            ids[i, :cl] = np.asarray(r["input_ids"][0])
            cond_mask[i, :cl] = np.asarray(r["audio_mask"][0])
            u_start[i] = cl - target_lens[i]
            row_lens[i] = cl

        ts = self._time_steps(num_steps, t_shift)
        k_sched = np.zeros((num_steps, B), np.int64)
        for i, tl in enumerate(target_lens):
            total = tl * C
            for s in range(num_steps):
                k = max(1, math.ceil(total * (ts[s + 1] - ts[s])))
                k_sched[s, i] = total if s == num_steps - 1 else k

        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        out = self.unmask(
            t(ids), t(cond_mask), t(row_lens), t(u_start),
            t(np.asarray(target_lens, np.int64)), t(k_sched), U,
            guidance_scale, class_temperature, position_temperature,
            layer_penalty_factor,
            torch.Generator(device=dev).manual_seed(int(seed)))
        out = out.cpu().numpy()
        self.last_run = {"rows": B, "L": L, "U": U, "steps": num_steps,
                         "passes": num_steps * (1 + (guidance_scale != 0))}
        results = []
        for i, r in enumerate(rows):
            cl = r["input_ids"].shape[1]
            toks = out[i, cl - target_lens[i]:cl]
            results.append(np.where(toks == mask_id, 0, toks))
        return results

    # ----------------------------------------------------- prompt build

    def _tokenize_style_and_text(self, text, language="None",
                                 instruct="None", denoise=True,
                                 ref_text=None):
        if self.text_tokenizer is None:
            raise ValueError("text_tokenizer is required; pass one or load "
                             "the model via load_model()")
        style = ("<|denoise|>" if denoise else "") + \
            f"<|lang_start|>{language}<|lang_end|>" + \
            f"<|instruct_start|>{instruct}<|instruct_end|>"
        style_ids = list(self.text_tokenizer(
            style, add_special_tokens=False).input_ids)
        wrapped = f"<|text_start|>{combine_text(text, ref_text)}" \
            f"<|text_end|>"
        text_ids = tokenize_with_nonverbal_tags(wrapped,
                                                self.text_tokenizer)
        return style_ids, text_ids

    def _prepare_inputs(self, style_ids, text_ids, T,
                        ref_tokens=None) -> dict:
        cfg = self.config
        C, mask_id = cfg.num_audio_codebook, cfg.audio_mask_id
        n_text = len(style_ids) + len(text_ids)
        blocks = [np.repeat(np.asarray(style_ids + text_ids,
                                       np.int32)[None, :, None], C, 2)]
        if ref_tokens is not None and len(ref_tokens):
            blocks.append(np.asarray(ref_tokens, np.int32)[None])
        blocks.append(np.full((1, T, C), mask_id, np.int32))
        input_ids = np.concatenate(blocks, axis=1)
        L = input_ids.shape[1]
        audio_mask = np.concatenate(
            [np.zeros((1, n_text), bool), np.ones((1, L - n_text), bool)],
            axis=1)
        return {"input_ids": input_ids, "audio_mask": audio_mask}

    def _target_len(self, text: str, duration_s: Optional[float]) -> int:
        if duration_s is not None:
            return math.ceil(duration_s * self.config.sample_rate
                             / SAMPLES_PER_TOKEN)
        from .duration import RuleDurationEstimator

        raw = RuleDurationEstimator().estimate_duration(
            text or "", "Nice to meet you.", 25)
        return max(10, int(raw * 1.15))

    def _encode_ref(self, ref_audio, max_duration_s: float):
        from .utils import create_voice_clone_prompt

        if self.audio_tokenizer is None:
            raise ValueError("audio tokenizer (HiggsAudio codec) required "
                             "for voice cloning via ref_audio")
        if isinstance(ref_audio, (str, Path)):
            return create_voice_clone_prompt(
                str(ref_audio), tokenizer=self.audio_tokenizer,
                max_duration_s=max_duration_s)
        return np.asarray(self.audio_tokenizer.encode(
            np.asarray(ref_audio, np.float32).reshape(-1)), np.int32)

    # ---------------------------------------------------------- generate

    def generate(self, text: Optional[str] = None,
                 duration_s: Optional[float] = None,
                 language: str = "None", lang_code: str = "None",
                 instruct: str = "None", ref_audio=None,
                 ref_text: Optional[str] = None,
                 ref_audio_max_duration_s: float = 10.0,
                 num_steps: int = 32, guidance_scale: float = 2.0,
                 class_temperature: float = 0.0,
                 position_temperature: float = 5.0,
                 layer_penalty_factor: float = 5.0, t_shift: float = 0.1,
                 ref_tokens=None, seed: int = 0, **kwargs
                 ) -> Generator[GenerationResult, None, None]:
        results = self.generate_batch(
            [text or ""], language=language, lang_code=lang_code,
            ref_text=ref_text, ref_audio=ref_audio, ref_tokens=ref_tokens,
            duration_s=duration_s, instruct=instruct,
            ref_audio_max_duration_s=ref_audio_max_duration_s,
            num_steps=num_steps, guidance_scale=guidance_scale,
            class_temperature=class_temperature,
            position_temperature=position_temperature,
            layer_penalty_factor=layer_penalty_factor, t_shift=t_shift,
            seed=seed)
        yield from results

    def generate_batch(self, text: Union[str, List[str]],
                       language="None", lang_code="None", ref_text=None,
                       ref_audio=None, ref_tokens=None, duration_s=None,
                       instruct="None",
                       ref_audio_max_duration_s: float = 10.0,
                       num_steps: int = 32, guidance_scale: float = 2.0,
                       class_temperature: float = 0.0,
                       position_temperature: float = 5.0,
                       layer_penalty_factor: float = 5.0,
                       t_shift: float = 0.1, max_batch_size: int = 8,
                       seed: int = 0, **kwargs
                       ) -> List[GenerationResult]:
        cfg = self.config
        if not isinstance(text, list):
            text = [text]
        if not text:
            return []
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be at least 1")
        if self.audio_tokenizer is None:
            raise RuntimeError(
                "OmniVoice needs its Higgs Audio codec to decode audio: "
                "bind one as `audio_tokenizer`, or load a directory with an "
                "audio_tokenizer/ subfolder")
        B = len(text)
        languages = _ensure_list(language, B)
        lang_codes = _ensure_list(lang_code, B)
        ref_texts = _ensure_list(ref_text, B)
        ref_tok_list = _ensure_list(ref_tokens, B)
        durations = _ensure_list(duration_s, B)
        instructs = _ensure_list(instruct, B)
        languages = [lang_codes[i] if languages[i] == "None"
                     and lang_codes[i] != "None" else languages[i]
                     for i in range(B)]
        if ref_audio is not None:
            ref_audios = _ensure_list(ref_audio, B)
            for i in range(B):
                if ref_tok_list[i] is None and ref_audios[i] is not None:
                    ref_tok_list[i] = self._encode_ref(
                        ref_audios[i], ref_audio_max_duration_s)

        rows, target_lens = [], []
        for i in range(B):
            style_ids, text_ids = self._tokenize_style_and_text(
                text[i], language=languages[i], instruct=instructs[i],
                denoise=ref_tok_list[i] is not None,
                ref_text=ref_texts[i])
            tl = self._target_len(text[i], durations[i])
            target_lens.append(tl)
            rows.append(self._prepare_inputs(style_ids, text_ids, tl,
                                             ref_tok_list[i]))

        results: List[GenerationResult] = []
        for cs in range(0, B, max_batch_size):
            ce = min(cs + max_batch_size, B)
            t0 = time.perf_counter()
            token_list = self._run_unmask(
                rows[cs:ce], target_lens[cs:ce], num_steps,
                guidance_scale, class_temperature, position_temperature,
                layer_penalty_factor, t_shift, seed + cs)
            dt = max(time.perf_counter() - t0, 1e-6)
            for j, tokens in enumerate(token_list):
                idx = cs + j
                tl = target_lens[idx]
                audio = np.asarray(self.audio_tokenizer.decode(tokens),
                                   np.float32)
                n = tl * SAMPLES_PER_TOKEN
                dur = n / cfg.sample_rate
                results.append(GenerationResult(
                    audio=audio, samples=n, sample_rate=cfg.sample_rate,
                    segment_idx=idx, token_count=tl,
                    audio_duration=format_duration(dur),
                    real_time_factor=round(dur / dt, 3),
                    prompt={"tokens": tl,
                            "tokens-per-sec": round(tl / dt, 2)},
                    audio_samples={"samples": n,
                                   "samples-per-sec": round(n / dt, 2)},
                    processing_time_seconds=dt,
                    peak_memory_usage=peak_memory_gb()))
        return results

    # ---------------------------------------------------------- loading

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`) and the Higgs Audio codec of its `audio_tokenizer/`
        subfolder, on the model's device in f32; files that fail to load
        raise."""
        model_path = Path(model_path)
        model.text_tokenizer = local_tokenizer(model_path)
        sub = model_path / "audio_tokenizer"
        if sub.is_dir():
            model.audio_tokenizer = load_higgs_codec(sub, model.device)
        return model


def load_higgs_codec(path: Path, device) -> TorchModel:
    """The Higgs Audio codec of a local directory: the published
    checkpoint through its `sanitize`, or a directory the convert CLI
    wrote (the JAX tree)."""
    from ....codec.models.higgs_audio import Model as HiggsCodec
    from ....codec.models.higgs_audio import ModelConfig as HiggsConfig
    from ....model import load_jax_params
    from ....utils import is_converted, load_config, load_weights

    config = load_config(path)
    codec = HiggsCodec(HiggsConfig.from_dict(config), device=device)
    weights = load_weights(path)
    if is_converted(config):
        return load_jax_params(codec, weights)
    return codec.bind(codec.sanitize(weights))


__all__ = ["Model", "ModelConfig", "BackboneConfig", "Backbone",
           "backbone_forward", "combine_text",
           "tokenize_with_nonverbal_tags", "load_higgs_codec",
           "SAMPLES_PER_TOKEN"]
