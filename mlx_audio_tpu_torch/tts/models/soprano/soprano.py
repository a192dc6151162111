"""Soprano: a token TTS whose Qwen3 LM's hidden states feed a Vocos head.

Counterpart of mlx_audio_tpu/tts/models/soprano/soprano.py: the configs
(`DecoderConfig`, `ModelConfig`, whose `__post_init__` picks the decoder
variant from the directory name, :80-92), `lm_forward` (:140: the Qwen3
layers of the port's `Qwen3LM`, QK norm, a tied or own head; it returns
the logits and the post-norm hidden rows), `decode_hidden` (:166: a 4x
linear `interpolate1d` with `align_corners`, the embed conv, ConvNeXt
blocks of a depthwise conv, LayerNorm, an exact-GELU MLP and gamma, the
final LayerNorm, the `out` linear, `exp` magnitudes clipped at 1e2 and the
phase, then `dsp.istft` at n_fft 2,048, hop 512, a periodic Hann window,
`center=True`), `preprocess_text` (:223), `generate` and the loaders.

The decode is a stepper of its own (`Decode`): the JAX package prefills a
`PROMPT_BUCKETS` bucket under a pad mask and runs chunks of 32 `lax.scan`
steps that mask every step from `[STOP]` on; here the prompt runs
unpadded into f32 caches of prompt + max_tokens columns, the chunk is 32
eager steps with its state on the device (the draw from a
`torch.Generator`, the stop, each step's post-norm hidden row), and one
read a chunk brings its tokens and its stop flag to the host; the kept
rows are gathered on the device. The kept tokens and rows are JAX's up
to `max_tokens`.

Departures, each pinned by a test in tests/test_torch_soprano.py:

* the decode stops at `max_tokens`. JAX's `generate` keeps every kept
  token of whole 32-step chunks, so a request yields up to 31 more than
  `max_tokens`, and its caches of bucket + max_tokens columns take a
  chunk's writes past their end, which `dynamic_update_slice` clamps onto
  earlier columns;
* `sanitize` reads each conv's layout (torch (O, I/g, K), MLX (O, K, I/g)
  or WIO) from the model's own shapes (`model.convs_to_wio`). JAX's
  guesses it from `shape[0] > shape[-1]` and misreads an MLX depthwise
  (C, K, 1) or an MLX embed conv (O, K, I);
* `post_load_hook` reads the directory's tokenizer only and raises on
  files that fail to load (JAX's leaves no tokenizer on any error);
* a bf16 model's head runs the magnitudes and phases in f32.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....dsp import istft
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Conv1d, LayerNorm, Linear, gelu
from ....ops.interpolate import interpolate1d
from ....ops.kvcache import KVCache
from ....ops.sampling import make_sampler
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)
from ..moss_tts.config import Qwen3LMConfig
from ..moss_tts.moss_tts import Qwen3LM, qwen3_lm_forward
from .text import clean_text

CHUNK = 32


@dataclass
class DecoderConfig(BaseModelArgs):
    decoder_num_layers: int = 8
    decoder_dim: int = 768
    decoder_intermediate_dim: int = 2304
    hop_length: int = 512
    n_fft: int = 2048
    upscale: int = 4
    input_kernel: int = 1
    dw_kernel: int = 3
    token_size: int = 2048
    receptive_field: int = 4


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "soprano"
    hidden_size: int = 512
    num_hidden_layers: int = 12
    intermediate_size: int = 2048
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    vocab_size: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = True
    sample_rate: int = 32000
    decoder_config: Optional[DecoderConfig] = None
    model_path: str = ""

    def __post_init__(self):
        if isinstance(self.decoder_config, dict):
            self.decoder_config = DecoderConfig.from_dict(
                self.decoder_config)
        if self.decoder_config is None:
            # a checkpoint config without decoder dims: the variant from
            # the directory name
            self.decoder_config = DecoderConfig()
            if self.model_path and "soprano-1.1" not in \
                    self.model_path.lower():
                self.decoder_config.decoder_dim = 512
                self.decoder_config.decoder_intermediate_dim = 1536
                self.decoder_config.input_kernel = 3

    @property
    def lm_config(self) -> Qwen3LMConfig:
        return Qwen3LMConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            head_dim=self.head_dim, rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta,
            tie_word_embeddings=self.tie_word_embeddings)


class ConvNeXtBlock(nn.Module):
    """dwconv -> LayerNorm -> pwconv1 -> GELU -> pwconv2, scaled by gamma."""

    def __init__(self, dim: int, inter: int, kernel: int, n_layers: int):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, kernel, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, inter)
        self.pwconv2 = Linear(inter, dim)
        self.gamma = nn.Parameter(torch.empty(dim))
        self.init_fill = {"gamma": 1.0 / n_layers}
        self.pad = (kernel - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.dwconv(x, padding=self.pad))
        h = self.pwconv2(gelu(self.pwconv1(h)))
        return x + self.gamma.to(x.dtype) * h


def lm_forward(model: "Model", embeds: torch.Tensor,
               caches: Optional[KVCache], offset: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embeds (B, T, D) -> (f32 logits (B, T, V), post-norm hidden (B, T,
    D)); causal, the caches (if any) written at the host int `offset`."""
    hidden, _ = qwen3_lm_forward(model.language_model, embeds, caches,
                                 offset)
    lm = model.language_model
    if hasattr(lm, "lm_head"):
        logits = lm.lm_head(hidden)
    else:
        logits = hidden @ lm.embed_tokens.weight.to(hidden.dtype).T
    return logits.float(), hidden


def decode_hidden(model: "Model", hidden: torch.Tensor) -> torch.Tensor:
    """(1, L, C) hidden rows -> (1, samples) f32 audio."""
    d = model.config.decoder_config
    dec = model.decoder.decoder
    target = d.upscale * (hidden.shape[1] - 1) + 1
    x = interpolate1d(hidden.to(dec.norm.weight.dtype), size=target,
                      mode="linear", align_corners=True)
    x = dec.norm(dec.embed(x, padding=(d.input_kernel - 1) // 2))
    for blk in dec.convnext:
        x = blk(x)
    x = dec.final_layer_norm(x)
    h = model.decoder.head.out(x).float()
    mag, phase = h.chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(mag), max=1e2)
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    w = np.hanning(d.n_fft + 1)[:-1].astype(np.float32)
    audio = istft(spec[0], hop_length=d.hop_length, win_length=d.n_fft,
                  window=w, center=True)
    return audio[None]


class Decode:
    """The prefill and the 32-step chunks of one request (see the module
    docstring): `start` runs the prompt, `chunk` advances the state in
    place and returns (the kept tokens, whether the request stopped)."""

    def __init__(self, model: "Model", temperature: float, top_p: float,
                 stop_id: int):
        self.model = model
        self.sampler = make_sampler(temperature=temperature, top_p=top_p)
        self.stop_id = int(stop_id)

    @torch.inference_mode()
    def start(self, ids, max_tokens: int, seed: int) -> dict:
        m = self.model
        lm = m.language_model
        dev = m.device
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)[None]
        n = ids_t.shape[1]
        caches = lm.make_caches(m.config.lm_config, 1, n + max_tokens)
        logits, hidden = lm_forward(m, lm.embed_tokens(ids_t), caches, 0)
        return {"logits": logits[:, -1], "caches": caches, "t": n,
                "step": 0, "max_tokens": max_tokens,
                "done": torch.zeros(1, dtype=torch.bool, device=dev),
                "rows": [hidden[:, -1]], "tokens": [],
                "generator": torch.Generator(device=dev).manual_seed(
                    int(seed))}

    @torch.inference_mode()
    def chunk(self, state: dict, n_steps: int = CHUNK
              ) -> Tuple[List[int], bool]:
        m = self.model
        lm = m.language_model
        toks, hids = [], []
        for _ in range(min(n_steps, state["max_tokens"] - state["step"])):
            tok = self.sampler(state["logits"], None, state["generator"])
            state["done"] = state["done"] | (tok == self.stop_id)
            toks.append(torch.where(state["done"], -1, tok))
            logits, hidden = lm_forward(m, lm.embed_tokens(tok[:, None]),
                                        state["caches"], state["t"])
            state["logits"] = logits[:, -1]
            hids.append(hidden[:, -1])
            state["t"] += 1
            state["step"] += 1
        if not toks:
            return [], True
        read = torch.cat([torch.stack(toks, dim=1),
                          state["done"][:, None].long()], dim=1)[0].tolist()
        keep = [i for i, t in enumerate(read[:-1]) if t >= 0]
        if keep:
            rows = torch.stack(hids, dim=1)[:, keep]
            state["rows"].extend(rows.unbind(1))
        kept = [read[i] for i in keep]
        state["tokens"].extend(kept)
        return kept, bool(read[-1]) or state["step"] >= state["max_tokens"]


class Model(TorchModel):
    """Soprano on `device`: the card by default; without CUDA the
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
        d = config.decoder_config
        with torch.device(device):
            self.language_model = Qwen3LM(config.lm_config)
            if not config.tie_word_embeddings:
                self.language_model.lm_head = Linear(
                    config.hidden_size, config.vocab_size, bias=False)
            self.decoder = holder(
                decoder=holder(
                    embed=Conv1d(config.hidden_size, d.decoder_dim,
                                 d.input_kernel),
                    norm=LayerNorm(d.decoder_dim, eps=1e-6),
                    convnext=nn.ModuleList(
                        ConvNeXtBlock(d.decoder_dim,
                                      d.decoder_intermediate_dim,
                                      d.dw_kernel, d.decoder_num_layers)
                        for _ in range(d.decoder_num_layers)),
                    final_layer_norm=LayerNorm(d.decoder_dim, eps=1e-6)),
                head=holder(out=Linear(d.decoder_dim, d.n_fft + 2)))
        self.requires_grad_(False)
        self.eval()
        self._tokenizer = None
        self._stop_token_id: Optional[int] = None
        self.last_run: dict = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    # ------------------------------------------------- text handling

    @staticmethod
    def preprocess_text(text: str, min_length: int = 30) -> List[str]:
        """Sentence split + short-sentence merge -> prompts."""
        cleaned = clean_text(text.strip())
        sentences = [s for s in re.split(r"(?<=[.!?])\s+", cleaned) if s]
        if min_length > 0 and len(sentences) > 1:
            merged: List[str] = []
            for s in sentences:
                if len(s) < min_length and merged:
                    merged[-1] = (merged[-1] + " " + s).strip()
                else:
                    merged.append(s)
            sentences = merged
        return [f"[STOP][TEXT]{s}[START]" for s in sentences]

    def stop_id(self) -> int:
        if self._stop_token_id is not None:
            return int(self._stop_token_id)
        return int(self._tokenizer.encode("[STOP]",
                                          add_special_tokens=False)[0])

    # --------------------------------------------------------- generate

    def decode_tokens(self, ids, max_tokens: int, temperature: float,
                      top_p: float, seed: int) -> Tuple[List[int],
                                                        torch.Tensor]:
        """The decode of one prompt -> (the kept tokens, their hidden rows
        (1, 1 + kept, D) after the prompt's last row, on the device).
        `last_run` gets the prompt length, chunks, steps and tokens."""
        dec = Decode(self, temperature, top_p, self.stop_id())
        state = dec.start(ids, max_tokens, seed)
        chunks = 0
        while True:
            _, stopped = dec.chunk(state)
            chunks += 1
            if stopped:
                break
        self.last_run = {"prompt_len": len(ids), "chunks": chunks,
                         "steps": state["step"],
                         "tokens": len(state["tokens"])}
        return state["tokens"], torch.stack(state["rows"], dim=1)

    def generate(self, text: str, voice: Optional[str] = None,
                 temperature: float = 0.3, top_p: float = 0.95,
                 split_pattern: str = "\n", max_tokens: int = 512,
                 verbose: bool = False, seed: int = 0, **kwargs):
        if self._tokenizer is None:
            raise RuntimeError("soprano needs its HF tokenizer (place "
                               "tokenizer files in the model directory)")
        pieces = [p for p in text.replace("\\n", "\n").split(split_pattern)
                  if p.strip()] if split_pattern else [text]
        prompts = [pr for piece in pieces
                   for pr in self.preprocess_text(piece)]
        for idx, prompt in enumerate(prompts):
            t0 = time.perf_counter()
            ids = list(self._tokenizer.encode(prompt,
                                              add_special_tokens=False))
            n = len(ids)
            toks, rows = self.decode_tokens(ids, max_tokens, temperature,
                                            top_p, seed + idx)
            with torch.inference_mode():
                audio = decode_hidden(self, rows)[0].cpu().numpy()
            dt = time.perf_counter() - t0
            dur = len(audio) / self.sample_rate
            yield GenerationResult(
                audio=audio, samples=len(audio),
                sample_rate=self.sample_rate, segment_idx=idx,
                token_count=len(toks), audio_duration=format_duration(dur),
                real_time_factor=round(dt / dur, 2) if dur else 0.0,
                prompt={"tokens": n,
                        "tokens-per-sec": round(n / dt, 2) if dt else 0},
                audio_samples={"samples": len(audio),
                               "samples-per-sec":
                                   round(len(audio) / dt, 2) if dt else 0},
                processing_time_seconds=dt,
                peak_memory_usage=peak_memory_gb())

    # ---------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict:
        """A checkpoint -> the JAX tree: `model.` dropped, the LM's leaves
        under `language_model.`, each conv weight read into WIO from the
        layout its shape shows."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if k.startswith("model."):
                k = k[len("model."):]
            if not k.startswith(("language_model.", "decoder.")):
                k = "language_model." + k
            out[k] = np.asarray(v)
        return convs_to_wio(
            out, shapes, lambda k, v: (".dwconv." in k or k.endswith(
                "decoder.embed.weight")) and np.ndim(v) == 3)

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`; files that fail to load raise) and its stop id:
        the pad id, else the id of `[STOP]`."""
        tok = local_tokenizer(model_path)
        model._tokenizer = tok
        if tok is not None:
            if tok.pad_token_id is not None:
                model._stop_token_id = tok.pad_token_id
            else:
                ids = tok.encode("[STOP]", add_special_tokens=False)
                model._stop_token_id = ids[0] if ids else None
        return model


__all__ = ["Model", "ModelConfig", "DecoderConfig", "ConvNeXtBlock",
           "decode_hidden", "lm_forward", "Decode", "CHUNK"]
