"""MOSS-TTS: a Qwen3 LM with 32 RVQ channels, in three checkpoint
layouts, and the Qwen3 LM that ten families share.

Counterpart of mlx_audio_tpu/tts/models/moss_tts/moss_tts.py.

The Qwen3 LM (`init_qwen3_lm` :76-86, `qwen3_lm_forward` :89-107): the
token table `embed_tokens`, the Qwen3 layers (`qwen3_tts.talker.
Qwen3Layer`, QK-norm GQA attention and a SiLU MLP) and the final RMSNorm
`norm`, under the JAX tree's names. Any config with the Qwen3 text fields
builds it (Qwen3-ASR's `TextConfig` as well as `Qwen3LMConfig`); VyvoTTS,
Soprano, the Qwen3 LM STT families and the `stt/models/qwen3_lm.py`
stepper run on it.

The model (`Model`) in its three layouts, each decoded on the device:

* the delay pattern (`moss_tts_delay`; `generate_delay_pattern_ids`,
  :577-650, with the step of `_delay_chunk_fn`, :450-575): a frame is one
  LM step, the text-channel state machine (`is_audio`, `is_stopping`,
  `audio_lengths`, `delayed_lengths` with its SENTINEL), the 32 audio
  channels sampled at once with the pad code barred and a rolling
  repetition window of HISTORY_WIN, then the counters and the next row.
  The JAX package scans chunks of CHUNK_FRAMES; here each chunk is that
  many eager frames with the state on the device and one read a chunk,
  and the prompt runs unpadded;
* the v1.5 local transformer (`moss_tts_local`; `generate_v15_local_ids`,
  :840-899, with `_v15_frame_fn`, :653-721): the text choice between the
  slot and the end token from the local head's first row, then the 32
  dependent channels through the one-layer GPT-2 over the growing buffer,
  each followed by its head's rows and a draw, then one LM step. JAX
  re-runs the GPT-2 over the buffer's prefix at each channel; here the
  GPT-2 keeps a cache over the frame's n_vq + 1 positions (the same
  numbers). JAX reads the text token every frame; here a chunk of
  CHUNK_FRAMES frames runs with one read, and the frames after the first
  that ends are dropped (nothing after them is kept, so nothing rolls
  back);
* the legacy local transformer (`generate_local_ids`, :901-949, with
  `_legacy_frame_fn`, :723-807): a small Qwen3 stack without RoPE
  (`_local_qwen3_forward`, :118) over per-channel MLPs, re-run over the
  channel buffer as JAX does, chunks as above. Its repetition penalty
  applies only when it samples (:741), as in JAX.

The embeddings (`_embed_rows_delay`, `_embed_rows_legacy`,
`_embed_rows_v15`, :400-433; in v1.5 the pad entries are masked out) sum
the 32 channel rows in f32. `sanitize` (:285-339) stacks the per-channel
tables and heads into (n_vq V, D); `model_quant_predicate` (:341) keeps
`audio_embeddings` dense. `generate` (:1000-1125), `_decode_generated_
audio` (:951-979) and the v1.5 stream decode audio through a bound
`audio_tokenizer` (its `encode_audio` and `decode_audio_codes`), and
raise without one, as JAX's do (:378-383). Categorical draws are
Gumbel-max: the noise comes from `_gumbel(kind, shape, generator)`, the
seam through which the tests hand the port JAX's draws (JAX's
`jax.random.categorical` adds its Gumbel noise to the logits the same
way); greedy decoding (temperature 0, or `do_sample=False`) draws
nothing. The LM's caches are f32, as JAX's.

Departures, each pinned by a test in tests/test_torch_moss_tts.py:

* the delay decode stops at `max_new_tokens`: JAX keeps whole chunks of 8
  (:636-643), so a request yields up to 7 more rows than asked, and with
  a prompt near the end of its 8,192-column cache a chunk writes past
  it; the port's rows equal JAX's up to `max_new_tokens`;
* the prompt runs unpadded, so any prompt length runs: JAX pads it to a
  bucket that caps at 4,096 rows (:67-72) and fails past it (:598,
  :820). The port's cache holds the prompt plus `max_new_tokens` columns
  and raises only when that passes MAX_CACHE_LEN;
* `stream=True` yields each chunk as soon as it is decoded. JAX's
  `_stream_v15` gathers every chunk and yields them after the last frame
  (:1196); the chunks are the same, in the same order;
* q8 of the local layouts: their frames reshape `audio_lm_heads.weight`
  to (n_vq, V, D) (:698, :757, :777), a leaf the JAX package's q8 has
  quantized, so JAX's q8 v1.5 and legacy models fail (KeyError
  'weight'). The port runs each channel's rows of the quantized head
  (rows c V to (c + 1) V; the groups run along the input) on K2;
* `post_load_hook` reads the directory only (`local_tokenizer`) and
  raises on tokenizer files or a `generation_config.json` that fail to
  load; JAX's leaves no tokenizer on any error (:346-351).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....model import TorchModel, check_device, holder
from ....nn import Embedding, Linear, QuantizedLinear, RMSNorm, rms_norm
from ....ops import quant
from ....ops.kvcache import KVCache
from ....ops.sampling import apply_repetition_penalty, top_k_top_p_filter
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)
from ..moss_tts_nano.gpt2 import GPT2, gpt2_forward, gpt2_make_caches
from ..qwen3_tts.talker import LayerStack, Qwen3Layer
from .config import ModelConfig, Qwen3LMConfig
from .processor import (MossTTSDelayProcessor, MossTTSLocalProcessor,
                        MossTTSLocalV15Processor, apply_de_delay_pattern)

MAX_CACHE_LEN = 8192
CHUNK_FRAMES = 8
HISTORY_WIN = 128
SENTINEL = 2 ** 30


class Qwen3LM(LayerStack):
    """`embed_tokens`, `layers.N`, `norm` (init_qwen3_lm's tree) with the
    RoPE table of `cfg.rope_theta`."""

    def __init__(self, cfg):
        super().__init__(cfg.num_hidden_layers, cfg.hidden_size,
                         cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim, cfg.intermediate_size,
                         cfg.attention_bias, cfg.rms_norm_eps, cfg.rope_theta)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size)

    def make_caches(self, cfg, batch: int, max_len: int,
                    dtype=torch.float32) -> KVCache:
        """Stacked (layers, batch, max_len, kv heads, head dim) caches on
        the LM's device, f32 by default as the JAX callers make them."""
        return KVCache.init(batch, max_len, cfg.num_key_value_heads,
                            cfg.head_dim, dtype, self.norm.weight.device,
                            n_layers=cfg.num_hidden_layers)


def init_qwen3_lm(cfg, device="cpu") -> Qwen3LM:
    """An empty `Qwen3LM` of `cfg` on `device`, for inference (the owning
    model's `init_params` or a bind fills it)."""
    with torch.device(device):
        return Qwen3LM(cfg).requires_grad_(False).eval()


def qwen3_lm_forward(lm: Qwen3LM, embeds: torch.Tensor,
                     caches: Optional[KVCache], offset: int,
                     pad_mask: Optional[torch.Tensor] = None,
                     deepstack: Optional[Sequence[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """embeds (B, T, D) -> (normed hidden (B, T, D), caches): causal over
    the prompt, the caches (if any) written in place at the host int
    `offset`; `pad_mask` (B, S) additive over the cache's columns (or the
    T keys without a cache) masks a right-padded prompt; `deepstack`
    (B, T, D) tensors are added after the first layers, one a layer.

    The layers see a view of the caches' first offset + T columns, the only
    ones a query may attend to, so a decode step reads the keys written so
    far, not the whole buffer (JAX's reads the whole buffer and masks the
    rest, which gives the same result)."""
    view = caches
    if caches is not None:
        used = offset + embeds.shape[1]
        view = KVCache(caches.k[:, :, :used], caches.v[:, :, :used])
        if pad_mask is not None:
            pad_mask = pad_mask[:, :used]
    lengths = None if pad_mask is None else pad_mask[:, None, None, :]
    return lm.run(embeds, view, offset, lengths,
                  deepstack=deepstack), caches


def lm_logits(owner, hidden: torch.Tensor) -> torch.Tensor:
    """The logits of a model that holds a `Qwen3LM` as `owner.model`: its
    `lm_head` over `hidden`, or the tied token table where it has none."""
    if hasattr(owner, "lm_head"):
        return owner.lm_head(hidden)
    return hidden @ owner.model.embed_tokens.weight.to(hidden.dtype).T



# ------------------------------------------------ local qwen3 (no rope)

class LocalQwen3(nn.Module):
    """The legacy local transformer (`_init_local_qwen3`): Qwen3 layers and
    a final `norm`, run without positions."""

    def __init__(self, cfg: Qwen3LMConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            Qwen3Layer(cfg.hidden_size, cfg.num_attention_heads,
                       cfg.num_key_value_heads, cfg.head_dim,
                       cfg.intermediate_size, False, cfg.rms_norm_eps)
            for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


def local_qwen3_forward(p: LocalQwen3, x: torch.Tensor) -> torch.Tensor:
    """Causal Qwen3 blocks over x (B, T, D) WITHOUT RoPE (the reference's
    MossTTSLocalAttention has QK-norm but no positions): the rotation by
    angle 0 leaves q and k as they are."""
    t = x.shape[1]
    hd = p.layers[0].self_attn.head_dim
    cos = torch.ones((t, 1, hd // 2), device=x.device)
    sin = torch.zeros((t, 1, hd // 2), device=x.device)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    mask = torch.zeros(t, t, device=x.device).masked_fill(
        ~keep, float("-inf"))
    for layer in p.layers:
        x = layer(x, cos, sin, None, 0, mask)
    return p.norm(x)


class MLP(nn.Module):
    """`gate_proj`, `up_proj` (in -> hidden), `down_proj` (hidden -> out),
    SiLU-gated (`_init_mlp`, `_mlp`)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.gate_proj = Linear(in_dim, hidden, bias=False)
        self.up_proj = Linear(in_dim, hidden, bias=False)
        self.down_proj = Linear(hidden, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def linear_rows(m: nn.Module, x: torch.Tensor, start: int,
                stop: int) -> torch.Tensor:
    """Output rows start:stop of the linear `m` over x: a dense head's
    rows, or an affine-quantized one's (K2 on the card), sliced from its
    codes and their per-row scales (the groups run along the input)."""
    if isinstance(m, Linear):
        return F.linear(x, m.weight[start:stop].to(x.dtype))
    if isinstance(m, QuantizedLinear):
        return quant.qmatmul(x, m.w_q[start:stop], m.scales[start:stop],
                             m.biases[start:stop])
    raise TypeError(f"no row slice for {type(m).__name__}")


# ------------------------------------------------------------- sampling

def _filtered(lg: torch.Tensor, temperature: float, top_p: float,
              top_k: int) -> torch.Tensor:
    return top_k_top_p_filter(lg / temperature, top_k=top_k or 0,
                              top_p=top_p if top_p else 1.0)


def _gumbel_max(lg: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical`'s draw: argmax(logits + Gumbel noise)."""
    return torch.argmax(lg + gumbel.to(lg.device, lg.dtype), dim=-1)


# ----------------------------------------------------------------- model

class Model(TorchModel):
    """The MOSS-TTS family model (delay, legacy local or v1.5 local) on
    `device`: the card by default; without CUDA the constructor raises
    unless given `device="cpu"`."""

    SANITIZE_GIVES_JAX_TREE = True

    def __init__(self, config=None, device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        if config.language_config is None:
            raise ValueError("MOSS-TTS requires language_config")
        super().__init__(config)
        cfg = config
        lc = cfg.language_config
        d = lc.hidden_size
        sizes = self._codebook_sizes()
        with torch.device(device):
            if cfg.is_v15_local_transformer:
                if len(set(sizes)) != 1:
                    raise NotImplementedError(
                        "stacked v15 heads require uniform codebook sizes")
                v = sizes[0]
                self.transformer = Qwen3LM(lc)
                self.audio_embeddings = Embedding(cfg.n_vq * v, d)
                self.text_lm_head = Linear(d, lc.vocab_size, bias=False)
                self.audio_lm_heads = Linear(d, cfg.n_vq * v, bias=False)
                if self._binary_text_head():
                    self.local_text_lm_head = Linear(d, 2, bias=False)
                self.local_transformer = GPT2(cfg.local_gpt2_config(),
                                              use_token_embedding=False)
            elif cfg.is_legacy_local_transformer:
                va = cfg.audio_vocab_size + 1
                ld, ffn = int(cfg.local_hidden_size), \
                    int(cfg.additional_mlp_ffn_hidden_size)
                self.model = holder(
                    text_embedding=Embedding(lc.vocab_size, d),
                    audio_embeddings=Embedding(cfg.n_vq * va, d),
                    language_model=Qwen3LM(lc))
                self.local_transformer = LocalQwen3(
                    cfg.local_transformer_config())
                self.speech_embedding_to_local_mlp = MLP(d, ffn, ld)
                self.local_to_speech_embedding_mlps = nn.ModuleDict(
                    {str(i): MLP(ld, ffn, d) for i in range(self.channels)})
                self.layer_norm_before_lm_heads = nn.ModuleDict(
                    {str(i): RMSNorm(d, lc.rms_norm_eps)
                     for i in range(self.channels)})
                self.text_lm_head = Linear(d, lc.vocab_size, bias=False)
                self.audio_lm_heads = Linear(d, cfg.n_vq * va, bias=False)
            else:
                va = cfg.audio_vocab_size + 1
                self.language_model = Qwen3LM(lc)
                self.audio_embeddings = Embedding(cfg.n_vq * va, d)
                self.text_lm_head = Linear(d, lc.vocab_size, bias=False)
                self.audio_lm_heads = Linear(d, cfg.n_vq * va, bias=False)
        self.requires_grad_(False)
        self.eval()
        self.tokenizer = None
        self.audio_tokenizer = None
        self.generation_config: Dict[str, object] = {}
        self.last_run: dict = {}

    @property
    def sample_rate(self) -> int:
        return int(self.config.sampling_rate)

    @property
    def channels(self) -> int:
        return 1 + int(self.config.n_vq)

    def _codebook_sizes(self) -> List[int]:
        cfg = self.config
        return (cfg.audio_codebook_sizes
                or [cfg.audio_vocab_size] * cfg.n_vq)

    def _binary_text_head(self) -> bool:
        return str(self.config.local_text_head_mode).strip().lower() == \
            "binary"

    def lm(self) -> Qwen3LM:
        """The global Qwen3 LM of this layout."""
        cfg = self.config
        if cfg.is_v15_local_transformer:
            return self.transformer
        if cfg.is_legacy_local_transformer:
            return self.model.language_model
        return self.language_model

    # ------------------------------------------------------------ loading

    def sanitize(self, weights):
        """Map upstream keys to the stacked layout (:285-339): per-channel
        tables stack into (n_vq V, D) embeddings and (n_vq V, D) fused
        heads; delay: `model.emb_ext.{c}`, `model.lm_heads.{i}`; legacy:
        `model.embedding_list.{i}`, `lm_heads.{i}`; v1.5:
        `audio_embeddings.{c}`, `audio_lm_heads.{c}`."""
        cfg = self.config
        out, emb_rows, head_rows = {}, {}, {}
        for key, w in weights.items():
            w = np.asarray(w)
            if key.startswith("model.") and not cfg.is_local_transformer:
                key = key[len("model."):]
            parts = key.split(".")
            if cfg.is_v15_local_transformer and parts[0] in (
                    "audio_embeddings", "audio_lm_heads"):
                (emb_rows if parts[0] == "audio_embeddings"
                 else head_rows)[int(parts[1])] = w
                continue
            if not cfg.is_local_transformer and parts[0] == "emb_ext":
                emb_rows[int(parts[1])] = w
                continue
            if parts[0] == "lm_heads":
                idx = int(parts[1])
                if idx == 0:
                    out["text_lm_head.weight"] = w
                else:
                    head_rows[idx - 1] = w
                continue
            if parts[0] == "embedding_list" or key.startswith(
                    "model.embedding_list."):
                idx = int(parts[-2])
                if idx == 0:
                    out["model.text_embedding.weight"] = w
                else:
                    emb_rows[idx - 1] = w
                continue
            out[key] = w
        if emb_rows:
            tgt = ("audio_embeddings.weight"
                   if not cfg.is_legacy_local_transformer
                   else "model.audio_embeddings.weight")
            out[tgt] = np.concatenate(
                [emb_rows[c] for c in range(len(emb_rows))], axis=0)
        if head_rows:
            out["audio_lm_heads.weight"] = np.concatenate(
                [head_rows[c] for c in range(len(head_rows))], axis=0)
        return out

    def model_quant_predicate(self, path, w):
        return not any(p in path for p in ("audio_embeddings",
                                           "audio_tokenizer"))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (`local_tokenizer`: None without
        tokenizer files; files that fail to load raise) and its
        `generation_config.json` (a file that fails to parse raises)."""
        model.tokenizer = local_tokenizer(model_path)
        gc = Path(model_path) / "generation_config.json"
        if gc.exists():
            cfg = json.loads(gc.read_text())
            model.generation_config = cfg if isinstance(cfg, dict) else {}
        return model

    def _gc(self, key: str, default):
        v = self.generation_config.get(key, default)
        return default if v is None else v

    def _processor(self):
        cfg = self.config
        if cfg.is_v15_local_transformer:
            return MossTTSLocalV15Processor(self.tokenizer, cfg)
        if cfg.is_legacy_local_transformer:
            return MossTTSLocalProcessor(self.tokenizer, cfg)
        return MossTTSDelayProcessor(self.tokenizer, cfg)

    # ------------------------------------------------------------ codec

    def _ensure_audio_tokenizer(self, source=None):
        if self.audio_tokenizer is None:
            raise RuntimeError(
                "MOSS-TTS needs the MOSS audio tokenizer bound "
                "(model.audio_tokenizer = ...)")
        return self.audio_tokenizer

    def encode_reference_audio(self, ref_audio, *, sample_rate=None,
                               num_quantizers=None, source=None):
        tok = self._ensure_audio_tokenizer(source)
        return tok.encode_audio(ref_audio, sample_rate=sample_rate,
                                num_quantizers=num_quantizers
                                or self.config.n_vq)

    def decode_audio_token_ids(self, codes, *, num_quantizers=None,
                               source=None):
        tok = self._ensure_audio_tokenizer(source)
        return tok.decode_audio_codes(codes, num_quantizers=num_quantizers
                                      or self.config.n_vq)

    # -------------------------------------------------------- embeddings

    def _channel_sum(self, table: Embedding, ids: torch.Tensor, size: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sum over channels of table rows ids (..., n_vq) + c size,
        in f32 (masked by `valid` where given)."""
        offs = torch.arange(self.config.n_vq, device=ids.device) * size
        emb = table(ids + offs).float()
        if valid is not None:
            emb = emb * valid[..., None]
        return emb.sum(dim=-2)

    def _embed_rows_delay(self, rows: torch.Tensor) -> torch.Tensor:
        """Delay layout: text emb + per-channel emb (the pad code is a
        row)."""
        e = self.language_model.embed_tokens(rows[..., 0])
        va = self.config.audio_vocab_size + 1
        return e + self._channel_sum(self.audio_embeddings, rows[..., 1:],
                                     va).to(e.dtype)

    def _embed_rows_legacy(self, rows: torch.Tensor) -> torch.Tensor:
        e = self.model.text_embedding(rows[..., 0])
        va = self.config.audio_vocab_size + 1
        return e + self._channel_sum(self.model.audio_embeddings,
                                     rows[..., 1:], va).to(e.dtype)

    def _embed_rows_v15(self, rows: torch.Tensor) -> torch.Tensor:
        """v1.5: the pad channel entries are masked out (ref :525-537)."""
        e = self.transformer.embed_tokens(rows[..., 0])
        ids = rows[..., 1:]
        valid = ids != self.config.audio_pad_token_id
        return e + self._channel_sum(
            self.audio_embeddings, torch.where(valid, ids, 0),
            self._codebook_sizes()[0], valid).to(e.dtype)

    # ----------------------------------------------------------- pieces

    def _gumbel(self, kind: str, shape: Tuple[int, ...],
                generator: torch.Generator) -> torch.Tensor:
        """Gumbel noise of `shape` for a categorical draw of `kind` ("text"
        or "audio"), f32 on the device."""
        u = torch.rand(shape, generator=generator, device=self.device)
        return -torch.log(-torch.log(u.clamp_(min=1e-20)))

    def _lm_step(self, embeds: torch.Tensor, caches: KVCache,
                 offset: int) -> torch.Tensor:
        """One LM step of embeds (1, 1, D) at the host int `offset` ->
        hidden (1, D)."""
        hidden, _ = qwen3_lm_forward(self.lm(), embeds, caches, offset)
        return hidden[:, -1]

    def _prefill(self, rows: torch.Tensor, embed: Callable, n: int,
                 extra: int) -> Tuple[KVCache, Optional[torch.Tensor]]:
        """Caches of n + extra columns, the first n prompt rows run through
        the LM -> (caches, the last row's hidden (1, D), or None for
        n = 0)."""
        cfg = self.config
        lm = self.lm()
        if n + extra > MAX_CACHE_LEN:
            raise ValueError(
                f"MOSS-TTS: a {rows.shape[1]}-row prompt and {extra} new "
                f"frames pass the {MAX_CACHE_LEN}-column cache")
        caches = lm.make_caches(cfg.language_config, 1, n + extra)
        if n == 0:
            return caches, None
        hidden, _ = qwen3_lm_forward(lm, embed(rows[:, :n]), caches, 0)
        return caches, hidden[:, -1]

    def _rows_tensor(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(input_ids, np.int64),
                               device=self.device)

    # ------------------------------------------------ the delay pattern

    def _delay_masks(self) -> dict:
        cfg = self.config
        v = cfg.language_config.vocab_size
        dev = self.device

        def mark(ids):
            m = torch.zeros(v, dtype=torch.bool, device=dev)
            m[list(ids)] = True
            return m

        return {
            "exclude_outside": mark([cfg.pad_token_id,
                                     cfg.audio_assistant_gen_slot_token_id,
                                     cfg.audio_assistant_delay_slot_token_id,
                                     cfg.audio_end_token_id]),
            "keep_inside": mark([cfg.audio_assistant_gen_slot_token_id,
                                 cfg.audio_assistant_delay_slot_token_id]),
            "delay_slot": mark([cfg.audio_assistant_delay_slot_token_id]),
            "im_end": mark([cfg.im_end_token_id]),
            "channels": torch.arange(cfg.n_vq, device=dev),
            "audio_counted": torch.tensor(
                [cfg.audio_start_token_id,
                 cfg.audio_assistant_gen_slot_token_id,
                 cfg.audio_assistant_delay_slot_token_id], device=dev)}

    def delay_frame(self, s: dict, k: dict) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """One delay-pattern frame from the state `s` (advanced in place)
        with the sampling knobs `k` -> (the new row (n_vq + 1,), done)."""
        cfg = self.config
        n_vq = cfg.n_vq
        va = cfg.audio_vocab_size + 1
        m = k["masks"]
        neg = float("-inf")
        h = self._lm_step(self._embed_rows_delay(s["row"]), s["caches"],
                          s["offset"])
        text_logits = self.text_lm_head(h).float()
        audio_logits = self.audio_lm_heads(h).float().reshape(n_vq, va)

        # the text channel's state machine (ref :795-839)
        tl = torch.where(s["is_audio"],
                         text_logits.masked_fill(~m["keep_inside"], neg),
                         text_logits.masked_fill(m["exclude_outside"], neg))
        if s["step"] == 0:
            tl = tl.masked_fill(m["delay_slot"], neg)
        if s["step"] <= n_vq:
            tl = tl.masked_fill(m["im_end"], neg)
        if k["text_do"]:
            sampled_text = _gumbel_max(
                _filtered(tl, k["text_temperature"], k["text_top_p"],
                          k["text_top_k"]),
                self._gumbel("text", tuple(tl.shape), s["generator"]))[0]
        else:
            sampled_text = torch.argmax(tl, dim=-1)[0]
        dl = s["delayed_lengths"]
        in_delay = dl < n_vq
        at_delay_end = dl == n_vq
        next_text = torch.where(
            s["is_stopping"], cfg.pad_token_id,
            torch.where(in_delay, cfg.audio_assistant_delay_slot_token_id,
                        torch.where(at_delay_end, cfg.audio_end_token_id,
                                    sampled_text)))
        is_audio = torch.where(
            ~s["is_stopping"] & at_delay_end, False,
            torch.where(next_text == cfg.audio_start_token_id, True,
                        s["is_audio"]))
        is_stopping = s["is_stopping"] | (next_text == cfg.im_end_token_id)

        # the audio channels (ref :841-869), all at once
        ch = m["channels"]
        active = (s["audio_lengths"] > ch) & torch.where(
            dl == SENTINEL, True, ch > dl - 1)
        al = audio_logits.clone()
        al[:, cfg.audio_pad_code] = neg
        al = apply_repetition_penalty(al, s["history"],
                                      k["audio_repetition_penalty"])
        if k["audio_do"]:
            toks = _gumbel_max(
                _filtered(al, k["audio_temperature"], k["audio_top_p"],
                          k["audio_top_k"]),
                self._gumbel("audio", tuple(al.shape), s["generator"]))
        else:
            toks = torch.argmax(al, dim=-1)
        toks = torch.where(active, toks, cfg.audio_pad_code)

        # the counters (ref :871-888)
        lengths = torch.where(torch.isin(next_text, m["audio_counted"]),
                              s["audio_lengths"] + 1, s["audio_lengths"])
        s["audio_lengths"] = torch.where(
            next_text == cfg.audio_end_token_id, 0, lengths)
        dl = torch.where(
            (dl == SENTINEL)
            & (next_text == cfg.audio_assistant_delay_slot_token_id), 0, dl)
        dl = torch.where(dl != SENTINEL, dl + 1, dl)
        s["delayed_lengths"] = torch.where(dl > n_vq, SENTINEL, dl)
        row = torch.cat([next_text[None], toks])
        s["row"] = row[None, None]
        s["history"] = torch.cat([s["history"][:, 1:], toks[:, None]], dim=1)
        s["done"] = s["done"] | is_stopping
        s["is_audio"], s["is_stopping"] = is_audio, is_stopping
        s["offset"] += 1
        s["step"] += 1
        return row, s["done"]

    @torch.inference_mode()
    def start_delay(self, input_ids, max_new_tokens: int, seed: int = 0
                    ) -> dict:
        """The prefill of rows [0, plen - 1) of input_ids (1, plen,
        n_vq + 1) and the state a delay frame advances: the last prompt
        row is the first frame's input, at column plen - 1."""
        cfg = self.config
        rows = np.asarray(input_ids, np.int64)
        if rows.ndim != 3:
            raise ValueError(f"Expected rank-3 input_ids, got {rows.shape}")
        if rows.shape[0] != 1:
            raise NotImplementedError("MOSS-TTS batch generation TBD")
        if rows.shape[-1] != cfg.n_vq + 1:
            raise ValueError(f"Expected {cfg.n_vq + 1} channels, "
                             f"got {rows.shape[-1]}")
        plen = rows.shape[1]
        rows_t = self._rows_tensor(rows)
        caches, _ = self._prefill(rows_t, self._embed_rows_delay, plen - 1,
                                  1 + max_new_tokens)
        text_col = rows[0, :, 0]
        is_cont = int(text_col[-1]) in {
            cfg.audio_start_token_id, cfg.audio_assistant_gen_slot_token_id}
        starts = np.flatnonzero(text_col == cfg.audio_start_token_id)
        audio_start_idx = int(starts[-1]) if len(starts) else -1
        is_audio = bool(is_cont and audio_start_idx != -1)
        dev = self.device

        def scalar(v, dtype=torch.long):
            return torch.tensor(v, dtype=dtype, device=dev)

        return {"caches": caches, "row": rows_t[:, -1:], "offset": plen - 1,
                "step": 0, "is_audio": scalar(is_audio, torch.bool),
                "is_stopping": scalar(False, torch.bool),
                "audio_lengths": scalar(plen - audio_start_idx
                                        if is_audio else 0),
                "delayed_lengths": scalar(SENTINEL),
                "history": torch.full((cfg.n_vq, HISTORY_WIN), -1,
                                      dtype=torch.long, device=dev),
                "done": scalar(False, torch.bool),
                "generator": torch.Generator(device=dev).manual_seed(
                    int(seed))}

    def delay_knobs(self, text_temperature=1.5, text_top_p=1.0,
                    text_top_k=50, audio_temperature=1.7, audio_top_p=0.8,
                    audio_top_k=25, audio_repetition_penalty=1.0) -> dict:
        text_do, audio_do = text_temperature > 0, audio_temperature > 0
        return dict(
            masks=self._delay_masks(), text_do=text_do, audio_do=audio_do,
            text_temperature=text_temperature if text_do else 1.0,
            text_top_p=text_top_p, text_top_k=text_top_k,
            audio_temperature=audio_temperature if audio_do else 1.0,
            audio_top_p=audio_top_p, audio_top_k=audio_top_k,
            audio_repetition_penalty=audio_repetition_penalty)

    @torch.inference_mode()
    def delay_chunk(self, s: dict, k: dict, n: int) -> Tuple[np.ndarray,
                                                             bool]:
        """n delay frames from `s`, read once -> (the kept rows (m,
        n_vq + 1), whether the request stopped within them)."""
        rows, dones = [], []
        for _ in range(n):
            row, done = self.delay_frame(s, k)
            rows.append(row)
            dones.append(done)
        read = torch.cat([torch.stack(rows),
                          torch.stack(dones).long()[:, None]], dim=1)
        read = read.cpu().numpy()
        d = read[:, -1] > 0
        if d.any():
            return read[:int(np.argmax(d)) + 1, :-1], True
        return read[:, :-1], False

    def generate_delay_pattern_ids(
            self, input_ids, *, max_new_tokens: int = 4096,
            text_temperature: float = 1.5, text_top_p: float = 1.0,
            text_top_k: int = 50, audio_temperature: float = 1.7,
            audio_top_p: float = 0.8, audio_top_k: int = 25,
            audio_repetition_penalty: float = 1.0, seed: int = 0
    ) -> List[Tuple[int, np.ndarray]]:
        """The delay-pattern decode -> [(start_length, rows)], at most
        `max_new_tokens` frames."""
        cfg = self.config
        rows = np.asarray(input_ids, np.int64)
        t0 = time.perf_counter()
        s = self.start_delay(rows, max_new_tokens, seed)
        k = self.delay_knobs(text_temperature, text_top_p, text_top_k,
                             audio_temperature, audio_top_p, audio_top_k,
                             audio_repetition_penalty)
        out_rows: List[np.ndarray] = []
        n, chunks = 0, 0
        while n < max_new_tokens:
            got, stopped = self.delay_chunk(
                s, k, min(CHUNK_FRAMES, max_new_tokens - n))
            chunks += 1
            out_rows.append(got)
            n += len(got)
            if stopped:
                break
        plen = rows.shape[1]
        self.last_run = {"layout": "delay", "prompt_len": plen,
                         "frames": n, "chunks": chunks,
                         "loop_s": time.perf_counter() - t0}
        gen = np.concatenate([rows[0]] + out_rows, axis=0)
        text_col = rows[0, :, 0]
        im_starts = np.flatnonzero(text_col == cfg.im_start_token_id)
        start_idx = int(im_starts[-1]) + 3 if len(im_starts) else plen
        return [(plen - start_idx, gen[start_idx:])]

    # ------------------------------------------------- the v1.5 local head

    def _sample_local(self, kind: str, logits: torch.Tensor,
                      temperature: float, top_p: float, top_k: int,
                      do: bool, generator, history=None, rep: float = 1.0
                      ) -> torch.Tensor:
        """The local frames' `sample` (:666-677, :738-748): the repetition
        penalty over `history`, then argmax or the filtered draw at
        max(temperature, 1e-6) -> (1,) int64."""
        lg = logits.float()
        if history is not None and rep != 1.0:
            lg = apply_repetition_penalty(lg, history, rep)
        if not do:
            return torch.argmax(lg, dim=-1)
        lg = _filtered(lg, max(temperature, 1e-6), top_p, top_k)
        return _gumbel_max(lg, self._gumbel(kind, tuple(lg.shape),
                                            generator))

    def v15_frame(self, s: dict, k: dict) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """One v1.5 frame from `s` (advanced in place) -> (the text token
        (1,), the frame's n_vq codes)."""
        cfg = self.config
        n_vq = cfg.n_vq
        v = self._codebook_sizes()[0]
        gen = s["generator"]
        lcache = s["local_caches"]
        lh, _ = gpt2_forward(self.local_transformer, s["hidden"][:, None],
                             caches=lcache, offset=0)
        lh = lh[:, -1]
        cand = k["cand"]
        if self._binary_text_head() and hasattr(self, "local_text_lm_head"):
            tl = self.local_text_lm_head(lh)
        else:
            tl = self.text_lm_head(lh)[..., cand]
        text_tok = cand[self._sample_local(
            "text", tl, k["text_temperature"], k["text_top_p"],
            min(k["text_top_k"], 2), k["text_do"], gen)]
        toks = []
        cur = lh
        emb_w = self.audio_embeddings.weight
        for c in range(n_vq):
            logits = linear_rows(self.audio_lm_heads, cur, c * v,
                                 (c + 1) * v)
            tok = self._sample_local(
                "audio", logits, k["audio_temperature"], k["audio_top_p"],
                k["audio_top_k"], k["audio_do"], gen,
                history=s["history"][c:c + 1],
                rep=k["audio_repetition_penalty"])
            toks.append(tok)
            if c + 1 < n_vq:
                emb = emb_w[c * v + tok].to(cur.dtype)
                cur, _ = gpt2_forward(self.local_transformer, emb[:, None],
                                      caches=lcache, offset=c + 1)
                cur = cur[:, -1]
        frame = torch.cat(toks)
        s["history"] = torch.cat([s["history"][:, 1:], frame[:, None]],
                                 dim=1)
        row = torch.cat([text_tok, frame])[None, None]
        s["hidden"] = self._lm_step(self._embed_rows_v15(row), s["caches"],
                                    s["offset"])
        s["offset"] += 1
        return text_tok, frame

    def local_knobs(self, do_sample=True, text_temperature=1.0,
                    text_top_p=1.0, text_top_k=50, audio_temperature=1.7,
                    audio_top_p=0.8, audio_top_k=25,
                    audio_repetition_penalty=1.0,
                    text_repetition_penalty=1.0) -> dict:
        cfg = self.config
        return dict(
            text_do=bool(do_sample) and text_temperature > 0,
            audio_do=bool(do_sample) and audio_temperature > 0,
            text_temperature=text_temperature, text_top_p=text_top_p,
            text_top_k=text_top_k, audio_temperature=audio_temperature,
            audio_top_p=audio_top_p, audio_top_k=audio_top_k,
            audio_repetition_penalty=audio_repetition_penalty,
            text_repetition_penalty=text_repetition_penalty,
            cand=torch.tensor([cfg.audio_assistant_slot_token_id,
                               cfg.audio_end_token_id], device=self.device))

    @torch.inference_mode()
    def start_local(self, input_ids, max_new_tokens: int, seed: int = 0
                    ) -> dict:
        """The prefill of the whole prompt (1, plen, n_vq + 1) of a local
        layout and the state its frames advance."""
        cfg = self.config
        rows = np.asarray(input_ids, np.int64)
        if rows.ndim != 3 or rows.shape[0] != 1:
            raise NotImplementedError(
                "local-transformer generation is single-sequence")
        plen = rows.shape[1]
        v15 = cfg.is_v15_local_transformer
        caches, hidden = self._prefill(
            self._rows_tensor(rows),
            self._embed_rows_v15 if v15 else self._embed_rows_legacy, plen,
            max_new_tokens)
        dev = self.device
        s = {"caches": caches, "hidden": hidden, "offset": plen,
             "history": torch.full((cfg.n_vq, HISTORY_WIN), -1,
                                   dtype=torch.long, device=dev),
             "generator": torch.Generator(device=dev).manual_seed(int(seed))}
        if v15:
            s["local_caches"] = gpt2_make_caches(
                self.local_transformer.cfg, 1, cfg.n_vq + 1, device=dev)
        else:
            s["text_history"] = torch.full((1, HISTORY_WIN), -1,
                                           dtype=torch.long, device=dev)
        return s

    def _local_frames(self, rows: np.ndarray, max_new_tokens: int,
                      knobs: dict, seed: int
                      ) -> Generator[np.ndarray, None, None]:
        """The kept frames of a local layout, chunk by chunk (one read a
        chunk): v1.5 frames (n_vq,) while the text token is the slot;
        legacy rows (n_vq + 1,) up to and including the audio end."""
        cfg = self.config
        v15 = cfg.is_v15_local_transformer
        t0 = time.perf_counter()
        s = self.start_local(rows, max_new_tokens, seed)
        frame = self.v15_frame if v15 else self.legacy_frame
        n, chunks, stop = 0, 0, False
        self.last_run = {"layout": "v1.5" if v15 else "legacy",
                         "prompt_len": rows.shape[1], "frames": 0,
                         "chunks": 0}
        while n < max_new_tokens and not stop:
            m = min(CHUNK_FRAMES, max_new_tokens - n)
            with torch.inference_mode():
                outs = [torch.cat(frame(s, knobs)) for _ in range(m)]
                read = torch.stack(outs).cpu().numpy()
            chunks += 1
            for r in read:
                if v15 and int(r[0]) != cfg.audio_assistant_slot_token_id:
                    stop = True
                    break
                n += 1
                self.last_run.update(frames=n, chunks=chunks,
                                     loop_s=time.perf_counter() - t0)
                yield r[1:] if v15 else r
                if not v15 and int(r[0]) == cfg.audio_end_token_id:
                    stop = True
                    break
            self.last_run.update(chunks=chunks,
                                 loop_s=time.perf_counter() - t0)

    def generate_v15_local_ids(self, input_ids, *, max_new_tokens=4096,
                               do_sample=True, text_temperature=1.0,
                               text_top_p=1.0, text_top_k=50,
                               audio_temperature=1.7, audio_top_p=0.8,
                               audio_top_k=25, audio_repetition_penalty=1.0,
                               seed: int = 0, n_vq_for_inference=None,
                               on_frame=None
                               ) -> List[Tuple[int, np.ndarray]]:
        cfg = self.config
        if n_vq_for_inference is not None and \
                int(n_vq_for_inference) != cfg.n_vq:
            raise ValueError(
                "MOSS-TTS-Local-Transformer-v1.5 has a fixed RVQ depth "
                f"(n_vq={cfg.n_vq}, got {n_vq_for_inference})")
        rows = np.asarray(input_ids, np.int64)
        knobs = self.local_knobs(do_sample, text_temperature, text_top_p,
                                 text_top_k, audio_temperature, audio_top_p,
                                 audio_top_k, audio_repetition_penalty)
        frames: List[np.ndarray] = []
        for f in self._local_frames(rows, max_new_tokens, knobs, seed):
            frames.append(f)
            if on_frame is not None:
                on_frame(f)
        return self._v15_output(rows, frames)

    def _v15_output(self, rows: np.ndarray, frames: List[np.ndarray]
                    ) -> List[Tuple[int, np.ndarray]]:
        cfg = self.config
        gen_rows = [rows[0]]
        for f in frames:
            r = np.empty((1, cfg.n_vq + 1), np.int64)
            r[0, 0] = cfg.audio_assistant_slot_token_id
            r[0, 1:] = f
            gen_rows.append(r)
        gen = np.concatenate(gen_rows, axis=0)
        return [self._start(rows, gen)]

    def _start(self, rows: np.ndarray, gen: np.ndarray
               ) -> Tuple[int, np.ndarray]:
        plen = rows.shape[1]
        starts = np.flatnonzero(rows[0, :, 0]
                                == self.config.audio_start_token_id)
        if len(starts):
            start_idx = int(starts[-1])
            return plen - start_idx - 1, gen[start_idx:]
        return 0, gen[plen:]

    # ---------------------------------------------- the legacy local head

    def legacy_frame(self, s: dict, k: dict) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """One legacy frame from `s` (advanced in place) -> (the text token
        (1,), the row's n_vq codes: the first nq sampled, the rest 0)."""
        cfg = self.config
        n_vq, nq = cfg.n_vq, k["nq"]
        va = cfg.audio_vocab_size + 1
        lc = cfg.language_config
        gen = s["generator"]
        up = self.speech_embedding_to_local_mlp
        cur = up(s["hidden"])
        buf, toks = [], []
        emb_w = self.model.audio_embeddings.weight
        for c in range(1 + nq):
            buf.append(cur)
            lh = local_qwen3_forward(self.local_transformer,
                                     torch.stack(buf, dim=1))[:, -1]
            lh = self.local_to_speech_embedding_mlps[str(c)](lh)
            lh = rms_norm(lh, self.layer_norm_before_lm_heads[str(c)].weight,
                          lc.rms_norm_eps)
            if c == 0:
                tok = self._sample_local(
                    "text", self.text_lm_head(lh), k["text_temperature"],
                    k["text_top_p"], k["text_top_k"], k["text_do"], gen,
                    s["text_history"] if k["text_do"] else None,
                    k["text_repetition_penalty"])
                emb = self.model.text_embedding(tok)
            else:
                logits = linear_rows(self.audio_lm_heads, lh, (c - 1) * va,
                                     c * va).float()
                logits[:, cfg.audio_pad_code] = float("-inf")
                tok = self._sample_local(
                    "audio", logits, k["audio_temperature"],
                    k["audio_top_p"], k["audio_top_k"], k["audio_do"], gen,
                    s["history"][c - 1:c] if k["audio_do"] else None,
                    k["audio_repetition_penalty"])
                emb = emb_w[(c - 1) * va + tok].to(lh.dtype)
            toks.append(tok)
            cur = up(emb)
        text_tok = toks[0]
        codes = torch.cat(toks[1:] + [torch.zeros(
            n_vq - nq, dtype=torch.long, device=self.device)])
        s["text_history"] = torch.cat([s["text_history"][:, 1:],
                                       text_tok[None]], dim=1)
        if nq:
            s["history"] = torch.cat([torch.cat(
                [s["history"][:nq, 1:], codes[:nq, None]], dim=1),
                s["history"][nq:]])
        row = torch.cat([text_tok, codes])[None, None]
        s["hidden"] = self._lm_step(self._embed_rows_legacy(row),
                                    s["caches"], s["offset"])
        s["offset"] += 1
        return text_tok, codes

    def generate_local_ids(self, input_ids, *, max_new_tokens=4096,
                           text_temperature=1.5, text_top_p=1.0,
                           text_top_k=50, text_repetition_penalty=1.0,
                           audio_temperature=1.0, audio_top_p=0.95,
                           audio_top_k=50, audio_repetition_penalty=1.1,
                           n_vq_for_inference=None, seed: int = 0
                           ) -> List[Tuple[int, np.ndarray]]:
        cfg = self.config
        rows = np.asarray(input_ids, np.int64)
        knobs = self.local_knobs(True, text_temperature, text_top_p,
                                 text_top_k, audio_temperature, audio_top_p,
                                 audio_top_k, audio_repetition_penalty,
                                 text_repetition_penalty)
        knobs["nq"] = max(1, min(cfg.n_vq,
                                 int(n_vq_for_inference or cfg.n_vq)))
        got = list(self._local_frames(rows, max_new_tokens, knobs, seed))
        return [self._start(rows, np.concatenate(
            [rows[0]] + [r[None] for r in got], axis=0))]

    # ----------------------------------------------------- audio decoding

    def _decode_generated_audio(self, outputs, *, source=None
                                ) -> Tuple[np.ndarray, int]:
        """(ref :1183-1229) de-delay, split non-pad runs, decode, trim."""
        cfg = self.config
        segments, token_count = [], 0
        for start_length, gen in outputs:
            codes = np.asarray(gen)[:, 1:].astype(np.int32)
            if not cfg.is_local_transformer:
                codes = apply_de_delay_pattern(codes)
            is_pad = np.all(codes == cfg.audio_pad_code, axis=1)
            idx = np.flatnonzero(~is_pad)
            if not len(idx):
                continue
            breaks = np.flatnonzero(np.diff(idx) != 1) + 1
            for run in np.split(idx, breaks):
                seg_codes = codes[run[0]:run[-1] + 1]
                token_count += len(seg_codes)
                audio = np.asarray(self.decode_audio_token_ids(
                    seg_codes, num_quantizers=cfg.n_vq,
                    source=source)).reshape(-1)
                if start_length > 0 and not segments and len(seg_codes):
                    ratio = min(max(start_length / len(seg_codes), 0.0), 1.0)
                    audio = audio[int(len(audio) * ratio):]
                segments.append(audio)
        if not segments:
            return np.zeros((0,), np.float32), 0
        return np.concatenate(segments), token_count

    def _result(self, audio, t0, token_count, prompt_tokens, seg=0,
                streaming=False, final=False) -> GenerationResult:
        dt = max(time.perf_counter() - t0, 1e-6)
        audio = np.asarray(audio).reshape(-1)
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=seg, token_count=token_count,
            audio_duration=format_duration(dur),
            real_time_factor=round(dur / dt, 3) if dt else 0.0,
            prompt={"tokens": prompt_tokens,
                    "tokens-per-sec": round(prompt_tokens / dt, 2)},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / dt, 2)},
            processing_time_seconds=dt, peak_memory_usage=peak_memory_gb(),
            is_streaming_chunk=streaming, is_final_chunk=final)

    # ---------------------------------------------------------- generate

    def _v15_kwargs(self, kwargs: dict) -> dict:
        return dict(
            do_sample=bool(kwargs.get("do_sample", True)),
            text_temperature=float(kwargs.get("text_temperature", 1.0)),
            text_top_p=float(kwargs.get("text_top_p", 1.0)),
            text_top_k=int(kwargs.get("text_top_k", 50)),
            audio_temperature=float(kwargs.get(
                "audio_temperature", kwargs.get("temperature", 1.7))),
            audio_top_p=float(kwargs.get("audio_top_p",
                                         kwargs.get("top_p", 0.8))),
            audio_top_k=int(kwargs.get("audio_top_k",
                                       kwargs.get("top_k", 25))),
            audio_repetition_penalty=float(kwargs.get(
                "audio_repetition_penalty",
                kwargs.get("repetition_penalty", 1.0))))

    def generate(self, text: str, ref_audio=None, ref_text=None,
                 prompt_audio_codes=None, mode: str = "generation",
                 stream: bool = False, max_tokens: Optional[int] = None,
                 **kwargs) -> Generator[GenerationResult, None, None]:
        if self.tokenizer is None:
            raise ValueError("Tokenizer is not initialized.")
        cfg = self.config
        t0 = time.perf_counter()
        processor = self._processor()

        refs = ref_audio if isinstance(ref_audio, (list, tuple)) else \
            ([ref_audio] if ref_audio is not None else [])
        if prompt_audio_codes is None and refs:
            prompt_audio_codes = [
                np.asarray(self.encode_reference_audio(
                    r, sample_rate=kwargs.get("ref_audio_sample_rate"),
                    num_quantizers=cfg.n_vq,
                    source=kwargs.get("audio_tokenizer_source")))
                for r in refs]
            if len(prompt_audio_codes) == 1:
                prompt_audio_codes = prompt_audio_codes[0]

        mode = str(mode or "generation").strip().lower()
        if mode in {"voice_clone", "direct"}:
            mode = "generation"
        if mode not in {"generation", "continuation"}:
            raise ValueError("mode must be generation or continuation")
        ref_texts = ref_text if isinstance(ref_text, list) else \
            ([ref_text] if ref_text else [])
        codes_list = prompt_audio_codes if isinstance(
            prompt_audio_codes, (list, tuple)) else \
            ([prompt_audio_codes] if prompt_audio_codes is not None else [])
        codes_list = [np.asarray(c, np.int32) for c in codes_list]
        if mode == "continuation" and len(codes_list) > 1:
            raise ValueError("continuation mode accepts one reference")

        user_kwargs = {
            "text": (text if mode == "generation"
                     else (ref_texts[0] if ref_texts else "") + text),
            "tokens": kwargs.get("tokens"),
            "instruction": kwargs.get("instruction"),
            "quality": kwargs.get("quality"),
            "sound_event": kwargs.get("sound_event"),
            "ambient_sound": kwargs.get("ambient_sound"),
            "language": kwargs.get("language"),
            "scene": kwargs.get("scene"),
        }
        if mode == "generation" and codes_list:
            user_kwargs["reference"] = codes_list
        if mode == "generation":
            conv = [processor.build_user_message(**user_kwargs)]
        else:
            if not codes_list:
                raise ValueError("continuation mode requires ref_audio or "
                                 "prompt_audio_codes")
            conv = [processor.build_user_message(**user_kwargs),
                    processor.build_assistant_message(codes_list)]
        batch = processor([conv], mode=mode)
        input_ids = batch["input_ids"]
        prompt_tokens = int(input_ids.shape[1])
        max_new = int(max_tokens if max_tokens is not None
                      else self._gc("max_new_tokens", 4096))
        seed = int(kwargs.get("seed", 0))

        if stream:
            if not cfg.is_v15_local_transformer:
                raise NotImplementedError(
                    "MOSS-TTS streaming is implemented for "
                    "MOSS-TTS-Local-Transformer-v1.5 only")
            yield from self._stream_v15(input_ids, t0, prompt_tokens,
                                        max_new, kwargs)
            return

        if cfg.is_v15_local_transformer:
            outputs = self.generate_v15_local_ids(
                input_ids, max_new_tokens=max_new, seed=seed,
                n_vq_for_inference=kwargs.get("n_vq_for_inference"),
                **self._v15_kwargs(kwargs))
        elif cfg.is_legacy_local_transformer:
            outputs = self.generate_local_ids(
                input_ids, max_new_tokens=max_new,
                text_temperature=float(kwargs.get("text_temperature", 1.5)),
                text_top_p=float(kwargs.get("text_top_p", 1.0)),
                text_top_k=int(kwargs.get("text_top_k", 50)),
                text_repetition_penalty=float(
                    kwargs.get("text_repetition_penalty", 1.0)),
                audio_temperature=float(kwargs.get("audio_temperature", 1.0)),
                audio_top_p=float(kwargs.get("audio_top_p", 0.95)),
                audio_top_k=int(kwargs.get("audio_top_k", 50)),
                audio_repetition_penalty=float(
                    kwargs.get("audio_repetition_penalty", 1.1)),
                n_vq_for_inference=kwargs.get("n_vq_for_inference"),
                seed=seed)
        else:
            outputs = self.generate_delay_pattern_ids(
                input_ids, max_new_tokens=max_new,
                text_temperature=float(kwargs.get(
                    "text_temperature", self._gc("temperature", 1.5))),
                text_top_p=float(kwargs.get("text_top_p",
                                            self._gc("top_p", 1.0))),
                text_top_k=int(kwargs.get("text_top_k", 50)),
                audio_temperature=float(kwargs.get(
                    "audio_temperature", self._gc("temperature", 1.7))),
                audio_top_p=float(kwargs.get("audio_top_p",
                                             self._gc("top_p", 0.8))),
                audio_top_k=int(kwargs.get("audio_top_k",
                                           self._gc("top_k", 25))),
                audio_repetition_penalty=float(kwargs.get(
                    "audio_repetition_penalty",
                    self._gc("repetition_penalty", 1.0))),
                seed=seed)
        audio, token_count = self._decode_generated_audio(
            outputs, source=kwargs.get("audio_tokenizer_source"))
        yield self._result(audio, t0, token_count, prompt_tokens, final=True)

    def _stream_v15(self, input_ids, t0, prompt_tokens, max_new, kwargs
                    ) -> Generator[GenerationResult, None, None]:
        """The chunked stream with context re-decode (ref
        _generate_v15_local_streaming_results :1254-1397): each chunk is
        yielded as soon as it is decoded."""
        cfg = self.config
        fps = 12.5
        spf = max(1, int(round(self.sample_rate / fps)))
        interval = float(kwargs.get("streaming_interval", 2.0) or 2.0)
        steady = max(1, int(round(interval * fps)))
        first = int(kwargs.get("streaming_first_chunk_frames")
                    or min(4, steady))
        context = max(0, int(kwargs.get("streaming_context_frames", 8) or 0))
        source = kwargs.get("audio_tokenizer_source")

        frames: List[np.ndarray] = []
        state = {"emitted": 0, "chunk": 0, "t0": t0}

        def flush(final: bool) -> Optional[GenerationResult]:
            end = len(frames)
            if end <= state["emitted"] and not final:
                return None
            if end > state["emitted"]:
                cstart = max(0, state["emitted"] - context)
                codes = np.stack(frames[cstart:end]).astype(np.int32)
                audio = np.asarray(self.decode_audio_token_ids(
                    codes, num_quantizers=cfg.n_vq,
                    source=source)).reshape(-1)
                trim = (state["emitted"] - cstart) * spf
                audio = audio[min(trim, len(audio)):]
                res = self._result(
                    audio, state["t0"], end - state["emitted"],
                    prompt_tokens if state["chunk"] == 0 else 0,
                    seg=state["chunk"], streaming=True, final=final)
                state["emitted"] = end
                state["chunk"] += 1
                state["t0"] = time.perf_counter()
                return res
            return self._result(
                np.zeros((0,), np.float32), state["t0"], 0,
                prompt_tokens if state["chunk"] == 0 else 0,
                seg=max(state["chunk"] - 1, 0), streaming=True, final=True)

        knobs = self.local_knobs(**self._v15_kwargs(kwargs))
        for f in self._local_frames(np.asarray(input_ids, np.int64),
                                    max_new, knobs,
                                    int(kwargs.get("seed", 0))):
            frames.append(f)
            threshold = first if state["chunk"] == 0 else steady
            if len(frames) - state["emitted"] >= threshold:
                res = flush(False)
                if res is not None:
                    yield res
        res = flush(True)
        if res is not None:
            yield res


__all__ = ["Model", "ModelConfig", "Qwen3LMConfig", "Qwen3LM",
           "init_qwen3_lm", "qwen3_lm_forward", "lm_logits", "LocalQwen3",
           "local_qwen3_forward", "linear_rows", "MAX_CACHE_LEN",
           "CHUNK_FRAMES", "HISTORY_WIN", "SENTINEL"]
