"""Granite Speech 4.1 NAR: one CTC pass and one bidirectional editor pass.

Counterpart of mlx_audio_tpu/stt/models/granite_speech_nar/
granite_speech_nar.py:

* the configs (`EncoderConfig`, `ProjectorConfig`, `TextConfig`,
  `ModelConfig`, :66-134) and the tree (`init_nar` :301-372: Granite
  Speech's encoder with `out_bpe`, the Q-former `projector`, the
  `editor`);
* `ctc_collapse_decode` and `add_insertion_slots` (:140-162), copied;
* `nar_encoder_forward` (:164-207): Granite Speech's conformer blocks
  (`granite_speech.block_attention`, `_conv_module`), the CTC softmax fed
  back at `self_conditioning_layer` (its blank column kept), the hidden
  states of `encoder_layer_indices` concatenated, posterior-weighted BPE
  pooling over windows of `bpe_pooling_window` and the BPE head;
* `nar_projector_forward` (:210-256): per-layer LayerNorms, a GELU
  projection, blocks of `block_size` rows, queries set to the learned ones
  plus each block's mean pool, window positions on the keys, pre-norm
  cross-attention layers with SiLU MLPs, the output norm and linear;
* `editor_forward` (:259-300): a bidirectional Granite stack (RMSNorm,
  RoPE, GQA attention at `attention_multiplier`, residuals scaled by
  `residual_multiplier`, embeddings by `embedding_multiplier`) over [audio
  rows | the slotted hypothesis], tied logits over the text rows divided
  by `logits_scaling`;
* `_extract_features` (:435-457), `transcribe_tokens` (:509) and
  `generate` (:519); `sanitize` and `post_load_hook`.

Two forward passes and no autoregressive step: the argmax of each pass
is collapsed on the host between them.

Departures from the JAX package:

* the encoder and projector run the feature rows the audio has, and the
  editor the rows of its sequence: JAX pads them to `ENC_BUCKETS` and
  `EDIT_BUCKETS` lengths under masks (compile-count workarounds), which
  give the same rows on the valid frames (`tests/test_torch_granite_
  speech_nar.py::test_unpadded_passes_equal_jax_buckets`);
  the block attention pads its last block and masks its keys, as Granite
  Speech's does;
* a bf16 model computes in bf16 (the features cast to it), its softmaxes
  in f32;
* `sanitize` reads each conv weight's layout (torch, MLX or the JAX tree's
  WIO) from the model's own shapes, where JAX's takes every weight as the
  JAX tree's;
* `post_load_hook` reads only the directory's tokenizer files and raises
  when they fail to load, where JAX's swallows any error and leaves none.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....dsp import hanning, mel_filters, spec_abs, stft
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Embedding, LayerNorm, Linear, RMSNorm, gelu
from ....ops.attention import attention
from ....ops.rope import apply_rope, rope_freqs
from ....tts.models.base import local_tokenizer
from ...models.base import STTOutput
from ..granite_speech.granite_speech import EncoderConfig as BaseEncoderConfig
from ..granite_speech.granite_speech import (_conformer_layer, _conv_module,
                                             _ff_forward, block_attention)
from ..llm_stt import as_audio


@dataclass
class EncoderConfig(BaseEncoderConfig):
    bpe_output_dim: int = 32000
    bpe_pooling_window: int = 4
    self_conditioning_layer: int = 8
    blank_token_id: int = 0


@dataclass
class ProjectorConfig(BaseModelArgs):
    num_layers: int = 2
    num_encoder_layers: int = 4
    hidden_size: int = 2048
    num_heads: int = 32
    block_size: int = 15
    downsample_rate: int = 5
    encoder_dim: int = 1024
    llm_dim: int = 2048
    mlp_ratio: int = 4
    mlp_bias: bool = True
    attn_bias: bool = True
    layernorm_eps: float = 1e-5


@dataclass
class TextConfig(BaseModelArgs):
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    vocab_size: int = 100352
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000000.0
    tie_word_embeddings: bool = True
    attention_multiplier: float = 0.015625
    embedding_multiplier: float = 12.0
    logits_scaling: float = 8.0
    residual_multiplier: float = 0.22
    bos_token_id: int = 100257
    eos_token_id: int = 100257
    pad_token_id: int = 100256

    @classmethod
    def from_dict(cls, params):
        params = dict(params or {})
        rp = params.get("rope_parameters")
        if isinstance(rp, dict) and "rope_theta" in rp:
            params.setdefault("rope_theta", rp["rope_theta"])
        return super().from_dict(params)


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "granite_speech_nar"
    encoder_config: Optional[dict] = None
    projector_config: Optional[dict] = None
    text_config: Optional[dict] = None
    encoder_layer_indices: List[int] = field(
        default_factory=lambda: [4, 8, 12, -1])
    blank_token_id: int = 100257
    scale_projected_embeddings: bool = True
    min_edit_sequence_length: int = 8
    tie_word_embeddings: bool = True
    model_path: str = ""

    def __post_init__(self):
        self.enc = EncoderConfig.from_dict(self.encoder_config or {})
        self.proj = ProjectorConfig.from_dict(self.projector_config or {})
        self.text = TextConfig.from_dict(self.text_config or {})


# --------------------------------------------------------------- decoding


def ctc_collapse_decode(tokens: np.ndarray, blank_id: int) -> np.ndarray:
    """Dedup adjacent repeats, drop blanks (ref decoding.py:11-35)."""
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return tokens
    first = np.concatenate([[True], tokens[1:] != tokens[:-1]])
    return tokens[first & (tokens != blank_id)]


def add_insertion_slots(token_ids: np.ndarray, blank_id: int,
                        min_len: int = 8) -> np.ndarray:
    """Interleave blanks as editing slots: CTC tokens at odd indices
    (ref decoding.py:38-63)."""
    token_ids = np.asarray(token_ids)
    n = len(token_ids)
    total = max(2 * n + 1, min_len)
    out = np.full((total,), blank_id, dtype=np.int32)
    if n:
        out[1:2 * n:2] = token_ids
    return out


# ------------------------------------------------------------------- tree


class Projector(nn.Module):
    """The Q-former projector's tree: `layer_norms.N`, `layer_projector`,
    the learned `query` and `window_positions` (zeros at init),
    `qformer.layers.N`, `out_norm`, `out_linear`."""

    init_fill = {"query": 0.0, "window_positions": 0.0}

    def __init__(self, pj: ProjectorConfig):
        super().__init__()
        h, eps = pj.hidden_size, pj.layernorm_eps
        self.layer_norms = nn.ModuleList(LayerNorm(pj.encoder_dim, eps)
                                         for _ in range(
                                             pj.num_encoder_layers))
        self.layer_projector = Linear(pj.num_encoder_layers * pj.encoder_dim,
                                      h, bias=pj.mlp_bias)
        self.query = nn.Parameter(torch.empty(
            1, pj.block_size // pj.downsample_rate, h))
        self.window_positions = nn.Parameter(torch.empty(1, pj.block_size,
                                                         h))
        self.qformer = holder(layers=nn.ModuleList(holder(
            attn_norm=LayerNorm(h, eps),
            cross_attention=holder(q_proj=Linear(h, h), k_proj=Linear(h, h),
                                   v_proj=Linear(h, h), o_proj=Linear(h, h)),
            mlp_norm=LayerNorm(h, eps),
            mlp=holder(fc1=Linear(h, h * pj.mlp_ratio),
                       fc2=Linear(h * pj.mlp_ratio, h)))
            for _ in range(pj.num_layers)))
        self.out_norm = LayerNorm(h, eps)
        self.out_linear = Linear(h, pj.llm_dim)


def _editor(tc: TextConfig) -> nn.Module:
    d = tc.hidden_size
    hd = d // tc.num_attention_heads
    inter = tc.intermediate_size
    return holder(
        embed_tokens=Embedding(tc.vocab_size, d),
        layers=nn.ModuleList(holder(
            input_layernorm=RMSNorm(d, tc.rms_norm_eps),
            self_attn=holder(
                q_proj=Linear(d, tc.num_attention_heads * hd, bias=False),
                k_proj=Linear(d, tc.num_key_value_heads * hd, bias=False),
                v_proj=Linear(d, tc.num_key_value_heads * hd, bias=False),
                o_proj=Linear(tc.num_attention_heads * hd, d, bias=False)),
            post_attention_layernorm=RMSNorm(d, tc.rms_norm_eps),
            mlp=holder(gate_proj=Linear(d, inter, bias=False),
                       up_proj=Linear(d, inter, bias=False),
                       down_proj=Linear(inter, d, bias=False)))
            for _ in range(tc.num_hidden_layers)),
        norm=RMSNorm(d, tc.rms_norm_eps))


# ----------------------------------------------------------------- passes


def nar_encoder_forward(model: "Model", feats: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1, N, input_dim), every row valid -> (BPE logits (1, N // w,
    bpe vocab), fused hidden states (1, N, 4 x hidden))."""
    cfg = model.config
    e = cfg.enc
    enc = model.encoder
    b, n, _ = feats.shape
    x = enc.input_linear(feats)
    hidden = [x]
    blank = None
    for idx, lp in enumerate(enc.layers, 1):
        x = 0.5 * _ff_forward(lp.ff1, x) + x
        x = block_attention(lp.attn, e, x) + x
        x = _conv_module(lp.conv, e, x) + x
        x = 0.5 * _ff_forward(lp.ff2, x) + x
        x = lp.post_norm(x)
        if idx == e.self_conditioning_layer:
            probs = torch.softmax(enc.out(x).float(), dim=-1)
            blank = probs[..., 0]
            x = x + enc.out_mid(probs.to(x.dtype))
        hidden.append(x)
    fused = torch.cat([hidden[i] for i in cfg.encoder_layer_indices], dim=-1)
    w = e.bpe_pooling_window
    n_pool = n // w
    imp = (1.0 - blank)[:, :n_pool * w].reshape(b, n_pool, w)
    hw = x[:, :n_pool * w].reshape(b, n_pool, w, -1)
    weights = imp / imp.sum(dim=-1, keepdim=True).clamp(min=1e-6)
    pooled = (hw * weights[..., None].to(hw.dtype)).sum(dim=2)
    return enc.out_bpe(pooled), fused


def nar_projector_forward(model: "Model", fused: torch.Tensor
                          ) -> torch.Tensor:
    """(1, T, 4 x encoder_dim), every row valid -> (1, ceil(T / block) x
    block / downsample, llm_dim)."""
    pj = model.config.proj
    p = model.projector
    b, t, _ = fused.shape
    parts = fused.chunk(pj.num_encoder_layers, dim=-1)
    h = gelu(p.layer_projector(torch.cat(
        [ln(part) for ln, part in zip(p.layer_norms, parts)], dim=-1)))
    block = pj.block_size
    h = F.pad(h, (0, 0, 0, (-t) % block))
    nblocks = h.shape[1] // block
    h = h.reshape(b * nblocks, block, pj.hidden_size)
    nq = block // pj.downsample_rate
    mean_pool = h.reshape(b * nblocks, nq, pj.downsample_rate,
                          pj.hidden_size).mean(dim=-2)
    query = p.query.to(h.dtype) + mean_pool
    kv = h + p.window_positions.to(h.dtype)
    heads = pj.num_heads
    dh = pj.hidden_size // heads
    for lp in p.qformer.layers:
        ca = lp.cross_attention
        bq, lq, dd = query.shape
        qn = lp.attn_norm(query)
        q = ca.q_proj(qn).reshape(bq, lq, heads, dh)
        k = ca.k_proj(kv).reshape(bq, -1, heads, dh)
        v = ca.v_proj(kv).reshape(bq, -1, heads, dh)
        query = query + ca.o_proj(attention(q, k, v).reshape(bq, lq, dd))
        query = query + lp.mlp.fc2(F.silu(lp.mlp.fc1(lp.mlp_norm(query))))
    out = p.out_linear(p.out_norm(query))
    return out.reshape(b, nblocks * nq, pj.llm_dim)


def editor_forward(model: "Model", embeds: torch.Tensor,
                   logits_start: int) -> torch.Tensor:
    """The bidirectional editor over (1, T, D), every row valid -> logits
    of the rows from `logits_start` on."""
    tc = model.config.text
    p = model.editor
    b, t, _ = embeds.shape
    x = embeds * tc.embedding_multiplier
    hd = tc.hidden_size // tc.num_attention_heads
    inv = rope_freqs(hd, tc.rope_theta).to(x.device)
    pos = torch.arange(t, device=x.device)
    for lp in p.layers:
        h = lp.input_layernorm(x)
        a = lp.self_attn
        q = apply_rope(a.q_proj(h).reshape(b, t, tc.num_attention_heads, hd),
                       pos, inv)
        k = apply_rope(a.k_proj(h).reshape(b, t, tc.num_key_value_heads, hd),
                       pos, inv)
        v = a.v_proj(h).reshape(b, t, tc.num_key_value_heads, hd)
        o = attention(q, k, v, scale=tc.attention_multiplier)
        x = x + a.o_proj(o.reshape(b, t, -1)) * tc.residual_multiplier
        h = lp.post_attention_layernorm(x)
        m = lp.mlp
        x = x + m.down_proj(F.silu(m.gate_proj(h)) * m.up_proj(h)) \
            * tc.residual_multiplier
    x = p.norm(x)[:, logits_start:]
    logits = x @ p.embed_tokens.weight.to(x.dtype).T
    return logits / tc.logits_scaling


# ------------------------------------------------------------------ model


class Model(TorchModel):
    """Granite Speech NAR on `device`: the card by default; without CUDA
    the constructor raises unless given `device="cpu"`."""

    SAMPLE_RATE = 16000

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
                out_mid=Linear(e.output_dim, e.hidden_dim),
                out_bpe=Linear(e.hidden_dim, e.bpe_output_dim))
            self.projector = Projector(config.proj)
            self.editor = _editor(config.text)
        self._tokenizer = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.SAMPLE_RATE

    @property
    def dtype(self) -> torch.dtype:
        return self.editor.norm.weight.dtype

    # ------------------------------------------------------------ features

    def _extract_features(self, audio) -> torch.Tensor:
        """(T,) 16-kHz mono -> (T_enc, 2 n_mels) stacked log-mel on the
        model's device: a 400-sample periodic Hann centred in a 512-point
        STFT, the precise HTK mel, log10, floored 8 below the maximum, two
        frames a row."""
        wav = torch.as_tensor(np.asarray(audio, np.float32).reshape(-1))
        n_fft, win_length, hop = 512, 400, 160
        n_mels = self.config.enc.input_dim // 2
        pad_l = (n_fft - win_length) // 2
        win = F.pad(hanning(win_length, periodic=True),
                    (pad_l, n_fft - win_length - pad_l))
        spec = stft(wav.to(self.device), n_fft=n_fft, hop_length=hop,
                    window=win, center=True, pad_mode="reflect")
        power = spec_abs(spec) ** 2
        fb = mel_filters(16000, n_fft, n_mels, mel_scale="htk",
                         precise=True).to(power.device)
        n_keep = 2 * (wav.shape[0] // (2 * hop))
        logmel = torch.log10(torch.clamp(power[:n_keep] @ fb.T, min=1e-10))
        logmel = torch.maximum(logmel, logmel.max() - 8.0) / 4.0 + 1.0
        return logmel.reshape(-1, 2 * n_mels)

    # ------------------------------------------------------------ pipeline

    @torch.inference_mode()
    def _encode(self, feats) -> Tuple[np.ndarray, torch.Tensor]:
        """(T, input_dim) -> (the BPE argmax over T // w windows, the audio
        rows (ceil(T / block) x block / downsample, llm_dim))."""
        feats = torch.as_tensor(feats).to(self.device, self.dtype)
        bpe_logits, fused = nar_encoder_forward(self, feats[None])
        audio = nar_projector_forward(self, fused)
        return bpe_logits[0].argmax(-1).cpu().numpy(), audio[0]

    @torch.inference_mode()
    def _edit(self, audio_embeds: torch.Tensor, text_ids: np.ndarray
              ) -> np.ndarray:
        cfg = self.config
        p = self.editor
        ids = torch.as_tensor(np.asarray(text_ids), dtype=torch.long,
                              device=self.device)
        text = p.embed_tokens(ids)
        if cfg.scale_projected_embeddings:
            audio_embeds = audio_embeds / cfg.text.embedding_multiplier
        embeds = torch.cat([audio_embeds.to(text.dtype), text])[None]
        logits = editor_forward(self, embeds, audio_embeds.shape[0])
        return logits[0].argmax(-1).cpu().numpy()

    def transcribe_tokens(self, feats) -> np.ndarray:
        """The two passes: CTC on the encoder, the collapse and its
        insertion slots, the editor, its collapse -> token ids."""
        cfg = self.config
        blank = cfg.blank_token_id
        t0 = time.perf_counter()
        bpe_argmax, audio_embeds = self._encode(feats)
        t1 = time.perf_counter()
        hypothesis = ctc_collapse_decode(bpe_argmax, blank_id=blank)
        text_ids = add_insertion_slots(hypothesis, blank_id=blank,
                                       min_len=cfg.min_edit_sequence_length)
        edited = self._edit(audio_embeds, text_ids)
        self.last_run = {"frames": int(np.shape(feats)[0]),
                         "audio_rows": int(audio_embeds.shape[0]),
                         "slots": int(len(text_ids)),
                         "encode_ms": (t1 - t0) * 1e3,
                         "edit_ms": (time.perf_counter() - t1) * 1e3}
        return ctc_collapse_decode(edited, blank_id=blank)

    def generate(self, audio, **kwargs) -> STTOutput:
        wav = as_audio(audio, self.sample_rate)
        t0 = time.time()
        feats = self._extract_features(wav)
        tokens = self.transcribe_tokens(feats)
        if self._tokenizer is not None:
            text = self._tokenizer.decode([int(t) for t in tokens],
                                          skip_special_tokens=True)
        else:
            text = " ".join(str(int(t)) for t in tokens)
        wall = time.time() - t0
        return STTOutput(text=text, total_time=wall,
                         generation_tokens=len(tokens),
                         generation_tps=len(tokens) / wall if wall else 0.0)

    __call__ = generate

    # ------------------------------------------------------------- loading

    def model_quant_predicate(self, path: str, leaf) -> bool:
        return path.startswith("editor.")

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """Batch-norm step counters dropped; conv weights to WIO from the
        layout their shapes show."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {k: np.asarray(v) for k, v in weights.items()
               if not k.endswith("num_batches_tracked")}
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3
                            and k.endswith("weight") and any(
                                s in k for s in ("up_conv", "down_conv",
                                                 "depth_conv")))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path))
        return model


__all__ = ["Model", "ModelConfig", "EncoderConfig", "ProjectorConfig",
           "TextConfig", "ctc_collapse_decode", "add_insertion_slots",
           "nar_encoder_forward", "nar_projector_forward", "editor_forward"]
