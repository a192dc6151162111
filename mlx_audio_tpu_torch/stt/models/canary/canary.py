"""Canary: NVIDIA's multilingual ASR/AST, a FastConformer encoder and a
transformer decoder; its tokenizer and decoder are shared with Cohere ASR.

Counterpart of mlx_audio_tpu/stt/models/canary/canary.py:

* `PreprocessorConfig`, `DecoderConfig` and `ModelConfig` (:47-93),
  `MEL_BUCKETS` (:44) and `CanaryTokenizer` (:96-145), copied. A plain
  piece list (`tokens.json`, index -> piece) decodes without sentencepiece;
  sentencepiece is imported only for a `tokenizer.model`, and its absence
  raises there;
* `_fixed_positions` (:150-158): interleaved sin/cos scaled by 1/sqrt(d);
* the decoder of `init_decoder` (:161-181) as `nn.Module`s named after the
  JAX leaves (`embedding`, `embedding_layer_norm`, `blocks.N.{self_attn_norm,
  self_attn.{q,k,v,out}_proj, cross_attn_norm, cross_attn.{...}, ff_norm,
  ff1, ff2}`, `final_norm`, `output_proj`);
* `cross_kv` (:189-196) and `decoder_forward` (:199-244): the causal
  prefill and the one-token step over stacked self-attention caches;
* `greedy_decode`, the counterpart of the `lax.while_loop` of `_fns`
  (:316-354), which Cohere ASR's `decode` runs too;
* the `Model` (:249-482): `_log_mel` with pre-emphasis in host numpy
  (:278-293), the encoder (the shared `parakeet.conformer`) at a mel bucket
  with `encoder_proj` where `d_model != enc_output_dim`, `generate` (the
  `language` keyword sets both languages), `sanitize` and
  `post_load_hook`.

Departures: `decoder_forward` returns the hidden state after the final
norm and `logits` applies the head, so a caller projects only the rows it
needs. The caches are written in place and attention reads their written
columns (the JAX package masks the whole buffer). The caches are f32, as
the JAX callers' are, so self-attention runs in f32; a bf16 model computes
the rest in bf16. The greedy loop is Python over eager steps, its flags
copied to the host without blocking (`ops/host_flags.py`): it stops at
most `STEPS_AFTER_EOS` step after the one where every row finished, with
the same kept tokens, and skips the step whose logits no kept token needs.
For Canary's `Model`:

* a prompt plus `max_tokens` past the `max_sequence_length` rows of the
  position table raises before the prefill; JAX's gather clamps the index
  and repeats the last position;
* `post_load_hook` raises when a tokenizer file is present but fails to
  load; JAX swallows the error and `generate` later says "tokenizer not
  loaded";
* `sanitize` reads each conv weight's layout, torch (O, I, K[, K]) or MLX
  (O, K[, K], I), from the model's own parameter shapes; JAX transposes
  every 3-D weight whose first axis is longer than its last, which is
  right for torch's layout and wrong for MLX's. It renames the decoder's
  keys only: JAX's renames `linear_q` etc. to `q_proj` in the encoder's
  keys too, where the conformer reads `linear_q`.
"""

from __future__ import annotations

import base64
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....dsp import log_mel_spectrogram
from ....model import TorchModel, check_device
from ....nn import Embedding, LayerNorm, Linear
from ....ops.attention import attention
from ....ops.host_flags import FinishedFlags
from ....ops.kvcache import KVCache, kv_update
from ....utils import load_audio
from ..base import STTOutput
from ..parakeet.conformer import (Conformer, ConformerArgs,
                                  conformer_forward, subsampled_length)

MEL_BUCKETS = (256, 512, 1024, 2048, 3008)
# steps the decode may run after the one where every row has finished: it
# reads the flags of step i-1 before launching step i+1
STEPS_AFTER_EOS = 1


@dataclass
class PreprocessorConfig(BaseModelArgs):
    sample_rate: int = 16000
    normalize: str = "per_feature"
    features: int = 128
    n_fft: int = 512
    window_size: float = 0.025
    window_stride: float = 0.01
    preemph: float = 0.97


@dataclass
class DecoderConfig(BaseModelArgs):
    num_layers: int = 8
    hidden_size: int = 1024
    num_attention_heads: int = 16
    inner_size: int = 4096
    max_sequence_length: int = 1024


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "canary"
    vocab_size: int = 16384
    enc_output_dim: int = 1024
    encoder: dict = field(default_factory=dict)
    transf_decoder: Optional[DecoderConfig] = None
    preprocessor: Optional[PreprocessorConfig] = None

    def __post_init__(self):
        if isinstance(self.transf_decoder, dict):
            self.transf_decoder = DecoderConfig.from_dict(
                self.transf_decoder)
        if self.transf_decoder is None:
            self.transf_decoder = DecoderConfig()
        if isinstance(self.preprocessor, dict):
            self.preprocessor = PreprocessorConfig.from_dict(
                self.preprocessor)
        if self.preprocessor is None:
            self.preprocessor = PreprocessorConfig()

    def conformer_args(self) -> ConformerArgs:
        valid = set(ConformerArgs.__dataclass_fields__)
        return ConformerArgs(**{k: v for k, v in self.encoder.items()
                                if k in valid})


# ----------------------------------------------------------- tokenizer

class CanaryTokenizer:
    """SentencePiece tokenizer + Canary prompt format. A plain piece list
    (`tokens.json`, index -> piece) gives decode-only support without
    sentencepiece."""

    def __init__(self, model_path: Optional[str] = None, *,
                 model_proto: Optional[bytes] = None,
                 piece_list: Optional[List[str]] = None):
        self.sp = None
        if piece_list is not None:
            self.vocab_size = len(piece_list)
            self.token2id = {s: i for i, s in enumerate(piece_list)}
            self._pieces = piece_list
            return
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError(
                "a tokenizer.model needs the sentencepiece package, which is "
                "not installed; a tokens.json piece list (index -> piece) "
                "needs nothing") from e
        if model_proto is not None:
            self.sp = spm.SentencePieceProcessor(model_proto=model_proto)
        else:
            self.sp = spm.SentencePieceProcessor()
            self.sp.load(model_path)
        self.vocab_size = self.sp.get_piece_size()
        self.token2id = {self.sp.id_to_piece(i): i
                         for i in range(self.vocab_size)}

    def encode(self, text: str) -> List[int]:
        if self.sp is None:
            raise RuntimeError("encode() needs the sentencepiece model")
        return self.sp.encode(text)

    def decode(self, ids: List[int]) -> str:
        if self.sp is None:
            return "".join(self._pieces[i] for i in ids
                           if 0 <= i < self.vocab_size) \
                .replace("▁", " ").strip()
        return self.sp.decode(ids)

    def build_prompt_tokens(self, source_lang: str = "en",
                            target_lang: str = "en",
                            use_pnc: bool = True) -> List[int]:
        t = self.token2id
        return [t["<|startofcontext|>"], t["<|startoftranscript|>"],
                t["<|emo:undefined|>"], t[f"<|{source_lang}|>"],
                t[f"<|{target_lang}|>"],
                t["<|pnc|>"] if use_pnc else t["<|nopnc|>"],
                t["<|noitn|>"], t["<|notimestamp|>"], t["<|nodiarize|>"]]

    @property
    def eos_id(self) -> int:
        return self.token2id.get("<|endoftext|>", 0)


# -------------------------------------------------------------- decoder

def _fixed_positions(max_len: int, d: int) -> np.ndarray:
    """Interleaved sin/cos scaled by 1/sqrt(d)."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d))
    ang = pos * div
    pe = np.stack([np.sin(ang), np.cos(ang)], axis=2).reshape(max_len, d)
    return (pe / np.sqrt(d)).astype(np.float32)


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)


class DecoderBlock(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.self_attn_norm = LayerNorm(d)
        self.self_attn = Attention(d)
        self.cross_attn_norm = LayerNorm(d)
        self.cross_attn = Attention(d)
        self.ff_norm = LayerNorm(d)
        self.ff1 = Linear(d, inner)
        self.ff2 = Linear(inner, d)


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, vocab: int, d: int):
        super().__init__()
        self.embedding = Embedding(vocab, d)
        self.embedding_layer_norm = LayerNorm(d)
        self.blocks = nn.ModuleList(DecoderBlock(d, cfg.inner_size)
                                    for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(d)
        self.output_proj = Linear(d, vocab)


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.view(b, t, n, -1)


def cross_kv(dec: TransformerDecoder, cfg: DecoderConfig,
             enc: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each block's cross-attention (k, v), (B, S, H, hd), from the encoder
    output (B, S, d)."""
    h = cfg.num_attention_heads
    return [(_heads(blk.cross_attn.k_proj(enc), h),
             _heads(blk.cross_attn.v_proj(enc), h)) for blk in dec.blocks]


def encoder_bias(enc_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) bool valid encoder frames -> the additive cross-attention
    mask (B, 1, 1, S): 0 or -1e9 (not -inf, so a row with no valid frame
    stays finite)."""
    return torch.zeros(enc_mask.shape, device=enc_mask.device).masked_fill(
        ~enc_mask, -1e9)[:, None, None, :]


def decoder_forward(dec: TransformerDecoder, cfg: DecoderConfig,
                    tokens: torch.Tensor, enc_bias: torch.Tensor,
                    caches: KVCache, ckv: List, offset: int,
                    pos_table: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) at positions offset..offset+T-1 -> hidden (B, T, d)
    after the final norm. Each block writes its self-attention k/v into
    `caches` (stacked, f32) at `offset`, in place, and attends in f32 over
    the offset + T written columns, causally among the T new rows."""
    b, t = tokens.shape
    h = cfg.num_attention_heads
    x = dec.embedding(tokens)
    x = dec.embedding_layer_norm(x + pos_table[offset:offset + t].to(x.dtype))
    s = offset + t
    mask = None
    if t > 1:
        q_pos = torch.arange(offset, s, device=x.device)[:, None]
        mask = torch.zeros(t, s, device=x.device).masked_fill(
            torch.arange(s, device=x.device)[None, :] > q_pos, float("-inf"))
    for i, blk in enumerate(dec.blocks):
        a = blk.self_attn
        hn = blk.self_attn_norm(x)
        c = kv_update(caches.layer(i), _heads(a.k_proj(hn), h),
                      _heads(a.v_proj(hn), h), offset)
        o = attention(_heads(a.q_proj(hn), h).float(), c.k[:, :s],
                      c.v[:, :s], mask=mask)
        x = x + a.out_proj(o.to(x.dtype).reshape(b, t, -1))
        ca = blk.cross_attn
        ck, cv = ckv[i]
        o = attention(_heads(ca.q_proj(blk.cross_attn_norm(x)), h), ck, cv,
                      mask=enc_bias)
        x = x + ca.out_proj(o.reshape(b, t, -1))
        x = x + blk.ff2(F.relu(blk.ff1(blk.ff_norm(x))))
    return dec.final_norm(x)


def logits(dec: TransformerDecoder, h: torch.Tensor) -> torch.Tensor:
    """Hidden (..., d) -> logits (..., vocab)."""
    return dec.output_proj(h)


@torch.inference_mode()
def greedy_decode(dec: TransformerDecoder, cfg: DecoderConfig,
                  pos_table: torch.Tensor, enc: torch.Tensor,
                  enc_mask: torch.Tensor, prompt: List[int],
                  max_tokens: int, eos_id: int, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, int]:
    """Batched decode after `prompt` over the encoder output (B, S, d) ->
    (tokens (B, max_tokens) on the device, EOS from each row's first EOS
    on; decode steps run). Greedy, or sampled at `temperature` > 0 from
    `generator`. A row with no valid encoder frame starts finished."""
    b, dev = enc.shape[0], enc.device
    d = dec.embedding.weight.shape[1]
    plen = len(prompt)
    ckv = cross_kv(dec, cfg, enc)
    ebias = encoder_bias(enc_mask)
    caches = KVCache.init(b, plen + max_tokens, cfg.num_attention_heads,
                          d // cfg.num_attention_heads, dtype=torch.float32,
                          device=dev, n_layers=cfg.num_layers)
    ids = torch.tensor(prompt, device=dev).expand(b, plen)
    h = decoder_forward(dec, cfg, ids, ebias, caches, ckv, 0, pos_table)
    lg = logits(dec, h[:, -1])
    toks = torch.full((b, max_tokens), eos_id, dtype=torch.long, device=dev)
    done = ~enc_mask.any(dim=1)
    flags = FinishedFlags(max(max_tokens, 1), done)
    lag = STEPS_AFTER_EOS + 1
    steps = 0
    for i in range(max_tokens):
        if i >= lag and bool(flags.read(i - lag).all()):
            break
        if temperature > 0.0:
            nxt = torch.multinomial(torch.softmax(lg.float() / temperature,
                                                  dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = lg.argmax(dim=-1)
        nxt = torch.where(done, eos_id, nxt)
        done = done | (nxt == eos_id)
        toks[:, i] = nxt
        flags.record(i, done)
        steps = i + 1
        if steps < max_tokens:
            h = decoder_forward(dec, cfg, nxt[:, None], ebias, caches, ckv,
                                plen + i, pos_table)
            lg = logits(dec, h[:, 0])
    return toks, steps


# ---------------------------------------------------------------- model

def mel_bucket(t: int) -> int:
    """The MEL_BUCKETS bucket of t frames; past the last, t rounded up to
    a multiple of 512."""
    return next((b for b in MEL_BUCKETS if t <= b), ((t + 511) // 512) * 512)


def _to_jax_conv(key: str, w: np.ndarray, torch_shape: Tuple[int, ...]
                 ) -> np.ndarray:
    """A conv weight in torch (O, I, K[, K]) or MLX (O, K[, K], I) layout,
    told apart by the model's own torch-layout shape for it -> the JAX
    tree's WIO / HWIO."""
    if w.shape == torch_shape:
        return np.transpose(w, (2, 1, 0) if w.ndim == 3 else (2, 3, 1, 0))
    o, i, *k = torch_shape
    if w.shape == (o, *k, i):
        return np.transpose(w, (1, 2, 0) if w.ndim == 3 else (1, 2, 3, 0))
    raise ValueError(f"{key}: shape {w.shape} is neither torch's "
                     f"{torch_shape} nor MLX's {(o, *k, i)}")


class Model(TorchModel):
    """Canary on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda"):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        self.args = config.conformer_args()
        self.dec_cfg = config.transf_decoder
        d = config.enc_output_dim
        with torch.device(device):
            self.encoder = Conformer(self.args)
            self.decoder = TransformerDecoder(self.dec_cfg, config.vocab_size,
                                              d)
            self.encoder_proj = (Linear(self.args.d_model, d)
                                 if self.args.d_model != d else None)
        self.requires_grad_(False)
        self.eval()
        # the decoder's fixed positions, f32 on the device (not a parameter)
        self.pos_table = torch.from_numpy(_fixed_positions(
            self.dec_cfg.max_sequence_length, d)).to(device)
        self._tokenizer: Optional[CanaryTokenizer] = None
        self.last_run: Dict[str, int] = {}

    @property
    def sample_rate(self) -> int:
        return self.config.preprocessor.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the parameters: the compute dtype."""
        return self.decoder.embedding.weight.dtype

    def _log_mel(self, audio: np.ndarray) -> np.ndarray:
        """Samples -> the per-feature-normalized log mel (T, F) in host
        numpy: pre-emphasis, a periodic Hann window of n_fft, ln(mel +
        1e-6), each mel bin normalized over the frames (ddof 0)."""
        pp = self.config.preprocessor
        x = np.asarray(audio, np.float32).reshape(-1)
        if pp.preemph:
            x = np.concatenate([x[:1], x[1:] - pp.preemph * x[:-1]])
        mel = log_mel_spectrogram(
            x, n_fft=pp.n_fft,
            hop_length=int(pp.window_stride * pp.sample_rate),
            n_mels=pp.features, sample_rate=pp.sample_rate,
            log_base="ln", log_floor_mode="add").numpy()
        mean = mel.mean(axis=0, keepdims=True)
        std = mel.std(axis=0, keepdims=True) + 1e-5
        return (mel - mean) / std

    @torch.inference_mode()
    def encode(self, mel: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """A log mel (T, F) -> (encoder output (1, T', d), valid frames
        (1, T') bool), run at its `mel_bucket`."""
        t = mel.shape[0]
        padded = np.zeros((1, mel_bucket(t), mel.shape[1]), np.float32)
        padded[0, :t] = mel
        feats = torch.from_numpy(padded).to(self.device, self.dtype)
        n = torch.tensor([t], device=self.device)
        enc = conformer_forward(self.encoder, self.args, feats, n)
        if self.encoder_proj is not None:
            enc = self.encoder_proj(enc)
        mask = torch.arange(enc.shape[1], device=enc.device)[None, :] \
            < subsampled_length(self.args, n)[:, None]
        return enc, mask

    def generate(self, audio, *, max_tokens: int = 200,
                 source_lang: str = "en", target_lang: str = "en",
                 use_pnc: bool = True, temperature: float = 0.0,
                 seed: int = 0, stream: bool = False,
                 verbose: bool = False, **kwargs) -> STTOutput:
        """Transcribe (or translate) `audio` (a path, or samples at the
        preprocessor's rate) in one pass: `max_tokens` at most, greedy or
        sampled at `temperature` from `seed`. `language` sets both
        languages; `stream` is accepted and ignored, as in the JAX
        package."""
        language = kwargs.pop("language", None)
        if language:
            source_lang = target_lang = language
        t0 = time.time()
        if isinstance(audio, (str, Path)):
            audio = load_audio(str(audio), self.sample_rate)
        if self._tokenizer is None:
            raise RuntimeError("tokenizer not loaded (place the "
                               "sentencepiece model beside the weights)")
        prompt = self._tokenizer.build_prompt_tokens(source_lang,
                                                     target_lang, use_pnc)
        limit = self.dec_cfg.max_sequence_length
        if len(prompt) + max_tokens > limit:
            raise ValueError(
                f"a prompt of {len(prompt)} tokens plus max_tokens="
                f"{max_tokens} exceeds the decoder's {limit} positions")
        mel = self._log_mel(np.asarray(audio))
        enc, enc_mask = self.encode(mel)
        generator = None
        if temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        toks, steps = greedy_decode(
            self.decoder, self.dec_cfg, self.pos_table, enc, enc_mask,
            prompt, max_tokens, self._tokenizer.eos_id, float(temperature),
            generator)
        row = toks[0].cpu().numpy()
        stop = np.flatnonzero(row == self._tokenizer.eos_id)
        generated = (row[:stop[0]] if stop.size else row).tolist()
        self.last_run = {"decode_steps": steps,
                         "mel_bucket": mel_bucket(mel.shape[0])}
        text = self._tokenizer.decode(generated).strip()
        dt = time.time() - t0
        if verbose:
            print(f"Text: {text}")
        return STTOutput(
            text=text, language=source_lang,
            segments=[{"text": text, "start": 0.0, "end": 0.0}],
            prompt_tokens=len(prompt), generation_tokens=len(generated),
            total_tokens=len(prompt) + len(generated), total_time=dt,
            prompt_tps=len(prompt) / dt if dt else 0,
            generation_tps=len(generated) / dt if dt else 0)

    __call__ = generate

    # ------------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The MLX-native community layout's decoder names (transf_decoder.
        layers.N.first_sub_layer.linear_q etc., head.classifier) and
        NeMo-native names onto the JAX tree's, as numpy; the encoder's
        names are the tree's already (its attention's `linear_q` stays, where
        JAX renames it to the decoder's `q_proj` too); conv weights, torch's
        or MLX's layout as the model's own shapes tell, to WIO / HWIO."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        renames = (
            ("transf_decoder._decoder.layers.", "decoder.blocks."),
            ("transf_decoder.layers.", "decoder.blocks."),
            (".first_sub_layer.", ".self_attn."),
            (".second_sub_layer.", ".cross_attn."),
            (".third_sub_layer.", ".ff."),
            (".linear_q.", ".q_proj."), (".linear_k.", ".k_proj."),
            (".linear_v.", ".v_proj."), (".linear_out.", ".out_proj."),
            (".ff.dense_in.", ".ff1."), (".ff.dense_out.", ".ff2."),
            ("head.classifier.", "decoder.output_proj."),
            ("transf_decoder.embedding.token_embedding.",
             "decoder.embedding."))
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if not k.startswith("encoder."):
                for old, new in renames:
                    k = k.replace(old, new)
            if k.endswith("weight") and v.ndim in (3, 4) and k in shapes:
                v = _to_jax_conv(k, v, shapes[k])
            out[k] = v
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The tokenizer: a sentencepiece model file (`tokenizer.model`,
        `spm.model` or `canary_tokenizer.model`), else config.json's
        `tokenizer_model_base64`, else a `tokens.json` piece list. A file
        that is present but fails to load raises."""
        model_path = Path(model_path)
        for name in ("tokenizer.model", "spm.model",
                     "canary_tokenizer.model"):
            f = model_path / name
            if f.exists():
                model._tokenizer = CanaryTokenizer(str(f))
                return model
        cfg = model_path / "config.json"
        if cfg.exists():
            proto = json.loads(cfg.read_text()).get("tokenizer_model_base64")
            if proto:
                model._tokenizer = CanaryTokenizer(
                    model_proto=base64.b64decode(proto))
                return model
        tokens = model_path / "tokens.json"
        if tokens.exists():
            model._tokenizer = CanaryTokenizer(
                piece_list=json.loads(tokens.read_text(encoding="utf-8")))
        return model


__all__ = ["Model", "ModelConfig", "PreprocessorConfig", "DecoderConfig",
           "CanaryTokenizer", "TransformerDecoder", "MEL_BUCKETS",
           "_fixed_positions", "cross_kv", "encoder_bias", "decoder_forward",
           "logits", "greedy_decode", "mel_bucket"]
