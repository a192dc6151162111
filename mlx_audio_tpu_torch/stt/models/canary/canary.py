"""Canary's tokenizer and transformer decoder, shared with Cohere ASR.

Counterpart of the decoder half of mlx_audio_tpu/stt/models/canary/
canary.py:

* `DecoderConfig` (:58-64) and `CanaryTokenizer` (:96-145), copied. A plain
  piece list (`tokens.json`, index -> piece) decodes without sentencepiece;
  sentencepiece is imported only for a `tokenizer.model`, and its absence
  raises there;
* `_fixed_positions` (:150-158): interleaved sin/cos scaled by 1/sqrt(d);
* the decoder of `init_decoder` (:161-181) as `nn.Module`s named after the
  JAX leaves (`embedding`, `embedding_layer_norm`, `blocks.N.{self_attn_norm,
  self_attn.{q,k,v,out}_proj, cross_attn_norm, cross_attn.{...}, ff_norm,
  ff1, ff2}`, `final_norm`, `output_proj`);
* `cross_kv` (:189-196) and `decoder_forward` (:199-244): the causal
  prefill and the one-token step over stacked self-attention caches.

Departures: `decoder_forward` returns the hidden state after the final
norm and `logits` applies the head, so a caller projects only the rows it
needs. The caches are written in place and attention reads their written
columns (the JAX package masks the whole buffer). The caches are f32, as
the JAX caller's are (cohere_asr.py:391-394), so self-attention runs in f32;
a bf16 model computes the rest in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....nn import Embedding, LayerNorm, Linear
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update


@dataclass
class DecoderConfig(BaseModelArgs):
    num_layers: int = 8
    hidden_size: int = 1024
    num_attention_heads: int = 16
    inner_size: int = 4096
    max_sequence_length: int = 1024


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


__all__ = ["DecoderConfig", "CanaryTokenizer", "TransformerDecoder",
           "_fixed_positions", "cross_kv", "encoder_bias", "decoder_forward",
           "logits"]
