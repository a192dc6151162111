"""Shared pieces of the LLM-decoder STT families on the llama backbone:
Voxtral, Qwen2-Audio, GLM-ASR, Granite Speech and VibeVoice-ASR.

Each family encodes its audio, splices the encoder's rows into a prompt's
token embeddings and decodes with `tts.models.llama`'s `Model` held as
`language_model` (the JAX tree's `init_llama` under that name). Counterpart
of the pieces those five JAX modules share:

* the Whisper-style tower of mlx_audio_tpu/stt/models/voxtral/voxtral.py
  (`init_audio_tower` and `audio_tower_forward`, :92-139), which
  Qwen2-Audio reuses with fixed sinusoidal positions and a 2x average pool
  before its last LayerNorm (qwen2_audio.py:107-149): `WhisperTower`,
  `tower_forward`; MOSS-Transcribe-Diarize's `whisper_encoder_forward` and
  Higgs Audio v3's (its `final_pool2` the same pool) run on it too;
* the prompt splice (each `generate`'s `embeds[0, pos[:m]] = feats[:m]`):
  `splice_embeds`;
* each family's jitted prefill and while-loop (or chunk scan) decode, here
  `stt.models.qwen3_lm`'s eager prefill and chunks of DEC_CHUNK steps with
  one read a chunk (`decode_fns`, `lm_forward`).

Departures, the same in every family:

* the prompt is not padded to a bucket (a TPU workaround): the prefill
  runs its n rows, which gives the same logits;
* the decode is `qwen3_lm`'s: draws from a `torch.Generator` (only greedy
  decoding compares with JAX token for token), a stop at most one step
  after EOS with the same kept tokens, f32 caches that grow with the decode
  up to n + max_tokens columns (JAX allocates them all at once), and a step
  that reads only the columns written so far; the repetition penalty's
  history runs on across chunks (GLM-ASR's JAX chunk starts a new, empty
  one every 32 tokens);
* a bf16 model computes in bf16 against f32 caches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...model import holder
from ...nn import Conv1d, Embedding, LayerNorm, Linear, gelu
from ...ops.attention import attention
from ...ops.kvcache import KVCache
from ...tts.models.llama.llama import (init_caches, llama_forward,
                                       logits_from_hidden)
from .qwen3_lm import DEC_CHUNK, DecodeFns, prompt_decode_fns

# (temperature, top_k, top_p, min_p, repetition_penalty,
#  repetition_context_size, min_tokens_to_keep)
GREEDY = (0.0, 0, 1.0, 0.0, 1.0, 20, 1)


def sampling_knobs(temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 1.0, min_p: float = 0.0,
                   repetition_penalty: Optional[float] = 1.0,
                   repetition_context_size: int = 20,
                   min_tokens_to_keep: int = 1) -> tuple:
    """The sampling knobs as the tuple `decode_fns` keys on."""
    return (float(temperature), int(top_k), float(top_p), float(min_p),
            float(repetition_penalty or 1.0), int(repetition_context_size),
            int(min_tokens_to_keep))


# ------------------------------------------------------------------ tower


class WhisperTower(nn.Module):
    """init_audio_tower's tree (voxtral.py:92-114): `conv1`, `conv2`,
    `embed_positions` (`n_positions` rows), `layers.N` (pre-norm, k_proj
    without bias) and the final `layer_norm` (GLM-ASR's encoder holds it
    outside: `final_norm=False`)."""

    def __init__(self, a, n_positions: Optional[int] = None,
                 final_norm: bool = True):
        super().__init__()
        d = a.d_model
        self.conv1 = Conv1d(a.num_mel_bins, d, 3)
        self.conv2 = Conv1d(d, d, 3)
        self.embed_positions = Embedding(
            n_positions or a.max_source_positions, d)
        self.layers = nn.ModuleList(holder(
            self_attn_layer_norm=LayerNorm(d),
            self_attn=holder(q_proj=Linear(d, d),
                             k_proj=Linear(d, d, bias=False),
                             v_proj=Linear(d, d), out_proj=Linear(d, d)),
            final_layer_norm=LayerNorm(d),
            fc1=Linear(d, a.encoder_ffn_dim),
            fc2=Linear(a.encoder_ffn_dim, d))
            for _ in range(a.encoder_layers))
        if final_norm:
            self.layer_norm = LayerNorm(d)


def tower_forward(tower: WhisperTower, heads: int, mel: torch.Tensor,
                  pool: bool = False) -> torch.Tensor:
    """mel (B, T, n_mels) -> (B, T / 2, d) (`audio_tower_forward`): two
    GELU convs (the second stride 2), the learned or fixed positions, the
    pre-norm layers, then the final LayerNorm; with `pool` a 2x average
    pool first, an odd last frame dropped (Qwen2-Audio)."""
    x = gelu(tower.conv1(mel, padding=1))
    x = gelu(tower.conv2(x, stride=2, padding=1))
    x = x + tower.embed_positions.weight[:x.shape[1]].to(x.dtype)[None]
    b, t, d = x.shape
    for lp in tower.layers:
        hn = lp.self_attn_layer_norm(x)
        sa = lp.self_attn
        q = sa.q_proj(hn).reshape(b, t, heads, d // heads)
        k = sa.k_proj(hn).reshape(b, t, heads, d // heads)
        v = sa.v_proj(hn).reshape(b, t, heads, d // heads)
        x = x + sa.out_proj(attention(q, k, v).reshape(b, t, d))
        x = x + lp.fc2(gelu(lp.fc1(lp.final_layer_norm(x))))
    if pool:
        t2 = (t // 2) * 2
        x = x[:, :t2].reshape(b, t2 // 2, 2, d).mean(dim=2)
    return tower.layer_norm(x)


# ----------------------------------------------------------------- prompt


def splice_embeds(lm, ids: Sequence[int], feats: torch.Tensor,
                  positions: Optional[Sequence[int]] = None,
                  audio_id: Optional[int] = None) -> torch.Tensor:
    """The prompt's token embeddings (1, n, D) on the LM's device, ids past
    the vocabulary looked up as id 0, the rows at `positions` (or at each
    `audio_id`) replaced in order by the first rows of `feats`."""
    tok = torch.as_tensor(list(ids), dtype=torch.long)
    vocab = lm.config.vocab_size
    safe = torch.where(tok >= vocab, 0, tok)
    dev = lm.model.embed_tokens.weight.device
    embeds = lm.model.embed_tokens(safe[None].to(dev))
    if positions is None:
        positions = torch.nonzero(tok == audio_id)[:, 0].tolist()
    m = min(len(positions), feats.shape[0])
    if m:
        idx = torch.as_tensor(list(positions[:m]), device=dev)
        embeds[0, idx] = feats[:m].to(dev, embeds.dtype)
    return embeds


# ----------------------------------------------------------------- decode


def lm_forward(lm, embeds: torch.Tensor, caches: Optional[KVCache],
               offset: int, pad_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """`llama_forward` of embeds (B, T, D) against a view of the caches'
    first offset + T columns, the only ones a query may attend to (written
    in place at `offset`); `pad_mask` (B, S) additive over the caches'
    columns."""
    view = caches
    if caches is not None:
        used = offset + embeds.shape[1]
        view = KVCache(caches.k[:, :, :used], caches.v[:, :, :used])
        if pad_mask is not None:
            pad_mask = pad_mask[:, :used]
    hidden, _ = llama_forward(lm, embeds, caches=view, offset=offset,
                              mask=pad_mask)
    return hidden, caches


def decode_fns(lm, n: int, max_tokens: int, sampling: tuple,
               eos_ids: Tuple[int, ...],
               min_context: int = 0) -> DecodeFns:
    """`qwen3_lm.prompt_decode_fns` over the llama LM `lm` for an n-row
    prompt: f32 caches on the LM's device, the repetition penalty's
    history at least `min_context` tokens long."""
    cfg = lm.config
    dev = lm.model.embed_tokens.weight.device
    return prompt_decode_fns(
        text_config=cfg, embed_fn=lm.model.embed_tokens,
        forward_fn=lambda e, c, o, m: lm_forward(lm, e, c, o, m),
        logits_fn=lambda h: logits_from_hidden(lm, h),
        make_caches=lambda cols: init_caches(cfg, 1, cols, torch.float32,
                                             dev),
        n=n, max_tokens=max_tokens, sampling=sampling, eos_ids=eos_ids,
        min_context=min_context)


def decode_tokens(gen) -> List[int]:
    """Drain an `iter_decode` generator -> the kept tokens."""
    out: List[int] = []
    for new in gen:
        out.extend(new)
    return out


def as_audio(audio, sample_rate: int) -> np.ndarray:
    """A path (read and resampled to `sample_rate`), a list (its first
    item), a tensor or an array -> mono f32 numpy."""
    from pathlib import Path

    from ...utils import load_audio

    x = audio[0] if isinstance(audio, list) else audio
    if isinstance(x, (str, Path)):
        x = load_audio(x, sample_rate=sample_rate)
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32).reshape(-1)


__all__ = ["GREEDY", "DEC_CHUNK", "sampling_knobs", "WhisperTower",
           "tower_forward", "splice_embeds", "lm_forward", "decode_fns",
           "decode_tokens", "as_audio"]
