"""The Qwen3 LM of MOSS-TTS, shared by the Qwen3 LM families.

Counterpart of `init_qwen3_lm` (:76-86) and `qwen3_lm_forward` (:89-107) in
mlx_audio_tpu/tts/models/moss_tts/moss_tts.py: the token table
`embed_tokens`, the Qwen3 layers (`qwen3_tts.talker.Qwen3Layer`, QK-norm
GQA attention and a SiLU MLP) and the final RMSNorm `norm`, under the JAX
tree's names. Any config with the Qwen3 text fields builds it (Qwen3-ASR's
`TextConfig` as well as `Qwen3LMConfig`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ....nn import Embedding
from ....ops.kvcache import KVCache
from ..qwen3_tts.talker import LayerStack


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


__all__ = ["Qwen3LM", "init_qwen3_lm", "qwen3_lm_forward", "lm_logits"]
