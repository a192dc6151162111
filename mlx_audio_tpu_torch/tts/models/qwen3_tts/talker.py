"""Qwen3-TTS talker and code-predictor transformers.

Counterpart of mlx_audio_tpu/tts/models/qwen3_tts/talker.py. The JAX
package stores each layer stack stacked (a leading L axis on every leaf)
and runs it as one `lax.scan`; here each layer is its own module in an
`nn.ModuleList` and a Python loop runs them (`model.load_jax_params`
unstacks the JAX tree). The KV cache is still one stacked buffer
(L, B, S, Hkv, D) of which each layer writes its own view in place.

MRoPE is plain RoPE over the same inverse frequencies, since the three
position streams are equal for TTS (talker.py:8-11).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import Embedding, Linear, RMSNorm, StackedTable
from ....ops.attention import attention, decode_attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import apply_rotary, rope_cos_sin, rope_freqs
from .config import Qwen3TTSTalkerCodePredictorConfig, Qwen3TTSTalkerConfig


class SelfAttention(nn.Module):
    def __init__(self, hidden: int, n_heads: int, n_kv: int, head_dim: int,
                 bias: bool, eps: float):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.q_proj = Linear(hidden, n_heads * head_dim, bias=bias)
        self.k_proj = Linear(hidden, n_kv * head_dim, bias=bias)
        self.v_proj = Linear(hidden, n_kv * head_dim, bias=bias)
        self.o_proj = Linear(n_heads * head_dim, hidden, bias=bias)
        self.q_norm = RMSNorm(head_dim, eps)
        self.k_norm = RMSNorm(head_dim, eps)


class MLP(nn.Module):
    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.gate_proj = Linear(hidden, inter, bias=False)
        self.up_proj = Linear(hidden, inter, bias=False)
        self.down_proj = Linear(inter, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen3Layer(nn.Module):
    """QK-norm GQA attention + SiLU MLP (qwen3_layer_forward, :143-186)."""

    def __init__(self, hidden: int, n_heads: int, n_kv: int, head_dim: int,
                 inter: int, bias: bool, eps: float):
        super().__init__()
        self.self_attn = SelfAttention(hidden, n_heads, n_kv, head_dim, bias,
                                       eps)
        self.mlp = MLP(hidden, inter)
        self.input_layernorm = RMSNorm(hidden, eps)
        self.post_attention_layernorm = RMSNorm(hidden, eps)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: Optional[KVCache], offset: int,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """`mask`: additive, for a multi-token step (with or without a
        cache); a one-token step against a cache reads `offset + 1` valid
        entries, or the (B, S) bool `mask` of valid entries if given."""
        b, t, _ = x.shape
        a = self.self_attn
        h = self.input_layernorm(x)
        q = a.q_norm(a.q_proj(h).reshape(b, t, a.n_heads, a.head_dim))
        k = a.k_norm(a.k_proj(h).reshape(b, t, a.n_kv, a.head_dim))
        v = a.v_proj(h).reshape(b, t, a.n_kv, a.head_dim)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if cache is not None:
            kv_update(cache, k, v, offset)
            if t == 1:
                out = decode_attention(q, cache.k, cache.v, offset + 1,
                                       lengths_mask=mask)
            else:
                out = attention(q, cache.k, cache.v, mask=mask)
        else:
            out = attention(q, k, v, mask=mask)
        x = x + a.o_proj(out.reshape(b, t, a.n_heads * a.head_dim))
        return x + self.mlp(self.post_attention_layernorm(x))


class LayerStack(nn.Module):
    """`layers` + final `norm` with the rope table (scan_layers, :214-278)."""

    def __init__(self, n_layers: int, hidden: int, n_heads: int, n_kv: int,
                 head_dim: int, inter: int, bias: bool, eps: float,
                 rope_theta: float):
        super().__init__()
        self.layers = nn.ModuleList(
            Qwen3Layer(hidden, n_heads, n_kv, head_dim, inter, bias, eps)
            for _ in range(n_layers))
        self.norm = RMSNorm(hidden, eps)
        self.register_buffer("inv_freq", rope_freqs(head_dim, rope_theta),
                             persistent=False)

    def run(self, x: torch.Tensor, caches: Optional[KVCache], offset: int,
            lengths_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Causal pass over x (B, T, D), writing the stacked cache (if any)
        at column `offset`; returns the normed hidden. RoPE rotates at
        offset.. unless `positions` (B, T) says otherwise (scan_layers,
        :214-278; continuous batching writes every row at the shared
        column `offset` and rotates each at its own length).

        With a cache and T > 1 the additive mask spans the whole buffer:
        keys after the query or past offset+T are masked, plus
        `lengths_mask` (B, 1, 1, S) if given (the prefill's pad mask). With
        a cache and T = 1, `lengths_mask` is the (B, S) bool of each row's
        valid columns, which then replaces the first offset+1."""
        b, t, _ = x.shape
        if positions is None:
            positions = offset + torch.arange(t, device=x.device)[None, :]
        cos, sin = rope_cos_sin(positions, self.inv_freq)
        mask = None
        if t > 1:
            s = caches.k.shape[2] if caches is not None else t
            pos_s = torch.arange(s, device=x.device)[None, None, None, :]
            q_pos = (offset + torch.arange(t, device=x.device))[
                None, None, :, None]
            ok = (pos_s <= q_pos) & (pos_s < offset + t)
            mask = torch.zeros(ok.shape, device=x.device).masked_fill(
                ~ok, float("-inf"))
            if lengths_mask is not None:
                mask = mask + lengths_mask
        elif caches is not None:
            mask = lengths_mask
        for i, layer in enumerate(self.layers):
            cache = caches.layer(i) if caches is not None else None
            x = layer(x, cos, sin, cache, offset, mask)
        return self.norm(x)


class TalkerModel(LayerStack):
    def __init__(self, cfg: Qwen3TTSTalkerConfig):
        super().__init__(cfg.num_hidden_layers, cfg.hidden_size,
                         cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim, cfg.intermediate_size,
                         cfg.attention_bias, cfg.rms_norm_eps, cfg.rope_theta)
        self.codec_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.text_embedding = Embedding(cfg.text_vocab_size,
                                        cfg.text_hidden_size)


class TextProjection(nn.Module):
    """ResizeMLP: text_hidden -> silu -> hidden (text_projection, :315)."""

    def __init__(self, text_hidden: int, hidden: int):
        super().__init__()
        self.linear_fc1 = Linear(text_hidden, text_hidden, bias=True)
        self.linear_fc2 = Linear(text_hidden, hidden, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_fc2(F.silu(self.linear_fc1(x)))


class CodePredictor(nn.Module):
    """Predicts code groups 1..G-1 of a frame (init_code_predictor, :354)."""

    def __init__(self, cfg: Qwen3TTSTalkerCodePredictorConfig,
                 talker_hidden: int):
        super().__init__()
        self.cfg = cfg
        g1 = cfg.num_code_groups - 1
        self.model = LayerStack(cfg.num_hidden_layers, cfg.hidden_size,
                                cfg.num_attention_heads,
                                cfg.num_key_value_heads, cfg.head_dim,
                                cfg.intermediate_size, cfg.attention_bias,
                                cfg.rms_norm_eps, cfg.rope_theta)
        # per-group codec embeddings and heads, stacked (G-1, V, D). The
        # embeddings are as wide as the talker, as in the published
        # checkpoint: their sum joins the talker's next input, and each
        # sub-step's input goes through small_to_mtp_projection. (The JAX
        # package's init sizes them at the code predictor's width, which
        # only works while the two widths are equal.)
        self.model.codec_embedding = StackedTable(g1, cfg.vocab_size,
                                                  talker_hidden)
        self.lm_head = StackedTable(g1, cfg.vocab_size, cfg.hidden_size)
        self.small_to_mtp_projection = (
            Linear(talker_hidden, cfg.hidden_size, bias=True)
            if cfg.hidden_size != talker_hidden else None)

    def forward(self, x: torch.Tensor, caches: KVCache, offset: int,
                head_idx: int) -> torch.Tensor:
        """One step -> logits (B, V) of head `head_idx` at the last
        position (code_predictor_forward, :383-408)."""
        if self.small_to_mtp_projection is not None:
            x = self.small_to_mtp_projection(x)
        h = self.model.run(x, caches, offset)
        return h[:, -1] @ self.lm_head.weight[head_idx].T

    def sample(self, hidden: torch.Tensor, code0_embed: torch.Tensor,
               sample_fn: Callable[[torch.Tensor], torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Groups 1..G-1 of one frame, one sub-step each, against a fresh
        cache of G+2 (code_predictor_sample, :411-458).

        hidden (B, 1, D_talker): the talker's hidden state at the frame;
        code0_embed (B, 1, D): talker codec embedding of group 0's token.
        Returns (codes (B, G-1), summed code-predictor embedding of those
        codes (B, 1, D))."""
        cfg = self.cfg
        n_groups = cfg.num_code_groups
        b = hidden.shape[0]
        table = self.model.codec_embedding.weight            # (G-1, V, D)
        caches = KVCache.init(b, n_groups + 2, cfg.num_key_value_heads,
                              cfg.head_dim, hidden.dtype, hidden.device,
                              n_layers=cfg.num_hidden_layers)
        logits = self(torch.cat([hidden, code0_embed], dim=1), caches, 0, 0)
        tok = sample_fn(logits)
        toks = [tok]
        emb_sum = torch.zeros_like(code0_embed)
        for gi in range(1, n_groups - 1):
            x = table[gi - 1][tok][:, None]
            emb_sum = emb_sum + x
            logits = self(x, caches, gi + 1, gi)
            tok = sample_fn(logits)
            toks.append(tok)
        emb_sum = emb_sum + table[n_groups - 2][tok][:, None]
        return torch.stack(toks, dim=1), emb_sum


class Talker(nn.Module):
    def __init__(self, cfg: Qwen3TTSTalkerConfig):
        super().__init__()
        self.cfg = cfg
        self.model = TalkerModel(cfg)
        self.text_projection = TextProjection(cfg.text_hidden_size,
                                              cfg.hidden_size)
        self.codec_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.code_predictor = CodePredictor(cfg.code_predictor_config,
                                            cfg.hidden_size)

    def forward(self, embeds: torch.Tensor, caches: Optional[KVCache],
                offset: int, lengths_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (codec logits (B, T, V), hidden (B, T, D)) (talker_forward,
        :321-346). `offset` is the cache write column; `positions` (B, T)
        overrides the RoPE positions (LayerStack.run)."""
        h = self.model.run(embeds, caches, offset, lengths_mask, positions)
        return self.codec_head(h), h

    def make_cache(self, batch: int, max_len: int, dtype,
                   device) -> KVCache:
        cfg = self.cfg
        return KVCache.init(batch, max_len, cfg.num_key_value_heads,
                            cfg.head_dim, dtype, device,
                            n_layers=cfg.num_hidden_layers)
