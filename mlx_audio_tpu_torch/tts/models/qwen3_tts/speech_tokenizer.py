"""Qwen3-TTS 12.5 Hz split-RVQ speech-tokenizer decoder, one-shot and
streaming.

Counterpart of the decode half of
mlx_audio_tpu/tts/models/qwen3_tts/speech_tokenizer.py: `snake_beta`,
`causal_conv` and `causal_conv_step`, `causal_tconv` and
`causal_tconv_step`, `split_rvq_decode`, the pre-transformer (sliding
window, LayerScale) with and without caches, the ConvNeXt and residual
units, `decode_full` (:358-379), `init_stream_state` (:390-456) and
`streaming_step` (:459-497); and `encoder_mimi_config` (:504-548), the
Mimi config of the reference encoder that ICL voice cloning encodes a
clip with (the port's codec/models/mimi). Module names follow the JAX tree
(`speech_tokenizer.decoder.<...>`); the convolutions hold torch layouts,
converted from the JAX package's WIO / pre-flipped kernels by
`model.load_jax_params`.

The streaming state is a nested dict of fixed-shape tensors laid out as the
JAX package's pytree (conv tails, transposed-conv overflows, the
pre-transformer's KV caches, the stream offset). `Decoder.streaming_step`
returns the new state; it writes the KV caches in place, every other leaf
is a new tensor. Given a row `mask`, rows outside it come back unchanged
(`take_rows`), so one batched step serves rows at different stream ages.

Departure: a transposed conv's streamed overflow is carried without the
conv's bias (`CausalTConv.step`), so the overlap samples hold the bias
once and the stream equals `forward` with any bias. The JAX package's
`causal_tconv_step` adds it twice there; at zero biases the two agree.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import (Conv1d, ConvTranspose1d, Embedding, LayerNorm, Linear,
                    RMSNorm, conv_transpose1d, gelu)
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update_rows
from ....ops.rope import apply_rotary, rope_cos_sin, rope_freqs
from .config import Qwen3TTSTokenizerDecoderConfig

# frames the streaming pre-transformer's KV buffer holds by default
# (:44): a stream longer than its state's buffer raises
STREAM_CACHE_LEN = 4096


class SnakeBeta(nn.Module):
    """x + 1/(e^beta) sin^2(e^alpha x) (snake_beta, :52-56)."""

    init_fill = {"alpha": 0.0, "beta": 0.0}

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(dim))
        self.beta = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.exp(self.alpha)
        beta = torch.exp(self.beta)
        return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha) ** 2


class CausalConv(nn.Module):
    """`{"conv": {...}}` holder; left-pads (k-1)*dil + 1 - stride."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.kernel = kernel
        self.conv = Conv1d(in_ch, out_ch, kernel, bias=bias, groups=groups)

    def forward(self, x: torch.Tensor, dilation: int = 1,
                stride: int = 1) -> torch.Tensor:
        pad = (self.kernel - 1) * dilation + 1 - stride
        return self.conv(x, stride=stride, padding=(pad, 0),
                         dilation=dilation)

    def step(self, x: torch.Tensor, buf: torch.Tensor, dilation: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming form (causal_conv_step, :70-76): `buf` (B, pad, C)
        holds the last pad inputs. -> (y, new buf)."""
        ctx = torch.cat([buf, x], dim=1)
        y = self.conv(ctx, dilation=dilation)
        return y, ctx[:, ctx.shape[1] - buf.shape[1]:]


class CausalTConv(nn.Module):
    """Transposed conv with the last kernel - stride samples trimmed."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.conv = ConvTranspose1d(in_ch, out_ch, kernel)

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        y = self.conv(x, stride=stride)
        trim = self.kernel - stride
        return y[:, :y.shape[1] - trim] if trim > 0 else y

    def step(self, x: torch.Tensor, overflow: torch.Tensor, stride: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming form (causal_tconv_step, :85-97): the conv runs
        without its bias, the tail carried from the last call is added to
        the first samples, the bias is added to the samples handed out, and
        the trimmed kernel - stride samples are carried, bias-free, to the
        next call. Each sample then holds the bias once, as in `forward`;
        the JAX package carries the biased tail, and the next chunk adds
        the bias to it again. A fresh stream's overflow is zeros.
        -> (y, new overflow)."""
        trim = self.kernel - stride
        if trim <= 0:
            return self.conv(x, stride=stride), overflow
        y = conv_transpose1d(x, self.conv.weight, stride=stride)
        ov = overflow.shape[1]
        y = torch.cat([y[:, :ov] + overflow, y[:, ov:]], dim=1)
        out = y[:, :y.shape[1] - trim]
        if self.conv.bias is not None:
            out = out + self.conv.bias.to(out.dtype)
        return out, y[:, y.shape[1] - trim:]


class Codebook(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self.embed = Embedding(size, dim)


class VQLayer(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self.codebook = Codebook(size, dim)


class VQ(nn.Module):
    def __init__(self, n_q: int, size: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(VQLayer(size, dim) for _ in range(n_q))


class RVQ(nn.Module):
    def __init__(self, n_q: int, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        dim = cfg.codebook_dim // 2
        # 1x1 conv (JAX WIO (1, dim, codebook_dim)), no bias
        self.output_proj = Conv1d(dim, cfg.codebook_dim, 1, bias=False)
        self.vq = VQ(n_q, cfg.codebook_size, dim)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, n_q, T) -> (B, T, codebook_dim)."""
        acc = None
        for i, layer in enumerate(self.vq.layers):
            q = layer.codebook.embed(codes[:, i])
            acc = q if acc is None else acc + q
        return self.output_proj(acc)


class SplitRVQ(nn.Module):
    """Semantic level(s) and acoustic rest, decoded and summed
    (split_rvq_decode, :126-148)."""

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.n_sem = cfg.num_semantic_quantizers
        self.rvq_first = RVQ(cfg.num_semantic_quantizers, cfg)
        self.rvq_rest = RVQ(cfg.num_quantizers - cfg.num_semantic_quantizers,
                            cfg)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        out = self.rvq_first(codes[:, :self.n_sem])
        if codes.shape[1] > self.n_sem:
            out = out + self.rvq_rest(codes[:, self.n_sem:])
        return out


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.init_fill = {"scale": init}
        self.scale = nn.Parameter(torch.empty(dim))


class TfAttention(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        hd, b = cfg.head_dim, cfg.attention_bias
        self.q_proj = Linear(cfg.hidden_size, cfg.num_attention_heads * hd, b)
        self.k_proj = Linear(cfg.hidden_size, cfg.num_key_value_heads * hd, b)
        self.v_proj = Linear(cfg.hidden_size, cfg.num_key_value_heads * hd, b)
        self.o_proj = Linear(cfg.num_attention_heads * hd, cfg.hidden_size, b)


class TfMLP(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size, False)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, False)
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size, False)


class TfLayer(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        eps, init = cfg.rms_norm_eps, cfg.layer_scale_initial_scale
        self.self_attn = TfAttention(cfg)
        self.mlp = TfMLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.self_attn_layer_scale = LayerScale(cfg.hidden_size, init)
        self.mlp_layer_scale = LayerScale(cfg.hidden_size, init)


class PreTransformer(nn.Module):
    """Sliding-window causal transformer with LayerScale
    (pre_transformer_forward, :201-258): `forward` over a whole sequence,
    `step` against KV caches."""

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.input_proj = Linear(cfg.latent_dim, cfg.hidden_size)
        self.output_proj = Linear(cfg.hidden_size, cfg.latent_dim)
        self.layers = nn.ModuleList(TfLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.register_buffer("inv_freq",
                             rope_freqs(cfg.head_dim, cfg.rope_theta),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        positions = torch.arange(t, device=x.device)[None, :]
        return self._run(x, positions, self._window(positions, t))

    def step(self, x: torch.Tensor, caches, offset: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, latent) at stream ages `offset` (a 0-dim tensor, or
        (B,) per row); writes each layer's KV in place at its rows'
        offsets and attends over the whole buffer through the sliding
        window. Rows outside `mask` (B,) bool keep their cache columns."""
        b, t = x.shape[:2]
        off = offset.reshape(-1).expand(b)
        positions = off[:, None] + torch.arange(t, device=x.device)
        return self._run(x, positions,
                         self._window(positions, caches[0].k.shape[1]),
                         caches, off, mask)

    def _window(self, positions: torch.Tensor, s: int) -> torch.Tensor:
        """Additive (B|1, 1, T, s) mask: each query sees itself and the
        sliding_window - 1 keys before it."""
        pos_s = torch.arange(s, device=positions.device)
        q_pos = positions[:, None, :, None]
        ok = (pos_s <= q_pos) & (pos_s > q_pos - self.cfg.sliding_window)
        return torch.zeros(ok.shape, device=positions.device).masked_fill(
            ~ok, float("-inf"))

    def _run(self, x: torch.Tensor, positions: torch.Tensor,
             mask: torch.Tensor, caches=None, off=None,
             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        x = self.input_proj(x)
        cos, sin = rope_cos_sin(positions, self.inv_freq)
        if rows is not None:
            keep = ~rows[:, None, None, None]
            r = torch.arange(b, device=x.device)[:, None]
            cols = off[:, None] + torch.arange(t, device=x.device)
        for i, lp in enumerate(self.layers):
            a = lp.self_attn
            h = lp.input_layernorm(x)
            q = apply_rotary(a.q_proj(h).reshape(b, t, nh, hd), cos, sin)
            k = apply_rotary(a.k_proj(h).reshape(b, t, nkv, hd), cos, sin)
            v = a.v_proj(h).reshape(b, t, nkv, hd)
            if caches is not None:
                c = caches[i]
                if rows is not None:
                    k = torch.where(keep, c.k[r, cols], k)
                    v = torch.where(keep, c.v[r, cols], v)
                kv_update_rows(c, k, v, off)
                k, v = c.k, c.v
            out = attention(q, k, v, mask=mask).reshape(b, t, nh * hd)
            x = x + a.o_proj(out) * lp.self_attn_layer_scale.scale
            h = lp.post_attention_layernorm(x)
            m = lp.mlp
            x = x + (m.down_proj(F.silu(m.gate_proj(h)) * m.up_proj(h))
                     * lp.mlp_layer_scale.scale)
        return self.output_proj(self.norm(x))


class ConvNeXt(nn.Module):
    """Depthwise causal conv k=7 -> LayerNorm -> MLP (exact GELU) -> gamma
    residual (_convnext_apply, :277-289)."""

    init_fill = {"gamma": 1e-6}

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = CausalConv(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._mlp(x, self.dwconv(x))

    def step(self, x: torch.Tensor, buf: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, buf = self.dwconv.step(x, buf)
        return self._mlp(x, h), buf

    def _mlp(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h = self.pwconv2(gelu(self.pwconv1(self.norm(h))))
        return x + self.gamma * h


class ResUnit(nn.Module):
    """snake -> causal conv k=7 (dilated) -> snake -> 1x1 conv, residual
    (_res_unit_apply, :302-314)."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.act1 = SnakeBeta(dim)
        self.conv1 = CausalConv(dim, dim, 7)
        self.act2 = SnakeBeta(dim)
        self.conv2 = CausalConv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.act1(x), dilation=self.dilation)
        return self.conv2(self.act2(h)) + x

    def step(self, x: torch.Tensor, buf: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, buf = self.conv1.step(self.act1(x), buf, dilation=self.dilation)
        return self.conv2(self.act2(h)) + x, buf


class DecoderBlock(nn.Module):
    """snake -> upsampling transposed conv -> residual units dil 1, 3, 9."""

    def __init__(self, in_dim: int, out_dim: int, rate: int):
        super().__init__()
        self.rate = rate
        self.block = nn.ModuleList([
            SnakeBeta(in_dim), CausalTConv(in_dim, out_dim, rate * 2),
            ResUnit(out_dim, 1), ResUnit(out_dim, 3), ResUnit(out_dim, 9)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        snake, tconv, *units = self.block
        x = tconv(snake(x), self.rate)
        for unit in units:
            x = unit(x)
        return x

    def step(self, x: torch.Tensor, st: dict) -> Tuple[torch.Tensor, dict]:
        """Streaming form over st {overflow, res2_buf, res3_buf, res4_buf}
        (streaming_step, :484-493)."""
        snake, tconv, *units = self.block
        x, ov = tconv.step(snake(x), st["overflow"], self.rate)
        ns = {"overflow": ov}
        for name, unit in zip(("res2_buf", "res3_buf", "res4_buf"), units):
            x, ns[name] = unit.step(x, st[name])
        return x, ns


class Decoder(nn.Module):
    """codes (B, n_q, T) -> audio (B, T * total_upsample) (init_decoder,
    :317-351; decode_full, :358-379)."""

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.pre_transformer = PreTransformer(cfg)
        self.quantizer = SplitRVQ(cfg)
        self.pre_conv = CausalConv(cfg.codebook_dim, cfg.latent_dim, 3)
        self.upsample = nn.ModuleList(
            nn.ModuleList([CausalTConv(cfg.latent_dim, cfg.latent_dim,
                                       factor * 2), ConvNeXt(cfg.latent_dim)])
            for factor in cfg.upsampling_ratios)
        blocks = [CausalConv(cfg.latent_dim, cfg.decoder_dim, 7)]
        for li, rate in enumerate(cfg.upsample_rates):
            blocks.append(DecoderBlock(cfg.decoder_dim // 2 ** li,
                                       cfg.decoder_dim // 2 ** (li + 1), rate))
        out_dim = cfg.decoder_dim // 2 ** len(cfg.upsample_rates)
        blocks += [SnakeBeta(out_dim), CausalConv(out_dim, 1, 7)]
        self.decoder = nn.ModuleList(blocks)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.quantizer(codes)
        h = self.pre_conv(h)
        h = self.pre_transformer(h)
        for (tconv, convnext), factor in zip(self.upsample,
                                             cfg.upsampling_ratios):
            h = convnext(tconv(h, factor))
        for block in self.decoder:
            h = block(h)
        return torch.clamp(h[..., 0], -1.0, 1.0)

    def streaming_step(self, state: dict, codes: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[dict, torch.Tensor]:
        """Decode only the new codes (B, n_q, T) -> (new state, audio (B,
        T * total_upsample)) (streaming_step, :459-497). With `mask` (B,)
        bool, rows outside it come back bit-for-bit unchanged (their codes
        are padding and their audio is not to be used): the batched decode
        of continuous batching (`_get_batch_stream_decoder`,
        qwen3_tts.py:869-892)."""
        cfg = self.cfg
        off = state["offset"]
        ns = {"upsample": {}, "decoder": {}}
        h = self.quantizer(codes)
        h, ns["pre_conv_buf"] = self.pre_conv.step(h, state["pre_conv_buf"])
        h = self.pre_transformer.step(h, state["tf_caches"], off, mask)
        ns["tf_caches"] = state["tf_caches"]
        ns["offset"] = off + codes.shape[-1]
        for i, ((tconv, convnext), factor) in enumerate(
                zip(self.upsample, cfg.upsampling_ratios)):
            st = state["upsample"][str(i)]
            h, ov = tconv.step(h, st["overflow"], factor)
            h, cb = convnext.step(h, st["convnext_buf"])
            ns["upsample"][str(i)] = {"overflow": ov, "convnext_buf": cb}
        first, *blocks, snake, out_conv = self.decoder
        h, ns["decoder"]["init_buf"] = first.step(
            h, state["decoder"]["init_buf"])
        for li, block in enumerate(blocks):
            h, ns["decoder"][str(li + 1)] = block.step(
                h, state["decoder"][str(li + 1)])
        h, ns["decoder"]["out_buf"] = out_conv.step(
            snake(h), state["decoder"]["out_buf"])
        if mask is not None:
            ns = take_rows(mask, ns, state)
        return ns, torch.clamp(h[..., 0], -1.0, 1.0)


class SpeechTokenizer(nn.Module):
    """`decoder`, and the Mimi reference `encoder` once a model attaches
    one (`Model.attach_ref_encoder`)."""

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig):
        super().__init__()
        self.decoder = Decoder(cfg)


def encoder_mimi_config(enc_cfg: Optional[dict]):
    """The MimiConfig of the tokenizer's `encoder_config` dict (None: the
    published defaults, 32 quantizers of 2,048 x 256 at 12.5 Hz). The
    reference encoder (SEANet, projected transformer, a stride-2
    downsample, split RVQ) is the Mimi encoder under other field names."""
    from ....codec.models.mimi.mimi import MimiConfig

    e = dict(enc_cfg or {})
    return MimiConfig(
        channels=e.get("audio_channels", 1),
        sample_rate=e.get("sampling_rate", 24000),
        frame_rate=e.get("frame_rate", 12.5),
        seanet=dict(
            dimension=e.get("hidden_size", 512),
            channels=e.get("audio_channels", 1),
            nfilters=e.get("num_filters", 64),
            nresidual_layers=e.get("num_residual_layers", 1),
            ratios=e.get("upsampling_ratios", [8, 6, 5, 4]),
            ksize=e.get("kernel_size", 7),
            residual_ksize=e.get("residual_kernel_size", 3),
            last_ksize=e.get("last_kernel_size", 3),
            dilation_base=e.get("dilation_growth_rate", 2),
            pad_mode="constant",
            true_skip=not e.get("use_conv_shortcut", False),
            compress=e.get("compress", 2)),
        transformer=dict(
            d_model=e.get("hidden_size", 512),
            num_heads=e.get("num_attention_heads", 8),
            num_layers=e.get("num_hidden_layers", 8),
            layer_scale=e.get("layer_scale_initial_scale", 0.01),
            context=e.get("sliding_window", 250),
            max_period=float(e.get("rope_theta", 10000.0)),
            dim_feedforward=e.get("intermediate_size", 2048)),
        quantizer_nq=e.get("num_quantizers", 32),
        quantizer_bins=e.get("codebook_size", 2048),
        quantizer_dim=e.get("codebook_dim", 256))


def total_upsample(cfg: Qwen3TTSTokenizerDecoderConfig) -> int:
    return int(math.prod(cfg.upsample_rates) * math.prod(cfg.upsampling_ratios))


def init_stream_state(cfg: Qwen3TTSTokenizerDecoderConfig, batch: int = 1,
                      dtype=torch.float32, device=None,
                      per_row_offset: bool = False,
                      cache_len: Optional[int] = None) -> dict:
    """The streaming state, all zeros and of fixed shapes (:390-456).
    `offset` is a 0-dim int64 tensor, or (batch,) with `per_row_offset`
    so that rows admitted at different times decode through one batched
    step. `cache_len` right-sizes the pre-transformer's KV buffer (default
    STREAM_CACHE_LEN frames): attention reads all of it every step."""
    cache_len = cache_len or STREAM_CACHE_LEN

    def z(t: int, c: int) -> torch.Tensor:
        return torch.zeros(batch, t, c, dtype=dtype, device=device)

    caches = KVCache.init(batch, cache_len, cfg.num_key_value_heads,
                          cfg.head_dim, dtype, device,
                          n_layers=cfg.num_hidden_layers)
    state = {
        "offset": torch.zeros((batch,) if per_row_offset else (),
                              dtype=torch.long, device=device),
        "pre_conv_buf": z(2, cfg.codebook_dim),
        "tf_caches": [caches.layer(i)
                      for i in range(cfg.num_hidden_layers)],
        "upsample": {str(i): {"overflow": z(factor, cfg.latent_dim),
                              "convnext_buf": z(6, cfg.latent_dim)}
                     for i, factor in enumerate(cfg.upsampling_ratios)},
        "decoder": {"init_buf": z(6, cfg.latent_dim)},
    }
    for li, rate in enumerate(cfg.upsample_rates):
        out_dim = cfg.decoder_dim // 2 ** (li + 1)
        state["decoder"][str(li + 1)] = {
            "overflow": z(rate, out_dim), "res2_buf": z(6, out_dim),
            "res3_buf": z(18, out_dim), "res4_buf": z(54, out_dim)}
    state["decoder"]["out_buf"] = z(
        6, cfg.decoder_dim // 2 ** len(cfg.upsample_rates))
    return state


def take_rows(mask: torch.Tensor, new, old):
    """The state `new` on the rows where `mask` (B,) is set and `old`
    elsewhere, leaf by leaf (every leaf is batch-leading; a 0-dim offset
    takes mask[0]). A leaf that is `old`'s own tensor (the KV caches,
    written in place by a masked step) is kept as it is."""
    if isinstance(new, dict):
        return {k: take_rows(mask, v, old[k]) for k, v in new.items()}
    if isinstance(new, (list, tuple)) and not isinstance(new, KVCache):
        return [take_rows(mask, n, o) for n, o in zip(new, old)]
    if isinstance(new, KVCache):
        return KVCache(*(take_rows(mask, n, o) for n, o in zip(new, old)))
    if new is old:
        return new
    m = mask.reshape((-1,) + (1,) * (new.ndim - 1)) if new.ndim else mask[0]
    return torch.where(m, new, old)


def reset_rows(state: dict, rows) -> None:
    """Zero the state of batch rows `rows` in place: a fresh stream for
    each (the continuous-batching admission, continuous_batching.py:296,
    430)."""
    for v in (state.values() if isinstance(state, dict) else state):
        if isinstance(v, (dict, list)):
            reset_rows(v, rows)
        elif isinstance(v, KVCache):
            v.k[rows] = 0
            v.v[rows] = 0
        else:
            v[rows] = 0
