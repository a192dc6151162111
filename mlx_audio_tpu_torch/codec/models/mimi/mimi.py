"""Mimi: Moshi's 12.5 Hz streaming codec (SEANet, a windowed RoPE
transformer and a split residual VQ).

Counterpart of mlx_audio_tpu/codec/models/mimi/mimi.py:

* `MimiConfig` with `from_dict` taking both the kyutai nested schema and
  the HF `MimiModel` flat one (:49-149), `mimi_202407`;
* the causal conv helpers (:157-203): `_causal_conv` pads eff - stride on
  the left and, at stride > 1, the extra right cover a whole last frame
  needs; `pad_mode` "edge" is torch's replicate, "reflect" torch's reflect
  on the left with a zero extra cover; `_causal_tconv` cuts kernel - stride
  from the end; `_conv_step` and `_tconv_step` are their streaming forms
  (a conv's past in a buffer; a transposed conv's overflow carried to the
  next chunk, its bias subtracted so that it is added once);
* the transformer (:338-377), whole (a causal window of `context` frames)
  and against a KV cache at a host-int offset;
* the SEANet encoder and decoder (:381-427), the split RVQ (:431-462),
  `encode`, `decode` and `encode_to_latent` (:466-537), and the streaming
  `init_decode_stream_state`, `decode_step` and `decode_latent_step`
  (:495-576);
* `sanitize` (`sanitize_mimi`, with `remap_hf` for HF `MimiModel` keys;
  :580-716) for kyutai and HF checkpoints, codebooks rebuilt from
  cluster_usage / embedding_sum;
* `from_pretrained`, a local directory of config.json and weights (the JAX
  package's `FunctionalModel.from_pretrained`, model.py:63), never
  downloaded.

Activations are channel-last (B, T, C). Parameters keep torch's layouts
(model.py), so a torch checkpoint's conv kernels bind as they are; the
depthwise frame-rate `upsample.convtr` (groups = dimension) comes from the
JAX tree through `load_jax_params`, which reads its groups off the module.
`Mimi(..., decoder=False)` builds the encode path only (the Qwen3-TTS
reference encoder).

Departure from the JAX package, pinned by
tests/test_torch_mimi.py::test_stream_keeps_the_first_chunks_bias: a fresh
stream's transposed-conv overflow is the conv's bias, where JAX's zeros
take the bias off the first kernel - stride frames of a stream's first
chunk (the streamed audio then differs from `decode` wherever the SEANet
upsample biases are not zero, as in a trained checkpoint). `encode` and `encode_to_latent` run under
`exact_f32()`: codes are an argmin over distances, and cuDNN's default
TF32 convolutions would flip some of them on the card.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import Conv1d, ConvTranspose1d, Embedding, LayerNorm, Linear
from ....nn.layers import gelu
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import apply_rotary, rope_cos_sin, rope_freqs
from ..blocks import vq_encode


@contextmanager
def exact_f32():
    """Full-f32 matmuls and cuDNN convolutions inside the block (TF32 off),
    restored after it. The flags are process-wide."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@dataclass
class SeanetConfig:
    dimension: int = 512
    channels: int = 1
    causal: bool = True
    nfilters: int = 64
    nresidual_layers: int = 1
    ratios: List[int] = field(default_factory=lambda: [8, 6, 5, 4])
    ksize: int = 7
    residual_ksize: int = 3
    last_ksize: int = 3
    dilation_base: int = 2
    pad_mode: str = "constant"
    true_skip: bool = True
    compress: int = 2


@dataclass
class TransformerConfig:
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 8
    layer_scale: float = 0.01
    context: int = 250
    max_period: float = 10000.0
    dim_feedforward: int = 2048


@dataclass
class MimiConfig(BaseModelArgs):
    channels: int = 1
    sample_rate: float = 24000
    frame_rate: float = 12.5
    renormalize: bool = True
    seanet: SeanetConfig = field(default_factory=SeanetConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    quantizer_nq: int = 16
    quantizer_bins: int = 2048
    quantizer_dim: int = 256
    model_path: str = ""

    def __post_init__(self):
        if isinstance(self.seanet, dict):
            self.seanet = SeanetConfig(**self.seanet)
        if isinstance(self.transformer, dict):
            self.transformer = TransformerConfig(**{
                k: v for k, v in self.transformer.items()
                if k in TransformerConfig.__dataclass_fields__})

    @classmethod
    def from_dict(cls, config: dict):
        """The kyutai nested config, or the HF-transformers `MimiConfig`
        flat schema (the kyutai/mimi hub repo's)."""
        if isinstance(config, dict) and (
                "upsampling_ratios" in config or "num_filters" in config):
            hidden = config.get("hidden_size", 512)
            sr = config.get("sampling_rate", 24000)
            ratios = list(config.get("upsampling_ratios", [8, 6, 5, 4]))
            # HF's frame-rate downsampler is a fixed stride-2 conv, and its
            # frame_rate a computed property absent from to_dict()
            frame_rate = config.get(
                "frame_rate", sr / float(math.prod(ratios)) / 2.0)
            return cls(
                channels=config.get("audio_channels", 1),
                sample_rate=sr,
                frame_rate=frame_rate,
                seanet=dict(
                    dimension=hidden,
                    channels=config.get("audio_channels", 1),
                    causal=config.get("use_causal_conv", True),
                    nfilters=config.get("num_filters", 64),
                    nresidual_layers=config.get("num_residual_layers", 1),
                    ratios=ratios,
                    ksize=config.get("kernel_size", 7),
                    residual_ksize=config.get("residual_kernel_size", 3),
                    last_ksize=config.get("last_kernel_size", 3),
                    dilation_base=config.get("dilation_growth_rate", 2),
                    pad_mode=config.get("pad_mode", "constant"),
                    compress=config.get("compress", 2)),
                transformer=dict(
                    d_model=hidden,
                    num_heads=config.get("num_attention_heads", 8),
                    num_layers=config.get("num_hidden_layers", 8),
                    layer_scale=config.get("layer_scale_initial_scale", 0.01),
                    context=config.get("sliding_window", 250),
                    max_period=config.get("rope_theta", 10000.0),
                    dim_feedforward=config.get("intermediate_size", 2048)),
                quantizer_nq=config.get("num_quantizers", 16),
                quantizer_bins=config.get("codebook_size", 2048),
                quantizer_dim=config.get(
                    "vector_quantization_hidden_dimension", 256),
                model_path=config.get("model_path", ""))
        return super().from_dict(config)


def mimi_202407(num_codebooks: int = 16) -> MimiConfig:
    return MimiConfig(quantizer_nq=num_codebooks)


ModelConfig = MimiConfig


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x, alpha=1.0)


# ---------------------------------------------------------------------------
# causal conv helpers
# ---------------------------------------------------------------------------


def _causal_conv(conv: Conv1d, x: torch.Tensor, kernel: int, stride: int = 1,
                 dilation: int = 1, pad_mode: str = "constant",
                 extra_cover: bool = True) -> torch.Tensor:
    eff = (kernel - 1) * dilation + 1
    pad_left = eff - stride
    t = x.shape[-2]
    extra = 0
    if extra_cover and stride > 1:
        nframes = math.ceil((t + pad_left - eff) / stride) + 1
        ideal = (nframes - 1) * stride + eff - pad_left
        extra = max(0, ideal - t)
    if pad_mode == "reflect":
        # torch 'reflect' (no edge duplication); the extra cover stays zero
        if pad_left:
            x = torch.cat([torch.flip(x[:, 1:pad_left + 1], dims=(1,)), x], 1)
        if extra:
            x = F.pad(x, (0, 0, 0, extra))
    elif pad_mode == "edge":
        x = F.pad(x.transpose(1, 2), (pad_left, extra),
                  mode="replicate").transpose(1, 2)
    else:
        x = F.pad(x, (0, 0, pad_left, extra))
    return conv(x, stride=stride, dilation=dilation)


def _causal_tconv(conv: ConvTranspose1d, x: torch.Tensor, kernel: int,
                  stride: int) -> torch.Tensor:
    y = conv(x, stride=stride)
    trim = max(kernel - stride, 0)
    return y[:, : y.shape[1] - trim] if trim > 0 else y


def _conv_step(conv: Conv1d, x: torch.Tensor, buf: torch.Tensor,
               dilation: int = 1, stride: int = 1):
    """Streaming causal conv on whole-frame chunks; buf holds the past
    eff - stride frames. -> (y, new buf)."""
    ctx = torch.cat([buf, x], dim=1)
    y = conv(ctx, stride=stride, dilation=dilation)
    keep = buf.shape[1]
    return y, (ctx[:, ctx.shape[1] - keep:] if keep > 0 else buf)


def _tconv_step(conv: ConvTranspose1d, x: torch.Tensor,
                overflow: torch.Tensor, kernel: int, stride: int):
    """Streaming causal transposed conv: the last kernel - stride output
    frames are carried to the next chunk (less the bias, which the next
    chunk's output adds again). A fresh stream's overflow is the bias
    itself (`init_decode_stream_state`), so that the first chunk keeps its
    bias. -> (y, new overflow)."""
    y = conv(x, stride=stride)
    trim = max(kernel - stride, 0)
    if trim == 0:
        return y, overflow
    ov = overflow.shape[1]
    add = overflow if conv.bias is None else overflow - conv.bias.to(y.dtype)
    y = torch.cat([y[:, :ov] + add, y[:, ov:]], dim=1)
    return y[:, : y.shape[1] - trim], y[:, y.shape[1] - trim:]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.scale = nn.Parameter(torch.full((dim,), float(init)))
        self.init_fill = {"scale": float(init)}


class TransformerLayer(nn.Module):
    def __init__(self, t: TransformerConfig):
        super().__init__()
        d = t.d_model
        self.self_attn = holder(in_proj=Linear(d, 3 * d, bias=False),
                                out_proj=Linear(d, d, bias=False))
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.linear1 = Linear(d, t.dim_feedforward, bias=False)
        self.linear2 = Linear(t.dim_feedforward, d, bias=False)
        self.layer_scale_1 = LayerScale(d, t.layer_scale)
        self.layer_scale_2 = LayerScale(d, t.layer_scale)


def _resblock(dim: int, s: SeanetConfig) -> nn.Module:
    hidden = dim // s.compress
    return holder(block=nn.ModuleDict({
        "0": Conv1d(dim, hidden, s.residual_ksize),
        "1": Conv1d(hidden, dim, 1)}))


def _rvq(n: int, c: MimiConfig, decoder: bool) -> nn.Module:
    d, qd = c.seanet.dimension, c.quantizer_dim
    parts = {"input_proj": Conv1d(d, qd, 1, bias=False),
             "vq": holder(layers=nn.ModuleList(
                 holder(codebook=holder(embed=Embedding(c.quantizer_bins, qd)))
                 for _ in range(n)))}
    if decoder:
        parts["output_proj"] = Conv1d(qd, d, 1, bias=False)
    return holder(**parts)


class Mimi(TorchModel):
    """The Mimi codec on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`. `decoder=False` leaves
    out the decode path (decoder, its transformer, the frame-rate
    upsample, the quantizer's output projections)."""

    def __init__(self, config: Union[MimiConfig, dict, None] = None,
                 device="cuda", *, decoder: bool = True, **kwargs):
        device = check_device(device)
        if config is None:
            config = MimiConfig.from_dict(kwargs) if kwargs else MimiConfig()
        elif isinstance(config, dict):
            config = MimiConfig.from_dict(config)
        super().__init__(config)
        c, s, t = config, config.seanet, config.transformer
        enc_frame_rate = c.sample_rate / math.prod(s.ratios)
        self.downsample_stride = int(enc_frame_rate / c.frame_rate)
        self.samples_per_frame = int(math.prod(s.ratios)
                                     * self.downsample_stride)
        self.has_decoder = decoder
        top = s.nfilters * (1 << len(s.ratios))
        with torch.device(device):
            layers, mult = [], 1
            for ratio in reversed(s.ratios):
                dim = mult * s.nfilters
                layers.append(holder(
                    residuals=nn.ModuleList(_resblock(dim, s) for _ in
                                            range(s.nresidual_layers)),
                    downsample=holder(conv=Conv1d(dim, 2 * dim, 2 * ratio))))
                mult *= 2
            self.encoder = holder(
                init_conv1d=holder(conv=Conv1d(s.channels, s.nfilters,
                                               s.ksize)),
                layers=nn.ModuleList(layers),
                final_conv1d=holder(conv=Conv1d(top, s.dimension,
                                                s.last_ksize)))
            self.encoder_transformer = holder(transformer=holder(
                layers=nn.ModuleList(TransformerLayer(t)
                                     for _ in range(t.num_layers))))
            self.downsample = holder(conv=holder(conv=Conv1d(
                s.dimension, s.dimension, 2 * self.downsample_stride,
                bias=False)))
            self.quantizer = holder(rvq_first=_rvq(1, c, decoder),
                                    rvq_rest=_rvq(c.quantizer_nq - 1, c,
                                                  decoder))
            if decoder:
                layers, mult = [], top // s.nfilters
                for ratio in s.ratios:
                    dim = mult * s.nfilters
                    layers.append(holder(
                        upsample=holder(conv=ConvTranspose1d(
                            dim, dim // 2, 2 * ratio)),
                        residuals=nn.ModuleList(
                            _resblock(dim // 2, s)
                            for _ in range(s.nresidual_layers))))
                    mult //= 2
                self.decoder = holder(
                    init_conv1d=holder(conv=Conv1d(s.dimension, top,
                                                   s.ksize)),
                    layers=nn.ModuleList(layers),
                    final_conv1d=holder(conv=Conv1d(s.nfilters, s.channels,
                                                    s.last_ksize)))
                self.decoder_transformer = holder(transformer=holder(
                    layers=nn.ModuleList(TransformerLayer(t)
                                         for _ in range(t.num_layers))))
                self.upsample = holder(convtr=holder(convtr=ConvTranspose1d(
                    s.dimension, s.dimension, 2 * self.downsample_stride,
                    bias=False, groups=s.dimension)))
        self.register_buffer("inv_freq", rope_freqs(
            t.d_model // t.num_heads, t.max_period).to(device),
            persistent=False)
        self.requires_grad_(False)
        self.eval()

    @property
    def frame_rate(self):
        return self.config.frame_rate

    @property
    def sample_rate(self):
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.init_conv1d.conv.weight.dtype

    # -- transformer ---------------------------------------------------------

    def _transformer(self, tf: nn.Module, x: torch.Tensor,
                     caches: Optional[KVCache] = None, offset: int = 0
                     ) -> torch.Tensor:
        """x (B, T, D) through the layers; with `caches` (stacked, written
        in place at `offset`) each query attends to the keys of
        (offset + i - context, offset + i] in the cache."""
        t = self.config.transformer
        hd = t.d_model // t.num_heads
        b, tl, _ = x.shape
        dev = x.device
        pos = offset + torch.arange(tl, device=dev)
        cos, sin = rope_cos_sin(pos[None], self.inv_freq)
        q_pos = pos[:, None]
        k_pos = (torch.arange(offset + tl, device=dev) if caches is not None
                 else pos)[None, :]
        ok = (k_pos <= q_pos) & (k_pos > q_pos - t.context)
        mask = torch.zeros(ok.shape, device=dev).masked_fill(
            ~ok, float("-inf"))[None, None]
        for i, lp in enumerate(tf.layers):
            h = lp.norm1(x)
            q, k, v = lp.self_attn.in_proj(h).chunk(3, dim=-1)
            q = apply_rotary(q.reshape(b, tl, t.num_heads, hd), cos, sin)
            k = apply_rotary(k.reshape(b, tl, t.num_heads, hd), cos, sin)
            v = v.reshape(b, tl, t.num_heads, hd)
            if caches is not None:
                cache = kv_update(caches.layer(i), k, v, offset)
                k = cache.k[:, :offset + tl]
                v = cache.v[:, :offset + tl]
            out = attention(q, k, v, mask=mask).reshape(b, tl, t.d_model)
            x = x + lp.self_attn.out_proj(out) * lp.layer_scale_1.scale.to(
                x.dtype)
            h = lp.linear2(gelu(lp.linear1(lp.norm2(x))))
            x = x + h * lp.layer_scale_2.scale.to(x.dtype)
        return x

    # -- seanet --------------------------------------------------------------

    def _resblock(self, p: nn.Module, x: torch.Tensor, dilation: int,
                  buf: Optional[torch.Tensor] = None):
        s = self.config.seanet
        h = elu(x)
        if buf is None:
            h = _causal_conv(p.block["0"], h, s.residual_ksize,
                             dilation=dilation, pad_mode=s.pad_mode)
            h = _causal_conv(p.block["1"], elu(h), 1, pad_mode=s.pad_mode)
            return x + h, None
        h, buf = _conv_step(p.block["0"], h, buf, dilation=dilation)
        return x + p.block["1"](elu(h)), buf

    def _encode_latent(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T, 1) -> (B, frames at the encoder's rate, D)."""
        s = self.config.seanet
        p = self.encoder
        x = _causal_conv(p.init_conv1d.conv, audio, s.ksize,
                         pad_mode=s.pad_mode)
        for layer, ratio in zip(p.layers, reversed(s.ratios)):
            for ri, res in enumerate(layer.residuals):
                x, _ = self._resblock(res, x, s.dilation_base ** ri)
            x = _causal_conv(layer.downsample.conv, elu(x), ratio * 2,
                             stride=ratio, pad_mode=s.pad_mode)
        return _causal_conv(p.final_conv1d.conv, elu(x), s.last_ksize,
                            pad_mode=s.pad_mode)

    def _decode_latent(self, x: torch.Tensor) -> torch.Tensor:
        """(B, frames at the encoder's rate, D) -> audio (B, T, 1)."""
        s = self.config.seanet
        p = self.decoder
        x = _causal_conv(p.init_conv1d.conv, x, s.ksize, pad_mode=s.pad_mode)
        for layer, ratio in zip(p.layers, s.ratios):
            x = _causal_tconv(layer.upsample.conv, elu(x), ratio * 2, ratio)
            for ri, res in enumerate(layer.residuals):
                x, _ = self._resblock(res, x, s.dilation_base ** ri)
        return _causal_conv(p.final_conv1d.conv, elu(x), s.last_ksize,
                            pad_mode=s.pad_mode)

    # -- quantizer -----------------------------------------------------------

    @staticmethod
    def _rvq_encode(rp: nn.Module, x: torch.Tensor, n_q: int):
        residual = rp.input_proj(x)
        codes = []
        for i in range(n_q):
            cb = rp.vq.layers[i].codebook.embed.weight
            idx = vq_encode(residual, cb, normalized=False)
            codes.append(idx)
            residual = residual - F.embedding(idx, cb).to(residual.dtype)
        return codes

    @staticmethod
    def _rvq_decode(rp: nn.Module, codes: torch.Tensor) -> torch.Tensor:
        acc = None
        for i in range(codes.shape[1]):
            q = rp.vq.layers[i].codebook.embed(codes[:, i])
            acc = q if acc is None else acc + q
        return rp.output_proj(acc)

    def quantizer_encode(self, x: torch.Tensor) -> torch.Tensor:
        """Latents (B, T, D) -> codes (B, nq, T) int64."""
        q = self.quantizer
        codes = (self._rvq_encode(q.rvq_first, x, 1)
                 + self._rvq_encode(q.rvq_rest, x,
                                    self.config.quantizer_nq - 1))
        return torch.stack(codes, dim=1)

    def quantizer_decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Codes (B, n, T) (n <= nq) -> latents (B, T, D)."""
        q = self.quantizer
        out = self._rvq_decode(q.rvq_first, codes[:, :1])
        if codes.shape[1] > 1:
            out = out + self._rvq_decode(q.rvq_rest, codes[:, 1:])
        return out

    # -- public --------------------------------------------------------------

    def _audio(self, audio) -> torch.Tensor:
        """(B, 1, T) / (B, T) / (T,) audio -> (B, T, 1) on the device."""
        x = torch.as_tensor(np.asarray(audio, np.float32)
                            if not isinstance(audio, torch.Tensor) else audio)
        x = x.to(self.device, self.dtype)
        if x.ndim == 3:
            x = x[:, 0]
        elif x.ndim == 1:
            x = x[None]
        return x[..., None]

    def _latent(self, audio) -> torch.Tensor:
        x = self._encode_latent(self._audio(audio))
        x = self._transformer(self.encoder_transformer.transformer, x)
        return _causal_conv(self.downsample.conv.conv, x,
                            2 * self.downsample_stride,
                            stride=self.downsample_stride, pad_mode="edge")

    @torch.inference_mode()
    def encode(self, audio) -> torch.Tensor:
        """audio (B, 1, T) / (B, T) / (T,) -> codes (B, nq, frames) int64."""
        with exact_f32():
            return self.quantizer_encode(self._latent(audio))

    @torch.inference_mode()
    def encode_to_latent(self, audio) -> torch.Tensor:
        """audio -> the pre-quantizer latents (B, frames, D)."""
        with exact_f32():
            return self._latent(audio)

    def _need_decoder(self):
        if not self.has_decoder:
            raise ValueError("this Mimi was built with decoder=False")

    @torch.inference_mode()
    def decode(self, codes) -> torch.Tensor:
        """codes (B, n, T) -> audio (B, 1, T * samples_per_frame)."""
        self._need_decoder()
        codes = torch.as_tensor(np.asarray(codes) if not isinstance(
            codes, torch.Tensor) else codes).to(self.device, torch.long)
        x = self.quantizer_decode(codes)
        x = _causal_tconv(self.upsample.convtr.convtr, x,
                          2 * self.downsample_stride, self.downsample_stride)
        x = self._transformer(self.decoder_transformer.transformer, x)
        return self._decode_latent(x).transpose(1, 2)

    # -- streaming decode ----------------------------------------------------

    def init_decode_stream_state(self, batch: int = 1,
                                 max_frames: int = 2048) -> dict:
        """A fresh streaming-decode state: conv pasts, transposed-conv
        overflows, the decoder transformer's KV cache of `max_frames`
        frames at the upsampled rate, and the host-int offset."""
        self._need_decoder()
        s, t = self.config.seanet, self.config.transformer
        dev, dt = self.device, self.dtype

        def z(n: int, c: int) -> torch.Tensor:
            return torch.zeros(batch, n, c, device=dev, dtype=dt)

        layers, mult = [], 1 << len(s.ratios)
        for layer, ratio in zip(self.decoder.layers, s.ratios):
            dim = mult * s.nfilters
            # the overflow less the bias is added to the next chunk: a
            # fresh stream carries the bias, so nothing is taken off
            layers.append({"up_overflow": z(ratio, dim // 2)
                           + layer.upsample.conv.bias.to(dt), "res": [
                z((s.residual_ksize - 1) * s.dilation_base ** ri, dim // 2)
                for ri in range(s.nresidual_layers)]})
            mult //= 2
        return {
            "offset": 0,
            "up_overflow": z(self.downsample_stride, s.dimension),
            "tf_caches": KVCache.init(batch, max_frames, t.num_heads,
                                      t.d_model // t.num_heads, dt, dev,
                                      n_layers=t.num_layers),
            "dec": {"init_buf": z(s.ksize - 1, s.dimension), "layers": layers,
                    "final_buf": z(s.last_ksize - 1, s.nfilters)},
        }

    @torch.inference_mode()
    def decode_step(self, state: dict, codes) -> Tuple[dict, torch.Tensor]:
        """Streaming decode of codes (B, n, T_new) -> (state, audio (B, 1,
        T_new * samples_per_frame)); the chunks' audio joined is `decode`'s."""
        codes = torch.as_tensor(np.asarray(codes) if not isinstance(
            codes, torch.Tensor) else codes).to(self.device, torch.long)
        return self.decode_latent_step(state, self.quantizer_decode(codes))

    @torch.inference_mode()
    def decode_latent_step(self, state: dict, x: torch.Tensor
                           ) -> Tuple[dict, torch.Tensor]:
        """Streaming decode of latent frames (B, T_new, D): upsample,
        transformer, SEANet decoder. The caches are written in place; the
        returned state holds the new buffers."""
        self._need_decoder()
        s = self.config.seanet
        ds = self.downsample_stride
        ns: Dict = {"dec": {"layers": []}}
        x, ns["up_overflow"] = _tconv_step(
            self.upsample.convtr.convtr, x, state["up_overflow"], 2 * ds, ds)
        offset = state["offset"]
        if offset + x.shape[1] > state["tf_caches"].k.shape[2]:
            raise ValueError(
                f"the stream's transformer cache holds "
                f"{state['tf_caches'].k.shape[2]} frames; {offset} are "
                f"written and this chunk adds {x.shape[1]}")
        x = self._transformer(self.decoder_transformer.transformer, x,
                              caches=state["tf_caches"], offset=offset)
        ns["tf_caches"] = state["tf_caches"]
        ns["offset"] = offset + x.shape[1]
        p = self.decoder
        x, ns["dec"]["init_buf"] = _conv_step(p.init_conv1d.conv, x,
                                              state["dec"]["init_buf"])
        for layer, ratio, st in zip(p.layers, s.ratios,
                                    state["dec"]["layers"]):
            x, over = _tconv_step(layer.upsample.conv, elu(x),
                                  st["up_overflow"], ratio * 2, ratio)
            bufs = []
            for ri, res in enumerate(layer.residuals):
                x, b = self._resblock(res, x, s.dilation_base ** ri,
                                      st["res"][ri])
                bufs.append(b)
            ns["dec"]["layers"].append({"up_overflow": over, "res": bufs})
        x, ns["dec"]["final_buf"] = _conv_step(
            p.final_conv1d.conv, elu(x), state["dec"]["final_buf"])
        return ns, x.transpose(1, 2)

    # -- weights -------------------------------------------------------------

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict:
        """`sanitize_mimi` at this model's config: kyutai or HF mimi names
        onto this tree (the decode path's dropped without a decoder)."""
        return sanitize_mimi(weights, self.config.seanet, self.has_decoder)

    @classmethod
    def from_pretrained(cls, path: Union[str, Path], device="cuda",
                        **kwargs) -> "Mimi":
        """A local directory of config.json and weights (safetensors or
        npz) through `sanitize`; never downloaded."""
        from ....utils import load_config, load_weights

        device = check_device(device)
        path = Path(path).expanduser()
        if not path.is_dir():
            raise FileNotFoundError(f"Local model path not found: {path}")
        config = load_config(path)
        config["model_path"] = str(path)
        model = cls(MimiConfig.from_dict(config), device=device, **kwargs)
        return model.bind(model.sanitize(load_weights(path)))


# ---------------------------------------------------------------------------
# checkpoint names
# ---------------------------------------------------------------------------


def remap_hf(weights: Dict[str, np.ndarray], s: SeanetConfig) -> Dict:
    """HF-transformers `MimiModel` keys (the kyutai/mimi hub repo) -> the
    Mimi tree's names: HF flattens the SEANet blocks and ELUs into one
    indexed list, whose index maps are rebuilt from the SEANet config; q,
    k, v are fused into in_proj; the split-RVQ prefixes are renamed."""
    import re

    n_r, nres = len(s.ratios), s.nresidual_layers
    enc, dec = ({0: "encoder.init_conv1d.conv"},
                {0: "decoder.init_conv1d.conv"})
    res_enc, res_dec = {}, {}
    idx = 1
    for g in range(n_r):
        for j in range(nres):
            res_enc[idx] = f"encoder.layers.{g}.residuals.{j}"
            idx += 1
        idx += 1  # ELU
        enc[idx] = f"encoder.layers.{g}.downsample.conv"
        idx += 1
    enc[idx + 1] = "encoder.final_conv1d.conv"
    idx = 1
    for g in range(n_r):
        idx += 1  # ELU
        dec[idx] = f"decoder.layers.{g}.upsample.conv"
        idx += 1
        for j in range(nres):
            res_dec[idx] = f"decoder.layers.{g}.residuals.{j}"
            idx += 1
    dec[idx + 1] = "decoder.final_conv1d.conv"
    ren = {
        "input_layernorm.weight": "norm1.weight",
        "input_layernorm.bias": "norm1.bias",
        "post_attention_layernorm.weight": "norm2.weight",
        "post_attention_layernorm.bias": "norm2.bias",
        "mlp.fc1.weight": "linear1.weight",
        "mlp.fc2.weight": "linear2.weight",
        "self_attn_layer_scale.scale": "layer_scale_1.scale",
        "mlp_layer_scale.scale": "layer_scale_2.scale",
        "self_attn.o_proj.weight": "self_attn.out_proj.weight",
    }
    out, qkv = {}, {}
    for k, w in weights.items():
        m = re.match(r"^(encoder|decoder)\.layers\.(\d+)\."
                     r"(?:block\.(\d+)\.)?conv\.(weight|bias)$", k)
        if m:
            side, i, b, leaf = (m.group(1), int(m.group(2)), m.group(3),
                                m.group(4))
            if b is not None:   # a resnet block: HF 1/3 -> ours 0/1
                base = (res_enc if side == "encoder" else res_dec)[i]
                out[f"{base}.block.{0 if int(b) == 1 else 1}.{leaf}"] = w
            else:
                base = (enc if side == "encoder" else dec)[i]
                out[f"{base}.{leaf}"] = w
            continue
        m = re.match(r"^(encoder|decoder)_transformer\.layers\.(\d+)\.(.+)$",
                     k)
        if m:
            pre = f"{m.group(1)}_transformer.transformer.layers.{m.group(2)}"
            rest = m.group(3)
            if rest in ren:
                out[f"{pre}.{ren[rest]}"] = w
                continue
            m2 = re.match(r"^self_attn\.([qkv])_proj\.weight$", rest)
            if m2:
                qkv.setdefault(pre, {})[m2.group(1)] = np.asarray(w)
                continue
        if k.startswith("quantizer.semantic_residual_vector_quantizer."):
            out["quantizer.rvq_first." + k.split(".", 2)[2].replace(
                "layers.", "vq.layers.", 1)] = w
            continue
        if k.startswith("quantizer.acoustic_residual_vector_quantizer."):
            out["quantizer.rvq_rest." + k.split(".", 2)[2].replace(
                "layers.", "vq.layers.", 1)] = w
            continue
        if k == "downsample.conv.weight":
            out["downsample.conv.conv.weight"] = w
            continue
        if k == "upsample.conv.weight":
            out["upsample.convtr.convtr.weight"] = w
            continue
        out[k] = w
    for pre, d in qkv.items():
        if not d["q"].shape == d["k"].shape == d["v"].shape:
            raise ValueError(
                "mimi: GQA checkpoints (num_key_value_heads != "
                "num_attention_heads) are not supported; got q/k/v "
                f"shapes {d['q'].shape}/{d['k'].shape}/{d['v'].shape}")
        out[f"{pre}.self_attn.in_proj.weight"] = np.concatenate(
            [d["q"], d["k"], d["v"]], axis=0)
    return out


def sanitize_mimi(weights: Dict[str, np.ndarray], s: SeanetConfig,
                  decoder: bool = True) -> Dict[str, np.ndarray]:
    """Map kyutai or HF mimi checkpoints onto the Mimi tree's names (HF's
    through `remap_hf`): leading underscores stripped from each name
    segment, codebooks rebuilt from cluster_usage / embedding_sum
    (embed_sum), the `initialized` flags dropped. Conv kernels keep torch's
    layouts, which are the port's; without a decoder, the decode path's
    weights (and the quantizer's output projections) are dropped."""
    if any(".self_attn.q_proj." in k or k.startswith(
            "quantizer.semantic_residual_vector_quantizer.")
           for k in weights):
        weights = remap_hf(weights, s)
    out, codebooks = {}, {}
    for k, w in weights.items():
        k = ".".join(seg.lstrip("_") for seg in k.split("."))
        if ("codebook.cluster_usage" in k or "codebook.embed_sum" in k
                or "codebook.embedding_sum" in k):
            base = k.split(".codebook.")[0]
            codebooks.setdefault(base, {})[
                "usage" if "cluster_usage" in k else "sum"] = \
                np.asarray(w, np.float32)
            continue
        if "codebook.initialized" in k:
            continue
        out[k] = np.asarray(w)
    for base, d in codebooks.items():
        if "usage" in d and "sum" in d:
            out[f"{base}.codebook.embed.weight"] = d["sum"] / np.clip(
                d["usage"][:, None], 1e-5, None)
    if not decoder:
        out = {k: v for k, v in out.items() if not k.startswith((
            "decoder.", "decoder_transformer.", "upsample."))
            and ".output_proj." not in k}
    return out


Model = Mimi

__all__ = ["Mimi", "MimiConfig", "Model", "ModelConfig", "mimi_202407",
           "exact_f32", "remap_hf", "sanitize_mimi"]
