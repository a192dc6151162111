"""MossFormer2-SE 48K: mask-based speech enhancement over a Kaldi fbank.

Counterpart of mlx_audio_tpu/sts/models/mossformer2_se/mossformer2_se.py:

* the primitives (:71-130): scale norm, group norm over (T, C), layer
  norm at eps 1e-8, PReLU, the depthwise-17 conv, FFConvM;
* the partial RoPE over 32 dims (:132-146), the FLASH block with groups
  of 256 (grouped ReLU^2 attention plus global linear attention, token
  shift; :148-218), the UniDeep and gated FSMN blocks (:220-266), the
  masknet (:269-340);
* the chunk function (:387-438): fbank with two orders of deltas, the
  mask, the STFT (center=False) masked and the port's `dsp.ISTFTCache`;
  `_decode_one_audio`'s sliding 4-s windows past 20 s (:460-490),
  `_decode_chunked` past 60 s (:492-524), `generate` returning a dict
  (:530-535), `sanitize` (:342-365).

The fbank dithers, as JAX's does with `PRNGKey(0)` for each chunk: the
draws come from `self._noise(shape)`, by default standard normal from a
CPU `torch.Generator` seeded 0 for each chunk, moved to the model's
device, so one input gives one output on every device; tests hand in
JAX's draws through it.

Departures from the JAX package: the STFT's windowed frames and DFT run
in float64 (`dsp.stft`) where JAX's run in f32; `sanitize` reads each
conv weight's layout from the model's own shapes, where JAX's takes a
3-D weight with a last axis of 1 for a torch 1x1 conv.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .... import dsp
from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Conv1d, Conv2d, LayerNorm, Linear

MAX_WAV_VALUE = 32768.0


@dataclass
class MossFormer2SEConfig(BaseModelArgs):
    model_type: str = "mossformer2_se"
    sample_rate: int = 48000
    win_len: int = 1920
    win_inc: int = 384
    fft_len: int = 1920
    win_type: str = "hamming"
    num_mels: int = 60
    preemphasis: float = 0.97
    one_time_decode_length: int = 20
    decode_window: int = 4
    chunk_seconds: float = 4.0
    chunk_overlap: float = 0.25
    auto_chunk_threshold: float = 60.0
    in_channels: int = 180
    out_channels: int = 512
    out_channels_final: int = 961
    num_blocks: int = 24
    group_size: int = 256
    query_key_dim: int = 128
    fsmn_inner: int = 256
    fsmn_lorder: int = 20
    model_path: Optional[str] = None

    @property
    def sampling_rate(self) -> int:
        return self.sample_rate


class Leaves(nn.Module):
    """Raw leaves of the JAX tree, each filled with a constant at init
    (`init_fill`)."""

    def __init__(self, **leaves):
        super().__init__()
        self.init_fill = {}
        for name, (shape, value) in leaves.items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))
            self.init_fill[name] = value


def _layer_norm(m: LayerNorm, x: torch.Tensor, eps: float = 1e-8):
    return F.layer_norm(x, (x.shape[-1],), m.weight.to(x.dtype),
                        m.bias.to(x.dtype), eps)


def _prelu(m: Leaves, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, m.weight.to(x.dtype) * x)


def _rope_partial(x: torch.Tensor, dims: int = 32,
                  base: float = 10000.0) -> torch.Tensor:
    """NeoX-style rotation of the first `dims` features (x (B, T, D))."""
    t = x.shape[1]
    half = dims // 2
    inv = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[None].to(x.dtype), torch.sin(ang)[None].to(
        x.dtype)
    x1, x2 = x[..., :half], x[..., half:dims]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      x[..., dims:]], dim=-1)


class FFConvM(nn.Module):
    """Norm (scale, or layer at eps 1e-5), linear, SiLU, plus its depthwise
    conv of kernel 17."""

    def __init__(self, dim_in: int, dim_out: int, norm: str = "scale"):
        super().__init__()
        self.linear = Linear(dim_in, dim_out)
        self.conv_module = Conv1d(dim_out, dim_out, 17, bias=False,
                                  groups=dim_out)
        self.norm = (Leaves(g=((1,), 1.0)) if norm == "scale"
                     else LayerNorm(dim_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.norm, Leaves):
            norm = x.norm(dim=-1, keepdim=True) * (x.shape[-1] ** -0.5)
            h = x * (self.norm.g.to(x.dtype) / norm.clamp(min=1e-8))
        else:
            h = _layer_norm(self.norm, x, 1e-5)
        h = F.silu(self.linear(h))
        return h + self.conv_module(h, padding=8)


class FlashBlock(nn.Module):
    """FLASH shared dual attention."""

    def __init__(self, dim: int, qk_dim: int, group_size: int,
                 expansion: float = 4.0):
        super().__init__()
        self.group_size = group_size
        self.to_hidden = FFConvM(dim, int(dim * expansion))
        self.to_qk = FFConvM(dim, qk_dim)
        self.qk_offset_scale = Leaves(gamma=((4, qk_dim), 1.0),
                                      beta=((4, qk_dim), 0.0))
        self.to_out = FFConvM(dim * 2, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        x_shift, x_pass = x.chunk(2, dim=-1)
        x_shift = F.pad(x_shift, (0, 0, 1, 0))[:, :-1]
        normed = torch.cat([x_shift, x_pass], dim=-1)
        v, u = self.to_hidden(normed).chunk(2, dim=-1)
        qk = self.to_qk(normed)
        os_ = self.qk_offset_scale
        heads = qk[..., None, :] * os_.gamma.to(x.dtype) + os_.beta.to(
            x.dtype)
        quad_q, lin_q, quad_k, lin_k = (_rope_partial(heads[..., i, :])
                                        for i in range(4))
        g = self.group_size
        padding = (g - n % g) % g
        if padding:
            quad_q, quad_k, lin_q, lin_k, v, u = (
                F.pad(t, (0, 0, 0, padding))
                for t in (quad_q, quad_k, lin_q, lin_k, v, u))
        ng = quad_q.shape[1] // g

        def grp(t):
            return t.reshape(b, ng, g, t.shape[-1])

        qq, qk_, vg, ug = map(grp, (quad_q, quad_k, v, u))
        attn = torch.square(F.relu(qq @ qk_.transpose(-1, -2) / g))
        quad_v, quad_u = attn @ vg, attn @ ug
        lin_kv = lin_k.transpose(1, 2) @ v / n
        lin_ku = lin_k.transpose(1, 2) @ u / n
        lin_v = (lin_q @ lin_kv).reshape(vg.shape)
        lin_u = (lin_q @ lin_ku).reshape(ug.shape)
        att_v = (quad_v + lin_v).reshape(b, -1, v.shape[-1])[:, :n]
        att_u = (quad_u + lin_u).reshape(b, -1, u.shape[-1])[:, :n]
        out = (att_u * v[:, :n]) * torch.sigmoid(att_v * u[:, :n])
        return x + self.to_out(out)


class UniDeepFsmn(nn.Module):
    def __init__(self, inner: int, lorder: int):
        super().__init__()
        self.lorder = lorder
        self.linear = Linear(inner, inner)
        self.project = Linear(inner, inner, bias=False)
        self.conv1 = Conv2d(inner, inner, (2 * lorder - 1, 1), bias=False,
                            groups=inner)
        self.conv1.init_fill = {"weight": 0.0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.project(F.relu(self.linear(x)))
        pad = self.lorder - 1
        y = F.pad(p1.transpose(1, 2)[..., None], (0, 0, pad, pad))
        out = self.conv1(y)[..., 0].transpose(1, 2)
        return x + p1 + out


class GatedFsmnBlock(nn.Module):
    def __init__(self, dim: int, inner: int, lorder: int):
        super().__init__()
        self.conv1 = Linear(dim, inner)
        self.prelu = Leaves(weight=((1,), 0.25))
        self.norm1 = LayerNorm(inner)
        self.norm2 = LayerNorm(inner)
        self.gated_fsmn = holder(to_u=FFConvM(inner, inner, "ln"),
                                 to_v=FFConvM(inner, inner, "ln"),
                                 fsmn=UniDeepFsmn(inner, lorder))
        self.conv2 = Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(self.norm1, _prelu(self.prelu, self.conv1(x)))
        g = self.gated_fsmn
        x_u = g.fsmn(g.to_u(h))
        h = _layer_norm(self.norm2, g.to_v(h) * x_u + h)
        return self.conv2(h) + x


def add_masknet(self: nn.Module, c: MossFormer2SEConfig) -> None:
    """The masknet's modules (init_masknet's tree) on `self`, at its
    root, as the JAX tree holds them."""
    self.norm = Leaves(weight=((c.in_channels, 1), 1.0),
                       bias=((c.in_channels, 1), 0.0))
    self.conv1d_encoder = Linear(c.in_channels, c.out_channels,
                                 bias=False)
    self.pos_enc = Leaves(scale=((1,), 1.0))
    mossformer = holder(
        layers=nn.ModuleList(FlashBlock(c.out_channels, c.query_key_dim,
                                        c.group_size)
                             for _ in range(c.num_blocks)),
        fsmn=nn.ModuleList(GatedFsmnBlock(c.out_channels, c.fsmn_inner,
                                          c.fsmn_lorder)
                           for _ in range(c.num_blocks)))
    self.mdl = holder(
        intra_mdl=holder(mossformerM=mossformer,
                         norm=LayerNorm(c.out_channels)),
        intra_norm=LayerNorm(c.out_channels))
    self.conv1d_out = Linear(c.out_channels, c.out_channels * 2)
    self.conv1_decoder = Linear(c.out_channels, c.out_channels_final,
                                bias=False)
    self.prelu = Leaves(weight=((1,), 0.25))
    self.output = Linear(c.out_channels, c.out_channels)
    self.output_gate = Linear(c.out_channels, c.out_channels)


def masknet_forward(self: nn.Module, feats: torch.Tensor) -> torch.Tensor:
    """features (B, T, in_channels) -> the first speaker's mask (B, T,
    out_channels_final), over the modules `add_masknet` put on `self`."""
    b, t, _ = feats.shape
    mean = feats.mean(dim=(1, 2), keepdim=True)
    var = (feats - mean).square().mean(dim=(1, 2), keepdim=True)
    x = (feats - mean) * torch.rsqrt(var + 1e-8)
    x = x * self.norm.weight.reshape(1, 1, -1).to(x.dtype) \
        + self.norm.bias.reshape(1, 1, -1).to(x.dtype)
    x = self.conv1d_encoder(x)
    d = x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) \
        * self.pos_enc.scale.float()
    x = x + pe[None].to(x.dtype)
    m = self.mdl.intra_mdl.mossformerM
    h = x
    for flash, fsmn in zip(m.layers, m.fsmn):
        h = fsmn(flash(h))
    h = _layer_norm(self.mdl.intra_mdl.norm, h)
    gn = self.mdl.intra_norm
    mean = h.mean(dim=(1, 2), keepdim=True)
    var = (h - mean).square().mean(dim=(1, 2), keepdim=True)
    h = (h - mean) * torch.rsqrt(var + 1e-8) * gn.weight.to(h.dtype) \
        + gn.bias.to(h.dtype)
    x = self.conv1d_out(_prelu(self.prelu, h + x))
    x = x.reshape(b, t, 2, -1)[:, :, 0]        # the first speaker
    gated = torch.tanh(self.output(x)) * torch.sigmoid(
        self.output_gate(x))
    return F.relu(self.conv1_decoder(gated))


# ------------------------------------------------------------------ model

class Model(TorchModel):
    """MossFormer2-SE on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`. Its weights are the
    JAX tree's masknet, at the root (`add_masknet`)."""

    def __init__(self, config=None, device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = MossFormer2SEConfig.from_dict(kwargs) if kwargs else \
                MossFormer2SEConfig()
        elif isinstance(config, dict):
            config = MossFormer2SEConfig.from_dict(config)
        super().__init__(config)
        with torch.device(device):
            add_masknet(self, config)
        self._istft = dsp.ISTFTCache()
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    def _noise(self, shape) -> torch.Tensor:
        """The fbank's dither draws for one chunk (JAX: normal(PRNGKey(0),
        shape) for every chunk)."""
        return torch.randn(shape, generator=torch.Generator().manual_seed(0))

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1d_encoder.weight.dtype

    # ---------------------------------------------------------- chunks

    @torch.inference_mode()
    def mask(self, audio: torch.Tensor) -> torch.Tensor:
        """A chunk at int16 scale (T,) on the device -> its mask (frames,
        out_channels_final) f32: fbank (dithered by `_noise`) with two
        orders of deltas through the masknet."""
        c = self.config
        frames = dsp._get_strided_kaldi(audio, c.win_len, c.win_inc, True)
        fb = dsp.compute_fbank_kaldi(
            audio, sample_rate=c.sample_rate, win_len=c.win_len,
            win_inc=c.win_inc, num_mels=c.num_mels, win_type=c.win_type,
            preemphasis=c.preemphasis,
            noise=self._noise(tuple(frames.shape)))
        d1 = dsp.compute_deltas_kaldi(fb.T, win_length=5).T
        d2 = dsp.compute_deltas_kaldi(d1.T, win_length=5).T
        feats = torch.cat([fb, d1, d2], dim=1)[None]
        return masknet_forward(self, feats.to(self.dtype))[0].float()

    @torch.inference_mode()
    def _process_chunk(self, audio: np.ndarray,
                       chunk_length: int) -> np.ndarray:
        c = self.config
        # pad so that center=False framing covers every sample
        n = len(audio)
        pad = c.win_len - n if n < c.win_len else (-(n - c.win_len)) \
            % c.win_inc
        x = torch.as_tensor(np.pad(np.asarray(audio, np.float32), (0, pad)),
                            device=self.device)
        mask = self.mask(x)
        window = dsp.hamming(c.win_len, periodic=False)
        spec = dsp.stft(x, n_fft=c.fft_len, hop_length=c.win_inc,
                        win_length=c.win_len, window=window, center=False)
        m = mask[:spec.shape[0]]
        if m.shape[0] < spec.shape[0]:
            m = F.pad(m, (0, 0, 0, spec.shape[0] - m.shape[0]))
        masked = spec * m[:, :spec.shape[1]]
        out = self._istft.istft(masked.real.T[None], masked.imag.T[None],
                                c.fft_len, c.win_inc, c.win_len, window,
                                center=False, audio_length=chunk_length)
        self.last_run["chunks"] = self.last_run.get("chunks", 0) + 1
        return out[0].cpu().numpy()

    # --------------------------------------------------------- enhance

    def enhance(self, audio_input, chunked: Optional[bool] = None
                ) -> np.ndarray:
        c = self.config
        if isinstance(audio_input, str):
            from ....utils import load_audio

            audio = np.asarray(load_audio(audio_input, c.sample_rate))
        else:
            audio = np.asarray(audio_input, np.float32)
        if audio.ndim == 2:
            audio = audio[0] if audio.shape[0] <= audio.shape[1] \
                else audio[:, 0]
        self.last_run = {"chunks": 0}
        duration = len(audio) / c.sample_rate
        use_chunked = chunked if chunked is not None else \
            duration >= c.auto_chunk_threshold
        if use_chunked:
            return self._decode_chunked(audio)
        return self._decode_one_audio(audio)

    def _decode_one_audio(self, audio: np.ndarray) -> np.ndarray:
        c = self.config
        original_len = len(audio)
        x = audio * MAX_WAV_VALUE
        if original_len > c.sample_rate * c.one_time_decode_length:
            window_size = int(c.sample_rate * c.decode_window)
            stride = int(window_size * 0.75)
            t = len(x)
            if t < window_size:
                x = np.pad(x, (0, window_size - t))
            elif t < window_size + stride:
                x = np.pad(x, (0, window_size + stride - t))
            elif (t - window_size) % stride != 0:
                x = np.pad(x, (0, t - (t - window_size) // stride
                               * stride))
            t = len(x)
            out = np.zeros(t)
            give_up = (window_size - stride) // 2
            idx = 0
            while idx + window_size <= t:
                seg = self._process_chunk(x[idx:idx + window_size],
                                          window_size)
                if idx == 0:
                    out[:window_size - give_up] = seg[:-give_up]
                else:
                    out[idx + give_up:idx + window_size - give_up] = \
                        seg[give_up:-give_up]
                idx += stride
            return out[:original_len] / MAX_WAV_VALUE
        out = self._process_chunk(x, len(x))
        return np.asarray(out) / MAX_WAV_VALUE

    def _decode_chunked(self, audio: np.ndarray) -> np.ndarray:
        c = self.config
        original_len = len(audio)
        x = audio * MAX_WAV_VALUE
        chunk_samples = int(c.sample_rate * c.chunk_seconds)
        overlap = int(chunk_samples * c.chunk_overlap)
        stride = chunk_samples - overlap
        give_up = overlap // 2
        if original_len <= chunk_samples:
            return self._process_chunk(x, original_len) / MAX_WAV_VALUE
        chunks, starts = [], []
        idx = 0
        while idx + chunk_samples <= original_len:
            chunks.append(self._process_chunk(x[idx:idx + chunk_samples],
                                              chunk_samples))
            starts.append(idx)
            idx += stride
        if idx < original_len:
            chunks.append(self._process_chunk(x[idx:],
                                              original_len - idx))
            starts.append(idx)
        out = np.zeros(original_len)
        for i, (chunk, start) in enumerate(zip(chunks, starts)):
            first, last = i == 0, i == len(chunks) - 1
            ks = 0 if first else give_up
            if last and len(chunk) < chunk_samples:
                ke = len(chunk)
            else:
                ke = len(chunk) - give_up
            os_, oe = start + ks, min(start + ke, original_len)
            out[os_:oe] = chunk[ks:ks + (oe - os_)]
        return out / MAX_WAV_VALUE

    def __call__(self, audio, **kwargs):
        return self.enhance(audio, **kwargs)

    def generate(self, audio, **kwargs):
        t0 = time.perf_counter()
        out = self.enhance(audio, **kwargs)
        return {"audio": out, "sample_rate": self.config.sample_rate,
                "processing_time_seconds": time.perf_counter() - t0}

    # --------------------------------------------------------- loading

    def sanitize(self, weights) -> Dict[str, np.ndarray]:
        """The checkpoint's `model.model.mossformer.` (or shorter) prefix
        dropped; 1x1 convs to linears (out, in); the FSMN memory convs to
        HWIO and the FFConvM depthwise convs to WIO, each read from the
        layout its shape shows against this model's."""
        shapes = self.state_dict()
        shapes = {k: tuple(v.shape) for k, v in shapes.items()}
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            for prefix in ("model.model.mossformer.", "model.mossformer.",
                           "mossformer."):
                if k.startswith(prefix):
                    k = k[len(prefix):]
                    break
            want = shapes.get(k)
            if want is not None and len(want) == 2 and v.ndim == 3 \
                    and v.shape[-1] == 1:
                v = v[..., 0]                     # a 1x1 conv's (O, I, 1)
            if k.endswith("gated_fsmn.fsmn.conv1.weight") and v.ndim == 4:
                o, i, kh, kw = want
                if v.shape == (o, i, kh, kw):     # torch (C, 1, K, 1)
                    v = np.transpose(v, (2, 3, 1, 0))
                elif v.shape == (o, kh, kw, i):   # MLX (C, K, 1, 1)
                    v = np.transpose(v, (1, 2, 3, 0))
            out[k] = v
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3
                            and k.endswith("conv_module.weight"))


MossFormer2SEModel = Model

__all__ = ["Model", "MossFormer2SEModel", "MossFormer2SEConfig",
           "add_masknet", "masknet_forward",
           "FlashBlock", "GatedFsmnBlock"]
