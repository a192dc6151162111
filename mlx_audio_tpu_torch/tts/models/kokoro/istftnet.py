"""Kokoro ISTFTNet decoder (channel-last, mask-aware).

Counterpart of mlx_audio_tpu/tts/models/kokoro/istftnet.py. Every op keeps
the JAX package's validity masks, so a bucket-padded run gives the same
samples in the valid region as a tight one.

The generator's residual legs (AdaIN -> snake -> dilated conv) go through
`ops.snake_conv.adain_snake_conv1d`: the hand-written CUDA kernel K1 for a
CUDA tensor, its plain PyTorch version for a CPU tensor. K1's operands
(the weight in its path's layout, alpha and bias in f32) are made once per
weight load (`AdaINResBlock1.pack_kernel_weights`), not per call. The instance-norm
statistics stay a plain torch reduction (`_masked_stats`) and are folded
into the leg's scale/shift, as in the JAX package's fused path.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....dsp import (_pad_center, _window_envelope_np, _window_np,
                     frame_signal, irfft_pair, overlap_add, rdft_pair)
from ....nn import Conv1d, ConvTranspose1d, Linear, leaky_relu
from ....ops.interpolate import interpolate1d
from ....ops.snake_conv import (adain_snake_conv1d, choose_path, fold_adain,
                                kernel_weight)


def fold_weight_norm(g, v) -> np.ndarray:
    """w = g * v / ||v||, norm over all dims except 0 (torch weight_norm)."""
    g = np.asarray(g, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# Masked instance norm + AdaIN
# ---------------------------------------------------------------------------


def _mask(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return x
    return torch.where(valid[..., None], x, 0.0)


def _masked_stats(x: torch.Tensor, valid: Optional[torch.Tensor]):
    """Per-(batch, channel) time-axis mean and (biased) variance in f32,
    two-pass, over the valid rows."""
    xf = x.float()
    if valid is None:
        return xf.mean(-2), xf.var(-2, correction=0)
    m = valid[..., None].float()
    count = m.sum(-2).clamp(min=1.0)
    mean = (xf * m).sum(-2) / count
    var = (((xf - mean[..., None, :]) ** 2) * m).sum(-2) / count
    return mean, var


def instance_norm(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """IN over the time axis of (B, T, C), statistics in f32."""
    mean, var = _masked_stats(x, valid)
    xf = x.float()
    return ((xf - mean[..., None, :]) * torch.rsqrt(var[..., None, :] + eps)
            ).to(x.dtype)


class AdaIN(nn.Module):
    def __init__(self, style_dim: int, num_features: int):
        super().__init__()
        self.fc = Linear(style_dim, num_features * 2)

    def affine(self, s: torch.Tensor):
        """(gamma, beta), each (B, C)."""
        return self.fc(s).chunk(2, dim=-1)

    def forward(self, x, s, valid=None):
        gamma, beta = self.affine(s)
        return (1 + gamma[:, None, :]) * instance_norm(x, valid) + beta[:, None, :]


# ---------------------------------------------------------------------------
# AdainResBlk1d (prosody/decoder residual block, optional 2x upsample)
# ---------------------------------------------------------------------------


class AdainResBlk1d(nn.Module):
    """(B, T, Cin) -> (B, T[*2 if upsample], Cout); istftnet.py:132-168."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int,
                 upsample: bool = False):
        super().__init__()
        self.conv1 = Conv1d(dim_in, dim_out, 3)
        self.conv2 = Conv1d(dim_out, dim_out, 3)
        self.norm1 = AdaIN(style_dim, dim_in)
        self.norm2 = AdaIN(style_dim, dim_out)
        if dim_in != dim_out:
            self.conv1x1 = Conv1d(dim_in, dim_out, 1, bias=False)
        self.upsample = upsample
        if upsample:
            self.pool = ConvTranspose1d(dim_in, dim_in, 3, groups=dim_in)

    def forward(self, x, s, valid=None):
        up_valid = None
        if valid is not None and self.upsample:
            up_valid = valid.repeat_interleave(2, dim=-1)
        out_valid = up_valid if self.upsample else valid

        h = leaky_relu(self.norm1(x, s, valid), 0.2)
        h = _mask(h, valid)
        if self.upsample:
            # depthwise transposed conv stride 2 (k=3, p=1), left-pad 1 frame
            h = self.pool(h, stride=2, padding=1)
            h = F.pad(h, (0, 0, 1, 0))
            h = _mask(h, up_valid)
        h = self.conv1(h, padding=1)
        h = leaky_relu(self.norm2(h, s, out_valid), 0.2)
        h = _mask(h, out_valid)
        h = _mask(self.conv2(h, padding=1), out_valid)

        sc = x.repeat_interleave(2, dim=-2) if self.upsample else x
        if hasattr(self, "conv1x1"):
            sc = self.conv1x1(sc)
        sc = _mask(sc, out_valid)
        return (h + sc) / math.sqrt(2)


# ---------------------------------------------------------------------------
# AdaINResBlock1 (generator snake resblock): the kernel's caller
# ---------------------------------------------------------------------------


class AdaINResBlock1(nn.Module):
    """Snake-activated AdaIN residual block (istftnet.py:225-262).

    Each of its 2*len(dilations) legs is one `adain_snake_conv1d` call."""

    def __init__(self, channels: int, kernel: int, dilations: Sequence[int],
                 style_dim: int):
        super().__init__()
        self.dilations = tuple(int(d) for d in dilations)
        n = len(self.dilations)
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, kernel)
                                    for _ in range(n))
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, kernel)
                                    for _ in range(n))
        self.adain1 = nn.ModuleList(AdaIN(style_dim, channels) for _ in range(n))
        self.adain2 = nn.ModuleList(AdaIN(style_dim, channels) for _ in range(n))
        self.alpha1 = nn.ParameterList(nn.Parameter(torch.ones(channels))
                                       for _ in range(n))
        self.alpha2 = nn.ParameterList(nn.Parameter(torch.ones(channels))
                                       for _ in range(n))
        # leg -> (stamp, kernel weight, alpha, bias) for K1; leg 2i is
        # convs1[i], leg 2i+1 convs2[i]
        self._kernel_ops: dict = {}

    @torch.no_grad()
    def pack_kernel_weights(self) -> None:
        """Lay out each leg's operands as K1 takes them: the conv weight
        (O, I, k) as `kernel_weight` of WIO for the path `choose_path` gives
        its dtype and width, alpha and bias in f32. Called once per bind,
        init_params or load_jax_params (Kokoro's `_cast_decoder`); a leg
        whose parameters have changed since is laid out again on its next
        CUDA call."""
        self._kernel_ops.clear()
        for i in range(len(self.dilations)):
            self._kernel_ops[2 * i] = self._layout(self.convs1[i],
                                                   self.alpha1[i])
            self._kernel_ops[2 * i + 1] = self._layout(self.convs2[i],
                                                       self.alpha2[i])

    @staticmethod
    def _layout(conv: Conv1d, alpha) -> tuple:
        w = conv.weight
        path = choose_path(w.dtype, w.shape[0])
        bias = (torch.zeros(w.shape[0], device=w.device) if conv.bias is None
                else conv.bias.float())
        return (_stamp(w, alpha, conv.bias),
                kernel_weight(w.permute(2, 1, 0), path),
                alpha.float().reshape(-1).contiguous(), bias.contiguous())

    def _operands(self, leg: int, conv: Conv1d, alpha) -> tuple:
        """(kernel weight, alpha, bias) of one leg, laid out again only if
        its parameters changed since `pack_kernel_weights`."""
        ops = self._kernel_ops.get(leg)
        if ops is None or ops[0] != _stamp(conv.weight, alpha, conv.bias):
            ops = self._kernel_ops[leg] = self._layout(conv, alpha)
        return ops[1:]

    def _leg(self, leg: int, adain: AdaIN, conv: Conv1d, alpha, x, s,
             dilation, valid, vlen):
        mean, var = _masked_stats(x, valid)
        gamma, beta = adain.affine(s)
        scale, shift = fold_adain(mean, var, gamma, beta)
        w = conv.weight.permute(2, 1, 0)
        if x.device.type == "cpu":
            return adain_snake_conv1d(x, scale, shift, alpha, w, conv.bias,
                                      dilation=dilation, valid_len=vlen)
        kw, alpha32, bias32 = self._operands(leg, conv, alpha)
        return adain_snake_conv1d(x, scale, shift, alpha32, w, bias32,
                                  dilation=dilation, valid_len=vlen,
                                  kernel_w=kw)

    def forward(self, x, s, valid=None):
        vlen = None if valid is None else valid.sum(-1).to(torch.int32)
        for i, d in enumerate(self.dilations):
            h = self._leg(2 * i, self.adain1[i], self.convs1[i],
                          self.alpha1[i], x, s, d, valid, vlen)
            h = self._leg(2 * i + 1, self.adain2[i], self.convs2[i],
                          self.alpha2[i], h, s, 1, valid, vlen)
            x = _mask(h + x, valid)
        return x


def _stamp(*tensors) -> tuple:
    """Identity and in-place version of each tensor (None stays None)."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        try:
            version = t._version
        except RuntimeError:     # inference tensors keep no version counter
            version = -1
        out.append((t.data_ptr(), t.device, t.dtype, version))
    return tuple(out)


# ---------------------------------------------------------------------------
# STFT helpers (magnitude/phase), basis-matmul DFT as in the JAX package
# ---------------------------------------------------------------------------


def _stft_mag_phase(x: torch.Tensor, n_fft: int, hop: int):
    """x (B, T) -> (mag, phase), each (B, frames, n_fft//2+1). Center reflect."""
    w = torch.from_numpy(_window_np("hann", n_fft, False)).to(x.device)
    xp = _pad_center(x, n_fft // 2, "reflect")
    frames = frame_signal(xp, n_fft, hop) * w
    re, im = rdft_pair(frames, n_fft)
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


@lru_cache(maxsize=16)
def _envelope(n_fft: int, num_frames: int, hop: int,
              device: torch.device) -> torch.Tensor:
    w_np = _window_np("hann", n_fft, True)
    env = _window_envelope_np(tuple(w_np.tolist()), num_frames, hop, n_fft,
                              False)
    return torch.from_numpy(env).to(device)


def _istft_from_mag_phase(mag: torch.Tensor, phase: torch.Tensor, n_fft: int,
                          hop: int) -> torch.Tensor:
    """(B, frames, bins) -> (B, samples); window-sum normalised, centre-trimmed,
    all in f32."""
    w = torch.from_numpy(_window_np("hann", n_fft, True)).to(mag.device)
    mag = mag.float()
    phase = phase.float()
    frames_time = irfft_pair(mag * torch.cos(phase), mag * torch.sin(phase),
                             n=n_fft)
    rec = overlap_add(frames_time * w, hop, n_fft)
    env = _envelope(n_fft, mag.shape[-2], hop, mag.device)
    rec = torch.where(env > 1e-10, rec / env, rec)
    return rec[..., n_fft // 2: -(n_fft // 2)]


# ---------------------------------------------------------------------------
# Harmonic source (SineGen + SourceModuleHnNSF)
# ---------------------------------------------------------------------------


class SourceModule(nn.Module):
    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = Linear(harmonic_num + 1, 1)


def harmonic_source(l_linear: Linear, f0: torch.Tensor, sample_rate: int,
                    upsample_scale: int, harmonic_num: int = 8,
                    sine_amp: float = 0.1, noise_std: float = 0.003,
                    voiced_threshold: float = 10.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """f0 (B, T, 1) at audio rate -> harmonic excitation (B, T).

    The phase is integrated at the control rate and linearly re-upsampled
    (istftnet.py:319-368). `generator=None` is the deterministic path (no
    random initial phase, no noise)."""
    b, t, _ = f0.shape
    dim = harmonic_num + 1
    fn = f0 * torch.arange(1, dim + 1, dtype=f0.dtype,
                           device=f0.device)[None, None, :]
    rad = torch.remainder(fn / sample_rate, 1.0)
    if generator is not None:
        rand_ini = torch.randn((b, dim), generator=generator,
                               device=f0.device, dtype=f0.dtype)
        rand_ini[:, 0] = 0.0
        rad = rad.clone()
        rad[:, 0, :] += rand_ini

    rad_ds = interpolate1d(rad, scale_factor=1.0 / upsample_scale, mode="linear")
    phase = torch.cumsum(rad_ds, dim=1) * 2 * math.pi
    phase = interpolate1d(phase * upsample_scale,
                          scale_factor=float(upsample_scale), mode="linear")
    sines = torch.sin(phase)
    if sines.shape[1] > t:
        sines = sines[:, :t, :]
    elif sines.shape[1] < t:
        sines = F.pad(sines, (0, 0, 0, t - sines.shape[1]))
    sine_waves = sines * sine_amp

    uv = (f0 > voiced_threshold).to(f0.dtype)
    if generator is None:
        noise = torch.zeros_like(sine_waves)
    else:
        noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
        noise = noise_amp * torch.randn(sine_waves.shape, generator=generator,
                                        device=f0.device, dtype=f0.dtype)
    sine_waves = sine_waves * uv + noise
    return torch.tanh(l_linear(sine_waves))[..., 0]


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


class Generator(nn.Module):
    def __init__(self, style_dim: int, resblock_kernel_sizes, upsample_rates,
                 upsample_initial_channel, resblock_dilation_sizes,
                 upsample_kernel_sizes, gen_istft_n_fft, gen_istft_hop_size):
        super().__init__()
        self.rates = [int(r) for r in upsample_rates]
        self.kernels = [int(k) for k in upsample_kernel_sizes]
        self.n_fft = int(gen_istft_n_fft)
        self.hop = int(gen_istft_hop_size)
        self.num_kernels = len(resblock_kernel_sizes)
        self.m_source = SourceModule()
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.noise_res = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        num_up = len(self.rates)
        for i, k in enumerate(self.kernels):
            c_in = upsample_initial_channel // (2 ** i)
            c_out = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(c_in, c_out, k))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AdaINResBlock1(c_out, int(rk), rd, style_dim))
            if i + 1 < num_up:
                stride_f0 = math.prod(self.rates[i + 1:])
                self.noise_convs.append(Conv1d(self.n_fft + 2, c_out, stride_f0 * 2))
                self.noise_res.append(AdaINResBlock1(c_out, 7, [1, 3, 5], style_dim))
            else:
                self.noise_convs.append(Conv1d(self.n_fft + 2, c_out, 1))
                self.noise_res.append(AdaINResBlock1(c_out, 11, [1, 3, 5], style_dim))
        self.conv_post = Conv1d(upsample_initial_channel // (2 ** num_up),
                                self.n_fft + 2, 7)

    def forward(self, x, s, f0_curve, valid=None, generator=None):
        """x (B, F2, C), s (B, style), f0_curve (B, F2) -> audio (B, samples)."""
        rates, n_fft, hop = self.rates, self.n_fft, self.hop
        num_up = len(rates)
        total_up = math.prod(rates) * hop

        # harmonic excitation at audio rate, f32 end to end
        f0_up = interpolate1d(f0_curve[..., None].float(),
                              scale_factor=float(total_up), mode="nearest")
        har = harmonic_source(self.m_source.l_linear, f0_up, 24000, total_up,
                              generator=generator)
        if valid is not None:
            har = torch.where(valid.repeat_interleave(total_up, dim=-1), har, 0.0)
        mag, phase = _stft_mag_phase(har, n_fft, hop)
        har_spec = torch.cat([mag, phase], dim=-1).to(x.dtype)

        cur_valid = valid
        for i in range(num_up):
            u, k = rates[i], self.kernels[i]
            x = leaky_relu(x, 0.1)
            if i + 1 < num_up:
                stride_f0 = math.prod(rates[i + 1:])
                x_source = self.noise_convs[i](har_spec, stride=stride_f0,
                                               padding=(stride_f0 + 1) // 2)
            else:
                x_source = self.noise_convs[i](har_spec)
            x = self.ups[i](x, stride=u, padding=(k - u) // 2)
            if cur_valid is not None:
                cur_valid = cur_valid.repeat_interleave(u, dim=-1)
                x = _mask(x, cur_valid)
            if i == num_up - 1:
                # reflection pad (1, 0) in time
                x = torch.cat([x[:, 1:2], x], dim=1)
                if cur_valid is not None:
                    cur_valid = torch.cat([cur_valid[:, 1:2], cur_valid], dim=-1)
            if x_source.shape[1] > x.shape[1]:
                x_source = x_source[:, : x.shape[1]]
            elif x_source.shape[1] < x.shape[1]:
                x_source = F.pad(x_source, (0, 0, 0, x.shape[1] - x_source.shape[1]))
            x = x + self.noise_res[i](_mask(x_source, cur_valid), s, cur_valid)
            xs = None
            for j in range(self.num_kernels):
                out = self.resblocks[i * self.num_kernels + j](x, s, cur_valid)
                xs = out if xs is None else xs + out
            x = xs / self.num_kernels

        x = self.conv_post(leaky_relu(x, 0.01), padding=3)
        spec = torch.exp(x[..., : n_fft // 2 + 1])
        phase_out = torch.sin(x[..., n_fft // 2 + 1:])
        return _istft_from_mag_phase(spec, phase_out, n_fft, hop)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class Decoder(nn.Module):
    def __init__(self, dim_in: int, style_dim: int, dim_out: int, cfg,
                 bottleneck_dim: int = 1024, res_dim: int = 64):
        super().__init__()
        bd, rd = bottleneck_dim, res_dim
        self.encode = AdainResBlk1d(dim_in + 2, bd, style_dim)
        self.decode = nn.ModuleList([
            AdainResBlk1d(bd + 2 + rd, bd, style_dim),
            AdainResBlk1d(bd + 2 + rd, bd, style_dim),
            AdainResBlk1d(bd + 2 + rd, bd, style_dim),
            AdainResBlk1d(bd + 2 + rd, cfg.upsample_initial_channel, style_dim,
                          upsample=True),
        ])
        self.F0_conv = Conv1d(1, 1, 3)
        self.N_conv = Conv1d(1, 1, 3)
        self.asr_res = nn.ModuleList([Conv1d(dim_in, rd, 1)])
        self.generator = Generator(
            style_dim, cfg.resblock_kernel_sizes, cfg.upsample_rates,
            cfg.upsample_initial_channel, cfg.resblock_dilation_sizes,
            cfg.upsample_kernel_sizes, cfg.gen_istft_n_fft,
            cfg.gen_istft_hop_size)

    def forward(self, asr, f0_curve, n_curve, s, frame_valid=None,
                generator=None):
        """asr (B, F, C), f0/n (B, 2F), s (B, style) -> audio (B, samples).

        The compute dtype follows `asr`; the f0/n curves stay f32 for the
        harmonic source and are cast only for their conv branches."""
        cdt = asr.dtype
        f0_d = _mask(self.F0_conv(f0_curve[..., None].to(cdt), stride=2,
                                  padding=1), frame_valid)
        n_d = _mask(self.N_conv(n_curve[..., None].to(cdt), stride=2,
                                padding=1), frame_valid)
        x = self.encode(torch.cat([asr, f0_d, n_d], dim=-1), s, frame_valid)
        asr_res = _mask(self.asr_res[0](asr), frame_valid)
        res = True
        cur_valid = frame_valid
        for blk in self.decode:
            if res:
                x = torch.cat([x, asr_res, f0_d, n_d], dim=-1)
            x = blk(x, s, cur_valid)
            if blk.upsample:
                res = False
                if cur_valid is not None:
                    cur_valid = cur_valid.repeat_interleave(2, dim=-1)
        return self.generator(x, s, f0_curve, cur_valid, generator=generator)
