"""DeepFilterNet 2/3 speech enhancement.

Counterpart of mlx_audio_tpu/sts/models/deepfilternet/model.py: the
Vorbis window and libDF's `wnorm`, `norm_alpha` with libDF's rounding, the
ERB features in dB under an exponential mean norm and the complex DF
features under an exponential unit norm (:56-76), `enhance_array` (the
one-hop left context, the fft-size right pad and the fft - hop delay
compensation, :138-165), `generate`, `enhance_file`, the hop-wise
`DeepFilterNetStreamer` with its explicit state (EMA states, conv history
frames, GRU states; :358-462), and `sanitize` (torch conv layouts to the
JAX tree's HWIO, GRU `weight_ih_l0` keys to per-layer leaves).

The EMA norms are the linear recurrence s_t = a s_(t-1) + (1 - a) x_t.
JAX runs it as `lax.scan` inside one program; a Python loop on the card
would cost launches every 10-ms hop. Here `linear_scan` runs it in blocks
of SCAN_BLOCK frames: each block is one product with a lower-triangular
matrix of powers a^(t-j), t >= j (so no power grows: the a^-t of a single
power series would overflow f32 over a long file), and the blocks' carries
are the same recurrence over blocks, at a^SCAN_BLOCK, solved the same way;
a file of T frames takes about log_64(T) levels of a few launches each.

The offline path runs the network over the whole file at once: eager
PyTorch compiles nothing per shape and the network is causal, so the JAX
package's padding to frame buckets would change nothing but the work. It
runs under `exact_f32()` (no TF32 in cuDNN's convolutions and GRUs, which
a fresh process would use). The streamer keeps the JAX package's host
numpy analysis and synthesis and runs each chunk of `chunk_frames` hops
through the network on the model's device with real history frames (valid
time padding in the convs that consume history), reading the chunk's
spectrum back once; it gives what the offline path gives, up to rounding.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ....dsp import istft as dsp_istft, stft as dsp_stft
from ....model import TorchModel, check_device, leaves
from .config import DeepFilterNetConfig, config_for_version
from . import network as N

# frames a block of the EMA scan covers (one product each)
SCAN_BLOCK = 64


def vorbis_window(size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float32)
    inner = np.sin(0.5 * np.pi * (n + 0.5) / (size // 2))
    return np.sin(0.5 * np.pi * inner * inner).astype(np.float32)


def norm_alpha(hop: int, sr: int) -> float:
    """libDF get_norm_alpha rounding."""
    a_raw = math.exp(-hop / sr)
    precision = 3
    a = 1.0
    while a >= 1.0:
        a = round(a_raw, precision)
        precision += 1
    return a


@lru_cache(maxsize=32)
def _decay(a: float, n: int, device: torch.device):
    """(n, n) lower-triangular a^(t-j) for j <= t, and (n,) a^(t+1), f32 on
    `device` (built in float64 on the host)."""
    t = np.arange(n)
    expo = t[:, None] - t[None, :]
    mat = np.where(expo >= 0, float(a) ** np.maximum(expo, 0), 0.0)
    carry = float(a) ** (t + 1.0)
    return (torch.from_numpy(mat.astype(np.float32)).to(device),
            torch.from_numpy(carry.astype(np.float32)).to(device))


def linear_scan(y: torch.Tensor, s0: torch.Tensor, a: float,
                block: int = SCAN_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """s_t = a s_(t-1) + y_t over the first axis of y (T, ...) from s0
    (...) -> (s (T, ...), s_(T-1))."""
    t = y.shape[0]
    if t <= block:
        mat, carry = _decay(a, t, y.device)
        s = torch.einsum("tj,j...->t...", mat, y) \
            + carry.reshape((t,) + (1,) * s0.ndim) * s0
        return s, s[-1]
    nb = -(-t // block)
    yb = torch.nn.functional.pad(
        y.reshape(t, -1), (0, 0, 0, nb * block - t)).reshape(
            (nb, block) + y.shape[1:])
    mat, carry = _decay(a, block, y.device)
    local = torch.einsum("tj,bj...->bt...", mat, yb)
    ends, _ = linear_scan(local[:, -1], s0, a ** block, block)
    prev = torch.cat([s0[None], ends[:-1]])
    s = local + carry.reshape((1, block) + (1,) * s0.ndim) * prev[:, None]
    s = s.reshape((nb * block,) + y.shape[1:])[:t]
    return s, s[-1]


def ema_mean_norm(x: torch.Tensor, state: torch.Tensor, alpha: float):
    """(T, E) band dB features -> ((x - s) / 40, final s)."""
    s, last = linear_scan(x * (1 - alpha), state, alpha)
    return (x - s) / 40.0, last


def ema_unit_norm(x: torch.Tensor, state: torch.Tensor, alpha: float):
    """(T, D) complex features -> (x / sqrt(s), final s), s the EMA of the
    magnitude."""
    s, last = linear_scan(x.abs() * (1 - alpha), state, alpha)
    return x / torch.sqrt(s), last


class Model(TorchModel):
    """DeepFilterNet on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: DeepFilterNetConfig = None, device="cuda",
                 **kwargs):
        device = check_device(device)
        if config is None:
            config = config_for_version(kwargs) if kwargs else \
                DeepFilterNetConfig()
        elif isinstance(config, dict):
            config = config_for_version(config)
        super().__init__(config)
        p = config
        self.wnorm = 1.0 / (p.fft_size * p.fft_size / (2.0 * p.hop_size))
        self.window = vorbis_window(p.fft_size)
        self.alpha = norm_alpha(p.hop_size, p.sample_rate)
        f = p.fft_size // 2 + 1
        with torch.device(device):
            self.enc = N.encoder(p)
            self.erb_dec = N.erb_decoder(p)
            self.df_dec = N.df_decoder(p)
            self.erb_fb = nn.Parameter(torch.zeros(f, p.nb_erb))
            self.mask = leaves(erb_inv_fb=(p.nb_erb, f))
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @torch.no_grad()
    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        """The JAX package's init (TorchModel.init_params), the ERB
        filterbanks zero as there (a checkpoint carries them)."""
        super().init_params(seed, on_device)
        self.erb_fb.zero_()
        self.mask.erb_inv_fb.zero_()
        return self

    # ------------------------------------------------------- features

    def _features(self, spec: torch.Tensor, erb_state: torch.Tensor,
                  df_state: torch.Tensor):
        """spec complex (T, F) -> feat_erb (T, E), feat_df complex (T, D)
        and the EMA states after them."""
        p = self.config
        erb = (spec.real ** 2 + spec.imag ** 2) @ self.erb_fb
        erb_db = 10.0 * torch.log10(erb + 1e-10)
        feat_erb, erb_state = ema_mean_norm(erb_db, erb_state, self.alpha)
        feat_df, df_state = ema_unit_norm(spec[:, : p.nb_df], df_state,
                                          self.alpha)
        return feat_erb, feat_df, erb_state, df_state

    def _init_ema(self):
        p = self.config
        dev = self.device
        return (torch.from_numpy(np.linspace(-60.0, -90.0, p.nb_erb,
                                             dtype=np.float32)).to(dev),
                torch.from_numpy(np.linspace(0.001, 0.0001, p.nb_df,
                                             dtype=np.float32)).to(dev))

    # -------------------------------------------------------- offline

    @torch.inference_mode()
    def enhance_array(self, audio: np.ndarray) -> np.ndarray:
        from ....codec.models.mimi import exact_f32

        p = self.config
        x = np.asarray(audio, np.float32).reshape(-1)
        orig = len(x)
        # libDF: one-hop implicit left context + fft_size right pad
        x = torch.from_numpy(np.pad(x, (p.hop_size, p.fft_size))).to(
            self.device)
        with exact_f32():
            spec = dsp_stft(x, n_fft=p.fft_size, hop_length=p.hop_size,
                            win_length=p.fft_size, window=self.window,
                            center=False) * self.wnorm           # (T, F)
            feat_erb, feat_df, _, _ = self._features(spec, *self._init_ema())
            spec_e = N.dfnet_forward(self, p, spec[None], feat_erb[None],
                                     feat_df[None])[0]
            out = dsp_istft(spec_e / self.wnorm, hop_length=p.hop_size,
                            win_length=p.fft_size, window=self.window,
                            center=False,
                            length=orig + p.hop_size + p.fft_size,
                            normalized=True)
        d = p.fft_size - p.hop_size
        return np.clip(out[d: orig + d].cpu().numpy(), -1.0, 1.0)

    def enhance_file(self, input_path, output_path):
        from ....audio_io import read, write
        from ....utils import resample_audio

        audio, sr = read(str(input_path))
        if audio.ndim > 1:
            audio = audio[:, 0]
        if sr != self.config.sample_rate:
            audio = resample_audio(audio, sr, self.config.sample_rate)
        write(str(output_path), self.enhance_array(audio),
              self.config.sample_rate)
        return Path(output_path)

    def generate(self, audio, **kwargs) -> np.ndarray:
        if isinstance(audio, (str, Path)):
            from ....utils import load_audio

            audio = load_audio(str(audio), self.config.sample_rate)
        return self.enhance_array(np.asarray(audio))

    # ------------------------------------------------------- streaming

    def create_streamer(self, chunk_frames: int = 8):
        if self.config.enc_concat:
            raise NotImplementedError(
                "streaming is implemented for the DeepFilterNet3 path")
        return DeepFilterNetStreamer(self, chunk_frames)

    def stream_step(self, spec: torch.Tensor, state: dict):
        """One chunk: spec complex (t, F) on the device -> the enhanced
        chunk (t, F) and the new state (the EMA states, the history frames
        of the features and the spectrum, the GRU states)."""
        p = self.config
        t = spec.shape[0]
        kt_in = p.conv_kernel_inp[0]
        h_erb = kt_in - 1
        h_df0 = kt_in - 1 + (p.df_pathway_kernel_size_t - 1)
        h_spec = p.df_order - 1
        feat_erb, feat_df, erb_s, df_s = self._features(
            spec, state["erb_ema"], state["df_ema"])
        erb_in = torch.cat([state["feat_erb"], feat_erb])
        df_in = torch.cat([state["feat_df"], feat_df])
        spec_in = torch.cat([state["spec"], spec])

        enc = self.enc
        # history-consuming convs over real past frames (valid in time);
        # every other conv of the path has time kernel 1
        e0 = N.apply_conv_block(enc["erb_conv0"], erb_in[None, None],
                                causal_pad=False)[:, :, -t:]
        e1 = N.apply_conv_block(enc["erb_conv1"], e0, fstride=2)
        e2 = N.apply_conv_block(enc["erb_conv2"], e1, fstride=2)
        e3 = N.apply_conv_block(enc["erb_conv3"], e2)
        c0_full = N.apply_conv_block(
            enc["df_conv0"], torch.view_as_real(df_in).permute(2, 0, 1)[None],
            causal_pad=False)
        c0 = c0_full[:, :, -t:]
        c1 = N.apply_conv_block(enc["df_conv1"], c0, fstride=2)
        emb, _, enc_gru = N.embed(enc, p, e3, c1, state["enc_gru"])
        m, erb_gru = N.erb_decoder_forward(self.erb_dec, p, emb, e3, e2, e1,
                                           e0, state["erb_gru"])
        spec_m = spec[None] * (m @ self.mask.erb_inv_fb)
        kt = p.df_pathway_kernel_size_t
        coefs, df_gru = N.df_coefs(self.df_dec, p, emb,
                                   c0_full[:, :, -(t + kt - 1):],
                                   state["df_gru"], causal_pad=False)
        low = N.deep_filter(spec_in[None], coefs, p.nb_df, p.df_order,
                            history=h_spec)
        spec_e = torch.cat([low, spec_m[:, :, p.nb_df:]], dim=2)[0]
        new_state = {
            "erb_ema": erb_s, "df_ema": df_s,
            "feat_erb": erb_in[-h_erb:], "feat_df": df_in[-h_df0:],
            "spec": spec_in[-h_spec:],
            "enc_gru": enc_gru, "erb_gru": erb_gru, "df_gru": df_gru,
        }
        return spec_e, new_state

    def init_stream_state(self) -> dict:
        p = self.config
        dev = self.device
        kt_in = p.conv_kernel_inp[0]
        f = p.fft_size // 2 + 1
        erb_s, df_s = self._init_ema()

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "erb_ema": erb_s, "df_ema": df_s,
            "feat_erb": zeros(kt_in - 1, p.nb_erb),
            "feat_df": zeros(kt_in - 1 + p.df_pathway_kernel_size_t - 1,
                             p.nb_df, dtype=torch.complex64),
            "spec": zeros(p.df_order - 1, f, dtype=torch.complex64),
            "enc_gru": [zeros(1, p.emb_hidden_dim)],
            "erb_gru": [zeros(1, p.emb_hidden_dim)
                        for _ in range(max(1, p.emb_num_layers - 1))],
            "df_gru": [zeros(1, p.df_hidden_dim)
                       for _ in range(p.df_num_layers)],
        }

    # -------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict:
        """A torch DeepFilterNet checkpoint -> the JAX tree, as numpy:
        Conv2d (O, I/g, kT, kF) -> HWIO; the depthwise ConvTranspose2d
        (I, O/g, kT, kF) -> the pre-flipped HWIO forward kernel; GRU
        `<name>.weight_ih_l0` etc -> `<name>.gru_layers.0.weight_ih`."""
        import re

        out = {}
        for k, v in weights.items():
            v = np.asarray(v, np.float32)
            m = re.match(r"(.*)\.(weight|bias)_(ih|hh)_l(\d+)$", k)
            if m:
                base, kind, which, layer = m.groups()
                out[f"{base}.gru_layers.{layer}.{kind}_{which}"] = v
                continue
            if k.endswith(".weight") and v.ndim == 4:
                if ".convt2." in k or ".convt1." in k:
                    v = np.flip(v, axis=(2, 3))
                out[k] = np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))
                continue
            out[k] = v
        return out


class DeepFilterNetStreamer:
    """Hop-accumulating streamer: host numpy analysis and synthesis (the
    JAX package's), the network a chunk of `chunk_frames` hops on the
    model's device."""

    def __init__(self, model: Model, chunk_frames: int = 8):
        self.model = model
        self.p = model.config
        self.chunk_frames = chunk_frames
        self.reset()

    def reset(self):
        p = self.p
        self._state = self.model.init_stream_state()
        self._pending = np.zeros(0, np.float32)
        self._analysis_mem = np.zeros(p.fft_size - p.hop_size, np.float32)
        self._synth_mem = np.zeros(p.fft_size - p.hop_size, np.float32)
        self._prev_env = np.zeros(0, np.float32)
        self._delay_dropped = 0

    @torch.inference_mode()
    def _network(self, spec: np.ndarray) -> np.ndarray:
        from ....codec.models.mimi import exact_f32

        with exact_f32():
            spec_e, self._state = self.model.stream_step(
                torch.from_numpy(spec).to(self.model.device), self._state)
        return spec_e.cpu().numpy()

    def process_chunk(self, chunk: np.ndarray,
                      is_last: bool = False) -> np.ndarray:
        p = self.p
        x = np.asarray(chunk, np.float32).reshape(-1)
        self._pending = np.concatenate([self._pending, x])
        if is_last:
            pad = np.zeros(3 * p.hop_size + (p.fft_size - p.hop_size),
                           np.float32)
            self._pending = np.concatenate([self._pending, pad])

        outs = []
        window = self.model.window
        cf = self.chunk_frames
        while len(self._pending) >= p.hop_size * cf:
            hops = self._pending[: p.hop_size * cf]
            self._pending = self._pending[p.hop_size * cf:]
            buf = np.concatenate([self._analysis_mem, hops])
            frames = np.stack([buf[i * p.hop_size:
                                   i * p.hop_size + p.fft_size]
                               for i in range(cf)])
            self._analysis_mem = buf[-(p.fft_size - p.hop_size):]
            spec = (np.fft.rfft(frames * window, axis=-1)
                    * self.model.wnorm).astype(np.complex64)
            enh_c = self._network(spec) / self.model.wnorm
            # synthesis overlap-add with libDF window^2 normalization
            frames_td = np.fft.irfft(enh_c, n=p.fft_size, axis=-1) * window
            env = np.zeros((cf - 1) * p.hop_size + p.fft_size)
            wsq = window * window
            acc = np.zeros_like(env)
            for i in range(cf):
                acc[i * p.hop_size: i * p.hop_size + p.fft_size] += \
                    frames_td[i]
                env[i * p.hop_size: i * p.hop_size + p.fft_size] += wsq
            acc[: p.fft_size - p.hop_size] += self._synth_mem
            full_env = env.copy()
            if self._prev_env.size:
                full_env[: p.fft_size - p.hop_size] += self._prev_env
            out = acc[: cf * p.hop_size] / np.maximum(
                full_env[: cf * p.hop_size], 1e-10)
            self._synth_mem = acc[cf * p.hop_size:]
            self._prev_env = env[cf * p.hop_size:]
            outs.append(out.astype(np.float32))

        if not outs:
            return np.zeros(0, np.float32)
        y = np.concatenate(outs)
        # drop the algorithmic delay once
        d = p.fft_size - p.hop_size
        if self._delay_dropped < d:
            take = min(d - self._delay_dropped, len(y))
            y = y[take:]
            self._delay_dropped += take
        return np.clip(y, -1.0, 1.0)

    def flush(self) -> np.ndarray:
        return self.process_chunk(np.zeros(0, np.float32), is_last=True)


DeepFilterNetModel = Model

__all__ = ["Model", "DeepFilterNetModel", "DeepFilterNetStreamer",
           "vorbis_window", "norm_alpha", "linear_scan", "ema_mean_norm",
           "ema_unit_norm"]
