"""DSP helpers (subset of mlx_audio_tpu/dsp.py).

* The ISTFTNet heads' pieces: framing, the small real DFT as a basis
  matmul, its inverse, overlap-add and the window envelope (what Kokoro's
  harmonic-source STFT and final inverse STFT use). That DFT keeps the JAX
  package's basis-matmul form (not `torch.fft`) so the harmonic spectrum's
  phase, fed raw into the noise convs, sees the same rounding near the
  arctan2 branch cut.
* `stft` and `spec_abs` (Voxtral Realtime's mel), with the DFT taken in
  float64 for the reason below and the spectrum returned in complex64.
* `istft` (Mel-Band-RoFormer's and DeepFilterNet's synthesis): an f32
  `torch.fft.irfft` a frame and one `F.fold` overlap-add for any hop,
  normalised by Σ window (or Σ window², COLA). The Kokoro-shaped
  `ISTFTCache` is not ported.
* The shared log-mel front end of Whisper-style STT (`mel_filters`,
  `log_mel_spectrogram`, `STR_TO_WINDOW_FN`). Its DFT is `torch.fft.rfft`
  where the JAX package multiplies by a DFT basis at `Precision.HIGHEST`
  (a TPU workaround). The windowed frames, the DFT, the power and the mel
  product run in float64 and the mel is rounded to float32 before the log:
  in f32 both forms err by up to about 7e-5 of log-mel on low-power bins,
  in different directions, so an f32 rfft would stray 1.2e-4 from the JAX
  package; in f64 the port is within the JAX package's own error. No TF32
  applies to f64.

* The Kaldi features (dsp.py:865-1048: `mel_scale_kaldi`,
  `get_mel_banks_kaldi`, `compute_deltas_kaldi`, `compute_fbank_kaldi`)
  of FSMN VAD, SenseVoice, Fun-ASR-Nano, FireRedASR2 and MossFormer2-SE.
  The framing, dither, DC removal, pre-emphasis and window run in f32, as
  in the JAX package; the power spectrum and the mel product run in
  float64 and the mel energies are rounded to f32 before the log, for the
  reason above. The dither's noise has a seam: `noise=` takes the draws
  (a test hands in JAX's `normal(PRNGKey(0), frames.shape)`), else they
  come from a CPU `torch.Generator` seeded 0, so one input gives one
  output on every device, as JAX's fixed key does.

Windows, DFT bases, filterbanks and envelopes are built on the host in
float64 (float32 for a filterbank's non-`precise` build), cast to float32
and cached, exactly as in the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch

# DFT lengths up to this use the basis matmul (dsp._DFT_MATMUL_MAX).
_DFT_MATMUL_MAX = 256


@lru_cache(maxsize=None)
def _window_np(kind: str, size: int, periodic: bool) -> np.ndarray:
    denom = size if periodic else size - 1
    n = np.arange(size, dtype=np.float64)
    if kind == "hann":
        w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)
    elif kind == "blackman":
        w = (0.42 - 0.5 * np.cos(2.0 * np.pi * n / denom)
             + 0.08 * np.cos(4.0 * np.pi * n / denom))
    elif kind == "bartlett":
        w = 1.0 - 2.0 * np.abs(n - denom / 2.0) / denom
    elif kind == "povey":
        w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)) ** 0.85
    else:
        raise ValueError(f"Unknown window kind: {kind}")
    return w.astype(np.float32)


def hanning(size: int, periodic: bool = False) -> torch.Tensor:
    """Hann window (dsp.hanning)."""
    return torch.from_numpy(_window_np("hann", size, periodic).copy())


def hamming(size: int, periodic: bool = False) -> torch.Tensor:
    return torch.from_numpy(_window_np("hamming", size, periodic).copy())


def blackman(size: int, periodic: bool = False) -> torch.Tensor:
    return torch.from_numpy(_window_np("blackman", size, periodic).copy())


def bartlett(size: int, periodic: bool = False) -> torch.Tensor:
    return torch.from_numpy(_window_np("bartlett", size, periodic).copy())


def povey(size: int, periodic: bool = False) -> torch.Tensor:
    """Kaldi 'povey' window (hann**0.85)."""
    return torch.from_numpy(_window_np("povey", size, periodic).copy())


STR_TO_WINDOW_FN = {
    "hann": hanning,
    "hanning": hanning,
    "hamming": hamming,
    "blackman": blackman,
    "bartlett": bartlett,
    "povey": povey,
}


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """(..., T) -> (..., num_frames, frame_length) overlapping frames (a view)."""
    t = x.shape[-1]
    if 1 + (t - frame_length) // hop_length <= 0:
        raise ValueError(f"Input is too short (length={t}) for "
                         f"frame_length={frame_length} with "
                         f"hop_length={hop_length}.")
    return x.unfold(-1, frame_length, hop_length)


def _pad_center(x: torch.Tensor, padding: int, pad_mode: str) -> torch.Tensor:
    """Pad the last axis on both sides: 'constant' (zeros) or 'reflect'
    (torch 'reflect': no edge duplication)."""
    if pad_mode == "constant":
        return torch.nn.functional.pad(x, (padding, padding))
    if pad_mode == "reflect":
        prefix = torch.flip(x[..., 1: padding + 1], dims=(-1,))
        suffix = torch.flip(x[..., -(padding + 1): -1], dims=(-1,))
        return torch.cat([prefix, x, suffix], dim=-1)
    raise ValueError(f"Invalid pad_mode {pad_mode}")


def _resolve_window(window, win_length: int, n_fft: int) -> torch.Tensor:
    """A window spec (name or array) as f32, zero-padded at the end to n_fft
    (dsp._resolve_window)."""
    if isinstance(window, str):
        fn = STR_TO_WINDOW_FN.get(window.lower())
        if fn is None:
            raise ValueError(f"Unknown window function: {window}")
        w = fn(win_length)
    else:
        w = torch.as_tensor(window, dtype=torch.float32)
    if w.shape[0] < n_fft:
        w = torch.nn.functional.pad(w, (0, n_fft - w.shape[0]))
    return w


def _rfft64(x: torch.Tensor, w: torch.Tensor, n_fft: int, hop_length: int,
            center: bool, pad_mode: str) -> torch.Tensor:
    """The frames of f32 x (centre-padded if `center`), windowed by w and
    transformed in float64: (..., num_frames, n_fft // 2 + 1) complex128."""
    if center:
        x = _pad_center(x, n_fft // 2, pad_mode)
    frames = frame_signal(x, n_fft, hop_length).double() \
        * w.to(x.device, torch.float64)
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def stft(x, n_fft: int = 800, hop_length: Optional[int] = None,
         win_length: Optional[int] = None,
         window: Union[str, torch.Tensor, np.ndarray] = "hann",
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """Short-time Fourier transform (dsp.stft): (..., T) ->
    (..., num_frames, n_fft // 2 + 1) complex64, on x's device (the CPU
    for numpy input). The windowed frames and the DFT run in float64, as in
    `log_mel_spectrogram`."""
    x = torch.as_tensor(x, dtype=torch.float32)
    w = _resolve_window(window, n_fft if win_length is None else win_length,
                        n_fft)
    return _rfft64(x, w, n_fft, n_fft // 4 if hop_length is None
                   else hop_length, center, pad_mode).to(torch.complex64)


def spec_abs(spec: torch.Tensor) -> torch.Tensor:
    """Magnitude of an `stft` result (dsp.spec_abs), f32."""
    return spec.abs()


@lru_cache(maxsize=None)
def _rdft_bases_np(n_fft: int):
    """Forward real-DFT bases (cos, -sin), each (n_fft, n_fft//2+1) f32."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * ((n * k) % n_fft) / n_fft
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@lru_cache(maxsize=None)
def _irdft_bases_np(n_fft: int):
    """Inverse real-DFT bases (C, S), each (n_fft//2+1, n_fft) f32, with
    `re @ C + im @ S == irfft(re + 1j*im, n_fft)`."""
    kk = np.arange(n_fft // 2 + 1)[:, None]
    nn = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * ((kk * nn) % n_fft) / n_fft
    w = np.full((n_fft // 2 + 1, 1), 2.0)
    w[0, 0] = 1.0
    if n_fft % 2 == 0:
        w[-1, 0] = 1.0
    c = (w * np.cos(ang) / n_fft).astype(np.float32)
    s = (-(w * np.sin(ang)) / n_fft).astype(np.float32)
    return c, s


@lru_cache(maxsize=None)
def _bases(inverse: bool, n_fft: int, device: torch.device):
    """The DFT bases as f32 tensors on `device` (copied there once)."""
    arrs = (_irdft_bases_np if inverse else _rdft_bases_np)(n_fft)
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def rdft_pair(frames: torch.Tensor, n_fft: Optional[int] = None):
    """Real DFT as a basis matmul: (..., n_fft) -> (re, im), each
    (..., n_fft//2+1) f32."""
    nf = frames.shape[-1] if n_fft is None else n_fft
    cosb, msinb = _bases(False, nf, frames.device)
    f32 = frames.float()
    return f32 @ cosb, f32 @ msinb


def irdft_pair(re: torch.Tensor, im: torch.Tensor,
               n: Optional[int] = None) -> torch.Tensor:
    """Inverse of `rdft_pair` as one pair of (K, n) matmuls."""
    nf = 2 * (re.shape[-1] - 1) if n is None else n
    c, s = _bases(True, nf, re.device)
    return re.float() @ c + im.float() @ s


def irfft_pair(re: torch.Tensor, im: torch.Tensor,
               n: Optional[int] = None) -> torch.Tensor:
    """irfft of (real, imag) parts: the basis matmul for n <= 256, else
    torch.fft."""
    nf = 2 * (re.shape[-1] - 1) if n is None else n
    if nf <= _DFT_MATMUL_MAX:
        return irdft_pair(re, im, nf)
    return torch.fft.irfft(torch.complex(re.float(), im.float()), n=n, dim=-1)


def overlap_add(frames: torch.Tensor, hop_length: int,
                win_length: int) -> torch.Tensor:
    """Overlap-add (..., num_frames, win_length) -> (..., T),
    T = (num_frames-1)*hop + win.

    When hop divides win (the ISTFTNet heads) this is win/hop shifted adds
    of contiguous reshapes, in the JAX package's order; otherwise one
    strided add per sample offset, which sums in the same order."""
    lead = frames.shape[:-2]
    nfr = frames.shape[-2]
    t = (nfr - 1) * hop_length + win_length
    fr = frames.reshape(-1, nfr, win_length)
    out = torch.zeros(fr.shape[0], t, dtype=fr.dtype, device=fr.device)
    if win_length % hop_length == 0:
        for j in range(win_length // hop_length):
            slab = fr[:, :, j * hop_length:(j + 1) * hop_length]
            out[:, j * hop_length: j * hop_length + nfr * hop_length] += (
                slab.reshape(fr.shape[0], nfr * hop_length))
    else:
        for j in range(win_length):
            out[:, j: j + (nfr - 1) * hop_length + 1: hop_length] += fr[:, :, j]
    return out.reshape(*lead, t)


@lru_cache(maxsize=None)
def _window_envelope_np(window_key, num_frames: int, hop_length: int,
                        win_length: int, squared: bool) -> np.ndarray:
    """Overlap-added window (or window^2) normalisation envelope, f64 sums
    cast to f32. `np.add.at` adds in frame order, as the JAX loop does."""
    w = np.asarray(window_key, dtype=np.float64)
    wn = w * w if squared else w
    t = (num_frames - 1) * hop_length + win_length
    env = np.zeros(t, dtype=np.float64)
    idx = (np.arange(num_frames)[:, None] * hop_length
           + np.arange(win_length)[None, :])
    np.add.at(env, idx.ravel(), np.tile(wn, num_frames))
    return env.astype(np.float32)


@lru_cache(maxsize=64)
def _envelope_on(window_key, num_frames: int, hop_length: int,
                 win_length: int, squared: bool,
                 device: torch.device) -> torch.Tensor:
    """`_window_envelope_np` as an f32 tensor on `device` (copied once)."""
    return torch.from_numpy(_window_envelope_np(
        window_key, num_frames, hop_length, win_length, squared)).to(device)


def istft(x: torch.Tensor, hop_length: Optional[int] = None,
          win_length: Optional[int] = None,
          window: Union[str, torch.Tensor, np.ndarray] = "hann",
          center: bool = True, length: Optional[int] = None,
          normalized: bool = False) -> torch.Tensor:
    """Inverse STFT (dsp.istft, mlx_audio_tpu/dsp.py:383-453): complex
    (..., num_frames, n_fft // 2 + 1) -> (..., T) f32 on x's device.

    Each frame is `torch.fft.irfft`, cut to win_length and windowed; the
    frames are overlap-added in one `F.fold` and divided by the overlap-
    added window (window squared when `normalized`, the COLA form) where
    that exceeds 1e-10. `center` without `length` trims win_length // 2 from
    both ends; `length` cuts the result to its first `length` samples
    (and, as in the JAX package, then trims nothing at the front). A window
    name gives the periodic window; a numpy array or tensor is used as it
    is, zero-padded to win_length. The envelope is built on the host in
    float64 from the window's f32 values, as the JAX package builds it."""
    if win_length is None:
        win_length = (x.shape[-1] - 1) * 2
    if hop_length is None:
        hop_length = win_length // 4
    if isinstance(window, str):
        kind = {"hanning": "hann"}.get(window.lower(), window.lower())
        if window.lower() not in STR_TO_WINDOW_FN:
            raise ValueError(f"Unknown window function: {window}")
        w_np = _window_np(kind, win_length + 1, False)[:-1]
    else:
        w_np = np.asarray(window.cpu() if isinstance(window, torch.Tensor)
                          else window, np.float32)
    if w_np.shape[0] < win_length:
        w_np = np.pad(w_np, (0, win_length - w_np.shape[0]))
    lead, nfr = x.shape[:-2], x.shape[-2]
    frames = torch.fft.irfft(x.to(torch.complex64), dim=-1)[..., :win_length]
    frames = frames * torch.tensor(w_np, device=x.device)
    t = (nfr - 1) * hop_length + win_length
    out = torch.nn.functional.fold(
        frames.reshape(-1, nfr, win_length).transpose(1, 2),
        output_size=(1, t), kernel_size=(1, win_length),
        stride=(1, hop_length)).reshape(*lead, t)
    env = _envelope_on(tuple(w_np.astype(np.float64).tolist()), nfr,
                       hop_length, win_length, normalized, x.device)
    out = torch.where(env > 1e-10, out / env, out)
    if center and length is None:
        out = out[..., win_length // 2: -(win_length // 2)]
    if length is not None:
        out = out[..., :length]
    return out


# ---------------------------------------------------------------------------
# Mel filterbank (dsp.py:515-608)
# ---------------------------------------------------------------------------


def _hz_to_mel_np(freq, mel_scale: str):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        return np.where(
            freq >= min_log_hz, min_log_mel + np.log(freq / min_log_hz) / logstep, mels
        )


def _mel_to_hz_np(mels, mel_scale: str):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )


@lru_cache(maxsize=None)
def _mel_filters_np(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float,
    f_max: Optional[float],
    norm: Optional[str],
    mel_scale: str,
    precise: bool,
) -> np.ndarray:
    """The (n_mels, n_fft//2+1) triangular filterbank, built on the host in
    float32, or in float64 when `precise` (the JAX package's two builds)."""
    f_max = f_max or sample_rate / 2
    build_dtype = np.float64 if precise else np.float32

    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs, dtype=build_dtype)

    m_min = float(_hz_to_mel_np(f_min, mel_scale))
    m_max = float(_hz_to_mel_np(f_max, mel_scale))
    m_pts = np.linspace(m_min, m_max, n_mels + 2, dtype=build_dtype)
    f_pts = _mel_to_hz_np(m_pts, mel_scale).astype(build_dtype)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]

    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes)).astype(build_dtype)

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :].astype(build_dtype)

    return np.moveaxis(fb, 0, 1).astype(np.float32)


def mel_filters(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float = 0,
    f_max: Optional[float] = None,
    norm: Optional[str] = None,
    mel_scale: str = "htk",
    precise: bool = False,
) -> torch.Tensor:
    """Triangular mel filterbank, shape (n_mels, n_fft // 2 + 1), f32 on the
    CPU (dsp.mel_filters, including the float64 `precise` build)."""
    return torch.from_numpy(_mel_filters_np(
        sample_rate, n_fft, n_mels, float(f_min), f_max, norm, mel_scale,
        precise).copy())


@lru_cache(maxsize=None)
def filters_on(device: torch.device, sample_rate: int, n_fft: int,
               n_mels: int, norm: Optional[str], mel_scale: str,
               precise: bool = False,
               f_max: Optional[float] = None) -> torch.Tensor:
    """The filterbank (f_min 0), transposed to (n_fft//2+1, n_mels), on
    `device` (copied there once)."""
    return mel_filters(sample_rate, n_fft, n_mels, 0.0, f_max, norm,
                       mel_scale, precise).T.contiguous().to(device)


# ---------------------------------------------------------------------------
# Log-mel spectrogram, the shared STT feature front end (dsp.py:631-705)
# ---------------------------------------------------------------------------


def log_mel_spectrogram(
    audio,
    n_fft: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
    sample_rate: int = 16000,
    padding: int = 0,
    window: Union[str, torch.Tensor] = "hann",
    periodic_window: bool = True,
    log_base: str = "log10_whisper",
    mel_norm: Optional[str] = None,
    mel_scale: str = "htk",
    precise: bool = False,
    log_floor_mode: str = "clip",
    device=None,
) -> torch.Tensor:
    """Log-mel spectrogram: (..., T) -> (..., frames, n_mels), f32.

    Pad `padding` zeros at the end, reflect-pad n_fft//2 on both sides,
    frame, window, |rfft|^2, mel (these four in f64), log. `log_base`: "log10_whisper" (clamp
    at 1e-10, log10, floor at the maximum of the WHOLE array less 8, then
    (x + 4) / 4), else natural log with `log_floor_mode` "clip"
    (log(max(mel, 1e-5))) or "log" (log(mel + 1e-6)). Runs on `device`
    (default: the audio's, the CPU for numpy input); the defaults
    reproduce Whisper's front end."""
    audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
    if isinstance(window, str):
        fn = STR_TO_WINDOW_FN[window.lower()]
        w = fn(n_fft + 1)[:-1] if periodic_window else fn(n_fft)
    else:
        w = torch.as_tensor(window, dtype=torch.float32)
    if padding > 0:
        audio = torch.nn.functional.pad(audio, (0, padding))
    spec = _rfft64(audio, w, n_fft, hop_length, True, "reflect")
    power = spec.real ** 2 + spec.imag ** 2
    fb = filters_on(audio.device, sample_rate, n_fft, n_mels, mel_norm,
                    mel_scale, precise)
    mel = (power @ fb.double()).float()
    if log_base == "log10_whisper":
        logspec = torch.log10(torch.clamp(mel, min=1e-10))
        logspec = torch.maximum(logspec, logspec.max() - 8.0)
        return (logspec + 4.0) / 4.0
    if log_floor_mode == "clip":
        return torch.log(torch.clamp(mel, min=1e-5))
    return torch.log(mel + 1e-6)


# ---------------------------------------------------------------------------
# ISTFTCache (dsp.py:454-512)
# ---------------------------------------------------------------------------


class ISTFTCache:
    """Batched inverse STFT (dsp.ISTFTCache): (batch, freq, frames) real
    and imaginary parts -> (batch, samples) f32 on their device. The JAX
    package compiles one program a (n_fft, hop, win_length, center) and
    caches it; here each such config is recorded, and the squared-window
    envelope of each (window, frames, hop) is built once on the host in
    float64 (`_envelope_on`)."""

    def __init__(self):
        self._configs = set()

    def istft(self, real_part: torch.Tensor, imag_part: torch.Tensor,
              n_fft: int, hop_length: int, win_length: int, window,
              center: bool = True,
              audio_length: Optional[int] = None) -> torch.Tensor:
        w = _resolve_window(window, win_length, n_fft)
        dev = real_part.device
        nfr = real_part.shape[-1]
        self._configs.add((n_fft, hop_length, win_length, center))
        env = _envelope_on(tuple(w.double().tolist()), nfr, hop_length,
                           n_fft, True, dev).clamp(min=1e-10)
        spec = torch.complex(real_part.float(), imag_part.float())
        frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
        frames = frames * w.to(dev)
        lead = frames.shape[:-2]
        t = (nfr - 1) * hop_length + n_fft
        out = torch.nn.functional.fold(
            frames.reshape(-1, nfr, n_fft).transpose(1, 2),
            output_size=(1, t), kernel_size=(1, n_fft),
            stride=(1, hop_length)).reshape(*lead, t)
        out = out / env
        if center:
            out = out[..., n_fft // 2:]
        if audio_length is not None:
            out = out[..., :audio_length]
        return out

    def clear_cache(self):
        self._configs.clear()

    def cache_info(self):
        return {"jitted_configs": len(self._configs)}


# ---------------------------------------------------------------------------
# Kaldi-compatible features (dsp.py:865-1048)
# ---------------------------------------------------------------------------


def mel_scale_kaldi(freq):
    """Hz -> mel, Kaldi's formula."""
    return 1127.0 * torch.log(1.0 + torch.as_tensor(freq) / 700.0)


def inverse_mel_scale_kaldi(mel_freq):
    """Mel -> Hz, Kaldi's formula."""
    return 700.0 * (torch.exp(torch.as_tensor(mel_freq) / 1127.0) - 1.0)


def _next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


@lru_cache(maxsize=None)
def _mel_banks_kaldi_np(num_bins: int, window_length_padded: int,
                        sample_freq: float, low_freq: float,
                        high_freq: float):
    """Kaldi's triangular mel banks (num_bins, window_length_padded // 2)
    and their centre frequencies, built in float64, cast to f32."""
    assert num_bins > 3, "Must have at least 3 mel bins"
    assert window_length_padded % 2 == 0
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq += nyquist
    assert (0.0 <= low_freq < nyquist) and (0.0 < high_freq <= nyquist)

    def m(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def im(mel):
        return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0)
                        - 1.0)

    fft_bin_width = sample_freq / window_length_padded
    mel_low = float(m(low_freq))
    mel_high = float(m(high_freq))
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left = mel_low + bin_idx * mel_delta
    center = mel_low + (bin_idx + 1.0) * mel_delta
    right = mel_low + (bin_idx + 2.0) * mel_delta
    center_freqs = im(center)
    mel = m(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    bins = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return bins, center_freqs.squeeze().astype(np.float32)


def get_mel_banks_kaldi(num_bins: int, window_length_padded: int,
                        sample_freq: float, low_freq: float,
                        high_freq: float):
    """Kaldi mel filterbank (num_bins, n_fft // 2) and centre frequencies,
    f32 on the CPU."""
    bins, cf = _mel_banks_kaldi_np(num_bins, window_length_padded,
                                   float(sample_freq), float(low_freq),
                                   float(high_freq))
    return torch.from_numpy(bins.copy()), torch.from_numpy(cf.copy())


@lru_cache(maxsize=16)
def _kaldi_banks_on(num_bins: int, padded: int, sample_freq: float,
                    low_freq: float, high_freq: float,
                    device: torch.device) -> torch.Tensor:
    """The banks padded by one zero column (the Nyquist bin), transposed to
    (padded // 2 + 1, num_bins), float64 on `device` (copied once)."""
    bins, _ = _mel_banks_kaldi_np(num_bins, padded, sample_freq, low_freq,
                                  high_freq)
    return torch.from_numpy(np.pad(bins, ((0, 0), (0, 1))).T.astype(
        np.float64)).to(device)


def compute_deltas_kaldi(specgram, win_length: int = 5,
                         mode: str = "edge") -> torch.Tensor:
    """Delta coefficients over the last (time) axis of (..., freq, time):
    one depthwise conv of the (-n..n) / denom kernel over the edge- or
    zero-padded rows."""
    if win_length < 3:
        raise ValueError(f"win_length should be >= 3, got {win_length}")
    specgram = torch.as_tensor(specgram)
    shape = specgram.shape
    x = specgram.reshape(-1, shape[-1])
    n = (win_length - 1) // 2
    denom = float(n * (n + 1) * (2 * n + 1)) / 3.0
    xp = torch.nn.functional.pad(
        x[:, None], (n, n), mode="replicate" if mode == "edge"
        else "constant")
    kernel = (torch.arange(-n, n + 1, dtype=x.dtype, device=x.device)
              / denom)
    return torch.nn.functional.conv1d(xp, kernel[None, None]).reshape(shape)


def _get_strided_kaldi(waveform: torch.Tensor, window_size: int,
                       window_shift: int, snip_edges: bool) -> torch.Tensor:
    """Kaldi's frames (m, window_size): with `snip_edges` only whole
    frames; else (T + shift // 2) // shift frames over the signal with its
    edges reflected."""
    num_samples = waveform.shape[0]
    if snip_edges:
        if num_samples < window_size:
            return waveform.new_zeros((0, 0))
        return frame_signal(waveform, window_size, window_shift)
    m = (num_samples + (window_shift // 2)) // window_shift
    pad = window_size // 2 - window_shift // 2
    if pad > 0:
        pad_left = torch.flip(waveform[1:pad + 1], (0,))
        pad_right = (torch.flip(waveform, (0,))[:pad] if pad > 1
                     else waveform[-1:])
        waveform = torch.cat([pad_left, waveform, pad_right])
    else:
        waveform = torch.cat([waveform[-pad:], torch.flip(waveform, (0,))])
    needed = (m - 1) * window_shift + window_size
    if waveform.shape[0] < needed:
        waveform = torch.cat([waveform, waveform[-1:].expand(
            needed - waveform.shape[0])])
    return frame_signal(waveform, window_size, window_shift)[:m]


def compute_fbank_kaldi(waveform, sample_rate: int = 48000,
                        win_len: int = 1920, win_inc: int = 384,
                        num_mels: int = 60, win_type: str = "hamming",
                        preemphasis: float = 0.97, dither: float = 1.0,
                        snip_edges: bool = True, low_freq: float = 20.0,
                        high_freq: float = 0.0,
                        noise: Optional[torch.Tensor] = None,
                        device=None) -> torch.Tensor:
    """Kaldi-compatible log mel-filterbank features (time, num_mels), f32
    on `device` (default: the waveform's, the CPU for numpy input).

    Dither adds `noise * dither` to the frames: `noise` (the frames'
    shape) if given, else standard normal draws from a CPU generator
    seeded 0, moved to the frames' device."""
    waveform = torch.as_tensor(waveform, dtype=torch.float32, device=device)
    if waveform.ndim == 2:
        waveform = waveform[0]
    window_shift = int(sample_rate * (win_inc / sample_rate * 1000) * 0.001)
    window_size = int(sample_rate * (win_len / sample_rate * 1000) * 0.001)
    padded = _next_power_of_2(window_size)
    frames = _get_strided_kaldi(waveform, window_size, window_shift,
                                snip_edges)
    if frames.shape[0] == 0:
        return waveform.new_zeros((0, num_mels))
    if dither != 0.0:
        if noise is None:
            noise = torch.randn(frames.shape,
                                generator=torch.Generator().manual_seed(0))
        frames = frames + torch.as_tensor(noise, dtype=torch.float32).to(
            frames.device) * dither
    frames = frames - frames.mean(dim=1, keepdim=True)
    if preemphasis != 0.0:
        frames = torch.cat([frames[:, :1],
                            frames[:, 1:] - preemphasis * frames[:, :-1]],
                           dim=1)
    if win_type in ("hamming", "hanning", "povey"):
        kind = {"hanning": "hann"}.get(win_type, win_type)
        frames = frames * torch.from_numpy(
            _window_np(kind, window_size, False)).to(frames.device)
    spec = torch.fft.rfft(frames.double(), n=padded, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    banks = _kaldi_banks_on(num_mels, padded, float(sample_rate),
                            float(low_freq), float(high_freq), frames.device)
    feats = (power @ banks).float()
    return torch.log(torch.clamp(feats, min=1e-8))
