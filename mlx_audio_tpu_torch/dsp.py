"""DSP helpers for the ISTFTNet heads (subset of mlx_audio_tpu/dsp.py).

Framing, the small real DFT as a basis matmul, its inverse, overlap-add and
the window envelope: what Kokoro's harmonic-source STFT and final inverse
STFT use. The DFT keeps the JAX package's basis-matmul form (not
`torch.fft`) so the harmonic spectrum's phase, fed raw into the noise
convs, sees the same rounding near the arctan2 branch cut.

Windows, DFT bases and envelopes are built on the host in float64, cast to
float32 and cached, exactly as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

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
