"""Whisper audio constants and mel front end.

Counterpart of mlx_audio_tpu/stt/models/whisper/audio.py: the constants,
`log_mel_spectrogram` (the shared `dsp.log_mel_spectrogram` in its Whisper
mode, last frame dropped) and `pad_or_trim`.
"""

from __future__ import annotations

import torch

from ....dsp import log_mel_spectrogram as _log_mel

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100
TOKENS_PER_SECOND = SAMPLE_RATE // (HOP_LENGTH * 2)  # 50


def log_mel_spectrogram(audio, n_mels: int = 80, padding: int = 0,
                        device=None) -> torch.Tensor:
    """audio (T,) -> (frames, n_mels) f32, Whisper-normalized log10 mel, on
    `device` (default: the audio's)."""
    mel = _log_mel(audio, n_fft=N_FFT, hop_length=HOP_LENGTH, n_mels=n_mels,
                   sample_rate=SAMPLE_RATE, padding=padding,
                   log_base="log10_whisper", device=device)
    # whisper drops the last (partial) frame like torch.stft(..., center=True)[:-1]
    return mel[..., :-1, :]


def pad_or_trim(array, length: int = N_FRAMES, axis: int = -2) -> torch.Tensor:
    """Pad with zeros or trim the time axis to `length`."""
    array = torch.as_tensor(array)
    cur = array.shape[axis]
    if cur > length:
        return array.narrow(axis, 0, length)
    if cur < length:
        pad = [0, 0] * array.ndim
        pad[2 * (array.ndim - 1 - axis % array.ndim) + 1] = length - cur
        return torch.nn.functional.pad(array, pad)
    return array
