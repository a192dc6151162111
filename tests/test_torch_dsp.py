"""The port's log-mel front end against the JAX package, on the CPU at f32.

`mel_filters` (both mel scales, both norms, the f32 and the f64 `precise`
build) must equal the JAX package's to 1e-7; `log_mel_spectrogram` (the
Whisper mode and the natural-log `clip` mode) must agree within 1e-4
absolute: the port takes `torch.fft.rfft` where the JAX package multiplies
by a DFT basis at HIGHEST precision, so the two round differently in the
last bits of the power spectrum (about 3e-6 of log-mel seen), and the
Whisper mode's floor at the whole array's maximum less 8 hides the rest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

MEL_TOL = 1e-4


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("norm", [None, "slaney"])
@pytest.mark.parametrize("mel_scale", ["htk", "slaney"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_filters_match_jax(n_mels, mel_scale, norm, precise):
    from mlx_audio_tpu.dsp import mel_filters as jax_mel_filters
    from mlx_audio_tpu_torch.dsp import mel_filters

    want = np.asarray(jax_mel_filters(16000, 400, n_mels, norm=norm,
                                      mel_scale=mel_scale, precise=precise))
    got = mel_filters(16000, 400, n_mels, norm=norm, mel_scale=mel_scale,
                      precise=precise)
    assert got.dtype == torch.float32 and got.shape == (n_mels, 201)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("log_base", ["log10_whisper", "clip"])
@pytest.mark.parametrize("padding", [0, 480])
@pytest.mark.parametrize("seconds", [1.0, 7.3, 31.0])
def test_log_mel_spectrogram_matches_jax(seconds, padding, log_base):
    from mlx_audio_tpu.dsp import log_mel_spectrogram as jax_log_mel
    from mlx_audio_tpu_torch.dsp import log_mel_spectrogram

    audio = (np.random.RandomState(int(seconds * 10)).randn(
        int(seconds * 16000)) * 0.1).astype(np.float32)
    kw = dict(n_mels=80, padding=padding)
    if log_base == "clip":
        kw.update(log_base="log", log_floor_mode="clip")
    want = np.asarray(jax_log_mel(audio, **kw))
    got = log_mel_spectrogram(audio, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= MEL_TOL


def test_log_mel_floor_spans_the_whole_array():
    """The Whisper mode floors at the maximum of the whole (batched) array
    less 8, so a loud row raises a quiet row's floor, as in JAX."""
    from mlx_audio_tpu.dsp import log_mel_spectrogram as jax_log_mel
    from mlx_audio_tpu_torch.dsp import log_mel_spectrogram

    rs = np.random.RandomState(3)
    audio = np.stack([rs.randn(8000) * 1e-4, rs.randn(8000)]).astype(
        np.float32)
    want = np.asarray(jax_log_mel(audio))
    got = log_mel_spectrogram(audio).numpy()
    assert np.abs(got - want).max() <= MEL_TOL
    assert got[0].min() == pytest.approx(got.max() - 2.0, abs=1e-6)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_whisper_log_mel_drops_the_last_frame(n_mels):
    from mlx_audio_tpu.stt.models.whisper import audio as jax_audio
    from mlx_audio_tpu_torch.stt.models.whisper import audio

    x = (np.random.RandomState(1).randn(16000 * 3) * 0.1).astype(np.float32)
    want = np.asarray(jax_audio.log_mel_spectrogram(x, n_mels=n_mels,
                                                    padding=1600))
    got = audio.log_mel_spectrogram(x, n_mels=n_mels, padding=1600)
    assert got.shape == want.shape == (310, n_mels)
    assert np.abs(got.numpy() - want).max() <= MEL_TOL


@pytest.mark.parametrize("length,axis", [(7, -2), (3, -2), (5, -2), (9, -1),
                                         (2, 0)])
def test_pad_or_trim_matches_jax(length, axis):
    from mlx_audio_tpu.stt.models.whisper.audio import (
        pad_or_trim as jax_pad_or_trim)
    from mlx_audio_tpu_torch.stt.models.whisper.audio import pad_or_trim

    x = np.random.RandomState(2).randn(4, 5, 6).astype(np.float32)
    want = np.asarray(jax_pad_or_trim(x, length, axis=axis))
    got = pad_or_trim(torch.from_numpy(x), length, axis=axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_windows_match_jax():
    from mlx_audio_tpu import dsp as jax_dsp
    from mlx_audio_tpu_torch import dsp

    assert set(dsp.STR_TO_WINDOW_FN) == set(jax_dsp.STR_TO_WINDOW_FN)
    for name, fn in dsp.STR_TO_WINDOW_FN.items():
        for periodic in (False, True):
            np.testing.assert_array_equal(
                fn(400, periodic).numpy(),
                np.asarray(jax_dsp.STR_TO_WINDOW_FN[name](400, periodic)))
