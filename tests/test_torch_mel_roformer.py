"""Mel-Band-RoFormer in the PyTorch port against the JAX package, on the
CPU at float32: the band layout, the band split and the mask estimator
against a loop over the bands of the torch-layout weights (as
tests/test_mel_roformer.py:91-151 holds JAX's stacked stages), the
forward and `separate` over several chunks (a mono input upmixed) against
JAX's, `sanitize`, and the port's `generate`. Config: tests/
test_mel_roformer.py's (`chip_smoke.MEL_SMALL`), weights its fake ZFTurbo
state dict, sanitized by each package.

Tolerance: 2e-4 absolute at f32 (summation order only; the port's STFT
takes its DFT in float64, JAX's in float32, about 1e-8 apart here), and
the stages against the per-band loop 1e-4 as the JAX test holds them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from chip_smoke import MEL_SMALL  # noqa: E402
from test_mel_roformer import _torch_style_weights  # noqa: E402

ATOL = 2e-4


@pytest.fixture(scope="module")
def models():
    from mlx_audio_tpu.sts.models.mel_roformer import MelRoFormerConfig as JC
    from mlx_audio_tpu.sts.models.mel_roformer import Model as JModel
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.mel_roformer import Model

    jm = JModel(JC(**MEL_SMALL))
    w = _torch_style_weights(jm.config, jm.layout)
    jm.bind(unflatten(jm.sanitize(w)))
    pm = Model(MEL_SMALL, device="cpu")
    load_jax_params(pm, pm.sanitize(w))
    return jm, pm, w


def test_band_layout_equals_jax(models):
    jm, pm, _ = models
    a, b = jm.layout, pm.layout
    np.testing.assert_array_equal(np.asarray(a.gather_idx), b.gather_idx)
    np.testing.assert_array_equal(np.asarray(a.valid), b.valid)
    np.testing.assert_array_equal(np.asarray(a.counts), b.counts)
    assert a.band_dims == b.band_dims and a.max_bd == b.max_bd
    covered = np.zeros(b.f2, bool)
    covered[b.gather_idx[b.valid]] = True
    assert covered.all()


def test_band_split_matches_a_loop_over_the_bands(models):
    """The stacked band split (padded lanes inert) against each band's
    RMSNorm over its true entries and projection, straight from the torch
    weights."""
    from mlx_audio_tpu_torch.sts.models.mel_roformer import band_split

    _, pm, w = models
    lay = pm.layout
    rng = np.random.RandomState(1)
    b, t = 1, 5
    repr_ri = rng.randn(b, t, lay.f2, 2).astype(np.float32)
    got = band_split(pm, torch.from_numpy(repr_ri)).numpy()
    for i in range(lay.num_bands):
        band = repr_ri[:, :, lay.gather_idx[i][lay.valid[i]], :].reshape(
            b, t, -1)
        nrm = np.sqrt((band * band).sum(-1, keepdims=True))
        b_n = band / np.maximum(nrm, 1e-12) * np.sqrt(band.shape[-1]) \
            * w[f"band_split.to_features.{i}.0.gamma"]
        ref = b_n @ w[f"band_split.to_features.{i}.1.weight"].T \
            + w[f"band_split.to_features.{i}.1.bias"]
        np.testing.assert_allclose(got[:, :, i], ref, atol=1e-4)


def test_mask_estimator_matches_a_loop_over_the_bands(models):
    from mlx_audio_tpu_torch.sts.models.mel_roformer import mask_estimator

    _, pm, w = models
    rng = np.random.RandomState(2)
    x = rng.randn(1, 4, pm.num_bands, MEL_SMALL["dim"]).astype(np.float32)
    mask = mask_estimator(pm, torch.from_numpy(x)).numpy()
    for i, bd in enumerate(pm.layout.band_dims):
        base = f"mask_estimators.0.to_freqs.{i}.0"
        hh = np.tanh(x[:, :, i] @ w[f"{base}.0.weight"].T
                     + w[f"{base}.0.bias"])
        hh = np.tanh(hh @ w[f"{base}.2.weight"].T + w[f"{base}.2.bias"])
        oo = hh @ w[f"{base}.4.weight"].T + w[f"{base}.4.bias"]
        ref = oo[..., :bd] / (1 + np.exp(-oo[..., bd:]))
        np.testing.assert_allclose(mask[:, :, i, :bd], ref, atol=1e-4)
        assert (mask[:, :, i, bd:] == 0).all()


def test_forward_matches_jax(models):
    jm, pm, _ = models
    audio = (np.random.RandomState(0).randn(2, 2, 2048) * 0.1).astype(
        np.float32)
    want = np.asarray(jm(audio))
    got = pm(audio).numpy()
    assert got.shape == (2, 2, 2048) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 5000), (5000, 2), (3000,)])
def test_separate_matches_jax(models, shape):
    """50%-overlapped chunks averaged: stereo channels first or last (four
    chunks, the last one shifted to the end), and a mono input upmixed."""
    jm, pm, _ = models
    audio = (np.random.RandomState(3).randn(*shape) * 0.1).astype(np.float32)
    want, got = jm.separate(audio), pm.separate(audio)
    n = shape[0] if len(shape) == 1 else max(shape)
    assert got.vocals.shape == (2, n) and got.sample_rate == 8000
    np.testing.assert_allclose(got.vocals, want.vocals, atol=ATOL)
    assert got.duration_seconds == want.duration_seconds


def test_zero_mask_weights_give_silence():
    from mlx_audio_tpu.sts.models.mel_roformer import MelRoFormerConfig as JC
    from mlx_audio_tpu.sts.models.mel_roformer import Model as JModel
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.mel_roformer import Model

    lay = JModel(JC(**MEL_SMALL)).layout
    w = _torch_style_weights(JC(**MEL_SMALL), lay)
    for i in range(lay.num_bands):
        base = f"mask_estimators.0.to_freqs.{i}.0"
        w[f"{base}.4.weight"] = np.zeros_like(w[f"{base}.4.weight"])
        w[f"{base}.4.bias"] = np.zeros_like(w[f"{base}.4.bias"])
    pm = Model(MEL_SMALL, device="cpu")
    load_jax_params(pm, pm.sanitize(w))
    audio = np.random.RandomState(1).randn(1, 2, 1024).astype(np.float32)
    np.testing.assert_allclose(pm(audio).numpy(), 0.0, atol=1e-5)


def test_sanitize_matches_jax_and_is_idempotent(models):
    jm, pm, w = models
    want, got = jm.sanitize(w), pm.sanitize(w)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]))
    assert pm.sanitize(got) is got


def test_generate_is_separate_on_a_file(models, tmp_path):
    """The port's departure: `generate` (the STS CLI's entry) is
    `separate` on an array or a file read at its channels, and its result's
    `audio` is the stem."""
    from mlx_audio_tpu_torch import audio_io

    _, pm, _ = models
    stereo = (np.random.RandomState(4).randn(3000, 2) * 0.1).astype(
        np.float32)
    audio_io.write(tmp_path / "in.wav", stereo, 8000)
    read, _ = audio_io.read(tmp_path / "in.wav", dtype="float32")
    got = pm.generate(str(tmp_path / "in.wav"))
    np.testing.assert_array_equal(got.audio, pm.separate(read.T).vocals)
    np.testing.assert_array_equal(pm.generate(read.T).audio, got.audio)
