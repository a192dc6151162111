"""The Kaldi features and `ISTFTCache` of the port's dsp against the JAX
package's, on the CPU: tests/test_dsp.py::TestKaldi (deltas against the
loop, the mel scale's round trip, fbank shapes with and without
`snip_edges`) and ::TestISTFT::test_istft_cache_batched_roundtrip, then
each function held to its JAX counterpart: the strided framing with its
reflected edges, the mel banks and centre frequencies, deltas in edge and
zero mode, the fbank at the callers' configs (16 kHz at int16 scale
without dither, MossFormer2-SE's 48 kHz with dither fed JAX's draws) and
the inverse STFT of a batch.

Tolerances: the log fbank at ATOL = 2e-4 (tests/test_torch_parity.py:19)
on values of 8 to 29: the port's power spectrum and mel product run in
float64, JAX's in f32, so the gap is JAX's own f32 summation error
(about 7e-5 at most here); deltas, banks and the ISTFT at f32 rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
ATOL = 2e-4


def jdsp():
    from mlx_audio_tpu import dsp

    return dsp


def pdsp():
    from mlx_audio_tpu_torch import dsp

    return dsp


def test_deltas_match_loop_and_jax():
    rng = np.random.RandomState(8)
    spec = rng.randn(3, 10, 50).astype(np.float32)
    n = 2
    denom = n * (n + 1) * (2 * n + 1) / 3.0
    kernel = np.arange(-n, n + 1)
    for mode, np_mode in (("edge", "edge"), ("zero", "constant")):
        got = pdsp().compute_deltas_kaldi(torch.from_numpy(spec), 5,
                                          mode).numpy()
        padded = np.pad(spec.reshape(-1, 50), [(0, 0), (n, n)],
                        mode=np_mode)
        ref = np.stack([np.sum(padded[:, i:i + 5] * kernel, axis=1) / denom
                        for i in range(50)], axis=1).reshape(spec.shape)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(jdsp().compute_deltas_kaldi(spec, 5, mode)),
            atol=1e-6)
    with pytest.raises(ValueError, match="win_length"):
        pdsp().compute_deltas_kaldi(torch.from_numpy(spec), 2)


def test_mel_scale_roundtrip_and_banks_match_jax():
    f = np.array([100.0, 1000.0, 8000.0])
    back = pdsp().inverse_mel_scale_kaldi(pdsp().mel_scale_kaldi(
        torch.from_numpy(f))).numpy()
    np.testing.assert_allclose(back, f, rtol=1e-5)
    np.testing.assert_allclose(pdsp().mel_scale_kaldi(torch.from_numpy(f)),
                               np.asarray(jdsp().mel_scale_kaldi(f)),
                               rtol=1e-6)
    for args in ((80, 512, 16000.0, 20.0, 0.0), (60, 2048, 48000.0, 20.0,
                                                 0.0),
                 (23, 256, 8000.0, 100.0, -200.0)):
        got = [t.numpy() for t in pdsp().get_mel_banks_kaldi(*args)]
        want = [np.asarray(t) for t in jdsp().get_mel_banks_kaldi(*args)]
        assert got[0].shape == (args[0], args[1] // 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert [pdsp()._next_power_of_2(x) for x in (0, 1, 400, 512, 1920)] \
        == [1, 1, 512, 512, 2048]


@pytest.mark.parametrize("n", [16000, 399, 160])
def test_strided_framing_matches_jax(n):
    """Kaldi's frames with `snip_edges` (whole frames only; none for a
    short input) and without (the edges reflected)."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    for snip in (True, False):
        got = pdsp()._get_strided_kaldi(torch.from_numpy(x), 400, 160,
                                        snip).numpy()
        want = np.asarray(jdsp()._get_strided_kaldi(
            __import__("jax.numpy").numpy.asarray(x), 400, 160, snip))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


FBANK = {
    "16k-int16": dict(sample_rate=16000, win_len=400, win_inc=160,
                      num_mels=80, dither=0.0, scale=32768.0),
    "16k-no-snip": dict(sample_rate=16000, win_len=400, win_inc=160,
                        num_mels=40, dither=0.0, snip_edges=False,
                        scale=1.0),
    "8k-povey": dict(sample_rate=8000, win_len=256, win_inc=128, num_mels=20,
                     dither=0.0, win_type="povey", scale=32768.0),
    "48k-dither": dict(sample_rate=48000, win_len=1920, win_inc=384,
                       num_mels=60, scale=32768.0),
}


@pytest.mark.parametrize("case", sorted(FBANK))
def test_fbank_matches_jax(case):
    """The log fbank at the callers' configs against JAX's; the dithered
    one fed JAX's draws (`normal(PRNGKey(0), frames.shape)`, what its
    key=None takes) through the `noise` seam."""
    import jax

    kw = dict(FBANK[case])
    scale = kw.pop("scale")
    x = (np.random.RandomState(9).randn(kw["sample_rate"]) * 0.1
         * scale).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jdsp().compute_fbank_kaldi(
        a, **kw))(x))
    noise = None
    if kw.get("dither", 1.0):
        shape = pdsp()._get_strided_kaldi(
            torch.from_numpy(x), kw["win_len"], kw["win_inc"], True).shape
        noise = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(0), tuple(shape))))
    got = pdsp().compute_fbank_kaldi(x, noise=noise, **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    if case == "16k-no-snip":
        assert got.shape[0] == (16000 + 80) // 160
    if case == "48k-dither":
        assert got.shape == (1 + (48000 - 1920) // 384, 60)


def test_fbank_dither_is_deterministic_and_has_a_seam():
    """Without `noise` one input gives one output (a CPU generator
    seeded 0, as JAX's fixed key); the same draws handed in give the same
    features, other draws others; dither 0 ignores the noise; a short
    input gives no frame."""
    x = (np.random.RandomState(1).randn(8000) * 3000).astype(np.float32)
    kw = dict(sample_rate=8000, win_len=256, win_inc=128, num_mels=20)
    a = pdsp().compute_fbank_kaldi(x, **kw)
    assert torch.equal(a, pdsp().compute_fbank_kaldi(x, **kw))
    nz = torch.randn((61, 256), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, pdsp().compute_fbank_kaldi(x, noise=nz, **kw))
    assert not torch.equal(a, pdsp().compute_fbank_kaldi(
        x, noise=nz * 0, **kw))
    assert torch.equal(pdsp().compute_fbank_kaldi(x, dither=0.0, **kw),
                       pdsp().compute_fbank_kaldi(x, noise=nz, dither=0.0,
                                                  **kw))
    assert pdsp().compute_fbank_kaldi(x[:100], **kw).shape == (0, 20)


def _spec(window, center):
    x = np.random.RandomState(3).randn(2, 4096).astype(np.float32)
    spec = np.asarray(jdsp().stft(x, n_fft=512, hop_length=128,
                                  window=window, center=center))
    return (x, np.ascontiguousarray(spec.real.transpose(0, 2, 1)),
            np.ascontiguousarray(spec.imag.transpose(0, 2, 1)))


def test_istft_cache_batched_roundtrip():
    """tests/test_dsp.py's round trip (hann, centred), and the result
    against JAX's ISTFTCache."""
    w = np.array(jdsp().hanning(512))
    x, re, im = _spec(w, True)
    cache = pdsp().ISTFTCache()
    out = cache.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft=512,
                      hop_length=128, win_length=512,
                      window=torch.from_numpy(w), center=True,
                      audio_length=x.shape[1]).numpy()
    assert out.shape == x.shape
    np.testing.assert_allclose(out[:, 256:-256], x[:, 256:-256], atol=1e-3)
    want = np.asarray(jdsp().ISTFTCache().istft(
        re, im, 512, 128, 512, w, center=True, audio_length=x.shape[1]))
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_istft_cache_uncentred_hamming_and_cache_api():
    """MossFormer2-SE's form (hamming, center=False, a window shorter than
    n_fft zero-padded, cut to audio_length) against JAX's; `cache_info`
    counts configs and `clear_cache` empties it, as JAX's."""
    w = np.array(jdsp().hamming(512))
    x, re, im = _spec(w, False)
    cache = pdsp().ISTFTCache()
    got = cache.istft(torch.from_numpy(re), torch.from_numpy(im), 512, 128,
                      512, torch.from_numpy(w), center=False,
                      audio_length=4000).numpy()
    jc = jdsp().ISTFTCache()
    want = np.asarray(jc.istft(re, im, 512, 128, 512, w, center=False,
                               audio_length=4000))
    assert got.shape == want.shape == (2, 4000)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, x[:, :4000], atol=1e-4)
    w4 = np.array(jdsp().hamming(400))
    got = cache.istft(torch.from_numpy(re), torch.from_numpy(im), 512, 128,
                      400, torch.from_numpy(w4), center=False).numpy()
    want = np.asarray(jc.istft(re, im, 512, 128, 400, w4, center=False))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    assert cache.cache_info() == jc.cache_info() == {"jitted_configs": 2}
    cache.clear_cache()
    assert cache.cache_info() == {"jitted_configs": 0}
