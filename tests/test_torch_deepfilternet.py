"""DeepFilterNet 2/3 in the PyTorch port against the JAX package, on the CPU
at float32: the Vorbis window and `norm_alpha`, the EMA norms (the port's
blocked scan against JAX's `lax.scan` and a float64 loop, over lengths
that take one, two and three levels of blocks), the GRU (`nn.GRU`) against
JAX's `_gru_cell`, the grouped linear, offline `enhance_array` (DFN3 and
the DFN2 path), the streamer against the port's offline path and JAX's
streamer, and `sanitize`. Config: tests/test_deepfilternet.py's
(`chip_smoke.DFN_SMALL`), with its seeded random ERB filterbank; one JAX
weight set reaches the port through `load_jax_params`.

Tolerances: 2e-4 absolute at f32 (summation order only); the streamer
against the offline path 1e-5, as the JAX package holds its own (its
streamer is bit-identical by design; the port's EMA scan sums each block
of frames in one product, so a chunk boundary moves the rounding).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import DFN_SMALL  # noqa: E402

ATOL = 2e-4
STREAM_ATOL = 1e-5


def _pair(seed: int, **kw):
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.deepfilternet import Model
    from test_deepfilternet import _model

    jm = _model(seed=seed, **kw)
    pm = Model(dataclasses.asdict(jm.config), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in flatten(jm.params).items()})
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    jm, pm = _pair(3)
    assert all(getattr(jm.config, k) == v for k, v in DFN_SMALL.items())
    return jm, pm


def _noise(n: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def test_window_and_alpha_equal_jax():
    from mlx_audio_tpu.sts.models.deepfilternet.model import (
        norm_alpha as jalpha, vorbis_window as jwin)
    from mlx_audio_tpu_torch.sts.models.deepfilternet.model import (
        norm_alpha, vorbis_window)

    for n in (8, 96, 960):
        np.testing.assert_array_equal(vorbis_window(n), jwin(n))
    for hop, sr in ((480, 48000), (48, 16000), (256, 16000)):
        assert norm_alpha(hop, sr) == jalpha(hop, sr)


@pytest.mark.parametrize("frames", [10, 300, 5000])
def test_ema_norms_match_jax_and_a_loop(frames):
    """The blocked scan (blocks of 64 frames; 300 frames take two levels,
    5,000 three) against JAX's lax.scan and a float64 loop: the mean norm
    of dB features and the unit norm of complex ones."""
    from mlx_audio_tpu.sts.models.deepfilternet.model import (
        _ema_mean_norm, _ema_unit_norm)
    from mlx_audio_tpu_torch.sts.models.deepfilternet.model import (
        ema_mean_norm, ema_unit_norm)

    rng = np.random.RandomState(frames)
    alpha = 0.99
    x = (rng.randn(frames, 4) * 10 - 70).astype(np.float32)
    s0 = np.linspace(-60, -90, 4).astype(np.float32)
    want, wlast = _ema_mean_norm(jnp.asarray(x), jnp.asarray(s0), alpha)
    got, last = ema_mean_norm(torch.from_numpy(x), torch.from_numpy(s0),
                              alpha)
    state, ref = s0.astype(np.float64), np.empty(x.shape)
    for i in range(frames):
        state = x[i] * (1 - alpha) + state * alpha
        ref[i] = (x[i] - state) / 40.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(wlast), atol=1e-3)
    ri = (rng.randn(frames, 3, 2) * 0.01).astype(np.float32)
    d0 = np.array([1e-3, 5e-4, 1e-4], np.float32)
    want, _ = _ema_unit_norm(jnp.asarray(ri), jnp.asarray(d0), alpha)
    got, _ = ema_unit_norm(torch.view_as_complex(torch.from_numpy(ri)),
                           torch.from_numpy(d0), alpha)
    np.testing.assert_allclose(torch.view_as_real(got).numpy(),
                               np.asarray(want), atol=ATOL)


def test_linear_scan_stays_finite_over_a_long_file():
    """An hour of 10-ms hops at a = 0.99: no power of a grows (the single
    power series a^-t would overflow f32 after 8,800 frames)."""
    from mlx_audio_tpu_torch.sts.models.deepfilternet.model import (
        linear_scan)

    y = torch.ones(360_000, 2) * 0.01
    s, last = linear_scan(y, torch.zeros(2), 0.99)
    assert torch.isfinite(s).all()
    np.testing.assert_allclose(s[-1].numpy(), 1.0, rtol=1e-4)
    np.testing.assert_allclose(s[0].numpy(), 0.01, rtol=1e-6)


def test_gru_matches_jax_gru_cell():
    """`nn.GRU` (gate order r, z, n; b_hn inside r's product) against
    JAX's `_gru_cell` scanned over 9 steps from a non-zero state, through
    the one-place conversion of its leaf."""
    from mlx_audio_tpu.nn.recurrent import init_gru
    from mlx_audio_tpu.sts.models.deepfilternet.network import _gru_seq
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params
    from mlx_audio_tpu_torch.nn import GRU

    p = init_gru(jax.random.PRNGKey(0), 6, 5)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 6).astype(np.float32)
    h0 = rng.randn(2, 5).astype(np.float32)
    want, want_h = _gru_seq(p, jnp.asarray(x), jnp.asarray(h0))
    m = TorchModel(None)
    m.gru = GRU(6, 5)
    load_jax_params(m, {f"gru.{k}": np.asarray(v)
                        for k, v in flatten(p).items()})
    got, got_h = m.gru(torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               atol=1e-5)


def test_grouped_linear_matches_jax():
    from mlx_audio_tpu.sts.models.deepfilternet import network as N
    from mlx_audio_tpu_torch.nn import GroupedLinear

    p = N.init_grouped_linear(jax.random.PRNGKey(0), 8, 12, 2)
    x = np.random.RandomState(1).randn(1, 3, 8).astype(np.float32)
    lin = GroupedLinear(8, 12, 2)
    lin.load_state_dict({"weight": torch.from_numpy(np.asarray(
        p["weight"]))})
    np.testing.assert_allclose(
        lin(torch.from_numpy(x)).detach().numpy(),
        np.asarray(N.apply_grouped_linear(p, jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("version", ["DeepFilterNet3", "DeepFilterNet2"])
def test_enhance_array_matches_jax(version):
    jm, pm = _pair(0, enc_concat=version == "DeepFilterNet2")
    audio = _noise(16000, 0)
    want, got = jm.enhance_array(audio), pm.enhance_array(audio)
    assert got.shape == audio.shape and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=ATOL)
    # a length off the hop grid
    audio = _noise(4001, 1)
    np.testing.assert_allclose(pm.enhance_array(audio),
                               jm.enhance_array(audio), atol=ATOL)


def test_streamer_matches_offline_and_jax(pair):
    """8-hop chunks (the last one partial, then the flush) against the
    port's own offline path and JAX's streamer."""
    jm, pm = pair
    p = pm.config
    n = p.hop_size * 40 + 17
    audio = _noise(n, 4)
    offline = pm.enhance_array(audio)
    outs, jouts = [], []
    s, js = pm.create_streamer(8), jm.create_streamer(8)
    step = p.hop_size * 8
    for i in range(0, n, step):
        outs.append(s.process_chunk(audio[i: i + step]))
        jouts.append(js.process_chunk(audio[i: i + step]))
    outs.append(s.flush())
    jouts.append(js.flush())
    streamed, jstreamed = (np.concatenate(o)[:n] for o in (outs, jouts))
    k = min(len(streamed), len(offline)) - p.fft_size
    assert k > n // 2
    np.testing.assert_allclose(streamed[:k], offline[:k], atol=STREAM_ATOL)
    np.testing.assert_allclose(streamed, jstreamed, atol=ATOL)
    s.reset()
    again = np.concatenate([s.process_chunk(audio), s.flush()])[:n]
    np.testing.assert_allclose(again, streamed, atol=STREAM_ATOL)


def test_streamer_rejects_df2():
    _, pm = _pair(0, enc_concat=True)
    with pytest.raises(NotImplementedError):
        pm.create_streamer()


def test_sanitize_matches_jax(pair):
    """Torch layouts: Conv2d (O, I/g, kT, kF) and the depthwise
    ConvTranspose2d (I, O/g, kT, kF) to HWIO (the latter pre-flipped), GRU
    `_l<i>` keys to per-layer leaves; everything else as it is."""
    jm, pm = pair
    rng = np.random.RandomState(0)
    w = {"enc.emb_gru.weight_ih_l0": rng.randn(48, 16),
         "enc.emb_gru.bias_hh_l1": rng.randn(48),
         "enc.erb_conv0.1.weight": rng.randn(4, 1, 3, 3),
         "erb_dec.convt2.0.weight": rng.randn(4, 1, 1, 3),
         "erb_dec.convt1.0.weight": rng.randn(4, 1, 2, 3),
         "enc.lsnr_fc.0.bias": rng.randn(1)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    want, got = jm.sanitize(w), pm.sanitize(w)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]))
    assert got["erb_dec.convt1.0.weight"].shape == (2, 3, 1, 4)
