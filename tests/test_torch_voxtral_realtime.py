"""The port's Voxtral Realtime against the JAX package, on the CPU at f32:
token math, the STFT and the mel, the tekken decode, the encoder over
MEL_BUCKETS, the AdaRMSNorm scales, greedy offline `generate` (whole and
`stream=True`, EOS included), the no-tokenizer errors and the loaders
(conv layouts, the consolidated remap).

Both packages run one weight set: the JAX model's random parameters,
loaded into the port with `model.load_jax_params`. Tensors agree within
TOL (2e-4); tokens and text are equal. The configs are
tests/test_voxtral_realtime.py's (1-layer encoder) and the same with a
2-layer encoder, where JAX's bucketed `Model.encode` is NaN for some
lengths and the port's is not (`test_padded_bucket_is_finite...`).
"""

import base64
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlx_audio_tpu.stt.models.voxtral_realtime import voxtral_realtime as jvr  # noqa: E402
from mlx_audio_tpu.utils import flatten  # noqa: E402

TOL = 2e-4


def config_dict(enc_layers=1, window=64, eos=2):
    """tests/test_voxtral_realtime.py's tiny config, with `enc_layers`
    encoder layers, a sliding window of `window` and EOS id `eos`."""
    return dict(
        model_type="voxtral_realtime",
        encoder_args=dict(dim=16, n_layers=enc_layers, n_heads=2, head_dim=8,
                          hidden_dim=32, n_kv_heads=2, sliding_window=window,
                          downsample_factor=4,
                          audio_encoding_args=dict(num_mel_bins=16)),
        decoder=dict(dim=16, n_layers=1, n_heads=2, n_kv_heads=2, head_dim=8,
                     hidden_dim=32, vocab_size=64, ada_rms_norm_t_cond_dim=4),
        transcription_delay_ms=160, n_left_pad_tokens=2, eos_token_id=eos)


def write_tekken(path, suffix=""):
    """A tekken.json of 40 special ids and the letters a-j (each followed
    by `suffix`), in the format both packages read."""
    vocab = [{"token_bytes": base64.b64encode((c + suffix).encode()).decode()}
             for c in "abcdefghij"]
    path.write_text(json.dumps({
        "vocab": vocab, "config": {"default_num_special_tokens": 40},
        "special_tokens": [{"rank": 1}, {"rank": 2}, {"rank": 32}]}))
    return path


def model_pair(cfg: dict, tekken=None):
    """(JAX model, port model on the CPU) with the JAX model's random
    parameters in both, and the tekken tokenizer at `tekken` if given."""
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models import voxtral_realtime as pvr

    jm = jvr.Model(jvr.ModelConfig.from_dict(json.loads(json.dumps(cfg))))
    jm.init_and_bind()
    pm = pvr.Model(pvr.ModelConfig.from_dict(cfg), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in
                         flatten(jm.params).items()})
    if tekken is not None:
        jm._tokenizer = jvr.TekkenTokenizer(str(tekken))
        pm._tokenizer = pvr.TekkenTokenizer(str(tekken))
    return jm, pm


def noise(seed: int, n: int = 16000) -> np.ndarray:
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.fixture(scope="module")
def tekken(tmp_path_factory):
    return write_tekken(tmp_path_factory.mktemp("tekken") / "tekken.json",
                        " ")


@pytest.fixture(scope="module")
def pair(tekken):
    return model_pair(config_dict(), tekken)


@pytest.fixture(scope="module")
def pair2(tekken):
    return model_pair(config_dict(enc_layers=2), tekken)


# ------------------------------------------------------------ token math


def test_token_math_matches_jax():
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        voxtral_realtime as pvr)

    assert pvr._num_audio_tokens(1280) == 1
    assert pvr._num_audio_tokens(16000) == 13
    assert pvr._num_delay_tokens(480) == 6
    for n in (0, 1, 159, 160, 161, 1279, 1280, 1281, 16000, 48123):
        assert pvr._num_audio_tokens(n) == jvr._num_audio_tokens(n)
    for ms in (80, 160, 240, 480, 960, 2400):
        assert pvr._num_delay_tokens(ms) == jvr._num_delay_tokens(ms)
    for n, left, right in ((1000, 2, 3), (1280, 32, 7), (16001, 0, 0)):
        a = np.arange(n, dtype=np.float32)
        got = pvr._pad_audio_streaming(a, left, right)
        assert len(got) % 1280 == 0
        np.testing.assert_array_equal(got, jvr._pad_audio_streaming(
            a, left, right))


# ------------------------------------------------------------- stft, mel


@pytest.mark.parametrize("n_fft,hop,win_length,window,center", [
    (400, 160, 400, "hann", True), (512, 128, 400, "hamming", True),
    (64, 16, 64, "hann", False)])
def test_stft_matches_jax(n_fft, hop, win_length, window, center):
    from mlx_audio_tpu.dsp import stft as jax_stft
    from mlx_audio_tpu_torch.dsp import spec_abs, stft

    x = noise(3, 8000) * 0.1
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win_length,
              window=window, center=center)
    want = np.asarray(jax_stft(jnp.asarray(x), **kw))
    got = stft(x, **kw)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL, err
    np.testing.assert_allclose(spec_abs(got).numpy(), np.abs(want),
                               atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("kind,seconds", [("silence", 1.0), ("noise", 1.0),
                                          ("noise", 2.37)])
def test_mel_matches_jax(kind, seconds):
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        ModelConfig, voxtral_realtime as pvr)

    n = int(seconds * 16000)
    audio = np.zeros(n, np.float32) if kind == "silence" else noise(4, n)
    aec = ModelConfig.from_dict(config_dict()).audio_encoding_args
    got = pvr.voxtral_mel(audio, aec)
    want = np.asarray(jvr.voxtral_mel(jnp.asarray(audio), aec))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape == (n // 160, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    if kind == "silence":
        # silence clamps to (global_max - 8 + 4) / 4
        np.testing.assert_allclose(got.numpy(), (1.5 - 8.0 + 4.0) / 4.0,
                                   atol=1e-6)


# ---------------------------------------------------------------- tekken


def test_tekken_decode_matches_jax(tmp_path):
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        TekkenTokenizer)

    path = write_tekken(tmp_path / "tekken.json")
    tok, ref = TekkenTokenizer(str(path)), jvr.TekkenTokenizer(str(path))
    assert tok.decode([1, 40, 41, 2, 42]) == "abc"
    for ids in ([], [40, 49, 50, 32, 63, 0], list(range(64)), [45] * 3):
        assert tok.decode(ids) == ref.decode(ids)


def test_tekken_missing_file_raises(tmp_path):
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        TekkenTokenizer)

    with pytest.raises(FileNotFoundError, match="tekken.json not found"):
        TekkenTokenizer.from_model_path(tmp_path)


# --------------------------------------------------------------- encoder


@pytest.mark.parametrize("layers", [1, 2])
def test_encode_matches_jax_and_buckets_agree(pair, pair2, layers):
    """Model.encode's adapter frames equal JAX's (at a 2-layer encoder, on
    a length whose bucket padding stays within the window, where JAX is
    finite), and a longer pad (another bucket) keeps the prefix."""
    jm, pm = pair if layers == 1 else pair2
    audio = jvr._pad_audio_streaming(noise(0, 16000 * (1 if layers == 1
                                                       else 4)), 2, 3)
    got, n = pm.encode(audio)
    want, n_j = jm.encode(audio)
    assert n == n_j == len(audio) // 1280 and got.shape == (1, n, 16)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    longer = np.concatenate([audio, np.zeros(1280 * 80, np.float32)])
    got2, _ = pm.encode(longer)
    np.testing.assert_allclose(got2[:, :n].numpy(), got.numpy(), atol=TOL,
                               rtol=0)


def test_padded_bucket_is_finite_where_jax_is_nan(pair2):
    """The departure: at a 2-layer encoder, 1 s of audio (about 200 mel
    frames in the 512 bucket, so pad queries lie more than the window past
    the valid frames) makes JAX's Model.encode NaN; the port's frames are
    finite and equal JAX's encode_audio run on the mel padded only to its
    own length."""
    jm, pm = pair2
    audio = jvr._pad_audio_streaming(noise(1), 2, 13)
    want_nan, n = jm.encode(audio)
    assert np.isnan(want_nan).any()          # the reference's fault
    got, n_p = pm.encode(audio)
    assert n_p == n and torch.isfinite(got).all()
    mel = np.asarray(jvr.voxtral_mel(jnp.asarray(audio),
                                     jm.config.audio_encoding_args))
    mel = mel[1:] if mel.shape[0] % 2 else mel
    ref = np.asarray(jvr.encode_audio(jm.params["encoder"], jm.config,
                                      jnp.asarray(mel[None]),
                                      jnp.int32(mel.shape[0])))[:, :n]
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


# ----------------------------------------------------------- ada scales


def test_ada_scales_match_jax_and_follow_the_delay(pair):
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        voxtral_realtime as pvr)

    jm, pm = pair
    d = pm.config.decoder
    outs = []
    for t in (2.0, 6.0):
        emb = pvr.compute_time_embedding(t, d.dim)
        np.testing.assert_array_equal(emb, jvr.compute_time_embedding(
            t, d.dim))
        got = pvr.ada_scales(pm.decoder, d, torch.from_numpy(emb))
        want = np.asarray(jvr.ada_scales(jm.params["decoder"], d,
                                         jnp.asarray(emb)))
        assert got.shape == (1, 16)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1])


# -------------------------------------------------------------- generate


@pytest.mark.parametrize("seed,max_tokens", [(1, 512), (2, 512), (1, 7)])
def test_generate_matches_jax(pair, seed, max_tokens):
    """Greedy lockstep tokens and text equal JAX's, within the lockstep
    budget (at most n_audio - prompt_len + 1 tokens) or `max_tokens`."""
    jm, pm = pair
    audio = noise(seed)
    got = pm.generate(audio, max_tokens=max_tokens)
    want = jm.generate(audio, max_tokens=max_tokens)
    assert got.text == want.text
    assert got.generation_tokens == want.generation_tokens
    assert got.prompt_tokens == want.prompt_tokens
    assert got.segments == want.segments
    n_delay = jvr._num_delay_tokens(160)
    n_audio = len(jvr._pad_audio_streaming(audio, 2, n_delay + 11)) // 1280
    assert got.generation_tokens <= min(max_tokens,
                                        n_audio - (1 + 2 + n_delay) + 1)
    chunks = [new for new, _, _ in pm._run(audio, max_tokens, None)]
    assert chunks == [new for new, _, _ in jm._run(audio, max_tokens, None)]


@pytest.mark.parametrize("eos", [42, 60])
def test_generate_stops_at_eos_like_jax(pair, tekken, eos):
    """With EOS an id the random weights do emit (the same weights as
    `pair`, whose EOS they never emit), the offline decode keeps the tokens
    before its first EOS and stops there, as JAX's does."""
    jm, pm = model_pair(config_dict(eos=eos), tekken)
    audio = noise(1)
    natural = [t for new, _, _ in pair[1]._run(audio, 512, None)
               for t in new]
    got = [new for new, _, _ in pm._run(audio, 512, None)]
    assert got == [new for new, _, _ in jm._run(audio, 512, None)]
    assert eos in natural
    assert sum(got, []) == natural[:natural.index(eos)]
    assert pm.generate(audio).text == jm.generate(audio).text


def test_stream_deltas_match_jax(pair):
    jm, pm = pair
    audio = noise(2, 16000 * 7)     # more than one 64-position chunk
    got = list(pm.generate(audio, stream=True, max_tokens=512))
    want = list(jm.generate(audio, stream=True, max_tokens=512))
    assert len(got) > 1 and all(isinstance(d, str) for d in got)
    assert got == want
    assert "".join(got).strip() == pm.generate(audio).text


def test_no_tokenizer_errors():
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig)

    m = Model(ModelConfig.from_dict(config_dict()), device="cpu")
    with pytest.raises(RuntimeError, match="tekken"):
        m.generate(np.zeros(8000, np.float32))
    with pytest.raises(RuntimeError, match="tekken"):
        m.create_streaming_session()


# --------------------------------------------------------------- loading


def test_conv_layouts_match_jax():
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig)

    m = Model(ModelConfig.from_dict(config_dict()), device="cpu")
    jm = jvr.Model(jvr.ModelConfig.from_dict(config_dict()))
    rs = np.random.RandomState(0)
    weights = {
        "encoder.conv_layers_0_conv.conv.weight":
            rs.randn(16, 3, 16).astype(np.float32),    # MLX (O, K, I)
        "encoder.conv_layers_1_conv.conv.weight":
            rs.randn(16, 16, 3).astype(np.float32),    # torch (O, I, K)
        "encoder.conv_layers_1_conv.conv.bias": np.zeros(16, np.float32)}
    got, want = m.sanitize(weights), jm.sanitize(weights)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["encoder.conv_layers_0_conv.conv.weight"].shape == (3, 16, 16)


def test_consolidated_remap_and_passthrough_match_jax(pair):
    """A converted tree passes through sanitize unchanged; the mistral
    consolidated names map onto it as JAX's `_remap_consolidated` maps
    them, and load into the port."""
    from chip_smoke import voxtral_consolidated_names
    from mlx_audio_tpu_torch.model import load_jax_params

    jm, pm = pair
    flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
    again = pm.sanitize(flat)
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k])
    cons = voxtral_consolidated_names(flat)
    assert any(k.startswith("mm_streams_embeddings.") for k in cons)
    assert any(k.startswith("layers.0.ada_rms_norm_t_cond.0.") for k in cons)
    got = pm._remap_consolidated(cons)
    assert got.keys() == jm._remap_consolidated(cons).keys() == flat.keys()
    other = type(pm)(pm.config, device="cpu")
    load_jax_params(other, pm.sanitize(cons))
    for (k, a), (_, b) in zip(other.state_dict().items(),
                              pm.state_dict().items()):
        assert torch.equal(a, b), k
