"""The port's Nemotron ASR against the JAX package, on the CPU at f32: the
cases of tests/test_nemotron_asr.py on the port, then the front end, the
prompted encoder (padded rows with no key under the chunked-limited mask
included), the greedy RNN-T's tokens and frames, `generate` and
`stream_generate` whole and in chunks, `load_model` of a converted
checkpoint, and the departure: the frames of a chunk are counted with the
config's own subsampling stages.

Both packages run one weight set: the JAX model's random parameters
(tests/test_nemotron_asr.py's `_cfg`) loaded into the port with
`model.load_jax_params`. Tensors agree within ATOL = 2e-4, the repo's f32
precedent; tokens, frames and texts are equal. `generate` is compared at
the config with a subsampling factor of 8 (the published one), where the
JAX package counts a chunk's frames right.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mlx_audio_tpu.stt.models.nemotron_asr import Model as JModel  # noqa: E402
from mlx_audio_tpu.stt.models.nemotron_asr import ModelConfig as JConfig  # noqa: E402
from mlx_audio_tpu.stt.models.nemotron_asr import nemotron_asr as jn  # noqa: E402
from mlx_audio_tpu.utils import flatten  # noqa: E402
from test_nemotron_asr import _cfg, _vocab  # noqa: E402

ATOL = 2e-4


def config_dict(factor=4):
    d = json.loads(json.dumps(dataclasses.asdict(_cfg())))
    d["encoder"]["subsampling_factor"] = factor
    return d


def model_pair(factor=4):
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.nemotron_asr import Model, ModelConfig

    jm = JModel(JConfig.from_dict(config_dict(factor))).init_and_bind()
    pm = Model(ModelConfig.from_dict(config_dict(factor)), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in flatten(jm.params).items()})
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return model_pair()


@pytest.fixture(scope="module")
def pair8():
    return model_pair(8)


def _feats(seed, t):
    return np.random.RandomState(seed).randn(1, t, 16).astype(np.float32)


def _greedy(pm, feats, n, state=None):
    return pm.greedy_rnnt(torch.from_numpy(feats), n,
                          pm.initial_state() if state is None else state)


# ---------------------------------------- tests/test_nemotron_asr.py cases


class TestMask:
    def test_chunked_limited_structure(self):
        from mlx_audio_tpu_torch.stt.models.nemotron_asr.nemotron_asr import \
            chunked_limited_mask

        m = chunked_limited_mask(8, 4, 1)
        assert m[0, 0] and m[0, 1]
        assert not m[0, 2]
        assert m[5, 0]
        assert not m[7, 0]

    def test_subsampled_length(self):
        from mlx_audio_tpu_torch.stt.models.nemotron_asr.nemotron_asr import \
            subsampled_length

        assert subsampled_length(100, 2) == (100 // 2 + 1) // 2 + 1


class TestTokenizer:
    def test_decode_strips_specials_and_lang(self):
        from mlx_audio_tpu_torch.stt.models.nemotron_asr.nemotron_asr import (
            decode_pieces, detected_language)

        v = _vocab()
        toks = [1, 3, 4, 0, 6]
        assert decode_pieces(toks, v) == " the cat ok."
        assert detected_language(toks, v) == "en-US"


class TestEncoder:
    def test_bucket_exactness(self, pair):
        from mlx_audio_tpu_torch.stt.models.nemotron_asr.nemotron_asr import \
            subsampled_length

        _, m = pair
        mel = _feats(0, 90)
        f_tight = m.encode(torch.from_numpy(mel), 90, (8, 1), 0).numpy()
        padded = np.zeros((1, 128, 16), np.float32)
        padded[:, :90] = mel
        f_pad = m.encode(torch.from_numpy(padded), 90, (8, 1), 0).numpy()
        n = subsampled_length(90, 2)
        np.testing.assert_allclose(f_pad[:, :n], f_tight[:, :n], atol=2e-5)

    def test_prompt_changes_output(self, pair):
        _, m = pair
        mel = torch.zeros(1, 64, 16)
        a = m.encode(mel, 64, (8, 1), 0).numpy()
        b = m.encode(mel, 64, (8, 1), 1).numpy()
        assert not np.allclose(a, b)


class TestGreedy:
    def test_rnnt_emits_and_respects_cap(self, pair):
        _, m = pair
        toks, times, _, _ = _greedy(m, _feats(1, 12), 12)
        assert len(toks) <= 12 * m.config.max_symbols
        assert (np.diff(times) >= 0).all()

    def test_chunk_chaining_matches_full(self, pair):
        _, m = pair
        feats = _feats(2, 16)
        full, _, _, _ = _greedy(m, feats, 16)
        t1, _, state, _ = _greedy(m, feats[:, :8], 8)
        t2, _, _, _ = _greedy(m, feats[:, 8:], 8, state)
        assert full == t1 + t2


class TestGenerate:
    def test_end_to_end(self, pair):
        _, m = pair
        out = m.generate(np.random.RandomState(3).randn(16000)
                         .astype(np.float32))
        assert isinstance(out.text, str)
        assert out.total_time > 0

    def test_stream_cumulative(self, pair):
        _, m = pair
        results = list(m.stream_generate(
            np.random.RandomState(4).randn(32000).astype(np.float32),
            chunk_duration=1.0))
        assert len(results) >= 2
        assert results[1].text.startswith(results[0].text[:4]) or \
            results[0].text == ""


class TestSanitize:
    def test_lstm_and_conv_layouts(self, pair):
        _, m = pair
        out = m.sanitize({
            "decoder.prediction.dec_rnn.lstm.0.Wx": np.ones((32, 8)),
            "decoder.prediction.dec_rnn.lstm.0.Wh": np.ones((32, 8)),
            "decoder.prediction.dec_rnn.lstm.0.bias": np.ones((32,)),
            "encoder.pre_encode.conv.0.weight": np.ones((4, 3, 3, 1)),
            "encoder.layers.0.conv.depthwise_conv.weight":
                np.ones((16, 5, 1)),
        })
        assert "decoder.prediction.dec_rnn.lstm.0.weight_ih" in out
        assert "decoder.prediction.dec_rnn.lstm.0.bias_ih" in out
        assert out["encoder.pre_encode.conv.0.weight"].shape == (3, 3, 1, 4)
        assert out["encoder.layers.0.conv.depthwise_conv.weight"].shape \
            == (5, 1, 16)

    def test_converted_passthrough(self, pair):
        jm, m = pair
        flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
        again = m.sanitize(flat)
        assert set(again) == set(flat)
        for k in flat:
            assert again[k].shape == flat[k].shape, k


# ------------------------------------------------------- against JAX


@pytest.mark.parametrize("seconds", [0.2, 1.0, 2.5])
def test_log_mel_matches_jax(pair, seconds):
    from mlx_audio_tpu_torch.stt.models.nemotron_asr.nemotron_asr import \
        nemo_log_mel

    jm, pm = pair
    x = np.random.RandomState(int(seconds * 10)).randn(
        int(16000 * seconds)).astype(np.float32)
    want = np.asarray(jn.nemo_log_mel(jnp.asarray(x),
                                      jm.config.preprocessor))
    got = nemo_log_mel(x, pm.config.preprocessor).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_valid,prompt", [(90, 1), (20, 0)])
def test_encode_matches_jax(pair, n_valid, prompt):
    """Every row of the prompted encoder output, padded ones included.
    Under the chunked-limited mask [8, 1] some padded rows see no valid key
    (the last at 90 valid mel frames of 128; rows 14-32 at 20, 6 valid
    encoder frames of 33): JAX's attention is NaN there and zeroed after;
    the port's output is finite and equal."""
    from mlx_audio_tpu_torch.stt.models.nemotron_asr.nemotron_asr import (
        chunked_limited_mask, subsampled_length)

    jm, pm = pair
    mel = np.zeros((1, 128, 16), np.float32)
    mel[:, :n_valid] = _feats(5, n_valid)
    want = np.asarray(jn.encode(jm.params, jm.config, jnp.asarray(mel),
                                jnp.int32(n_valid), (8, 1),
                                jnp.int32(prompt)))
    got = pm.encode(torch.from_numpy(mel), n_valid, (8, 1), prompt).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    t, n = got.shape[1], subsampled_length(n_valid, 2)
    keyless = ~(chunked_limited_mask(t, 8, 1)[:, :n]).any(axis=1)
    assert keyless.sum() == (19 if n_valid == 20 else 1)


@pytest.mark.parametrize("seed,t", [(6, 12), (7, 30)])
def test_greedy_tokens_and_frames_match_jax(pair, seed, t):
    jm, pm = pair
    feats = _feats(seed, t)
    z = jnp.zeros((1, 1, 8))
    toks, tms, _, _, _ = jn.greedy_rnnt(
        jm.params, jm.config, jnp.asarray(feats), jnp.int32(t), z, z,
        jnp.int32(jm.config.decoder.vocab_size))
    toks, tms = np.asarray(toks), np.asarray(tms)
    got, frames, _, run = _greedy(pm, feats, t)
    assert got == toks[toks >= 0].tolist() and got
    assert frames == tms[toks >= 0].tolist()
    assert run["joint_steps"] >= t


@pytest.mark.parametrize("chunk_duration", [30.0, 1.0])
def test_generate_and_stream_match_jax(pair8, chunk_duration):
    """At subsampling factor 8: `generate` (one chunk, and 1-s chunks with
    the decoder state carried) and `stream_generate`'s cumulative results
    equal JAX's; the chunked run's tokens are the whole run's."""
    jm, pm = pair8
    audio = np.random.RandomState(8).randn(16000 * 3).astype(np.float32)
    want = jm.generate(audio, chunk_duration=chunk_duration)
    got = pm.generate(audio, chunk_duration=chunk_duration)
    assert (got.text, got.segments, got.language, got.generation_tokens) == \
        (want.text, want.segments, want.language, want.generation_tokens)
    assert got.generation_tokens > 0
    sw = [(o.text, o.segments) for o in jm.stream_generate(
        audio, chunk_duration=chunk_duration)]
    sg = [(o.text, o.segments) for o in pm.stream_generate(
        audio, chunk_duration=chunk_duration)]
    assert sg == sw and sg[-1][0] == got.text
    assert pm.last_run["audio_chunks"] == (1 if chunk_duration == 30.0
                                           else 4)


def test_load_model_of_a_converted_checkpoint(pair, tmp_path):
    """The converted layout (MLX convs, LSTM Wx / Wh / bias) written by
    chip_smoke.py through the STT router: the model's exact parameters."""
    import mlx_audio_tpu_torch
    from chip_smoke import write_nemotron_checkpoint
    from mlx_audio_tpu_torch.stt.models.nemotron_asr import Model

    _, pm = pair
    write_nemotron_checkpoint(pm, tmp_path / "nemotron-tiny")
    loaded = mlx_audio_tpu_torch.load_model(tmp_path / "nemotron-tiny",
                                            device="cpu")
    assert isinstance(loaded, Model)
    for k, v in pm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# ----------------------------------------------------------- departure


def test_frames_are_counted_with_the_configs_stages(pair):
    """At subsampling factor 4, a 3-s chunk's 301 mel frames give 76
    encoder frames. JAX's generate counts subsampled_length(301) at its
    default of three stages, 39, and decodes those only; the port decodes
    all 76, each token's time inside them."""
    jm, pm = pair
    audio = np.random.RandomState(9).randn(16000 * 3).astype(np.float32)
    want, got = jm.generate(audio), pm.generate(audio)
    assert int(jn.subsampled_length(301)) == 39
    frame_sec = 4 * 160 / 16000
    assert max(s["end"] for s in want.segments) <= 39 * frame_sec + 1e-9
    assert max(s["end"] for s in got.segments) > 39 * frame_sec
    assert max(s["end"] for s in got.segments) <= 76 * frame_sec + 1e-9
    assert pm.last_run["joint_steps"] >= 76
