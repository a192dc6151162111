"""KittenTTS of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_model_families.py::TestKittenTTS (voices.npz packs
with a speed prior, tail shaping, multi-chunk crossfades, the dynamic
uint8 fake-quant), each held to the JAX package's, then the port's
loader.

Config: TestKittenTTS's tiny KittenTTS (a 2-layer PL-BERT at d24, a
generator of 16 channels), f32 compute in both packages (the JAX config is
switched to f32 before its first call) and the generator's noise off in
both (`deterministic_noise`), one parameter set drawn with numpy over
JAX's shapes (`test_torch_mimi.numpy_params`). The random generator's
audio peaks at 1e4-1e9, so the audio is held as tests/test_torch_kokoro.py
holds Kokoro's: max |port - JAX| within AUDIO_REL = 1e-4 of JAX's peak
(its f32 summation order, amplified through the generator's exp); the
host-side helpers are equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from tiny_configs import TINY_VOCAB  # noqa: E402

AUDIO_REL = 1e-4
TEXTS = ["Hello world.", "one. two. three. four. five. six."]


def kitten_cfg(model_path: str) -> dict:
    return dict(
        istftnet=dict(resblock_kernel_sizes=[3], upsample_rates=[4, 4],
                      upsample_initial_channel=16,
                      resblock_dilation_sizes=[[1, 3, 5]],
                      upsample_kernel_sizes=[8, 8],
                      gen_istft_n_fft=12, gen_istft_hop_size=3),
        hidden_dim=32, max_conv_dim=24, max_dur=50, n_layer=2, n_mels=20,
        n_token=len(TINY_VOCAB) + 1, style_dim=16,
        text_encoder_kernel_size=5, asr_res_dim=8,
        plbert=dict(num_hidden_layers=2, num_attention_heads=2,
                    hidden_size=24, intermediate_size=32,
                    max_position_embeddings=128, embedding_size=12,
                    dropout=0.0),
        vocab=TINY_VOCAB, model_path=model_path,
        speed_priors={"carol": 1.2}, voice_aliases={"c": "carol"})


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX KittenTTS, port KittenTTS) on one weight set and one
    voices.npz, both in f32 with the generator's noise off."""
    from mlx_audio_tpu.tts.models.kitten_tts import Model as JModel
    from mlx_audio_tpu.tts.models.kitten_tts import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.kitten_tts import Model, ModelConfig

    d = tmp_path_factory.mktemp("kitten")
    rng = np.random.RandomState(0)
    np.savez(d / "voices.npz",
             carol=rng.randn(1, 32).astype(np.float32),
             dave=rng.randn(4, 1, 32).astype(np.float32))
    cfg = kitten_cfg(str(d))
    jm = JModel(JConfig(**cfg))
    jm.config.compute_dtype = jm.config.transfer_dtype = "float32"
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig(
        **cfg, compute_dtype="float32", transfer_dtype="float32"),
        device="cpu"), flat)
    return jm, pm, flat, d


@pytest.fixture
def no_noise(monkeypatch):
    """Both packages' synth with the generator's noise off, as Kokoro's
    parity tests run it (the two random streams differ)."""
    from mlx_audio_tpu.tts.models.kokoro import Model as JKokoro
    from mlx_audio_tpu_torch.tts.models.kokoro import Model as PKokoro

    for cls in (JKokoro, PKokoro):
        call = cls.__call__
        monkeypatch.setattr(
            cls, "__call__",
            lambda self, ps, ref_s, speed=1.0, _call=call, **kw:
            _call(self, ps, ref_s, speed=speed, deterministic_noise=True))


def test_config_maps_onto_kokoro(models):
    _, pm, _, _ = models
    cfg = pm.config
    assert (cfg.decoder_bottleneck, cfg.decoder_res_dim) == (24, 8)
    assert (cfg.hidden_dim, cfg.style_dim) == (32, 16)


def test_voices_aliases_and_packs_equal_jax(models):
    jm, pm, _, _ = models
    assert pm.get_supported_speakers() == jm.get_supported_speakers() \
        == ["carol", "dave"]
    for voice, n in (("carol", 5), ("c", 3), ("dave", 2), ("dave", 40)):
        np.testing.assert_array_equal(pm.get_voice(voice, n),
                                      jm.get_voice(voice, n))
    with pytest.raises(FileNotFoundError, match="not in"):
        pm.get_voice("nobody")


@pytest.mark.parametrize("case", [
    dict(text=TEXTS[0], voice="carol"),
    dict(text=TEXTS[0], voice="c", tail_silence_ms=100, fade_out_ms=50),
    dict(text=TEXTS[1], voice="dave", chunk_size=10, crossfade_ms=10,
         speed=0.9)])
def test_generate_equals_jax(models, no_noise, case):
    """Whole requests: the speed prior, the tail shaping and the chunked
    crossfades, segment for segment."""
    jm, pm, _, _ = models
    got = list(pm.generate(**case))
    want = list(jm.generate(**case))
    assert [r.segment_idx for r in got] == [r.segment_idx for r in want]
    assert [r.token_count for r in got] == [r.token_count for r in want]
    for a, b in zip(got, want):
        assert a.samples == b.samples > 0
        b = np.asarray(b.audio)
        assert np.abs(a.audio - b).max() <= AUDIO_REL * np.abs(b).max()
    if "tail_silence_ms" in case:
        n_sil = int(0.1 * pm.config.sample_rate)
        assert np.abs(got[-1].audio[-n_sil:]).max() == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_crossfade_and_tail_equal_jax(models, seed):
    jm, pm, _, _ = models
    rng = np.random.RandomState(seed)
    a = rng.randn(3000).astype(np.float32)
    b = rng.randn(2000).astype(np.float32)
    for fade in (0, 240, 5000):
        for x, y in zip(pm._crossfade(a, b, fade), jm._crossfade(a, b, fade)):
            np.testing.assert_array_equal(x, y)
    a[-500:] *= 1e-3
    for fade_ms, tail_ms in ((200, 200), (50, 0), (0, 100)):
        np.testing.assert_array_equal(pm._apply_tail(a, fade_ms, tail_ms),
                                      jm._apply_tail(a, fade_ms, tail_ms))


def test_fake_quant_equals_jax():
    """tests/test_model_families.py's inputs: zeros, and 100 normal
    draws; the port's copy equals JAX's and stays within one step."""
    from mlx_audio_tpu.tts.models.kitten_tts.kitten_tts import \
        fake_quant_dynamic_u8 as jfq
    from mlx_audio_tpu_torch.tts.models.kitten_tts import \
        fake_quant_dynamic_u8

    y = np.random.RandomState(0).randn(100).astype(np.float32)
    for x in (np.zeros((4, 4), np.float32), y, np.abs(y), -np.abs(y)):
        got = fake_quant_dynamic_u8(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jfq(jnp.asarray(x))),
                                   atol=1e-6)
    step = (max(float(y.max()), 0) - min(float(y.min()), 0)) / 255.0
    assert np.abs(fake_quant_dynamic_u8(torch.from_numpy(y)).numpy()
                  - y).max() <= step


def test_load_model_from_a_directory(models, no_noise, tmp_path):
    """A KittenTTS directory (config.json, the published torch-layout
    weights, voices.npz) through the port's top-level `load_model` on the
    CPU generates what the bound model does; the card is the default."""
    import json
    import shutil

    from mlx_audio_tpu_torch.utils import load_model

    jm, pm, _, vdir = models
    d = tmp_path / "kitten-nano"
    d.mkdir()
    cfg = dict(kitten_cfg(""), model_type="kitten",
               compute_dtype="float32", transfer_dtype="float32")
    cfg.pop("model_path")
    (d / "config.json").write_text(json.dumps(cfg))
    shutil.copy(vdir / "voices.npz", d / "voices.npz")
    np.savez(d / "model.npz", **{k: v.float().numpy()
                                 for k, v in pm.state_dict().items()})
    m = load_model(str(d), device="cpu")
    assert type(m).__module__.endswith("kitten_tts.kitten_tts")
    a = list(m.generate(TEXTS[0], voice="carol"))[0].audio
    b = list(pm.generate(TEXTS[0], voice="carol"))[0].audio
    np.testing.assert_allclose(a, b, atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(str(d))
